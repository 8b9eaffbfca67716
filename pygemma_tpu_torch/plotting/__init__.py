from .plot import manhattan_plot, qq_plot  # noqa: F401
