from .plot import available, manhattan_plot, qq_plot  # noqa: F401
