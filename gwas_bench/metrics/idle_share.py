"""The device's idle share of the traced window (%): 1 - (union of its
kernel, copy and set intervals) / (the window's wall time), both from the
same profiled window.  None when the trace holds no device operation."""


def read(ctx):
    r = ctx.reduced
    if not r.device_ops:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
