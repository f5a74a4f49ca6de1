"""device_idle_share (%): the share of the traced sub-window in which no
activity ran on the device (profiler: the union of kernels, copies and
sets)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr.busy_s <= 0 or tr.window_s <= 0:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
