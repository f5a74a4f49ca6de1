"""peak_device_gb (GB): `torch.cuda.max_memory_allocated()` over the run
until the window (and the traced sub-window) closed, 1e9 bytes a GB."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
