"""decode_device_ms (ms): device time of the activities launched inside
the engine state's `decode` calls / those calls, in the traced
sub-window (profiler)."""


def read(ctx):
    tr = ctx["trace"]
    n = tr.calls.get("decode", 0) if tr else 0
    s = tr.device_s.get("decode", 0.0) if tr else 0.0
    return s / n * 1e3 if n and s > 0 else None
