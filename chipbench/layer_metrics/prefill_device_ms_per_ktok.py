"""prefill_device_ms_per_ktok (ms/ktok): device time of the activities
launched inside the engine state's `prefill` calls / thousands of prompt
tokens prefilled, in the traced sub-window (profiler)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr.prefill_tokens or tr.device_s.get("prefill", 0.0) <= 0:
        return None
    return tr.device_s["prefill"] * 1e3 / (tr.prefill_tokens / 1e3)
