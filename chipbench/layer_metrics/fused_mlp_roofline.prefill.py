"""fused_mlp_roofline.prefill (%): the least time the card could take for
the `fused_mlp` calls made inside prefills in the traced sub-window
(`harness/work.fused_mlp`: its rows, its weights once) / the device time
of the activities launched inside those calls."""
from harness import work


def read(ctx):
    tr = ctx["trace"]
    dev = tr.device_s.get("fused_mlp@prefill", 0.0) if tr else 0.0
    calls = [c for c in tr.mlp_calls if c[4] == "prefill"] if tr else []
    if dev <= 0 or not calls:
        return None
    t = sum(work.roofline_s(*work.fused_mlp(n, d, f, size)) for n, d, f, size, _ in calls)
    return t / dev * 100.0
