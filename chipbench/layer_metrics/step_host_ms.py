"""step_host_ms (ms): the host's own time in a `step()` of the measured
window, apart from waiting on the device: (`step_us` - `sync_wait_us`) /
`steps`, the engine's counters (`stats`, read off the harness's clock).
None where the engine keeps no such counters."""


def read(ctx):
    st = ctx["stats"]
    if not st.get("steps") or "step_us" not in st or "sync_wait_us" not in st:
        return None
    return (st["step_us"] - st["sync_wait_us"]) / st["steps"] / 1e3
