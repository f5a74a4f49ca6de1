"""engine_step_ms (ms): the window's seconds / the `step()` calls in it
(host clock)."""


def read(ctx):
    if not ctx["steps"]:
        return None
    return (ctx["closed"] - ctx["opened"]) / ctx["steps"] * 1e3
