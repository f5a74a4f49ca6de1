"""queue_wait_p90_ms (ms): the 90th percentile, over the requests first
admitted in the measured window, of the engine's admission mark
(`Request.t_admit`) less the client's submission.  None where requests
carry no admission mark."""
from harness import window


def read(ctx):
    opened, closed = ctx["opened"], ctx["closed"]
    waits = [r.req.t_admit - r.req.t_submit for r in ctx["recs"]
             if getattr(r.req, "t_admit", None) is not None
             and window.in_window(r.req.t_admit, opened, closed)]
    p90 = window.percentile(waits, 90)
    return None if p90 is None else p90 * 1e3
