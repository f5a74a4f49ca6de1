"""decode_batch_mean (slots): decode tokens / decode steps in the window,
from the engine's counters (`stats`: every admission's first token comes
from its prefill, every other token from a decode step)."""


def read(ctx):
    st = ctx["stats"]
    steps = st.get("decode_steps", 0)
    if not steps:
        return None
    return (st["tokens_out"] - st["prefills"]) / steps
