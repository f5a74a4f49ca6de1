"""What decides `correct`: the served tokens against the plain reference.

Once the window has closed, a sample drawn from the seed of the requests
the window finished, the longest of them in it, is run through the
cell's reference (`chipbench/reference/<family>.py`, float32 with TF32
off) over each prompt with its served tokens; the number compared is the
widest gap by which a served token's logit lies below the reference's
best at its position (`logit_gap`), or, where that number does not
separate the program from the control, the mean gap over the served
tokens (`mean_logit_gap`); a cell's file gives a limit to each number
it compares.  The control (`control=True`, never in a benchmark run)
reads the same numbers for the token that the float8 reference
(`reference/_ops.fp8_matmul`) puts first at each position.
"""
from __future__ import annotations

import importlib

import numpy as np


def sample(recs, opened: float, closed: float, seed: int, tokens: int, at_most: int):
    """The requests to compare: of those finished in the window as asked,
    the longest (prompt + output), then others in an order drawn from the
    seed until `tokens` served tokens or `at_most` requests."""
    done = [r for r in recs if r.done and r.ok and opened < r.req.t_done <= closed]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + r.output_len, -r.index))
    rest = [r for r in done if r is not longest]
    pick, n = [longest], longest.output_len
    for i in np.random.default_rng([int(seed), 3]).permutation(len(rest)):
        if n >= tokens or len(pick) >= at_most:
            break
        pick.append(rest[i])
        n += rest[i].output_len
    return pick


def served(rec):
    """(the reference's input tokens: prompt and every served token but
    the last, the prompt's length, the served tokens)."""
    out = np.asarray(rec.req.out_tokens, np.int64)
    return np.concatenate([np.asarray(rec.prompt, np.int64), out[:-1]]), len(rec.prompt), out


def gaps(cfg: dict, weights: dict, items, device, control: bool = False) -> dict:
    """Over `items` ([(tokens, n_prompt, served)]): the widest logit gap of
    the served tokens (`logit_gap`), their mean gap (`mean_logit_gap`),
    the served token count, and with `control` the same two numbers of
    the float8 control's first choices (`control_gap`,
    `control_mean_gap`)."""
    import torch

    from reference import _ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = importlib.import_module(f"reference.{cfg['reference']}")
    per, ctl = [], []
    with torch.no_grad():
        for toks, n_prompt, srv in items:
            t = torch.as_tensor(toks, device=device)
            s = torch.as_tensor(srv, device=device)
            r = ref.logits(cfg, weights, t, n_prompt)
            per.append(_ops.logit_gaps(r, s).cpu())
            if control:
                c = ref.logits(cfg, weights, t, n_prompt, mm=_ops.fp8_matmul)
                ctl.append(_ops.logit_gaps(r, s, c).cpu())
    g = torch.cat(per)
    out = {"logit_gap": float(g.max()), "mean_logit_gap": float(g.mean()),
           "served_tokens": int(g.numel())}
    if control:
        c = torch.cat(ctl)
        out.update(control_gap=float(c.max()), control_mean_gap=float(c.mean()))
    return out
