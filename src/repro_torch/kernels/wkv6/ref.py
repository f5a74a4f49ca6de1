"""Plain PyTorch versions of the WKV6 kernel: the CPU path of `ops` and
the oracle the CUDA kernel is held against.

Both evaluate the recurrence the way the JAX model does
(`repro.models.rwkv6`): step by step for one token (`wkv_sequential`),
and for longer inputs chunk by chunk in closed form (`wkv_chunked`):
pairwise decays exp(Lp[t] - L[s]) with exponents clipped to [-60, 0],
the state carried from chunk to chunk.  A padded tail has logw = 0 and
k = v = 0, so it leaves the final state as it was.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _sequential(r, k, v, logw, u, s0):
    """r/k/v/logw (B, S, H, D); u (B, H, D); s0 (B, H, D, Dv)."""
    state = s0.float()
    w = torch.exp(logw)
    outs = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhi,bhj->bhij", k[:, t], v[:, t])
        outs.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                 state + u[..., None] * kv))
        state = w[:, t][..., None] * state + kv
    return torch.stack(outs, 1), state


def _chunked(r, k, v, logw, u, s0, chunk: int):
    b, s, h, _ = r.shape
    pad = (-s) % chunk
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, logw))
    n = r.shape[1] // chunk

    def resh(t):
        return t.reshape(b, n, chunk, h, t.shape[-1]).transpose(0, 1)

    rc, kc, vc, wc = resh(r), resh(k), resh(v), resh(logw)
    idx = torch.arange(chunk, device=r.device)
    tmask = (idx[:, None] > idx[None, :]).to(r.dtype)
    eye = torch.eye(chunk, dtype=r.dtype, device=r.device)
    state = s0.float()
    outs = []
    for c in range(n):
        rt, kt, vt, lw = rc[c], kc[c], vc[c], wc[c]       # (B, C, H, D)
        L = torch.cumsum(lw, dim=1)                       # inclusive
        Lp = L - lw                                       # exclusive
        # inter-chunk: decay from the chunk's start
        o = torch.einsum("bchd,bhde->bche", rt * torch.exp(Lp), state)
        # intra-chunk pairwise decays P[t, s, i] = exp(Lp[t, i] - L[s, i])
        P = torch.exp(torch.clamp(Lp[:, :, None] - L[:, None, :], -60.0, 0.0))
        P = P * tmask[None, :, :, None, None]
        A = torch.einsum("bthd,bshd,btshd->bths", rt, kt, P)
        diag = torch.einsum("bthd,bhd,bthd->bth", rt, u, kt)
        A = A + diag[..., None] * eye[None, :, None, :]
        outs.append(o + torch.einsum("bths,bshe->bthe", A, vt))
        decay_all = torch.exp(L[:, -1])                   # (B, H, D)
        decay_tail = torch.exp(torch.clamp(L[:, -1:] - L, -60.0, 0.0))
        state = state * decay_all[..., None] + \
            torch.einsum("bshd,bshe->bhde", kt * decay_tail, vt)
    return torch.cat(outs, 1)[:, :s], state


def wkv6_bshd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                  chunk: int = 64):
    """Model layout: r/k/logw (B, S, H, D), v (B, S, H, Dv), u (H, D) or
    (B, H, D), s0 (B, H, D, Dv).  Computes in float32 whatever the input
    dtype and returns (o (B, S, H, Dv) in r's dtype, s_final (B, H, D, Dv)
    float32), as the JAX `wkv6_pallas` casts: sequential for S = 1,
    chunked otherwise."""
    dt = r.dtype
    r, k, v, logw = (t.float() for t in (r, k, v, logw))
    ub = u.float().expand(r.shape[0], *r.shape[2:])
    if r.shape[1] == 1:
        o, s = _sequential(r, k, v, logw, ub, s0)
    else:
        o, s = _chunked(r, k, v, logw, ub, s0, chunk)
    return o.to(dt), s


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
             chunk: int = 64):
    """The JAX op's layout: r/k/logw (BH, S, D), v (BH, S, Dv), u
    (BH, 1, D), s0 (BH, D, Dv).  Returns (o (BH, S, Dv), s_final (BH, D, Dv)); the chunk
    is cut to S, as the JAX op cuts it."""
    o, s = wkv6_bshd_ref(r[:, :, None], k[:, :, None], v[:, :, None],
                         logw[:, :, None], u, s0[:, None],
                         chunk=min(chunk, r.shape[1]))
    return o[:, :, 0], s[:, 0]
