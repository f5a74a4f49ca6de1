"""Sharding rules of the port (from `repro.parallel.sharding`): one place
that maps every parameter and cache leaf to a spec over the ("pod",
"data", "model") mesh, and the explicit tensor parallelism that carries
them out over `torch.distributed`.

A spec is a tuple with one entry a dim: None (replicated), an axis name
or a tuple of axis names (the dim split over their flattened grid), as
a JAX `PartitionSpec`.  The rules are the JAX table, regex for regex
(TP over "model", DP over ("pod", "data"), EP = experts over "model"):

  * attention: wq/wuq sharded on the head (output) dim, wo on the input
    dim, wk/wv when the kv dim divides the model axis;
  * MLP: w_in/w_gate on d_ff, w_out on d_ff (its input dim);
  * MoE: experts_* on the expert dim (EP), else TP on f;
  * embed/head: vocab-sharded;
  * a dim shards only when the axis divides it, else it is replicated.
Stacked-layer params (under "segments/") have a leading layer dim that
never shards.

**One departure from GSPMD.**  GSPMD may split a head's columns (smollm's
wq of 576 columns over 2 ranks holds 4.5 heads a rank) and reshards
around the attention.  Explicit tensor parallelism runs each rank's
heads whole, so given the model config (`cfg=`) the port shards the
head-carrying leaves of an attention only on whole heads: all of its
query and KV heads (MLA: its heads) must divide the axis, else the
attention's leaves are replicated.  With `cfg` the QKV biases shard with
their projections' columns (the JAX rules, with no bias rule, replicate
them: GSPMD reshards the add).  Without `cfg`, `param_spec_map` gives
the JAX table exactly.

Under a mesh the model reads `current_mesh()`: the one mesh the serving
engine enters (`use_mesh`) around prefill and decode, or the training
step around its loss (`use_mesh(data_split=True)`: each rank holds its
rows of the global batch, `split_axes()`); None outside it.  A dense KV
state whose slots split over "data" decodes its own slots the same way
(`use_mesh(data_split=True, lanes=...)`: `row_lanes()` says where its
rows sit in the step's global lane order), and one whose single
sequence's cache length splits over "data" decodes under
`use_mesh(seq_split=True)` (`seq_axes()`); a cache whose length splits
over "model" under `use_mesh(seq_split="model")`.  `decode_split` reads
those keywords off a cache's `cache_specs` for every family (with
`seq_leaves`, the KV leaves whose length splits: whisper's cross KV may
stay whole where its self KV splits), and `local_tree` cuts a whole
cache to a rank's blocks.  For
training, `optimizer_shardings` and `data_shardings` give the optimizer
state's and the batch's specs (path -> spec maps, as `param_spec_map`),
and `gather_whole` / `local_slice` move a leaf between its whole form
and a rank's block.

**What a rank holds** (`hold`).  By default ("tp") a rank holds each
leaf as the block tensor parallelism computes with: `param_spec` with
the whole-heads rule.  Two other layouts hold a leaf as JAX's table
places it, without the whole-heads rule: "jax" (the table as JAX's
`params_shardings` applies it) and "fsdp" (the table over DP too,
ZeRO-3: a dim over ("data", "model") or ("pod", "data", "model"), as
JAX's dry run sets for its FSDP archs).  The model then gathers each
such leaf to its TP block only while its layer runs
(`collectives.gather_held`; a rank holds at most one layer's gathered
weights), and the gradient comes back to the held block already summed
over the DP ranks.  Every family takes every hold.  Under "jax" and
"fsdp" a recurrent state is held as JAX's `cache_shardings` places it
(`state_specs`): rglru's `h` and conv window whole on "model" (at
long_500k `h`'s channels over the DP axes), rwkv6's `wkv` on its key
dim; the decoder moves each leaf to the block its layer computes with
and the new state back (`state_layouts`, `move_state`, `reshard`).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import re
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.bridge import tree_map, tree_paths
from repro_torch.parallel.mesh import Mesh, MeshShape

Spec = tuple


def axis_size(mesh, name) -> int:
    if mesh is None:
        return 1
    if isinstance(name, (tuple, list)):
        n = 1
        for a in name:
            n *= axis_size(mesh, a)
        return n
    return mesh.shape[name] if name in mesh.shape else 1


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


DP_AXES = ("pod", "data")


def dp_axes(mesh):
    return tuple(a for a in DP_AXES if a in mesh.shape) or None


# --- parameter rules --------------------------------------------------------

def _shard_axis(mesh, dim: int, fsdp: bool):
    """The widest candidate axis (fsdp: over DP too, ZeRO-3 style) that
    divides `dim`, else None."""
    cands = ([("pod", "data", "model"), ("data", "model"), "model"]
             if fsdp else ["model"])
    for c in cands:
        names = c if isinstance(c, tuple) else (c,)
        if all(n in mesh.shape for n in names) and _div(dim, axis_size(mesh, c)):
            return c
    return None


def _param_rules():
    def col(mesh, shape, fsdp):     # shard last dim
        return (*([None] * (len(shape) - 1)), _shard_axis(mesh, shape[-1], fsdp))

    def row(mesh, shape, fsdp):     # shard first-of-matrix dim
        return (_shard_axis(mesh, shape[0], fsdp), *([None] * (len(shape) - 1)))

    def expert_in(mesh, shape, fsdp):   # (E, d, f): EP, else TP on f
        ax = _shard_axis(mesh, shape[0], fsdp)
        if ax is not None:
            return (ax, *([None] * (len(shape) - 1)))
        return (None, *([None] * (len(shape) - 2)),
                _shard_axis(mesh, shape[-1], False))

    def expert_out(mesh, shape, fsdp):  # (E, f, d): EP, else TP on f
        ax = _shard_axis(mesh, shape[0], fsdp)
        if ax is not None:
            return (ax, *([None] * (len(shape) - 1)))
        return (None, _shard_axis(mesh, shape[1], False), *([None] * (len(shape) - 2)))

    def repl(mesh, shape, fsdp):
        return (None,) * len(shape)

    return [
        (r"(^|/)embed$", row),                      # (V, d) vocab-sharded
        (r"(^|/)head$", col),                       # (d, V)
        (r"(^|/)dec_pos$", repl),
        (r"/attn/w(q|uq)$", col),
        (r"/attn/w(k|v)$", col),
        (r"/attn/wo$", row),
        (r"/attn/w(dq|dkv)$", repl),
        (r"/attn/w(uk|uv)$", col),
        (r"/(self_attn|cross_attn)/w[qkv]$", col),
        (r"/(self_attn|cross_attn)/wo$", row),
        (r"/mlp/w_(in|gate)$", col),
        (r"/mlp/w_out$", row),
        (r"/moe/experts_(in|gate)$", expert_in),
        (r"/moe/experts_out$", expert_out),
        (r"/moe/router$", repl),
        (r"/moe/shared/w_(in|gate)$", col),
        (r"/moe/shared/w_out$", row),
        # rglru
        (r"/rec/w_(x|gate)$", col),
        (r"/rec/w_out$", row),
        (r"/rec/(wa|wx_in)$", col),
        (r"/rec/(conv_w|conv_b|lam)$", repl),
        # rwkv6
        (r"/att/w[rkvg]$", col),
        (r"/att/wo$", row),
        (r"/att/w[ab]$", repl),
        (r"/ffn/wk$", col),
        (r"/ffn/wv$", row),
        (r"/ffn/wr$", col),
        (r"/mtp/proj$", repl),
    ]


_RULES = _param_rules()

# leaves whose sharded dim carries attention heads (whole-heads rule)
HEAD_LEAVES = re.compile(
    r"/attn/w(q|k|v|o|uq|uk|uv)$|/(self_attn|cross_attn)/w[qkvo]$|/att/w[rkvgo]$")
# QKV biases: sharded with their projection's columns under the cfg rules
BIAS_LEAVES = re.compile(r"/(attn|self_attn|cross_attn)/b[qkv]$")


def attn_heads(cfg) -> tuple[int, ...]:
    """The head counts an attention's shards must split whole: query and
    KV heads, MLA's query heads (its latent has none), rwkv6's time-mix
    heads (d_model / head_dim)."""
    if cfg.family == "rwkv6":
        return (cfg.d_model // cfg.hd,)
    return (cfg.n_heads,) if cfg.use_mla else (cfg.n_heads, cfg.kv_heads)


def heads_shard(cfg, n: int) -> bool:
    """Whether an attention shards over n ranks on whole heads."""
    return n > 1 and all(_div(h, n) for h in attn_heads(cfg))


def path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def param_spec(mesh, path: str, shape, stacked: bool, fsdp: bool = False,
               cfg=None) -> Spec:
    """The spec of the leaf at `path` ('/'-joined) of `shape`; `stacked`:
    a leading layer dim that never shards.  `cfg`: apply the whole-heads
    rule and shard the QKV biases (see the module docstring)."""
    base_shape = tuple(shape[1:]) if stacked else tuple(shape)
    spec = None
    if cfg is not None and BIAS_LEAVES.search(path):
        spec = (_shard_axis(mesh, base_shape[-1], fsdp),)
    for pat, fn in _RULES:
        if spec is None and re.search(pat, path):
            spec = fn(mesh, base_shape, fsdp)
    if spec is None:
        spec = (None,) * len(base_shape)
    if cfg is not None and (HEAD_LEAVES.search(path) or BIAS_LEAVES.search(path)):
        ax = next((a for a in spec if a is not None), None)
        if ax is not None and not heads_shard(cfg, axis_size(mesh, ax)):
            spec = (None,) * len(base_shape)
    return (None, *spec) if stacked else tuple(spec)


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def _stacked(ps: str, x) -> bool:
    return "segments/" in ps and len(x.shape) >= 1


def param_spec_map(mesh, params: Any, fsdp: bool = False, *, cfg=None) -> dict[str, Spec]:
    """'/'-joined path -> spec for every leaf of a params tree (of tensors,
    or of anything with a `.shape`)."""
    out = {}
    for path, x in _leaves_with_paths(params):
        ps = path_str(path)
        out[ps] = param_spec(mesh, ps, tuple(x.shape), _stacked(ps, x), fsdp, cfg)
    return out


HOLDS = ("tp", "jax", "fsdp")


def held_spec(mesh, path: str, shape, stacked: bool, cfg, hold: str = "tp") -> Spec:
    """The spec of the block a rank holds of the leaf at `path` under
    `hold` (see the module docstring): the TP spec for "tp", JAX's table
    (over DP too for "fsdp") otherwise."""
    if hold not in HOLDS:
        raise ValueError(f"hold {hold!r}: one of {HOLDS}")
    if hold == "tp":
        return param_spec(mesh, path, shape, stacked, cfg=cfg)
    return param_spec(mesh, path, shape, stacked, fsdp=hold == "fsdp")


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """A leaf's per-rank shape under `spec`."""
    return tuple(n if a is None else n // axis_size(mesh, a)
                 for n, a in zip(shape, spec))


def leaf_block(mesh: Mesh, cfg, path: str, shape, stacked: bool = False,
               hold: str = "tp"):
    """(this rank's shape, a function cutting its block out of a tensor of
    `shape`) for the leaf at `path`, by `held_spec`: the TP block with the
    whole-heads rule ("tp"), or JAX's block ("jax", "fsdp"), which the
    model gathers to the TP block while its layer runs."""
    shape = tuple(shape)
    spec = held_spec(mesh, path, shape, stacked, cfg, hold)
    if all(a is None for a in spec):
        return shape, lambda t: t
    return local_shape(shape, spec, mesh), lambda t: local_slice(t, spec, mesh)


def block_cutter(mesh, cfg, hold: str = "tp"):
    """`cut(path, t)`: this rank's block of the leaf `t` at `path` held as
    `hold` (`leaf_block`), or `t` itself without a mesh; the families'
    inits cut each leaf as it is drawn."""
    if mesh is None:
        return lambda path, t: t
    return lambda path, t: leaf_block(mesh, cfg, path, tuple(t.shape), hold=hold)[1](t)


def local_slice(t: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of t under `spec`, as a tensor of its own."""
    for dim, a in enumerate(spec):
        if a is None:
            continue
        n = axis_size(mesh, a)
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.axis_rank(a) * size, size)
    return t.clone()


def local_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's blocks of every leaf of a whole tree under `specs` (a
    tree of specs of the same structure): `local_slice` mapped over it,
    e.g. a whole decode cache cut to a rank's blocks of `cache_specs`.  A
    block is a contiguous run of each split dim, so a ring's slot order,
    and a cross KV's encoder positions, survive the cut."""
    return tree_map(lambda t, s: local_slice(t, s, mesh), tree, specs)


def reshard(t: torch.Tensor, mesh, src: Spec, dst: Spec) -> torch.Tensor:
    """A rank's block `t` of a leaf under spec `src` as its block of the
    same leaf under `dst`: along each dim whose entries differ, the block
    gathered whole over `src`'s axes (a counted `all_gather`, so the dry
    run's collective bytes include the move), then cut to `dst`'s block.
    Either way round: held -> compute and compute -> held.  `t` itself
    where the specs agree; no gradient."""
    from repro_torch.parallel import collectives as coll
    moved = [d for d, (a, b) in enumerate(zip(src, dst)) if spec_axes((a,)) != spec_axes((b,))]
    for d in moved:
        if src[d] is not None:
            t = coll.all_gather(t, mesh, src[d], dim=d)
    for d in moved:
        if dst[d] is not None:
            size = t.shape[d] // axis_size(mesh, dst[d])
            t = t.narrow(d, mesh.axis_rank(dst[d]) * size, size)
    return t.contiguous() if moved else t


def shard_params(params: Any, mesh: Mesh, cfg, hold: str = "tp") -> Any:
    """This rank's blocks of every parameter of a whole tree (`leaf_block`
    under `hold`; the same tree, replicated leaves the tensors given).
    The blocks `api.init_params(mesh=, hold=)` draws are these, bit for
    bit."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, prefix + (i,)) for i, v in enumerate(tree))
        if tree is None:
            return None
        ps = path_str(prefix)
        return leaf_block(mesh, cfg, ps, tree.shape, _stacked(ps, tree), hold)[1](tree)
    return walk(params, ())


def held_spec_map(mesh, params: Any, cfg, hold: str = "tp") -> dict[str, Spec]:
    """'/'-joined path -> `held_spec` for every leaf of a whole params tree
    (anything with a `.shape`)."""
    return {path_str(path): held_spec(mesh, path_str(path), tuple(x.shape),
                                      _stacked(path_str(path), x), cfg, hold)
            for path, x in _leaves_with_paths(params)}


@functools.lru_cache(maxsize=32)
def _spec_maps(cfg, names: tuple, sizes: tuple, hold: str):
    mesh = MeshShape(names, dict(zip(names, sizes)))
    whole = whole_shapes(cfg)
    return held_spec_map(mesh, whole, cfg, hold), param_spec_map(mesh, whole, cfg=cfg)


@functools.lru_cache(maxsize=32)
def whole_shapes(cfg):
    """`api.param_shapes(cfg)`, cached: the whole parameter tree as `meta`
    tensors."""
    from repro_torch.models import api
    return api.param_shapes(cfg)


def spec_maps(cfg, mesh, hold: str = "tp") -> tuple[dict, dict]:
    """(held specs, TP specs) by '/'-joined path for every parameter of
    `cfg` on `mesh` (read from the whole shapes, `api.param_shapes`;
    cached by the mesh's shape)."""
    names = tuple(mesh.axis_names)
    return _spec_maps(cfg, names, tuple(mesh.shape[a] for a in names), hold)


def compute_tree(cfg, tree: Any, prefix: str, layer: bool = False) -> Any:
    """`tree` (this rank's held parameters at path `prefix`: a leaf, a
    subtree, or with `layer` one layer's views of a stacked segment) with
    every leaf held in a block other than its TP block gathered to the
    TP block (`collectives.gather_held`) under the enclosing
    `use_mesh(hold=)`; `tree` itself where the rank holds TP blocks."""
    mesh, hold = current_mesh(), current_hold()
    if mesh is None or hold == "tp":
        return tree
    from repro_torch.parallel import collectives as coll
    held, comp = spec_maps(cfg, mesh, hold)
    rows = split_axes()

    def walk(t, at):
        if isinstance(t, dict):
            return {k: walk(v, f"{at}/{k}") for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, f"{at}/{i}") for i, v in enumerate(t))
        if t is None:
            return None
        h, c = held[at], comp[at]
        return coll.gather_held(t, mesh, h[1:] if layer else h, c[1:] if layer else c, rows)

    return walk(tree, prefix)


def _probe(cfg, params: Any, plan) -> tuple:
    """(got, expected) widths of a leaf `tp_plan` cuts in each family: the
    embedding's rows and the first layer's query columns (rwkv6: its
    receptance, rglru: its first recurrent block's `w_x` or its MLP)."""
    rows = cfg.vocab // plan.tp if plan.vocab else cfg.vocab
    fam = cfg.family
    if fam == "transformer":
        attn = next(iter(params["segments"][0].values()))["attn"]
        q = cfg.n_heads * (cfg.hd + (cfg.mla_rope_dim if cfg.use_mla else 0))
        col, want = attn["wuq" if cfg.use_mla else "wq"].shape[-1], q // plan.tp if plan.attn else q
    elif fam == "rwkv6":
        col, want = params["layers"][0]["att"]["wr"].shape[-1], \
            cfg.d_model // plan.tp if plan.attn else cfg.d_model
    elif fam == "whisper":
        col, want = params["dec_layers"][0]["self_attn"]["wq"].shape[-1], \
            cfg.d_model // plan.tp if plan.attn else cfg.d_model
    else:
        rec = next((p["rec"] for p in params["layers"] if "rec" in p), None)
        if rec is not None:
            w = cfg.lru_width or cfg.d_model
            col, want = rec["w_x"].shape[-1], w // plan.tp if plan.rec else w
        else:
            col, want = params["layers"][0]["mlp"]["w_in"].shape[-1], \
                cfg.d_ff // plan.tp if plan.mlp else cfg.d_ff
    return (params["embed"].shape[0], col), (rows, want)


def check_shards(cfg, params: Any, mesh: Mesh, hold: str = "tp") -> None:
    """Raise ValueError unless `params` hold this rank's blocks under
    `mesh`: the embedding's rows and the first layer's query (or
    recurrent) columns must be the widths `tp_plan` cuts them to (a whole
    tree run where blocks belong would be summed over the ranks); under
    another `hold`, every leaf's shape must be its held block's."""
    if hold not in HOLDS:
        raise ValueError(f"hold {hold!r}: one of {HOLDS}")
    if hold != "tp":
        held = spec_maps(cfg, mesh, hold)[0]
        whole = {path_str(p): tuple(x.shape) for p, x in _leaves_with_paths(whole_shapes(cfg))}
        bad = [(path_str(p), tuple(t.shape)) for p, t in _leaves_with_paths(params)
               if tuple(t.shape) != local_shape(whole[path_str(p)], held[path_str(p)], mesh)]
        if bad:
            raise ValueError(f"params are not this rank's {hold!r} blocks over "
                             f"{dict(mesh.shape)}: {bad[:3]} (draw them with "
                             f"api.init_params(mesh=, hold=) or cut them with shard_params)")
        return
    got, want = _probe(cfg, params, tp_plan(cfg, mesh))
    if got != want:
        raise ValueError(f"params are not this rank's shards over {dict(mesh.shape)}: "
                         f"embedding rows and query columns {got}, expected {want} "
                         f"(draw them with api.init_params(mesh=) or cut them with "
                         f"shard_params)")


def local_range(plan, n: int, sharded: bool) -> tuple[int, int]:
    """(start, length) of this rank's block of n channels or heads: its
    "model" coordinate's n / tp where `sharded`, else the whole (0, n)."""
    if plan is None or not sharded:
        return 0, n
    k = n // plan.tp
    return plan.mesh.coord("model") * k, k


# --- activation / batch / cache rules ----------------------------------------

def batch_spec(mesh, batch_size: int, ndim: int) -> Spec:
    dp = dp_axes(mesh)
    if dp and _div(batch_size, axis_size(mesh, dp)):
        return (dp, *([None] * (ndim - 1)))
    return (None,) * ndim


def data_shardings(mesh, batch: dict) -> dict[str, Spec]:
    """key -> spec for every leaf of a batch dict (the JAX
    `data_shardings`): the leading (batch) dim over DP where it divides,
    every other dim replicated (embeds (B, S, d) likewise)."""
    return {k: batch_spec(mesh, v.shape[0], len(v.shape)) for k, v in batch.items()}


_OPT_PREFIXES = ("inner/mu/", "inner/nu/", "inner/v/", "error_feedback/")


def optimizer_shardings(mesh, params_shape: Any, opt_shape: Any, *,
                        cfg=None, hold: str = "tp") -> dict[str, Spec]:
    """'/'-joined path -> spec for every leaf of an optimizer-state tree
    (the JAX `optimizer_shardings`): AdamW's moments, Adafactor's
    unfactored `v` and the error feedback mirror their parameter's spec;
    Adafactor's factored `vr` drops the last entry, `vc` the one before
    the last; the step count (and any leaf without a parameter) is
    replicated.  `params_shape`: the whole parameter tree (anything with
    a `.shape`), `cfg` as `param_spec_map` takes it; `hold`: the state
    mirrors the held blocks (`held_spec`: "fsdp" is JAX's
    `optimizer_shardings(fsdp=True)`)."""
    pmap = param_spec_map(mesh, params_shape, False, cfg=cfg) if hold == "tp" \
        else held_spec_map(mesh, params_shape, cfg, hold)
    out = {}
    for path, x in _leaves_with_paths(opt_shape):
        ps = path_str(path)
        ndim = len(x.shape)
        rest, tail = ps, None
        for prefix in _OPT_PREFIXES:
            if ps.startswith(prefix):
                rest = ps[len(prefix):]
                break
        for t in ("/vr", "/vc", "/v"):
            if rest.endswith(t):
                tail, rest = t, rest[: -len(t)]
                break
        spec = pmap.get(rest)
        if spec is None:
            out[ps] = (None,) * ndim
            continue
        parts = list(spec)
        if tail == "/vr":
            parts = parts[:-1]
        elif tail == "/vc":
            parts = parts[:-2] + parts[-1:]
        out[ps] = tuple((parts + [None] * ndim)[:ndim])
    return out


def leaf_specs(tree: Any, specs: dict) -> list:
    """The specs of `tree`'s leaves in `bridge.tree_leaves` order, read
    from `specs` ('/'-joined path -> spec) at each leaf's path."""
    return [specs[path_str(path)] for path, _ in tree_paths(tree)]


def spec_axes(spec: Spec) -> tuple:
    """The mesh axes a spec shards over, in the order of its dims."""
    out: list = []
    for a in spec:
        for n in ((a,) if isinstance(a, str) else (a or ())):
            if n not in out:
                out.append(n)
    return tuple(out)


def global_shape(shape, spec: Spec, mesh) -> tuple:
    """The whole leaf's shape of a rank's block of `shape` under `spec`."""
    return tuple(n if a is None else n * axis_size(mesh, a) for n, a in zip(shape, spec))


def gather_whole(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block `t` under `spec` (the
    inverse of `local_slice`; no gradient)."""
    from repro_torch.parallel import collectives as coll
    with torch.no_grad():
        for dim, a in enumerate(spec):
            if a is not None:
                t = coll.all_gather(t, mesh, a, dim=dim)
    return t


def gather_tree(tree: Any, specs: dict, mesh) -> list[tuple[str, torch.Tensor]]:
    """('/'-joined path, the whole leaf) of every leaf of a tree of this
    rank's blocks, in `bridge.tree_paths` order, `specs` by path (every
    rank takes part in each gather)."""
    return [(path_str(path), gather_whole(torch.as_tensor(t).detach(),
                                          specs[path_str(path)], mesh))
            for path, t in tree_paths(tree)]


def cache_specs(mesh, cache: Any, kv_heads: int, batch_size: int,
                seq_shard: bool = False, *, n_heads: int | None = None) -> Any:
    """Specs of a dense cache tree, JAX's `cache_shardings` leaf for leaf:
    the batch over DP when it divides (a batch of one long sequence: its
    length over "data", SP); then "model" on the second-to-last dim when
    it divides, is at least the axis and is not the batch dim or already
    split: the kv-head dim of a {k, v} leaf (L, B, C, Hkv, hd), where
    the heads split whole (`n_heads`: the query heads, checked too where
    given), and the cache length C of MLA's latent (L, B, C, D).
    `seq_shard`: where no dim took "model", the cache length goes over
    "model" when it divides and C >= 4 x the axis.  A length over "model"
    decodes by the partial-softmax combine over "model"
    (`use_mesh(seq_split="model")`), in every family's decoder.  A
    per-layer cache ("layers": rglru, rwkv6, whisper) has its batch on
    axis 0, its length on axis 1.  The serving engine's bf16 / f32
    dense rectangles take this rule (`DenseKVState.place`): a data rank
    holds its block of the slots, or of one slot's cache length, and a
    model rank its KV heads or its block of the length."""
    dp = dp_axes(mesh)
    dsz = axis_size(mesh, dp) if dp else 1
    msz = axis_size(mesh, "model")
    heads_ok = n_heads is None or _div(n_heads, msz)

    def leaf(path, x):
        ps = path_str(path)
        shape = tuple(x.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        dims: list = [None] * nd
        bdim = 1 if ("segments" in ps and nd >= 3) else 0
        if dp and _div(shape[bdim], dsz) and shape[bdim] > 1:
            dims[bdim] = dp
        elif nd > bdim + 1 and dp and _div(shape[bdim + 1], dsz) \
                and shape[bdim] == 1 and shape[bdim + 1] >= dsz:
            dims[bdim + 1] = dp            # SP on the cache length dim
        assigned = False
        i = nd - 2
        if i > bdim and dims[i] is None and _div(shape[i], msz) and shape[i] >= msz \
                and (nd != 5 or heads_ok):
            dims[i] = "model"
            assigned = True
        cdim = bdim + 1
        if seq_shard and not assigned and nd >= cdim + 2 \
                and dims[cdim] is None and _div(shape[cdim], msz) \
                and shape[cdim] >= 4 * msz:
            dims[cdim] = "model"
        return tuple(dims)

    return _map_with_path(leaf, cache)


def kv_head_specs(mesh, pool_segments: Any, kv_heads: int, *,
                  n_heads: int | None = None) -> Any:
    """Specs of the paged pools (the JAX `paged_cache_shardings`): only the
    kv-head dim of a (L, pages, page_size, Hkv, hd) pool (or of its int8
    scales, (L, pages, 1, Hkv, 1)) shards over "model", on whole heads;
    the page dims never shard (one global pool addressed through per-slot
    tables), and MLA's latent pool stays replicated.  The serving engine's
    int8 dense rectangles (and their scales) take the same rule: every
    rank holds every slot, as JAX leaves them unplaced."""
    msz = axis_size(mesh, "model")
    heads_ok = n_heads is None or _div(n_heads, msz)

    def leaf(path, x):
        shape = tuple(x.shape)
        dims: list = [None] * len(shape)
        if len(shape) == 5 and heads_ok and shape[3] == kv_heads \
                and _div(kv_heads, msz) and kv_heads >= msz:
            dims[3] = "model"
        return tuple(dims)

    return _map_with_path(leaf, pool_segments)


def layer_state_specs(mesh, cfg, layers: Any) -> Any:
    """Specs of the recurrent and cross-attention states' per-layer leaves
    (batch on axis 0), on the "model" dims the port's TP computes with:
    rglru's `h` (B, w) and conv window (B, cw - 1, w) at local channels
    where its recurrent block shards; rwkv6's `wkv` (B, H, hd, hd) at
    local heads where its time mix shards, else at the rank's block of
    each head's key dim where hd splits (`TPPlan.keys`: JAX's
    `cache_shardings` split); the KV of rglru's ring and whisper's self
    and cross attention (B, C, H, hd) at local heads where the attention
    shards on whole heads.  The token shifts (B, 1, d) stay whole: the
    residual stream is replicated.  The batch never shards (every rank
    holds every slot).  What a rank holds under the weights' `hold`:
    `state_specs`."""
    plan = tp_plan(cfg, mesh)

    def leaf(path, x):
        dims: list = [None] * len(x.shape)
        name = path[-1]
        if name in ("h", "conv") and plan.rec:
            dims[-1] = "model"
        elif name == "wkv" and (plan.attn or plan.keys):
            dims[2 if plan.keys else 1] = "model"
        elif name in ("k", "v", "ck", "cv") and plan.attn:
            dims[2] = "model"
        return tuple(dims)

    return _map_with_path(leaf, layers)


class _Shape:
    """A stand-in with a `.shape`, for the spec rules."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def state_specs(mesh, cfg, shapes: dict, hold: str = "tp", *, rows=None,
                sp: bool = False, seq_shard: bool = False) -> dict:
    """Specs of one layer's recurrent or cross-attention state leaves
    (`shapes`: name -> the whole leaf's shape, the batch on axis 0) as a
    rank holds them: the rows over `rows` (the DP axes a decode's rows
    split over; None: every rank holds every row); under "tp" the
    "model" dims the port's TP computes with (`layer_state_specs`);
    under "jax" / "fsdp" JAX's `cache_shardings` (`cache_specs`), which
    may differ from those: rglru's `h` and conv window stay whole on
    "model" (its recurrent block computes on its channels), rwkv6's `wkv`
    takes its key dim where its time mix holds whole heads, and with `sp`
    (a batch of one sequence whose cache length splits over the DP axes)
    a leaf's second dim goes over the DP axes where it divides (`h`'s
    channels).  `seq_shard`: the config's `cache_seq_shard` (JAX's dry
    run reads it; its engine does not)."""
    objs = {k: _Shape(v) for k, v in shapes.items()}
    if hold == "tp":
        specs = layer_state_specs(mesh, cfg, [objs])[0]
        return {k: (rows, *s[1:]) for k, s in specs.items()}
    if rows is None and not sp:     # every rank holds every row: no DP rule
        mesh = MeshShape(("model",), {"model": axis_size(mesh, "model")})
    batch = next(iter(shapes.values()))[0]
    return cache_specs(mesh, objs, cfg.kv_heads, batch, seq_shard, n_heads=cfg.n_heads)


def state_layouts(cfg, batch: int, dims: dict):
    """(held, compute) specs of one layer's state leaves inside the
    enclosing `use_mesh` (`state_specs` under its hold, and under "tp"),
    or None where they agree (no mesh, "tp", or the same blocks): `dims`
    name -> the whole leaf's dims after the batch, `batch` this rank's
    rows.  A decoder moves each held leaf to its compute block before its
    block runs and the new state back (`move_state`)."""
    mesh, hold = current_mesh(), current_hold()
    if mesh is None or hold == "tp":
        return None
    rows = split_axes()
    seq = seq_axes()
    whole = batch * axis_size(mesh, rows) if rows else batch
    shapes = {k: (whole, *d) for k, d in dims.items()}
    held = state_specs(mesh, cfg, shapes, hold, rows=rows,
                       sp=seq is not None and "model" not in seq,
                       seq_shard=cfg.cache_seq_shard)
    comp = state_specs(mesh, cfg, shapes, "tp", rows=rows)

    def live(spec):         # an axis of one rank splits nothing
        return [tuple(n for n in spec_axes((a,)) if axis_size(mesh, n) > 1) for a in spec]
    return None if all(live(held[k]) == live(comp[k]) for k in dims) else (held, comp)


def move_state(st: dict, layouts, back: bool = False) -> dict:
    """A layer's state leaves named in `layouts` (`state_layouts`) moved
    from their held blocks to their compute blocks (`back`: the other way
    round) by `reshard`; the others, and every leaf where `layouts` is
    None, as they are."""
    if layouts is None:
        return st
    src, dst = layouts[::-1] if back else layouts
    mesh = current_mesh()
    return {k: reshard(t, mesh, src[k], dst[k]) if k in src else t for k, t in st.items()}


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def local_cache_shapes(mesh, cache: Any, specs: Any) -> Any:
    """Each cache leaf's per-rank shape under its spec (a tree of tuples)."""
    return tree_map(lambda x, s: local_shape(tuple(x.shape), s, mesh), cache, specs)


KV_LEAVES = ("k", "v", "ck", "cv", "latent")


def _kv_dims(specs: Any):
    """(batch, length) entries of the specs of a dense cache's first KV
    leaf: dims 1 and 2 of the (L, B, C, ...) leaves of "segments", dims 0
    and 1 of a per-layer "k" (B, C, ...) of "layers" (rglru's ring,
    whisper's self KV); None where the cache has no KV leaf (rwkv6)."""
    if "segments" in specs:
        spec = next(iter(specs["segments"][0].values()))
        return spec[1], spec[2]
    for layer in specs.get("layers", ()):
        if "k" in layer:
            return layer["k"][0], layer["k"][1]
    return None


def dense_split(mesh, specs: Any):
    """How `cache_specs`' specs split a dense cache over the DP axes:
    "rows" (the slots), "seq" (a single slot's cache length, SP) or None
    (every data rank holds the whole rectangle: no DP axis of more than
    one rank, neither dim divides, or no KV leaf).  The cache length may
    split over "model" besides (`length_axes`)."""
    dp = dp_axes(mesh) if mesh is not None else None
    dims = _kv_dims(specs)
    if dp is None or axis_size(mesh, dp) == 1 or dims is None:
        return None
    if dims[0] is not None:
        return "rows"
    return "seq" if dims[1] is not None and "model" not in spec_axes((dims[1],)) else None


def length_axes(mesh, specs: Any):
    """The mesh axes of more than one rank that `cache_specs`' specs split
    a dense cache's length over (that of its first KV leaf: `_kv_dims`):
    the DP axes under SP, ("model",) where the length goes over "model"
    (MLA's latent, `seq_shard`), else None."""
    dims = _kv_dims(specs) if mesh is not None else None
    if dims is None:
        return None
    axes = tuple(a for a in spec_axes((dims[1],)) if axis_size(mesh, a) > 1)
    return axes or None


def decode_split(mesh, specs: Any) -> dict:
    """The `use_mesh` keywords of a decode over a dense cache placed by
    `cache_specs`' `specs`, for the cache length: `seq_split` True where
    a single slot's length splits over the DP axes, "model" where it
    splits over "model", with `seq_leaves` naming the KV leaves whose
    length splits (whisper's cross KV stays whole where its length does
    not divide); {} where no length splits.  The rows' split
    (`data_split`) follows the tokens' spec and is the caller's."""
    split = "model" if length_axes(mesh, specs) == ("model",) else \
        (dense_split(mesh, specs) == "seq" or None)
    if split is None:
        return {}
    trees = specs["segments"] if "segments" in specs else specs["layers"]
    cdim = 2 if "segments" in specs else 1
    leaves = {k for t in trees for k, s in t.items()
              if k in KV_LEAVES and any(axis_size(mesh, a) > 1 for a in spec_axes((s[cdim],)))}
    return {"seq_split": split, "seq_leaves": frozenset(leaves)}


def place(mesh, cache: Any, specs: Any) -> Any:
    """A zero cache of per-rank shapes: every leaf reallocated at its
    local shape, dtype and device kept (the states place before any
    prefill, so no value is carried)."""
    return tree_map(lambda x, s: torch.zeros(local_shape(tuple(x.shape), s, mesh),
                                             dtype=x.dtype, device=x.device),
                    cache, specs)


# --- the explicit TP plan the model follows ------------------------------------

@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Which parts of a layer run sharded over "model" (tp ranks) under
    the param rules: attention on whole heads (rwkv6: the time mix), the
    dense MLP on d_ff (rwkv6: the channel mix's key and value), the
    vocab, MoE by experts ("ep") or on f ("f"), the shared expert on its
    f, rglru's recurrent block on its lru width (`rec`), rwkv6's
    channel-mix receptance on d (`gate`) and, where its time mix's heads
    do not split whole but its head dim does, its WKV recurrence on the
    rank's block of each head's key dim (`keys`: the state split as JAX's
    `cache_shardings` splits it, the output summed over "model").  Each
    sharded part ends in one `all_reduce` (the unembedding, rwkv6's
    receptance and rglru's recurrent input to its gates in an
    `all_gather`) and, under autograd, starts at a `copy_to` of each
    replicated tensor entering it.  `dp`: the DP axes the batch's rows are split over (training, or
    a dense KV state's slots: `use_mesh(data_split=True)`), else None;
    `lanes`: where those rows sit in a serving step's global lane order
    (`row_lanes`); `sp`: the axes a dense cache's length is split over
    (`seq_axes`)."""
    mesh: Any
    tp: int
    attn: bool
    mlp: bool
    vocab: bool
    moe: str
    shared: bool
    rec: bool = False
    gate: bool = False
    keys: bool = False
    dp: Any = None
    lanes: Any = None
    sp: Any = None


def tp_plan(cfg, mesh) -> TPPlan:
    tp = axis_size(mesh, "model")
    sharded = lambda n: tp > 1 and _shard_axis(mesh, n, False) == "model"  # noqa: E731
    moe = ""
    if cfg.use_moe and tp > 1:
        moe = "ep" if sharded(cfg.n_experts) else ("f" if sharded(cfg.routed_ff) else "")
    attn = heads_shard(cfg, tp)
    return TPPlan(mesh=mesh, tp=tp, attn=attn, mlp=sharded(cfg.d_ff),
                  vocab=sharded(cfg.vocab), moe=moe,
                  shared=bool(cfg.n_shared_experts)
                  and sharded(cfg.routed_ff * cfg.n_shared_experts),
                  rec=cfg.family == "rglru" and sharded(cfg.lru_width or cfg.d_model),
                  gate=cfg.family == "rwkv6" and sharded(cfg.d_model),
                  keys=cfg.family == "rwkv6" and tp > 1 and not attn and _div(cfg.hd, tp),
                  **(dict(dp=split_axes(), lanes=row_lanes(), sp=seq_axes())
                     if mesh is current_mesh() else {}))


_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=(None, None, None, None, "tp", None))


@contextlib.contextmanager
def use_mesh(mesh, *, data_split: bool = False, lanes=None, seq_split: bool | str = False,
             seq_leaves=None, hold: str | None = None):
    """Run the enclosed model calls sharded over `mesh` (None: unsharded);
    the mesh is forgotten on exit.  `data_split`: the batch's rows are
    split over the mesh's DP axes (training, or a dense KV state's slots:
    each rank holds its rows of the global batch), else every rank holds
    the whole batch.  `lanes` (with `data_split`): (order, own), long
    tensors placing a serving step's rows in its global lane order:
    `order` (W,) picks the W lanes, in order, out of the rows gathered
    from every DP rank (rank-major), `own` (rows,) names the lane each
    local row stands for; None: the global batch is the gathered rows
    themselves.  `seq_split`: the dense cache's length is split, True over
    the DP axes (a batch of one long sequence, SP), "model" over "model"
    (MLA's latent, `cache_seq_shard`; with `data_split` or alone): decode
    attention combines the ranks' partial softmaxes.  `seq_leaves`: the
    names of the cache leaves whose length splits (`decode_split`; None:
    every KV leaf the decoder reads).  `hold`: how the ranks hold the
    weights (`HOLDS`), and a recurrent state its leaves
    (`state_layouts`); None keeps the enclosing context's on the same
    mesh, else "tp"."""
    if seq_split not in (False, True, "model"):
        raise ValueError(f"seq_split {seq_split!r}: False, True or 'model'")
    dp = dp_axes(mesh) if mesh is not None and (data_split or seq_split is True) else None
    if dp is not None and axis_size(mesh, dp) == 1:
        dp = None
    rows = dp if data_split else None
    sp = dp if seq_split is True else None
    if seq_split == "model" and mesh is not None and axis_size(mesh, "model") > 1:
        sp = ("model",)
    if hold is None:
        outer = _MESH.get()
        hold = outer[4] if mesh is not None and outer[0] is mesh else "tp"
    elif hold not in HOLDS:
        raise ValueError(f"hold {hold!r}: one of {HOLDS}")
    leaves = frozenset(seq_leaves) if sp is not None and seq_leaves is not None else None
    token = _MESH.set((mesh, rows, lanes if rows is not None else None, sp, hold, leaves))
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the enclosing `use_mesh`, else None."""
    return _MESH.get()[0]


def split_axes():
    """The DP axes the batch's rows are split over inside the enclosing
    `use_mesh(data_split=True)` (None where every rank holds the whole
    batch, or the axes hold one rank)."""
    return _MESH.get()[1]


def row_lanes():
    """The (order, own) lanes of the enclosing `use_mesh(data_split=True,
    lanes=...)`, else None."""
    return _MESH.get()[2]


def seq_axes():
    """The axes a dense cache's length is split over inside the enclosing
    `use_mesh(seq_split=)`: the DP axes (True) or ("model",) ("model");
    None: the length is whole."""
    return _MESH.get()[3]


def length_split(leaf: str | None = None):
    """The axes the length of the cache leaf named `leaf` is split over
    inside the enclosing `use_mesh`: `seq_axes()` where `seq_leaves`
    names the leaf (or names none, or `leaf` is None), else None."""
    _, _, _, sp, _, leaves = _MESH.get()
    return sp if leaf is None or leaves is None or leaf in leaves else None


def current_hold() -> str:
    """How the ranks hold the weights inside the enclosing `use_mesh`
    (`HOLDS`; "tp" outside one)."""
    return _MESH.get()[4]


# --- multi-replica serving ----------------------------------------------------

def replica_meshes(mesh, n: int) -> list:
    """Split `mesh` into `n` per-replica meshes along its "data" axis, each
    keeping the whole "model" (and "pod") extent (the JAX
    `replica_meshes`).  `mesh=None` gives `[None] * n`, n == 1 `[mesh]`;
    a mesh with no "data" axis, or one whose data axis `n` does not
    divide, raises ValueError.

    A `MeshShape` splits into shapes.  A rank's `Mesh` splits into the
    `Mesh` of the replica holding this rank (with its own subgroups) and
    `MeshShape`s of the others; every rank must call it, in the same
    order (it makes subgroups)."""
    if mesh is None:
        return [None] * n
    if n == 1:
        return [mesh]
    names = list(mesh.axis_names)
    if "data" not in names:
        raise ValueError(f"mesh {names} has no 'data' axis to split {n} replicas over")
    dsz = mesh.shape["data"]
    if dsz % n != 0:
        raise ValueError(f"data axis of size {dsz} does not divide into {n} replicas")
    shape = dict(mesh.shape, data=dsz // n)
    if not isinstance(mesh, Mesh):
        return [MeshShape(tuple(names), dict(shape)) for _ in range(n)]
    m = shape["model"]
    d = shape["data"]
    out: list = []
    for i in range(n):
        base = i * d * m
        ranks = list(range(base, base + d * m))
        groups: dict = {}
        for key, blocks in (
                (("data",), [[base + a * m + j for a in range(d)] for j in range(m)]),
                (("model",), [[base + a * m + j for j in range(m)] for a in range(d)]),
                (("data", "model"), [ranks])):
            for rs in blocks:
                g = dist.new_group([mesh.root + r for r in rs]) if len(rs) > 1 else None
                if mesh.rank in rs:
                    groups[key] = g
        if mesh.rank in ranks:
            out.append(Mesh(mesh.axis_names, dict(shape), mesh.rank - base,
                            mesh.device, groups, root=mesh.root + base))
        else:
            out.append(MeshShape(tuple(names), dict(shape)))
    return out
