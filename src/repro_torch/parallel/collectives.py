"""The collectives explicit tensor parallelism needs, over the axes of a
`parallel.mesh.Mesh`: a sum over "model" (after a row-parallel product or
a vocab-parallel lookup), the gather of column shards (the vocab, rwkv6's
receptance, rglru's recurrent input) and, over "data", of a cluster's
per-step events or of a data-parallel batch, the all-to-all of the
shard_map MoE dispatch, the broadcast of rank 0's sampled tokens (and of
a cluster's clock), and the ring shift of the pipeline.

Each is a no-op over an axis of one rank (and with no mesh), and each
counts its calls in `COUNTS` where it runs, as the kernel wrappers
count launches.  gloo carries all_reduce, all_gather, all_to_all and
broadcast for CUDA tensors (all_reduce in bfloat16 too; the list form of
all-to-all it refuses, so the dispatch uses `all_to_all_single`), which
lets several ranks share one card; NCCL carries them between cards.

**Under autograd** (grad mode on and an input that requires a gradient)
each runs as a `torch.autograd.Function` with Megatron's rules, and its
backward counts under its own key ("<name>_bwd"):

  * `all_reduce` (Megatron's g): the sum forward, the identity backward;
  * `copy_to` (Megatron's f): the identity forward (no collective), the
    sum of the gradient backward; it goes where a replicated tensor
    enters a sharded part, so its gradient is whole on every rank;
  * `all_gather`: backward "split" (the rank's own slice of the
    gradient, where everything downstream is replicated over the axes)
    or "reduce_scatter" (the sum over the ranks, then the rank's slice,
    where each rank's downstream differs);
  * `all_to_all`: its own inverse;
  * `shift` (the pipeline's ring): backward the other way round.

`broadcast` has no gradient.  Without autograd each runs as before:
serving pays nothing, and the forward's collectives are the same.

`gather_held` takes a leaf a rank holds in a block other than its TP
block (`sharding.HOLDS`: JAX's layout, or FSDP's) to the TP block while
its layer runs; its backward returns the held block's gradient summed
over the DP ranks the batch's rows split over (a reduce-scatter).

Beside the calls, `BYTES` sums each collective's result bytes (each
backward's under the op it performs), keyed by XLA's op names as JAX's
dry run counts them from HLO (`repro.launch.analyze.collective_bytes`):
"all-reduce" (and `all_max`), "all-gather", "reduce-scatter",
"all-to-all", "collective-permute" (the pipeline's shift) and
"broadcast"; `collective_bytes()` adds their "total".  Under the `fake`
process-group backend (the dry run) nothing moves, but every size is
counted.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# calls that ran, by collective (the backward's under "<name>_bwd");
# single-writer: the rank's own thread
FORWARD = ("all_reduce", "all_gather", "all_to_all", "broadcast")
BACKWARD = ("all_reduce_bwd", "copy_to_bwd", "all_gather_bwd", "all_to_all_bwd",
            "shift_bwd")
COUNTS = {k: 0 for k in FORWARD + ("shift",) + BACKWARD + ("hold", "hold_bwd")}
OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "broadcast")
BYTES = {k: 0 for k in OPS}


def reset() -> None:
    for k in COUNTS:
        COUNTS[k] = 0
    for k in BYTES:
        BYTES[k] = 0


def collective_bytes() -> dict:
    """The result bytes counted since `reset`, by op, and their "total"."""
    return dict(BYTES, total=sum(BYTES.values()))


def _count(op: str, nbytes: int) -> None:
    BYTES[op] += int(nbytes)


def _axes(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _size(mesh, axes) -> int:
    if mesh is None:
        return 1
    n = 1
    for a in _axes(axes):
        n *= mesh.shape.get(a, 1)
    return n


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _sum(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced over `axes` (in place when contiguous)."""
    y = x.contiguous()
    dist.all_reduce(y, op=op, group=mesh.group(axes))
    return y


def _gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n, group = _size(mesh, axes), mesh.group(axes)
    if dist.get_backend(group) == "gloo":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)
    # one tensor, not n (the dry run's fake backend gathers over 512 ranks)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _own(g: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's slice along `dim` of a gathered gradient."""
    n = _size(mesh, axes)
    size = g.shape[dim] // n
    return g.narrow(dim, mesh.axis_rank(_axes(axes)) * size, size).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        # a copy: x may be a view another Function returned (a kernel
        # wrapper's reshape), which autograd forbids writing in place
        return _sum(x.clone(memory_format=torch.contiguous_format), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        COUNTS["all_reduce_bwd"] += 1
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        COUNTS["copy_to_bwd"] += 1
        _count("all-reduce", g.nbytes)
        return _sum(g.clone(), ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, backward):
        ctx.mesh, ctx.axes, ctx.dim, ctx.rule = mesh, axes, dim, backward
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        COUNTS["all_gather_bwd"] += 1
        if ctx.rule == "reduce_scatter":
            # gloo has no reduce_scatter: the sum, then the rank's slice
            g = _sum(g.contiguous().clone(), ctx.mesh, ctx.axes)
            _count("reduce-scatter", g.nbytes // _size(ctx.mesh, ctx.axes))
        return _own(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None, None


def _a2a(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group(axes))
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _a2a(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        COUNTS["all_to_all_bwd"] += 1
        _count("all-to-all", g.nbytes)
        return _a2a(g, ctx.mesh, ctx.axes), None, None


def all_reduce(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """The sum of x over `axes`, on every rank.  Reduces in place when x
    is contiguous: the caller passes a tensor it does not read again.
    Under autograd it reduces a copy, and the gradient passes through
    unchanged (g)."""
    if _size(mesh, axes) == 1:
        return x
    COUNTS["all_reduce"] += 1
    _count("all-reduce", x.nbytes)
    if _grad_path(x):
        return _AllReduce.apply(x, mesh, axes)
    return _sum(x, mesh, axes)


def all_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of x over `axes` (in place when contiguous);
    no gradient.  Counted as an all_reduce."""
    if _size(mesh, axes) == 1:
        return x
    COUNTS["all_reduce"] += 1
    _count("all-reduce", x.nbytes)
    return _sum(x, mesh, axes, dist.ReduceOp.MAX)


def copy_to(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """x itself forward; under autograd its gradient summed over `axes`
    (f).  No collective in a forward, nothing over an axis of one rank."""
    if _size(mesh, axes) == 1 or not _grad_path(x):
        return x
    return _CopyTo.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh, axes="model", dim: int = -1, *,
               backward: str = "split") -> torch.Tensor:
    """Every rank's x over `axes`, concatenated along `dim` in rank order
    (the vocab shards of the logits back into one row).  Under autograd
    the rank's gradient is its own slice of the output's ("split": the
    downstream is replicated over `axes`) or the slice of the output's
    gradient summed over `axes` ("reduce_scatter": the ranks'
    downstreams differ)."""
    if backward not in ("split", "reduce_scatter"):
        raise ValueError(f"all_gather backward {backward!r}: 'split' or 'reduce_scatter'")
    if _size(mesh, axes) == 1:
        return x
    COUNTS["all_gather"] += 1
    _count("all-gather", x.nbytes * _size(mesh, axes))
    if _grad_path(x):
        return _AllGather.apply(x, mesh, axes, dim, backward)
    return _gather(x, mesh, axes, dim)


def all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """x's n equal chunks along dim 0 sent one to each rank of `axes`
    (chunk i to the rank at index i); returns the chunks received, in
    rank order along dim 0 (`lax.all_to_all(split_axis=0, concat_axis=0,
    tiled=True)`).  Under autograd the backward is the same exchange of
    the gradient's chunks (the inverse all-to-all)."""
    n = _size(mesh, axes)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    COUNTS["all_to_all"] += 1
    _count("all-to-all", x.nbytes)
    if _grad_path(x):
        return _AllToAll.apply(x, mesh, axes)
    return _a2a(x, mesh, axes)


def broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's x on every rank of the mesh (in place); no gradient."""
    if _size(mesh, tuple(mesh.shape) if mesh is not None else ()) == 1:
        return x
    y = x.contiguous()
    dist.broadcast(y, src=mesh.root, group=mesh.group(tuple(mesh.axis_names)))
    COUNTS["broadcast"] += 1
    _count("broadcast", y.nbytes)
    return y


def _ring(x: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """x sent to the rank `step` places on along `axis` (cyclically), and
    the tensor of the rank `step` places back received.  gloo carries
    point-to-point only for CPU tensors: a CUDA tensor crosses a gloo
    group through host memory."""
    n = mesh.shape[axis]
    c = mesh.coord(axis)
    to, frm = mesh.axis_peer(axis, (c + step) % n), mesh.axis_peer(axis, (c - step) % n)
    group = mesh.group(axis)
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if host else x).contiguous()
    out = torch.empty_like(src)
    for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, src, to, group),
                                       dist.P2POp(dist.irecv, out, frm, group)]):
        req.wait()
    return out.to(x.device) if host else out


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _ring(x, mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        COUNTS["shift_bwd"] += 1
        _count("collective-permute", g.nbytes)
        return _ring(g, ctx.mesh, ctx.axis, -1), None, None


def shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The pipeline's ring shift: x to the next rank along `axis`, the
    previous rank's x back (`lax.ppermute` with pairs (i, i + 1 mod n));
    under autograd the gradient goes the other way round."""
    if _size(mesh, axis) == 1:
        return x
    COUNTS["shift"] += 1
    _count("collective-permute", x.nbytes)
    if _grad_path(x):
        return _Shift.apply(x, mesh, axis)
    return _ring(x, mesh, axis, 1)


# --- held leaves (sharding.HOLDS) ----------------------------------------------

def _names(a) -> tuple:
    return () if a is None else _axes(a)


def _live(mesh, spec) -> tuple:
    """`spec` without the axes of one rank (they split nothing)."""
    def keep(a):
        names = tuple(n for n in _names(a) if mesh.shape.get(n, 1) > 1)
        return None if not names else (names[0] if len(names) == 1 else names)
    return tuple(keep(a) for a in spec)


def _held_plan(held, comp) -> list:
    """[(dim, kind, held axes)] turning a block under `held` into the block
    under `comp` dim by dim: "gather" (comp whole: an all_gather over the
    held axes), "exchange" (comp over "model", held over DP axes then
    "model": the TP block's D held blocks fetched from their owners), or
    "cut" (held whole, comp over "model": the rank's slice)."""
    plan = []
    for dim, (h, c) in enumerate(zip(held, comp)):
        hn, cn = _names(h), _names(c)
        if hn == cn:
            continue
        if not cn:
            plan.append((dim, "gather", hn))
        elif cn == ("model",) and not hn:
            plan.append((dim, "cut", ()))
        elif cn == ("model",) and hn[-1:] == ("model",):
            plan.append((dim, "exchange", hn))
        else:
            raise NotImplementedError(f"a leaf held as {held} computes as {comp}")
    return plan


def _exchange(x: torch.Tensor, mesh, axes, dim: int, back: bool = False) -> torch.Tensor:
    """The held block x (dim `dim` over `axes` = DP axes then "model",
    block c = the rank's index over them) to the TP block of its "model"
    coordinate m (blocks m D .. m D + D - 1, D = size(axes) / size("model")):
    one all_to_all over `axes` in which each rank sends its block to the D
    ranks whose TP block holds it.  `back`: the reverse, for a gradient of
    the TP block: each piece goes to its block's owner, which sums the D
    pieces it receives (in float32, in the order of the DP ranks)."""
    n, msz = _size(mesh, axes), _size(mesh, "model")
    d = n // msz
    c, m = mesh.axis_rank(axes), mesh.coord("model")
    xm = x.movedim(dim, 0)
    tp_owner = [b // d == m for b in range(n)]           # blocks of my TP block
    my_readers = [b % msz == c // d for b in range(n)]   # ranks reading my block
    if not back:
        rows = xm.shape[0]
        inp = xm.unsqueeze(0).expand(d, *xm.shape).reshape(d * rows, *xm.shape[1:])
        send, recv = my_readers, tp_owner
    else:
        rows = xm.shape[0] // d
        inp = xm
        send, recv = tp_owner, my_readers
    out = xm.new_empty((d * rows, *xm.shape[1:]))
    dist.all_to_all_single(out, inp.contiguous(), [rows * r for r in recv],
                           [rows * r for r in send], group=mesh.group(axes))
    if back:
        out = out.reshape(d, rows, *xm.shape[1:]).float().sum(0).to(x.dtype)
    return out.movedim(0, dim)


def _held_forward(x: torch.Tensor, mesh, plan: list) -> torch.Tensor:
    for dim, kind, axes in plan:
        if kind == "gather":
            x = _gather(x, mesh, axes, dim)
        elif kind == "exchange":
            x = _exchange(x, mesh, axes, dim)
        else:
            n = _size(mesh, "model")
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.coord("model") * size, size)
        if kind != "cut":
            _count("all-gather", x.nbytes)
    # contiguous, as a TP block is held: a strided weight takes another
    # product kernel, which rounds otherwise
    return x.contiguous()


def _axes_order(mesh, names) -> tuple:
    return tuple(a for a in mesh.axis_names if a in names and mesh.shape[a] > 1)


class _Held(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, plan, held, rows):
        ctx.mesh, ctx.plan, ctx.held, ctx.rows = mesh, plan, held, rows
        ctx.shape = tuple(x.shape)
        return _held_forward(x, mesh, plan)

    @staticmethod
    def backward(ctx, g):
        COUNTS["hold_bwd"] += 1
        return _held_backward(g, ctx.mesh, ctx.plan, ctx.held, ctx.rows, ctx.shape), \
            None, None, None, None


def _held_backward(g, mesh, plan, held, rows, shape):
    """The held block's gradient from the TP block's, summed over the DP
    axes `rows` the batch's rows split over (and over "model" where the TP
    block is a part of the leaf)."""
    rows = _names(rows)
    if len(plan) == 1 and plan[0][1] == "exchange" \
            and set(rows) >= set(plan[0][2]) - {"model"}:
        dim, _, axes = plan[0]
        out = _exchange(g, mesh, axes, dim, back=True)
        _count("reduce-scatter", out.nbytes)
        extra = _axes_order(mesh, set(rows) - set(axes))
        if extra:
            out = _sum(out, mesh, extra)
            _count("all-reduce", out.nbytes)
        return out
    # the TP block placed in the whole leaf's zeros, summed, the held block cut
    whole = [n * (_size(mesh, _names(h)) if h is not None else 1)
             for n, h in zip(shape, held)]
    full = g.new_zeros(whole)
    view = full
    for dim, kind, _ in plan:
        if kind != "gather":
            size = g.shape[dim]
            view = view.narrow(dim, mesh.coord("model") * size, size)
    view.copy_(g)
    axes = _axes_order(mesh, set(rows) | ({"model"} if any(k != "gather" for _, k, _ in plan)
                                          else set()))
    if axes:
        full = _sum(full, mesh, axes)
        _count("all-reduce", full.nbytes)
    for dim, h in enumerate(held):
        if h is not None:
            full = _own(full, mesh, h, dim)
    return full.contiguous()


def gather_held(x: torch.Tensor, mesh, held, comp, rows=None) -> torch.Tensor:
    """A leaf this rank holds as its block `x` under spec `held` (one entry
    a dim, as `sharding.param_spec`'s) as its block under `comp`, the TP
    spec the layer computes with: an all_gather where the TP block is
    whole, an exchange where held is a finer split of the TP block's dim
    (FSDP's ("data", "model") block d M + m lies in TP block (d M + m) // D,
    not in m, so the D blocks of TP block m are fetched from their
    owners), the rank's slice where held is whole.  Under autograd the
    gradient comes back to the held block summed over `rows` (the DP axes
    the batch's rows split over; None: every rank holds the whole batch)
    and, where the TP block is a part of the leaf, over "model": a
    reduce-scatter.  `x` itself where the specs agree."""
    plan = _held_plan(_live(mesh, held), _live(mesh, comp))
    if not plan:
        return x
    COUNTS["hold"] += 1
    if _grad_path(x):
        return _Held.apply(x, mesh, plan, _live(mesh, held), rows)
    return _held_forward(x, mesh, plan)
