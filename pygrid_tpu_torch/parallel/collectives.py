"""The collectives of a mesh program, over a named axis of a ``DeviceMesh``.

Counterpart of the ``lax`` collectives that the JAX package's ``shard_map``
bodies call (``psum``, ``pmean``, ``all_gather``, ``psum_scatter``,
``all_to_all``, ``ppermute``, ``axis_index``), on ``torch.distributed``
with one process per rank: ``mesh.get_group(axis)`` is the group a
collective runs over.

``shard_map`` takes global arrays and returns global arrays, and the port
keeps that signature: every rank passes the whole input, :func:`shard`
cuts the rank's block out of an input that the reference shards
(``P(axis)``) and passes one it replicates (``P()``, ``dims=None``);
:func:`all_gather` puts a sharded output back together.

**Gradients.** Every rank computes the same scalar objective (the loss of
a replicated output), and each rank's autograd runs on its own. So the
backward of a collective gives each rank the gradient of that one
objective with respect to its own operand, and never sums what every
rank already holds:

- :func:`psum` backward is the identity (each rank already holds the
  objective's gradient of the replicated sum), :func:`pmean`'s divides by
  the axis size;
- :func:`all_gather` backward takes the rank's own block of the cotangent,
  and :func:`shard`'s backward all-gathers the block gradients: the pair
  at the edge of a mesh program;
- a replicated input's backward (``dims=None`` in :func:`shard`) is a psum:
  each rank's use of it contributes its part of the gradient (the
  reference's implicit psum of a ``P()`` input's cotangent);
- :func:`psum_scatter` backward is an all-gather, :func:`all_to_all`'s
  the inverse all-to-all, :func:`ppermute`'s the inverse permutation.

``torch.distributed.nn.functional.all_gather`` is not used: its backward
is a reduce-scatter sum, which gives each rank P times the gradient of a
replicated objective.

A collective's backward is itself a collective, so every rank must run
the same collective backward nodes in the same order. The mesh programs
keep their graphs the same shape on every rank: :func:`shard` cuts all
inputs of a program in one node, a rank-dependent choice is a
``torch.where`` and not a Python branch, and :func:`keep` holds a value
that a rank does not use in the graph (with a zero gradient).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

# all_gather_single / reduce_scatter_single replace the *_tensor names in
# newer torch; older torch has only the latter
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def axis_size(mesh, axis: str) -> int:
    """Number of ranks along ``axis`` of ``mesh``."""
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def _dim(mesh, axis: str) -> int:
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}: its axes are {names}")
    return names.index(axis)


def _group(mesh, axis: str):
    return mesh.get_group(axis)


# --- the pair at the edge of a mesh program ---------------------------------


def _block(x: torch.Tensor, n: int, i: int, dim: int) -> torch.Tensor:
    if x.shape[dim] % n:
        raise ValueError(
            f"dimension {dim} of a {tuple(x.shape)} input does not split into {n} blocks"
        )
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size).contiguous()


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    """Tiled all-gather along ``dim``: the ranks' blocks concatenated in
    rank order."""
    x0 = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x0.shape[0],) + tuple(x0.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, x0, group=group)
    return out.movedim(0, dim)


class _Enter(torch.autograd.Function):
    """All inputs of a mesh program in one node: a sharded input (an int
    ``dim``) gives the rank's block along ``dim``, a replicated one
    (``None``) passes through. Backward, in input order: an all-gather of
    each block gradient, a psum of each replicated input's gradient."""

    @staticmethod
    def forward(ctx, mesh, axis, dims, *xs):
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, dims
        return tuple(x.clone() if d is None else _block(x, n, i, d) for x, d in zip(xs, dims))

    @staticmethod
    def backward(ctx, *grads):
        group, n = _group(ctx.mesh, ctx.axis), axis_size(ctx.mesh, ctx.axis)
        out = []
        for g, d, needed in zip(grads, ctx.dims, ctx.needs_input_grad[3:]):
            if not needed:  # alike on every rank, which pass the same inputs
                out.append(None)
            elif d is None:
                g = g.clone()
                dist.all_reduce(g, group=group)
                out.append(g)
            else:
                out.append(_gather(g, group, n, d))
        return (None, None, None, *out)


def shard(mesh, axis: str, *xs: torch.Tensor, dims: Sequence[int | None] | int = 0):
    """The rank's blocks of whole inputs (``in_specs=P(axis)`` on ``dims``),
    in one autograd node; ``None`` in ``dims`` passes that input whole
    (``in_specs=P()``: the identity forward, a psum of its gradient
    backward). One tensor gives one tensor, several a tuple."""
    if isinstance(dims, int) or dims is None:
        dims = (dims,) * len(xs)
    out = _Enter.apply(mesh, axis, tuple(dims), *xs)
    return out[0] if len(xs) == 1 else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.n, ctx.i, ctx.dim = axis_size(mesh, axis), axis_index(mesh, axis), dim
        return _gather(x, _group(mesh, axis), ctx.n, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.n, ctx.i, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)`` along ``dim`` (also the edge of a
    mesh program: ``out_specs=P(axis)``); backward, the rank's own block of
    the cotangent."""
    return _AllGather.apply(x, mesh, axis, dim)


# --- reductions ---------------------------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        out = x.clone()
        dist.all_reduce(out, group=_group(mesh, axis))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis``, replicated on every rank; backward, the identity."""
    return _PSum.apply(x, mesh, axis)


def pmean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def pmean_many(xs: Sequence[torch.Tensor], mesh, axis: str) -> list[torch.Tensor]:
    """:func:`pmean` of each tensor, as one all-reduce per dtype over their
    concatenation (no gradient)."""
    group, n = _group(mesh, axis), axis_size(mesh, axis)
    out: list[torch.Tensor | None] = [None] * len(xs)
    for dtype in dict.fromkeys(x.dtype for x in xs):
        idx = [i for i, x in enumerate(xs) if x.dtype == dtype]
        flat = torch.cat([xs[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= n
        off = 0
        for i in idx:
            size = xs[i].numel()
            out[i] = flat[off: off + size].view(xs[i].shape)
            off += size
    return out


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        group, n = _group(mesh, axis), axis_size(mesh, axis)
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split into {n} blocks")
        x0 = x.movedim(dim, 0).contiguous()
        out = torch.empty((x0.shape[0] // n,) + tuple(x0.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _reduce_scatter_flat(out, x0, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = axis_size(ctx.mesh, ctx.axis)
        return _gather(g, _group(ctx.mesh, ctx.axis), n, ctx.dim), None, None, None


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """``lax.psum_scatter(..., tiled=True)`` along ``dim``: the sum over
    ``axis``, each rank keeping its block; backward, an all-gather."""
    return _PSumScatter.apply(x, mesh, axis, dim)


# --- data movement ------------------------------------------------------------


def _all_to_all(x: torch.Tensor, group, n: int, split_axis: int, concat_axis: int):
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: dimension {split_axis} of {tuple(x.shape)} does not split into {n}"
        )
    x0 = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(x0)
    dist.all_to_all_single(out, x0, group=group)
    chunks = out.reshape((n, x0.shape[0] // n) + tuple(x0.shape[1:])).unbind(0)
    return torch.cat([c.movedim(0, split_axis) for c in chunks], dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_axis, concat_axis):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.split_axis, ctx.concat_axis = split_axis, concat_axis
        return _all_to_all(x, _group(mesh, axis), axis_size(mesh, axis), split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        n = axis_size(ctx.mesh, ctx.axis)
        g = _all_to_all(g, _group(ctx.mesh, ctx.axis), n, ctx.concat_axis, ctx.split_axis)
        return g, None, None, None, None


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(..., tiled=True)``: ``x`` splits into axis-size
    chunks along ``split_axis``, chunk j goes to rank j, and the chunks
    received from ranks 0, 1, ... concatenate along ``concat_axis``."""
    return _AllToAll.apply(x, mesh, axis, split_axis, concat_axis)


def _check_perm(perm, n: int) -> tuple[tuple[int, int], ...]:
    perm = tuple((int(s), int(d)) for s, d in perm)
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) or not all(
            0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a permutation of axis indices 0..{n - 1}")
    return perm


def _ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """Send ``x`` to each ``d`` with ``(me, d)`` in ``perm``; receive from
    each ``s`` with ``(s, me)``; zeros where nothing arrives. A pair from a
    rank to itself is a local copy."""
    group, me = _group(mesh, axis), axis_index(mesh, axis)
    ranks = dist.get_process_group_ranks(group)
    x = x.contiguous()
    out, ops = None, []
    for s, d in perm:
        if s == me and d == me:
            out = x.clone()
        elif s == me:
            ops.append(dist.P2POp(dist.isend, x, ranks[d], group))
        elif d == me:
            out = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.zeros_like(x) if out is None else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return _ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = tuple((d, s) for s, d in ctx.perm)
        return _ppermute(g, ctx.mesh, ctx.axis, inverse), None, None, None


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` is a list of (source, destination) axis
    indices; a rank that receives nothing gets zeros. Backward, the inverse
    permutation."""
    return _PPermute.apply(x, mesh, axis, _check_perm(perm, axis_size(mesh, axis)))


# --- graph shape ----------------------------------------------------------------


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.shapes = [(o.shape, o.dtype, o.device) for o in others]
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=d) for s, t, d in ctx.shapes))


def keep(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x``, with ``others`` held in its graph at a zero gradient: a value
    that this rank computed but does not use still reaches the objective,
    so its collective backward runs here as on every other rank."""
    if not torch.is_grad_enabled() or not any(o.requires_grad for o in others):
        return x
    return _Keep.apply(x, *others)
