"""Mixture-of-experts FFNs: a top-1 layer with expert parallelism, and a
dropless sigmoid top-k layer over a held share of the experts.

The top-1 layer is the counterpart of :mod:`pygrid_tpu.models.moe`:
GShard-style top-1 routing with a capacity per expert.

- every rank routes its block of tokens (gate softmax → argmax expert,
  position in the expert's bucket by a cumulative sum in arrival order,
  tokens past the capacity dropped);
- dispatch is two all-to-alls over the ``"expert"`` mesh axis: the token
  buckets travel to the ranks that own their experts, each rank runs its
  experts' FFN as one batched product, and the results travel back to be
  combined with the gate weights.

With enough capacity (no drops) the expert-parallel output equals the
dense compute-every-expert reference up to float reassociation. Every rank
passes the whole parameter list and the whole ``[T, d]`` tokens
(:mod:`pygrid_tpu_torch.parallel.collectives`): the experts are cut to the
rank's block there, and the whole output comes back.

The top-k layer (:func:`topk_expert_layer`, DeepSeek-V3's routed experts,
no counterpart in the JAX package) is told which experts it holds: it
routes every token over all the experts, and computes only the held
experts' part of the result, the share one card of an expert-parallel
deployment computes before the exchange. It drops no token and needs no
host sync: the held assignments are sorted by expert on the device, the
per-expert offsets stay there, and the experts' SwiGLU runs as grouped
products (``torch.nn.functional.grouped_mm``) over a dispatch buffer of
``T · min(k, held)`` rows, the most the held experts can receive. The row
passes around the products (the gather, the SwiGLU, the weighted combine
and their gradients) are CUDA kernels (``csrc/moe_rows.cu``) that read the
held count ``offs[-1]`` on the device and touch only the rows before it;
each has a plain PyTorch version beside it, which runs for CPU tensors over
every row. Rows past the held assignments are never read back: the offsets
leave them out of every product, and the combines read only held slots.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from typing import NamedTuple

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.kernels import build
from pygrid_tpu_torch.parallel import collectives as C
from pygrid_tpu_torch.utils.profiling import region


def param_shapes(d_model: int, d_ff: int, n_experts: int) -> list[tuple[int, ...]]:
    """Shapes of ``init``'s list: [gate Wg, W1, b1, W2, b2], experts
    stacked on axis 0."""
    return [(d_model, n_experts), (n_experts, d_model, d_ff), (n_experts, d_ff),
            (n_experts, d_ff, d_model), (n_experts, d_model)]


def init(
    d_model: int,
    d_ff: int,
    n_experts: int,
    generator: torch.Generator | None = None,
    device: str | torch.device = "cuda",
) -> list[torch.Tensor]:
    """[gate Wg, expert W1, b1, W2, b2] with experts stacked on axis 0:
    normal weights scaled by 1/sqrt(fan-in) and zero biases, drawn on the
    CPU from ``generator`` (seed 0 when None) and moved to ``device``.
    The draws differ from the reference's ``jax.random`` ones; parity tests
    carry the reference's params across with :mod:`..convert`."""
    dev = resolve(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    wg, w1, b1, w2, b2 = param_shapes(d_model, d_ff, n_experts)
    params = [
        torch.randn(wg, generator=g) / math.sqrt(d_model),
        torch.randn(w1, generator=g) / math.sqrt(d_model),
        torch.zeros(b1),
        torch.randn(w2, generator=g) / math.sqrt(d_ff),
        torch.zeros(b2),
    ]
    return [p.to(dev) for p in params]


def _expert_ffn(w1, b1, w2, b2, h):
    """Each expert's FFN on its tokens: ``h [E, n, d]`` → ``[E, n, d]``,
    one batched product per layer (GELU in its tanh form, as ``jax.nn.gelu``)."""
    a = F.gelu(torch.bmm(h, w1) + b1[:, None, :], approximate="tanh")
    return torch.bmm(a, w2) + b2[:, None, :]


def _route(x: torch.Tensor, wg: torch.Tensor, capacity: int):
    """Top-1 routing: dispatch one-hot ``[t, E, C]`` and combine weights."""
    n_experts = wg.shape[1]
    gates = torch.softmax(x @ wg, dim=-1)  # [t, E]
    expert_idx = gates.argmax(dim=-1)  # [t]
    onehot = F.one_hot(expert_idx, n_experts).to(x.dtype)  # [t, E]
    # arrival order within each expert's bucket
    pos = (torch.cumsum(onehot, dim=0).gather(1, expert_idx[:, None])[:, 0] - 1).long()
    keep = (pos < capacity).to(x.dtype)
    slot = F.one_hot(pos.clamp(max=capacity - 1), capacity).to(x.dtype)
    dispatch = onehot[:, :, None] * slot[:, None, :] * keep[:, None, None]  # [t, E, C]
    gate_val = gates.gather(1, expert_idx[:, None])[:, 0]
    return dispatch, dispatch * gate_val[:, None, None]


def apply_dense(params: list, x: torch.Tensor) -> torch.Tensor:
    """Single-device reference: every expert computes every token, the
    top-1 gate selects (exact, no capacity drops)."""
    wg, w1, b1, w2, b2 = params
    gates = torch.softmax(x @ wg, dim=-1)
    expert_idx = gates.argmax(dim=-1)
    all_out = _expert_ffn(w1, b1, w2, b2, x.expand((w1.shape[0],) + tuple(x.shape)))  # [E, t, d]
    sel = all_out[expert_idx, torch.arange(x.shape[0], device=x.device)]  # [t, d]
    return sel * gates.gather(1, expert_idx[:, None])


def param_specs(n_leading: int = 5, axis: str = "expert") -> list[str | None]:
    """Where ``init``'s list lives: the gate replicated (``None``), the
    experts split over ``axis`` on their stacking axis."""
    return [None, axis, axis, axis, axis][:n_leading]


def apply_expert_parallel(
    params: list,
    x: torch.Tensor,
    mesh,
    axis: str = "expert",
    capacity_factor: float = 2.0,
) -> torch.Tensor:
    """Expert-parallel MoE: the tokens ``[T, d]`` split over ``axis`` on T,
    the experts on their stacking axis; two all-to-alls move the buckets.
    Whole params and tokens in, the whole ``[T, d]`` output back."""
    p_sz = C.axis_size(mesh, axis)
    wg = params[0]
    n_experts = wg.shape[1]
    if n_experts % p_sz:
        raise ValueError(f"experts ({n_experts}) must divide over mesh axis ({p_sz})")
    if x.shape[0] % p_sz:
        raise ValueError(f"tokens ({x.shape[0]}) must shard over {p_sz}")
    t_local = x.shape[0] // p_sz
    capacity = max(1, int(math.ceil(t_local * capacity_factor / n_experts)))
    dims = [None if s is None else 0 for s in param_specs(len(params), axis)] + [0]
    wg, w1, b1, w2, b2, x = C.shard(mesh, axis, *params, x, dims=dims)
    dispatch, combine = _route(x, wg, capacity)  # [t, E, C]
    buckets = torch.einsum("tec,td->ecd", dispatch, x)  # [E, C, d]
    # the buckets of expert e go to e's owner; the capacity axis concatenates
    expert_in = C.all_to_all(buckets, mesh, axis, split_axis=0, concat_axis=1)  # [E/P, P*C, d]
    expert_out = _expert_ffn(w1, b1, w2, b2, expert_in)
    back = C.all_to_all(expert_out, mesh, axis, split_axis=1, concat_axis=0)  # [E, C, d]
    return C.all_gather(torch.einsum("tec,ecd->td", combine, back), mesh, axis)


# --------------------------------------------------------------------------
# dropless sigmoid top-k over a held share of the experts
# --------------------------------------------------------------------------

#: :func:`dispatch` calls since the last :func:`reset_moe_counts` (a layer's
#: recompute inside a backward is not counted) and the dispatch rows M they
#: bounded, and on the device the held assignments they routed and the
#: largest load one held expert took; held_assignments / bound_rows is the
#: share of the dispatch rows the row kernels touch
moe_calls = 0
_bound_rows = 0
_held_assignments: torch.Tensor | None = None
_max_load: torch.Tensor | None = None


def moe_counts() -> dict[str, int]:
    """The counters, read from the device (a host sync: never in a round)."""
    return {
        "calls": moe_calls,
        "held_assignments": 0 if _held_assignments is None else int(_held_assignments),
        "max_load": 0 if _max_load is None else int(_max_load),
        "bound_rows": _bound_rows,
    }


def reset_moe_counts() -> None:
    global moe_calls, _bound_rows, _held_assignments, _max_load
    moe_calls = _bound_rows = 0
    _held_assignments = _max_load = None


def _count(loads: torch.Tensor, rows: int) -> None:
    global moe_calls, _bound_rows, _held_assignments, _max_load
    moe_calls += 1
    _bound_rows += rows
    n, top = loads.sum(), loads.max()
    _held_assignments = n if _held_assignments is None else _held_assignments + n
    _max_load = top if _max_load is None else torch.maximum(_max_load, top)


def route_topk(x32, wg, bias, top_k: int, scale: float):
    """DeepSeek-V3's router, in f32: scores ``s = sigmoid(x wgᵀ)`` over every
    expert (``wg`` [E, d]); the ``top_k`` experts by ``s + bias`` (the bias
    steers the choice only); each weight ``s_i / Σ_selected s`` times
    ``scale``. Returns (sel [T, k] int64, weights [T, k] f32)."""
    s = torch.sigmoid(x32.float() @ wg.float().t())
    sel = torch.topk(s.detach() + bias, top_k, dim=-1, sorted=False).indices
    w = s.gather(1, sel)
    return sel, w / (w.sum(-1, keepdim=True) + 1e-20) * scale


class Dispatch(NamedTuple):
    """Where each held assignment goes, all on the device.

    ``order`` [M]: flat assignment ids (token · k + slot), held ones first
    and grouped by expert, then the rest; M = T · min(k, held) rows bound
    the held assignments. ``offs`` [held] int32: each held expert's end in
    ``order``. ``pos`` [T, k]: each assignment's place in the sort.
    ``held`` [T, k]: whether its expert is held here."""

    order: torch.Tensor
    offs: torch.Tensor
    pos: torch.Tensor
    held: torch.Tensor


def dispatch(sel: torch.Tensor, first: int, n_held: int) -> Dispatch:
    """The dispatch plan of ``sel`` [T, k] for the experts ``first`` ..
    ``first + n_held - 1``: a stable sort by held expert, with the others
    after them, and the loads' offsets, without a host sync."""
    T, k = sel.shape
    local = sel.reshape(-1) - first
    held = (local >= 0) & (local < n_held)
    key = torch.where(held, local, torch.full_like(local, n_held))
    order = torch.argsort(key, stable=True)
    loads = torch.zeros(n_held + 1, dtype=torch.int64, device=sel.device)
    loads.scatter_add_(0, key, torch.ones_like(key))
    M = T * min(k, n_held)
    if torch._C._current_graph_task_id() == -1:  # not a recompute in a backward
        _count(loads[:n_held], M)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=sel.device))
    return Dispatch(order[:M], loads[:n_held].cumsum(0).to(torch.int32),
                    pos.view(T, k), held.view(T, k))


# --------------------------------------------------------------------------
# the row passes around the grouped products: plain versions (the CPU path,
# and the yardstick on the card) and the kernels of csrc/moe_rows.cu
# --------------------------------------------------------------------------

#: the row kernels (``csrc/moe_rows.cu``), each a wrapper below
ROW_KERNELS = ("moe_gather", "moe_swiglu_fwd", "moe_combine_fwd", "moe_rows_bwd",
               "moe_swiglu_bwd", "moe_combine_bwd")

#: blocks of 256 threads a streaming multiprocessor in a row kernel's
#: persistent grid (8 fill an SM's 2,048 threads)
BLOCKS_PER_SM = 8

#: launches of each row kernel since the last :func:`reset_launch_counts`;
#: a wrapper adds one where it launches its kernel and nowhere else
_launches = dict.fromkeys(ROW_KERNELS, 0)


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    _launches.update(dict.fromkeys(ROW_KERNELS, 0))


def gather_reference(x, order, k):
    """``x[order // k]`` [M, d]: each dispatch row's token."""
    return x.index_select(0, order // k)


def swiglu_reference(h):
    """``silu(h[:, :f]) · h[:, f:]`` [M, f] of gate‖up rows [M, 2f]."""
    f = h.shape[1] // 2
    return F.silu(h[:, :f]) * h[:, f:]


def _gather_rows(rows, pos, held):
    """``rows[pos]`` [T, k, ·] with every slot not held here at zero."""
    T, k = pos.shape
    idx = torch.where(held, pos, torch.zeros_like(pos)).reshape(-1)
    g = rows.index_select(0, idx).view(T, k, rows.shape[-1])
    return g.masked_fill_(~held[..., None], 0)


def combine_reference(o, w, pos, held):
    """``y[t] = Σ_j held w[t, j] · o[pos[t, j]]`` [T, d] in o's dtype, the
    sum in f32."""
    return torch.bmm(w[:, None, :], _gather_rows(o, pos, held).float())[:, 0].to(o.dtype)


def rows_bwd_reference(gy, o, w, order, k):
    """(dws [M] f32, do [M, d]) of rows ``o`` [M, d] against ``gy`` [T, d]:
    ``dws[r] = <gy[t], o[r]>`` with f32 products and sum, and ``do[r] =
    gy[t] · w.flat[order[r]]`` for the row's token ``t = order[r] // k``."""
    gs = gy.index_select(0, order // k)
    dws = (gs.float() * o.float()).sum(-1)
    do = (gs * w.reshape(-1).index_select(0, order)[:, None]).to(o.dtype)
    return dws, do


def swiglu_bwd_reference(h, da):
    """The gradient [M, 2f] of :func:`swiglu_reference` at ``h`` for
    ``da`` [M, f]."""
    h = h.detach().requires_grad_()
    with torch.enable_grad():
        a = swiglu_reference(h)
    return torch.autograd.grad(a, h, da)[0]


def combine_bwd_reference(dxs, dws, pos, held):
    """(dx [T, d] in dxs's dtype, the f32 sum of the held slots' rows, and
    dw [T, k] f32, each held slot's ``dws`` and 0 elsewhere)."""
    dx = _gather_rows(dxs, pos, held).float().sum(1).to(dxs.dtype)
    return dx, _gather_rows(dws[:, None], pos, held)[..., 0]


_ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _grid(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count * BLOCKS_PER_SM


#: the dtype of each of the plan's tensors a row kernel reads
_PLAN_DTYPES = {"order": torch.int64, "offs": torch.int32, "pos": torch.int64,
                "held": torch.bool, "w": torch.float32, "dws": torch.float32}


def _check_plan(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != _PLAN_DTYPES[name]:
            raise TypeError(f"the row kernels take {name} as {_PLAN_DTYPES[name]}, got {t.dtype}")


def _launch(name: str, rows: torch.Tensor, *args) -> None:
    """Launch row kernel ``name`` on ``rows``' device and stream: ``args``
    (tensors by pointer, ints as they are), then the rows' dtype flag and
    the grid. Raises for anything the kernels do not take: another device
    or dtype of rows, a tensor elsewhere or not contiguous."""
    if rows.device.type != "cuda":
        raise ValueError(f"the row kernels run on CUDA tensors, got {rows.device}")
    if rows.dtype not in _ROW_DTYPES:
        raise TypeError(f"the row kernels take float32 or bfloat16 rows, got {rows.dtype}")
    for a in args:
        if isinstance(a, torch.Tensor) and (a.device != rows.device or not a.is_contiguous()):
            raise ValueError("the row kernels take contiguous tensors on one device")
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    build.launch("moe_rows", f"pgt_{name}", rows.device, *ptrs, _ROW_DTYPES[rows.dtype],
                 _grid(rows.device.index))
    _launches[name] += 1


def gather_rows(x, order, offs, k):
    """The dispatch rows [M, d] of tokens ``x`` [T, d]: row r is
    ``x[order[r] // k]``. On the card only the held rows ``r < offs[-1]``
    are written."""
    if x.device.type == "cpu":
        return gather_reference(x, order, k)
    _check_plan(order=order, offs=offs)
    x = x.contiguous()
    xs = torch.empty((order.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    _launch("moe_gather", x, x, order, offs, xs, offs.shape[0], k, x.shape[1])
    return xs


def swiglu(h, offs):
    """:func:`swiglu_reference` of gate‖up rows ``h`` [M, 2f]; on the card
    of the held rows only."""
    if h.device.type == "cpu":
        return swiglu_reference(h)
    _check_plan(offs=offs)
    f = h.shape[1] // 2
    a = torch.empty((h.shape[0], f), dtype=h.dtype, device=h.device)
    _launch("moe_swiglu_fwd", h, h, offs, a, offs.shape[0], f)
    return a


def combine(o, w, pos, held):
    """:func:`combine_reference`: each token's held slots' rows of ``o``,
    weighted by ``w`` [T, k] f32."""
    if o.device.type == "cpu":
        return combine_reference(o, w, pos, held)
    _check_plan(w=w, pos=pos, held=held)
    T, k = pos.shape
    y = torch.empty((T, o.shape[1]), dtype=o.dtype, device=o.device)
    _launch("moe_combine_fwd", o, o, w.contiguous(), pos, held, y, T, k, o.shape[1])
    return y


def rows_bwd(gy, o, w, order, offs, k):
    """:func:`rows_bwd_reference`; on the card of the held rows only."""
    if o.device.type == "cpu":
        return rows_bwd_reference(gy, o, w, order, k)
    _check_plan(w=w, order=order, offs=offs)
    M, d = o.shape
    dws = torch.empty(M, dtype=torch.float32, device=o.device)
    do = torch.empty_like(o)
    _launch("moe_rows_bwd", o, gy.to(o.dtype).contiguous(), o, w.contiguous(), order, offs,
            dws, do, offs.shape[0], k, d)
    return dws, do


def swiglu_bwd(h, da, offs):
    """:func:`swiglu_bwd_reference`; on the card of the held rows only."""
    if h.device.type == "cpu":
        return swiglu_bwd_reference(h, da)
    _check_plan(offs=offs)
    dh = torch.empty_like(h)
    _launch("moe_swiglu_bwd", h, h, da.to(h.dtype).contiguous(), offs, dh, offs.shape[0],
            h.shape[1] // 2)
    return dh


def combine_bwd(dxs, dws, pos, held):
    """:func:`combine_bwd_reference`: (dx [T, d], dw [T, k] f32)."""
    if dxs.device.type == "cpu":
        return combine_bwd_reference(dxs, dws, pos, held)
    _check_plan(dws=dws, pos=pos, held=held)
    T, k = pos.shape
    dx = torch.empty((T, dxs.shape[1]), dtype=dxs.dtype, device=dxs.device)
    dw = torch.empty((T, k), dtype=torch.float32, device=dxs.device)
    _launch("moe_combine_bwd", dxs, dxs, dws, pos, held, dx, dw, T, k, dxs.shape[1])
    return dx, dw


class _HeldExperts(torch.autograd.Function):
    """The held experts' weighted output, ``y[t] = Σ_j w[t, j] ·
    E_{sel[t, j]}(x[t])`` over the slots held here, with f32 sums.

    Saves only its inputs and the plan: the backward gathers the rows and
    runs the experts' products again (the [M, ·] buffers are too large to
    keep for every layer), then the router weights' gradient
    (``<dy, E(x)>``), the products' input and weight gradients, each a
    grouped product over the same offsets. The row passes around the
    products are the wrappers above: on the card they touch only the held
    rows ``r < offs[-1]``, and the rows past them are never read (the
    offsets leave them out of every product, and the combines read only
    held slots)."""

    @staticmethod
    def forward(ctx, x, w, w13, w2, order, offs, pos, held):
        with region("pgt.moe.experts.fwd"):
            xs = gather_rows(x, order, offs, pos.shape[1])
            h = F.grouped_mm(xs, w13, offs=offs)
            o = F.grouped_mm(swiglu(h, offs), w2, offs=offs)
            y = combine(o, w, pos, held)
        ctx.save_for_backward(x, w, w13, w2, order, offs, pos, held)
        return y

    @staticmethod
    def backward(ctx, gy):
        with region("pgt.moe.experts.bwd"):
            x, w, w13, w2, order, offs, pos, held = ctx.saved_tensors
            k = pos.shape[1]
            xs = gather_rows(x, order, offs, k)
            h = F.grouped_mm(xs, w13, offs=offs)
            a = swiglu(h, offs)
            o = F.grouped_mm(a, w2, offs=offs)
            dws, do = rows_bwd(gy.to(x.dtype), o, w, order, offs, k)
            da = F.grouped_mm(do, w2.transpose(-2, -1), offs=offs)
            dh = swiglu_bwd(h, da, offs)
            dw2 = F.grouped_mm(a.t(), do, offs=offs)
            dw13 = F.grouped_mm(xs.t(), dh, offs=offs)
            dxs = F.grouped_mm(dh, w13.transpose(-2, -1), offs=offs)
            dx, dw = combine_bwd(dxs, dws, pos, held)
        return dx, dw, dw13, dw2, None, None, None, None


def topk_expert_layer(x, x32, wg, bias, w13, w2, experts_held: range, top_k: int,
                      scale: float) -> torch.Tensor:
    """The routed experts' part of one token's output that the experts in
    ``experts_held`` give, for ``x`` [T, d] in the compute dtype (the
    router reads ``x32``, the same rows in f32): route over all of ``wg``'s
    experts (:func:`route_topk`), plan the dispatch, run the held experts
    (``w13`` [held, d, 2f] gate‖up, ``w2`` [held, f, d]). A token none of
    whose experts is held gets 0."""
    with region("pgt.moe.route"):
        sel, w = route_topk(x32, wg, bias, top_k, scale)
        plan = dispatch(sel, experts_held.start, len(experts_held))
    return _HeldExperts.apply(x, w, w13, w2, *plan)
