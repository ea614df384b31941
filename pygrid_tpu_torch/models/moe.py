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
``T · min(k, held)`` rows, the most the held experts can receive. Rows past
the held assignments are never read back: their products are left out by
the offsets or masked where the rows are gathered.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from typing import NamedTuple

from pygrid_tpu_torch.device import resolve
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
#: recompute inside a backward is not counted), and on the device the held
#: assignments they routed and the largest load one held expert took
moe_calls = 0
_held_assignments: torch.Tensor | None = None
_max_load: torch.Tensor | None = None


def moe_counts() -> dict[str, int]:
    """The counters, read from the device (a host sync: never in a round)."""
    return {
        "calls": moe_calls,
        "held_assignments": 0 if _held_assignments is None else int(_held_assignments),
        "max_load": 0 if _max_load is None else int(_max_load),
    }


def reset_moe_counts() -> None:
    global moe_calls, _held_assignments, _max_load
    moe_calls = 0
    _held_assignments = _max_load = None


def _count(loads: torch.Tensor) -> None:
    global moe_calls, _held_assignments, _max_load
    moe_calls += 1
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
    if torch._C._current_graph_task_id() == -1:  # not a recompute in a backward
        _count(loads[:n_held])
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=sel.device))
    M = T * min(k, n_held)
    return Dispatch(order[:M], loads[:n_held].cumsum(0).to(torch.int32),
                    pos.view(T, k), held.view(T, k))


def _swiglu_rows(xs, w13, w2, offs):
    """Each held expert's SwiGLU on its rows of ``xs`` [M, d]: [M, d]. Rows
    past ``offs[-1]`` hold whatever the buffers held."""
    h = F.grouped_mm(xs, w13, offs=offs)
    f = w2.shape[1]
    return F.grouped_mm(F.silu(h[:, :f]) * h[:, f:], w2, offs=offs)


def _gather_rows(rows, pos, held):
    """``rows[pos]`` [T, k, d] with every slot not held here at zero."""
    T, k = pos.shape
    idx = torch.where(held, pos, torch.zeros_like(pos)).reshape(-1)
    g = rows.index_select(0, idx).view(T, k, rows.shape[-1])
    return g.masked_fill_(~held[..., None], 0)


class _HeldExperts(torch.autograd.Function):
    """The held experts' weighted output, ``y[t] = Σ_j w[t, j] ·
    E_{sel[t, j]}(x[t])`` over the slots held here, with f32 sums.

    Saves only its inputs and the plan: the backward gathers the rows and
    runs the experts' products again (the [M, ·] buffers are too large to
    keep for every layer), then the router weights' gradient
    (``<dy, E(x)>``), the products' input and weight gradients, each a
    grouped product over the same offsets. A row past the held
    assignments is computed from whatever its buffer held: the offsets
    leave it out of every weight gradient, and :func:`_gather_rows` never
    reads it back."""

    @staticmethod
    def forward(ctx, x, w, w13, w2, order, offs, pos, held):
        with region("pgt.moe.experts.fwd"):
            k = pos.shape[1]
            xs = x.index_select(0, order // k)
            o = _swiglu_rows(xs, w13, w2, offs)
            g = _gather_rows(o, pos, held)
            y = torch.bmm(w[:, None, :], g.float())[:, 0]
        ctx.save_for_backward(x, w, w13, w2, order, offs, pos, held)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        with region("pgt.moe.experts.bwd"):
            x, w, w13, w2, order, offs, pos, held = ctx.saved_tensors
            k = pos.shape[1]
            tok = order // k
            xs = x.index_select(0, tok)
            f = w2.shape[1]
            with torch.enable_grad():
                h = F.grouped_mm(xs, w13, offs=offs).requires_grad_()
                a = F.silu(h[:, :f]) * h[:, f:]
            o = F.grouped_mm(a.detach(), w2, offs=offs)
            gs = gy.to(x.dtype).index_select(0, tok)
            dws = torch.sum(gs * o, dim=-1, dtype=torch.float32, keepdim=True)
            dw = _gather_rows(dws, pos, held)[..., 0]
            do = (gs * w.reshape(-1).index_select(0, order)[:, None]).to(x.dtype)
            da = F.grouped_mm(do, w2.transpose(-2, -1), offs=offs)
            (dh,) = torch.autograd.grad(a, h, da)
            dw2 = F.grouped_mm(a.detach().t(), do, offs=offs)
            dw13 = F.grouped_mm(xs.t(), dh, offs=offs)
            dxs = F.grouped_mm(dh, w13.transpose(-2, -1), offs=offs)
            dx = _gather_rows(dxs, pos, held).float().sum(1)
        return dx.to(x.dtype), dw, dw13, dw2, None, None, None, None


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
