"""Mixture-of-experts FFN with expert parallelism.

Counterpart of :mod:`pygrid_tpu.models.moe`: GShard-style top-1 routing
with a capacity per expert.

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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.parallel import collectives as C


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
