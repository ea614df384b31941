"""Plan translation — the portable op-list dialect and the variant registry:
the port's counterpart of :mod:`pygrid_tpu.plans.translators`.

The ``"list"`` variant is the JAX package's JSON-able walk of a jaxpr: every
equation as ``{"op", "in", "out", "params"}`` with integer SSA ids
(``jaxpr_to_oplist`` there). It is the bridge between the two stacks: a plan
traced by the JAX package crosses the wire as this op list, and
:func:`run_oplist` executes it here with

- ``backend="torch"``: the counterpart of the reference's ``backend="jax"``
  interpreter (``_INTERP_TABLE``) — the same op vocabulary, built on torch
  ops on ``device`` (default ``"cuda"``), with the reference interpreter's
  semantics where torch's defaults differ (``div`` true-divides integers,
  ``rem`` truncates like C, ``round`` is half to even, ``argmax`` takes the
  first index, reductions keep the operand's integer dtype, 64-bit inputs
  are canonicalised to 32 bits as ``jnp.asarray`` does);
- ``backend="numpy"``: the port's own copy of the reference's numpy-only
  table (``_NUMPY_TABLE``), the proof that a client with nothing but an
  ndarray library can run a hosted training plan.

Op lists are remote-supplied: allocation sizes and call-nesting depth are
bounded exactly as in the reference, and a malformed structure or an op
outside the dialect fails with a typed :class:`PlanTranslationError`. Where
the reference derives an expansion op's output shape with
``jax.eval_shape``, the port computes it from the params (``_SHAPE_RULES``).
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from pygrid_tpu_torch.device import resolve
from pygrid_tpu_torch.utils.exceptions import PlanTranslationError

# --- params ---------------------------------------------------------------


def _dt(p):
    """A sanitized dtype param as a numpy dtype (typed error for a dtype
    numpy lacks, e.g. ``bfloat16`` without ml_dtypes)."""
    name = p["__dtype__"] if isinstance(p, dict) else p
    try:
        return np.dtype(name)
    except TypeError as err:
        raise PlanTranslationError(f"dtype {name!r} not supported by numpy") from err


_TORCH_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "uint16": torch.uint16,
    "int32": torch.int32,
    "uint32": torch.uint32,
    "int64": torch.int64,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

#: jnp.asarray's canonicalisation with 64-bit types off (the JAX default)
_CANONICAL = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.uint64: torch.uint32,
    torch.complex128: torch.complex64,
}


def _tdt(p) -> torch.dtype:
    """A sanitized dtype param as a (canonical) torch dtype."""
    name = p["__dtype__"] if isinstance(p, dict) else str(p)
    dtype = _TORCH_DTYPES.get(name)
    if dtype is None:
        raise PlanTranslationError(f"dtype {name!r} not supported by the torch backend")
    return _CANONICAL.get(dtype, dtype)


def _dims(x) -> tuple[int, ...]:
    """Coerce a sanitized dims param (list of ints / 0-d arrays) to ints."""
    if x is None:
        return ()
    return tuple(int(np.asarray(v)) for v in x)


def _tt(x):  # tuple-of-tuples from sanitized lists
    return tuple(tuple(v) if isinstance(v, list) else v for v in x)


def _window_init(dtype) -> Any:
    """Identity for a max reduction at this dtype (numpy or torch)."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return -math.inf
        if dtype == torch.bool:
            return False
        return torch.iinfo(dtype).min
    if np.issubdtype(np.dtype(dtype), np.floating):
        return -np.inf
    return np.iinfo(np.dtype(dtype)).min


def _gs_dnums(p) -> tuple[tuple[int, ...], ...]:
    dims = [tuple(_dims(d)) for d in p["dimension_numbers"]]
    if len(dims) == 3:  # pre-batching-dims trace: batching dims default ()
        dims += [(), ()]
    if len(dims) != 5:
        raise PlanTranslationError(
            f"gather/scatter: unsupported dimension_numbers arity {len(dims)}"
        )
    return tuple(dims)


def _gs_mode(p) -> str:
    """'clip' | 'fill_or_drop' from the sanitized mode repr.
    PROMISE_IN_BOUNDS is executed as CLIP: out-of-bounds under a promise is
    undefined behavior in XLA, and for a REMOTE-SUPPLIED program clamping
    is the only safe refinement."""
    mode = p.get("mode")
    text = mode.get("__repr__", "") if isinstance(mode, dict) else str(mode)
    if "FILL_OR_DROP" in text:
        return "fill_or_drop"
    if "CLIP" in text or "PROMISE_IN_BOUNDS" in text or not text:
        return "clip"
    raise PlanTranslationError(f"gather/scatter: unsupported mode {text!r}")


def _gs_fill_value(fill, dtype):
    """jax's fill_value=None resolution (lax.gather): NaN for inexact,
    False for bool, the most negative/positive representable for
    signed/unsigned ints — so every backend agrees on the wire."""
    if fill is not None:
        return fill
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point or dtype.is_complex:
            return math.nan
        if dtype == torch.bool:
            return False
        info = torch.iinfo(dtype)
        return info.min if info.min < 0 else info.max
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.inexact):
        return np.nan
    if dt == np.bool_:
        return False
    try:
        info = np.iinfo(dt)
    except ValueError as err:
        raise PlanTranslationError(
            f"gather: no default fill_value for dtype {dt}"
        ) from err
    return info.min if np.issubdtype(dt, np.signedinteger) else info.max


# --- bounds -----------------------------------------------------------------

#: ceiling on any single array an op-list may allocate (~1 GB f32): the
#: dialect executes REMOTE-SUPPLIED programs, and a few hundred bytes of
#: envelope must not be able to demand a multi-TB iota/broadcast
MAX_OPLIST_ELEMENTS = 1 << 28
#: nested call-op depth bound — a hostile envelope of self-nesting jaxprs
#: must fail typed, not exhaust the interpreter stack
MAX_OPLIST_DEPTH = 64

#: ops whose params directly size an output allocation
_ALLOC_SHAPE_PARAMS = {
    "iota": "shape",
    "broadcast_in_dim": "shape",
    "reshape": "new_sizes",
}

#: ops whose OUTPUT can dwarf their inputs even when every operand is
#: within bounds (outer-product dot_general, dilated conv, a concatenate
#: repeating one operand many times, padding-inflated window reductions,
#: a gather with a hostile index count) — their output shape is derived
#: from the params (``_SHAPE_RULES``, allocating nothing) and bounded.
#: scatter-add's output is operand-shaped, but its shape rule is the
#: typed-params gate: hostile dimension_numbers fail as
#: PlanTranslationError on both backends, not as a raw IndexError.
#: Backend-side intermediates (padded/dilated arrays) are bounded at their
#: allocation sites via _bounded_elems.
_EXPANSION_OPS = (
    "dot_general",
    "conv_general_dilated",
    "concatenate",
    "reduce_window_max",
    "gather",
    "scatter-add",
)
# select_and_scatter_add is NOT in _EXPANSION_OPS: its output is always
# operand-shaped; the window grid is validated inside each backend's op.


def _bounded_elems(shape, what: str) -> None:
    n = 1
    for d in shape:
        if d < 0:
            raise PlanTranslationError(f"{what}: negative dim in {shape}")
        n *= int(d)
    if n > MAX_OPLIST_ELEMENTS:
        raise PlanTranslationError(
            f"{what}: {n} elements exceeds the "
            f"{MAX_OPLIST_ELEMENTS}-element allocation bound"
        )


def _shape(x) -> tuple[int, ...]:
    return tuple(int(d) for d in getattr(x, "shape", ()))


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _axes_ok(axes, rank: int) -> bool:
    return all(0 <= d < rank for d in axes) and len(set(axes)) == len(axes)


def _shape_dot_general(a, b, p) -> tuple[int, ...]:
    dnums = _tt(p["dimension_numbers"])
    (lc, rc), (lb, rb) = (
        tuple(tuple(_dims(d)) for d in dnums[0]),
        tuple(tuple(_dims(d)) for d in dnums[1]),
    )
    sa, sb = _shape(a), _shape(b)
    _need(len(lc) == len(rc) and len(lb) == len(rb), "dimension count mismatch")
    _need(_axes_ok(lc + lb, len(sa)) and _axes_ok(rc + rb, len(sb)), "dims out of range")
    _need(all(sa[i] == sb[j] for i, j in zip(lc + lb, rc + rb)), "size mismatch")
    free_a = [sa[i] for i in range(len(sa)) if i not in lc + lb]
    free_b = [sb[j] for j in range(len(sb)) if j not in rc + rb]
    return tuple([sa[i] for i in lb] + free_a + free_b)


def _conv_geometry(sa, sb, p):
    """Shape-level validation of conv_general_dilated; returns
    ``(specs, strides, pads, ldil, rdil, groups, bgroups, canonical out
    shape [N, O, *spatial])``."""
    lhs_spec, rhs_spec, out_spec = [tuple(_dims(d)) for d in p["dimension_numbers"]]
    n = len(sa)
    _need(n >= 2 and len(sb) == n, "operand ranks differ")
    for spec in (lhs_spec, rhs_spec, out_spec):
        _need(len(spec) == n and sorted(spec) == list(range(n)), "bad dimension_numbers")
    nsp = n - 2
    strides = _dims(p["window_strides"])
    pads = [tuple(_dims(q)) for q in p["padding"]]
    ldil = _dims(p.get("lhs_dilation") or [1] * nsp)
    rdil = _dims(p.get("rhs_dilation") or [1] * nsp)
    groups = int(p.get("feature_group_count", 1))
    bgroups = int(p.get("batch_group_count", 1))
    _need(len(strides) == len(pads) == len(ldil) == len(rdil) == nsp, "spatial rank mismatch")
    _need(all(len(q) == 2 for q in pads), "bad padding")
    _need(all(s >= 1 for s in strides + ldil + rdil), "strides and dilations must be >= 1")
    _need(groups >= 1 and bgroups >= 1 and (groups == 1 or bgroups == 1), "bad group counts")
    N, C = sa[lhs_spec[0]], sa[lhs_spec[1]]
    O, I = sb[rhs_spec[0]], sb[rhs_spec[1]]
    _need(C == I * groups and O % groups == 0, "feature_group_count mismatch")
    _need(N % bgroups == 0 and O % bgroups == 0, "batch_group_count mismatch")
    out = [N // bgroups, O]
    for i in range(nsp):
        d, k = sa[lhs_spec[2 + i]], sb[rhs_spec[2 + i]]
        d_dil = (d - 1) * ldil[i] + 1 if d else 0
        k_eff = (k - 1) * rdil[i] + 1 if k else 0
        padded = d_dil + pads[i][0] + pads[i][1]
        out.append((padded - k_eff) // strides[i] + 1 if padded >= k_eff and k else 0)
    specs = (lhs_spec, rhs_spec, out_spec)
    return specs, strides, pads, ldil, rdil, groups, bgroups, tuple(out)


def _shape_conv(a, b, p) -> tuple[int, ...]:
    specs, *_, canon = _conv_geometry(_shape(a), _shape(b), p)
    out = [0] * len(canon)
    for i, d in enumerate(specs[2]):
        out[d] = canon[i]
    return tuple(out)


def _shape_concatenate(*args) -> tuple[int, ...]:
    p, arrays = args[-1], args[:-1]
    shapes = [_shape(a) for a in arrays]
    _need(len(shapes) > 0, "nothing to concatenate")
    dim = int(p["dimension"])
    rank = len(shapes[0])
    _need(0 <= dim < rank and all(len(s) == rank for s in shapes), "bad dimension")
    _need(all(s[:dim] + s[dim + 1:] == shapes[0][:dim] + shapes[0][dim + 1:] for s in shapes),
          "shapes differ off the concatenated dim")
    out = list(shapes[0])
    out[dim] = sum(s[dim] for s in shapes)
    return tuple(out)


def _window_geometry(sa, p, dilations: bool = True):
    wd = _dims(p["window_dimensions"])
    ws = _dims(p["window_strides"])
    pads = [tuple(_dims(q)) for q in p["padding"]]
    n = len(sa)
    wdil = _dims(p.get("window_dilation") or [1] * n) if dilations else (1,) * n
    bdil = _dims(p.get("base_dilation") or [1] * n) if dilations else (1,) * n
    _need(len(wd) == len(ws) == len(pads) == len(wdil) == len(bdil) == n, "window rank mismatch")
    _need(all(len(q) == 2 for q in pads), "bad padding")
    _need(all(v >= 1 for v in wd + ws + wdil + bdil), "window sizes must be >= 1")
    out = []
    for d, w, s, (lo, hi), wl, bl in zip(sa, wd, ws, pads, wdil, bdil):
        padded = ((d - 1) * bl + 1 if d else 0) + lo + hi
        eff = (w - 1) * wl + 1
        out.append((padded - eff) // s + 1 if padded >= eff else 0)
    return wd, ws, pads, wdil, bdil, tuple(out)


def _shape_reduce_window_max(a, p) -> tuple[int, ...]:
    return _window_geometry(_shape(a), p)[-1]


def _gather_geometry(sa, si, p):
    """The reference's gather validation, on shapes; returns
    ``(dnums, slice_sizes, batch_shape, kept dims, batch positions, out shape)``."""
    offs, coll, smap, ob, ib = _gs_dnums(p)
    slice_sizes = _dims(p["slice_sizes"])
    n = len(sa)
    _need(len(slice_sizes) == n, f"slice_sizes rank {len(slice_sizes)} != operand rank {n}")
    _need(len(si) >= 1 and si[-1] == len(smap), "index vector dim does not match start_index_map")
    _need(all(0 <= sz <= sa[d] for d, sz in enumerate(slice_sizes)), "slice size out of range")
    _need(_axes_ok(coll + ob, n) and _axes_ok(smap, n), "operand dims out of range")
    _need(all(slice_sizes[d] == 1 for d in coll + ob), "collapsed/batching dim slice size != 1")
    _need(len(ob) == len(ib) and all(0 <= b < len(si) - 1 for b in ib),
          "indices batching dims out of range")
    batch_shape = si[:-1]
    kept = [d for d in range(n) if d not in coll and d not in ob]
    _need(len(offs) == len(kept), "offset_dims / slice-dim mismatch")
    out_rank = len(batch_shape) + len(offs)
    _need(_axes_ok(offs, out_rank), "offset_dims out of range")
    batch_pos = [d for d in range(out_rank) if d not in offs]
    out = [0] * out_rank
    for d, size in zip(batch_pos, batch_shape):
        out[d] = size
    for d, opd in zip(offs, kept):
        out[d] = slice_sizes[opd]
    return (offs, coll, smap, ob, ib), slice_sizes, batch_shape, kept, batch_pos, tuple(out)


def _shape_gather(a, idx, p) -> tuple[int, ...]:
    return _gather_geometry(_shape(a), _shape(idx), p)[-1]


def _scatter_geometry(sa, si, su, p):
    """The reference's scatter-add validation, on shapes; returns
    ``(dnums, batch_shape, window operand dims, update batch dims, window sizes)``."""
    uw, ins, smap, ob, ib = _gs_dnums(p)
    n = len(sa)
    _need(len(si) >= 1 and si[-1] == len(smap),
          "index vector dim does not match scatter_dims_to_operand_dims")
    _need(_axes_ok(ins + ob, n) and _axes_ok(smap, n), "operand dims out of range")
    _need(len(ob) == len(ib) and all(0 <= b < len(si) - 1 for b in ib),
          "indices batching dims out of range")
    batch_shape = si[:-1]
    window_operand_dims = [d for d in range(n) if d not in ins and d not in ob]
    _need(len(uw) == len(window_operand_dims), "update_window_dims / operand window mismatch")
    _need(_axes_ok(uw, len(su)), "update_window_dims out of range")
    upd_batch_dims = [d for d in range(len(su)) if d not in uw]
    _need(tuple(su[d] for d in upd_batch_dims) == tuple(batch_shape),
          "update batch shape does not match indices")
    window_sizes = [1] * n
    for ud, opd in zip(uw, window_operand_dims):
        window_sizes[opd] = su[ud]
    _need(all(window_sizes[d] <= sa[d] for d in range(n)), "update window exceeds operand")
    return (uw, ins, smap, ob, ib), batch_shape, window_operand_dims, upd_batch_dims, window_sizes


def _shape_scatter_add(a, idx, upd, p) -> tuple[int, ...]:
    _scatter_geometry(_shape(a), _shape(idx), _shape(upd), p)
    return _shape(a)


_SHAPE_RULES = {
    "dot_general": _shape_dot_general,
    "conv_general_dilated": _shape_conv,
    "concatenate": _shape_concatenate,
    "reduce_window_max": _shape_reduce_window_max,
    "gather": _shape_gather,
    "scatter-add": _shape_scatter_add,
}


def _check_alloc(op: str, params: dict, invals: tuple = ()) -> None:
    key = _ALLOC_SHAPE_PARAMS.get(op)
    if key is not None and key in params:
        dims = _dims(params[key])
        n = 1
        for d in dims:
            if d < 0:
                raise PlanTranslationError(f"{op}: negative dim in {dims}")
            n *= d
        if n > MAX_OPLIST_ELEMENTS:
            raise PlanTranslationError(
                f"{op}: output of {n} elements exceeds the "
                f"{MAX_OPLIST_ELEMENTS}-element allocation bound"
            )
        return
    rule = _SHAPE_RULES.get(op)
    if rule is None:
        return
    try:
        shape = rule(*invals, params)
    except PlanTranslationError:
        raise
    except Exception as err:  # noqa: BLE001 — hostile params
        raise PlanTranslationError(f"{op}: invalid params: {err}") from err
    size = math.prod(shape)
    if size > MAX_OPLIST_ELEMENTS:
        raise PlanTranslationError(
            f"{op}: output of {size} elements exceeds the "
            f"{MAX_OPLIST_ELEMENTS}-element allocation bound"
        )


# --- the torch interpreter table --------------------------------------------
#
# Each op takes the reference interpreter's operands (tensors on the run's
# device, or a Python-scalar literal) and its params. A Python-scalar
# literal takes the dtype of the tensor it meets — a jaxpr equation's
# operands share one dtype, so that is the literal's own type, and an f32
# operand never widens to f64.


def _coerce(*xs):
    """Operands as tensors on one device: a Python scalar becomes a 0-d
    tensor of the first tensor operand's dtype (jnp's weak typing)."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    if like is None:
        return tuple(torch.as_tensor(x, dtype=_scalar_dtype(x)) for x in xs)
    return tuple(
        x if isinstance(x, torch.Tensor)
        else torch.tensor(x, dtype=like.dtype, device=like.device)
        for x in xs
    )


def _scalar_dtype(x) -> torch.dtype:
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, int):
        return torch.int32
    return torch.float32


def _unary(fn):
    return lambda a, p: fn(*_coerce(a))


def _binary(fn):
    return lambda a, b, p: fn(*_coerce(a, b))


def _t_div(a, b):
    # jnp.divide true-divides integers (x64 off: into float32)
    if not (a.dtype.is_floating_point or a.dtype.is_complex):
        return torch.true_divide(a.to(torch.float32), b.to(torch.float32))
    return torch.true_divide(a, b)


def _t_sign(a):
    if a.dtype.is_floating_point:
        return torch.where(torch.isnan(a), a, torch.sign(a))  # jnp.sign(nan) is nan
    return torch.sign(a)


def _t_integer_pow(a, y: int):
    """lax.integer_pow as XLA lowers it: binary exponentiation by repeated
    multiplication (exact for integers), a reciprocal for y < 0."""
    if y == 0:
        return torch.ones_like(a)
    recip, y = y < 0, abs(y)
    acc = None
    while y > 0:
        if y & 1:
            acc = a if acc is None else acc * a
        y >>= 1
        if y > 0:
            a = a * a
    return torch.ones_like(acc) / acc if recip else acc


def _t_convert(a, p):
    (a,) = _coerce(a)
    dtype = _tdt(p["new_dtype"])
    if a.dtype.is_floating_point and not (dtype.is_floating_point or dtype == torch.bool):
        a = torch.trunc(a)  # float -> int truncates toward zero
    return a.to(dtype)


def _t_reduce(kind: str):
    def run(x, p):
        (x,) = _coerce(x)
        axes = _dims(p["axes"])
        if not axes:
            return x.to(torch.bool) if kind in ("and", "or") else x
        if kind == "sum":
            return torch.sum(x, dim=axes).to(x.dtype)
        if kind == "max":
            return torch.amax(x, dim=axes)
        if kind == "min":
            return torch.amin(x, dim=axes)
        out = x
        for d in sorted(axes, reverse=True):
            if kind == "prod":
                out = torch.prod(out, dim=d)
            elif kind == "and":
                out = torch.all(out, dim=d)
            else:
                out = torch.any(out, dim=d)
        return out.to(x.dtype) if kind == "prod" else out

    return run


def _t_arg(fn):
    def run(a, p):
        (a,) = _coerce(a)
        return fn(a, dim=_dims(p["axes"])[0]).to(_tdt(p["index_dtype"]))

    return run


def _t_select_n(*args):
    which, cases = args[0], list(args[1:-1])
    cases = list(_coerce(*cases))
    if not isinstance(which, torch.Tensor):
        which = torch.tensor(which, device=cases[0].device)
    if len(cases) == 2:
        # jnp.where(which, cases[1], cases[0]): any non-zero predicate picks 1
        return torch.where(which.to(torch.bool), cases[1], cases[0])
    # jnp.select: the first matching case, else 0
    out = torch.zeros(torch.broadcast_shapes(which.shape, *[c.shape for c in cases]),
                      dtype=cases[0].dtype, device=cases[0].device)
    for i in reversed(range(len(cases))):
        out = torch.where(which == i, cases[i], out)
    return out


def _t_dot_general(a, b, p):
    a, b = _coerce(a, b)
    spec = _einsum_spec(a.ndim, b.ndim, p)
    if a.dtype.is_floating_point or a.dtype.is_complex:
        return torch.einsum(spec, a, b)
    # integer products wrap mod 2^bits as XLA's do; broadcast-multiply and
    # sum in the operand dtype (the card has no integer matmul)
    lhs, rhs_out = spec.split("->")
    l_sub, r_sub = lhs.split(",")
    letters = sorted(set(l_sub + r_sub), key=(l_sub + r_sub).index)
    _bounded_elems([dict(zip(l_sub + r_sub, _shape(a) + _shape(b)))[c] for c in letters],
                   "dot_general (integer product)")
    full = "".join(letters)
    prod = _broadcast_sub(a, l_sub, full) * _broadcast_sub(b, r_sub, full)
    contracted = [i for i, c in enumerate(full) if c not in rhs_out]
    out = torch.sum(prod, dim=contracted).to(a.dtype) if contracted else prod
    kept = "".join(c for c in full if c in rhs_out)
    return out.permute([kept.index(c) for c in rhs_out])


def _broadcast_sub(x, sub: str, full: str):
    """``x`` (axes labelled ``sub``) viewed with one axis per letter of
    ``full``, in ``full``'s order, size 1 where it has no such axis."""
    order = [sub.index(c) for c in full if c in sub]
    x = x.permute(order)
    shape = []
    it = iter(x.shape)
    for c in full:
        shape.append(next(it) if c in sub else 1)
    return x.reshape(shape)


def _einsum_spec(na: int, nb: int, params) -> str:
    dnums = _tt(params["dimension_numbers"])
    (lc, rc), (lb, rb) = (
        tuple(tuple(_dims(d)) for d in dnums[0]),
        tuple(tuple(_dims(d)) for d in dnums[1]),
    )
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    l_sub: list[Any] = [None] * na
    r_sub: list[Any] = [None] * nb
    batch = []
    for i, j in zip(lb, rb):
        ch = next(letters)
        l_sub[i] = r_sub[j] = ch
        batch.append(ch)
    for i, j in zip(lc, rc):
        ch = next(letters)
        l_sub[i] = r_sub[j] = ch
    l_free = []
    for i in range(na):
        if l_sub[i] is None:
            l_sub[i] = next(letters)
            l_free.append(l_sub[i])
    r_free = []
    for j in range(nb):
        if r_sub[j] is None:
            r_sub[j] = next(letters)
            r_free.append(r_sub[j])
    return f"{''.join(l_sub)},{''.join(r_sub)}->{''.join(batch + l_free + r_free)}"


def _t_dilate(x, dil, axes, fill=0):
    """Insert ``dil - 1`` copies of ``fill`` between neighbours along each
    of ``axes`` (XLA's lhs/base dilation)."""
    for ax, d in zip(axes, dil):
        if d == 1 or x.shape[ax] == 0:
            continue
        shape = list(x.shape)
        shape[ax] = (shape[ax] - 1) * d + 1
        _bounded_elems(shape, "conv (dilated operand)")
        out = torch.full(shape, fill, dtype=x.dtype, device=x.device)
        sel = [slice(None)] * x.ndim
        sel[ax] = slice(None, None, d)
        out[tuple(sel)] = x
        x = out
    return x


def _t_pad(x, pads, first_axis: int, value=0):
    """Pad (or, for negative entries, crop) the trailing axes from
    ``first_axis`` on by ``pads`` [(lo, hi), ...]."""
    if not any(lo or hi for lo, hi in pads):
        return x
    grown = [d + max(0, lo) + max(0, hi) for d, (lo, hi) in
             zip(x.shape[first_axis:], pads)]
    _bounded_elems(list(x.shape[:first_axis]) + grown, "padded operand")
    flat = []
    for lo, hi in reversed(pads):  # F.pad lists the last axis first
        flat += [lo, hi]
    return F.pad(x, flat, value=value)


def _t_conv(a, b, p):
    """conv_general_dilated on torch: permute to [N, C, *spatial] x
    [O, I, *spatial] by the dimension numbers, dilate the lhs by zero
    insertion and pad (negative padding crops), then one ``convNd`` with
    the rhs dilation, the strides and the feature groups; batch groups
    fold the lhs batch into channel groups. Covers the forward AND both
    backward convs a training plan emits."""
    a, b = _coerce(a, b)
    specs, strides, pads, ldil, rdil, groups, bgroups, out_shape = _conv_geometry(
        _shape(a), _shape(b), p)
    lhs_spec, rhs_spec, out_spec = specs
    nsp = a.ndim - 2
    if not (a.dtype.is_floating_point or a.dtype.is_complex):
        raise PlanTranslationError("conv_general_dilated: integer operands are not "
                                   "supported by the torch backend")
    if nsp not in (1, 2, 3):
        raise PlanTranslationError(f"conv_general_dilated: {nsp} spatial dims not "
                                   "supported by the torch backend")
    x = a.permute(lhs_spec)
    w = b.permute(rhs_spec)
    x = _t_dilate(x, ldil, range(2, 2 + nsp))
    x = _t_pad(x, pads, 2)
    if bgroups > 1:
        # batch group g (rows g*N/G ... of the batch) feeds output
        # features group g: move the groups into the channel axis
        n, c = x.shape[0] // bgroups, x.shape[1]
        x = x.reshape(bgroups, n, c, *x.shape[2:]).transpose(0, 1)
        x = x.reshape(n, bgroups * c, *x.shape[3:])
        groups = bgroups
    if 0 in out_shape:  # an empty window grid: convNd rejects it
        out = torch.zeros(out_shape, dtype=a.dtype, device=a.device)
    else:
        conv = (F.conv1d, F.conv2d, F.conv3d)[nsp - 1]
        out = conv(x, w, stride=strides, dilation=rdil, groups=groups)
    return out.permute(np.argsort(out_spec).tolist())


def _t_windows(x, wd, ws, wdil):
    """Sliding windows: [*out_grid, *window] (a view)."""
    n = x.ndim
    for d in range(n):
        eff = (wd[d] - 1) * wdil[d] + 1
        x = x.unfold(d, eff, ws[d])
    if any(v != 1 for v in wdil):
        x = x[(slice(None),) * n + tuple(slice(None, None, v) for v in wdil)]
    return x


def _t_reduce_window_max(a, p):
    (a,) = _coerce(a)
    wd, ws, pads, wdil, bdil, out_shape = _window_geometry(_shape(a), p)
    init = _window_init(a.dtype)
    x = _t_dilate(a, bdil, range(a.ndim), fill=init)
    x = _t_pad(x, pads, 0, value=init)
    if 0 in out_shape:
        return torch.full(out_shape, init, dtype=a.dtype, device=a.device)
    win = _t_windows(x, wd, ws, wdil)
    return torch.amax(win, dim=tuple(range(a.ndim, 2 * a.ndim)))


def _t_select_and_scatter_add(source, operand, p):
    """The maxpool VJP: each source value lands on the first maximum of
    its window in row-major window order (XLA's 'ge' scan; ties — a
    window of post-ReLU zeros — go to the first element), the same rule
    as the reference's numpy twin."""
    sel = p.get("select_prim")
    if not (isinstance(sel, dict) and sel.get("__repr__") == "ge"):
        raise PlanTranslationError(
            f"select_and_scatter_add: unsupported select {sel!r}"
        )
    source, operand = _coerce(source, operand)
    n = operand.ndim
    try:
        wd, ws, pads, _, _, out_shape = _window_geometry(_shape(operand), p, dilations=False)
    except ValueError as err:
        raise PlanTranslationError(f"select_and_scatter_add: invalid params: {err}") from err
    _bounded_elems(out_shape, "select_and_scatter_add (window grid)")
    if tuple(source.shape) != out_shape:
        raise PlanTranslationError(
            f"select_and_scatter_add: source shape {tuple(source.shape)} "
            f"does not match window grid {out_shape}"
        )
    padded = _t_pad(operand, pads, 0, value=_window_init(operand.dtype))
    if 0 in out_shape:
        return torch.zeros_like(operand, dtype=source.dtype)
    win = _t_windows(padded, wd, ws, (1,) * n)
    arg = win.reshape(*out_shape, -1).argmax(dim=-1)  # first max, row-major
    # absolute (padded) flat index of each selected element
    flat = torch.zeros(out_shape, dtype=torch.int64, device=operand.device)
    rem = arg
    strides = [math.prod(padded.shape[d + 1:]) for d in range(n)]
    for d in range(n):
        wstride = math.prod(wd[d + 1:])
        off = torch.div(rem, wstride, rounding_mode="floor")
        rem = rem - off * wstride
        grid = torch.arange(out_shape[d], device=operand.device) * ws[d]
        view = [1] * n
        view[d] = out_shape[d]
        flat = flat + (grid.reshape(view) + off) * strides[d]
    scatter = torch.zeros(padded.numel(), dtype=source.dtype, device=operand.device)
    scatter.index_put_((flat.reshape(-1),), source.reshape(-1), accumulate=True)
    # undo the padding (a negative pad, a crop, grows back as zeros)
    return _t_pad(scatter.reshape(padded.shape), [(-lo, -hi) for lo, hi in pads], 0)


def _gather_starts(idx, smap, ob, ib, n, batch_shape):
    """[B, n] int64 start of each index row's slice (zeros off the map)."""
    rows = idx.reshape(-1, idx.shape[-1]).to(torch.int64)
    starts = torch.zeros((rows.shape[0], n), dtype=torch.int64, device=idx.device)
    for j, opd in enumerate(smap):
        starts[:, opd] = rows[:, j]
    if ob:
        pos = torch.stack(torch.meshgrid(
            *[torch.arange(s, device=idx.device) for s in batch_shape], indexing="ij"),
            dim=-1).reshape(-1, len(batch_shape))
        for opd, idim in zip(ob, ib):
            starts[:, opd] = pos[:, idim]
    return starts


def _window_index(starts, sizes, shape):
    """Per-dim index tensors [B, *sizes] of the windows at ``starts``."""
    n = len(sizes)
    out = []
    for d in range(n):
        view = [1] * n
        view[d] = sizes[d]
        ar = torch.arange(sizes[d], device=starts.device).reshape(view)
        out.append(starts[:, d].reshape(-1, *[1] * n) + ar)
    return out


def _t_gather(a, idx, p):
    """XLA gather, vectorised: offset/collapsed dims, batching dims, CLIP
    (clamp each start) and FILL_OR_DROP (an out-of-bounds row becomes
    fill_value) — the semantics of the reference's ``_np_gather``."""
    a, idx = _coerce(a, idx)
    dnums, slice_sizes, batch_shape, kept, batch_pos, out_shape = _gather_geometry(
        _shape(a), _shape(idx), p)
    offs, coll, smap, ob, ib = dnums
    mode = _gs_mode(p)
    n = a.ndim
    _bounded_elems(out_shape, "gather (output)")
    starts = _gather_starts(idx, smap, ob, ib, n, batch_shape)
    limit = torch.tensor([a.shape[d] - slice_sizes[d] for d in range(n)],
                         dtype=torch.int64, device=a.device)
    oob = ((starts < 0) | (starts > limit)).any(dim=1)
    clamped = torch.minimum(torch.clamp(starts, min=0), limit)
    if 0 in slice_sizes or starts.shape[0] == 0:
        rows = torch.zeros((starts.shape[0], *slice_sizes), dtype=a.dtype, device=a.device)
    else:
        rows = a[tuple(_window_index(clamped, slice_sizes, a.shape))]
    if mode == "fill_or_drop":
        fill = torch.tensor(_gs_fill_value(p.get("fill_value"), a.dtype),
                            dtype=a.dtype, device=a.device)
        rows = torch.where(oob.reshape(-1, *[1] * n), fill, rows)
    rows = rows.reshape(*batch_shape, *[slice_sizes[d] for d in kept]) if kept or batch_shape \
        else rows.reshape(())
    perm = [0] * len(out_shape)
    nb = len(batch_shape)
    for k, d in enumerate(batch_pos):
        perm[d] = k
    for k, d in enumerate(offs):
        perm[d] = nb + k
    return rows.permute(perm) if perm else rows


def _t_scatter_add(a, idx, upd, p):
    """XLA scatter-add, vectorised; FILL_OR_DROP drops out-of-bounds
    updates, CLIP clamps them (the reference's ``_np_scatter_add``)."""
    a, idx, upd = _coerce(a, idx, upd)
    dnums, batch_shape, win_dims, upd_batch_dims, window_sizes = _scatter_geometry(
        _shape(a), _shape(idx), _shape(upd), p)
    uw, ins, smap, ob, ib = dnums
    mode = _gs_mode(p)
    n = a.ndim
    starts = _gather_starts(idx, smap, ob, ib, n, batch_shape)
    limit = torch.tensor([a.shape[d] - window_sizes[d] for d in range(n)],
                         dtype=torch.int64, device=a.device)
    oob = ((starts < 0) | (starts > limit)).any(dim=1)
    clamped = torch.minimum(torch.clamp(starts, min=0), limit)
    # updates as [B, *window_sizes]: batch dims first, then the window
    # dims (ascending uw <-> window operand dims), size-1 dims re-inserted
    u = upd.permute(upd_batch_dims + list(uw)).reshape(-1, *window_sizes)
    if mode == "fill_or_drop":
        u = torch.where(oob.reshape(-1, *[1] * n), torch.zeros((), dtype=u.dtype,
                                                               device=u.device), u)
    out = a.clone()
    if u.numel():
        out.index_put_(tuple(_window_index(clamped, window_sizes, a.shape)), u,
                       accumulate=True)
    return out


def _expand_dims(a, dims):
    for d in sorted(dims):
        a = a.unsqueeze(d)
    return a


def _t_broadcast_in_dim(a, p):
    (a,) = _coerce(a)
    shape, bcd = _dims(p["shape"]), _dims(p["broadcast_dimensions"])
    staged = [1] * len(shape)
    for i, d in enumerate(bcd):
        staged[d] = a.shape[i]
    return a.reshape(staged).expand(shape)


def _t_iota(p, device):
    shape, dim = _dims(p["shape"]), int(p["dimension"])
    ar = torch.arange(shape[dim], device=device).to(_tdt(p["dtype"]))
    view = [shape[dim] if i == dim else 1 for i in range(len(shape))]
    return ar.reshape(view).expand(shape)


def _t_slice(a, p):
    (a,) = _coerce(a)
    strides = _dims(p["strides"]) if p.get("strides") else [1] * a.ndim
    return a[tuple(slice(s, l, st) for s, l, st in zip(
        _dims(p["start_indices"]), _dims(p["limit_indices"]), strides))]


def _clamped_starts(starts, shape, sizes) -> list[int]:
    """lax.dynamic_slice's start indices: a negative start counts from the
    end (as jax wraps it), then each is clamped so the window fits."""
    out = []
    for s, d, n in zip(starts, shape, sizes):
        s = int(s)
        s = s + d if s < 0 else s
        out.append(min(max(s, 0), d - n))
    return out


def _t_dynamic_slice(*args):
    a, starts, p = args[0], args[1:-1], args[-1]
    sizes = _dims(p["slice_sizes"])
    c = _clamped_starts(starts, a.shape, sizes)
    return a[tuple(slice(s, s + k) for s, k in zip(c, sizes))]


def _t_dynamic_update_slice(a, u, *rest):
    a, u = _coerce(a, u)
    c = _clamped_starts(rest[:-1], a.shape, u.shape)
    out = a.clone()
    out[tuple(slice(s, s + k) for s, k in zip(c, u.shape))] = u
    return out


def _t_cumsum(a, p):
    (a,) = _coerce(a)
    axis = int(np.asarray(p["axis"]))
    if bool(p.get("reverse", False)):
        return torch.flip(torch.cumsum(torch.flip(a, (axis,)), axis, dtype=a.dtype), (axis,))
    return torch.cumsum(a, axis, dtype=a.dtype)


_TORCH_TABLE: dict[str, Any] = {
    "add": _binary(torch.add),
    "add_any": _binary(torch.add),  # autodiff accumulation
    "rem": _binary(torch.fmod),  # lax.rem: C-style truncation
    "atan2": _binary(torch.atan2),
    "nextafter": _binary(torch.nextafter),
    "clamp": lambda lo, x, hi, p: torch.clamp(*_coerce(x, lo, hi)),
    "cumsum": _t_cumsum,
    "sub": _binary(torch.sub),
    "mul": _binary(torch.mul),
    "div": _binary(_t_div),
    "pow": _binary(torch.pow),
    "max": _binary(torch.maximum),
    "min": _binary(torch.minimum),
    "and": _binary(torch.logical_and),
    "or": _binary(torch.logical_or),
    "xor": _binary(torch.logical_xor),
    "gt": _binary(torch.gt),
    "lt": _binary(torch.lt),
    "ge": _binary(torch.ge),
    "le": _binary(torch.le),
    "eq": _binary(torch.eq),
    "ne": _binary(torch.ne),
    "neg": _unary(torch.neg),
    "sign": _unary(_t_sign),
    "abs": _unary(torch.abs),
    "exp": _unary(torch.exp),
    "log": _unary(torch.log),
    "tanh": _unary(torch.tanh),
    "sqrt": _unary(torch.sqrt),
    "rsqrt": _unary(torch.rsqrt),
    "logistic": _unary(torch.sigmoid),
    "floor": _unary(torch.floor),
    "ceil": _unary(torch.ceil),
    "round": _unary(torch.round),  # half to even, as jnp.round
    "is_finite": _unary(torch.isfinite),
    "stop_gradient": lambda a, p: a,
    "copy": lambda a, p: a,
    "integer_pow": lambda a, p: _t_integer_pow(*_coerce(a), int(p["y"])),
    "exp2": _unary(torch.exp2),
    "square": _unary(lambda a: a * a),
    "convert_element_type": _t_convert,
    "reshape": lambda a, p: _coerce(a)[0].reshape(_dims(p["new_sizes"])),
    "squeeze": lambda a, p: _coerce(a)[0].squeeze(_dims(p["dimensions"])),
    "expand_dims": lambda a, p: _expand_dims(_coerce(a)[0], _dims(p["dimensions"])),
    "transpose": lambda a, p: _coerce(a)[0].permute(_dims(p["permutation"])),
    "broadcast_in_dim": _t_broadcast_in_dim,
    "slice": _t_slice,
    "rev": lambda a, p: torch.flip(_coerce(a)[0], _dims(p["dimensions"])),
    "reduce_sum": _t_reduce("sum"),
    "reduce_max": _t_reduce("max"),
    "reduce_min": _t_reduce("min"),
    "reduce_prod": _t_reduce("prod"),
    "reduce_and": _t_reduce("and"),
    "reduce_or": _t_reduce("or"),
    "argmax": _t_arg(torch.argmax),
    "argmin": _t_arg(torch.argmin),
    "select_n": _t_select_n,
    "dot_general": _t_dot_general,
    "conv_general_dilated": _t_conv,
    "reduce_window_max": _t_reduce_window_max,
    "select_and_scatter_add": _t_select_and_scatter_add,
    "gather": _t_gather,
    "scatter-add": _t_scatter_add,
    "concatenate": lambda *args: torch.cat(_coerce(*args[:-1]), int(args[-1]["dimension"])),
    "iota": _t_iota,
    "dynamic_slice": _t_dynamic_slice,
    "dynamic_update_slice": _t_dynamic_update_slice,
}


# --- pure-numpy interpreter table -------------------------------------------
#
# The port's copy of the reference's numpy-only table: a foreign client with
# only an ndarray library can run a grad-traced training plan.


def _np_dot_general(a, b, params):
    return np.einsum(_einsum_spec(a.ndim, b.ndim, params), a, b)


def _np_broadcast_in_dim(a, p):
    shape, bcd = _dims(p["shape"]), _dims(p["broadcast_dimensions"])
    staged = [1] * len(shape)
    for i, d in enumerate(bcd):
        staged[d] = a.shape[i]
    return np.broadcast_to(np.reshape(a, staged), shape)


def _np_iota(p):
    shape, dim = _dims(p["shape"]), int(p["dimension"])
    ar = np.arange(shape[dim], dtype=_dt(p["dtype"]))
    view = np.reshape(
        ar, [shape[dim] if i == dim else 1 for i in range(len(shape))]
    )
    return np.broadcast_to(view, shape)


def _np_reduce(fn):
    def run(x, params):
        return fn(x, axis=_dims(params["axes"]) or None)

    return run


def _np_windows(a: np.ndarray, p: dict, pad_value) -> tuple[np.ndarray, tuple]:
    """Strided sliding windows of ``a`` per reduce-window params: returns
    (patches [out_shape… + window_dims…], padded input shape). Supports
    window_dilation via strided slicing of the window dims; base_dilation
    must be 1 (typed error — nothing in the plan corpus emits it)."""
    wd = _dims(p["window_dimensions"])
    ws = _dims(p["window_strides"])
    pads = [tuple(_dims(q)) for q in p["padding"]]
    wdil = _dims(p.get("window_dilation") or [1] * a.ndim)
    bdil = _dims(p.get("base_dilation") or [1] * a.ndim)
    if any(d != 1 for d in bdil):
        raise PlanTranslationError(
            "reduce_window: base_dilation != 1 not supported by the "
            "numpy backend"
        )
    _bounded_elems(
        [d + lo + hi for d, (lo, hi) in zip(a.shape, pads)],
        "reduce_window (padded input)",
    )
    padded = np.pad(a, pads, constant_values=pad_value)
    eff_wd = tuple((w - 1) * d + 1 for w, d in zip(wd, wdil))
    view = np.lib.stride_tricks.sliding_window_view(padded, eff_wd)
    # stride the output positions, then dilate the window dims
    out_sel = tuple(slice(None, None, s) for s in ws)
    win_sel = tuple(slice(None, None, d) for d in wdil)
    return view[out_sel + win_sel], padded.shape


def _np_reduce_window_max(a, p):
    patches, _ = _np_windows(a, p, _window_init(a.dtype))
    return patches.max(axis=tuple(range(a.ndim, 2 * a.ndim)))


def _np_select_and_scatter_add(source, operand, p):
    """Numpy twin of the maxpool VJP: route each source value to the
    first-maximum position of its window (XLA's 'ge' scan-order tie
    rule = argmax over row-major window order)."""
    sel = p.get("select_prim")
    if not (isinstance(sel, dict) and sel.get("__repr__") == "ge"):
        raise PlanTranslationError(
            f"select_and_scatter_add: unsupported select {sel!r}"
        )
    n = operand.ndim
    pads = [tuple(_dims(q)) for q in p["padding"]]
    patches, padded_shape = _np_windows(
        operand, {**p, "window_dilation": [1] * n}, _window_init(operand.dtype)
    )
    out_shape = patches.shape[:n]
    if tuple(np.shape(source)) != out_shape:
        raise PlanTranslationError(
            f"select_and_scatter_add: source shape {np.shape(source)} "
            f"does not match window grid {out_shape}"
        )
    wd = patches.shape[n:]
    flat = patches.reshape(out_shape + (-1,))
    arg = flat.argmax(axis=-1)                      # first max, row-major
    # absolute (padded) coordinates of each selected element
    win_off = np.unravel_index(arg, wd)             # n arrays, out_shape
    ws = _dims(p["window_strides"])
    out_grid = np.meshgrid(
        *[np.arange(s) for s in out_shape], indexing="ij"
    )
    scatter = np.zeros(padded_shape, dtype=source.dtype)
    idx = tuple(g * s + w for g, s, w in zip(out_grid, ws, win_off))
    np.add.at(scatter, idx, source)
    # crop the padding back off
    crop = tuple(
        slice(lo, lo + dim) for (lo, _), dim in zip(pads, operand.shape)
    )
    return scatter[crop]


def _np_conv(a, b, p):
    """conv_general_dilated on numpy: normalize to (N, C, *spatial) ×
    (O, I, *spatial) via the dimension numbers, dilate/pad explicitly,
    then one sliding-window tensordot per feature group. Covers the
    forward AND both backward convs the training plans emit (input grads
    arrive as lhs_dilation, weight grads as a transposed conv)."""
    dn = [tuple(_dims(d)) for d in p["dimension_numbers"]]
    lhs_spec, rhs_spec, out_spec = dn
    if int(p.get("batch_group_count", 1)) != 1:
        raise PlanTranslationError(
            "conv: batch_group_count != 1 not supported by numpy backend"
        )
    groups = int(p.get("feature_group_count", 1))
    a = np.transpose(a, lhs_spec)                   # [N, C, *spatial]
    b = np.transpose(b, rhs_spec)                   # [O, I, *spatial]
    nsp = a.ndim - 2
    strides = _dims(p["window_strides"])
    pads = [tuple(_dims(q)) for q in p["padding"]]
    ldil = _dims(p.get("lhs_dilation") or [1] * nsp)
    rdil = _dims(p.get("rhs_dilation") or [1] * nsp)

    def dilate(x, dil, axes):
        for ax, d in zip(axes, dil):
            if d == 1:
                continue
            shape = list(x.shape)
            shape[ax] = (shape[ax] - 1) * d + 1 if shape[ax] else 0
            _bounded_elems(shape, "conv (dilated operand)")
            out = np.zeros(shape, x.dtype)
            out[tuple(
                slice(None, None, d) if i == ax else slice(None)
                for i in range(x.ndim)
            )] = x
            x = out
        return x

    a = dilate(a, ldil, range(2, 2 + nsp))
    b = dilate(b, rdil, range(2, 2 + nsp))
    # negative padding = cropping (conv transpose emits it); a crop that
    # consumes the whole dim yields an EMPTY dim, exactly like lax
    crop = []
    for i, (lo, hi) in enumerate(pads):
        start = max(0, -lo)
        stop = max(start, a.shape[2 + i] - max(0, -hi))
        crop.append(slice(start, stop))
    a = a[(slice(None), slice(None)) + tuple(crop)]
    pos_pads = [(max(0, lo), max(0, hi)) for lo, hi in pads]
    _bounded_elems(
        list(a.shape[:2])
        + [d + lo + hi for d, (lo, hi) in zip(a.shape[2:], pos_pads)],
        "conv (padded operand)",
    )
    a = np.pad(a, [(0, 0), (0, 0)] + pos_pads)
    kernel_sp = b.shape[2:]
    view = np.lib.stride_tricks.sliding_window_view(
        a, kernel_sp, axis=tuple(range(2, 2 + nsp))
    )  # [N, C, *out_sp, *kernel_sp]
    view = view[
        (slice(None), slice(None))
        + tuple(slice(None, None, s) for s in strides)
    ]
    cin_g = a.shape[1] // groups
    cout_g = b.shape[0] // groups
    outs = []
    for g in range(groups):
        vg = view[:, g * cin_g: (g + 1) * cin_g]
        bg = b[g * cout_g: (g + 1) * cout_g]
        # [N, C, *out, *k] × [O, C, *k] → [N, *out, O]
        og = np.tensordot(
            vg, bg, axes=([1] + list(range(2 + nsp, 2 + 2 * nsp)),
                          [1] + list(range(2, 2 + nsp))),
        )
        outs.append(og)
    out = np.concatenate(outs, axis=-1)             # [N, *out_sp, O]
    out = np.moveaxis(out, -1, 1)                   # [N, O, *out_sp]
    # place result axes per out_spec: out_spec[i] = destination axis of
    # canonical axis i
    inv = np.argsort(out_spec)
    return np.transpose(out, inv)


def _np_gather(a, idx, p):
    """Numpy twin of XLA gather (one Python loop per index row — a
    reference interpreter, not a fast path). Handles offset/collapsed
    dims, batching dims, CLIP and FILL_OR_DROP modes."""
    offs, coll, smap, ob, ib = _gs_dnums(p)
    slice_sizes = _dims(p["slice_sizes"])
    mode = _gs_mode(p)
    idx = np.asarray(idx)
    a = np.asarray(a)
    if len(slice_sizes) != a.ndim:
        raise PlanTranslationError(
            f"gather: slice_sizes rank {len(slice_sizes)} != operand rank "
            f"{a.ndim}"
        )
    if idx.ndim < 1 or idx.shape[-1] != len(smap):
        raise PlanTranslationError(
            "gather: index vector dim does not match start_index_map"
        )
    for d, sz in enumerate(slice_sizes):
        if not 0 <= sz <= a.shape[d]:
            raise PlanTranslationError(
                f"gather: slice size {sz} out of range for dim {d}"
            )
    for d in (*coll, *ob):
        if slice_sizes[d] != 1:
            raise PlanTranslationError(
                f"gather: collapsed/batching dim {d} must have slice size 1"
            )
    for b in ib:
        if not 0 <= b < idx.ndim - 1:
            raise PlanTranslationError(
                f"gather: indices batching dim {b} out of range"
            )
    batch_shape = idx.shape[:-1]
    kept = [d for d in range(a.ndim) if d not in coll and d not in ob]
    if len(offs) != len(kept):
        raise PlanTranslationError("gather: offset_dims / slice-dim mismatch")
    out_rank = len(batch_shape) + len(offs)
    if any(not 0 <= d < out_rank for d in offs):
        raise PlanTranslationError("gather: offset_dims out of range")
    batch_pos = [d for d in range(out_rank) if d not in offs]
    out_shape = [0] * out_rank
    for d, size in zip(batch_pos, batch_shape):
        out_shape[d] = size
    for d, opd in zip(offs, kept):
        out_shape[d] = slice_sizes[opd]
    _bounded_elems(out_shape, "gather (output)")
    if mode == "fill_or_drop":
        # resolve the fill lazily: CLIP never consults it (and the
        # resolution can fail typed for exotic dtypes)
        out = np.full(
            out_shape,
            _gs_fill_value(p.get("fill_value"), a.dtype),
            dtype=a.dtype,
        )
    else:
        out = np.zeros(out_shape, dtype=a.dtype)  # every slot overwritten
    for pos in np.ndindex(*batch_shape):
        starts = [0] * a.ndim
        for j, opd in enumerate(smap):
            starts[opd] = int(idx[pos + (j,)])
        for opd, idim in zip(ob, ib):
            starts[opd] = pos[idim]
        oob = any(
            not 0 <= s <= a.shape[d] - slice_sizes[d]
            for d, s in enumerate(starts)
        )
        if oob:
            if mode == "fill_or_drop":
                continue  # row already holds fill_value
            starts = [
                min(max(s, 0), a.shape[d] - slice_sizes[d])
                for d, s in enumerate(starts)
            ]
        slc = a[tuple(
            slice(s, s + n) for s, n in zip(starts, slice_sizes)
        )]
        slc = np.squeeze(slc, axis=tuple(sorted((*coll, *ob))))
        sel: list[Any] = [slice(None)] * out_rank
        for d, i in zip(batch_pos, pos):
            sel[d] = i
        out[tuple(sel)] = slc
    return out


def _np_scatter_add(a, idx, upd, p):
    """Numpy twin of XLA scatter-add (same loop-per-index-row posture as
    :func:`_np_gather`); FILL_OR_DROP drops out-of-bounds updates, CLIP
    clamps them."""
    uw, ins, smap, ob, ib = _gs_dnums(p)
    mode = _gs_mode(p)
    a = np.asarray(a)
    idx = np.asarray(idx)
    upd = np.asarray(upd)
    if idx.ndim < 1 or idx.shape[-1] != len(smap):
        raise PlanTranslationError(
            "scatter-add: index vector dim does not match "
            "scatter_dims_to_operand_dims"
        )
    for b in ib:
        if not 0 <= b < idx.ndim - 1:
            raise PlanTranslationError(
                f"scatter-add: indices batching dim {b} out of range"
            )
    batch_shape = idx.shape[:-1]
    window_operand_dims = [
        d for d in range(a.ndim) if d not in ins and d not in ob
    ]
    if len(uw) != len(window_operand_dims):
        raise PlanTranslationError(
            "scatter-add: update_window_dims / operand window mismatch"
        )
    if any(not 0 <= d < upd.ndim for d in uw):
        raise PlanTranslationError(
            "scatter-add: update_window_dims out of range"
        )
    upd_batch_dims = [d for d in range(upd.ndim) if d not in uw]
    if tuple(upd.shape[d] for d in upd_batch_dims) != batch_shape:
        raise PlanTranslationError(
            "scatter-add: update batch shape does not match indices"
        )
    window_sizes = [1] * a.ndim
    for ud, opd in zip(uw, window_operand_dims):
        window_sizes[opd] = upd.shape[ud]
    if any(
        window_sizes[d] > a.shape[d] for d in range(a.ndim)
    ):
        raise PlanTranslationError(
            "scatter-add: update window exceeds operand"
        )
    out = np.array(a, copy=True)
    for pos in np.ndindex(*batch_shape):
        starts = [0] * a.ndim
        for j, opd in enumerate(smap):
            starts[opd] = int(idx[pos + (j,)])
        for opd, idim in zip(ob, ib):
            starts[opd] = pos[idim]
        oob = any(
            not 0 <= s <= a.shape[d] - window_sizes[d]
            for d, s in enumerate(starts)
        )
        if oob:
            if mode == "fill_or_drop":
                continue
            starts = [
                min(max(s, 0), a.shape[d] - window_sizes[d])
                for d, s in enumerate(starts)
            ]
        usel: list[Any] = [slice(None)] * upd.ndim
        for d, i in zip(upd_batch_dims, pos):
            usel[d] = i
        # remaining dims are uw in ascending order ↔ window_operand_dims;
        # reshape only re-inserts the size-1 inserted/batching dims
        window = np.reshape(upd[tuple(usel)], window_sizes)
        out[tuple(
            slice(s, s + n) for s, n in zip(starts, window_sizes)
        )] += window
    return out


def _np_select_n(*args):
    which, cases = args[0], list(args[1:-1])
    if len(cases) == 2 and which.dtype == np.bool_:
        return np.where(which, cases[1], cases[0])
    return np.select([which == i for i in range(len(cases))], cases)


def _np_slice(a, p):
    idx = tuple(
        slice(s, l, (st if st else None))
        for s, l, st in zip(
            _dims(p["start_indices"]),
            _dims(p["limit_indices"]),
            _dims(p["strides"]) if p.get("strides") else [None] * a.ndim,
        )
    )
    return a[idx]


def _np_dynamic_slice(*args):
    a, starts, p = args[0], args[1:-1], args[-1]
    sizes = _dims(p["slice_sizes"])
    clamped = [
        int(np.clip(int(s), 0, d - n))
        for s, d, n in zip(starts, a.shape, sizes)
    ]
    return a[tuple(slice(c, c + n) for c, n in zip(clamped, sizes))]


def _np_dus(a, u, starts):
    out = np.array(a, copy=True)
    clamped = [
        int(np.clip(int(s), 0, d - n))
        for s, d, n in zip(starts, a.shape, u.shape)
    ]
    out[tuple(slice(c, c + n) for c, n in zip(clamped, u.shape))] = u
    return out


_NUMPY_TABLE: dict[str, Any] = {
    "add": lambda a, b, p: np.add(a, b),
    "add_any": lambda a, b, p: np.add(a, b),
    "sub": lambda a, b, p: np.subtract(a, b),
    "mul": lambda a, b, p: np.multiply(a, b),
    "div": lambda a, b, p: np.divide(a, b),
    "pow": lambda a, b, p: np.power(a, b),
    "rem": lambda a, b, p: np.fmod(a, b),  # lax.rem: C-style truncation
    "atan2": lambda a, b, p: np.arctan2(a, b),
    "nextafter": lambda a, b, p: np.nextafter(a, b),
    "max": lambda a, b, p: np.maximum(a, b),
    "min": lambda a, b, p: np.minimum(a, b),
    "and": lambda a, b, p: np.logical_and(a, b),
    "or": lambda a, b, p: np.logical_or(a, b),
    "xor": lambda a, b, p: np.logical_xor(a, b),
    "gt": lambda a, b, p: np.greater(a, b),
    "lt": lambda a, b, p: np.less(a, b),
    "ge": lambda a, b, p: np.greater_equal(a, b),
    "le": lambda a, b, p: np.less_equal(a, b),
    "eq": lambda a, b, p: np.equal(a, b),
    "ne": lambda a, b, p: np.not_equal(a, b),
    "clamp": lambda lo, x, hi, p: np.clip(x, lo, hi),
    "cumsum": lambda a, p: (
        np.flip(np.cumsum(np.flip(a, int(np.asarray(p["axis"]))),
                          int(np.asarray(p["axis"]))),
                int(np.asarray(p["axis"])))
        if bool(p.get("reverse", False))
        else np.cumsum(a, int(np.asarray(p["axis"])))
    ),
    "neg": lambda a, p: np.negative(a),
    "sign": lambda a, p: np.sign(a),
    "abs": lambda a, p: np.abs(a),
    "exp": lambda a, p: np.exp(a),
    "exp2": lambda a, p: np.exp2(a),
    "log": lambda a, p: np.log(a),
    "tanh": lambda a, p: np.tanh(a),
    "sqrt": lambda a, p: np.sqrt(a),
    "rsqrt": lambda a, p: 1.0 / np.sqrt(a),
    "logistic": lambda a, p: 1.0 / (1.0 + np.exp(-a)),
    "floor": lambda a, p: np.floor(a),
    "ceil": lambda a, p: np.ceil(a),
    "round": lambda a, p: np.round(a),  # both default to half-to-even
    "is_finite": lambda a, p: np.isfinite(a),
    "stop_gradient": lambda a, p: a,
    "copy": lambda a, p: a,
    "integer_pow": lambda a, p: a ** int(p["y"]),
    "square": lambda a, p: np.square(a),
    "convert_element_type": lambda a, p: np.asarray(a).astype(
        _dt(p["new_dtype"])
    ),
    "reshape": lambda a, p: np.reshape(a, _dims(p["new_sizes"])),
    "squeeze": lambda a, p: np.squeeze(a, axis=_dims(p["dimensions"]) or None),
    "expand_dims": lambda a, p: np.expand_dims(a, _dims(p["dimensions"])),
    "transpose": lambda a, p: np.transpose(a, _dims(p["permutation"])),
    "broadcast_in_dim": _np_broadcast_in_dim,
    "slice": _np_slice,
    "rev": lambda a, p: np.flip(a, _dims(p["dimensions"])),
    "reduce_sum": _np_reduce(np.sum),
    "reduce_max": _np_reduce(np.max),
    "reduce_min": _np_reduce(np.min),
    "reduce_prod": _np_reduce(np.prod),
    "reduce_and": _np_reduce(np.all),
    "reduce_or": _np_reduce(np.any),
    "argmax": lambda a, p: np.argmax(a, axis=_dims(p["axes"])[0]).astype(
        _dt(p["index_dtype"])
    ),
    "argmin": lambda a, p: np.argmin(a, axis=_dims(p["axes"])[0]).astype(
        _dt(p["index_dtype"])
    ),
    "select_n": _np_select_n,
    "dot_general": _np_dot_general,
    "conv_general_dilated": _np_conv,
    "reduce_window_max": _np_reduce_window_max,
    "select_and_scatter_add": _np_select_and_scatter_add,
    "gather": _np_gather,
    "scatter-add": _np_scatter_add,
    "concatenate": lambda *args: np.concatenate(
        list(args[:-1]), int(args[-1]["dimension"])
    ),
    "iota": _np_iota,
    "dynamic_slice": _np_dynamic_slice,
    "dynamic_update_slice": lambda a, u, *rest: _np_dus(a, u, rest[:-1]),
}


#: sub-jaxpr wrapper primitives: executed by running the inner jaxpr
_CALL_OPS = (
    "jit", "pjit", "closed_call", "custom_jvp_call", "custom_vjp_call",
    "custom_jvp_call_jaxpr", "remat", "checkpoint", "custom_transpose_call",
)


def _torch_lift(x, device: torch.device) -> torch.Tensor:
    """An operand as a tensor on ``device``, 64-bit types canonicalised
    to 32 bits as ``jnp.asarray`` does; raw ``|V2`` wire values are
    bfloat16."""
    if isinstance(x, torch.Tensor):
        t = x
    elif isinstance(x, (bool, int, float)):
        t = torch.tensor(x, dtype=_scalar_dtype(x))
    else:
        arr = np.asarray(x)
        if arr.dtype == np.dtype("V2"):
            arr = arr.view(np.int16)
            return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            arr = np.array(arr, order="C")  # a writable copy without negative strides
        t = torch.from_numpy(arr)
    t = t.to(device=device, dtype=_CANONICAL.get(t.dtype, t.dtype))
    return t


def run_oplist(
    oplist: dict,
    *args: Any,
    backend: str = "torch",
    device: str | torch.device = "cuda",
    _depth: int = 0,
) -> Any:
    """Interpret the portable op-list dialect. Returns the plan outputs.

    ``backend="torch"`` executes with torch ops on ``device`` (default
    ``"cuda"``; without a GPU that raises unless the caller passes
    ``device="cpu"``) — the counterpart of the reference's ``"jax"``
    interpreter. ``backend="numpy"`` executes with numpy only, on the
    host (``device`` is not consulted).

    Op-lists are remote-supplied: allocation sizes and call-nesting depth
    are bounded, and any malformed structure fails with a typed
    :class:`PlanTranslationError`.
    """
    if _depth > MAX_OPLIST_DEPTH:
        raise PlanTranslationError(
            f"oplist call nesting exceeds {MAX_OPLIST_DEPTH}"
        )
    if backend == "numpy":
        table, lift = _NUMPY_TABLE, np.asarray
        dev = None
    elif backend == "torch":
        dev = resolve(device)
        table = _TORCH_TABLE

        def lift(x):
            return _torch_lift(x, dev)
    else:
        raise PlanTranslationError(f"unknown oplist backend {backend!r}")
    env: dict[int, Any] = {}
    for cid, cval in zip(oplist["constvars"], oplist["consts"]):
        env[cid] = lift(cval)
    if len(args) != len(oplist["invars"]):
        raise PlanTranslationError(
            f"oplist expects {len(oplist['invars'])} args, got {len(args)}"
        )
    for iid, a in zip(oplist["invars"], args):
        env[iid] = lift(a)

    def read(r):
        if "var" in r:
            return env[r["var"]]
        if "lit" in r:
            return r["lit"]
        return lift(r["lit_arr"])

    for eqn in oplist["eqns"]:
        op, params = eqn["op"], eqn["params"]
        invals = [read(r) for r in eqn["in"]]
        if op in _CALL_OPS:
            inner = None
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                cand = params.get(key)
                if isinstance(cand, dict) and "__jaxpr__" in cand:
                    inner = cand["__jaxpr__"]
                    break
            if inner is None:
                raise PlanTranslationError(f"no inner jaxpr for {op}")
            outs = run_oplist(
                inner, *invals, backend=backend, device=device, _depth=_depth + 1
            )
            outs = outs if isinstance(outs, (list, tuple)) else [outs]
        else:
            fn = table.get(op)
            if fn is None:
                raise PlanTranslationError(
                    f"op {op!r} not in portable dialect ({backend} backend)"
                )
            _check_alloc(op, params, tuple(invals))
            if op == "iota":
                outs = [fn(params, dev) if dev is not None else fn(params)]
            else:
                outs = [fn(*invals, params)]
        for oid, oval in zip(eqn["out"], outs):
            env[oid] = oval

    results = [read(r) for r in oplist["outvars"]]
    return results[0] if len(results) == 1 else tuple(results)


def count_ops(oplist: dict) -> int:
    """Equations one run of ``oplist`` executes, inner call ops' bodies
    included (each call op counts as its body's equations)."""
    n = 0
    for eqn in oplist["eqns"]:
        inner = None
        if eqn["op"] in _CALL_OPS:
            for key in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                cand = eqn["params"].get(key)
                if isinstance(cand, dict) and "__jaxpr__" in cand:
                    inner = cand["__jaxpr__"]
                    break
        n += count_ops(inner) if inner is not None else 1
    return n


# --- torch.export program -> oplist -----------------------------------------
#
# The torch-graph counterpart of the reference's ``jaxpr_to_oplist``: a
# plan built by the port gets the same portable "list" variant a JAX-built
# plan has. The input is the exported program after ``run_decompositions()``
# (core ATen, functional: no in-place op survives). Each ATen op maps onto
# the dialect's own primitives as ``jax.make_jaxpr`` would have emitted
# them, so the JAX package's interpreters, the port's and the encrypted
# interpreter all run the list; the convolution gradients follow JAX's own
# transpose rules (``rev`` of the kernel, lhs dilation by the stride, batch
# and feature swapped for the weight gradient). An op with no lowering
# raises; nothing is dropped.


def _sanitize_param(value: Any) -> Any:
    """One eqn param in the reference's wire-safe encoding (its
    ``_sanitize_param``): dtypes as ``{"__dtype__": name}``, tuples as
    lists."""
    if isinstance(value, (bool, int, float, str, type(None))):
        return value
    if isinstance(value, torch.dtype):
        return {"__dtype__": str(value).removeprefix("torch.")}
    if isinstance(value, (tuple, list)):
        return [_sanitize_param(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _sanitize_param(v) for k, v in value.items()}
    return {"__repr__": repr(value)}


class _Val:
    """A lowered value: its operand reference (``{"var": id}`` or a
    literal), shape and dialect dtype (64-bit types at 32 bits)."""

    __slots__ = ("ref", "shape", "dtype")

    def __init__(self, ref: dict, shape, dtype: torch.dtype) -> None:
        self.ref = ref
        self.shape = tuple(int(d) for d in shape)
        self.dtype = _CANONICAL.get(dtype, dtype)


#: stands for the indices output of ``max_pool2d_with_indices``, which has
#: no dialect op: only the pool's own backward may read it (and ignores it)
_POOL_INDICES = object()

_ELEMENTWISE = {
    "aten.add.Tensor": "add", "aten.sub.Tensor": "sub", "aten.mul.Tensor": "mul",
    "aten.div.Tensor": "div", "aten.div.Scalar": "div", "aten.maximum.default": "max",
}
_COMPARISONS = {
    f"aten.{name}.{kind}": name
    for name in ("eq", "ne", "lt", "le", "gt", "ge") for kind in ("Tensor", "Scalar")
}
_UNARY = {"aten.neg.default": "neg", "aten.exp.default": "exp"}
#: identities of a functional program
_ALIASES = ("aten.clone.default", "aten.alias.default")
_RESHAPES = ("aten.view.default", "aten.squeeze.dims", "aten.squeeze.dim",
             "aten.unsqueeze.default")
_POOL_BACKWARD = "aten.max_pool2d_with_indices_backward.default"


def _pair(v, n: int) -> list[int]:
    v = [int(x) for x in (v if isinstance(v, (list, tuple)) else [v])]
    return v * n if len(v) == 1 else v


class _FxLowering:
    """One walk of an exported program's graph into the dialect."""

    def __init__(self) -> None:
        self.eqns: list[dict] = []
        self.n_ids = 0

    def fresh(self) -> int:
        self.n_ids += 1
        return self.n_ids - 1

    def emit(self, op: str, ins, out_shape, out_dtype, **params) -> _Val:
        out = self.fresh()
        self.eqns.append({
            "op": op,
            "in": [v.ref for v in ins],
            "out": [out],
            "params": {k: _sanitize_param(v) for k, v in params.items()},
        })
        return _Val({"var": out}, out_shape, out_dtype)

    @staticmethod
    def literal(value, dtype: torch.dtype) -> _Val:
        dtype = _CANONICAL.get(dtype, dtype)
        name = str(dtype).removeprefix("torch.")
        try:
            arr = np.asarray(value, dtype=np.dtype(name))
        except TypeError as err:
            raise PlanTranslationError(f"no numpy literal of dtype {name}") from err
        return _Val({"lit_arr": arr}, (), dtype)

    # -- building blocks ---------------------------------------------------

    def at(self, x, dtype: torch.dtype) -> _Val:
        """``x`` at ``dtype``: a Python scalar as a 0-d literal, a value of
        another dtype through ``convert_element_type``."""
        dtype = _CANONICAL.get(dtype, dtype)
        if not isinstance(x, _Val):
            return self.literal(x, dtype)
        if x.dtype == dtype:
            return x
        return self.emit("convert_element_type", [x], x.shape, dtype,
                         new_dtype=dtype, weak_type=False, sharding=None)

    def broadcast(self, v: _Val, shape, dims) -> _Val:
        return self.emit("broadcast_in_dim", [v], shape, v.dtype, shape=list(shape),
                         broadcast_dimensions=list(dims), sharding=None)

    def reshape(self, v: _Val, shape) -> _Val:
        if tuple(shape) == v.shape:
            return v
        return self.emit("reshape", [v], shape, v.dtype, new_sizes=list(shape),
                         dimensions=None, sharding=None)

    def binary(self, op: str, a, b, dtype: torch.dtype, shape, out_dtype=None) -> _Val:
        """An elementwise op as jnp emits it: operands at one dtype, and of
        two operands of rank > 0 the lower-ranked one gets leading unit
        dims by ``broadcast_in_dim`` (rank-0 operands stay as they are)."""
        a, b = self.at(a, dtype), self.at(b, dtype)
        if a.shape and b.shape and len(a.shape) != len(b.shape):
            rank = max(len(a.shape), len(b.shape))

            def up(v):
                n = rank - len(v.shape)
                return v if n == 0 else self.broadcast(v, (1,) * n + v.shape, range(n, rank))

            a, b = up(a), up(b)
        return self.emit(op, [a, b], shape, out_dtype or dtype)

    def reduce(self, op: str, v: _Val, axes) -> _Val:
        axes = sorted({d % len(v.shape) for d in axes}) if v.shape else []
        shape = tuple(s for i, s in enumerate(v.shape) if i not in axes)
        return self.emit(op, [v], shape, v.dtype, axes=axes, out_sharding=None)

    def conv(self, lhs, rhs, shape, dtype, *, strides, padding, lhs_dilation,
             rhs_dilation, dnums) -> _Val:
        return self.emit(
            "conv_general_dilated", [lhs, rhs], shape, dtype,
            window_strides=strides, padding=padding, lhs_dilation=lhs_dilation,
            rhs_dilation=rhs_dilation, dimension_numbers=dnums, feature_group_count=1,
            batch_group_count=1, precision=None, preferred_element_type=None,
            out_sharding=None)

    # -- the graph ---------------------------------------------------------

    def node(self, target: str, args, kwargs, out):
        """Lower one call; returns its value (a tuple for a multi-output
        op, ``_POOL_INDICES`` for the pool's indices)."""
        shape = tuple(out.shape) if isinstance(out, torch.Tensor) else ()
        dtype = out.dtype if isinstance(out, torch.Tensor) else None
        if target in _ALIASES:
            return args[0]
        if target in _ELEMENTWISE:
            if kwargs.get("alpha", 1) != 1 or kwargs.get("rounding_mode") is not None:
                raise PlanTranslationError(f"{target}: alpha/rounding_mode not lowered")
            return self.binary(_ELEMENTWISE[target], args[0], args[1], dtype, shape)
        if target in _COMPARISONS:
            a, b = args[0], args[1]
            ops = [x.dtype for x in (a, b) if isinstance(x, _Val)]
            common = torch.promote_types(*ops) if len(ops) == 2 else ops[0]
            return self.binary(_COMPARISONS[target], a, b, common, shape, torch.bool)
        if target in _UNARY:
            return self.emit(_UNARY[target], [args[0]], shape, dtype)
        if target == "aten.relu.default":
            return self.binary("max", args[0], 0, dtype, shape)
        if target == "aten.where.self":
            cond, t, f = args
            cases = []
            for x in (f, t):  # select_n(pred, on_false, on_true)
                x = self.at(x, dtype)
                if x.shape != shape:
                    n = len(shape) - len(x.shape)
                    x = self.broadcast(x, shape, range(n, len(shape)))
                cases.append(x)
            if cond.shape != shape:
                cond = self.broadcast(cond, shape, range(len(shape) - len(cond.shape),
                                                         len(shape)))
            return self.emit("select_n", [cond, *cases], shape, dtype)
        if target == "aten._to_copy.default":
            return self.at(args[0], kwargs.get("dtype") or args[0].dtype)
        if target in _RESHAPES:
            return self.reshape(args[0], shape)
        if target == "aten.permute.default":
            rank = len(args[0].shape)
            return self.emit("transpose", [args[0]], shape, dtype,
                             permutation=[int(d) % rank for d in args[1]])
        if target == "aten.expand.default":
            x = args[0]
            if x.shape == shape:
                return x
            return self.broadcast(x, shape, range(len(shape) - len(x.shape), len(shape)))
        if target in ("aten.full.default", "aten.full_like.default",
                      "aten.scalar_tensor.default"):
            fill = args[0] if target == "aten.scalar_tensor.default" else args[1]
            lit = self.literal(fill, dtype)
            return lit if not shape else self.broadcast(lit, shape, ())
        if target == "aten.mm.default":
            a, b = (self.at(x, dtype) for x in args)
            return self.emit("dot_general", [a, b], shape, dtype,
                             dimension_numbers=[[[1], [0]], [[], []]], precision=None,
                             preferred_element_type=dtype, out_sharding=None)
        if target in ("aten.sum.dim_IntList", "aten.sum.default",
                      "aten.mean.default", "aten.mean.dim"):
            if kwargs.get("dtype") is not None:
                raise PlanTranslationError(f"{target}: dtype= not lowered")
            x = args[0]
            dims = args[1] if len(args) > 1 and args[1] else range(len(x.shape))
            keepdim = bool(args[2]) if len(args) > 2 else bool(kwargs.get("keepdim", False))
            total = self.reduce("reduce_sum", x, dims)
            if target.startswith("aten.mean"):
                count = math.prod(x.shape) // max(math.prod(total.shape), 1)
                total = self.binary("div", total, float(count), total.dtype, total.shape)
            return self.reshape(total, shape) if keepdim else total
        if target == "aten.argmax.default":
            x = args[0]
            dim = args[1] if len(args) > 1 else kwargs.get("dim")
            if dim is None:
                x, dim = self.reshape(x, (math.prod(x.shape),)), 0
            dim = int(dim) % max(len(x.shape), 1)
            red = tuple(s for i, s in enumerate(x.shape) if i != dim)
            idx = self.emit("argmax", [x], red, torch.int32, axes=[dim],
                            index_dtype=torch.int32)
            return self.reshape(idx, shape)
        if target == "aten._log_softmax.default":
            return self.log_softmax(args[0], int(args[1]))
        if target == "aten.convolution.default":
            return self.convolution(out, *args)
        if target == "aten.convolution_backward.default":
            return self.convolution_backward(out, *args)
        if target == "aten.max_pool2d_with_indices.default":
            x = args[0]
            p = self.pool_params(x, *args[1:])
            val = self.emit("reduce_window_max", [x], out[0].shape, x.dtype,
                            base_dilation=[1] * len(x.shape), **p)
            return (val, _POOL_INDICES)
        if target == _POOL_BACKWARD:
            grad, x = args[0], args[1]
            p = self.pool_params(x, *args[2:7])
            if any(d != 1 for d in p.pop("window_dilation")):
                raise PlanTranslationError(f"{target}: dilation has no select_and_scatter_add")
            return self.emit("select_and_scatter_add", [grad, x], x.shape, grad.dtype,
                             select_prim={"__repr__": "ge"}, **p)
        raise PlanTranslationError(f"op {target} has no lowering to the op-list dialect")

    def log_softmax(self, x: _Val, dim: int) -> _Val:
        """``jax.nn.log_softmax``: shifted = x - max(x); shifted -
        log(sum(exp(shifted)))."""
        rank = len(x.shape)
        dim %= rank
        kept = [i for i in range(rank) if i != dim]
        keep_shape = tuple(1 if i == dim else s for i, s in enumerate(x.shape))
        m = self.broadcast(self.reduce("reduce_max", x, [dim]), keep_shape, kept)
        shifted = self.emit("sub", [x, m], x.shape, x.dtype)
        e = self.emit("exp", [shifted], x.shape, x.dtype)
        s = self.reduce("reduce_sum", e, [dim])
        lse = self.broadcast(self.emit("log", [s], s.shape, s.dtype), keep_shape, kept)
        return self.emit("sub", [shifted, lse], x.shape, x.dtype)

    def convolution(self, out, x, w, bias, stride, padding, dilation, transposed,
                    output_padding, groups):
        if transposed or groups != 1:
            raise PlanTranslationError(
                "aten.convolution: only groups=1 non-transposed convolutions are lowered")
        nsp = len(x.shape) - 2
        spec = list(range(nsp + 2))
        y = self.conv(x, w, out.shape, out.dtype, strides=_pair(stride, nsp),
                      padding=[[p, p] for p in _pair(padding, nsp)],
                      lhs_dilation=[1] * nsp, rhs_dilation=_pair(dilation, nsp),
                      dnums=[spec, spec, spec])
        if bias is None:
            return y
        b = self.broadcast(bias, (1, bias.shape[0]) + (1,) * nsp, [1])
        return self.emit("add", [y, b], y.shape, y.dtype)

    def convolution_backward(self, out, g, x, w, bias_sizes, stride, padding, dilation,
                             transposed, output_padding, groups, output_mask):
        """The three gradients of an NCHW/OIHW convolution as JAX's conv
        transpose rules emit them; entries ``output_mask`` leaves out are
        not emitted."""
        if transposed or groups != 1:
            raise PlanTranslationError(
                "aten.convolution_backward: only groups=1 non-transposed convolutions "
                "are lowered")
        nsp = len(x.shape) - 2
        s, p, d = _pair(stride, nsp), _pair(padding, nsp), _pair(dilation, nsp)
        k = w.shape[2:]
        n_in, n_out = x.shape[2:], g.shape[2:]
        spec = list(range(nsp + 2))
        swap = [1, 0] + spec[2:]
        grads = [None, None, None]
        if output_mask[0]:
            rev = self.emit("rev", [w], w.shape, w.dtype, dimensions=spec[2:])
            pads = []
            for i in range(nsp):
                lo = d[i] * (k[i] - 1) - p[i]
                pads.append([lo, n_in[i] + d[i] * (k[i] - 1) - 1 - (n_out[i] - 1) * s[i] - lo])
            grads[0] = self.conv(g, rev, x.shape, g.dtype, strides=[1] * nsp, padding=pads,
                                 lhs_dilation=s, rhs_dilation=d, dnums=[spec, swap, spec])
        if output_mask[1]:
            pads = [[p[i], (n_out[i] - 1) * s[i] + 1 - n_in[i] + d[i] * (k[i] - 1) - p[i]]
                    for i in range(nsp)]
            grads[1] = self.conv(x, g, w.shape, g.dtype, strides=d, padding=pads,
                                 lhs_dilation=[1] * nsp, rhs_dilation=s,
                                 dnums=[swap, swap, swap])
        if output_mask[2]:
            grads[2] = self.reduce("reduce_sum", g, [0] + spec[2:])
        return tuple(grads)

    @staticmethod
    def pool_params(x: _Val, kernel, stride=(), padding=0, dilation=1, ceil_mode=False):
        if ceil_mode:
            raise PlanTranslationError("max_pool2d: ceil_mode is not lowered")
        lead = len(x.shape) - 2
        k = _pair(kernel, 2)
        s = _pair(stride, 2) if stride else k
        p = _pair(padding, 2)
        return {
            "window_dimensions": [1] * lead + k,
            "window_strides": [1] * lead + s,
            "padding": [[0, 0]] * lead + [[q, q] for q in p],
            "window_dilation": [1] * lead + _pair(dilation, 2),
        }


def fx_to_oplist(exported_program) -> dict:
    """Walk a ``torch.export`` program (after ``run_decompositions()``)
    into the portable op-list dialect: ``{"constvars", "consts", "invars",
    "eqns", "outvars"}`` with integer SSA ids, as ``jaxpr_to_oplist``
    writes it for a jaxpr. Lifted tensor constants, parameters and buffers
    become ``consts``. An ATen op with no lowering raises
    :class:`PlanTranslationError` naming it."""
    from torch.export.graph_signature import InputKind, OutputKind

    ep = exported_program
    sig = ep.graph_signature
    low = _FxLowering()
    placeholders = {n.name: n for n in ep.graph.nodes if n.op == "placeholder"}
    vals: dict[Any, Any] = {}
    constvars, consts, invars = [], [], []

    def bind(spec):
        node = placeholders[spec.arg.name]
        meta = node.meta.get("val")
        if not isinstance(meta, torch.Tensor):
            raise PlanTranslationError(f"plan input {node.name} is not a tensor")
        vid = low.fresh()
        vals[node] = _Val({"var": vid}, meta.shape, meta.dtype)
        return vid

    for spec in sig.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            continue
        if spec.kind not in (InputKind.PARAMETER, InputKind.BUFFER, InputKind.CONSTANT_TENSOR):
            raise PlanTranslationError(f"exported input kind {spec.kind} is not lowered")
        value = (ep.constants[spec.target] if spec.kind == InputKind.CONSTANT_TENSOR
                 else ep.state_dict[spec.target])
        constvars.append(bind(spec))
        consts.append(value.detach().cpu().numpy())
    for spec in sig.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            invars.append(bind(spec))
    if any(spec.kind != OutputKind.USER_OUTPUT for spec in sig.output_specs):
        raise PlanTranslationError("an exported program that mutates its inputs is not lowered")

    def resolve_arg(a):
        if isinstance(a, torch.fx.Node):
            return vals[a]
        if isinstance(a, (list, tuple)):
            return type(a)(resolve_arg(x) for x in a)
        return a

    outvars: list = []
    for node in ep.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "output":
            outs = resolve_arg(node.args[0])
            for v in outs if isinstance(outs, (list, tuple)) else [outs]:
                if not isinstance(v, _Val):
                    raise PlanTranslationError(f"plan output {v!r} has no op-list value")
                outvars.append(v.ref)
            continue
        if node.op != "call_function":
            raise PlanTranslationError(f"graph node {node.op} {node.target} is not lowered")
        args, kwargs = resolve_arg(node.args), resolve_arg(node.kwargs)
        target = str(node.target)
        if target == "<built-in function getitem>":
            val = args[0][args[1]]
            if val is None:
                raise PlanTranslationError(f"{node.name} reads an output that was not computed")
            vals[node] = val
            continue
        if target != _POOL_BACKWARD and any(
                a is _POOL_INDICES for a in list(args) + list(kwargs.values())):
            raise PlanTranslationError(
                f"{target} reads max_pool2d_with_indices' indices, which have no "
                "op-list value")
        vals[node] = low.node(target, args, kwargs, node.meta.get("val"))
    return {"constvars": constvars, "consts": consts, "invars": invars,
            "eqns": low.eqns, "outvars": outvars}


# --- variant registry -------------------------------------------------------


class PlanTranslatorDefault:
    variant = "list"

    @staticmethod
    def translate(plan) -> Any:
        if plan.oplist is None:
            raise PlanTranslationError("plan has no oplist (not built?)")
        return plan.oplist


class PlanTranslatorXla:
    """The compiled artifact: a JAX-built plan's ``jax.export`` bytes, or
    a port-built plan's ``torch.export`` program (its ``torch_blob``)."""

    variant = "xla"

    @staticmethod
    def translate(plan) -> Any:
        blob = plan.exported_blob
        if blob is None:
            blob = getattr(plan, "torch_blob", None)
        if blob is None:
            raise PlanTranslationError("plan has no exported XLA artifact")
        return blob


class PlanTranslatorPortable:
    variant = "code"

    @staticmethod
    def translate(plan) -> Any:
        return plan.code


PLAN_VARIANTS = {
    t.variant: t
    for t in (PlanTranslatorDefault, PlanTranslatorXla, PlanTranslatorPortable)
}
# wire-compat aliases for syft.js-era clients (reference routes accept
# receive_operations_as ∈ {list, torchscript, tfjs} — routes.py:228-233)
PLAN_VARIANT_ALIASES = {"torchscript": "xla", "tfjs": "code", "list": "list"}


def translate_plan(plan, variant: str) -> Any:
    variant = PLAN_VARIANT_ALIASES.get(variant, variant)
    translator = PLAN_VARIANTS.get(variant)
    if translator is None:
        raise PlanTranslationError(f"unknown plan variant {variant!r}")
    return translator.translate(plan)
