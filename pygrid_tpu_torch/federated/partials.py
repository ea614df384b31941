"""Partial (pre-aggregated) diff envelopes + the sub-aggregator fold.

The hierarchical report path: a sub-aggregator absorbs the reports of a
subtree of workers, folds them incrementally into ONE count-weighted
partial sum, and forwards a single ``model-centric/report-partial``
frame upstream — the node then folds K subtree partials instead of
K×fanout worker reports. No reference analog: the reference node ingests
every diff individually (``cycle_manager.py:151-178``).

Semantics are exact by construction: a partial carries the per-parameter
**sum** Σᵢ wᵢ·dᵢ (not the mean) plus ``count`` (leaf reports folded) and
``weight_sum`` (Σᵢ wᵢ; equals ``count`` when unweighted), so folds
associate — a tree of any shape produces the same totals as the flat
fold, and the root's single divide (``_DiffAccumulator.mean``) is the
same FedAvg mean. Partial sums travel as float64 (leaf diffs are f32 or
bf16 wire payloads; the f64 carry keeps integer-valued sums exact
through any tree depth). SecAgg composes because masked reports are
mod-2³² sums: a sub-aggregator adds masked uint32 vectors (wraparound
included) and the pairwise masks still cancel at the root's unmask
round — the tree never sees a plaintext diff.

Two wire shapes live here:

- the **report-partial event payload** fields (``workers``, ``count``,
  ``weight_sum``, ``diff``) — framed by ``worker/subagg.py`` and parsed
  by ``node/events.py``;
- the **durable envelope** (:func:`encode_partial_envelope`) the node
  stores in the first member's ``worker_cycles.diff`` row so the
  restart-recovery rebuild can re-fold the subtree with its original
  count and weight.

The port's copy of :mod:`pygrid_tpu.federated.partials`, with the port's imports.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from pygrid_tpu_torch.utils.exceptions import PyGridError

_MAGIC = "__pygrid_partial_diff__"

#: hard bound on one partial's leaf count — a hostile frame must not
#: claim an absurd divisor weight into the cycle mean
MAX_PARTIAL_COUNT = 1_000_000


def encode_partial_envelope(
    state_blob: bytes, count: int, weight_sum: float, masked: bool = False
) -> bytes:
    """The durable storage form: one msgpack map wrapping the partial's
    State (or masked-envelope) bytes with its fold bookkeeping."""
    from pygrid_tpu_torch.serde import serialize

    return serialize(
        {
            _MAGIC: True,
            "count": int(count),
            "weight_sum": float(weight_sum),
            "masked": bool(masked),
            "state": bytes(state_blob),
        }
    )


def decode_partial_envelope(
    blob: bytes,
) -> tuple[int, float, bool, bytes] | None:
    """``(count, weight_sum, masked, state_bytes)`` if ``blob`` is a
    partial envelope, else None (callers fall through to the plain-diff
    doors). Malformed bookkeeping in a recognized envelope raises typed —
    a stored envelope is server-written, so damage is worth surfacing."""
    from pygrid_tpu_torch.serde.packer import unpackb

    try:
        obj = unpackb(blob)
    except Exception:  # noqa: BLE001 — not msgpack → not an envelope
        return None
    if not (isinstance(obj, dict) and obj.get(_MAGIC) is True):
        return None
    try:
        count = int(obj["count"])
        weight_sum = float(obj["weight_sum"])
        state = obj["state"]
    except (KeyError, TypeError, ValueError) as err:
        raise PyGridError(f"malformed partial envelope: {err}") from err
    if not isinstance(state, (bytes, bytearray)):
        raise PyGridError("malformed partial envelope: state not bytes")
    if count < 1 or count > MAX_PARTIAL_COUNT:
        raise PyGridError(f"partial envelope count {count} out of range")
    return count, weight_sum, bool(obj.get("masked")), bytes(state)


def serialize_partial_sums(sums: Sequence[np.ndarray]) -> bytes:
    """A partial's wire payload: one dense State of float64 sum tensors
    (float64 so integer-valued leaf sums stay exact through the tree;
    one frame per subtree, so the 2× over f32 costs ~nothing vs the
    fanout× frames it replaces)."""
    from pygrid_tpu_torch.plans.state import serialize_model_params

    return serialize_model_params(
        [np.asarray(s, dtype=np.float64) for s in sums]
    )


class PartialFold:
    """The sub-aggregator's streaming fold: leaf report blobs (and
    downstream partials) accumulate straight from their wire buffers
    into float64 per-parameter sums — zero tensor copies, one
    report-sized residency regardless of subtree size.

    Plain and masked (SecAgg) reports are mutually exclusive per fold:
    a masked fold is a mod-2³² uint32 sum whose payload re-encodes as a
    masked envelope; mixing would silently corrupt both."""

    def __init__(self) -> None:
        self.count = 0
        self.weight_sum = 0.0
        self.sums: list[np.ndarray] | None = None
        self.masked: bool | None = None  # unknown until the first report
        #: (worker_id, request_key) of every leaf folded so far — the
        #: node validates each pair, so the tree adds no trust surface
        self.entries: list[tuple[str, str]] = []

    def _ensure_mode(self, masked: bool) -> None:
        if self.masked is None:
            self.masked = masked
        elif self.masked is not masked:
            raise PyGridError(
                "cannot mix masked and plain reports in one partial fold"
            )

    def add_report(
        self, worker_id: str, request_key: str, diff: bytes
    ) -> None:
        """Fold one leaf report (dense State — f32/bf16 — or a SecAgg
        masked envelope). Anything else (sparse envelopes, malformed
        bytes) bounces typed so the worker retries direct-to-node."""
        from pygrid_tpu_torch.federated import secagg
        from pygrid_tpu_torch.serde import state_raw_tensors

        if not diff:
            raise PyGridError("empty diff")
        raws = state_raw_tensors(diff)
        if raws is not None and all(
            rt.kind in ("<f4", "bf16") for rt in raws
        ):
            self._ensure_mode(False)
            self._fold_raws(raws, weight=1.0)
        else:
            # masked envelopes don't parse as a plain State; decode_
            # masked_diff owns the typed error for everything else
            masked = secagg.decode_masked_diff(bytes(diff))
            self._ensure_mode(True)
            self._fold_masked(masked)
        self.count += 1
        self.weight_sum += 1.0
        self.entries.append((str(worker_id), str(request_key)))

    def add_partial(
        self,
        entries: Sequence[tuple[str, str]],
        diff: bytes,
        count: int,
        weight_sum: float | None = None,
        masked: bool = False,
    ) -> None:
        """Fold a downstream sub-aggregator's partial (deeper trees):
        the count-weighted merge — sums add, counts add, weights add."""
        from pygrid_tpu_torch.serde import state_raw_tensors

        if count < 1:
            raise PyGridError("cannot fold a zero-count partial report")
        if len(entries) != count:
            raise PyGridError(
                f"partial carries {len(entries)} worker entries but "
                f"claims count {count}"
            )
        if masked:
            from pygrid_tpu_torch.federated import secagg

            self._ensure_mode(True)
            self._fold_masked(secagg.decode_masked_diff(bytes(diff)))
        else:
            raws = state_raw_tensors(diff)
            if raws is None or any(
                rt.kind not in ("<f4", "<f8", "bf16") for rt in raws
            ):
                raise PyGridError("partial diff is not a dense State")
            self._ensure_mode(False)
            self._fold_raws(raws, weight=1.0)
        self.count += int(count)
        self.weight_sum += float(
            weight_sum if weight_sum is not None else count
        )
        self.entries.extend((str(w), str(k)) for w, k in entries)

    def _fold_raws(self, raws, weight: float) -> None:
        from pygrid_tpu_torch.native import accum_bf16, accum_f32

        if self.sums is None:
            self.sums = [
                np.zeros(rt.shape, dtype=np.float64) for rt in raws
            ]
        if len(raws) != len(self.sums) or any(
            rt.shape != s.shape for rt, s in zip(raws, self.sums)
        ):
            raise PyGridError(
                "report tensor shapes do not match this fold's shapes"
            )
        for s, rt in zip(self.sums, raws):
            if rt.kind == "bf16":
                accum_bf16(s, rt.raw, weight)
            elif rt.kind == "<f8":
                flat = s.reshape(-1)
                src = np.frombuffer(rt.raw, dtype=np.float64)
                if weight == 1.0:
                    np.add(flat, src, out=flat)
                else:
                    flat += src * weight
            else:
                accum_f32(s, rt.raw, weight)

    def _fold_masked(self, masked: list[np.ndarray]) -> None:
        if self.sums is None:
            self.sums = [
                np.array(m, dtype=np.uint32, copy=True) for m in masked
            ]
            return
        if len(masked) != len(self.sums) or any(
            np.shape(m) != s.shape for m, s in zip(masked, self.sums)
        ):
            raise PyGridError(
                "masked report shapes do not match this fold's shapes"
            )
        for s, m in zip(self.sums, masked):
            np.add(s, m, out=s)  # uint32 wraparound = mod 2^32

    def to_report(self) -> tuple[bytes, int, float]:
        """``(diff_blob, count, weight_sum)`` for the upstream
        ``report-partial`` frame. Typed error on an empty fold — the
        zero-count partial contract holds at every tree level."""
        if self.sums is None or self.count < 1:
            raise PyGridError("cannot fold a zero-count partial report")
        if self.masked:
            from pygrid_tpu_torch.federated import secagg

            blob = secagg.encode_masked_diff(self.sums)
        else:
            blob = serialize_partial_sums(self.sums)
        return blob, self.count, self.weight_sum
