"""Byzantine-robust aggregation — coordinate-wise median and trimmed
mean (Yin et al., "Byzantine-Robust Distributed Learning: Towards
Optimal Statistical Rates", ICML '18).

No reference analog: the reference's only aggregator is the plain mean
(cycle_manager.py:275-290), where a single malicious worker shifting one
coordinate by M moves the aggregate by M/K — unbounded. Median tolerates
up to ⌈K/2⌉−1 arbitrary reports per coordinate; trimmed mean tolerates
⌈βK⌉ per tail while keeping more statistical efficiency than the median
under honest noise.

Configured per process: ``server_config["robust_aggregation"] =
{"name": "median"}`` or ``{"name": "trimmed_mean", "trim_fraction": β}``
(β ∈ [0, 0.5); each coordinate drops its ⌈βK⌉ largest and smallest
values before averaging).

These estimators need every diff at once, so robust processes skip the
streaming accumulator and aggregate from the stored rows at completion —
O(K) memory at flush time is the price of order statistics.

The port's copy of :mod:`pygrid_tpu.federated.robust`, with the port's imports.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from pygrid_tpu_torch.utils.exceptions import PyGridError


def coordinate_median(diffs: Sequence[Sequence[np.ndarray]]) -> list[np.ndarray]:
    """Element-wise median over K diff lists (each a list of tensors)."""
    if not diffs:
        raise PyGridError("no diffs to aggregate")
    out = []
    for tensors in zip(*diffs):
        stacked = np.stack([np.asarray(t, dtype=np.float64) for t in tensors])
        out.append(np.median(stacked, axis=0).astype(np.float32))
    return out


def trimmed_mean(
    diffs: Sequence[Sequence[np.ndarray]], trim_fraction: float
) -> list[np.ndarray]:
    """Per coordinate: sort the K values, drop ⌈βK⌉ from each tail,
    average the rest. β=0 is the plain mean; β→0.5 approaches the
    median. Requires K > 2·⌈βK⌉ (something must survive the trim)."""
    if not diffs:
        raise PyGridError("no diffs to aggregate")
    if not 0.0 <= trim_fraction < 0.5:
        raise PyGridError(
            f"trim_fraction must be in [0, 0.5), got {trim_fraction}"
        )
    k = len(diffs)
    cut = math.ceil(trim_fraction * k)
    if k - 2 * cut < 1:
        raise PyGridError(
            f"trimmed_mean with {k} diffs and trim_fraction="
            f"{trim_fraction} trims everything"
        )
    out = []
    for tensors in zip(*diffs):
        stacked = np.sort(
            np.stack([np.asarray(t, dtype=np.float64) for t in tensors]),
            axis=0,
        )
        kept = stacked[cut : k - cut] if cut else stacked
        out.append(kept.mean(axis=0).astype(np.float32))
    return out


def robust_aggregate(
    diffs: Sequence[Sequence[np.ndarray]], config: dict
) -> list[np.ndarray]:
    """Dispatch on ``config["name"]`` (validated at host time). If a
    trimmed mean is impossible at the diff count that actually arrived
    (host validation bounds it against min_diffs, but ceil interactions
    at other counts are not monotone), degrade to the median rather than
    raise — an exception here would leave the cycle permanently open."""
    name = config.get("name")
    if name == "median":
        return coordinate_median(diffs)
    if name == "trimmed_mean":
        trim = float(config.get("trim_fraction", 0.1))
        if len(diffs) - 2 * math.ceil(trim * len(diffs)) < 1:
            return coordinate_median(diffs)
        return trimmed_mean(diffs, trim)
    raise PyGridError(f"unknown robust_aggregation {name!r}")


def validate_config(server_config: dict) -> None:
    """Host-time validation (controller.create_process)."""
    cfg = server_config.get("robust_aggregation")
    if cfg is None:
        return
    if not isinstance(cfg, dict):
        raise PyGridError(
            "robust_aggregation must be a dict {name, ...}"
        )
    name = cfg.get("name")
    if name not in ("median", "trimmed_mean"):
        raise PyGridError(
            "robust_aggregation name must be 'median' or 'trimmed_mean'"
        )
    if name == "trimmed_mean":
        trim = cfg.get("trim_fraction", 0.1)
        if not isinstance(trim, (int, float)) or not 0.0 <= trim < 0.5:
            raise PyGridError("trim_fraction must be in [0, 0.5)")
        # a cycle can complete with as few as min_diffs reports — the trim
        # must leave at least one value at that count, or every completion
        # attempt would raise and wedge the cycle (the completion path
        # also degrades to the median as a backstop, but a config that
        # can never run as written should fail at host time)
        min_diffs = server_config.get("min_diffs")
        if min_diffs is None:
            raise PyGridError(
                "trimmed_mean requires min_diffs (without it a single "
                "report completes the cycle and the trim has nothing left)"
            )
        if int(min_diffs) - 2 * math.ceil(trim * int(min_diffs)) < 1:
            raise PyGridError(
                f"trimmed_mean with trim_fraction={trim} trims everything "
                f"at min_diffs={min_diffs}"
            )
    for incompatible, why in (
        ("differential_privacy",
         "noise is calibrated to the mean's C/K sensitivity; order "
         "statistics have a different sensitivity"),
        ("secure_aggregation",
         "order statistics need individually visible reports, which "
         "secure aggregation exists to prevent"),
        ("async_aggregation",
         "the FedBuff buffer pre-reduces reports; order statistics need "
         "them separate"),
    ):
        if server_config.get(incompatible) is not None:
            raise PyGridError(
                f"robust_aggregation cannot be combined with "
                f"{incompatible} ({why})"
            )
