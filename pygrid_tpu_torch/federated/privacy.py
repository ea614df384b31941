"""Differential privacy for federated aggregation — DP-FedAvg (McMahan et
al., "Learning Differentially Private Recurrent Language Models"). No
reference analog: the reference aggregates raw diffs.

Per process: ``server_config["differential_privacy"] = {
    "clip_norm": C,          # per-client L2 bound over the whole diff
    "noise_multiplier": z,   # z = σ/C; (ε, δ) follows from z, K, rounds
}``

Mechanics (server-side, on the protocol plane's host-resident arrays):

- every client's diff is **clipped** to global L2 norm ≤ C at ingest —
  before it touches the running sum, so the accumulator only ever holds
  bounded contributions;
- after averaging, Gaussian noise **N(0, (z·C/K)²)** is added to every
  coordinate of the mean (σ scales 1/K because the sensitivity of the
  *mean* to one client is C/K).

Noise draws use OS entropy (``numpy.random.default_rng()`` fresh per
cycle) — a seeded/replayable stream would void the privacy guarantee.

The port's copy of :mod:`pygrid_tpu.federated.privacy`, with the port's imports.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from pygrid_tpu_torch.utils.exceptions import PyGridError


def global_l2_norm(diff: Sequence[np.ndarray]) -> float:
    return math.sqrt(
        sum(float(np.sum(np.square(np.asarray(t, dtype=np.float64)))) for t in diff)
    )


def clip_diff(
    diff: Sequence[np.ndarray], clip_norm: float
) -> list[np.ndarray]:
    """Scale the whole diff so its global L2 norm is ≤ ``clip_norm``
    (norm-preserving direction, never amplifies)."""
    if clip_norm <= 0:
        raise PyGridError(f"clip_norm must be positive, got {clip_norm}")
    norm = global_l2_norm(diff)
    scale = min(1.0, clip_norm / max(norm, 1e-12))
    if scale >= 1.0:
        return [np.asarray(t, dtype=np.float32) for t in diff]
    return [(np.asarray(t, dtype=np.float32) * np.float32(scale)) for t in diff]


def local_dp_noise(
    diff: Sequence[np.ndarray],
    clip_norm: float,
    noise_multiplier: float,
) -> list[np.ndarray]:
    """CLIENT-side DP (local/distributed DP): clip the own diff to
    L2 ≤ C and add N(0, (z·C)²) per coordinate BEFORE it leaves the
    device. Unlike server-side DP-FedAvg (which the node applies and
    SecAgg therefore forbids — the node never sees individuals), local
    noise composes with secure aggregation: each client's report is
    already private on its own, and the masked sum the server learns
    carries the aggregate noise. σ is z·C (not z·C/K): the client
    protects itself without trusting the server to noise anything.
    Post-processing invariance means compression after this is safe."""
    clipped = clip_diff(diff, clip_norm)
    if noise_multiplier < 0:
        raise PyGridError("noise_multiplier must be >= 0")
    if noise_multiplier == 0:
        return clipped
    sigma = noise_multiplier * clip_norm
    rng = np.random.default_rng()  # OS entropy — never seeded
    return [
        t + rng.normal(0.0, sigma, size=t.shape).astype(np.float32)
        for t in clipped
    ]


def add_gaussian_noise(
    avg_diff: Sequence[np.ndarray],
    clip_norm: float,
    noise_multiplier: float,
    n_clients: int,
) -> list[np.ndarray]:
    """Noise the averaged (clipped) diff: σ = z·C/K per coordinate."""
    if noise_multiplier < 0:
        raise PyGridError("noise_multiplier must be >= 0")
    if n_clients <= 0:
        raise PyGridError("n_clients must be positive")
    if noise_multiplier == 0:
        return [np.asarray(t, dtype=np.float32) for t in avg_diff]
    sigma = noise_multiplier * clip_norm / n_clients
    rng = np.random.default_rng()  # OS entropy — never seeded
    return [
        np.asarray(t, dtype=np.float32)
        + rng.normal(0.0, sigma, size=np.shape(t)).astype(np.float32)
        for t in avg_diff
    ]
