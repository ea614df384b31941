"""Worker-admission policy for cycle join requests.

Parity surface: reference ``routes/model_centric/routes.py:287-468``
(``fl_cycle_application_decision`` — the ``/req-join`` mockup). The
reference hard-codes its inputs ("MVP variable stubs") and solves the
Poisson admission rate with ``scipy.stats.poisson`` + a bisect loop; here
the same policy reads real process/cycle state, and the Poisson survival
function is closed-form (``math.lgamma`` log-pmf sum) so there is no scipy
dependency.

Policy, identical in structure to the reference:

- eligibility gates: upload/download speed minima, worker-reuse window
  (``do_not_reuse_workers_until_cycle``), cycle not past ``num_cycles``,
  enough cycle time left, not already in the cycle;
- ``pool_selection == "iterate"``: first-come-first-served up to
  ``max_workers × (1 + EXPECTED_FAILURE_RATE)`` (over-admission padding
  for workers that never report);
- ``pool_selection == "random"``: admit with probability
  ``λ_approx / λ_actual`` where ``λ_approx`` is the smallest Poisson rate
  whose P(K ≥ k′) reaches the confidence target for the
  failure-adjusted worker quota k′.

The port's copy of :mod:`pygrid_tpu.federated.selection`, with the port's imports.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass

#: historical fraction of admitted workers that never report a diff
#: (reference :314)
EXPECTED_FAILURE_RATE = 0.2
#: don't hand out work with less than this many seconds left (reference :311)
MINIMUM_CYCLE_TIME_LEFT = 500.0
#: P(K >= k') target when solving for the admission rate (reference :389)
CONFIDENCE = 0.95


def poisson_sf(k: float, lam: float) -> float:
    """P(K > k) for K ~ Poisson(lam) — scipy-free ``poisson.sf``.

    Sums the pmf up to ``floor(k)`` in log space; k' here is O(max_workers)
    so the direct sum is exact and fast."""
    if lam <= 0:
        return 0.0
    cdf = 0.0
    for i in range(int(math.floor(k)) + 1):
        cdf += math.exp(i * math.log(lam) - lam - math.lgamma(i + 1))
    return max(0.0, 1.0 - cdf)


def solve_admission_rate(
    k_prime: float, confidence: float = CONFIDENCE
) -> int:
    """Smallest integer rate λ with P(K ≥ k′) ≈ confidence.

    The reference bisects ``scipy.poisson.sf`` over ``range(3·k′)``
    (:403-430); the sf is monotone in λ, so plain bisection on the same
    integer grid gives the identical answer without the unstable
    tolerance-window early-exit."""
    lo, hi = 0, max(1, int(3 * k_prime))
    while lo < hi:
        mid = (lo + hi) // 2
        if poisson_sf(k_prime, float(mid)) >= confidence:
            hi = mid
        else:
            lo = mid + 1
    return lo


@dataclass
class AdmissionDecision:
    accepted: bool
    reason: str


def eligibility_reason(
    *,
    server_config: dict,
    cycle_sequence: int,
    already_in_cycle: bool,
    last_participation: int,
    up_speed: float,
    down_speed: float,
) -> str | None:
    """The gates shared by every admission path — WS cycle-request
    (``controller.assign``) and HTTP ``/req-join`` — so the two protocols
    cannot drift. Returns a reject reason, or None when eligible."""
    min_up = float(server_config.get("minimum_upload_speed", 0) or 0)
    min_down = float(server_config.get("minimum_download_speed", 0) or 0)
    if up_speed < min_up or down_speed < min_down:
        return "bandwidth below minimum"
    reuse_after = int(
        server_config.get("do_not_reuse_workers_until_cycle", 0) or 0
    )
    if last_participation and last_participation + reuse_after > cycle_sequence:
        return "inside worker-reuse window"
    if already_in_cycle:
        return "already assigned this cycle"
    return None


def should_admit(
    *,
    server_config: dict,
    cycle_sequence: int,
    cycle_time_left: float | None,
    workers_in_cycle: int,
    already_in_cycle: bool,
    last_participation: int,
    up_speed: float,
    down_speed: float,
    request_rate: float = 5.0,
    rng: random.Random | None = None,
) -> AdmissionDecision:
    """One join decision (reference :329-450).

    ``request_rate`` is the observed worker-join rate per unit time — the
    reference's ``normalized_lambda_actual`` (hard-coded 5 there, injectable
    here). ``cycle_time_left`` of None means the cycle has no deadline."""
    rng = rng or random
    reject = eligibility_reason(
        server_config=server_config,
        cycle_sequence=cycle_sequence,
        already_in_cycle=already_in_cycle,
        last_participation=last_participation,
        up_speed=up_speed,
        down_speed=down_speed,
    )
    if reject is not None:
        return AdmissionDecision(False, reject)
    num_cycles = server_config.get("num_cycles")
    if num_cycles and cycle_sequence > int(num_cycles):
        return AdmissionDecision(False, "process cycles exhausted")
    if cycle_time_left is not None and cycle_time_left < MINIMUM_CYCLE_TIME_LEFT:
        return AdmissionDecision(False, "cycle nearly over")

    max_workers = float(server_config.get("max_workers", 100) or 100)
    k_prime = max_workers * (1 + EXPECTED_FAILURE_RATE)
    pool = server_config.get("pool_selection", "random")

    if pool == "iterate":
        if workers_in_cycle < k_prime:
            return AdmissionDecision(True, "fcfs slot available")
        return AdmissionDecision(False, "fcfs pool full")

    # "random": Poisson-rate admission
    t_left = cycle_time_left if cycle_time_left is not None else 3600.0
    lambda_actual = request_rate * max(t_left, 1.0)
    lambda_approx = solve_admission_rate(k_prime)
    if lambda_actual <= lambda_approx:
        return AdmissionDecision(True, "expected worker shortage")
    admit_prob = lambda_approx / lambda_actual
    if rng.random() < admit_prob:
        return AdmissionDecision(True, "won admission lottery")
    return AdmissionDecision(False, "lost admission lottery")
