"""Server-side FL optimizers — FedOpt (Reddi et al., "Adaptive Federated
Optimization"): the node treats the averaged worker diff as a
pseudo-gradient and applies a stateful server update instead of the plain
``new = params − avg_diff`` the reference hardcodes
(``cycle_manager.py:295-298``). Beyond parity: the reference has no server
optimizer concept at all.

Configured per FL process::

    server_config["server_optimizer"] = {
        "name": "sgd" | "momentum" | "adam",   # fedavg / fedavgm / fedadam
        "lr": 1.0,                              # server learning rate
        # momentum: {"beta": 0.9}
        # adam:     {"beta1": 0.9, "beta2": 0.99, "eps": 1e-3}
    }

Implemented in pure numpy: the protocol plane's arrays arrive in host RAM
and are ~1 MB — the same reduce-where-the-data-lives doctrine as the diff
accumulator (cycle_manager.py). Optimizer state persists as a serde blob
per model (``S.ServerOptState``), so a restarted node resumes mid-process
with its momentum/second-moment estimates intact.

The port's copy of :mod:`pygrid_tpu.federated.server_opt`, with the port's imports.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from pygrid_tpu_torch.utils.exceptions import PyGridError


def apply_server_optimizer(
    params: Sequence[np.ndarray],
    avg_diff: Sequence[np.ndarray],
    opt_config: dict | None,
    state: dict | None,
) -> tuple[list[np.ndarray], dict | None]:
    """One server step: ``(params, avg_diff, state) -> (new_params, state)``.

    ``opt_config=None`` (or name "sgd" with lr 1.0) reproduces the
    reference's hardcoded FedAvg update exactly.
    """
    if not opt_config:
        return [np.asarray(p) - np.asarray(d) for p, d in zip(params, avg_diff)], None

    name = str(opt_config.get("name", "sgd")).lower()
    lr = float(opt_config.get("lr", 1.0))
    params = [np.asarray(p, dtype=np.float32) for p in params]
    grads = [np.asarray(d, dtype=np.float32) for d in avg_diff]

    if name == "sgd":
        return [p - lr * g for p, g in zip(params, grads)], None

    if name == "momentum":
        beta = float(opt_config.get("beta", 0.9))
        m = (
            [np.asarray(v) for v in state["m"]]
            if state
            else [np.zeros_like(g) for g in grads]
        )
        m = [beta * mi + gi for mi, gi in zip(m, grads)]
        new = [p - lr * mi for p, mi in zip(params, m)]
        return new, {"m": m}

    if name == "adam":
        beta1 = float(opt_config.get("beta1", 0.9))
        beta2 = float(opt_config.get("beta2", 0.99))
        # eps is FedAdam's adaptivity floor τ: added to sqrt(v), not inside
        # it (paper default 1e-3, much larger than training-Adam's 1e-8)
        eps = float(opt_config.get("eps", 1e-3))
        if state:
            m = [np.asarray(v) for v in state["m"]]
            v = [np.asarray(x) for x in state["v"]]
            t = int(state["t"])
        else:
            m = [np.zeros_like(g) for g in grads]
            v = [np.zeros_like(g) for g in grads]
            t = 0
        t += 1
        m = [beta1 * mi + (1 - beta1) * gi for mi, gi in zip(m, grads)]
        v = [beta2 * vi + (1 - beta2) * gi * gi for vi, gi in zip(v, grads)]
        m_hat = [mi / (1 - beta1**t) for mi in m]
        v_hat = [vi / (1 - beta2**t) for vi in v]
        new = [
            p - lr * mh / (np.sqrt(vh) + eps)
            for p, mh, vh in zip(params, m_hat, v_hat)
        ]
        return new, {"m": m, "v": v, "t": t}

    raise PyGridError(f"unknown server optimizer {name!r}")
