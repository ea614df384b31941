"""The one generator of every traffic mix: ``traffic/<mix>.json`` holds the
parameters, and each batch is drawn on the device from the run's seed and
the batch's index, so the same seed gives the same inputs.

Kinds:

- ``tokens``: ``clients`` × ``batch`` sequences of ``seq_len`` token ids,
  uniform over the configuration's vocabulary; the targets are the next
  tokens (``seq_len + 1`` drawn per sequence).
- ``features``: ``clients`` × ``batch`` rows of the configuration's input
  width, ``x`` ``"normal"`` (standard normal) or ``"uniform01"``; with
  ``labels`` ``"onehot"``, one-hot targets uniform over the output width.
  Without ``clients`` a batch is one request's ``[batch, width]``.
"""

from __future__ import annotations

import torch

from benchmark.harness import BenchError, sub_seed


def _gen(seed: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, "traffic", index))


def batch(traffic: dict, config: dict, seed: int, index: int, device):
    """Batch ``index`` of the mix: ``(X, y)``, or ``x`` alone for a request."""
    g = _gen(seed, index, device)
    kind = traffic["kind"]
    if kind == "tokens":
        K, B, L = traffic["clients"], traffic["batch"], traffic["seq_len"]
        t = torch.randint(0, config["port"]["vocab"], (K, B, L + 1), generator=g, device=device)
        return t[..., :-1].contiguous(), t[..., 1:].contiguous()
    if kind == "features":
        sizes = config["sizes"]
        lead = ((traffic["clients"],) if "clients" in traffic else ()) + (traffic["batch"],)
        if traffic["x"] == "normal":
            x = torch.randn(lead + (sizes[0],), generator=g, device=device)
        elif traffic["x"] == "uniform01":
            x = torch.rand(lead + (sizes[0],), generator=g, device=device)
        else:
            raise BenchError(f"unknown input distribution {traffic['x']!r}")
        if traffic.get("labels") != "onehot":
            return x
        labels = torch.randint(0, sizes[-1], lead, generator=g, device=device)
        return x, torch.nn.functional.one_hot(labels, sizes[-1]).float()
    raise BenchError(f"unknown traffic kind {kind!r}")


def tokens_per_batch(traffic: dict) -> int:
    """Tokens (or rows) one batch of the mix carries."""
    n = traffic.get("clients", 1) * traffic["batch"]
    return n * traffic.get("seq_len", 1)
