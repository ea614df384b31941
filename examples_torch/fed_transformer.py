"""Federated transformer training on the card — the flagship composition.

The port's twin of ``examples/fed_transformer.py``: K simulated clients
each run local SGD on a decoder-only transformer, with the port's flash
attention inside every client step, and FedAvg aggregates the diffs, the
final step's weight gradients folded into one matmul per layer
(``parallel.make_fused_rounds`` over ``models.transformer``). On the card
the rounds run in bf16 with the bf16 cross-entropy backward, and every
attention launches the hand-written kernels of
``pygrid_tpu_torch/csrc/flash_fwd.cu`` and ``flash_bwd.cu`` (forward, dK/dV
and dQ); on the CPU (``--device cpu``) the same calls take their plain
PyTorch versions, in f32 as the reference runs there. The trained params
then serve greedy decoding (``models.decode.generate``).

The parameters are drawn as the reference draws them
(``jax.random.PRNGKey(0)``, through ``pygrid_tpu_torch.utils.prng``). The
task is tiny on purpose (copy-class sequences): the point is the
composition converging, not the corpus.

    python examples_torch/fed_transformer.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout

import numpy as np

K, B, L = 4, 4, 32          # clients × per-client batch × sequence length
ROUNDS = 30


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)

    import torch

    from pygrid_tpu_torch.device import resolve
    from pygrid_tpu_torch.models import decode, transformer
    from pygrid_tpu_torch.parallel import make_fused_rounds
    from pygrid_tpu_torch.parallel.flash_attention import flash_attention
    from pygrid_tpu_torch.utils import prng

    device = resolve(args.device)
    on_cpu = device.type == "cpu"
    cfg = transformer.TransformerConfig(
        vocab=32, d_model=32, n_heads=4, n_layers=2, d_ff=64, max_len=L
    )
    loss_fn = partial(
        transformer.loss_and_acc,
        cfg=cfg,
        attn_fn=flash_attention,
        # mixed precision and the bf16 CE backward on the card's tensor
        # cores; on the CPU they would only slow the plain versions down
        compute_dtype=None if on_cpu else "bfloat16",
        ce_grad_dtype=None if on_cpu else "bfloat16",
    )

    # task: one base corpus, each client holding ITS OWN token shift of
    # it — non-iid shards whose next-token rule is learnable only jointly
    rng = np.random.default_rng(0)
    corpus = rng.integers(0, cfg.vocab, (B, L + 1))
    base = (corpus[None] + np.arange(K)[:, None, None]) % cfg.vocab
    X = torch.from_numpy(base[..., :-1]).to(device)
    y = torch.from_numpy(base[..., 1:]).to(device)

    params = transformer.init_from_key(prng.PRNGKey(0, device="cpu"), cfg, device=device)
    rounds = make_fused_rounds(loss_fn, n_rounds=ROUNDS)
    final, losses, accs = rounds(params, X, y, 0.3)
    first, last = float(losses[0]), float(losses[-1])
    print(
        f"federated transformer: {K} clients × {ROUNDS} rounds "
        f"(flash attention, {'plain versions on the cpu' if on_cpu else 'bf16 on the card'}) — "
        f"loss {first:.3f} → {last:.3f}, acc {float(accs[-1]):.2f}"
    )
    if not last < first - 0.3:
        print("loss did not improve", file=sys.stderr)
        return 1

    # serve what you trained: KV-cache greedy decoding from the
    # federated params (over a grid this same call runs on a node through
    # client.run_remote_generation)
    prompt = X[0, :1, :8]  # first 8 tokens of client 0's shard
    toks = decode.generate(final, prompt, 12, cfg)
    print(
        f"generated continuation of {prompt[0].tolist()}: "
        f"{toks[0].tolist()}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
