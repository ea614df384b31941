"""Models of the port.

- The JAX package's three families: the MNIST MLP (``mlp``), the MNIST CNN
  (``cnn``) and the decoder-only transformer (``transformer``, GPT-2's
  block, with its KV-cache decode and serving passes in ``decode``).
- The DeepSeek-V3 decoder (``deepseek_v3``, Moonlight-16B-A3B's block:
  multi-head latent attention and the routed and shared experts of
  ``moe``), which has no counterpart in the JAX package.
- What both decoders share between their last hidden state and their loss
  (``lm``): the compute-dtype policy, the f32 logits, the padded CE head,
  the loss and the SGD step.

``REGISTRY`` maps each of the JAX package's family names to its module
(``init``, ``apply``, ``training_step``), as :mod:`pygrid_tpu.models`
does."""

from pygrid_tpu_torch.models import cnn, decode, mlp, transformer  # noqa: F401

#: model family registry (name -> module with init/apply/training_step)
REGISTRY = {"mlp": mlp, "cnn": cnn, "transformer": transformer}
