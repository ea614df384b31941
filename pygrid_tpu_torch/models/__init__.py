"""Models of the port: the three model families of the JAX package — the
MNIST MLP (``mlp``), the MNIST CNN (``cnn``) and the transformer
(``transformer``, with its KV-cache decode in ``decode``).

``REGISTRY`` maps each family's name to its module (``init``, ``apply``,
``training_step``), as :mod:`pygrid_tpu.models` does."""

from pygrid_tpu_torch.models import cnn, decode, mlp, transformer  # noqa: F401

#: model family registry (name -> module with init/apply/training_step)
REGISTRY = {"mlp": mlp, "cnn": cnn, "transformer": transformer}
