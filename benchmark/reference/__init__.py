"""Plain PyTorch and NumPy references. Nothing here imports ``jax``, the
JAX package or ``pygrid_tpu_torch``, and nothing here takes a value that
the program made: the harness hands both sides the inputs it drew."""
