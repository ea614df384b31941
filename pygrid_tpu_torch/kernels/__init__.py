"""Build and binding of the port's CUDA kernels (see :mod:`.build`)."""
