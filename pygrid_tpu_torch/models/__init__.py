"""Models of the port: the transformer and the MNIST MLP."""
