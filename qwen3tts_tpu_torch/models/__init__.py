"""Models of the port (parameters as NamedTuples of tensors, JAX layouts)."""
