"""Checkpoint readers and loaders of the port, and the weight seam from the
JAX package (``from_jax``)."""
