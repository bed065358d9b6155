"""Host text processing (a copy of the JAX package's JAX-free BPE tokenizer)."""
