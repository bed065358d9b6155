"""Ops of the port: plain PyTorch functions and the kernel wrappers."""
