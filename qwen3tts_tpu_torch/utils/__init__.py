"""Utilities of the port: kernel-level tracing."""
