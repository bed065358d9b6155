"""Ops of the port: plain PyTorch functions and the kernel wrappers.

Importing the package registers the ``qwen3tts`` ops of ``library`` with
their implementations, which the kernel modules add when imported."""

from . import library  # noqa: F401
from . import decode_attention, fused_code_predictor, fused_talker_step  # noqa: F401
from . import fused_vocoder, int8_matmul  # noqa: F401
