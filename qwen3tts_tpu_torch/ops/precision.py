"""Full float32 for the plain float32 stages on the card.

cuDNN's float32 convolution defaults to TF32 on Hopper
(``torch.backends.cudnn.allow_tf32``), which keeps 10 mantissa bits of each
operand; the XLA reference computes in float32. ``full_float32()`` turns
TF32 off for convolutions and matmuls for the duration of a call and
restores the caller's settings afterwards.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
