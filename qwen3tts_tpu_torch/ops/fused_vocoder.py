"""K3: one residual block of the vocoder's decoder stack,
``x + conv_k1(snake2(conv_k7_dilated(snake1(x))))``, causal.

Counterpart of ``qwen3tts_tpu/ops/pallas_vocoder.py``: replaces the Pallas
kernel ``fused_res_block`` (:162) with ``csrc/res_block.cu`` (whose source
says what bounds it and how this first design spends its bytes). float32 in
and out, float32 FMAs, no TF32: the reference for the port is the float32
XLA vocoder. Any channel width runs unpadded (the TPU kernel needs
128-lane multiples; the JAX package pads the 96- and 192-channel blocks,
which the port does not copy).
"""

from __future__ import annotations

import torch

from .. import _kernels


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x + exp(-beta) * sin^2(exp(alpha) * x), per channel, in float32."""
    xf = x.float()
    s = torch.sin(xf * torch.exp(alpha.float()))
    return (xf + torch.exp(-beta.float()) * s * s).to(x.dtype)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, b, dilation: int = 1) -> torch.Tensor:
    """Causal 1-D conv on x [T, Cin] with w [K, Cin, Cout]: left zero padding
    of dilation*(K-1), then y[t] = sum_k xp[t + dilation*k] @ w[k] in
    float32 (the JAX package's tap-sum form)."""
    K = w.shape[0]
    T = x.shape[0]
    xp = torch.nn.functional.pad(x, (0, 0, dilation * (K - 1), 0))
    acc = torch.matmul(xp[:T].float(), w[0].float())
    for k in range(1, K):
        acc = acc + torch.matmul(xp[dilation * k: dilation * k + T].float(), w[k].float())
    y = acc.to(x.dtype)
    return y if b is None else y + b


def res_block_plain(x, w1, b1, a1, be1, w2, b2, a2, be2, *, dilation: int):
    """Plain PyTorch version of K3."""
    h = snake(x, a1, be1)
    h = conv1d_causal(h, w1, b1, dilation)
    h = snake(h, a2, be2)
    h = conv1d_causal(h, w2, b2)
    return x + h


def fused_res_block(x, w1, b1, a1, be1, w2, b2, a2, be2, *, dilation: int):
    """x [T, C] f32; w1 [7, C, C]; w2 [1, C, C]; biases and snake params [C].

    CPU tensors run the plain version. CUDA tensors launch the kernel or
    raise; there is no fallback."""
    if x.device.type == "cpu":
        return res_block_plain(x, w1, b1, a1, be1, w2, b2, a2, be2, dilation=dilation)
    lib = _kernels.load_library()
    args = [t.float().contiguous() for t in (w1, b1, a1, be1, w2, b2, a2, be2)]
    _kernels.require_cuda(x, *args)
    T, C = x.shape
    if x.dtype != torch.float32:
        raise ValueError("fused_res_block takes float32 activations")
    if tuple(w1.shape) != (7, C, C) or tuple(w2.shape) != (1, C, C):
        raise ValueError(f"res-block weights {tuple(w1.shape)}, {tuple(w2.shape)} for C={C}")
    x = x.contiguous()
    s1 = torch.empty_like(x)
    s2 = torch.empty_like(x)
    out = torch.empty_like(x)
    err = lib.qtts_res_block(
        x.data_ptr(), *[t.data_ptr() for t in args], s1.data_ptr(), s2.data_ptr(),
        out.data_ptr(), T, C, int(dilation), _kernels.stream_ptr(x.device))
    _kernels.check(err, "fused_res_block")
    fused_res_block.launches += 1
    return out


fused_res_block.launches = 0
