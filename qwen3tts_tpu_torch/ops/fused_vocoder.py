"""K3: one residual block of the vocoder's decoder stack,
``x + conv_k1(snake2(conv_k7_dilated(snake1(x))))``, causal.

Counterpart of ``qwen3tts_tpu/ops/pallas_vocoder.py``: replaces the Pallas
kernel ``fused_res_block`` (:162) with ``csrc/res_block.cu`` (whose source
says what bounds it and how the design keeps the snake and the 7 taps on
chip). float32 in and out, float32 FMAs, no TF32: the reference for the
port is the float32 XLA vocoder. Any channel width that is a multiple of 8
runs unpadded (the TPU kernel needs 128-lane multiples; the JAX package
pads the 96- and 192-channel blocks, which the port does not copy): the
narrow blocks (C = 96, 192) in one launch, the others in two
(``res_block_plan``). A group of lanes [B, T, C] runs in the same launches,
the lane as the grid's third dimension: each lane's causal halo reads
zeros, never the previous lane's rows, and each lane equals the one-lane
call bit for bit (the vocoder's batched groups, ``models/vocoder.py``).
"""

from __future__ import annotations

import torch

from .. import _kernels
from . import library


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """x + exp(-beta) * sin^2(exp(alpha) * x), per channel, in float32."""
    xf = x.float()
    s = torch.sin(xf * torch.exp(alpha.float()))
    return (xf + torch.exp(-beta.float()) * s * s).to(x.dtype)


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, b, dilation: int = 1) -> torch.Tensor:
    """Causal 1-D conv on x [..., T, Cin] (leading lane dimensions, each lane
    padded on its own) with w [K, Cin, Cout]: left zero padding of
    dilation*(K-1), then y[t] = sum_k xp[t + dilation*k] @ w[k] in float32
    (the JAX package's tap-sum form)."""
    K = w.shape[0]
    T = x.shape[-2]
    xp = torch.nn.functional.pad(x, (0, 0, dilation * (K - 1), 0))
    acc = torch.matmul(xp[..., :T, :].float(), w[0].float())
    for k in range(1, K):
        acc = acc + torch.matmul(xp[..., dilation * k: dilation * k + T, :].float(),
                                 w[k].float())
    y = acc.to(x.dtype)
    return y if b is None else y + b


def res_block_plain(x, w1, b1, a1, be1, w2, b2, a2, be2, *, dilation: int):
    """Plain PyTorch version of K3, on x [T, C] or a group of lanes [B, T, C]."""
    h = snake(x, a1, be1)
    h = conv1d_causal(h, w1, b1, dilation)
    h = snake(h, a2, be2)
    h = conv1d_causal(h, w2, b2)
    return x + h


# the tile plan's constants (csrc/res_block.cu)
RB_TM = 128                  # rows per block
RB_TAPS = 7
RB_FUSED_WIDTHS = (96, 192)  # one block holds every column; the 1x1 conv in shared memory
RB_WIDE_TN = 128             # the others' column tiles


def res_block_plan(T: int, C: int, dilation: int):
    """K3's plan for T rows of C channels per lane (res_block_plan in the
    source): (launches, rows per block, columns per block, row tiles, column
    tiles, halo rows); each launch's grid is (row tiles, column tiles,
    lanes), so a group of lanes takes the launches of one.
    One launch where one block holds all C columns (RB_FUSED_WIDTHS), else
    two (the dilated conv into a scratch, then the 1x1 conv with the
    residual) over column tiles of RB_WIDE_TN. A block reads the x rows
    [t0 - halo, t0 + RB_TM) of its row tile, halo = 6 * dilation."""
    rows, halo = -(-T // RB_TM), (RB_TAPS - 1) * dilation
    if C in RB_FUSED_WIDTHS:
        return 1, RB_TM, C, rows, 1, halo
    return 2, RB_TM, RB_WIDE_TN, rows, -(-C // RB_WIDE_TN), halo


# lanes of one launch (the grid's third dimension)
RB_MAX_LANES = 65535


def _res_block_cpu(x, w1, b1, a1, be1, w2, b2, a2, be2, dilation):
    """The res-block op's CPU kernel: the plain version."""
    return res_block_plain(x, w1, b1, a1, be1, w2, b2, a2, be2, dilation=dilation)


def launch_res_block(x, w1, b1, a1, be1, w2, b2, a2, be2, dilation):
    """K3's launches for one res block (the res-block op's CUDA kernel),
    counted once on ``fused_res_block``."""
    lib = _kernels.load_library()
    args = [_kernels.aligned16(t.float()) for t in (w1, b1, a1, be1, w2, b2, a2, be2)]
    _kernels.require_cuda(x, *args)
    if x.dim() not in (2, 3) or x.dtype != torch.float32:
        raise ValueError(f"fused_res_block takes float32 [T, C] or [B, T, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, T, C = (1,) + tuple(x.shape) if x.dim() == 2 else tuple(x.shape)
    if not 1 <= B <= RB_MAX_LANES:
        raise ValueError(f"fused_res_block takes 1 to {RB_MAX_LANES} lanes, got {B}")
    if tuple(w1.shape) != (7, C, C) or tuple(w2.shape) != (1, C, C) or C % 8:
        raise ValueError(f"res-block weights {tuple(w1.shape)}, {tuple(w2.shape)} for C={C} "
                         "(C must be a multiple of 8)")
    x = _kernels.aligned16(x)
    out = torch.empty_like(x)
    s2 = torch.empty_like(x) if res_block_plan(T, C, dilation)[0] == 2 else None
    err = lib.qtts_res_block(
        x.data_ptr(), *[t.data_ptr() for t in args], None if s2 is None else s2.data_ptr(),
        out.data_ptr(), B, T, C, int(dilation), _kernels.stream_ptr(x.device))
    _kernels.check(err, "fused_res_block")
    fused_res_block.launches += 1
    return out


def fused_res_block(x, w1, b1, a1, be1, w2, b2, a2, be2, *, dilation: int):
    """x [T, C] or a group of lanes [B, T, C] f32; w1 [7, C, C]; w2 [1, C, C];
    biases and snake params [C]. Lane b's output is the one-lane call's on
    x[b], bit for bit. Runs the op ``qwen3tts::res_block``
    (``ops/library.py``).

    CPU tensors run the plain version. CUDA tensors launch the kernel (C a
    multiple of 8) or raise; there is no fallback."""
    return torch.ops.qwen3tts.res_block.default(x, w1, b1, a1, be1, w2, b2, a2, be2,
                                                int(dilation))


fused_res_block.launches = 0
library.implement("res_block", cpu=_res_block_cpu, cuda=launch_res_block)
