"""The W8A16 GEMM: y = x @ (q_int8 * scale) with a float32 sum.

Counterpart of ``qwen3tts_tpu/ops/pallas_int8_matmul.py``: ``int8_matmul``
replaces the Pallas kernel ``int8_matmul_pallas`` (:47) with the CUDA kernel
in ``csrc/int8_matmul.cu`` (whose source says what bounds it: the K x N int8
weight bytes). ``quant.matmul`` sends every 2-D int8 product here, so it
runs in every request's prefill and in each projection of the unfused
decode step. One cluster launch per call: the K ranges of a column tile are
the ranks of a thread block cluster, whose float32 partials are added in
rank order over distributed shared memory (``int8_mm_plan``).
"""

from __future__ import annotations

import torch

from .. import _kernels
from . import library

# the tile plan's constants (csrc/int8_matmul.cu)
MM_TN = 64                       # output columns per block
MM_BLOCK_TARGET = 264            # two blocks on each of 132 SMs
MM_MAX_SPLITS = 16               # a non-portable cluster
MM_ROWS = {0: 8, 1: 128}         # rows of x per block: FFMA path, tensor-core path
MM_TK = {0: 64, 1: 32}           # weight rows per tile


def int8_mm_plan(M: int, K: int, N: int, x_bf16: bool = True):
    """The GEMM's plan for x [M, K] @ q [K, N] (mm_plan in the source):
    (path, K splits, tiles per split, column tiles, row blocks). Path 1 (the
    tensor cores) takes bf16 x with M > 8, path 0 (float32 FMAs) the rest.
    The K rows are cut into tiles of MM_TK[path] rows; split s (cluster rank
    s) takes tiles [s * per, (s + 1) * per), so that about MM_BLOCK_TARGET
    blocks (splits x column tiles x row blocks), or fewer, run, with at most
    MM_MAX_SPLITS ranks a cluster."""
    path = 1 if x_bf16 and M > MM_ROWS[0] else 0
    col_tiles, row_tiles = N // MM_TN, -(-M // MM_ROWS[path])
    tiles = K // MM_TK[path]
    s = max(1, min(-(-MM_BLOCK_TARGET // (col_tiles * row_tiles)), tiles, MM_MAX_SPLITS))
    per = -(-tiles // s)
    return path, -(-tiles // per), per, col_tiles, row_tiles


def int8_mm_split_rows(M: int, K: int, N: int, x_bf16: bool = True):
    """The K rows [lo, hi) that each cluster rank of int8_mm_plan sums, in
    rank order (the order in which the ranks' partials are added)."""
    path, splits, per, _, _ = int8_mm_plan(M, K, N, x_bf16)
    span = per * MM_TK[path]
    return [(s * span, min(K, (s + 1) * span)) for s in range(splits)]


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: x [M, K] (bf16 or float32) @ int8 q [K, N] in float32,
    times scale [1, N] in float32, cast to x's dtype."""
    y = torch.matmul(x.float(), q.float())
    return (y * scale.float().reshape(1, -1)).to(x.dtype)


def launch_int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One cluster launch of the GEMM (the int8_matmul op's CUDA kernel),
    counted on ``int8_matmul``."""
    lib = _kernels.load_library()
    _kernels.require_cuda(x, q, scale)
    (M, K), N = x.shape, q.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32) or q.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes bf16/float32 x and int8 q, got {x.dtype}, {q.dtype}")
    if q.shape[0] != K or K % 64 or N % 64 or scale.numel() != N:
        raise ValueError(f"int8_matmul: shapes x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scale {tuple(scale.shape)} (K and N must be multiples of 64)")
    q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("int8_matmul: q must be 16-byte aligned")
    x, scale = _kernels.aligned16(x), _kernels.aligned16(scale.float())
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = lib.qtts_int8_matmul(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                               M, K, N, int(x.dtype == torch.bfloat16),
                               _kernels.stream_ptr(x.device))
    _kernels.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return y


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (q [K, N] int8 * scale [1, N]) -> [M, N] in x's dtype,
    through the op ``qwen3tts::int8_matmul`` (``ops/library.py``).

    CPU tensors run the plain version. CUDA tensors launch the kernel (x
    bf16 or float32; K and N multiples of 64; q 16-byte aligned) or raise;
    there is no fallback."""
    return torch.ops.qwen3tts.int8_matmul.default(x, q, scale)


int8_matmul.launches = 0
library.implement("int8_matmul", cpu=int8_matmul_plain, cuda=launch_int8_matmul)
