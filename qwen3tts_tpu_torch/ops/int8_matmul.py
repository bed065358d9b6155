"""The W8A16 GEMM: y = x @ (q_int8 * scale) with a float32 sum.

Counterpart of ``qwen3tts_tpu/ops/pallas_int8_matmul.py``: ``int8_matmul``
replaces the Pallas kernel ``int8_matmul_pallas`` (:47) with the CUDA kernel
in ``csrc/int8_matmul.cu`` (whose source says what bounds it: the K x N int8
weight bytes). ``quant.matmul`` sends every 2-D int8 product here, so it
runs in every request's prefill and in each projection of the unfused
decode step.
"""

from __future__ import annotations

import torch

from .. import _kernels


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: x [M, K] (bf16 or float32) @ int8 q [K, N] in float32,
    times scale [1, N] in float32, cast to x's dtype."""
    y = torch.matmul(x.float(), q.float())
    return (y * scale.float().reshape(1, -1)).to(x.dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ (q [K, N] int8 * scale [1, N]) -> [M, N] in x's dtype.

    CPU tensors run the plain version. CUDA tensors launch the kernel (x
    bf16 or float32; K and N multiples of 64; q 16-byte aligned) or raise;
    there is no fallback."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, scale)
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
    x = x.contiguous()
    scale = scale.float().contiguous()
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ws = torch.empty(lib.qtts_int8_matmul_ws_bytes(M, K, N), dtype=torch.uint8, device=x.device)
    err = lib.qtts_int8_matmul(x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
                               ws.data_ptr(), M, K, N, int(x.dtype == torch.bfloat16),
                               _kernels.stream_ptr(x.device))
    _kernels.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0
