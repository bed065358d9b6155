"""The 4-bit GEMV probe (counterpart of ``tools/exp_w4_gemv.py``, its
Pallas ``call`` at :87): out [1, N] int32 = sum over L layers of x [1, K]
int8 @ W_l, with W int8 [L, K, N] ("int8") or two 4-bit values per byte
[L, K/2, N] ("packed": byte [i, n] holds row i in its low nibble and row
i + K/2 in its high nibble, each biased by 8). The kernel is
``csrc/w4_gemv_probe.cu``; the probe is off every serving path and asks
whether 4-bit weights halve a weight-streaming GEMV's time on the card.

``project_layers`` times K1's own projection kernels (``csrc/layer.cuh``)
at the same shape, beside the probe.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .fused_talker_step import MODE_CODES

L, K, N = 28, 1024, 4096   # the probe's shape: a wqkv-like projection over 28 layers


def pack_nibbles(w: torch.Tensor) -> torch.Tensor:
    """int weights in [-8, 8) [..., K, N] -> the probe's packed bytes [...,
    K/2, N] int8: (lo + 8) | (hi + 8) << 4 (tools/exp_w4_gemv.py:125)."""
    K = w.shape[-2]
    w = w.to(torch.int32)
    packed = ((w[..., :K // 2, :] + 8) | ((w[..., K // 2:, :] + 8) << 4)).to(torch.uint8)
    return packed.view(torch.int8)


def w4_gemv_probe_plain(x: torch.Tensor, w: torch.Tensor, packed: bool) -> torch.Tensor:
    """Plain version: x [1, K] int8, w int8 [L, K, N] or packed [L, K/2, N]
    -> [1, N] int32. The dots run in float64, where every partial sum of
    these integer products is an integer below 2^53 and so exact (integer
    matrix products have no CUDA kernel in torch)."""
    xd = x.to(torch.float64)[0]
    if packed:
        b = w.to(torch.int32) & 0xff
        Kh = w.shape[-2]
        lo, hi = ((b & 15) - 8).to(torch.float64), ((b >> 4) - 8).to(torch.float64)
        out = (torch.einsum("k,lkn->n", xd[:Kh], lo) + torch.einsum("k,lkn->n", xd[Kh:], hi))
    else:
        out = torch.einsum("k,lkn->n", xd, w.to(torch.float64))
    return out.to(torch.int32)[None]


def w4_gemv_probe(x: torch.Tensor, w: torch.Tensor, packed: bool) -> torch.Tensor:
    """The probe's GEMV: its kernel for CUDA tensors, its plain version for
    CPU tensors (no fallback). Returns [1, N] int32."""
    Lw, rows, Nw = w.shape
    Kx = x.shape[-1]
    if x.dtype != torch.int8 or w.dtype != torch.int8 or rows != (Kx // 2 if packed else Kx):
        raise ValueError(f"w4_gemv_probe takes int8 x [1, K] and int8 weights [L, "
                         f"{'K/2' if packed else 'K'}, N]; got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return w4_gemv_probe_plain(x, w, packed)
    lib = _kernels.load_library()
    _kernels.require_cuda(x, w)
    out = torch.zeros((1, Nw), dtype=torch.int32, device=x.device)
    err = lib.qtts_w4_gemv_probe(x.contiguous().data_ptr(), w.contiguous().data_ptr(),
                                 int(packed), Lw, Kx, Nw, out.data_ptr(),
                                 _kernels.stream_ptr(x.device))
    _kernels.check(err, "w4_gemv_probe")
    w4_gemv_probe.launches += 1
    return out


w4_gemv_probe.launches = 0


def project_layers(x: torch.Tensor, w, mode: str, ws: torch.Tensor = None) -> torch.Tensor:
    """Launch K1's projection kernel of `mode` once per layer of the stacked
    weight w (a QuantLinear's q, a QuantLinear4, or a bf16 [L, K, N] tensor)
    on x [B, K] (int8 for "w8a8", float32 otherwise), as run_layer does; a
    timing harness on the card only (the results are not kept). Returns the
    workspace, which a caller may pass back in."""
    _kernels.require_cuda(x)
    lib = _kernels.load_library()
    B, Kx = x.shape
    if mode == "w4bf16":
        wt, s, z, G = w.q, w.scale.contiguous(), w.zero.contiguous(), w.scale.shape[-2]
    elif mode == "w8a8":
        wt, s, z, G = w.q, w.scale.contiguous(), None, 0
    else:
        wt, s, z, G = w, None, None, 0
    Lw, Nw = wt.shape[0], wt.shape[-1]
    code = MODE_CODES[mode]
    if ws is None:
        ws = torch.empty(lib.qtts_project_ws_bytes(code, B, Kx, Nw), dtype=torch.uint8,
                         device=x.device)
    err = lib.qtts_project_layers(
        code, x.data_ptr(), wt.contiguous().data_ptr(), None if s is None else s.data_ptr(),
        None if z is None else z.data_ptr(), G, Lw, B, Kx, Nw, ws.data_ptr(),
        _kernels.stream_ptr(x.device))
    _kernels.check(err, "project_layers")
    return ws
