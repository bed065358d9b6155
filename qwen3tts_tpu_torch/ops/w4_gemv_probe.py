"""The 4-bit GEMV probe (counterpart of ``tools/exp_w4_gemv.py``, its
Pallas ``call`` at :87): out [1, N] int32 = sum over L layers of x [1, K]
int8 @ W_l, with W int8 [L, K, N] ("int8") or two 4-bit values per byte
[L, K/2, N] ("packed": byte [i, n] holds row i in its low nibble and row
i + K/2 in its high nibble, each biased by 8). The kernel is
``csrc/w4_gemv_probe.cu``; the probe is off every serving path and asks
whether 4-bit weights halve a weight-streaming GEMV's time on the card.

``project_layers`` runs the talker's own projection kernels
(``csrc/layer.cuh``: K1's GEMVs for one lane, K5's tensor-core GEMMs for
B >= 2; modes "head" and "head_f32" the codec head's GEMV over bf16 or
float32 weights) alone, layer after layer, for
their times; ``project_result`` reads one layer's result out of its
workspace and ``project_layer_plain`` is its plain version.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .fused_talker_step import MODE_CODES, gemm_plan, gemv_plan, project_plain

L, K, N = 28, 1024, 4096   # the probe's shape: a wqkv-like projection over 28 layers
# project_layers' modes (csrc/layer.cuh plan codes): the weight modes w8a8,
# bf16 and w4bf16 by their WeightMode, the codec head's GEMV over bf16 (3)
# and float32 weights (5), and f32 (4)
HARNESS_CODES = dict({m: c for m, c in MODE_CODES.items() if m != "f32"}, head=3, f32=4,
                     head_f32=5)
HEAD_MODES = ("head", "head_f32")


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
    """Launch the projection kernel of `mode` once per layer of the stacked
    weight w (a QuantLinear's q, a QuantLinear4, or a bf16 [L, K, N] tensor)
    on x [B, K] (int8 for "w8a8", float32 otherwise), as run_layer does: a
    GEMV for B = 1 (launched with programmatic dependent launch, as in K1),
    K5's GEMM for B >= 2; modes "head" and "head_f32" are the codec head's
    GEMV (bf16 or float32 [L, K, N], B = 1). A harness of the card only. The results land in the
    workspace, which is returned and may be passed back in: w8a8 adds every
    layer into its int32 accumulator (never cleared), the float modes
    overwrite their partials layer by layer, so a check runs one layer on a
    zeroed workspace and reads it with project_result. A float x must hold
    bf16 values, as the row kernels emit it (K5's GEMM takes it as it is;
    the GEMVs round it again), except in f32, whose x is any float32."""
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
    code = HARNESS_CODES[mode]
    if ws is None:
        ws = torch.empty(lib.qtts_project_ws_bytes(code, B, Kx, Nw), dtype=torch.uint8,
                         device=x.device)
    err = lib.qtts_project_layers(
        code, x.data_ptr(), wt.contiguous().data_ptr(), None if s is None else s.data_ptr(),
        None if z is None else z.data_ptr(), G, Lw, B, Kx, Nw, ws.data_ptr(),
        _kernels.stream_ptr(x.device))
    _kernels.check(err, "project_layers")
    return ws


def _splits(mode: str, B: int, K: int, N: int) -> int:
    """The K splits of one projection's partials: the GEMV's (B = 1, or the
    head) or the GEMM's."""
    return gemv_plan(mode, K, N)[1] if B == 1 else gemm_plan(mode, K, N)[1]


def project_ws_bytes(mode: str, B: int, K: int, N: int) -> int:
    """Bytes of project_layers' workspace (qtts_project_ws_bytes): the int32
    accumulator [B, N] (w8a8), the float64 partials [halves, splits, B, N]
    of the float modes, or the head's float32 partials [splits, N], with
    gemv_plan's splits for B = 1 and gemm_plan's for B >= 2."""
    if mode == "w8a8":
        return 4 * B * N
    if mode in HEAD_MODES:
        return 4 * _splits(mode, 1, K, N) * N
    return 8 * (2 if mode == "w4bf16" else 1) * _splits(mode, B, K, N) * B * N


def project_result(ws: torch.Tensor, mode: str, B: int, K: int, N: int) -> torch.Tensor:
    """The result of one projection (B lanes) in its workspace: w8a8 the
    int32 accumulator [B, N]; a float mode its float64 partials [halves,
    splits, B, N] added split by split in order from zero and rounded to
    float32 per half, the halves then added in float32, as the kernels'
    consumer (proj_value) reads them; the head its float32 partials added
    in order, as head_sample_kernel adds them."""
    if mode == "w8a8":
        return ws[:4 * B * N].view(torch.int32).view(B, N)
    splits = _splits(mode, B, K, N)
    if mode in HEAD_MODES:
        part = ws[:4 * splits * N].view(torch.float32).view(splits, 1, N)
        y = torch.zeros((1, N), dtype=torch.float32, device=ws.device)
        for sp in range(splits):
            y = y + part[sp]
        return y
    halves = 2 if mode == "w4bf16" else 1
    part = ws[:8 * halves * splits * B * N].view(torch.float64).view(halves, splits, B, N)
    y = None
    for h in range(halves):
        s = torch.zeros((B, N), dtype=torch.float64, device=ws.device)
        for sp in range(splits):
            s = s + part[h, sp]
        y = s.float() if y is None else y + s.float()
    return y


def project_layer_plain(x: torch.Tensor, w, mode: str, l: int) -> torch.Tensor:
    """Plain version of layer l of project_layers: w8a8 the int32 dot of the
    int8 x with the int8 weights (in float64, exact); a float mode
    fused_talker_step.project_plain; the head x rounded to W's dtype @ W_l
    in float32, as the plain K1 computes its logits."""
    if mode == "w8a8":
        return torch.matmul(x.double(), w.q[l].double()).to(torch.int32)
    if mode in HEAD_MODES:
        return torch.matmul(x.to(w.dtype).float(), w[l].float())
    return project_plain(x, w, l)
