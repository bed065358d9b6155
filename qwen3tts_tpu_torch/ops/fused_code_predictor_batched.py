"""K6: the 15 residual codes of one frame for each of B lanes (the code
predictor's inner loop for a batch in lockstep).

Counterpart of ``qwen3tts_tpu/ops/pallas_code_predictor_batched.py``:
replaces the Pallas kernel ``fused_predict_codes_batched`` (:235) in its
w8a8 mode, with one cooperative launch per frame-set of the persistent
CUDA kernel in ``csrc/code_predictor_persistent.cuh`` (entry
``csrc/code_predictor_batched.cu``, whose source says what bounds it and how
each pass reads the int8 block stack once for all lanes).

Per lane the semantics are K2's (``fused_code_predictor.py``): activations
quantized per lane, the counter-hash sampler with the lane's seed, so lane b
equals K2 run with seeds[b]. Temperature and top-p are scalars or per-lane
[B] tensors (the Pallas kernel's per-lane operands, :86-88: continuous
serving gives each request its own). As in the Pallas kernel, K/V rows are stored in
the embedding dtype (K2 keeps them in float32); on float32 weights the two
agree exactly: the float32 tier's K6 keeps a float32 scratch. The Pallas kernel's one-hot embedding gather and lane-major
KV scratch are TPU tiling artifacts and are not copied.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .fused_code_predictor import _xinit, cuda_operands, emb_f32, predict_codes_plain
from .fused_talker_step import _lane_values, check_w8a8_blocks
from .sampling import sample_rows

MAX_LANES = 64   # lanes of one call (the Pallas kernel's VMEM budget)


def fused_predict_codes_batched_plain(cp_params, cfg, talker_hidden, cb0_embd, seeds, *,
                                      temperature, top_k, top_p=1.0, greedy=False,
                                      use_top_p=True):
    """Plain PyTorch version of K6: (codes [B, 15] int64, rest_sum [B, H]);
    temperature and top_p scalars or [B]."""
    return predict_codes_plain(
        cp_params, cfg, talker_hidden, cb0_embd, seeds, kv_dtype=cp_params.embds.dtype,
        temperature=temperature, top_k=top_k, top_p=top_p, greedy=greedy,
        use_top_p=use_top_p)


def fused_predict_codes_batched(cp_params, cfg, talker_hidden, cb0_embd, seeds, *,
                                temperature, top_k, top_p=1.0, greedy=False,
                                use_top_p=True):
    """talker_hidden, cb0_embd [B, H]; seeds int32 [B] (a tensor, or a list
    of ints); temperature and top_p scalars or per-lane [B] tensors.
    Returns (codes [B, 15], rest_sum [B, H] f32).

    CPU tensors run the plain version. CUDA tensors make one cooperative
    launch of the persistent kernel (bf16 or float32 heads and embedding
    tables, B <= 64) or raise, also when the grid cannot be co-resident or
    the device refuses the cooperative launch; there is no fallback. The
    kernel's KV scratch [2, L, B, Hkv, 16, D] in the embedding dtype is
    allocated here with torch.empty.
    """
    check_w8a8_blocks(cp_params.blocks)
    B = talker_hidden.shape[0]
    if not 1 <= B <= MAX_LANES:
        raise ValueError(f"fused_predict_codes_batched takes 1..{MAX_LANES} lanes, got {B}")
    if cp_params.embds.device.type == "cpu":
        return fused_predict_codes_batched_plain(
            cp_params, cfg, talker_hidden, cb0_embd, seeds, temperature=temperature,
            top_k=top_k, top_p=top_p, greedy=greedy, use_top_p=use_top_p)
    lib = _kernels.load_library()
    dev = cp_params.embds.device
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=dev).contiguous()
    _kernels.require_cuda(talker_hidden, cb0_embd, seeds)
    if tuple(seeds.shape) != (B,):
        raise ValueError(f"seeds must be [{B}], got {tuple(seeds.shape)}")
    tensors, dims = cuda_operands(cp_params, cfg)
    L, H, Hq, Hkv, D, F, V, CTX, S, _ = dims
    xinit = _xinit(cp_params, talker_hidden, cb0_embd).contiguous()
    codes = torch.empty((B, S), dtype=torch.int32, device=dev)
    rest_sum = torch.empty((B, H), dtype=torch.float32, device=dev)   # zeroed by the kernel
    f32 = int(emb_f32(cp_params))
    kv = torch.empty((2, L, B, Hkv, CTX, D), dtype=cp_params.embds.dtype, device=dev)
    ws = torch.empty(lib.qtts_cp_batched_ws_bytes(B, H, Hq, Hkv, D, F, CTX, V, f32),
                     dtype=torch.uint8, device=dev)
    temp, temps = _lane_values(temperature, B, dev)
    topp, topps = _lane_values(top_p, B, dev)
    err = lib.qtts_code_predictor_batched(
        xinit.data_ptr(), B, *[t.data_ptr() for t in tensors], f32, *dims,
        temp, topp, int(top_k), int(greedy), int(use_top_p), seeds.data_ptr(),
        None if temps is None else temps.data_ptr(), None if topps is None else topps.data_ptr(),
        codes.data_ptr(), rest_sum.data_ptr(), kv.data_ptr(), ws.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.check(err, "fused_predict_codes_batched")
    fused_predict_codes_batched.launches += 1
    sample_rows.site_rows["K6"] += B * S
    ops = fused_predict_codes_batched.operand_launches
    if temps is not None or topps is not None:
        ops["per_lane"] = ops.get("per_lane", 0) + 1
    if f32:
        ops["f32"] = ops.get("f32", 0) + 1
    return codes, rest_sum


fused_predict_codes_batched.launches = 0
# launches with per-lane sampling parameters (continuous serving), and with
# float32 heads and embeddings ("f32")
fused_predict_codes_batched.operand_launches = {}
