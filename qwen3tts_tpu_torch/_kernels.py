"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, and loaded with
``ctypes``. The library lands in ``_build/`` beside this file (listed in
``.gitignore``) under a name that hashes the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built when this
module is imported: the CPU tests import every module and have no ``nvcc``.

Every C entry point takes device pointers and the CUDA stream as
``c_void_p`` and returns the ``cudaError_t`` of its last launch
(``cudaGetLastError``); ``check`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# name -> argtypes of every C entry point (restype is int: a cudaError_t)
SIGNATURES = {
    "qtts_sample_rows": [
        P, I, I, P, I, F, F, I, I, I, I, I, P, F, P, P],
    "qtts_sample_shape": [I, I, I, I, F, P],                # V greedy top_k use_top_p top_p, out[3]
    "qtts_talker_ws_bytes": [I, I, I, I, I, I, I],          # H Hq Hkv D F Vc modes
    "qtts_talker_step": [
        P, I, P, P,                      # x_in, n_past, cos, sin
        P, P, P, P,                      # attn/q/k/ffn norms (f32)
        P, P, P, I, P, P, P, I,          # wqkv, wo, w_gateup, w_down:
        P, P, P, I, P, P, P, I,          #   (weights, scale, zero, G) each
        P, P, I, P, P,                   # output_norm, codec_head, modes, kv, kv_scale
        I, I,                            # kv_f32, head_f32
        I, I, I, I, I, I, I, I, F,       # L H Hq Hkv D F C Vc eps
        P, F, F, F, I, I, I, I, I, I,    # seen temp top_p pen top_k greedy
                                         # use_top_p suppress eos seed
        P, P, P, P, P],                  # hidden, logits, tok, ws, stream
    "qtts_talker_batched_ws_bytes": [I, I, I, I, I, I, I, I],   # B, then as above
    "qtts_talker_step_batched": [
        P, I, I, P, P,                   # x_in, B, n_past, cos, sin
        P, P, P, P,                      # attn/q/k/ffn norms (f32)
        P, P, P, I, P, P, P, I,          # wqkv, wo, w_gateup, w_down:
        P, P, P, I, P, P, P, I,          #   (weights, scale, zero, G) each
        P, P, I, P, P,                   # output_norm, codec_head, modes, kv, kv_scale
        I, I, I,                         # kv_f32, head_f32, lane_major
        I, I, I, I, I, I, I, I, F,       # L H Hq Hkv D F C Vc eps
        P, P, F, F, F, I, I, I, I, I,    # seen seeds temp top_p pen top_k
                                         # greedy use_top_p suppress eos
        P, I, P, P, P,                   # start, start_min, temps, topps, pens
        P, P, P, P, P],                  # hidden, logits, tok, ws, stream
    "qtts_project_ws_bytes": [I, I, I, I],                  # code B K N
    "qtts_project_layers": [
        I, P, P, P, P, I,                # code, x, w, scale, zero, G
        I, I, I, I, P, P],               # L B K N, ws, stream
    "qtts_w4_gemv_probe": [P, P, I, I, I, I, P, P],        # x w packed L K N out stream
    "qtts_cp_ws_bytes": [I, I, I, I, I, I, I, I],          # H Hq Hkv D F CTX V emb_f32
    "qtts_cp_batched_ws_bytes": [I, I, I, I, I, I, I, I, I],   # B, then as above
    "qtts_cp_grid": [I, I, I, I, I, I, I, I, I, I, P],     # L H Hq Hkv D F V CTX S emb_f32, out[5]
    "qtts_cp_batched_grid": [I, I, I, I, I, I, I, I, I, I, I, P],   # B, then as above
    "qtts_code_predictor_batched": [
        P, I, P, P,                      # xinit, B, cos, sin
        P, P, P, P, P,                   # attn/q/k/ffn/out norms (f32)
        P, P, P, P, P, P, P, P,          # wqkv, wo, w_gateup, w_down (q, s)
        P, P, I,                         # heads, embds, emb_f32
        I, I, I, I, I, I, I, I, I, F,    # L H Hq Hkv D F V CTX S eps
        F, F, I, I, I, P,                # temp top_p top_k greedy use_top_p seeds
        P, P,                            # temps, topps
        P, P, P, P, P],                  # codes, rest_sum, kv, ws, stream
    "qtts_code_predictor": [
        P, P, P,                         # xinit, cos, sin
        P, P, P, P, P,                   # attn/q/k/ffn/out norms (f32)
        P, P, P, P, P, P, P, P,          # wqkv, wo, w_gateup, w_down (q, s)
        P, P, I,                         # heads, embds, emb_f32
        I, I, I, I, I, I, I, I, I, F,    # L H Hq Hkv D F V CTX S eps
        F, F, I, I, I, I,                # temp top_p top_k greedy use_top_p seed
        P, P, P, P, P],                  # codes, rest_sum, kv, ws, stream
    "qtts_res_block_plan": [I, I, I, P],                    # T C dilation, out[6]
    "qtts_res_block": [
        P, P, P, P, P, P, P, P, P,       # x, w1, b1, a1, be1, w2, b2, a2, be2
        P, P, I, I, I, I, P],            # s2, out, B, T, C, dilation, stream
    "qtts_int8_mm_plan": [I, I, I, I, P],                   # M K N x_bf16, out[5]
    "qtts_int8_matmul": [
        P, P, P, P,                      # x, q, scale, y
        I, I, I, I, P],                  # M K N x_bf16, stream
    "qtts_decode_attention_splits": [I, I, I],              # B Hkv n_valid
    "qtts_decode_attention": [
        P, P, LL,                        # q, kv (the layer's K, lane 0), lane stride
        I, I, I, I, I, I, F, I,          # B Hq Hkv C D n_valid scale f32
        P, P],                           # out, stream
    "qtts_talker_attention_clusters": [I, I, I, I, I],      # B Hkv G rows kv_kind
    "qtts_lane_map_shape": [I, I, I, I, I, I, I, P],        # L Hkv C B D rows kv_f32, out[14]
    "qtts_gemm_plan": [I, I, I, P],                         # code K N, out[3]
    "qtts_gemv_plan": [I, I, I, P],                         # code K N, out[3]
}

_LIB = None
build_seconds = 0.0
# seconds each source's nvcc took in the last build (they run together)
source_seconds: dict = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> str:
    """Compile csrc/*.cu into _build/libqtts_<hash>.so (if not there yet);
    return its path. Each source is compiled by its own nvcc process, all
    started together, and the objects are then linked into the library."""
    global build_seconds, source_seconds
    h = hashlib.sha256()
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libqtts_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}.tmp"
    obj_dir = f"{tmp}.obj"
    os.makedirs(obj_dir, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        obj = os.path.join(obj_dir, os.path.basename(src) + ".o")
        cmd = ([nvcc] + ARCH_FLAGS
               + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-c", "-o", obj, src])
        log = open(obj + ".log", "w+")
        procs.append((obj, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), log))
    errors = []
    source_seconds = {}
    running = list(procs)
    while running:   # each source's seconds from the common start to its end
        for item in list(running):
            obj, proc, log = item
            if proc.poll() is None:
                continue
            running.remove(item)
            source_seconds[os.path.basename(obj)[:-len(".o")]] = time.perf_counter() - t0
            if proc.returncode != 0:
                log.seek(0)
                errors.append(f"nvcc failed ({proc.returncode}) on {os.path.basename(obj)}:\n"
                              f"{log.read()}")
            log.close()
        time.sleep(0.05)
    if not errors:
        link = subprocess.run([nvcc] + ARCH_FLAGS + ["-shared", "-o", tmp]
                              + [obj for obj, _, _ in procs], capture_output=True, text=True)
        if link.returncode != 0:
            errors.append(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    shutil.rmtree(obj_dir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, out)
    return out


def load_library():
    """The loaded kernel library (built on first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_size_t if name.endswith("_bytes") else ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def aligned16(t):
    """t contiguous, its data 16-byte aligned (the kernels' asynchronous
    copies move 16 bytes): a copy only for a view that starts off the
    boundary."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_cuda(*tensors) -> None:
    """Raise unless every tensor lies on a CUDA device (the kernels take
    nothing else; CPU tensors go to the plain versions before this)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"kernel needs CUDA tensors, got {t.device}")
