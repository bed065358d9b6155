"""Load model weights from reference-format GGUF files (counterpart of
``qwen3tts_tpu/io/gguf_checkpoint.py``).

Presents a GGUF model directory (qwen3-tts-0.6b-*.gguf +
qwen3-tts-tokenizer-*.gguf, the reference's on-disk convention,
src/qwen3_tts.cpp:118-119) through the same ``.tensor(hf_name)`` and
``.shape(hf_name)`` interface as ``SafetensorsDir``, so io/loader.py works
unchanged on either format. Tensors come back as CPU torch tensors with the
JAX package's values: F16 widened to float32, Q8_0 and Q4_K dequantized to
float32. Files are read through the port's native library
(``io/native.NativeGGUF``), as the JAX package reads them, with no quiet
fallback: a library that does not build or a file its parser refuses
raises. ``reader=GGUFReader`` reads the same values in pure Python (the
tests and the load timing beside the native reader).
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Tuple

import numpy as np
import torch

from . import tensor_names
from .native import NativeGGUF


class GGUFCheckpoint:
    """HF-named tensor access over one or more GGUF files, each opened by
    `reader` (NativeGGUF, or io.gguf.GGUFReader)."""

    def __init__(self, *paths: str, reader=NativeGGUF):
        self._readers = [reader(p) for p in paths]
        self._by_ggml = {}
        for r in self._readers:
            for name in r.keys():
                self._by_ggml[name] = r

    def __contains__(self, hf_name: str) -> bool:
        g = tensor_names.hf_to_ggml(hf_name)
        if g is None:
            return self._is_synthesized(hf_name)
        return g in self._by_ggml

    def _is_synthesized(self, hf_name: str) -> bool:
        # cluster_usage was folded into the codebook at conversion time; the
        # loader divides by it again, so synthesize ones.
        return hf_name.endswith("_codebook.cluster_usage")

    def _ggml(self, hf_name: str) -> str:
        g = tensor_names.hf_to_ggml(hf_name)
        if g is None or g not in self._by_ggml:
            raise KeyError(f"{hf_name} (ggml: {g}) not present in GGUF checkpoint")
        return g

    def shape(self, hf_name: str) -> Tuple[int, ...]:
        if self._is_synthesized(hf_name):
            g = self._ggml(hf_name.replace("cluster_usage", "embedding_sum"))
            return self._by_ggml[g].shape(g)[:1]
        g = self._ggml(hf_name)
        return self._by_ggml[g].shape(g)

    def tensor(self, hf_name: str) -> torch.Tensor:
        if self._is_synthesized(hf_name):
            return torch.ones(self.shape(hf_name), dtype=torch.float32)
        g = self._ggml(hf_name)
        arr = self._by_ggml[g].tensor(g)
        if arr.dtype == np.float16:
            return torch.from_numpy(arr.astype(np.float32))
        return torch.from_numpy(np.array(arr, copy=not arr.flags.writeable))


def find_gguf_models(model_dir: str) -> tuple[Optional[str], Optional[str]]:
    """Locate (tts_model.gguf, tokenizer.gguf) in a directory, preferring the
    reference's default filenames."""
    tts = tok = None
    for p in sorted(glob.glob(os.path.join(model_dir, "*.gguf"))):
        base = os.path.basename(p).lower()
        if "tokenizer" in base:
            tok = tok or p
        else:
            tts = tts or p
    return tts, tok
