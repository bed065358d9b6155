"""Minimal safetensors reader and writer of the port (counterpart of
``qwen3tts_tpu/io/safetensors_io.py``), on torch tensors.

A file is mapped with mmap; ``tensor(name)`` copies that tensor's bytes once
into a new CPU ``torch.Tensor`` and reinterprets them in the stored dtype:
BF16 as its raw 16-bit words viewed as ``torch.bfloat16``, never widened on
the host (the JAX package widens BF16 to float32 when ``ml_dtypes`` is
missing, which the machine with the card lacks). No second host copy is
kept and the tensor does not alias the file. ``shape(name)`` reads the
header only.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """mmap-backed random access to one .safetensors file."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        (header_len,) = struct.unpack_from("<Q", self._mm, 0)
        self.header = json.loads(self._mm[8: 8 + header_len].decode("utf-8"))
        self._data_start = 8 + header_len
        self.header.pop("__metadata__", None)

    def keys(self):
        return self.header.keys()

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(self.header[name]["shape"])

    def tensor(self, name: str) -> torch.Tensor:
        info = self.header[name]
        start, end = info["data_offsets"]
        out = torch.empty(end - start, dtype=torch.uint8)
        out.numpy()[:] = np.frombuffer(self._mm, np.uint8, end - start,
                                       self._data_start + start)
        return out.view(_DTYPES[info["dtype"]]).reshape(info["shape"])


class SafetensorsDir:
    """All *.safetensors under a directory as one name->tensor namespace."""

    def __init__(self, path: str):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors")
        )
        if not files:
            raise FileNotFoundError(f"no .safetensors files under {path}")
        self.files = [SafetensorsFile(p) for p in files]
        self.index: Dict[str, SafetensorsFile] = {}
        for sf in self.files:
            for k in sf.keys():
                self.index[k] = sf

    def __contains__(self, name: str) -> bool:
        return name in self.index

    def keys(self):
        return self.index.keys()

    def shape(self, name: str) -> Tuple[int, ...]:
        return self.index[name].shape(name)

    def tensor(self, name: str) -> torch.Tensor:
        return self.index[name].tensor(name)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for k in self.index:
            yield k, self.tensor(k)


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor]) -> None:
    """Write CPU or device tensors (or numpy arrays of the dtypes above but
    bfloat16) as one .safetensors file: the header first, then each tensor's
    bytes in turn, so no second copy of the whole file is held."""
    header = {}
    offset = 0
    for name, t in tensors.items():
        t = torch.as_tensor(t)
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    hdr = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for t in tensors.values():
            t = torch.as_tensor(t).detach().cpu().contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)
