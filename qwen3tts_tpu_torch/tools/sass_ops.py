#!/usr/bin/env python3
"""Count chosen SASS opcodes in each kernel of the built kernel library.

    python3 qwen3tts_tpu_torch/tools/sass_ops.py [--all] [PATTERN ...]

Builds the library if needed (nvcc on a machine with the CUDA toolkit),
disassembles it with cuobjdump and prints one JSON line: for every kernel
whose mangled name contains one of PATTERNs (default: the GEMMs, ``gemm_``
and ``gemv_``), the number of IMMA, DMMA, HMMA, IDP4A (SASS ``IDP.4A``),
DFMA, DMUL and FFMA instructions and of the conversions F2F (to or from
float64: F2F.F64.F32 and the like) and F2FP (the packing cvt to bf16x2),
and a few of its IMMA / DMMA / HMMA lines as cuobjdump prints them (an HMMA
line names its operand types: .BF16, or .TF32 for TF32). It shows which
pipe a kernel's products run on: the tensor cores (IMMA, DMMA, HMMA) or the
CUDA cores (IDP4A, DFMA, FFMA), and how many conversions it issues. K1's
GEMVs: ``sass_ops.py gemv_``. ``--all`` lists every kernel.
K3 and the W8A16 GEMM: ``sass_ops.py res_conv int8_mm_`` (K3: FFMA and no
HMMA; the GEMM's ``int8_mm_mma_kernel``: HMMA .BF16).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

OPCODES = ("IMMA", "DMMA", "HMMA", "IDP4A", "DFMA", "DMUL", "FFMA", "F2F", "F2FP")


def count_ops(sass: str, patterns, every=False):
    """{kernel: {opcode: count, "lines": [...]}} from cuobjdump -sass text."""
    out = {}
    for chunk in sass.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if not every and not any(p in name for p in patterns):
            continue
        ops = {}
        lines = []
        for line in chunk.splitlines():
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?P\d+\s+)?([A-Z0-9]+)(\.[A-Z0-9_.]+)?", line)
            if not m:
                continue
            op = m.group(2)
            if op == "IDP" and (m.group(3) or "").startswith(".4A"):
                op = "IDP4A"
            if op in OPCODES:
                ops[op] = ops.get(op, 0) + 1
                if op in ("IMMA", "DMMA", "HMMA") and len(lines) < 3:
                    lines.append(re.sub(r"\s+", " ", line.split(";")[0]).strip() + " ;")
        out[name] = dict(ops, lines=lines)
    return out


def main() -> int:
    from qwen3tts_tpu_torch import _kernels

    args = [a for a in sys.argv[1:] if a != "--all"]
    lib = _kernels.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    print(json.dumps(dict(library=os.path.basename(lib),
                          kernels=count_ops(sass, args or ["gemm_", "gemv_"],
                                            "--all" in sys.argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
