"""The port's kernels on the export path as ``torch.library`` ops.

Five ops in the ``qwen3tts`` namespace, one for each kernel that an
exported stage program reaches (``tools/export_aot.py``):

  - ``talker_step``: K1 (``ops/fused_talker_step.py``), every weight mode,
    over a bf16 cache or the int8 (q, scale) pair;
  - ``predict_codes``: K2 (``ops/fused_code_predictor.py``);
  - ``res_block``: K3 (``ops/fused_vocoder.py``), one clip or a group of
    lanes;
  - ``int8_matmul``: the W8A16 GEMM (``ops/int8_matmul.py``);
  - ``decode_attention``: decode attention (``ops/decode_attention.py``).

Each op's schema takes flat tensors, ints and floats: the wrappers keep
the NamedTuples of blocks and the configs and flatten them. Its CPU kernel
is the kernel's plain version, its CUDA kernel the launcher, which counts
its launches on the wrapper (``fused_talker_step.launches`` and the
rest), so a launch from an exported graph counts like an eager one; the
launcher raises on anything it cannot launch, and nothing falls back to
the plain version. Shapes under tracing (``torch.export``,
``torch.library.opcheck``) and on meta tensors come from each op's fake
implementation. The K1 op declares its cache operands mutable (``Tensor(a!)
kv``): the kernel writes them in place at ``n_past``, and the exported
graphs call it on them with no functional copy.

The ops are registered through ``torch.library.Library``, not
``torch.library.custom_op``: on this port's host a ``custom_op`` call of
K1's schema took about 1 ms, a ``Library`` call about 25 us more than the
Python function it wraps (PERF.md, PR 20).

Each kernel module registers its two implementations when it is imported
(``implement``), and the ``ops`` package imports the five, so importing
this module is enough to run a reloaded program.
"""

from __future__ import annotations

import torch

NAMESPACE = "qwen3tts"

_BLOCKS = ("Tensor attn_norm, Tensor q_norm, Tensor k_norm, Tensor ffn_norm")
_PROJ = ", ".join(f"Tensor {p}, Tensor? {p}_scale, Tensor? {p}_zero"
                  for p in ("wqkv", "wo", "w_gateup", "w_down"))
_PROJ_INT8 = ", ".join(f"Tensor {p}, Tensor {p}_scale"
                       for p in ("wqkv", "wo", "w_gateup", "w_down"))
_SAMPLING = "float temperature, float top_p"

SCHEMAS = {
    # dims: n_layers, hidden_size, n_heads, n_kv_heads, head_dim,
    # intermediate_size; returns (hidden [H] f32, logits [Vc] f32, cb0
    # int32 [1], or [0] when seen is None)
    "talker_step": (
        f"(Tensor x, SymInt n_past, {_BLOCKS}, {_PROJ}, Tensor output_norm, "
        "Tensor codec_head, Tensor(a!) kv, Tensor(b!)? kv_scale, Tensor? seen, SymInt seed, "
        f"{_SAMPLING}, float repetition_penalty, int top_k, bool greedy, bool use_top_p, "
        "int suppress_start, int eos_id, int[] dims, float eps, float rope_theta) "
        "-> (Tensor, Tensor, Tensor)"),
    # dims: as talker_step's, then vocab_size and n_codebooks; returns
    # (codes int32 [n_codebooks - 1], rest_sum [H] f32)
    "predict_codes": (
        f"(Tensor talker_hidden, Tensor cb0_embd, {_BLOCKS}, Tensor output_norm, "
        f"{_PROJ_INT8}, Tensor heads, Tensor embds, SymInt seed, {_SAMPLING}, int top_k, "
        "bool greedy, bool use_top_p, int[] dims, float eps, float rope_theta) "
        "-> (Tensor, Tensor)"),
    "res_block": (
        "(Tensor x, Tensor w1, Tensor b1, Tensor a1, Tensor be1, Tensor w2, Tensor b2, "
        "Tensor a2, Tensor be2, int dilation) -> Tensor"),
    "int8_matmul": "(Tensor x, Tensor q, Tensor scale) -> Tensor",
    "decode_attention": "(Tensor q, Tensor kv, int layer, SymInt n_valid) -> Tensor",
}

LIB = torch.library.Library(NAMESPACE, "DEF")
for _name, _schema in SCHEMAS.items():
    LIB.define(_name + _schema)


def op(name: str):
    """The op's default overload, ``torch.ops.qwen3tts.<name>.default``."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def as_int(v):
    """An int operand as the op takes it: a SymInt (under torch.export) as
    it is, anything else (a Python or numpy int) as a Python int."""
    return v if isinstance(v, torch.SymInt) else int(v)


def implement(name: str, *, cpu, cuda) -> None:
    """Register an op's kernels: `cpu` (the plain version) for CPU
    tensors, `cuda` (the launcher) for CUDA tensors."""
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")


@torch.library.register_fake(f"{NAMESPACE}::talker_step", lib=LIB)
def _talker_step_fake(x, n_past, *args):
    codec_head, seen, dims = args[17], args[20], args[30]
    return (x.new_empty((dims[1],), dtype=torch.float32),
            x.new_empty((codec_head.shape[-1],), dtype=torch.float32),
            x.new_empty((0 if seen is None else 1,), dtype=torch.int32))


@torch.library.register_fake(f"{NAMESPACE}::predict_codes", lib=LIB)
def _predict_codes_fake(talker_hidden, *args):
    dims = args[-3]
    return (talker_hidden.new_empty((dims[7] - 1,), dtype=torch.int32),
            talker_hidden.new_empty((dims[1],), dtype=torch.float32))


@torch.library.register_fake(f"{NAMESPACE}::res_block", lib=LIB)
def _res_block_fake(x, *args):
    return x.new_empty(x.shape)


@torch.library.register_fake(f"{NAMESPACE}::int8_matmul", lib=LIB)
def _int8_matmul_fake(x, q, scale):
    return x.new_empty((x.shape[0], q.shape[1]))


@torch.library.register_fake(f"{NAMESPACE}::decode_attention", lib=LIB)
def _decode_attention_fake(q, kv, layer, n_valid):
    return q.new_empty(q.shape)
