#!/usr/bin/env python3
"""AOT export of the stage programs with torch.export (counterpart of
``tools/export_aot.py``).

The JAX tool serializes two jitted programs, ``generate`` (the prefill and
the whole sampled frame loop, one ``lax.while_loop``) and ``vocoder``. The
port's frame loop syncs with the host once a frame for the EOS check and
keeps the threefry key chain on the host (``runtime/decode_loop.py``), so
it exports three programs and drives the loop from the host
(``run_generate``):

  - ``prefill``: ``build_prefill`` and ``talker_prefill`` into a cache of
    kv_capacity rows, then frame 0's cb0 drawn by ``sample_cb0``
    (``generate_init``);
  - ``frame``: one ``decode_loop.frame_step``, the body of
    ``generate_chunk``: the code predictor (K2, or ``predict_codes``), the
    step embedding, the talker step (K1, or ``talker_step``) and the next
    cb0;
  - ``vocoder``: ``vocoder_forward(codes, n)``, run under
    ``ops/precision.full_float32()`` by ``run_vocoder`` (the TF32 switch is
    global state, not part of a graph).

The weights are arguments of the programs, as in the JAX tool: a saved
``.pt2`` file holds the graph, not the parameters (the example inputs are
dropped before saving). Every value that changes from call to call enters
as a tensor (token ids, n_tokens, the language id, the speaker embedding,
the unfused route's threefry keys) or as a dynamic int (n_past and the
K1/K2 seeds). The route (fused or unfused talker step and code predictor,
resolved as the decode loop resolves "auto"), the weight tier, the
sampling parameters and the frame budget are fixed when a program is
exported, as JAX fixes them at trace time; ``export.json`` records them,
and the cache holds ceil((10 + frames + 8) / 256) * 256 rows, as in the
JAX tool. The kernels on the programs' paths are the ``qwen3tts`` ops of
``ops/library.py``: a process that loads the programs needs
``qwen3tts_tpu_torch.ops.library`` imported (``load_programs`` does it).

    python3 qwen3tts_tpu_torch/tools/export_aot.py --out exported/ [--frames 256] [--text-bucket 64]
    python3 qwen3tts_tpu_torch/tools/export_aot.py --out exported/ --check   # reload + run
    python3 qwen3tts_tpu_torch/tools/export_aot.py --out exported/ --tiny --device cpu

Full size exports ``PipelineConfig()`` (the bf16 tier: K1 in bf16 mode,
the eager code predictor, K3 in the vocoder) on the card; ``--tiny`` the
float32 tiny config. ``--check`` reloads the files and runs them with
freshly built seeded parameters, as the JAX tool rebuilds its
``PRNGKey(0)`` parameters.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import typing
from typing import NamedTuple

if __name__ == "__main__" and not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402
from torch.export import Dim  # noqa: E402

from qwen3tts_tpu_torch.models import talker as talker_model  # noqa: E402
from qwen3tts_tpu_torch.models.code_predictor import code_keys  # noqa: E402
from qwen3tts_tpu_torch.models.talker import make_kv_cache  # noqa: E402
from qwen3tts_tpu_torch.models.vocoder import vocoder_forward  # noqa: E402
from qwen3tts_tpu_torch.ops import library  # noqa: E402,F401  (the qwen3tts ops)
from qwen3tts_tpu_torch.ops import prng  # noqa: E402
from qwen3tts_tpu_torch.ops.kernel_prng import sampling_flags  # noqa: E402
from qwen3tts_tpu_torch.ops.precision import full_float32  # noqa: E402
from qwen3tts_tpu_torch.runtime import decode_loop  # noqa: E402

PROGRAMS = ("prefill", "frame", "vocoder")
SPEC_FILE = "export.json"
# example values of the dynamic ints while tracing (not 0 or 1, which
# torch.export would specialize)
EXAMPLE_SEED = 12345
# rows of the prefill window (the JAX tool exports nothink=False)
PREFILL_ROWS = 10


def _register_param_types() -> None:
    """torch.export serializes a NamedTuple of the inputs only when it is
    registered with a name; register every parameter container once."""
    from qwen3tts_tpu_torch.models.code_predictor import CodePredictorParams
    from qwen3tts_tpu_torch.models.talker import PrefillInputs, TalkerParams
    from qwen3tts_tpu_torch.models.transformer_core import BlockParams
    from qwen3tts_tpu_torch.models.vocoder import (ConvNeXtParams, DecoderBlockParams,
                                                   PreTfmBlockParams, ResBlockParams,
                                                   VocoderParams)
    from qwen3tts_tpu_torch.ops.quant import QuantLinear, QuantLinear4

    for t in (BlockParams, TalkerParams, CodePredictorParams, PrefillInputs, VocoderParams,
              PreTfmBlockParams, ConvNeXtParams, DecoderBlockParams, ResBlockParams,
              QuantLinear, QuantLinear4, decode_loop.GenerateResult):
        if t not in pytree.SUPPORTED_NODES:
            pytree._register_namedtuple(t, serialized_type_name=f"qwen3tts_tpu_torch.{t.__name__}")


@dataclasses.dataclass(frozen=True)
class ExportSpec:
    """What a set of programs was exported with (``export.json``)."""
    frames: int
    text_bucket: int
    kv_capacity: int
    fused_talker: bool
    fused_cp: bool
    temperature: float
    top_k: int
    top_p: float
    repetition_penalty: float
    allow_eos: bool


class Programs(NamedTuple):
    prefill: object     # callables: the exported programs' modules
    frame: object
    vocoder: object
    spec: ExportSpec


def _sampling(spec: ExportSpec, tcfg):
    """(samp, cb0_kw) of decode_loop.generate_chunk for spec's sampling."""
    greedy, use_top_p = sampling_flags(spec.temperature, spec.top_p)
    samp = dict(temperature=spec.temperature, top_p=spec.top_p, top_k=spec.top_k,
                greedy=greedy, use_top_p=use_top_p)
    cb0_kw = dict(samp, suppress_start=tcfg.codec_vocab_size - tcfg.n_suppressed_tail,
                  eos_id=tcfg.codec_eos_id if spec.allow_eos else -1)
    return samp, cb0_kw


class PrefillProgram(torch.nn.Module):
    """(tp, tokens [Tb], n_tokens, speaker_embd [H], language_id, keys [1, 2])
    -> (kv [L, 2, Hkv, kv_capacity, D], last hidden [H], cb0 [1] int64,
    trailing [Trb, H]): generate_init's prefill and frame 0's cb0, drawn
    with keys[0] (split(key, 3)[1]); n_tokens and language_id are int64
    scalars."""

    def __init__(self, tcfg, spec: ExportSpec):
        super().__init__()
        self.tcfg, self.spec = tcfg, spec

    def forward(self, tp, tokens, n_tokens, speaker_embd, language_id, keys):
        tcfg = self.tcfg
        _, cb0_kw = _sampling(self.spec, tcfg)
        pre = talker_model.build_prefill(tp, tcfg, tokens[None], n_tokens, speaker_embd[None],
                                         language_id)
        kv = make_kv_cache(tcfg, self.spec.kv_capacity, tp.codec_embd.dtype,
                           tp.codec_embd.device)
        last_hidden, logits = talker_model.talker_prefill(tp, tcfg, pre.prefill_embd[0], kv)
        cb0 = decode_loop.sample_cb0(logits[None], keys, **cb0_kw)
        return kv, last_hidden, cb0, pre.trailing[0]


class FrameProgram(torch.nn.Module):
    """(tp, cp, kv, seen, last_hidden, cb0 [1] int64, trailing_row [H],
    n_past, k1_seed, k2_seed, keys [S + 1, 2]) -> (codes [16] int64,
    hidden, next cb0): one ``decode_loop.frame_step``, kv and seen updated
    in place. k1_seed / k2_seed are K1's and K2's seeds on the fused route;
    keys holds the unfused route's threefry keys (int64), the S = 15 code
    keys of k_cp (``code_predictor.code_keys``) and the next frame's k_cb0;
    the other route's operands are ignored."""

    def __init__(self, tcfg, ccfg, spec: ExportSpec):
        super().__init__()
        self.tcfg, self.ccfg, self.spec = tcfg, ccfg, spec

    def forward(self, tp, cp, kv, seen, last_hidden, cb0, trailing_row, n_past, k1_seed,
                k2_seed, keys):
        spec, S = self.spec, self.ccfg.n_steps
        samp, cb0_kw = _sampling(spec, self.tcfg)
        return decode_loop.frame_step(
            tp, cp, self.tcfg, self.ccfg, last_hidden, cb0, kv, seen, trailing_row, n_past,
            k1_seed if spec.fused_talker else keys[S:],
            k2_seed if spec.fused_cp else keys[None, :S], fused_talker=spec.fused_talker, fused_cp=spec.fused_cp, samp=samp, cb0_kw=cb0_kw,
            repetition_penalty=spec.repetition_penalty)


class VocoderProgram(torch.nn.Module):
    """(vp, codes [frames, 16], n) -> waveform [frames * 1920]:
    ``vocoder_forward`` with n (an int64 scalar) valid frames."""

    def __init__(self, vcfg):
        super().__init__()
        self.vcfg = vcfg

    def forward(self, vp, codes, n):
        return vocoder_forward(vp, self.vcfg, codes, n)


def build_pipeline(tiny: bool, device, quant=None, seed: int = 0):
    """A Qwen3TTS of the exported config (``PipelineConfig()``, or the
    float32 tiny config) in weight tier `quant` (``RuntimeConfig.quant``:
    None keeps the compute dtype, the bf16 tier at full size) on synthetic
    weights seeded by `seed`."""
    from qwen3tts_tpu_torch.config import PipelineConfig, tiny_pipeline_config
    from qwen3tts_tpu_torch.pipeline import Qwen3TTS

    cfg = tiny_pipeline_config() if tiny else PipelineConfig()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, quant=quant))
    tts = Qwen3TTS(cfg, device=device)
    if not tts.load_models(None, synthetic=True, seed=seed):
        raise RuntimeError(tts.error_msg)
    return tts


def build_programs(frames: int, text_bucket: int, tiny: bool, *, device="cuda", quant=None,
                   tts=None, temperature: float = 0.9, top_k: int = 50, top_p: float = 1.0,
                   repetition_penalty: float = 1.05, allow_eos: bool = True,
                   fused_talker="auto", fused_cp="auto"):
    """({name: (module, example args)} of the three programs, their
    ExportSpec), on the parameters of `tts` (a loaded Qwen3TTS), or of
    build_pipeline(tiny, device, quant). The JAX tool's sampling
    (temperature 0.9, top-k 50, penalty 1.05) by default; the route is
    resolved on the parameters as the decode loop resolves it."""
    tts = tts if tts is not None else build_pipeline(tiny, device, quant)
    tp, cp, vp = tts.talker_params, tts.cp_params, tts.vocoder_params
    tcfg, ccfg, vcfg = tts.config.talker, tts.config.code_predictor, tts.config.vocoder
    spec = ExportSpec(
        frames=frames, text_bucket=text_bucket,
        kv_capacity=-(-(PREFILL_ROWS + frames + 8) // 256) * 256,
        fused_talker=decode_loop.resolve_fused_talker(fused_talker, tp),
        fused_cp=decode_loop.resolve_fused_cp(fused_cp, cp), temperature=float(temperature),
        top_k=int(top_k), top_p=float(top_p), repetition_penalty=float(repetition_penalty),
        allow_eos=bool(allow_eos))
    dev, dtype = tp.codec_embd.device, tp.codec_embd.dtype
    i64 = dict(dtype=torch.int64, device=dev)
    H = tcfg.hidden_size
    pre_args = (tp, torch.zeros((text_bucket,), **i64), torch.tensor(10, **i64),
                torch.zeros((H,), dtype=torch.float32, device=dev),
                torch.tensor(tcfg.english_language_id, **i64), torch.zeros((1, 2), **i64))
    frame_args = (tp, cp, make_kv_cache(tcfg, spec.kv_capacity, dtype, dev),
                  torch.zeros((tcfg.codec_vocab_size,), dtype=torch.int8, device=dev),
                  torch.zeros((H,), dtype=dtype, device=dev), torch.zeros((1,), **i64),
                  torch.zeros((H,), dtype=dtype, device=dev), PREFILL_ROWS, EXAMPLE_SEED,
                  EXAMPLE_SEED + 1, torch.zeros((ccfg.n_steps + 1, 2), **i64))
    voc_args = (vp, torch.zeros((frames, vcfg.n_codebooks), **i64), torch.tensor(frames, **i64))
    return {
        "prefill": (PrefillProgram(tcfg, spec), pre_args),
        "frame": (FrameProgram(tcfg, ccfg, spec), frame_args),
        "vocoder": (VocoderProgram(vcfg), voc_args),
    }, spec


def _dynamic_shapes(name, args):
    """Every tensor static; the frame's n_past and seeds dynamic ints."""
    shapes = [pytree.tree_map(lambda _: None, a) for a in args]
    if name == "frame":
        shapes[7:10] = [Dim.DYNAMIC] * 3
    return tuple(shapes)


@contextlib.contextmanager
def _no_stack_traces():
    """Trace without recording each node's Python stack: about a fifth of
    the tracing time and of the file, and nothing the programs run."""
    cfg = torch.fx.config
    saved = getattr(cfg, "do_not_emit_stack_traces", None)
    cfg.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        cfg.do_not_emit_stack_traces = saved


@contextlib.contextmanager
def _memoized_type_hints():
    """torch.export.load rebuilds each node of a graph from JSON and asks
    ``typing.get_type_hints`` of the schema class of every object it
    rebuilds, hundreds of thousands of times for one program; the answers
    depend on the class alone, so they are memoized while loading (2.5x
    faster on a graph of 6,000 nodes)."""
    hints, memo = typing.get_type_hints, {}

    def memoized(obj, globalns=None, localns=None, include_extras=False):
        key = (obj, id(globalns), id(localns), include_extras)
        if key not in memo:
            memo[key] = hints(obj, globalns, localns, include_extras)
        return memo[key]

    typing.get_type_hints = memoized
    try:
        yield
    finally:
        typing.get_type_hints = hints


def export_program(name, module, args):
    """torch.export of one program (grad off), its example inputs dropped."""
    with torch.no_grad(), _no_stack_traces():
        ep = torch.export.export(module, args, dynamic_shapes=_dynamic_shapes(name, args))
    ep.example_inputs = None
    return ep


def save_programs(out_dir: str, programs: dict, spec: ExportSpec) -> dict:
    """Export build_programs' programs into out_dir (``<name>.pt2``, and
    ``export.json`` for the spec); returns {name: bytes}."""
    _register_param_types()
    os.makedirs(out_dir, exist_ok=True)
    sizes = {}
    for name, (module, args) in programs.items():
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(export_program(name, module, args), path)
        sizes[name] = os.path.getsize(path)
    with open(os.path.join(out_dir, SPEC_FILE), "w") as f:
        json.dump(dataclasses.asdict(spec), f)
    return sizes


def do_export(out_dir: str, frames: int, text_bucket: int, tiny: bool, **kw) -> dict:
    """Export the three programs into out_dir; returns {name: bytes}. kw:
    build_programs'."""
    sizes = save_programs(out_dir, *build_programs(frames, text_bucket, tiny, **kw))
    for name, size in sizes.items():
        print(f"exported {name}: {size / 1e6:.3f} MB -> {os.path.join(out_dir, name)}.pt2")
    return sizes


def load_spec(out_dir: str) -> ExportSpec:
    with open(os.path.join(out_dir, SPEC_FILE)) as f:
        return ExportSpec(**json.load(f))


def load_programs(out_dir: str) -> Programs:
    """The programs of out_dir as callables (None for a program not saved
    there), and their ExportSpec."""
    _register_param_types()
    mods = []
    with _memoized_type_hints():
        for name in PROGRAMS:
            path = os.path.join(out_dir, f"{name}.pt2")
            mods.append(torch.export.load(path).module() if os.path.exists(path) else None)
    return Programs(*mods, load_spec(out_dir))


def run_generate(programs: Programs, tp, cp, tokens, n_tokens, speaker_embd, language_id, key,
                 *, talker_cfg) -> decode_loop.GenerateResult:
    """The host driver of the exported programs: generate_init's key chain
    and prefill, then generate_chunk's loop (the EOS check, the frame's keys
    from ``decode_loop.frame_draws``) over the ``frame`` program, up to the
    spec's frames. Returns what ``decode_loop.generate_from_tokens`` returns
    on the same inputs with the spec's route and sampling. tokens [Tb]
    padded ids with n_tokens real ones; key: the request's threefry key."""
    spec = programs.spec
    fused_talker, fused_cp = spec.fused_talker, spec.fused_cp
    dev, dtype = tp.codec_embd.device, tp.codec_embd.dtype
    i64 = dict(dtype=torch.int64, device=dev)
    key = prng.key_pair(key)
    key_next, k_cb0, _ = prng.split(key, 3)
    with torch.no_grad():
        kv, last_hidden, cb0_next, trailing = programs.prefill(
            tp, torch.as_tensor(tokens).to(**i64), torch.tensor(int(n_tokens), **i64),
            torch.as_tensor(speaker_embd, dtype=torch.float32).to(dev),
            torch.tensor(int(language_id), **i64), torch.tensor([k_cb0], **i64))
        Trb, n_past = trailing.shape[0], PREFILL_ROWS
        chain = key_next if fused_talker else key
        draws = decode_loop.frame_draws(chain, fused_cp, fused_talker)
        seen = torch.zeros((talker_cfg.codec_vocab_size,), dtype=torch.int8, device=dev)
        codes = torch.zeros((spec.frames, talker_cfg.n_codebooks), **i64)
        hidden = torch.zeros((spec.frames, talker_cfg.hidden_size), dtype=dtype, device=dev)
        S = cp.heads.shape[0]
        # the unfused route's keys when it samples (module docstring), else zeros
        host_keys = not (fused_talker and fused_cp) and not sampling_flags(
            spec.temperature, spec.top_p)[0]
        keys = torch.zeros((S + 1, 2), **i64)
        n = 0
        while n < spec.frames:
            cb0 = cb0_next.reshape(1).to(torch.int64)
            if spec.allow_eos and int(cb0) == talker_cfg.codec_eos_id:
                break
            chain, cb0_draw, cp_draw = draws
            if not fused_talker:
                draws = decode_loop.frame_draws(chain, fused_cp, fused_talker)
                cb0_draw = draws[1]
            if host_keys:
                k = np.zeros((S + 1, 2), np.int64)
                if not fused_cp:
                    k[:S] = code_keys(prng.key_array(cp_draw).reshape(1, 2), S)[0]
                if not fused_talker:
                    k[S] = cb0_draw
                keys = prng.to_device(k, dev)
            hidden[n] = last_hidden.to(dtype)
            codes[n], last_hidden, cb0_next = programs.frame(
                tp, cp, kv, seen, last_hidden, cb0, trailing[min(n, Trb - 1)], n_past,
                cb0_draw if fused_talker else 0, cp_draw if fused_cp else 0, keys)
            if fused_talker:
                draws = decode_loop.frame_draws(chain, fused_cp, fused_talker)
            n += 1
            n_past += 1
    return decode_loop.GenerateResult(codes[:n], n, hidden[:n])


def run_vocoder(programs: Programs, vp, codes, n):
    """The ``vocoder`` program on codes [frames, 16] (padded to the spec's
    frames) with n valid frames, in full float32 (``full_float32``)."""
    with full_float32(), torch.no_grad():
        return programs.vocoder(vp, codes, torch.tensor(int(n), dtype=torch.int64,
                                                        device=codes.device))


def do_check(out_dir: str, frames: int, text_bucket: int, tiny: bool, *, device="cuda",
             quant=None) -> dict:
    """Reload the programs of out_dir and run them on freshly built seeded
    parameters (build_pipeline's seed 0): one request of the JAX tool's
    arguments (zero tokens, n_tokens 10, the default voice, English, key
    prng_key(0)) and its codes through the vocoder. Returns {name: first
    output's shape}."""
    spec = load_spec(out_dir)
    if (spec.frames, spec.text_bucket) != (frames, text_bucket):
        raise ValueError(f"{out_dir} holds programs of {spec.frames} frames and a text bucket "
                         f"of {spec.text_bucket}, not {frames} and {text_bucket}")
    programs = load_programs(out_dir)
    tts = build_pipeline(tiny, device, quant)
    tp, cp, vp = tts.talker_params, tts.cp_params, tts.vocoder_params
    tcfg = tts.config.talker
    res = run_generate(programs, tp, cp, torch.zeros((text_bucket,), dtype=torch.int64), 10,
                       torch.zeros((tcfg.hidden_size,)), tcfg.english_language_id,
                       prng.prng_key(0), talker_cfg=tcfg)
    padded = torch.zeros((frames, tcfg.n_codebooks), dtype=torch.int64, device=tts.device)
    padded[:res.n_frames] = res.codes
    audio = run_vocoder(programs, vp, padded, res.n_frames)
    shapes = {"prefill+frame": tuple(res.codes.shape), "vocoder": tuple(audio.shape)}
    for name, shape in shapes.items():
        print(f"{name}: reloaded + executed, first shape {shape}")
    return shapes


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="exported")
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--text-bucket", type=int, default=64)
    ap.add_argument("--tiny", action="store_true", help="tiny config (self-test)")
    ap.add_argument("--check", action="store_true", help="reload + run instead of export")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.check:
        do_check(args.out, args.frames, args.text_bucket, args.tiny, device=args.device)
    else:
        do_export(args.out, args.frames, args.text_bucket, args.tiny, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
