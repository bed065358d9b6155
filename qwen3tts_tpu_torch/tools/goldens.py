"""What the port's golden tools share (``make_goldens``, ``verify_stage``,
``compare_e2e``, ``debug_dump``; counterparts of the JAX package's
``tools/`` scripts of those names): the pipeline they build, the golden
directory they read (``det_*.bin`` + ``det_metadata.json``, the format of
the reference's generate_deterministic_reference.py, which both packages
write and read), and the two teacher-forced checks of a golden run.

The tools run ``Qwen3TTS`` at ``RuntimeConfig(dtype="float32")`` (or the
tiny config) on the card unless ``--device cpu``, with ``fused_talker=False``
(``TOOL_FLAGS``): the JAX tools' unfused step. So the card runs
``talker_step`` and ``predict_codes`` (the code-predictor kernel takes int8
blocks only), with K3 in the vocoder and the decode-attention kernel from C
= 1024 on; the CPU runs the plain versions. ``route`` reports it, and the
route of a pipeline with the default flags: K1 in its "f32" mode over a
float32 cache and head (``chip_smoke.parity_fullsize`` holds both routes to
the same bars).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..config import PipelineConfig, RuntimeConfig, tiny_pipeline_config
from ..models import talker as talker_model
from ..models.transformer_core import forward_prefill, forward_step
from ..ops.fused_talker_step import weight_mode
from ..ops.norms import rms_norm
from ..ops.precision import full_float32
from ..ops.sampling import sample_token
from ..pipeline import Qwen3TTS
from ..runtime import decode_loop

# the golden run's sampling: greedy, with the repetition penalty the
# JAX tools pass (make_goldens.py, verify_stage.py)
REPETITION_PENALTY = 1.05
N_CODEBOOKS = 16
# the pipeline flags of the tools' runs: the unfused talker step
TOOL_FLAGS = dict(fused_talker=False)


def add_model_args(ap) -> None:
    """The JAX tools' model flags, and --device."""
    ap.add_argument("--model", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="tiny config (harness self-test)")
    ap.add_argument("--device", default="cuda", help="torch device (default: the card)")


def pipeline_config(tiny: bool) -> PipelineConfig:
    return tiny_pipeline_config() if tiny else PipelineConfig(
        runtime=RuntimeConfig(dtype="float32"))


def load_pipeline(args) -> Qwen3TTS:
    """Qwen3TTS at the tools' config with the model (or synthetic weights
    from args.seed) loaded; raises RuntimeError with its error_msg."""
    tts = Qwen3TTS(pipeline_config(args.tiny), args.device, **TOOL_FLAGS)
    if not tts.load_models(args.model, synthetic=args.synthetic or args.model is None,
                           seed=args.seed):
        raise RuntimeError(tts.error_msg)
    return tts


def prefill_bucket(n_tokens: int, tiny: bool) -> int:
    """The JAX tools' prefill bucket: 16 at the tiny config, else the power
    of two above n_tokens (at least 16)."""
    return 16 if tiny else max(16, int(2 ** np.ceil(np.log2(n_tokens + 1))))


def build_prefill(tts: Qwen3TTS, tokens, speaker, language_id: int, tiny: bool):
    """(PrefillInputs, tts_pad_embd [H]) of the tools' bucket."""
    padded = np.zeros((prefill_bucket(len(tokens), tiny),), np.int64)
    padded[:len(tokens)] = tokens
    tp, tcfg = tts.talker_params, tts.config.talker
    with torch.no_grad():
        pre = talker_model.build_prefill(
            tp, tcfg, torch.from_numpy(padded), len(tokens),
            torch.as_tensor(np.asarray(speaker, np.float32), device=tts.device),
            language_id)
        pad = talker_model.project_text_tokens(
            tp, torch.tensor([tcfg.tts_pad_token_id], device=tts.device))[0]
    return pre, pad


def host(t) -> np.ndarray:
    return t.float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Goldens:
    """A golden directory: meta (det_metadata.json) and bin(name, dtype),
    None for a file that is not there."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "det_metadata.json")) as f:
            self.meta = json.load(f)

    def bin(self, name: str, dtype) -> Optional[np.ndarray]:
        p = os.path.join(self.path, name)
        return np.fromfile(p, dtype) if os.path.exists(p) else None

    def codes(self) -> np.ndarray:
        return self.bin("det_speech_codes.bin", np.int64).reshape(-1, N_CODEBOOKS)

    def speaker(self, hidden_size: int) -> np.ndarray:
        s = self.bin("det_speaker_embedding.bin", np.float32)
        return np.zeros((hidden_size,), np.float32) if s is None else s


def route(tts: Qwen3TTS) -> dict:
    """The route a synthesis of tts takes: dtype, the talker's weights,
    whether the talker and code-predictor kernels run (tts's flags, "auto"
    resolved on its params) and the talker kernel's weight mode when it
    runs ("f32" on the float32 tier's weights, ``weight_mode``)."""
    blocks = tts.talker_params.blocks
    fused_talker = decode_loop.resolve_fused_talker(tts.fused["fused_talker"],
                                                    tts.talker_params)
    w = blocks.wqkv
    return dict(dtype=tts.config.runtime.dtype, device=str(tts.device),
                talker_weights=str(w.dtype) if isinstance(w, torch.Tensor) else type(w).__name__,
                fused_talker=fused_talker,
                fused_cp=decode_loop.resolve_fused_cp(tts.fused["fused_cp"], tts.cp_params),
                kernel_weight_mode=str(weight_mode(blocks)) if fused_talker else None)


def _cp_teacher_forced(cp, ccfg, hidden, cb0_embd, rest) -> torch.Tensor:
    """The code predictor's greedy code s (s = 1..15) of one frame with the
    golden codes 1..s-1 fed back (``predict_codes`` with its own draws
    replaced by the golden ones): int64 [15]."""
    dt, dev = cp.embds.dtype, cp.embds.device
    kv = torch.zeros((1, ccfg.n_layers, 2, ccfg.n_kv_heads, ccfg.max_ctx, ccfg.head_dim),
                     dtype=dt, device=dev)

    def greedy(h, s):
        h = rms_norm(h, cp.output_norm, ccfg.rms_norm_eps)
        logits = torch.matmul(h.float(), cp.heads[s].float()).to(h.dtype).float()
        return sample_token(logits, None, temperature=0.0, top_k=0, greedy=True,
                            use_top_p=False)

    x = torch.stack([hidden, cb0_embd])[None].to(dt)
    h = forward_prefill(cp.blocks, ccfg, x, torch.arange(2, device=dev), kv, 0)
    out = [greedy(h[:, -1], 0)]
    for s in range(1, ccfg.n_steps):
        emb = cp.embds[s - 1, rest[s - 1]][None]
        out.append(greedy(forward_step(cp.blocks, ccfg, emb, s + 1, kv), s))
    return torch.cat(out)


def teacher_forced(tts: Qwen3TTS, goldens: Goldens) -> dict:
    """The golden codes fed to tts's talker and code predictor (unfused, in
    the params' dtype): for each frame f, the greedy cb0 of the logits
    before it (the prefill's at f = 0; suppression and the repetition
    penalty over the golden cb0 of frames < f, as the loop applies them),
    and the code predictor's greedy code s given the golden codes < s.
    Returns the share of frames whose prediction equals the golden code,
    per codebook, with the frame-exact share."""
    cfg = tts.config
    tcfg, ccfg = cfg.talker, cfg.code_predictor
    tp, cp = tts.talker_params, tts.cp_params
    dev, dtype = tp.codec_embd.device, tp.codec_embd.dtype
    meta = goldens.meta
    want = torch.as_tensor(goldens.codes(), device=dev)
    tokens = goldens.bin("det_text_tokens.bin", np.int64).ravel()
    padded, n_tok = tts._fit_tokens(list(tokens))
    Vc, F = tcfg.codec_vocab_size, want.shape[0]
    lang = meta["token_ids"]["language_id"]
    hits = torch.zeros((N_CODEBOOKS,), dtype=torch.int64, device=dev)
    frame_hits = 0
    with torch.no_grad(), full_float32():
        pre = talker_model.build_prefill(
            tp, tcfg, torch.from_numpy(padded), n_tok,
            torch.as_tensor(goldens.speaker(tcfg.hidden_size), device=dev), lang,
            nothink=lang < 0)
        P, Trb = pre.prefill_embd.shape[0], pre.trailing.shape[0]
        kv = talker_model.make_kv_cache(tcfg, P + F, dtype, dev)
        hidden, logits = talker_model.talker_prefill(tp, tcfg, pre.prefill_embd, kv)
        seen = torch.zeros((Vc,), dtype=torch.int8, device=dev)
        for f in range(F):
            cb0 = decode_loop.sample_cb0(
                logits[None], None, suppress_start=Vc - tcfg.n_suppressed_tail,
                eos_id=tcfg.codec_eos_id, temperature=0.0, top_k=0, top_p=1.0, greedy=True,
                use_top_p=False, seen=seen[None] if f else None,
                repetition_penalty=REPETITION_PENALTY)
            cb0_embd = tp.codec_embd[want[f, 0]]
            rest = _cp_teacher_forced(cp, ccfg, hidden.to(dtype), cb0_embd, want[f, 1:])
            got = torch.cat([cb0.reshape(1), rest])
            hits += got == want[f]
            frame_hits += bool((got == want[f]).all())
            seen[want[f, 0]] = 1
            step = (cb0_embd.float() + decode_loop._rest_embd_sum(cp, want[f, 1:])
                    + pre.trailing[min(f, Trb - 1)].float()).to(dtype)
            hidden, logits = talker_model.talker_step(tp, tcfg, step, P + f, kv)
    per_cb = (hits.double() / max(F, 1)).tolist()
    return dict(frames=F, per_codebook=per_cb, cb0=per_cb[0],
                cb1_15=float(np.mean(per_cb[1:])), frame_exact=frame_hits / max(F, 1))


def vocode_goldens(tts: Qwen3TTS, goldens: Goldens) -> dict:
    """The golden codes through tts's vocoder (``decode_codes``: K3 in every
    res block on the card) against det_decoded_audio.bin: the maximum and
    RMS error over the common samples, and their correlation."""
    got = tts.decode_codes(goldens.codes())
    want = goldens.bin("det_decoded_audio.bin", np.float32)
    n = min(len(got), len(want))
    d = got[:n].astype(np.float64) - want[:n].astype(np.float64)
    return dict(samples=n, lengths_equal=len(got) == len(want),
                max_abs_err=float(np.abs(d).max()) if n else 0.0,
                rms_err=float(np.sqrt(np.mean(d ** 2))) if n else 0.0,
                want_rms=float(np.sqrt(np.mean(want[:n].astype(np.float64) ** 2))) if n else 0.0)
