"""The port's checkpoint path against the JAX package's, at the tiny config:
the safetensors and GGUF readers and writers in both directions, the
HF <-> GGML name contract, the Q8_0 and Q4_K bytes, the loaders leaf by leaf
(bit for bit, from safetensors and from f16 and q8_0 GGUF files), the
config readers, and the pipeline's lifecycle (from_pretrained, load_models
of a GGUF directory, unload, low_mem, the progress callback, and greedy
codes equal to the JAX fused path's with the default and a cloned voice).

The checkpoint is the port's ``tools/hf_fixture.py`` directory (TTS model in
BF16, tokenizer model in float32); the GGUF files come from the JAX
package's ``tools/convert_hf_to_gguf.py``."""

from __future__ import annotations

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import hf_fixture as jax_fixture
from qwen3tts_tpu import pipeline as jpipeline
from qwen3tts_tpu.config import tiny_pipeline_config as jax_tiny
from qwen3tts_tpu.io import config_io as jconfig_io
from qwen3tts_tpu.io import gguf as jgguf
from qwen3tts_tpu.io import loader as jloader
from qwen3tts_tpu.io import safetensors_io as jst
from qwen3tts_tpu.io import tensor_names as jnames
from qwen3tts_tpu.io.gguf_checkpoint import GGUFCheckpoint as JGGUFCheckpoint
from qwen3tts_tpu.runtime import decode_loop as jdl
from qwen3tts_tpu.runtime.buckets import pick_bucket
from qwen3tts_tpu_torch.config import SamplingConfig
from qwen3tts_tpu_torch.config import tiny_pipeline_config as port_tiny
from qwen3tts_tpu_torch.io import config_io, gguf, loader, safetensors_io, tensor_names
from qwen3tts_tpu_torch.io.from_jax import params_from_jax
from qwen3tts_tpu_torch.io.gguf_checkpoint import GGUFCheckpoint
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.text.bpe import synthetic_tokenizer
from qwen3tts_tpu_torch.tools import hf_fixture

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import convert_hf_to_gguf  # noqa: E402

JCFG, PCFG = jax_tiny(), port_tiny()


def _int8(cfg):
    return dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, quant="int8"))


JCFG8, PCFG8 = _int8(JCFG), _int8(PCFG)
TEXT = "Hello there, port."
REF_SAMPLES = 800   # below the tiny config's largest speaker bucket (1024)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """root (the safetensors directory) and the f16 and q8_0 GGUF directories
    the JAX converter writes from it."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    tts_dir, tok_dir = hf_fixture.write_checkpoint_dir(root, PCFG)
    dirs = {"safetensors": root}
    for kind in ("f16", "q8_0"):
        d = str(tmp_path_factory.mktemp(f"gguf_{kind}"))
        convert_hf_to_gguf.convert(tts_dir, os.path.join(d, f"qwen3-tts-0.6b-{kind}.gguf"),
                                   kind, "tts")
        convert_hf_to_gguf.convert(tok_dir, os.path.join(d, f"qwen3-tts-tokenizer-{kind}.gguf"),
                                   kind, "tokenizer")
        dirs[f"gguf_{kind}"] = d
    return dirs


def _readers(ckpt, source):
    """(JAX reader, port reader) of the main model and of the tokenizer."""
    d = ckpt[source]
    if source == "safetensors":
        paths = [os.path.join(d, hf_fixture.TTS_DIR), os.path.join(d, hf_fixture.TOKENIZER_DIR)]
        return [(jloader.open_checkpoint_dir(p), loader.open_checkpoint_dir(p)) for p in paths]
    kind = source.split("_", 1)[1]
    paths = [os.path.join(d, f"qwen3-tts-0.6b-{kind}.gguf"),
             os.path.join(d, f"qwen3-tts-tokenizer-{kind}.gguf")]
    return [(JGGUFCheckpoint(p), GGUFCheckpoint(p)) for p in paths]


def _to_port(jax_params):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params))


def _assert_leaves_equal(got, want, where=""):
    """Every leaf of two port params trees equal, dtype and bits."""
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert torch.equal(got, want), where
        return
    assert type(got) is type(want) and len(got) == len(want), where
    names = getattr(want, "_fields", range(len(want)))
    for name, g, w in zip(names, got, want):
        _assert_leaves_equal(g, w, f"{where}.{name}")


# ---------------------------------------------------------------------------
# readers and writers
# ---------------------------------------------------------------------------

def _st_arrays():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(5, 7)).astype(np.float32)
    return {"f32": f32, "i64": rng.integers(-2**40, 2**40, size=(11,)),
            "bf16": rng.normal(size=(3, 4, 5)).astype(ml_dtypes.bfloat16)}


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_safetensors_round_trip(tmp_path, writer):
    """F32, I64 and BF16 written by one package read back by the other, bits
    equal (BF16 stays bfloat16 on the port's side: never widened)."""
    arrays = _st_arrays()
    path = str(tmp_path / "x.safetensors")
    if writer == "jax":
        jst.write_safetensors(path, arrays)
        got = safetensors_io.SafetensorsDir(str(tmp_path))
        assert got.tensor("bf16").dtype == torch.bfloat16
        assert got.shape("bf16") == (3, 4, 5)
    else:
        safetensors_io.write_safetensors(path, {
            k: torch.from_numpy(v.view(np.int16)).view(torch.bfloat16) if k == "bf16"
            else torch.from_numpy(v) for k, v in arrays.items()})
        got = jst.SafetensorsDir(str(tmp_path))
    for k, v in arrays.items():
        g = got.tensor(k)
        assert tuple(g.shape) == v.shape
        np.testing.assert_array_equal(_bits(g), _bits(v))


@pytest.mark.parametrize("make", [jax_fixture.make_tts_checkpoint,
                                  jax_fixture.make_tokenizer_checkpoint])
def test_name_contract_matches_jax(make):
    """hf_to_ggml, should_quantize_q8 and is_ffn_projection give the JAX
    package's answers for every fixture name."""
    for name in make(JCFG):
        g = tensor_names.hf_to_ggml(name)
        assert g == jnames.hf_to_ggml(name), name
        if g is not None:
            assert tensor_names.should_quantize_q8(g) == jnames.should_quantize_q8(g)
            assert tensor_names.is_ffn_projection(g) == jnames.is_ffn_projection(g)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_k"])
def test_quantized_bytes_match_jax(fmt):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 512)).astype(np.float32)
    x[0, :32] = 0.0   # an all-zero block
    quant = getattr(gguf, f"quantize_{fmt}")
    deq = getattr(gguf, f"dequantize_{fmt}")
    buf = quant(x)
    assert buf == getattr(jgguf, f"quantize_{fmt}")(x)
    np.testing.assert_array_equal(deq(buf, x.shape),
                                  getattr(jgguf, f"dequantize_{fmt}")(buf, x.shape))


def _gguf_tensors():
    rng = np.random.default_rng(4)
    return {"a": (rng.normal(size=(6, 32)).astype(np.float32), gguf.GGML_F32),
            "b": (rng.normal(size=(4, 64)).astype(np.float32), gguf.GGML_Q8_0),
            "c": (rng.normal(size=(33,)).astype(np.float32), gguf.GGML_F16),
            "d": (rng.normal(size=(2, 256)).astype(np.float32), gguf.GGML_Q4_K)}


def _write_gguf(mod, path):
    w = mod.GGUFWriter("test-arch")
    w.add_meta("test.n", gguf.T_U32, 42)
    w.add_meta("test.list", (gguf.T_ARR, gguf.T_STR), ["x", "yz"])
    for name, (a, t) in _gguf_tensors().items():
        w.add_tensor(name, a, ttype=t)
    w.write(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gguf_cross_read(tmp_path, writer):
    """A GGUF file written by either package is read by the other: metadata,
    shapes and F32/F16/Q8_0/Q4_K tensors as the writer's own reader reads
    them; both writers write the same bytes."""
    mods = {"jax": jgguf, "port": gguf}
    other = mods["port" if writer == "jax" else "jax"]
    path, path2 = str(tmp_path / "t.gguf"), str(tmp_path / "u.gguf")
    _write_gguf(mods[writer], path)
    r, own = other.GGUFReader(path), mods[writer].GGUFReader(path)
    assert r.metadata == own.metadata
    assert r.metadata["test.n"] == 42 and r.metadata["test.list"] == ["x", "yz"]
    for name, (a, _) in _gguf_tensors().items():
        np.testing.assert_array_equal(r.tensor(name), own.tensor(name))
        assert r.tensor(name).shape == a.shape
    _write_gguf(other, path2)
    with open(path, "rb") as f1, open(path2, "rb") as f2:
        assert f1.read() == f2.read()


def test_fixture_names_and_shapes_match_jax_fixture():
    for jmake, pmake in ((jax_fixture.make_tts_checkpoint, hf_fixture.make_tts_checkpoint),
                         (jax_fixture.make_tokenizer_checkpoint,
                          hf_fixture.make_tokenizer_checkpoint)):
        want, got = jmake(JCFG), pmake(PCFG)
        assert list(got) == list(want)
        assert all(tuple(got[k].shape) == want[k].shape for k in want)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

PARTS = {
    "talker": (0, "load_talker", "talker"),
    "code_predictor": (0, "load_code_predictor", "code_predictor"),
    "speaker_encoder": (0, "load_speaker_encoder", "speaker_encoder"),
    "vocoder": (1, "load_vocoder", "vocoder"),
}


@pytest.mark.parametrize("part", list(PARTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("source", ["safetensors", "gguf_f16", "gguf_q8_0"])
def test_loader_leaves_equal_jax(ckpt, source, dtype, part):
    """Every leaf of the port's loader equals the JAX loader's, bit for bit."""
    which, fn, cfg_name = PARTS[part]
    jst_, pst = _readers(ckpt, source)[which]
    want = getattr(jloader, fn)(jst_, getattr(JCFG, cfg_name), getattr(jnp, dtype))
    got = getattr(loader, fn)(pst, getattr(PCFG, cfg_name), getattr(torch, dtype), device="cpu")
    _assert_leaves_equal(got, _to_port(want), part)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["config_json", "no_config_json", "none"])
def test_config_from_model_dir_matches_jax(ckpt, where):
    d = {"config_json": ckpt["safetensors"], "no_config_json": ckpt["gguf_f16"],
         "none": None}[where]
    got = config_io.config_from_model_dir(d, PCFG.runtime)
    want = jconfig_io.config_from_model_dir(d, JCFG.runtime)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if where == "config_json":
        assert got.talker == PCFG.talker and got.code_predictor == PCFG.code_predictor


@pytest.mark.parametrize("source", ["safetensors", "gguf_q8_0"])
def test_inferred_configs_match_jax(ckpt, source):
    """infer_vocoder_config / infer_speaker_config from shapes alone equal the
    JAX package's, and recover the tiny widths from the default config."""
    (jt, pt), (jv, pv) = _readers(ckpt, source)
    got_v = config_io.infer_vocoder_config(pv, config_io.VocoderConfig())
    got_s = config_io.infer_speaker_config(pt, config_io.SpeakerEncoderConfig())
    assert dataclasses.asdict(got_v) == dataclasses.asdict(jconfig_io.infer_vocoder_config(jv))
    assert dataclasses.asdict(got_s) == dataclasses.asdict(jconfig_io.infer_speaker_config(jt))
    # n_heads comes from config.json only
    assert dataclasses.replace(got_v, n_heads=PCFG.vocoder.n_heads) == PCFG.vocoder
    assert got_s.hidden_dim == PCFG.speaker_encoder.hidden_dim


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipelines(ckpt):
    """The port's and the JAX package's Qwen3TTS at the tiny int8 config,
    each after load_models of the directory."""
    port = Qwen3TTS(PCFG8, device="cpu")
    jax_tts = jpipeline.Qwen3TTS(JCFG8)
    assert port.load_models(ckpt["safetensors"]), port.error_msg
    assert jax_tts.load_models(ckpt["safetensors"]), jax_tts.error_msg
    return port, jax_tts


def test_from_pretrained_equals_jax(ckpt):
    """from_pretrained (config from the directory's config.json files, then
    load_models) gives the JAX package's config and, leaf for leaf, its
    talker, code-predictor and vocoder params (int8 tier)."""
    root = ckpt["safetensors"]
    port = Qwen3TTS.from_pretrained(root, PCFG8.runtime, device="cpu")
    jax_tts = jpipeline.Qwen3TTS.from_pretrained(root, runtime=JCFG8.runtime)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(jax_tts.config)
    assert port.config.talker == PCFG.talker and port.config.vocoder.n_heads == 4
    _assert_leaves_equal(port.talker_params, _to_port(jax_tts.talker_params), "talker")
    _assert_leaves_equal(port.cp_params, _to_port(jax_tts.cp_params), "cp")
    _assert_leaves_equal(port.vocoder_params, _to_port(jax_tts.vocoder_params), "vocoder")
    assert port.is_loaded and port.t_load_ms > 0


def test_tokenizer_comes_from_the_directory(pipelines):
    port, jax_tts = pipelines
    vocab, _ = hf_fixture.fixture_vocab()
    assert port.tokenizer.bos_token_id == vocab["<|im_start|>"] == 256
    assert synthetic_tokenizer(PCFG.talker.text_vocab_size).bos_token_id != 256
    assert port.tokenizer.encode_for_tts(TEXT) == jax_tts.tokenizer.encode_for_tts(TEXT)


def _jax_greedy_codes(jax_tts, speaker, max_frames=8):
    tokens = jax_tts.tokenizer.encode_for_tts(TEXT)
    padded = np.zeros((pick_bucket(len(tokens), JCFG.runtime.prefill_buckets),), np.int32)
    padded[:len(tokens)] = tokens
    gen = jdl.generate_from_tokens(
        jax_tts.talker_params, jax_tts.cp_params, jnp.asarray(padded), jnp.int32(len(tokens)),
        jnp.asarray(speaker, jnp.float32), jnp.int32(JCFG.talker.english_language_id),
        jax.random.PRNGKey(0), talker_cfg=JCFG.talker, cp_cfg=JCFG.code_predictor,
        max_frames=max_frames, kv_capacity=32, temperature=0.0, top_k=50,
        repetition_penalty=1.05, fused_cp=True, fused_talker=True)
    return np.asarray(gen.codes)[:int(gen.n_frames)]


@pytest.mark.parametrize("voice", ["default", "cloned"])
def test_greedy_codes_match_jax_fused_path(pipelines, voice):
    """Greedy codes of from_pretrained + synthesize (the default voice) and
    + synthesize_with_voice (a seeded reference clip) EQUAL the JAX fused
    loop's (interpret mode) on the JAX loader's weights, with the JAX
    pipeline's embedding of the same clip; the two voices' codes differ."""
    port, jax_tts = pipelines
    sp = SamplingConfig(temperature=0.0, max_audio_tokens=8)
    ref = (np.random.default_rng(7).normal(size=REF_SAMPLES) * 0.3).astype(np.float32)
    if voice == "default":
        r = port.synthesize(TEXT, sp)
        speaker = np.zeros((JCFG.talker.hidden_size,), np.float32)
    else:
        r = port.synthesize_with_voice(TEXT, ref, sp)
        speaker = jax_tts.extract_speaker_embedding(ref)
        assert r.timings.t_encode_ms > 0
        other = port.synthesize(TEXT, sp).codes
        assert other.shape != r.codes.shape or (other != r.codes).any()
    assert r.success, r.error_msg
    want = _jax_greedy_codes(jax_tts, speaker)
    assert r.n_frames == len(want) > 0
    np.testing.assert_array_equal(r.codes, want)
    assert len(r.audio) == r.n_frames * PCFG.vocoder.samples_per_frame


@pytest.mark.parametrize("vocab", [True, False])
def test_load_models_of_a_gguf_directory(ckpt, tmp_path, capsys, vocab):
    """A directory of the reference's two GGUF files loads, with the
    tokenizer vocabulary of the main file, or, with none there, the
    synthetic tokenizer and the JAX package's warning; it serves."""
    hf_fixture.write_gguf_dir(ckpt["safetensors"], str(tmp_path), vocab=vocab)
    tts = Qwen3TTS(PCFG8, device="cpu")
    assert tts.load_models(str(tmp_path)), tts.error_msg
    warned = "GGUF file carries no tokenizer vocab" in capsys.readouterr().err
    assert warned is not vocab
    want = 256 if vocab else synthetic_tokenizer(PCFG.talker.text_vocab_size).bos_token_id
    assert tts.tokenizer.bos_token_id == want
    r = tts.synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=4))
    assert r.success and len(r.audio) == r.n_frames * PCFG.vocoder.samples_per_frame


def test_load_models_refuses_a_bad_directory(tmp_path):
    tts = Qwen3TTS(PCFG8, device="cpu")
    assert not tts.load_models(str(tmp_path))
    assert tts.error_msg.startswith("Failed to load models") and not tts.is_loaded


def test_unload_models(ckpt):
    tts = Qwen3TTS(PCFG8, device="cpu")
    assert tts.load_models(ckpt["safetensors"]) and tts.is_loaded
    tts.unload_models()
    assert not tts.is_loaded and tts.talker_params is None and tts.vocoder_params is None
    sp = SamplingConfig(temperature=0.0, max_audio_tokens=4)
    for r in (tts.synthesize(TEXT, sp), tts.synthesize_with_voice(TEXT, np.zeros(800), sp)):
        assert not r.success and r.error_msg == "Models not loaded"


def test_low_mem_gives_the_same_output(ckpt, pipelines):
    """low_mem loads the vocoder lazily and drops the talker after generation
    and the vocoder after decode; codes and audio equal low_mem=False's on
    two requests in a row."""
    port, _ = pipelines
    tts = Qwen3TTS(PCFG8, device="cpu", low_mem=True)
    assert tts.load_models(ckpt["safetensors"])
    assert tts.vocoder_params is None and tts.talker_params is not None
    sp = SamplingConfig(temperature=0.0, max_audio_tokens=6)
    want = port.synthesize(TEXT, sp)
    for _ in range(2):
        r = tts.synthesize(TEXT, sp)
        assert tts.talker_params is None and tts.vocoder_params is None
        np.testing.assert_array_equal(r.codes, want.codes)
        np.testing.assert_array_equal(r.audio, want.audio)


def test_progress_callback_fires_per_frame(pipelines):
    port, _ = pipelines
    calls = []
    port.set_progress_callback(lambda frame, total: calls.append((frame, total)))
    try:
        r = port.synthesize(TEXT, SamplingConfig(temperature=0.0, max_audio_tokens=6))
    finally:
        port.set_progress_callback(None)
    assert r.success and len(calls) >= r.n_frames > 0
    assert all(total == 6 for _, total in calls)
    assert [f for f, _ in calls] == sorted(f for f, _ in calls) and calls[-1][0] == r.n_frames
