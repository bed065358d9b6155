"""The port's native host library (``qwen3tts_tpu_torch/native``, bound by
``io/native.py``) against the port's pure-Python GGUF reader and against
the JAX package's native library (``qwen3tts_tpu/io/native.py``), bit for
bit on the CPU: F32, F16, Q8_0 and Q4_K tensors, the raw Q8_0 arrays, the
PCM16 WAV bytes and the linear resampler; the parser's and the compiler's
messages when they refuse (no quiet fallback); and the GGUF checkpoint
path reading through it, with the loaders' leaves equal to the Python
reader's."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from qwen3tts_tpu.io import native as jnative
from qwen3tts_tpu_torch.config import tiny_pipeline_config
from qwen3tts_tpu_torch.io import gguf, loader, native
from qwen3tts_tpu_torch.io.gguf_checkpoint import GGUFCheckpoint
from qwen3tts_tpu_torch.pipeline import Qwen3TTS
from qwen3tts_tpu_torch.tools import hf_fixture
from torch_continuous_common import one_torch_thread  # noqa: F401 - fixture by name

TYPES = {"f32": gguf.GGML_F32, "f16": gguf.GGML_F16, "q8_0": gguf.GGML_Q8_0,
         "q4_k": gguf.GGML_Q4_K}
SHAPES = {"f32": (6, 32), "f16": (33,), "q8_0": (4, 64), "q4_k": (3, 512)}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.fixture(scope="module")
def gguf_file(tmp_path_factory):
    """A GGUF file of each tensor type (and metadata of several types, an
    all-zero Q8_0 block and a Q4_K block of one value), written by the
    port's writer."""
    rng = np.random.default_rng(7)
    w = gguf.GGUFWriter("test-arch")
    w.add_meta("test.n", gguf.T_U32, 42)
    w.add_meta("test.eps", gguf.T_F32, 1e-6)
    w.add_meta("test.list", (gguf.T_ARR, gguf.T_STR), ["x", "yz"])
    for kind, ttype in TYPES.items():
        a = (rng.normal(size=SHAPES[kind]) * 3).astype(np.float32)
        if kind == "q8_0":
            a[0, :32] = 0.0
        if kind == "q4_k":
            a[1, :256] = 0.25
        w.add_tensor(kind, a, ttype=ttype)
    path = str(tmp_path_factory.mktemp("native") / "t.gguf")
    w.write(path)
    return path


@pytest.mark.parametrize("kind", list(TYPES))
def test_tensor_equals_python_and_jax_readers(gguf_file, kind):
    """NativeGGUF.tensor == GGUFReader.tensor (widened to float32) == the
    JAX NativeGGUF's, bits equal, with the shape and type."""
    got = native.NativeGGUF(gguf_file)
    py = gguf.GGUFReader(gguf_file)
    jx = jnative.NativeGGUF(gguf_file)
    a = got.tensor(kind)
    assert a.dtype == np.float32 and a.shape == SHAPES[kind] == py.shape(kind)
    assert got.tensor_type(kind) == TYPES[kind] == py.tensor_type(kind)
    np.testing.assert_array_equal(_bits(a), _bits(py.tensor(kind)))
    np.testing.assert_array_equal(_bits(a), _bits(jx.tensor(kind)))


def test_keys_and_table_equal_the_jax_reader(gguf_file):
    got, jx = native.NativeGGUF(gguf_file), jnative.NativeGGUF(gguf_file)
    assert list(got.keys()) == list(jx.keys()) == list(TYPES)
    assert got.tensors == jx.tensors


def test_tensor_q8_equals_python_and_jax_readers(gguf_file):
    q, d = native.NativeGGUF(gguf_file).tensor_q8("q8_0")
    pq, pd = gguf.GGUFReader(gguf_file).tensor_q8("q8_0")
    jq, jd = jnative.NativeGGUF(gguf_file).tensor_q8("q8_0")
    assert q.dtype == np.int8 and d.dtype == np.float32 and d.shape == (4, 2)
    np.testing.assert_array_equal(q, pq)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(_bits(d), _bits(pd))
    np.testing.assert_array_equal(_bits(d), _bits(jd))
    assert native.NativeGGUF(gguf_file).tensor_q8("f32") is None


@pytest.mark.parametrize("mangle", ["magic", "truncated", "missing"])
def test_a_file_the_parser_refuses_raises_its_message(gguf_file, tmp_path, mangle):
    with open(gguf_file, "rb") as f:
        data = f.read()
    path = str(tmp_path / "bad.gguf")
    if mangle == "magic":
        data = b"GGUX" + data[4:]
    elif mangle == "truncated":
        data = data[:60]
    if mangle != "missing":
        with open(path, "wb") as f:
            f.write(data)
    want = {"magic": "bad GGUF magic", "missing": "cannot open",
            "truncated": "bad metadata value of general.architecture"}
    with pytest.raises(ValueError, match=want[mangle]):
        native.NativeGGUF(path)


def test_a_truncated_tensor_raises_on_read(gguf_file, tmp_path):
    with open(gguf_file, "rb") as f:
        data = f.read()
    path = str(tmp_path / "short.gguf")
    with open(path, "wb") as f:
        f.write(data[:-100])
    r = native.NativeGGUF(path)
    with pytest.raises(IOError, match="truncated data of q4_k"):
        r.tensor("q4_k")


def test_a_library_that_does_not_build_raises_the_compiler_message(tmp_path, monkeypatch):
    """No quiet fallback: a source g++ refuses raises OSError with its
    message, and the checkpoint path raises with it."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(OSError, match="(?s)g\\+\\+ failed .*error"):
        native.get_lib()
    with pytest.raises(OSError, match="g\\+\\+ failed"):
        GGUFCheckpoint(str(tmp_path / "any.gguf"))


def test_the_library_is_built_into_build_under_a_hashed_name():
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("libqwen3tts_native_") and os.path.exists(path)


@pytest.mark.parametrize("n", [0, 1, 4801])
def test_wav_bytes_equal_the_jax_library_and_save_wav(tmp_path, n):
    """wav_write_pcm16's file equals the JAX native writer's, byte for
    byte, and the port's audio.wav.save_wav (clamped, truncated to int16)."""
    from qwen3tts_tpu_torch.audio.wav import save_wav

    x = (np.random.default_rng(n).normal(size=n) * 0.7).astype(np.float32)
    if n:
        x[0] = 1.5
    p, j, s = (str(tmp_path / f"{k}.wav") for k in "pjs")
    native.wav_write_pcm16(p, x, 24000)
    assert jnative.wav_write_pcm16(j, x, 24000)
    save_wav(s, x, 24000)
    with open(p, "rb") as a, open(j, "rb") as b, open(s, "rb") as c:
        got = a.read()
        assert got == b.read() == c.read()
    assert len(got) == 44 + 2 * n


def test_wav_to_a_directory_that_is_not_there_raises(tmp_path):
    with pytest.raises(OSError):
        native.wav_write_pcm16(str(tmp_path / "no" / "x.wav"), np.zeros(4, np.float32), 24000)


@pytest.mark.parametrize("rates", [(48000, 24000), (16000, 24000), (44100, 24000),
                                   (22050, 16000)])
def test_resample_equals_the_jax_library(rates):
    x = np.random.default_rng(sum(rates)).normal(size=3001).astype(np.float32)
    got = native.resample_linear(x, *rates)
    want = jnative.resample_linear(x, *rates)
    assert got.shape == want.shape == (int(len(x) / (rates[0] / rates[1])),)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.fixture(scope="module")
def gguf_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt"))
    hf_fixture.write_checkpoint_dir(root, tiny_pipeline_config())
    d = os.path.join(root, "gguf")
    hf_fixture.write_gguf_dir(root, d)
    return d


def _same_leaves(a, b):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
        return
    for x, y in zip(a, b):
        _same_leaves(x, y)


@pytest.mark.parametrize("stage", ["talker", "code_predictor", "vocoder"])
def test_loaders_read_the_same_leaves_through_both_readers(gguf_dir, stage):
    """The GGUF checkpoint reads through NativeGGUF by default; every leaf
    the loaders build equals the pure-Python reader's, bit for bit."""
    cfg = tiny_pipeline_config()
    path = os.path.join(gguf_dir, "qwen3-tts-tokenizer-q8_0.gguf" if stage == "vocoder"
                        else "qwen3-tts-0.6b-q8_0.gguf")
    nat, py = GGUFCheckpoint(path), GGUFCheckpoint(path, reader=gguf.GGUFReader)
    assert type(nat._readers[0]) is native.NativeGGUF
    load = {"talker": lambda st: loader.load_talker(st, cfg.talker, torch.float32, "cpu"),
            "code_predictor": lambda st: loader.load_code_predictor(
                st, cfg.code_predictor, torch.float32, "cpu"),
            "vocoder": lambda st: loader.load_vocoder(st, cfg.vocoder, torch.float32, "cpu")}
    _same_leaves(load[stage](nat), load[stage](py))


def test_the_pipeline_reads_a_gguf_directory_through_the_native_reader(gguf_dir):
    tts = Qwen3TTS(tiny_pipeline_config(), "cpu")
    assert tts.load_models(gguf_dir), tts.error_msg
    ckpt = tts._open_checkpoint(0, "TTS")
    assert all(type(r) is native.NativeGGUF for r in ckpt._readers)
