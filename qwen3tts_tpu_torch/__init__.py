"""qwen3tts_tpu_torch — the PyTorch/CUDA port of qwen3tts_tpu for NVIDIA Hopper.

The JAX package beside it is the reference. This package loads HF
safetensors and GGUF checkpoints (``Qwen3TTS.from_pretrained``, ``io/``),
runs single-stream synthesis (``Qwen3TTS.synthesize``), streaming
(``Qwen3TTS.synthesize_streaming``, ``synthesize_queue(on_audio=...)``),
voice cloning (``Qwen3TTS.synthesize_with_voice``), batched and continuous
serving (``Qwen3TTS.synthesize_batch``, ``synthesize_queue``) and the CLI
(``python -m qwen3tts_tpu_torch.cli``) in the JAX package's weight tiers
(bf16, the default; int8; q4; q4pure), through hand-written CUDA kernels
for the pieces the JAX package wrote in Pallas: the fused talker step
(single-stream and batched, in every weight mode), the fused code
predictor (single-stream and batched), the counter-hash sampler, the
vocoder res-block, and the unfused path's decode attention and W8A16 GEMM.
On CPU tensors every kernel wrapper runs its plain PyTorch version
instead.

It imports torch and never jax, and nothing of the JAX package: the host
modules it needs (``config``, ``text.bpe``, ``io``, ``audio``) are its own
copies.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CodePredictorConfig,
    PipelineConfig,
    RuntimeConfig,
    SamplingConfig,
    TalkerConfig,
    VocoderConfig,
    tiny_pipeline_config,
)


def __getattr__(name):
    if name in ("Qwen3TTS", "TTSResult"):
        from . import pipeline
        return getattr(pipeline, name)
    raise AttributeError(name)
