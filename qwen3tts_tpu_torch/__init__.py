"""qwen3tts_tpu_torch — the PyTorch/CUDA port of qwen3tts_tpu for NVIDIA Hopper.

The JAX package beside it is the reference. This package runs the single-stream
int8 synthesis path (``Qwen3TTS.synthesize``) with hand-written CUDA kernels
for the four pieces the JAX package wrote in Pallas: the fused talker step,
the fused code predictor, the counter-hash sampler and the vocoder res-block.
On CPU tensors every kernel wrapper runs its plain PyTorch version instead.

It imports torch and never jax; the JAX-free host modules of the old package
(``config``, ``text.bpe``, ``audio.wav``) are shared.
"""

__version__ = "0.1.0"

from qwen3tts_tpu.config import (  # noqa: F401
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
