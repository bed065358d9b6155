"""Stage timing / memory observability (reference qwen3_tts.cpp:30-82,414-439).

The reference always reports per-stage wall times, RTF, and RSS snapshots;
this module reproduces that surface. Copied from ``qwen3tts_tpu.runtime``,
whose package import pulls in jax. Deeper kernel-level tracing is delegated
to ``torch.profiler`` (see utils/profiling.py) instead of the reference's
compile-time QWEN3_TTS_TIMING counters: on the GPU the per-kernel story
lives in the profiler trace, not printf.
"""

from __future__ import annotations

import dataclasses
import resource
import sys
import time


def now_ms() -> float:
    return time.perf_counter() * 1e3


def rss_bytes() -> int:
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KiB on Linux, bytes on macOS
    return ru * 1024 if sys.platform != "darwin" else ru


@dataclasses.dataclass
class StageTimings:
    t_load_ms: float = 0.0
    t_tokenize_ms: float = 0.0
    t_encode_ms: float = 0.0
    t_generate_ms: float = 0.0
    t_decode_ms: float = 0.0
    t_total_ms: float = 0.0
    t_first_audio_ms: float = 0.0   # time-to-first-audio (streaming)
    mem_rss_start: int = 0
    mem_rss_peak: int = 0

    def report(self, audio_seconds: float, file=sys.stderr) -> None:
        wall_s = self.t_total_ms / 1e3
        x_rt = audio_seconds / wall_s if wall_s > 0 else 0.0
        rtf = wall_s / audio_seconds if audio_seconds > 0 else 0.0
        print("\nTiming:", file=file)
        print(f"  Tokenization:    {self.t_tokenize_ms:8.1f} ms", file=file)
        print(f"  Speaker encode:  {self.t_encode_ms:8.1f} ms", file=file)
        print(f"  Code generation: {self.t_generate_ms:8.1f} ms", file=file)
        print(f"  Vocoder decode:  {self.t_decode_ms:8.1f} ms", file=file)
        print(f"  Total:           {self.t_total_ms:8.1f} ms", file=file)
        print(f"  Audio duration:  {audio_seconds:8.2f} s", file=file)
        print(f"  Throughput:      {x_rt:.2f}x realtime (RTF={rtf:.4f})", file=file)
        if self.t_first_audio_ms:
            print(f"  First audio:     {self.t_first_audio_ms:8.1f} ms", file=file)
        print(f"  RSS peak:        {self.mem_rss_peak / 2**30:.2f} GB", file=file)
