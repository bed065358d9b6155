"""Kernel-level tracing (counterpart of ``qwen3tts_tpu/utils/profiling.py``).

Stage wall times and RSS are always on (``runtime/timing.py``); the
per-kernel story is a ``torch.profiler`` trace, written in the TensorBoard
profiler plugin's layout (a ``*.pt.trace.json`` chrome trace that
TensorBoard, Perfetto and chrome://tracing open):

    from qwen3tts_tpu_torch.utils.profiling import annotate, trace
    with trace("/tmp/qwen3tts-trace"):
        with annotate("request"):
            result = tts.synthesize(...)

The trace holds the host's operators and ``annotate`` regions, and, when a
CUDA device is present, every kernel, copy and memset on it.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int = 2):
    """Profile the enclosed block and write its trace into ``log_dir``
    (created if missing) when the block ends, also when it raises.

    host_tracer_level keeps the JAX option's name and its scale (there: 1
    user annotations, 2 also the runtime's high-level events, 3 verbose):
      - 0: no host activity, the device's only (ValueError without a CUDA
        device: nothing would be recorded);
      - 1: host activity, the operators and ``annotate`` regions;
      - 2 (the default): also each operator's input shapes
        (``record_shapes``);
      - 3: also the Python stack of each event (``with_stack``).
    Device activity (``ProfilerActivity.CUDA``) is recorded whenever
    ``torch.cuda.is_available()``."""
    activities = [ProfilerActivity.CPU] if host_tracer_level >= 1 else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if not activities:
        raise ValueError("host_tracer_level 0 records the device only, and there is no CUDA "
                         "device")
    with profile(activities=activities, record_shapes=host_tracer_level >= 2,
                 with_stack=host_tracer_level >= 3,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str):
    """Named region that shows up in the trace timeline."""
    return record_function(name)
