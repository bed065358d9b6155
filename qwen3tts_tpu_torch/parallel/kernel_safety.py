"""Sharding-aware gating of the fused kernels (counterpart of
``qwen3tts_tpu/parallel/kernel_safety.py``).

The fused talker step (K1/K5) and code predictor (K2/K6) read whole weight
matrices and have no partitioned form. The resolution in
``runtime/decode_loop.resolve_fused_*`` therefore inspects the params'
Placements (``parallel/mesh.py``), as the JAX package inspects their
committed shardings:

- any leaf split over a mesh axis of size > 1 -> the unfused path, one
  logged line per (kernel, axes) pair; an EXPLICIT ``fused_*=True`` raises;
- params replicated on a multi-device mesh -> the batched loop keeps the
  kernels by running each "dp" rank's lanes on that rank
  (``decode_loop.generate_from_tokens_batched``); the continuous scheduler
  turns them off under any multi-device mesh, as the JAX package's does.
"""

from __future__ import annotations

import torch

from .mesh import placement


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)


def partitioned_axes(params) -> frozenset:
    """Names of mesh axes (size > 1) that any leaf of `params` is split
    over; empty when every leaf is replicated or local."""
    axes = set()
    for x in _leaves(params):
        p = placement(x)
        if p is not None:
            axes.update(a for a in p.spec if a is not None and p.mesh.shape[a] > 1)
    return frozenset(axes)


def params_mesh(params):
    """The multi-device Mesh the params live on (from the first placed
    leaf), or None for local params and a one-device mesh."""
    for x in _leaves(params):
        p = placement(x)
        if p is not None and p.mesh.size > 1:
            return p.mesh
    return None


def dp_kernel_mesh(talker_params, cp_params, batch: int):
    """The mesh whose "dp" ranks each run the kernel-enabled batched loop on
    their own lanes, or None: the weights must be replicated on a
    multi-device mesh whose "dp" axis (size > 1) divides the batch."""
    mesh = params_mesh(talker_params) or params_mesh(cp_params)
    if mesh is None:
        return None
    if partitioned_axes((talker_params, cp_params)):
        return None
    if "dp" not in mesh.axis_names:
        return None
    dp = mesh.shape["dp"]
    if dp <= 1 or batch % dp != 0:
        return None
    return mesh
