"""The collectives of tensor- and data-parallel serving.

The JAX package writes none of these: GSPMD inserts them where a sharded
leaf meets the computation (``qwen3tts_tpu/parallel/shardings.py:1-17``).
The port calls them where the models need them, and each is a no-op on a
leaf that is not split (so a local or replicated model runs exactly the
ops it ran before meshes existed):

- the sum over "tp" of the partial products of a weight split over its
  input rows (``wo``, ``w_down``, the text projection's ``fc2``):
  ``matmul_rows``;
- the vocab gather over "tp" of a head split over its output columns (the
  codec head, the code predictor's heads): ``gather_columns``, an
  all-reduce of a zero-filled full-vocab buffer into which each rank has
  written its slice (adding zeros is exact, and ``all_reduce`` is one of
  the two collectives gloo takes on CUDA tensors);
- the lane gather over "dp" on the host: ``gather_lanes``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.int8_matmul import int8_matmul
from ..ops.quant import QuantLinear, QuantLinear4, matmul, matmul4_f32
from .mesh import Mesh, split_over


def matmul_rows(x: torch.Tensor, w, stacked) -> torch.Tensor:
    """``quant.matmul(x, w)`` for a layer w of the stacked leaf `stacked`;
    when `stacked` is split over its input rows, each rank multiplies its
    rows in float32, the partials are summed over "tp", and only then are
    int8 scales applied and the sum cast to x's dtype (the order of the
    JAX package's dot, all-reduce, scale). The int8 partial is the W8A16
    kernel's (plain version on the CPU) with float32 x and unit scales."""
    mesh = split_over(stacked, "tp", -2)
    if mesh is None:
        return matmul(x, w)
    if isinstance(w, QuantLinear):
        x2 = x.reshape(-1, x.shape[-1]).float()
        y = int8_matmul(x2, w.q, torch.ones_like(w.scale, dtype=torch.float32))
        y = y.reshape(*x.shape[:-1], y.shape[-1])
    elif isinstance(w, QuantLinear4):
        y = matmul4_f32(x, w)
    else:
        y = torch.matmul(x.float(), w.float())
    dist.all_reduce(y, group=mesh.groups["tp"])
    if isinstance(w, QuantLinear):
        y = y * w.scale.float().reshape(-1)
    return y.to(x.dtype)


def gather_columns(y: torch.Tensor, w) -> torch.Tensor:
    """y [..., N/tp], this rank's columns of a product with leaf w: the
    full [..., N] on every rank when w is split over its output columns,
    else y as it is."""
    mesh = split_over(w, "tp", -1)
    if mesh is None:
        return y
    n = y.shape[-1]
    full = torch.zeros((*y.shape[:-1], n * mesh.tp), dtype=y.dtype, device=y.device)
    full[..., mesh.tp_rank * n:(mesh.tp_rank + 1) * n] = y
    dist.all_reduce(full, group=mesh.groups["tp"])
    return full


def full_columns(w) -> int:
    """The global output columns of leaf w (its local ones times "tp" when
    w is split over them)."""
    mesh = split_over(w, "tp", -1)
    return w.shape[-1] * (1 if mesh is None else mesh.tp)


def lane_range(mesh: Mesh, B: int) -> tuple:
    """The lanes [lo, hi) of B that this rank's "dp" coordinate holds."""
    per = B // mesh.dp
    return mesh.dp_rank * per, (mesh.dp_rank + 1) * per


def gather_lanes(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each dp rank's lanes t [B/dp, ...] (on the host) concatenated in
    dp order into [B, ...] on every rank, over the gloo group of "dp"."""
    group = mesh.cpu_groups["dp"]
    if group is None:
        return t
    t = t.cpu().contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.dp)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)
