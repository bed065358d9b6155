"""Device meshes for multi-GPU serving (counterpart of
``qwen3tts_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with two
named axes and runs one program over it:

- ``dp``  data parallel: independent utterances (batched serving);
- ``tp``  tensor parallel: attention heads, FFN columns and vocab shards,
          summed and gathered by collectives.

The port runs one process per rank (SPMD, ``torch.distributed``): every
rank builds the same mesh after its process group is up, calls the same
entry point with the same global inputs, and returns the same global
result. Rank r sits at (r // tp, r % tp) of the (dp, tp) grid, as the JAX
package's ``reshape(dp, tp)`` of its device list places device r. Each
rank holds its device, a process group per axis for the device tensors'
collectives (the default group's backend, which the caller chose: NCCL
with one card a rank, or gloo, which takes CUDA tensors in ``all_reduce``
and ``broadcast``), and a gloo group per axis for the host's gathers (the
same group when the default backend is gloo). An axis of size 1 has no
group: nothing is exchanged over it.

A leaf of ``shardings.shard_params`` carries its ``Placement`` (the mesh
and the per-dim axis names, a PartitionSpec), which
``parallel/kernel_safety.py`` and the models' collectives read.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("dp", "tp")


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (dp, tp) mesh."""

    dp: int
    tp: int
    dp_rank: int                # this rank's coordinate on "dp"
    tp_rank: int                # and on "tp"
    device: torch.device        # this rank's device
    groups: dict                # axis -> process group over the device tensors (None: size 1)
    cpu_groups: dict            # axis -> gloo group for host tensors (None: size 1)

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def axis_names(self) -> tuple:
        return AXES

    @property
    def size(self) -> int:
        return self.dp * self.tp

    def coord(self, axis: str) -> int:
        return self.dp_rank if axis == "dp" else self.tp_rank


class Placement(NamedTuple):
    """Where a local leaf lives: the mesh, and per dim of the global array
    the mesh axis it is split over, or None (a PartitionSpec)."""

    mesh: Mesh
    spec: tuple


def placement(x) -> Optional[Placement]:
    """The Placement of a leaf (a tensor, or a quantized leaf whose first
    field is read), or None for a local leaf."""
    if isinstance(x, tuple):
        x = x[0] if x else None
    return getattr(x, "_placement", None)


def place(x: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """x as a new tensor object (sharing x's storage) that carries its
    Placement; x itself is left as it was."""
    out = x.detach()
    out._placement = Placement(mesh, tuple(spec))
    return out


def split_over(x, axis: str, dim: int) -> Optional[Mesh]:
    """The mesh when leaf x is split over `axis` (of size > 1) on dim `dim`
    (< 0, from the end) of its global shape, else None."""
    p = placement(x)
    if p is None or len(p.spec) < -dim or p.mesh.shape[axis] <= 1:
        return None
    return p.mesh if p.spec[dim] == axis else None


def _default_devices(world: int) -> list:
    if not torch.cuda.is_available():
        raise ValueError("no CUDA device: pass devices=['cpu'] * world for a CPU mesh")
    n = torch.cuda.device_count()
    return [torch.device("cuda", r % n) for r in range(world)]


def make_mesh(dp: int = 1, tp: int = 1,
              devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The (dp, tp) mesh over the first dp * tp ranks of the process group
    (one rank and no group when torch.distributed is not initialized).
    devices[r] is rank r's device (default: card r modulo the cards this
    process sees). Every rank of the group must call it, with the same
    arguments: it creates the axes' process groups. Raises ValueError when
    dp * tp exceeds the world; returns None on a rank outside the mesh."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    rank = dist.get_rank() if up else 0
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {dp}x{tp}: both axes need at least one device")
    if dp * tp > world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {world}")
    devices = list(devices) if devices is not None else _default_devices(world)
    if len(devices) < dp * tp:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, got {len(devices)}")
    # every rank creates every group, in the same order; under a gloo
    # default group the axis group serves the host's gathers too
    gloo = up and dist.get_backend() == "gloo"
    groups, cpu_groups = {"dp": None, "tp": None}, {"dp": None, "tp": None}
    for axis, n, members in (
            ("tp", tp, [[d * tp + t for t in range(tp)] for d in range(dp)]),
            ("dp", dp, [[d * tp + t for d in range(dp)] for t in range(tp)])):
        if n == 1:
            continue
        for ranks in members:
            g = dist.new_group(ranks)
            cg = g if gloo else dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                groups[axis], cpu_groups[axis] = g, cg
    if rank >= dp * tp:
        return None
    return Mesh(dp=dp, tp=tp, dp_rank=rank // tp, tp_rank=rank % tp,
                device=torch.device(devices[rank]), groups=groups, cpu_groups=cpu_groups)


def single_device_mesh(devices: Optional[Sequence] = None) -> Mesh:
    return make_mesh(1, 1, devices)
