"""Process meshes: the JAX package's ('dp', 'fsdp', 'tp', 'sp') device mesh
as one process per mesh position.

Counterpart of `audio_llama_tpu/parallel/mesh.py`. There a `jax.sharding.Mesh`
reshapes the device list row-major over the axes and `shard_map` runs the
program once per device. Here every process of a `torch.distributed` world
runs the program on its own shard, and a `Mesh` tells it where it sits:

- rank r of the mesh holds the mesh position `np.unravel_index(r, shape)`,
  the position JAX gives device r in `np.asarray(devices).reshape(shape)`,
  so rank r holds the same dp rows, tp heads and sp window as JAX device r;
- each axis has one process group per line of the mesh along it (the ranks
  that differ only in that axis's coordinate); `mesh.axis(name)` is this
  rank's line, which the collectives (`parallel/collectives.py`) reduce or
  gather over.

Axes:
  dp    data parallel: the batch rows split over it;
  fsdp  parameter sharding of the trainer (size 1 for generation);
  tp    tensor parallel: Megatron column/row shards of the decoder linears;
  sp    sequence parallel: the KV-cache timeline (generation) or the audio
        windows (encoding) split over it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

AXES = ("dp", "fsdp", "tp", "sp")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1 = fill with the remaining processes
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        dp, fsdp, tp, sp = self.dp, self.fsdp, self.tp, self.sp
        if dp == -1:
            if n_devices % (fsdp * tp * sp) != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fsdp*tp*sp={fsdp * tp * sp}")
            dp = n_devices // (fsdp * tp * sp)
        if dp * fsdp * tp * sp != n_devices:
            raise ValueError(f"mesh {dp}x{fsdp}x{tp}x{sp} != {n_devices} devices")
        return dp, fsdp, tp, sp


def best_mesh_shape(n_devices: int, model_heads: int = 8) -> MeshConfig:
    """A dp x tp split for n processes: tp = the largest power of two that
    divides both n and the KV-head count, capped at 8; the rest is dp."""
    tp = 1
    while tp * 2 <= 8 and n_devices % (tp * 2) == 0 and model_heads % (tp * 2) == 0:
        tp *= 2
    return MeshConfig(dp=n_devices // tp, fsdp=1, tp=tp)


@dataclass(frozen=True)
class MeshAxis:
    """This rank's line of the mesh along one axis: its size, this rank's
    coordinate on it and the process group of the line (None when the axis
    has size 1 or no world is running: nothing to reduce over); `members`
    holds the line's world ranks in axis order (the peers of a ring)."""

    name: str
    size: int
    index: int
    group: Optional[object] = None
    members: tuple = ()


class Mesh:
    """Axis names and sizes, this rank's coordinates and one `MeshAxis` per
    axis. `shape` maps name -> size, as `jax.sharding.Mesh.shape` does.
    `rank` is this process's position in the mesh (None for a world rank
    outside it, which takes part in no collective of the mesh)."""

    def __init__(self, axes: Sequence[tuple[str, int]], rank: Optional[int],
                 groups: Optional[dict] = None, members: Optional[dict] = None):
        self.axis_names = tuple(a for a, _ in axes)
        self.shape = {a: int(s) for a, s in axes}
        self.size = int(np.prod([s for _, s in axes]))
        self.rank = rank
        self.coords = (None if rank is None else
                       dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
                           rank, tuple(self.shape.values()))))))
        self._groups = groups or {}
        self._members = members or {}

    def axis(self, name: str) -> MeshAxis:
        if name not in self.shape:
            raise ValueError(f"mesh {self.axis_names} has no {name!r} axis")
        if self.coords is None:
            raise ValueError("this rank is outside the mesh")
        return MeshAxis(name, self.shape[name], self.coords[name], self._groups.get(name),
                        tuple(self._members.get(name, ())))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def mesh_coords(shape: Sequence[int], rank: int) -> tuple[int, ...]:
    """The mesh position of rank `rank`: JAX's row-major device order."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(shape)))


def axis_lines(shape: Sequence[int], axis: int) -> list[list[int]]:
    """The ranks of every line of the mesh along `axis`, in a fixed order
    (each list sorted by the coordinate on `axis`)."""
    ranks = np.arange(int(np.prod(shape))).reshape(tuple(shape))
    moved = np.moveaxis(ranks, axis, -1).reshape(-1, shape[axis])
    return [list(map(int, line)) for line in moved]


def build_mesh(axes: Sequence[tuple[str, int]], ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A mesh over world ranks `ranks` (default: the whole world, in order),
    laid out row-major over `axes` [(name, size), ...]; mesh rank i is world
    rank ranks[i]. Every rank of the world must call it, with the same
    arguments, in the same order as its other group creations: each line of
    each axis of size > 1 becomes a `torch.distributed` group, and
    `dist.new_group` is collective over the world. Without a running world
    the mesh must have one position, which this process holds."""
    import torch.distributed as dist

    sizes = [int(s) for _, s in axes]
    n = int(np.prod(sizes))
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a mesh of {n} positions needs a torch.distributed world "
                             "(parallel.distributed.initialize or spawn)")
        return Mesh(axes, 0)
    world, me = dist.get_world_size(), dist.get_rank()
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != n:
        raise ValueError(f"mesh {sizes} has {n} positions; given {len(ranks)} ranks")
    if max(ranks) >= world or len(set(ranks)) != n:
        raise ValueError(f"ranks {ranks} are not distinct ranks of a world of {world}")
    groups, lines = {}, {}
    for ax, (name, size) in enumerate(axes):
        if size == 1:
            continue
        for line in axis_lines(sizes, ax):
            members = [ranks[i] for i in line]
            group = dist.new_group(members)
            if me in members:
                groups[name], lines[name] = group, members
    return Mesh(axes, ranks.index(me) if me in ranks else None, groups, lines)


def make_mesh(cfg: MeshConfig = MeshConfig(), ranks: Optional[Sequence[int]] = None) -> Mesh:
    """('dp', 'fsdp', 'tp', 'sp') mesh over `ranks` (default: the whole
    world). Collective over the world: see `build_mesh`."""
    import torch.distributed as dist

    n = len(ranks) if ranks is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    return build_mesh(list(zip(AXES, cfg.resolve(n))), ranks)
