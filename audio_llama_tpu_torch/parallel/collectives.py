"""The collectives of sharded generation, over one mesh axis.

The JAX package names these inside `shard_map` as `lax` primitives; here
each runs over the process group of this rank's line of the mesh along the
axis (`parallel/mesh.py::MeshAxis`):

| JAX                                   | here                             |
|---------------------------------------|----------------------------------|
| `lax.psum(x, a)`                      | `psum(x, axis)`: all-reduce SUM  |
| `lax.pmax(x, a)`                      | `pmax(x, axis)`: all-reduce MAX  |
| `lax.all_gather(x, a, axis=d, tiled)` | `all_gather(x, axis, dim=d)`     |
| `lax.axis_index(a)`, `psum(1, a)`     | `axis_index(axis)`, `axis_size(axis)` |

The model code calls only these. An axis of size 1 (or None) is the
identity. The inputs are never written: each call returns a new tensor.

Transport: the process group's backend takes the tensors where they lie.
gloo (several ranks on one card) accepts CUDA tensors for all three ops
(all-reduce SUM and MAX, all-gather; f32, bf16 and int32), as chip_smoke's
gloo probe shows on torch 2.11 with CUDA 12.8, and stages them through the
host itself; nccl keeps them on the cards.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .mesh import MeshAxis


def axis_size(axis: Optional[MeshAxis]) -> int:
    return 1 if axis is None else axis.size


def axis_index(axis: Optional[MeshAxis]) -> int:
    return 0 if axis is None else axis.index


def _all_reduce(x: torch.Tensor, axis: Optional[MeshAxis], op) -> torch.Tensor:
    if axis_size(axis) == 1:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=axis.group)
    return y


def psum(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Sum of x over the axis, on every rank of it."""
    return _all_reduce(x, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Elementwise max of x over the axis, on every rank of it."""
    return _all_reduce(x, axis, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, axis: Optional[MeshAxis], dim: int = -1) -> torch.Tensor:
    """The ranks' x concatenated along `dim` in axis order (JAX's tiled
    all_gather)."""
    if axis_size(axis) == 1:
        return x
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim)
