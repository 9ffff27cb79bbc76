"""The collectives of sharded generation and training, over one mesh axis.

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
These four are detached (generation runs without autograd).

Training differentiates through its collectives, which JAX's GSPMD inserts
and transposes itself. Here each is a `torch.autograd.Function`:

| op                            | forward            | backward              |
|-------------------------------|--------------------|-----------------------|
| `copy_to(x, tp)` (Megatron f) | identity           | psum over the axis    |
| `reduce_from(x, tp)` (g)      | psum over the axis | identity              |
| `gather_from(x, tp, dim)`     | tiled all_gather   | this rank's slice     |
| `ppermute(x, axis, shift)`    | ring rotation: index i sends to i + shift | the reverse rotation |

(the reverse rotation is `lax.ppermute`'s transpose).

`torch.distributed.nn.all_reduce` is not `g`: its backward all-reduces the
already replicated cotangent, tp times too large. `ppermute_` is the
detached rotation the kernel ring (`parallel/ring_kernel.py`) calls inside
its own backward.

Transport: the process group's backend takes the tensors where they lie.
gloo (several ranks on one card) accepts CUDA tensors for all-reduce (SUM
and MAX) and all-gather (f32, bf16 and int32), as chip_smoke's gloo probe
shows on torch 2.11 with CUDA 12.8, and stages them through the host
itself; nccl keeps them on the cards. gloo's point-to-point send and recv
do not stage a CUDA tensor: they read its device address as host memory
(on the H100 machine the transport then fails with "Bad address"). So on
gloo `ppermute` copies the block to the host, sends it and copies what it
receives back (`ppermute_route` says which way a group takes); on nccl
the blocks stay on the cards. The nccl route (one card per rank) has not
been run yet: the card checks run 2 ranks on one card over gloo.
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


# -- point to point -------------------------------------------------------

def ppermute_route(axis: Optional[MeshAxis], x: torch.Tensor) -> str:
    """How `ppermute` moves x over the axis: "none" (size 1), "host" (gloo
    with a CUDA tensor: staged through the host) or "direct"."""
    if axis_size(axis) == 1:
        return "none"
    if x.device.type == "cuda" and dist.get_backend(axis.group) == "gloo":
        return "host"
    return "direct"


def ppermute_(x: torch.Tensor, axis: Optional[MeshAxis], shift: int = 1) -> torch.Tensor:
    """Rotate x around the axis's ring, detached: the rank at index i sends
    its x to index (i + shift) mod n and returns the block of index
    (i - shift) mod n."""
    n = axis_size(axis)
    if n == 1 or shift % n == 0:
        return x
    if not axis.members:
        raise ValueError(f"axis {axis.name!r} has no member list (build it with build_mesh)")
    route = ppermute_route(axis, x)
    src = x.detach().contiguous()
    if route == "host":
        src = src.cpu()
    out = torch.empty_like(src)
    dst_rank = axis.members[(axis.index + shift) % n]
    src_rank = axis.members[(axis.index - shift) % n]
    # one batch: nccl posts the send and the receive together, so two ranks
    # that both send first cannot wait on each other
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, dst_rank, axis.group),
                                   dist.P2POp(dist.irecv, out, src_rank, axis.group)])
    for r in reqs:
        r.wait()
    return out.to(x.device) if route == "host" else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return ppermute_(x, axis, shift)

    @staticmethod
    def backward(ctx, dy):
        return ppermute_(dy, ctx.axis, -ctx.shift), None, None


def ppermute(x: torch.Tensor, axis: Optional[MeshAxis], shift: int = 1) -> torch.Tensor:
    """`ppermute_` under autograd: the cotangent rotates back by -shift."""
    if axis_size(axis) == 1:
        return x
    return _PPermute.apply(x, axis, shift)


# -- Megatron's f and g, and the gather of a sharded output ---------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return psum(dy, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return psum(x, axis)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.width = axis, dim, x.shape[dim]
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, dy):
        mine = dy.narrow(ctx.dim, ctx.axis.index * ctx.width, ctx.width)
        return mine.contiguous(), None, None


def copy_to(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Megatron's f: x enters a column-parallel product on every rank of the
    axis; its cotangent, a partial sum on each rank, is summed."""
    return x if axis_size(axis) == 1 else _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """Megatron's g: the partial outputs of a row-parallel product summed
    over the axis; the cotangent is already whole on every rank."""
    return x if axis_size(axis) == 1 else _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: Optional[MeshAxis], dim: int = -1) -> torch.Tensor:
    """The ranks' column shards concatenated along `dim`; the cotangent of
    the whole keeps this rank's slice."""
    return x if axis_size(axis) == 1 else _GatherFrom.apply(x, axis, dim % x.dim())
