"""Megatron tensor-parallel shards of the decoder, and the trainer's layout.

Counterpart of the generation half of `audio_llama_tpu/parallel/sharding.py`
(`_frozen_leaf_spec`, `llama_specs`, `shard_frozen_for_generation`; the
LoRA specs of `_trainable_leaf_spec`). Specs are tuples of axis names (or
None) per dim, as the JAX package's `PartitionSpec`s:
  column-parallel (the OUT dim over 'tp'): q/k/v/gate/up and an untied
    lm_head, their int8 per-column scales, int4 pack-after-shard blocks
    (`w_p` [L, K, tp, N/(2 tp)], the block axis) and group scales, LoRA `b`;
  row-parallel (the IN dim over 'tp'): o/down, their int4 `w_p` [L, K, N/2]
    and group scales, the LoRA `a` of a row-parallel target; their int8
    per-column scales and biases stay whole (they apply after the sum);
  everything else replicated ('fsdp' marks the dims the trainer shards:
  generation refuses fsdp > 1).
Where JAX places the arrays with these specs and `shard_map` hands each
device its block, `shard_llama` cuts this rank's block out of a full tree:
the Whisper tree stays whole (`shard_frozen_for_generation`).

The training half (`sharded_train.py`): `batch_specs` (JAX's: the batch
axis over dp x fsdp, the token axis over sp when asked), `batch_rows` (this
rank's rows of a global batch: the tp and sp peers of one dp group take the
same rows; the sp slice of the tokens is cut after the splice, in
`models/allm.py::forward_nll`), `shard_trainable` / `gather_trainable` (a
tp block of the trainable tree and its inverse) and `sharded_flags` (which
leaves are blocks). The optimizer's moments follow their leaves.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..bridge import ParamTree
from .collectives import all_gather
from .mesh import MeshAxis

_COL = {"q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "fc1"}
_ROW = {"o_proj", "down_proj", "out_proj", "fc2"}


def _module_of(names) -> Optional[str]:
    for n in names:
        if n in _COL or n in _ROW:
            return n
    return None


def frozen_leaf_spec(names: list, ndim: int) -> tuple:
    """The JAX package's `_frozen_leaf_spec` for the leaf at path `names`."""
    mod = _module_of(names)
    last = names[-1] if names else ""
    if last == "weight" and "embed" in names:  # [V, D] (bf16 or int8)
        return (None, "fsdp")
    if "lm_head" in names:
        return ("tp",) if ndim == 1 else ("fsdp", "tp")
    if "pos_embed" in names or "conv1" in names or "conv2" in names:
        return ()
    if last == "w_p":
        if mod in _COL:
            return (None, None, "tp", None) if ndim == 4 else ()
        if mod in _ROW:
            return (None, "tp", None)
    if last == "w_s" and ndim == 3 and mod is not None:
        return (None, None, "tp") if mod in _COL else (None, "tp", None)
    if last == "w_r" and mod is not None:
        return (None, "tp") if mod in _ROW else ()
    if mod in _COL:
        if ndim == 3:
            return (None, "fsdp", "tp")
        if ndim == 2 and last in ("b", "bias", "w_s"):
            return (None, "tp")
        return ()
    if mod in _ROW:
        if ndim == 3:
            return (None, "tp", "fsdp")
        return ()
    return ()


def trainable_leaf_spec(names: list, ndim: int) -> tuple:
    """The JAX package's `_trainable_leaf_spec`: a column-parallel target's
    LoRA b [L, r, out] shards its out dim, a row-parallel target's a [L,
    in, r] its in dim; the rest (projector, other factors) is replicated."""
    mod = _module_of(names)
    last = names[-1] if names else ""
    if "lora" in names and mod is not None and ndim == 3:
        if mod in _COL and last == "b":
            return (None, None, "tp")
        if mod in _ROW and last == "a":
            return (None, "tp", None)
    return ()


def _specs(tree, leaf_spec, prefix=()) -> dict:
    out = {}
    for name, val in tree.items():
        path = prefix + (name,)
        if isinstance(val, (ParamTree, dict)):
            out[name] = _specs(val, leaf_spec, path)
        else:
            out[name] = leaf_spec(list(path), val.dim())
    return out


def llama_specs(params) -> dict:
    """Spec tree of a Llama tree (full precision, int8 or int4)."""
    return _specs(params, frozen_leaf_spec)


def trainable_specs(trainable) -> dict:
    return _specs(trainable, trainable_leaf_spec)


def _shard_leaf(t: torch.Tensor, spec: tuple, axis: MeshAxis) -> torch.Tensor:
    for dim, name in enumerate(spec):
        if name == "tp" and axis.size > 1:
            n = t.shape[dim]
            if n % axis.size:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over "
                                 f"tp={axis.size}")
            k = n // axis.size
            t = t.narrow(dim, axis.index * k, k).clone(memory_format=torch.contiguous_format)
    return t


def _shard(tree, leaf_spec, axis: MeshAxis, prefix=()) -> dict:
    out = {}
    for name, val in tree.items():
        path = prefix + (name,)
        if isinstance(val, (ParamTree, dict)):
            out[name] = _shard(val, leaf_spec, axis, path)
        else:
            t = val.data if isinstance(val, torch.nn.Parameter) else val
            out[name] = _shard_leaf(t, leaf_spec(list(path), t.dim()), axis)
    return out


def shard_llama(params, axis: MeshAxis) -> ParamTree:
    """This rank's tp block of a full Llama tree (new tensors; the full tree
    may be freed after)."""
    return ParamTree(_shard(params, frozen_leaf_spec, axis))


def cut_trainable(tree, axis: MeshAxis) -> dict:
    """This rank's tp blocks of a tree of tensors shaped like the trainable
    tree (the tree itself, or an optimizer moment) -> nested dict; a
    replicated leaf comes back as the same tensor."""
    return _shard(tree, trainable_leaf_spec, axis)


def shard_trainable(trainable, axis: MeshAxis):
    """This rank's tp block of the trainable tree (LoRA factors)."""
    if trainable is None:
        return None
    return ParamTree(cut_trainable(trainable, axis))


def sharded_flags(trainable: ParamTree) -> list:
    """Per parameter of the trainable tree, in `parameters()` order: is it a
    tp block (its spec names 'tp')?"""
    return ["tp" in trainable_leaf_spec(name.split("."), p.dim())
            for name, p in trainable.named_parameters()]


def gather_trainable(tree, axis: MeshAxis) -> dict:
    """The inverse of `shard_trainable`: every tp block gathered whole over
    the axis (a collective: every rank of it calls it) -> a nested dict of
    detached tensors. `tree` is the trainable tree or one shaped like it
    (an optimizer moment)."""
    return _gather(tree, axis, ())


def _gather(tree, axis, prefix):
    out = {}
    for name, val in tree.items():
        path = prefix + (name,)
        if isinstance(val, (ParamTree, dict)):
            out[name] = _gather(val, axis, path)
            continue
        t = val.detach()
        for dim, ax in enumerate(trainable_leaf_spec(list(path), t.dim())):
            if ax == "tp":
                t = all_gather(t, axis, dim=dim)
        out[name] = t
    return out


def batch_specs(batch, accum: bool = False, seq_axis: Optional[str] = None):
    """JAX's `batch_specs`: per field of an AudioLLMBatch, a spec tuple with
    the batch axis over ('dp', 'fsdp') (behind the micro-batch axis when
    `accum`) and, with `seq_axis`, the token axis of input_ids /
    attention_mask / labels over it; None for an absent field."""
    token_fields = {"input_ids", "attention_mask", "labels"}

    def spec(leaf, field):
        lead = (None,) if accum else ()
        rest = [None] * (leaf.dim() - len(lead) - 1)
        if seq_axis and field in token_fields and rest:
            rest[-1] = seq_axis
        return (*lead, ("dp", "fsdp"), *rest)

    return type(batch)(*(None if getattr(batch, f) is None else spec(getattr(batch, f), f)
                         for f in batch._fields))


def batch_rows(mesh, batch, accum: bool = False):
    """This rank's rows of a global batch: along the axis `batch_specs` puts
    over ('dp', 'fsdp') (dim 1 of [A, B, ...] leaves when `accum`), rows
    [i B/dp, (i + 1) B/dp) for dp coordinate i. tp and sp peers take the
    same rows."""
    dp = mesh.shape.get("dp", 1)
    if dp == 1:
        return batch
    i = mesh.axis("dp").index

    def cut(t, spec):
        if t is None:
            return None
        dim = spec.index(("dp", "fsdp"))
        n = t.shape[dim]
        if n % dp:
            raise ValueError(f"batch of {n} rows does not split over dp={dp}")
        return t.narrow(dim, i * (n // dp), n // dp)

    return type(batch)(*(cut(t, spec) for t, spec in zip(batch, batch_specs(batch, accum))))


def shard_frozen_for_generation(mesh, frozen) -> ParamTree:
    """{'llama': this rank's block over the mesh's 'tp' axis, 'whisper': the
    whole encoder}, as the JAX package places the frozen tree for
    `make_tp_generate`."""
    return ParamTree({"llama": shard_llama(frozen["llama"], mesh.axis("tp")),
                      "whisper": frozen["whisper"]})
