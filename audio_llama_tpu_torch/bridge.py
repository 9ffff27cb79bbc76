"""Weights from the JAX package's pytrees into the port's modules.

The JAX package keeps its parameters as nested dicts of arrays with stacked
`[L, ...]` layer leaves and linear weights stored `[in, out]` (so forward is
`x @ w`); see llama.py:55-88 and whisper.py:45-75 there. The port keeps the
same tree, leaf for leaf, as a `ParamTree`: an `nn.Module` whose children are
the sub-dicts and whose parameters are the leaves, under the same names. So
`from_jax` copies each leaf as it is, and `frozen["llama"]["layers"]["q_proj"]`
means the same tensor in both packages. `to_numpy` is the way back: a nested
dict of numpy arrays, as the JAX package's checkpoints and tests hold them.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .device import DeviceLike, resolve_device


class ParamTree(nn.Module):
    """A nested parameter dict as an `nn.Module`. Leaves are `nn.Parameter`s,
    frozen unless `requires_grad` (the trainable tree: projector + LoRA);
    sub-dicts are child `ParamTree`s with the same flag. Indexing by name
    mirrors the JAX pytree."""

    def __init__(self, tree: Mapping[str, Any], requires_grad: bool = False):
        super().__init__()
        self._names = []
        self._requires_grad = requires_grad
        for name, val in tree.items():
            if isinstance(val, ParamTree):
                self.add_module(name, val)
            elif isinstance(val, Mapping):
                self.add_module(name, ParamTree(val, requires_grad))
            elif isinstance(val, torch.Tensor):
                self.register_parameter(name, nn.Parameter(val, requires_grad=requires_grad))
            else:
                raise TypeError(f"ParamTree leaf {name!r}: {type(val).__name__}")
            self._names.append(name)

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __setitem__(self, name: str, val) -> None:
        if isinstance(val, Mapping):
            val = ParamTree(val, self._requires_grad)
        if isinstance(val, ParamTree):
            if name in self._parameters:
                del self._parameters[name]
            self.add_module(name, val)
        else:
            if name in self._modules:
                del self._modules[name]
            self.register_parameter(name, nn.Parameter(val, requires_grad=self._requires_grad))
        if name not in self._names:
            self._names.append(name)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def keys(self):
        return list(self._names)

    def values(self):
        return [self[n] for n in self._names]

    def items(self):
        return [(n, self[n]) for n in self._names]

    def get(self, name: str, default=None):
        return self[name] if name in self._names else default

    def to_dict(self) -> dict:
        """Nested dict of tensors (the JAX tree's shape)."""
        out = {}
        for name in self._names:
            val = self[name]
            out[name] = val.to_dict() if isinstance(val, ParamTree) else val.data
        return out


def to_tensor(x, device: torch.device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One leaf -> tensor. bfloat16 numpy leaves (ml_dtypes) keep their bits."""
    arr = np.array(x, order="C")  # a writable copy (JAX hands out read-only views)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax(
    tree: Mapping[str, Any], device: DeviceLike = None, dtype: Optional[torch.dtype] = None
) -> ParamTree:
    """A JAX param pytree (numpy or JAX arrays) -> ParamTree on `device`.
    `dtype` casts floating leaves; None keeps each leaf's own dtype."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return to_tensor(node, dev, dtype)

    return ParamTree(conv(tree))


def to_numpy(tree) -> dict:
    """A ParamTree (or nested dict of tensors) -> nested dict of numpy
    arrays on the host, copies that share no memory with the tensors.
    bfloat16 leaves become `ml_dtypes.bfloat16` arrays with the same bits
    (as JAX hands them out), which needs ml_dtypes."""
    if isinstance(tree, (ParamTree, Mapping)):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return t.numpy().copy()
