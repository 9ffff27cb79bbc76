"""The train state and the pieces of a train step.

Counterpart of `audio_llama_tpu/training/train_step.py`'s state. The step
itself, for one process as for many, is
`parallel/sharded_train.py::make_sharded_train_step` (one process is the
mesh of one position, as in the JAX trainer): a batch of [accum, micro,
...] leaves (or [micro, ...] when accum_steps == 1) runs its micro-batches
in order, each forward + backward into f32 gradients of the trainable tree
(projector + LoRA), summed and divided by accum_steps; the loss is the mean
of the micro-batch losses; then clip + AdamW (`training/optim.py`). The
frozen tree gets no gradients (its leaves are frozen and the encoder runs
without autograd).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..bridge import ParamTree
from ..models import allm
from .optim import OptaxAdamW


class TrainState(NamedTuple):
    trainable: ParamTree  # leaves require grad
    optimizer: OptaxAdamW
    step: int


def init_train_state(trainable: ParamTree, make_optimizer: Callable) -> TrainState:
    """Turn the trainable leaves on and build the optimizer over them."""
    trainable.requires_grad_(True)
    return TrainState(trainable, make_optimizer(list(trainable.parameters())), 0)


def gradients(loss: torch.Tensor, params: list) -> list:
    """d loss / d params; a leaf the loss does not reach (the projector on a
    text-only batch) gets zeros, as under jax.grad."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def micro_batch(batch: allm.AudioLLMBatch, i: int) -> allm.AudioLLMBatch:
    """Micro-batch i of an accumulation group ([accum, micro, ...] leaves)."""
    return allm.AudioLLMBatch(*(None if t is None else t[i] for t in batch))
