"""Train and eval steps.

Counterpart of `audio_llama_tpu/training/train_step.py`: a batch of
[accum, micro, ...] leaves (or [micro, ...] when accum_steps == 1) runs its
micro-batches in order, each forward + backward into f32 gradients of the
trainable tree (projector + LoRA), summed and divided by accum_steps; the
loss is the mean of the micro-batch losses; then clip + AdamW
(`training/optim.py`). The frozen tree gets no gradients (its leaves are
frozen and the encoder runs without autograd).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..bridge import ParamTree
from ..config import AudioLLMConfig
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


def make_loss_fn(cfg: AudioLLMConfig, audio_start_id: int, audio_end_id: int,
                 compute_dtype=torch.bfloat16, loss_chunk_size: int = 0,
                 remat: bool = False) -> Callable:
    def loss_fn(trainable, frozen, batch: allm.AudioLLMBatch) -> torch.Tensor:
        loss, _ = allm.forward(frozen, trainable, cfg, batch, audio_start_id, audio_end_id,
                               compute_dtype, loss_chunk_size=loss_chunk_size, remat=remat)
        return loss

    return loss_fn


def gradients(loss: torch.Tensor, params: list) -> list:
    """d loss / d params; a leaf the loss does not reach (the projector on a
    text-only batch) gets zeros, as under jax.grad."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


def _micro(batch: allm.AudioLLMBatch, i: int) -> allm.AudioLLMBatch:
    return allm.AudioLLMBatch(*(None if t is None else t[i] for t in batch))


def make_train_step(cfg: AudioLLMConfig, audio_start_id: int, audio_end_id: int,
                    compute_dtype=torch.bfloat16, accum_steps: int = 1,
                    loss_chunk_size: int = 0, remat: bool = False) -> Callable:
    """-> step(state, frozen, batch) -> (state, {"loss", "grad_norm"}), both
    0-d f32 tensors on the device (read them only when logging: reading
    synchronizes with the card)."""
    loss_fn = make_loss_fn(cfg, audio_start_id, audio_end_id, compute_dtype,
                           loss_chunk_size, remat)

    def step(state: TrainState, frozen: ParamTree, batch: allm.AudioLLMBatch):
        params = list(state.trainable.parameters())
        if accum_steps == 1:
            loss = loss_fn(state.trainable, frozen, batch)
            grads = gradients(loss, params)
            loss = loss.detach().float()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            for i in range(accum_steps):
                micro_loss = loss_fn(state.trainable, frozen, _micro(batch, i))
                micro_grads = gradients(micro_loss, params)
                loss = loss + micro_loss.detach().float()
                grads = [acc + g.float() for acc, g in zip(grads, micro_grads)]
            loss = loss / accum_steps
            grads = [g / accum_steps for g in grads]
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
        grad_norm = state.optimizer.step()
        for p in params:
            p.grad = None
        return TrainState(state.trainable, state.optimizer, state.step + 1), {
            "loss": loss, "grad_norm": grad_norm}

    return step


def make_eval_step(cfg: AudioLLMConfig, audio_start_id: int, audio_end_id: int,
                   compute_dtype=torch.bfloat16) -> Callable:
    """eval step: (trainable, frozen, batch) -> the batch's mean loss, 0-d,
    without autograd."""
    loss_fn = make_loss_fn(cfg, audio_start_id, audio_end_id, compute_dtype)

    @torch.no_grad()
    def step(trainable, frozen, batch):
        return loss_fn(trainable, frozen, batch).float()

    return step
