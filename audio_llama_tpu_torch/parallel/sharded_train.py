"""Sharded train and eval steps over a process mesh.

Counterpart of `audio_llama_tpu/parallel/sharded_train.py`. There GSPMD
derives every collective of the step from sharding annotations; here one
process runs per mesh position (`parallel/mesh.py`) and the step names its
collectives itself:

  dp   each rank takes its rows of the batch (`sharding.batch_rows`); the
       loss is the mean over the whole batch's scored tokens, so every
       micro-batch's (summed NLL, count) is summed over dp x sp before its
       backward, and the gradients are summed over dp x sp after the last;
  tp   the frozen Llama and the LoRA factors of the Megatron specs are this
       rank's blocks; the model's f / g collectives (`models/llama.py`) keep
       the replicated leaves' gradients whole on every rank; the clip norm
       sums the blocks over tp (`training/optim.py`);
  sp   each rank runs its slice of the sequence (`allm.forward_nll`), causal
       attention as the kernel ring (`parallel/ring_kernel.py`).

The steps keep JAX's signatures. Three of its arguments are unused here:
`kernel_partition` (every rank already runs the kernels on its own block;
JAX needs it to wrap each Pallas call in a nested shard_map), `optimizer`
(the port's TrainState carries its optimizer, built by
`init_sharded_state`) and `donate_state` (the step updates the state's
leaves in place). The `*_impl` flags take 'auto' only (the kernels on the
card, their plain versions on the host): any other value raises
ValueError, as the trainer CLI's. Refused with NotImplementedError: fsdp >
1 and sp together with tp (JAX gathers the heads for the ring,
ops/partitioning.py:179-180), ROADMAP queue 1 item 1.

The replicated trainables stay bit-equal on every rank: each sum is one
all-reduce whose result every rank of the group receives, and the update is
the same arithmetic on the same numbers.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch

from ..bridge import ParamTree
from ..config import AudioLLMConfig
from ..models import allm
from ..training import train_step as base_steps
from . import sharding
from .collectives import psum

QUEUE = "ROADMAP queue 1 item 1 (fsdp and sp x tp training)"


def check_impls(prefix: str = "", **impls: str) -> None:
    """Refuse a kernel choice (`attn_impl=...`) other than 'auto'."""
    for name, value in impls.items():
        if value != "auto":
            raise ValueError(
                f"{prefix}{name} {value!r}: the port takes 'auto' only (its kernels on the card, "
                "their plain versions on the host); the JAX package's A/B and interpret values "
                "have no counterpart here")


def check_mesh(mesh) -> None:
    if mesh.shape.get("fsdp", 1) > 1:
        raise NotImplementedError(f"fsdp > 1 (frozen weights 2-D sharded) waits for {QUEUE}")
    if mesh.shape.get("sp", 1) > 1 and mesh.shape.get("tp", 1) > 1:
        raise NotImplementedError(f"sp together with tp waits for {QUEUE}")


def _axis(mesh, name):
    return mesh.axis(name) if mesh.shape.get(name, 1) > 1 else None


def _psum_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the dp and sp axes (one all-reduce each)."""
    return psum(psum(x, _axis(mesh, "dp")), _axis(mesh, "sp"))


def _clone(tree) -> dict:
    return {k: _clone(v) if isinstance(v, (ParamTree, Mapping)) else v.detach().clone()
            for k, v in tree.items()}


def init_sharded_state(mesh, trainable, make_optimizer: Callable) -> base_steps.TrainState:
    """This rank's tp block of the whole trainable tree (new tensors), turned
    on, with its optimizer (`make_optimizer(params)`): Adam's moments are
    blocks like their leaves and the clip norm sums the blocks over tp."""
    check_mesh(mesh)
    block = ParamTree(_clone(sharding.cut_trainable(trainable, mesh.axis("tp"))))
    state = base_steps.init_train_state(block, make_optimizer)
    if _axis(mesh, "tp") is not None:
        state.optimizer.shard_norm(_axis(mesh, "tp"), sharding.sharded_flags(block))
    return state


def shard_train_state(mesh, state: base_steps.TrainState,
                      make_optimizer: Callable) -> base_steps.TrainState:
    """Re-cut a whole (one-device or checkpoint-restored) TrainState for this
    rank: its trainable blocks and the blocks of Adam's moments; counts and
    step as they are."""
    tp = mesh.axis("tp")
    out = init_sharded_state(mesh, state.trainable, make_optimizer)
    opt = state.optimizer.optax_state(state.trainable)
    adam = opt["1"]["0"]

    def tensors(node):
        if isinstance(node, Mapping):
            return {k: tensors(v) for k, v in node.items()}
        return torch.from_numpy(np.asarray(node, np.float32))

    adam["mu"], adam["nu"] = (sharding.cut_trainable(tensors(adam[k]), tp) for k in ("mu", "nu"))
    out.optimizer.load_optax_state(out.trainable, opt)
    return out._replace(step=state.step)


def gather_train_state(mesh, state: base_steps.TrainState):
    """(the whole trainable tree, the optimizer state in optax's layout with
    whole moments): the single-device checkpoint's contents. A collective
    over tp: every rank calls it; the coordinator writes."""
    tp = mesh.axis("tp")
    mu, nu = state.optimizer.moment_trees(state.trainable)
    moments = (sharding.gather_trainable(mu, tp), sharding.gather_trainable(nu, tp))
    return (sharding.gather_trainable(state.trainable, tp),
            state.optimizer.optax_state(state.trainable, moments))


def _rows(batch, template, mesh, accum: bool):
    """This rank's rows: a batch with the template's (global) row count is
    cut; one already holding B / dp rows (or any batch, with no template) is
    taken as it is."""
    if template is None:
        return batch
    dim = 1 if accum else 0
    n, want = batch.input_ids.shape[dim], template.input_ids.shape[dim]
    if n == want:
        return sharding.batch_rows(mesh, batch, accum)
    if n * mesh.shape.get("dp", 1) != want:
        raise ValueError(f"batch of {n} rows is neither the global {want} nor a dp share")
    return batch


def make_sharded_grad_fn(cfg: AudioLLMConfig, mesh, batch_template, audio_start_id: int,
                         audio_end_id: int, compute_dtype=torch.bfloat16, accum_steps: int = 1,
                         loss_chunk_size: int = 0, remat: bool = False):
    """-> grads(trainable, frozen, batch) -> (loss, [f32 gradient per
    parameter]): the train step's loss and gradients, summed over the mesh
    (each parameter's gradient is this rank's block of the whole one)."""
    check_mesh(mesh)
    tp, sp = _axis(mesh, "tp"), _axis(mesh, "sp")
    accum = accum_steps > 1

    def grads_fn(trainable, frozen, batch):
        batch = _rows(batch, batch_template, mesh, accum)
        params = list(trainable.parameters())
        micros = ([base_steps.micro_batch(batch, i) for i in range(accum_steps)] if accum
                  else [batch])
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss = torch.zeros((), dtype=torch.float32, device=params[0].device)
        for micro in micros:
            total, count = allm.forward_nll(frozen, trainable, cfg, micro, audio_start_id,
                                            audio_end_id, compute_dtype,
                                            loss_chunk_size=loss_chunk_size, remat=remat,
                                            tp_axis=tp, seq_axis=sp)
            # the whole micro-batch's sum and count, before the backward
            both = _psum_data(torch.stack([total.detach().float(), count.float()]), mesh)
            denom = both[1].clamp(min=1)
            micro_grads = base_steps.gradients(total / denom, params)
            grads = [acc + g.float() for acc, g in zip(grads, micro_grads)]
            loss = loss + both[0] / denom
        flat = _psum_data(torch.cat([g.reshape(-1) for g in grads]), mesh) / accum_steps
        grads = [g.view_as(p) for p, g in zip(params, flat.split([p.numel() for p in params]))]
        return loss / accum_steps, grads

    return grads_fn


def make_sharded_train_step(
    cfg: AudioLLMConfig,
    optimizer,
    mesh,
    batch_template: allm.AudioLLMBatch,
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype=torch.bfloat16,
    accum_steps: int = 1,
    donate_state: bool = True,
    loss_chunk_size: int = 0,
    remat: bool = False,
    attn_impl: str = "auto",
    enc_attn_impl: str = "auto",
    mel_impl: str = "auto",
    kernel_partition: bool = True,
):
    """-> step(state, frozen, batch) -> (state, {"loss", "grad_norm"}).
    `state` from `init_sharded_state`; `frozen` this rank's tree (the Llama
    cut by `shard_frozen_for_generation` under tp); `batch` the global batch
    (as `batch_template`, [A, B, ...] when accum_steps > 1) or this rank's
    rows of it; with no template, always this rank's rows (the trainer's
    loaders cut them). The loss is the whole batch's, on every rank.
    `optimizer`, `donate_state` and `kernel_partition` are unused (see the
    module docstring)."""
    check_impls(attn_impl=attn_impl, enc_attn_impl=enc_attn_impl, mel_impl=mel_impl)
    grads_fn = make_sharded_grad_fn(cfg, mesh, batch_template, audio_start_id, audio_end_id,
                                    compute_dtype, accum_steps, loss_chunk_size, remat)

    def step(state, frozen, batch):
        params = list(state.trainable.parameters())
        loss, grads = grads_fn(state.trainable, frozen, batch)
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype)
        grad_norm = state.optimizer.step()
        for p in params:
            p.grad = None
        return state._replace(step=state.step + 1), {"loss": loss, "grad_norm": grad_norm}

    return step


def make_sharded_eval_step(
    cfg: AudioLLMConfig,
    mesh,
    batch_template: allm.AudioLLMBatch,
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    enc_attn_impl: str = "auto",
    mel_impl: str = "auto",
    kernel_partition: bool = True,
):
    """-> eval(trainable, frozen, batch) -> the batch's mean loss, without
    autograd. Batches whose rows do not split over dp (x fsdp) run whole on
    every rank (eval is a small share of the work; sharded_train.py:168-181);
    the others (and every batch, with no template) as the train step's.
    `kernel_partition` is unused (see the module docstring)."""
    check_impls(attn_impl=attn_impl, enc_attn_impl=enc_attn_impl, mel_impl=mel_impl)
    check_mesh(mesh)
    tp, sp = _axis(mesh, "tp"), _axis(mesh, "sp")
    split = batch_template is None or batch_template.input_ids.shape[0] % (
        mesh.shape.get("dp", 1) * mesh.shape.get("fsdp", 1)) == 0

    @torch.no_grad()
    def step(trainable, frozen, batch):
        if split:
            batch = _rows(batch, batch_template, mesh, False)
        total, count = allm.forward_nll(frozen, trainable, cfg, batch, audio_start_id,
                                        audio_end_id, compute_dtype, tp_axis=tp, seq_axis=sp)
        both = torch.stack([total.float(), count.float()])
        both = _psum_data(both, mesh) if split else psum(both, sp)
        return both[0] / both[1].clamp(min=1)

    return step
