"""Optimizer and learning-rate schedule with optax's arithmetic.

Counterpart of `audio_llama_tpu/training/optim.py`, whose optimizer is
`optax.chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2, eps,
weight_decay))`. `OptaxAdamW` is that chain as a `torch.optim.Optimizer`:
the global norm over every gradient, the clip as optax writes it (no
`clip_grad_norm_` epsilon), Adam's moments and bias corrections, decoupled
decay on every leaf, then the step scaled by the schedule read at the count
BEFORE the update (so the first update has lr = schedule(0), which is 0
after a warm-up from 0). Its state converts to and from optax's layout under
`flax.serialization.to_state_dict`, so checkpoints cross between packages:

    {'0': {}, '1': {'0': {'count', 'mu', 'nu'}, '1': {}, '2': {'count'}}}

with int32 [] counts and mu / nu trees shaped like the trainable tree.

On one rank of a tensor-parallel trainer (`shard_norm`) some parameters are
this rank's block of a leaf: the global norm then sums the squares of the
replicated leaves once and the sharded blocks' squares over the tp axis, so
every rank clips by the same norm and the replicas stay equal. Adam's
moments follow their parameter, so they are blocks of the same leaves.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

Schedule = Callable[[int], float]


def cosine_schedule_with_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                                end_lr: float = 0.0) -> Schedule:
    """optax's `join_schedules([linear_schedule(0, peak, warmup),
    cosine_decay_schedule(peak, decay, alpha=end/peak)], [warmup])`,
    evaluated in f32 as optax does: linear 0 -> peak over the warm-up, then a
    half cosine from peak down to end_lr."""
    warmup_steps = max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)
    alpha = np.float32(end_lr / peak_lr if peak_lr else 0.0)
    f32 = np.float32

    def linear(count: int) -> np.float32:
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return (f32(0) - f32(peak_lr)) * frac + f32(peak_lr)

    def cosine(count: int) -> np.float32:
        c = f32(min(count, decay_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay_steps), dtype=f32))
        return f32(peak_lr) * ((f32(1) - alpha) * cos + alpha)

    def schedule(count: int) -> float:
        value = linear(count) if count < warmup_steps else cosine(count - warmup_steps)
        return float(np.float32(value))

    return schedule


class OptaxAdamW(torch.optim.Optimizer):
    """clip_by_global_norm(max_grad_norm) -> adamw(schedule, b1, b2, eps,
    weight_decay) over the parameters in their given order, in f32 on their
    device. `step()` reads `.grad` of every parameter (a missing gradient is
    an error: the optax chain updates every leaf) and returns the global norm
    before the clip, a 0-d tensor."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Schedule,
                 weight_decay: float = 0.01, max_grad_norm: float = 1.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        defaults = dict(weight_decay=weight_decay, max_grad_norm=max_grad_norm, b1=b1, b2=b2,
                        eps=eps)
        super().__init__(list(params), defaults)
        self.schedule = schedule
        self.tp_axis, self.sharded = None, None
        self.adam_count = 0  # optax ScaleByAdamState.count
        self.schedule_count = 0  # optax ScaleByScheduleState.count
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p]["mu"] = torch.zeros_like(p, dtype=torch.float32)
                self.state[p]["nu"] = torch.zeros_like(p, dtype=torch.float32)

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def shard_norm(self, tp_axis, sharded) -> None:
        """Mark the parameters (in order) that are tp blocks of their leaves
        (`sharded`, booleans) for the global norm over `tp_axis`."""
        sharded = [bool(f) for f in sharded]
        if len(sharded) != len(self._params()):
            raise ValueError("one sharded flag per parameter")
        self.tp_axis, self.sharded = tp_axis, sharded

    def _global_norm(self, grads) -> torch.Tensor:
        if self.sharded is None:
            return torch.sqrt(sum(torch.sum(g * g) for g in grads))
        from ..parallel.collectives import psum

        zero = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        rep = sum((torch.sum(g * g) for g, f in zip(grads, self.sharded) if not f), zero)
        blocks = sum((torch.sum(g * g) for g, f in zip(grads, self.sharded) if f), zero)
        return torch.sqrt(rep + psum(blocks, self.tp_axis))

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("OptaxAdamW.step takes no closure")
        params = self._params()
        if any(p.grad is None for p in params):
            raise RuntimeError("OptaxAdamW: every trainable leaf needs a gradient")
        grads = [p.grad.float() for p in params]
        g_norm = self._global_norm(grads)
        group = self.param_groups[0]
        b1, b2, eps, wd = group["b1"], group["b2"], group["eps"], group["weight_decay"]
        max_norm = group["max_grad_norm"]
        trigger = g_norm < max_norm
        count = self.adam_count + 1
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        lr = self.schedule(self.schedule_count)
        for p, g in zip(params, grads):
            g = torch.where(trigger, g, (g / g_norm) * max_norm)
            st = self.state[p]
            mu = (1 - b1) * g + b1 * st["mu"]
            nu = (1 - b2) * (g * g) + b2 * st["nu"]
            st["mu"], st["nu"] = mu, nu
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            update = update + wd * p.float()
            p.copy_((p.float() + (-lr) * update).to(p.dtype))
        self.adam_count = count
        self.schedule_count += 1
        return g_norm

    def moment_trees(self, tree) -> tuple:
        """(mu, nu): nested dicts of the moment tensors, shaped like `tree`
        (the ParamTree these parameters came from)."""
        by_id = {id(p): self.state[p] for p in self._params()}

        def moments(node, key):
            if isinstance(node, Mapping) or hasattr(node, "items"):
                return {k: moments(v, key) for k, v in node.items()}
            return by_id[id(node)][key]

        return moments(tree, "mu"), moments(tree, "nu")

    def optax_state(self, tree, moments=None) -> dict:
        """The state in optax's layout, numpy on the host; `tree` (the
        ParamTree these parameters came from) gives the nesting.
        `moments`: (mu, nu) trees to write in place of this optimizer's own
        (a sharded trainer's, gathered whole)."""
        from ..bridge import to_numpy

        mu, nu = self.moment_trees(tree) if moments is None else moments
        return {
            "0": {},
            "1": {
                "0": {"count": np.asarray(self.adam_count, np.int32),
                      "mu": to_numpy(mu), "nu": to_numpy(nu)},
                "1": {},
                "2": {"count": np.asarray(self.schedule_count, np.int32)},
            },
        }

    def load_optax_state(self, tree, state: Mapping) -> None:
        """Restore from optax's layout (as `optax_state` returns it, or as
        a checkpoint written by either package holds it)."""
        adam = state["1"]["0"]

        def load(node, mu, nu):
            if hasattr(node, "items"):
                if set(node.keys()) != set(mu.keys()):
                    raise ValueError(f"optimizer state keys {sorted(mu)} != "
                                     f"trainable keys {sorted(node.keys())}")
                for k, v in node.items():
                    load(v, mu[k], nu[k])
                return
            st = self.state[node]
            for key, val in (("mu", mu), ("nu", nu)):
                arr = np.asarray(val)
                if arr.shape != tuple(node.shape):
                    raise ValueError(f"optimizer {key} shape {arr.shape} != {tuple(node.shape)}")
                st[key] = torch.from_numpy(arr.astype(np.float32)).to(node.device)

        load(tree, adam["mu"], adam["nu"])
        self.adam_count = int(adam["count"])
        self.schedule_count = int(state["1"]["2"]["count"])
