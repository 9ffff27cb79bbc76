"""The rank side of the sharded-training tests, and the differentiable
collectives in a gloo world.

`tests/test_torch_ring.py` and `tests/test_torch_sharded_train.py` spawn
their worlds with the functions below: this module imports torch and the
port only, so a spawned rank does not import JAX. Its own tests hold
`collectives.copy_to` / `reduce_from` / `gather_from` / `ppermute` (values
and gradients) against their definitions in a world of 4 CPU ranks.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.parallel import collectives, distributed  # noqa: E402
from audio_llama_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from audio_llama_tpu_torch.parallel import sharded_train, sharding  # noqa: E402
from audio_llama_tpu_torch.parallel.ring_attention import ring_causal_mha  # noqa: E402
from audio_llama_tpu_torch.parallel.ring_kernel import ring_causal_mha_kernel  # noqa: E402

WORLD_TIMEOUT = 240  # seconds: a few times a world's normal run


# ---------------------------------------------------------------------------
# ranks: the differentiable collectives

def _collectives(rank, world):
    mesh = t_mesh.build_mesh([("tp", world)])
    ax = mesh.axis("tp")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out = {}
    for name, fn in (("copy", lambda t: collectives.copy_to(t, ax)),
                     ("reduce", lambda t: collectives.reduce_from(t, ax)),
                     ("gather", lambda t: collectives.gather_from(t, ax, dim=1)),
                     ("ppermute", lambda t: collectives.ppermute(t, ax, 1)),
                     ("ppermute-2", lambda t: collectives.ppermute(t, ax, -2))):
        xi = x.clone().requires_grad_(True)
        y = fn(xi)
        w = torch.ones_like(y) * (rank + 1) + torch.arange(y.numel()).reshape(y.shape)
        (y * w).sum().backward()
        out[name] = (y.detach(), xi.grad)
    out["route"] = collectives.ppermute_route(ax, x)
    return out


# ---------------------------------------------------------------------------
# ranks: the ring

def ring_cases(rank, world, cases):
    """Each case (q, k, v, mask, w, dtype): the global arrays; this rank runs
    its slice through the plain ring and the kernel ring (plain kernels on
    the CPU) and returns, per ring, (o, dq, dk, dv) of its slice for the
    loss sum(o * w)."""
    from audio_llama_tpu_torch.ops import causal_attention as ca

    mesh = t_mesh.build_mesh([("sp", world)])
    ax = mesh.axis("sp")
    results = []
    for q, k, v, mask, w, dtype in cases:
        Tl = q.shape[1] // world
        sl = slice(rank * Tl, (rank + 1) * Tl)
        dt = getattr(torch, dtype)
        got = {}
        for name, ring in (("plain", ring_causal_mha), ("kernel", ring_causal_mha_kernel)):
            ts = [torch.from_numpy(np.ascontiguousarray(x[:, sl])).to(dt).requires_grad_(True)
                  for x in (q, k, v)]
            never = ca.launches_never
            o = ring(*ts, axis=ax, mask=torch.from_numpy(np.ascontiguousarray(mask[:, sl])))
            grads = torch.autograd.grad(o, ts, torch.from_numpy(w[:, sl]).to(dt))
            got[name] = (o.detach(), *grads)
            assert ca.launches_never == never  # CPU tensors run the plain versions
        results.append(got)
    return results


# ---------------------------------------------------------------------------
# ranks: sharded train steps

def _optimizer(schedule_args):
    from audio_llama_tpu_torch.training import optim

    schedule = optim.cosine_schedule_with_warmup(*schedule_args)
    return lambda params: optim.OptaxAdamW(params, schedule, weight_decay=0.01,
                                           max_grad_norm=1.0)


def _torch_batch(b):
    from audio_llama_tpu_torch.models.allm import AudioLLMBatch

    return AudioLLMBatch(*(None if x is None else torch.from_numpy(x) for x in b))


def train_arms(rank, world, cfg_dict, frozen_np, trainable_np, batches, arms, schedule_args,
               sid, eid):
    """Each arm (name, (dp, tp, sp), accum): a mesh over the whole world,
    this rank's blocks of the bridged trees, one sharded step per batch
    (global numpy batches). Per arm and step: loss, grad norm, the gathered
    trainable tree and this rank's replicated leaves (for the bit-equality
    check)."""
    from audio_llama_tpu_torch.config import AudioLLMConfig

    cfg = AudioLLMConfig.from_dict(cfg_dict)
    out = {}
    for name, (dp, tp, sp), accum in arms:
        mesh = t_mesh.make_mesh(t_mesh.MeshConfig(dp=dp, fsdp=1, tp=tp, sp=sp))
        frozen = bridge.from_jax(frozen_np, "cpu")
        if tp > 1:
            frozen = sharding.shard_frozen_for_generation(mesh, frozen)
        trainable = bridge.from_jax(trainable_np, "cpu")
        state = sharded_train.init_sharded_state(mesh, trainable, _optimizer(schedule_args))
        template = _torch_batch(batches[0])
        step = sharded_train.make_sharded_train_step(
            cfg, None, mesh, template, sid, eid, torch.float32, accum_steps=accum)
        flags = sharding.sharded_flags(state.trainable)
        steps = []
        for b in batches:
            state, metrics = step(state, frozen, _torch_batch(b))
            whole, opt = sharded_train.gather_train_state(mesh, state)
            replicated = {n: p.detach().clone() for (n, p), f in
                          zip(state.trainable.named_parameters(), flags) if not f}
            steps.append({"loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]),
                          "trainable": bridge.to_numpy(whole) if rank == 0 else None,
                          "mu": opt["1"]["0"]["mu"] if rank == 0 else None,
                          "replicated": replicated})
        out[name] = steps
    return out


def train_cli(rank, world, argv):
    """The trainer CLI on this rank of the running world."""
    from audio_llama_tpu_torch.training.train import parse_args, train

    res = train(parse_args(list(argv) + ["--distributed", "--num_processes", str(world),
                                         "--process_id", str(rank)]))
    return {"steps": res["steps"], "final_checkpoint": res["final_checkpoint"],
            "loss": res.get("train/loss")}


def jobs(rank, world, items):
    """Several rank functions of this module in one world, in order: items
    [(name, args)] -> their results."""
    return [globals()[name](rank, world, *args) for name, args in items]


# ---------------------------------------------------------------------------
# tests

@pytest.fixture(scope="module")
def world4():
    return distributed.spawn(_collectives, 4, threads=1, timeout=WORLD_TIMEOUT)


def test_copy_to_is_identity_with_a_summed_cotangent(world4):
    xs = [torch.arange(6.).reshape(2, 3) + 10 * r for r in range(4)]
    ws = [torch.ones(2, 3) * (r + 1) + torch.arange(6.).reshape(2, 3) for r in range(4)]
    for r, res in enumerate(world4):
        y, g = res["copy"]
        assert torch.equal(y, xs[r])
        assert torch.equal(g, sum(ws))


def test_reduce_from_sums_with_an_identity_cotangent(world4):
    for r, res in enumerate(world4):
        y, g = res["reduce"]
        assert torch.equal(y, sum(torch.arange(6.).reshape(2, 3) + 10 * i for i in range(4)))
        assert torch.equal(g, torch.ones(2, 3) * (r + 1) + torch.arange(6.).reshape(2, 3))


def test_gather_from_keeps_each_ranks_slice_of_the_cotangent(world4):
    whole = torch.cat([torch.arange(6.).reshape(2, 3) + 10 * i for i in range(4)], dim=1)
    for r, res in enumerate(world4):
        y, g = res["gather"]
        assert torch.equal(y, whole)
        w = torch.ones(2, 12) * (r + 1) + torch.arange(24.).reshape(2, 12)
        assert torch.equal(g, w[:, 3 * r:3 * r + 3])


@pytest.mark.parametrize("name,shift", [("ppermute", 1), ("ppermute-2", -2)])
def test_ppermute_rotates_and_its_cotangent_rotates_back(world4, name, shift):
    for r, res in enumerate(world4):
        y, g = res[name]
        src = (r - shift) % 4
        assert torch.equal(y, torch.arange(6.).reshape(2, 3) + 10 * src)
        dst = (r + shift) % 4  # the rank that received this rank's block
        assert torch.equal(g, torch.ones(2, 3) * (dst + 1) + torch.arange(6.).reshape(2, 3))
    assert {res["route"] for res in world4} == {"direct"}
