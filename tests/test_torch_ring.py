"""The ring of sequence-parallel training against the JAX package, on the CPU.

- The plain versions of the causal kernels in their tri='never' mode (the
  forward, dq and dk/dv of one ring hop) against JAX's `_fwd_call`,
  `_dq_call` and `_dkv_call(tri='never')` in interpret mode, fed the same
  inputs and statistics.
- The plain ring (`parallel/ring_attention.py`) and the kernel ring
  (`parallel/ring_kernel.py`, plain kernels on CPU tensors) in gloo worlds
  of 2 and 4 CPU ranks (the rank side in `test_torch_shard_world.py`)
  against JAX's `ring_attention_sharded` on the 8-device CPU mesh and the
  single-device `causal_mha` (interpret mode): outputs, and the gradients
  of sum(o * w) against `jax.grad`, with a padded row.

Tolerance at f32: 5e-5 absolute and relative (the JAX package's own kernel
test), valid query rows only (padded query rows are garbage in both
packages).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

torch.set_num_threads(2)

from audio_llama_tpu.ops import causal_attention as j_ca  # noqa: E402
from audio_llama_tpu.parallel.ring_attention import ring_attention_sharded  # noqa: E402
from audio_llama_tpu_torch.ops import causal_attention as ca  # noqa: E402

import test_torch_shard_world as ranks  # noqa: E402  (the rank side; no JAX)
from test_torch_world import Spawned  # noqa: E402  (a world run beside the JAX references)
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

TOL = dict(atol=5e-5, rtol=5e-5)


def _case(B=2, T=256, Hq=4, Hkv=2, hd=32, pad_from=200, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, h, hd)).astype(np.float32) * 0.5
               for h in (Hq, Hkv, Hkv))
    mask = np.ones((B, T), np.int32)
    mask[0, pad_from:] = 0
    w = rng.normal(size=(B, T, Hq, hd)).astype(np.float32)
    return q, k, v, mask, w


def _heads(x):  # [B, T, H, hd] -> [B*H, T, hd]
    x = np.asarray(x)
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3]))


def _unheads(x, B):  # [B*H, T, hd] -> [B, T, H, hd]
    x = np.asarray(x)
    return x.reshape(B, -1, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


# --- one hop: the plain tri='never' versions against JAX's kernels ----------

def _hop_inputs():
    """A hop whose keys come from another shard: its own q and k/v, the
    source shard's padding bias (-1e9 on its last 56 keys of row 0)."""
    q, k, v, mask, w = _case(seed=1)
    hd = q.shape[-1]
    qs = torch.from_numpy(q) * hd ** -0.5
    bias = torch.where(torch.from_numpy(mask) != 0, 0.0, ca.NEG)
    return qs, torch.from_numpy(k), torch.from_numpy(v), bias, torch.from_numpy(w)


def test_never_forward_plain_matches_the_jax_kernel():
    qs, k, v, bias, _ = _hop_inputs()
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    o, l, m = ca.causal_attention_plain(qs, k, v, bias, tri="never")
    kn = jnp.zeros((B * Hkv, 1, 1), jnp.float32)
    jo, jl, jm = j_ca._fwd_call(_heads(qs), _heads(k), _heads(v),
                                jnp.asarray(bias.numpy())[:, None, :], kn, Hq, Hkv, bq=128,
                                ck=128, interpret=True, tri="never")
    np.testing.assert_allclose(o.numpy(), _unheads(jo, B), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl)[:, 0], **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[:, 0], **TOL)
    # every key contributes: the first query row sees all its hop's keys
    causal = ca.causal_attention_plain(qs, k, v, bias, tri="always")
    assert not np.allclose(o.numpy()[:, 0], causal.o.numpy()[:, 0])


def test_never_backward_plain_matches_the_jax_kernels():
    """dq and dk/dv of a hop fed another row statistic than the hop's own
    (the ring's merged m, l and D; here those of the causal attention of
    the same q), as JAX's `_dq_call` / `_dkv_call(tri='never')`."""
    qs, k, v, bias, do = _hop_inputs()
    B, T, Hq, hd = qs.shape
    Hkv = k.shape[2]
    o, l, m = ca.causal_attention_plain(qs, k, v, bias, tri="always")
    got = ca.causal_attention_bwd_plain(qs, k, v, bias, o, l, m, do, tri="never")
    d = ca.attention_bwd_prologue(o, do)
    args = (_heads(qs), _heads(k), _heads(v), jnp.asarray(bias.numpy())[:, None, :],
            jnp.asarray(m.numpy())[:, None, :], _heads(do), jnp.asarray(l.numpy())[:, None, :],
            jnp.asarray(d.numpy())[:, None, :], Hq, Hkv)
    kw = dict(bq=128, ck=128, interpret=True, tri="never")
    want = (j_ca._dq_call(*args, **kw), *j_ca._dkv_call(*args, **kw))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _unheads(wnt, B), **TOL)
    always = ca.causal_attention_bwd_plain(qs, k, v, bias, o, l, m, do, tri="always")
    assert not np.allclose(got[1].numpy(), always[1].numpy())


# --- the rings in gloo worlds ------------------------------------------------

CASE = _case()


class _RingWorld:
    """A world of n ranks running the ring cases in a thread (`Spawned`):
    `n` at once, `got` (each arm's o, dq, dk, dv gathered over the ranks)
    once the world is done, so a test computes its JAX reference first."""

    def __init__(self, n):
        q, k, v, mask, w = CASE
        self.n = n
        self._world = Spawned(ranks.ring_cases, n, args=([(q, k, v, mask, w, "float32")],),
                              threads=1, timeout=ranks.WORLD_TIMEOUT)

    @functools.cached_property
    def got(self):
        return {name: [np.concatenate([r[0][name][i].numpy() for r in self._world], axis=1)
                       for i in range(4)] for name in ("plain", "kernel")}


@pytest.fixture(scope="module", params=[2, 4], ids=["sp2", "sp4"])
def world(request):
    return _RingWorld(request.param)


def _loss(fn, w):
    return lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) * w)


@pytest.fixture(scope="module")
def jax_single():
    q, k, v, mask, w = CASE

    def attn(q_, k_, v_):
        return j_ca.causal_mha(q_, k_, v_, mask=jnp.asarray(mask), interpret=True,
                               block_q=128, chunk_k=128)

    args = [jnp.asarray(x) for x in (q, k, v)]
    o = attn(*args)
    return [np.asarray(o)] + [np.asarray(g) for g in
                              jax.grad(_loss(attn, w), argnums=(0, 1, 2))(*args)]


@functools.lru_cache(maxsize=None)
def _jax_ring(n):
    q, k, v, mask, w = CASE
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))
    ring = ring_attention_sharded(mesh, "sp")

    def attn(q_, k_, v_):
        return ring(q_, k_, v_, jnp.asarray(mask))

    args = [jnp.asarray(x) for x in (q, k, v)]
    o = jax.jit(attn)(*args)
    grads = jax.jit(jax.grad(_loss(attn, w), argnums=(0, 1, 2)))(*args)
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


def _compare(got, want):
    valid = CASE[3].astype(bool)
    for i, (g, wnt) in enumerate(zip(got, want)):
        if i < 2:  # o and dq: valid query rows
            g, wnt = g[valid], wnt[valid]
        np.testing.assert_allclose(g, wnt, err_msg="o dq dk dv".split()[i], **TOL)


@pytest.mark.parametrize("ring", ["plain", "kernel"])
def test_ring_matches_the_jax_ring(world, ring):
    want = _jax_ring(world.n)  # while the world runs
    _compare(world.got[ring], want)


@pytest.mark.parametrize("ring", ["plain", "kernel"])
def test_ring_matches_single_device_causal_attention(world, jax_single, ring):
    _compare(world.got[ring], jax_single)
