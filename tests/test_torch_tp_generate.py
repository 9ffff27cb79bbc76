"""Tensor-parallel and data-parallel generation of the port against the
JAX package's `make_tp_generate` / `make_dp_generate` on the 8-device CPU
mesh (tests/conftest.py).

The cases mirror `tests/test_tp_generate.py` and `tests/test_dp_generate.py`:
tp 2 and dp 2 x tp 2 on the f32 tree, tp 2 on the weight-only int8 tree and
on the int4 tree packed after the shard (`quantize_llama_int4(tp=2,
fuse=False)`, bridged from JAX so both packages hold the same bytes), dp 4
on the f32 and int8 trees; B = 4 with a right-padded row and 30 s audio.
The LoRA factors are non-zero (both a and b), so the column- and
row-parallel LoRA shards carry weight. The port runs in one gloo world of 4
CPU ranks, spawned once (the rank side in `test_torch_world.py`). Bar:
greedy tokens equal token for token at f32, on every rank. The refusals
raise where JAX's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.models import llama_int8 as j_l8  # noqa: E402
from audio_llama_tpu.parallel import MeshConfig as JMeshConfig  # noqa: E402
from audio_llama_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.parallel import distributed  # noqa: E402
from audio_llama_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from audio_llama_tpu_torch.parallel import sharding as t_shd  # noqa: E402

import test_torch_world as ranks  # noqa: E402  (the rank side; no JAX)
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

JCFG = JCfg.tiny()
CFG = AudioLLMConfig.tiny()
STATIC = dict(max_new_tokens=6, greedy=True, eos_id=-1, pad_id=0, audio_start_id=260,
              audio_end_id=261, has_audio=True)


def _inputs(B=4, T=9, seed=0, pad=True):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 250, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    if pad:
        mask[1, 7:] = 0  # a right-padded row
    audio = (rng.randn(B, CFG.mel.max_samples) * 0.1).astype(np.float32)
    return ids, mask, audio


def _case(name, kind, cfg4, tree, inputs, **over):
    dp, fsdp, tp, sp = cfg4
    return dict(name=name, kind=kind, axes=list(zip(t_mesh.AXES, cfg4)), tree=tree,
                ids=inputs[0], mask=inputs[1], audio=inputs[2], static=dict(STATIC, **over))


CASES = [
    _case("tp2", "tp", (1, 1, 2, 1), "f32", _inputs()),
    _case("dp2 tp2", "tp", (2, 1, 2, 1), "f32", _inputs(seed=1)),
    _case("tp2 int8", "tp", (1, 1, 2, 1), "int8", _inputs(seed=2)),
    _case("tp2 int4 (tp=2 packing)", "tp", (1, 1, 2, 1), "int4 tp2", _inputs(seed=3)),
    _case("dp4", "dp", (4, 1, 1, 1), "f32", _inputs(B=8, T=10, seed=0, pad=False)),
    _case("dp4 int8", "dp", (4, 1, 1, 1), "int8", _inputs(B=4, T=8, seed=1, pad=False),
          max_new_tokens=5),
]


@pytest.fixture(scope="module")
def trees():
    kf, kt = jax.random.split(jax.random.PRNGKey(0))
    frozen = j_allm.init_frozen(JCFG, kf, dtype=jnp.float32)
    trainable = j_allm.init_trainable(JCFG, kt)
    rng = np.random.default_rng(0)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        for f in ("a", "b"):
            br[f] = jnp.asarray(rng.normal(size=br[f].shape).astype(np.float32) * 0.1)
    out = {"f32": (frozen, trainable)}
    out["int8"] = (dict(frozen, llama=j_l8.quantize_llama(frozen["llama"])), trainable)
    out["int4 tp2"] = (dict(frozen, llama=j_l4.quantize_llama_int4(frozen["llama"], tp=2,
                                                                     group=32)), trainable)
    return out


@pytest.fixture(scope="module")
def jax_tokens(trees):
    out = {}
    for c in CASES:
        n = int(np.prod([s for _, s in c["axes"]]))
        mesh = j_make_mesh(JMeshConfig(*[s for _, s in c["axes"]]), devices=jax.devices()[:n])
        make = j_gen.make_tp_generate if c["kind"] == "tp" else j_gen.make_dp_generate
        fn = make(JCFG, mesh, compute_dtype=jnp.float32, **c["static"])
        frozen, trainable = trees[c["tree"]]
        res = fn(frozen, trainable, jnp.asarray(c["ids"]), jnp.asarray(c["mask"]),
                 jnp.asarray(c["audio"]), jax.random.PRNGKey(0))
        out[c["name"]] = (np.asarray(res.tokens), np.asarray(res.num_generated))
    return out


@pytest.fixture(scope="module")
def world(trees):
    trees_np = {k: tuple(jax.tree.map(np.asarray, t) for t in v) for k, v in trees.items()}
    return ranks.Spawned(ranks.generate_cases, 4, args=(trees_np, CASES), threads=1,
                         timeout=240)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_sharded_generate_matches_jax(world, jax_tokens, name):
    case = next(c for c in CASES if c["name"] == name)
    want_tokens, want_num = jax_tokens[name]
    for r in range(int(np.prod([s for _, s in case["axes"]]))):
        tokens, num = world[r][name]
        np.testing.assert_array_equal(tokens.numpy(), want_tokens, err_msg=f"rank {r}")
        np.testing.assert_array_equal(num.numpy(), want_num, err_msg=f"rank {r}")


def test_sampled_dp_rows_agree_across_ranks(trees):
    static = dict(STATIC, greedy=False, temperature=1.0)
    out = distributed.spawn(ranks.sampled_dp, 2, args=(
        jax.tree.map(np.asarray, trees["f32"]), _inputs(), static), threads=1, timeout=240)
    for a, b in zip(out[0], out[1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert not np.array_equal(out[0][0].numpy(), out[0][1].numpy())  # the seed matters


def _mesh(dp=1, fsdp=1, tp=1, sp=1):
    """A mesh object for the refusals, which raise before any collective."""
    return t_mesh.Mesh(list(zip(t_mesh.AXES, (dp, fsdp, tp, sp))), 0)


def test_tp_generate_refusals(trees):
    with pytest.raises(ValueError, match="divide"):
        t_gen.make_tp_generate(CFG, _mesh(tp=8), **STATIC)
    with pytest.raises(ValueError, match="fsdp=1"):
        t_gen.make_tp_generate(CFG, _mesh(fsdp=2, tp=2), **STATIC)
    with pytest.raises(ValueError, match="dp-only"):
        t_gen.make_dp_generate(CFG, _mesh(dp=4, tp=2), **STATIC)
    frozen, trainable = trees["f32"]
    fn = t_gen.make_tp_generate(CFG, _mesh(tp=2), device="cpu", **STATIC)
    ids, mask, audio = (torch.from_numpy(a) for a in _inputs())
    tt = bridge.from_jax(jax.tree.map(np.asarray, trainable), "cpu")
    # the default int4 tree is fused: refused outright
    fused = bridge.from_jax(jax.tree.map(np.asarray, dict(
        frozen, llama=j_l4.quantize_llama_int4(frozen["llama"], group=32))), "cpu")
    with pytest.raises(ValueError, match="fused int4"):
        fn(fused, tt, ids, mask, audio)
    # the unfused tree packed for tp=1: refused for its layout
    canon = bridge.from_jax(jax.tree.map(np.asarray, dict(
        frozen, llama=j_l4.quantize_llama_int4(frozen["llama"], group=32, fuse=False))), "cpu")
    with pytest.raises(ValueError, match="packed for tp=1"):
        fn(canon, tt, ids, mask, audio)


def test_a_pre_cut_block_is_refused(trees):
    """make_tp_generate takes the full tree, as JAX's does: one rank's block
    of the tp=2 int4 tree (cut by `shard_frozen_for_generation`) reads as
    a tree packed for tp=1 and is refused, not cut again."""
    frozen = bridge.from_jax(jax.tree.map(np.asarray, trees["int4 tp2"][0]), "cpu")
    block = t_shd.shard_frozen_for_generation(_mesh(tp=2), frozen)
    tt = bridge.from_jax(jax.tree.map(np.asarray, trees["int4 tp2"][1]), "cpu")
    fn = t_gen.make_tp_generate(CFG, _mesh(tp=2), device="cpu", **STATIC)
    ids, mask, audio = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="packed for tp=1"):
        fn(block, tt, ids, mask, audio)
