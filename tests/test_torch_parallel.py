"""The port's process-mesh layer and the timeline-sharded decode kernels
against the JAX package.

- The stats kernels' plain versions (`decode_attention_db_stats`, its int8
  and int4 twins) against JAX's interpret-mode Pallas kernels on
  numpy-seeded inputs: the owner appends, a non-owner does not, an
  all-invalid slab gives (-5e29, 0, 0); m, l and acc at f32 within 1e-5, the
  caches bit-equal after the call.
- Meshes: rank r's coordinates are those JAX `make_mesh` gives device r, the
  process-group lines follow the mesh, `MeshConfig.resolve` raises as JAX's.
- Sharding: the port's Megatron specs equal JAX `llama_specs` /
  `trainable_specs` leaf for leaf (bf16, int8, fused, unfused and tp-packed
  int4 trees), and each rank's block equals the shard JAX places on the
  device of that rank.
- int4 trees: the unfused (tp=1) and pack-after-shard (tp=2) trees against
  JAX `quantize_llama_int4(fuse=False, tp=1|2)`.
- In a gloo world of 4 CPU ranks (spawned once; the rank side in
  `test_torch_world.py`): `merge_partial_stats` over 2 and 4 slabs equals
  the plain single-slab decode, `sp_partial_attention` over 2 and 4 slabs
  equals JAX's XLA arm under shard_map, and `make_sp_encode` (sp 4,
  dp 2 x sp 2) equals JAX's within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.models import llama_int8 as j_l8  # noqa: E402
from audio_llama_tpu.ops import attention as j_att  # noqa: E402
from audio_llama_tpu.ops import decode_attention_db as j_db  # noqa: E402
from audio_llama_tpu.parallel import MeshConfig as JMeshConfig  # noqa: E402
from audio_llama_tpu.parallel import best_mesh_shape as j_best  # noqa: E402
from audio_llama_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from audio_llama_tpu.parallel import sharding as j_shd  # noqa: E402
from audio_llama_tpu.parallel.seq_parallel import make_sp_encode as j_sp_encode  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.models import llama_int4 as t_l4  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_db as db  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_mono as dm  # noqa: E402
from audio_llama_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from audio_llama_tpu_torch.parallel import sharding as t_shd  # noqa: E402
from audio_llama_tpu_torch.parallel.seq_parallel import make_sp_encode  # noqa: E402

import test_torch_world as ranks  # noqa: E402  (the rank side; no JAX)
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

JCFG = JCfg.tiny()
CFG = AudioLLMConfig.tiny()
L, B, HKV, HQ, S, HD = 2, 2, 2, 4, 64, 32
SCALE = HD ** -0.5


def _np(x):
    return np.asarray(x)


def _flat(tree, prefix=()):
    """{path tuple: leaf} of a nested dict / ParamTree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


# ---------------------------------------------------------------------------
# the stats kernels' plain versions against JAX's interpret-mode kernels
# ---------------------------------------------------------------------------

def _stats_case(seed, case):
    """Inputs of one call: local offset 19 (owner), 64 + 7 (past the slab:
    a later rank owns it) or -25 (an earlier rank owns it); `all_invalid`
    clears the whole mask."""
    rng = np.random.default_rng(seed)
    off = {"owner": 19, "later_owner": S + 7, "earlier_owner": -25, "all_invalid": 19}[case]
    valid = (np.arange(S)[None, :] <= min(off, S - 1)).astype(np.int32).repeat(B, 0)
    if case == "earlier_owner":  # every slot of an earlier window is in the past
        valid[:] = 1
    valid[0, 3:6] = 0
    valid[1, 10] = 0
    if case == "all_invalid":
        valid[:] = 0
    q = rng.normal(size=(B, HQ, HD)).astype(np.float32)
    return rng, off, valid, q


def _bf16_inputs(seed, case):
    rng, off, valid, q = _stats_case(seed, case)
    kn, vn = (rng.normal(size=(B, HKV, HD)).astype(np.float32) for _ in range(2))
    ck, cv = (rng.normal(size=(L, B, HKV, S, HD)).astype(np.float32) for _ in range(2))
    return off, valid, q, kn, vn, ck, cv


def _quant_inputs(seed, case, bits):
    rng, off, valid, q = _stats_case(seed, case)

    def nrm(*shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32))

    if bits == 8:
        (kn, ksn), (vn, vsn) = (j_llama.quantize_kv_rows(nrm(B, HKV, HD)) for _ in range(2))
        (ck, ks), (cv, vs) = (j_llama.quantize_kv_rows(nrm(L, B, HKV, S, HD)) for _ in range(2))
        arrs = (kn, vn, ck, cv, ks, vs, ksn, vsn)
    else:
        kvn, ksn, vsn = j_llama.quantize_kv_rows4(nrm(B, HKV, HD), nrm(B, HKV, HD))
        ckv, ks, vs = j_llama.quantize_kv_rows4(nrm(L, B, HKV, S, HD), nrm(L, B, HKV, S, HD))
        arrs = (kvn, ckv, ks, vs, ksn, vsn)
    return (off, valid, q) + tuple(_np(a).copy() for a in arrs)


def _check_stats(got, want, caches_got, caches_want, caches_before, owner):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-5, atol=1e-5)
    for cg, cw, c0 in zip(caches_got, caches_want, caches_before):
        np.testing.assert_array_equal(cg.numpy(), _np(cw))
        if not owner:
            np.testing.assert_array_equal(cg.numpy(), c0)


CASES = ["owner", "later_owner", "earlier_owner", "all_invalid"]


@pytest.mark.parametrize("case", CASES)
def test_db_stats_plain_matches_the_pallas_kernel(case):
    off, valid, q, kn, vn, ck, cv = _bf16_inputs(1, case)
    li = 1
    want = j_db.decode_attention_db_stats(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck), jnp.asarray(cv),
        li, off, jnp.asarray(valid), SCALE, interpret=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = db.decode_attention_db_stats(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv, li, off,
        torch.from_numpy(valid), SCALE)
    _check_stats(got[:3], want[:3], got[3:], want[3:], (ck, cv), 0 <= off < S)
    if case == "all_invalid":
        np.testing.assert_array_equal(got[0].numpy(), np.full((B, HQ), -5e29, np.float32))
        assert not got[1].any() and not got[2].any()


@pytest.mark.parametrize("case", CASES)
def test_quantized_db_stats_plain_matches_the_pallas_kernel(case):
    off, valid, q, kn, vn, ck, cv, ks, vs, ksn, vsn = _quant_inputs(2, case, 8)
    li = 1
    want = j_db.decode_attention_quantized_db_stats(
        *(jnp.asarray(a) for a in (q, kn, vn, ck, cv, ks[li], vs[li], ksn, vsn)),
        li, off, jnp.asarray(valid), SCALE, interpret=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = db.decode_attention_quantized_db_stats(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk, tv,
        torch.from_numpy(ks), torch.from_numpy(vs), torch.from_numpy(ksn),
        torch.from_numpy(vsn), li, off, torch.from_numpy(valid), SCALE)
    _check_stats(got[:3], want[:3], got[3:], want[3:], (ck, cv), 0 <= off < S)


@pytest.mark.parametrize("case", CASES)
def test_quantized4_db_stats_plain_matches_the_pallas_kernel(case):
    off, valid, q, kvn, ckv, ks, vs, ksn, vsn = _quant_inputs(3, case, 4)
    li = 0
    want = j_db.decode_attention_quantized4_db_stats(
        *(jnp.asarray(a) for a in (q, kvn, ckv, ks[li], vs[li], ksn, vsn)),
        li, off, jnp.asarray(valid), SCALE, interpret=True)
    t_ckv = torch.from_numpy(ckv.copy())
    got = db.decode_attention_quantized4_db_stats(
        torch.from_numpy(q), torch.from_numpy(kvn), t_ckv, torch.from_numpy(ks),
        torch.from_numpy(vs), torch.from_numpy(ksn), torch.from_numpy(vsn), li, off,
        torch.from_numpy(valid), SCALE)
    _check_stats(got[:3], want[:3], got[3:], want[3:], (ckv,), 0 <= off < S)


def test_stats_kernels_refuse_a_device_offset():
    off, valid, q, kn, vn, ck, cv = _bf16_inputs(1, "owner")
    with pytest.raises(TypeError, match="Python int"):
        db.decode_attention_db_stats(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            torch.from_numpy(ck), torch.from_numpy(cv), 0, torch.tensor(off),
            torch.from_numpy(valid), SCALE)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

MESHES = [JMeshConfig(dp=2, tp=2), JMeshConfig(dp=2, sp=2), JMeshConfig(dp=1, tp=2, sp=2),
          JMeshConfig(dp=2, fsdp=1, tp=2, sp=2), JMeshConfig(dp=-1, tp=4),
          JMeshConfig(dp=1, fsdp=2, tp=2, sp=2)]


@pytest.mark.parametrize("cfg", MESHES, ids=str)
def test_rank_coordinates_follow_jax_device_order(cfg):
    n = 8 if cfg.dp == -1 or cfg.dp * cfg.fsdp * cfg.tp * cfg.sp == 8 else 4
    jm = j_make_mesh(cfg, devices=jax.devices()[:n])
    shape = t_mesh.MeshConfig(cfg.dp, cfg.fsdp, cfg.tp, cfg.sp).resolve(n)
    assert tuple(jm.devices.shape) == shape
    for pos, dev in np.ndenumerate(jm.devices):
        assert t_mesh.mesh_coords(shape, dev.id) == pos
        m = t_mesh.Mesh(list(zip(t_mesh.AXES, shape)), dev.id)
        assert tuple(m.coords[a] for a in t_mesh.AXES) == pos
    for ax, name in enumerate(t_mesh.AXES):  # each line: the devices along one axis
        want = np.moveaxis(np.vectorize(lambda d: d.id)(jm.devices), ax, -1)
        assert t_mesh.axis_lines(shape, ax) == want.reshape(-1, shape[ax]).tolist(), name


def test_mesh_config_resolve_and_best_shape_match_jax():
    for args, n in [((2, 1, 4, 1), 8), ((-1, 1, 2, 1), 8), ((3, 1, 3, 1), 8),
                    ((-1, 1, 3, 1), 8), ((-1, 2, 2, 2), 8), ((1, 1, 2, 2), 8)]:
        jc, tc = JMeshConfig(*args), t_mesh.MeshConfig(*args)
        try:
            want = jc.resolve(n)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tc.resolve(n)
            assert str(got.value) == str(e)
        else:
            assert tc.resolve(n) == want
    for n in range(1, 9):
        for heads in (2, 8, 6):
            jb, tb = j_best(n, heads), t_mesh.best_mesh_shape(n, heads)
            assert (tb.dp, tb.fsdp, tb.tp, tb.sp) == (jb.dp, jb.fsdp, jb.tp, jb.sp)


def test_mesh_without_a_world():
    m = t_mesh.make_mesh(t_mesh.MeshConfig())
    assert m.shape == {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1} and m.rank == 0
    ax = m.axis("tp")
    assert (ax.size, ax.index, ax.group) == (1, 0, None)
    with pytest.raises(ValueError, match="needs a torch.distributed world"):
        t_mesh.build_mesh([("dp", 2)])
    with pytest.raises(ValueError, match="2x1x1x1 != 1 devices"):
        t_mesh.make_mesh(t_mesh.MeshConfig(dp=2))
    with pytest.raises(ValueError, match="no 'sp' axis"):
        t_mesh.Mesh([("dp", 1)], 0).axis("sp")


# ---------------------------------------------------------------------------
# Megatron specs and shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama_trees():
    p = j_llama.init_params(JCFG.llama, jax.random.PRNGKey(0), dtype=jnp.float32)
    return {
        "bf16": p,
        "int8": j_l8.quantize_llama(p),
        "int4 fused": j_l4.quantize_llama_int4(p, group=32),
        "int4 unfused": j_l4.quantize_llama_int4(p, group=32, fuse=False),
        "int4 tp2": j_l4.quantize_llama_int4(p, group=32, tp=2),
    }


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4 fused", "int4 unfused", "int4 tp2"])
def test_llama_specs_match_jax(llama_trees, kind):
    jt = llama_trees[kind]
    tt = bridge.from_jax(jax.tree.map(np.asarray, jt), "cpu")
    want = {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                j_shd.llama_specs(jt), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert _flat(t_shd.llama_specs(tt)) == want


def test_trainable_specs_match_jax():
    jt = j_allm.init_trainable(JCFG, jax.random.PRNGKey(1))
    tt = bridge.from_jax(jax.tree.map(np.asarray, jt), "cpu")
    want = {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                j_shd.trainable_specs(jt), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert _flat(t_shd.trainable_specs(tt)) == want


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4 tp2"])
def test_tp_blocks_equal_jax_device_shards(llama_trees, kind):
    """shard_llama(tree, rank i's tp axis) holds, leaf for leaf, the block
    JAX places on device i of a tp=2 mesh."""
    jt = llama_trees[kind]
    jm = j_make_mesh(JMeshConfig(dp=1, fsdp=1, tp=2), devices=jax.devices()[:2])
    placed = jax.tree.map(jax.device_put, jt, j_shd._to_shardings(jm, j_shd.llama_specs(jt)))
    tt = bridge.from_jax(jax.tree.map(np.asarray, jt), "cpu")
    for i in range(2):
        block = _flat(t_shd.shard_llama(tt, t_mesh.MeshAxis("tp", 2, i)))
        for path, arr in jax.tree_util.tree_flatten_with_path(placed)[0]:
            key = tuple(str(getattr(k, "key", k)) for k in path)
            shard = next(s for s in arr.addressable_shards if s.device.id == i)
            np.testing.assert_array_equal(block[key].detach().numpy(), np.asarray(shard.data),
                                          err_msg=str(key))


# ---------------------------------------------------------------------------
# the unfused and tp-packed int4 trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp", [1, 2])
def test_unfused_int4_trees_match_jax(llama_trees, tp):
    jq = llama_trees["int4 unfused" if tp == 1 else "int4 tp2"]
    tparams = bridge.from_jax(jax.tree.map(np.asarray, llama_trees["bf16"]), "cpu")
    tq = t_l4.quantize_llama_int4(tparams, group=32, tp=tp, fuse=False)
    want = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jq)[0]}
    got = {k: v.detach().numpy() for k, v in _flat(tq).items()}
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key].dtype == arr.dtype and got[key].shape == arr.shape, key
        if key[-1] in ("w_p", "w_s") and (tp == 1 or key[-2] in ("o_proj", "down_proj")):
            # quantized under lax.map, where XLA turns absmax / 7 into
            # absmax * (1 / 7): scales within one f32 ulp of the eager
            # division the port shares (test_torch_int4.py says more)
            if key[-1] == "w_s":
                assert (~np.isclose(got[key], arr, rtol=2.5e-7, atol=0)).mean() < 1e-3, key
            else:
                assert (got[key] != arr).mean() < 1e-3, key
        else:  # eager (vmap) quantization: bit for bit
            np.testing.assert_array_equal(got[key], arr, err_msg=str(key))
    deq_t = _flat(t_l4.dequantize_llama_int4(bridge.from_jax(jax.tree.map(np.asarray, jq),
                                                             "cpu")))
    deq_j = _flat(j_l4.dequantize_llama_int4(jq))
    assert set(deq_t) == set(deq_j)
    for key in deq_j:
        np.testing.assert_array_equal(deq_t[key].detach().numpy(), _np(deq_j[key]),
                                      err_msg=str(key))


def test_int4_tp_refusals(llama_trees):
    tparams = bridge.from_jax(jax.tree.map(np.asarray, llama_trees["bf16"]), "cpu")
    with pytest.raises(ValueError, match="tp=1 only"):
        t_l4.quantize_llama_int4(tparams, group=32, tp=2, fuse=True)
    with pytest.raises(ValueError, match="row-parallel slab"):
        t_l4.quantize_llama_int4(tparams, group=64, tp=2)
    from audio_llama_tpu_torch.models import llama as t_llama

    tq = bridge.from_jax(jax.tree.map(np.asarray, llama_trees["int4 tp2"]), "cpu")
    with pytest.raises(ValueError, match="packed for tp=2 used without"):
        t_llama.llama_forward(tq, CFG.llama, input_ids=torch.zeros((1, 3), dtype=torch.long),
                              compute_dtype=torch.float32)


# ---------------------------------------------------------------------------
# a gloo world of 4 CPU ranks: the merge and sequence-parallel encoding
# ---------------------------------------------------------------------------

def _encode_inputs():
    frozen = j_allm.init_frozen(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.RandomState(0)
    audio = rng.randn(2, 4 * CFG.mel.max_samples).astype(np.float32) * 0.1
    return frozen, audio


@pytest.fixture(scope="module", autouse=True)
def world():
    """The 4-rank world, started with the module's first test (autouse) so
    that it runs beside the module's other tests."""
    frozen, audio = _encode_inputs()
    return ranks.Spawned(ranks.parallel_cases, 4,
                         args=(jax.tree.map(np.asarray, frozen), audio), threads=1,
                         timeout=240)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_merge_partial_stats_equals_the_whole_slab(world, n, bits):
    """Each rank's stats kernel over its window, merged across the ranks,
    equals the mono kernel's plain version over the whole slab (the same
    append, the same valid slots)."""
    from audio_llama_tpu_torch.models import llama as t_llama

    q, k, v, kn, vn, off, valid = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                   for a in ranks.merge_case(n + bits))
    if bits == 16:
        want = dm.decode_attention_plain(q, kn, vn, k, v, 1, off, valid, SCALE)[0]
    elif bits == 4:
        ckv, ks, vs = t_llama.quantize_kv_rows4(k, v)
        kvn, ksn, vsn = t_llama.quantize_kv_rows4(kn, vn)
        want = dm.decode_attention_q4_plain(q, kvn, ckv, ks, vs, ksn, vsn, 1, off, valid,
                                            SCALE)[0]
    else:
        (ck, ks), (cv, vs) = t_llama.quantize_kv_rows(k), t_llama.quantize_kv_rows(v)
        (kq, ksn), (vq, vsn) = t_llama.quantize_kv_rows(kn), t_llama.quantize_kv_rows(vn)
        want = dm.decode_attention_q8_plain(q, kq, vq, ck, cv, ks, vs, ksn, vsn, 1, off, valid,
                                            SCALE)[0]
    for r in range(4):
        got = world[r][f"merge sp{n} kv{bits}"]
        if r >= n:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("pattern", ranks.SP_VALID)
def test_sp_partial_attention_matches_jax(world, n, pattern):
    """The plain slab attention, merged over 2 and 4 ranks, equals JAX's
    `sp_partial_attention` (its XLA arm) under shard_map, windows whose
    slots are all invalid included."""
    from jax.sharding import PartitionSpec as P

    q, k, v, valid = ranks.sp_attention_case(n + ranks.SP_VALID.index(pattern), pattern)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("sp",))
    fn = jax.shard_map(
        lambda q, k, v, valid: j_att.sp_partial_attention(q, k, v, valid, SCALE, "sp"),
        mesh=mesh, in_specs=(P(), P(None, None, "sp"), P(None, None, "sp"), P(None, "sp")),
        out_specs=P(), check_vma=False)
    want = np.asarray(fn(*(jnp.asarray(a) for a in (q, k, v, valid))))
    for r in range(4):
        got = world[r][f"sp attention sp{n} {pattern}"]
        if r >= n:
            assert got is None
            continue
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axes", [[("sp", 4)], [("dp", 2), ("sp", 2)]], ids=str)
def test_sp_encode_matches_jax(world, axes):
    jfrozen, audio = _encode_inputs()
    devs = np.array(jax.devices()[:4]).reshape([s for _, s in axes])
    jm = jax.sharding.Mesh(devs, tuple(a for a, _ in axes))
    want = np.asarray(j_sp_encode(JCFG, jm, compute_dtype=jnp.float32)(
        jfrozen, jnp.asarray(audio)))
    for r in range(4):
        got = world[r][f"encode {axes}"].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_sp_encode_refusals(world):
    assert world[0]["encode refusal"] == "sp=4 must divide the window count 3"
    with pytest.raises(ValueError, match="no 'sp' axis"):
        make_sp_encode(CFG, t_mesh.Mesh([("dp", 4)], 0))
