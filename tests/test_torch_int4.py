"""The port's int4 weight path against the JAX package's.

Toy dims with group 128 dividing every contraction (hidden 128, F 256, hd
32, as tests/test_llama_int4.py). Bars:
  - packing: bytes and scales bit-identical with clip off; with the
    clipped-RTN search on, identical except in (group, column) cells where
    two candidates' summed squared errors tie within f32 rounding (the two
    packages sum them in another order), counted and allowed only there;
  - the plain kernels (`int4_matmul_stacked`, `mlp_int4_stacked`) against
    the JAX Pallas kernels in interpret mode: f32 x to 1e-5 relative to the
    output's scale (the same f32 group sums in another order); bf16 x to one
    bf16 rounding of the output (2^-7 relative plus 1e-2 of its scale);
  - `quantize_llama_int4`: leaf for leaf, scales within one f32 ulp (see
    the test) and at most 1e-3 of bytes or scales apart;
  - `llama_forward` on the int4 tree against JAX at f32 to 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.config import LoraConfig as JLoraCfg  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.models import lora as j_lora  # noqa: E402
from audio_llama_tpu.ops import int4_matmul as j_i4  # noqa: E402
from audio_llama_tpu.ops import mlp_int4 as j_mlp4  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import LlamaConfig, LoraConfig  # noqa: E402
from audio_llama_tpu_torch.models import llama, llama_int4, lora  # noqa: E402
from audio_llama_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from audio_llama_tpu_torch.ops import mlp_int4 as mlp4  # noqa: E402

DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position_embeddings=2048, rope_scaling=None,
            tie_word_embeddings=True)
JCFG, CFG = JLlamaCfg(**DIMS), LlamaConfig(**DIMS)


def _np(x):
    return np.asarray(x)


def _t(x):
    return bridge.to_tensor(np.asarray(x), torch.device("cpu"))


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_quantize_pack_bit_identical(fmt):
    w = _rng(0).normal(size=(256, 384)).astype(np.float32)
    jp, js = j_i4.quantize_pack(jnp.asarray(w), fmt=fmt)
    tp, ts = i4.quantize_pack(torch.from_numpy(w), fmt=fmt)
    np.testing.assert_array_equal(tp.numpy(), _np(jp))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(i4.unpack_ref(tp, fmt).numpy(), _np(j_i4.unpack_ref(jp, fmt)))
    np.testing.assert_array_equal(i4.dequantize_ref(tp, ts, fmt=fmt).numpy(),
                                  _np(j_i4.dequantize_ref(jp, js, fmt=fmt)))
    with pytest.raises(ValueError, match="even N and group"):
        i4.quantize_pack(torch.zeros(100, 64))


def _clip_ties(w, cands, group=128):
    """Per (group, column): True where the best two candidates' summed
    squared errors are within f32 rounding of each other."""
    K, N = w.shape
    g = w.astype(np.float64).reshape(K // group, group, N)
    s0 = np.maximum(np.abs(g).max(axis=1), 1e-8) / 7.0
    errs = []
    for c in cands:
        s = (s0 * np.float32(c)).astype(np.float32)
        q = np.clip(np.round(g / s[:, None, :]), -7, 7)
        errs.append(((g - q * s[:, None, :]) ** 2).sum(axis=1))
    errs = np.sort(np.stack(errs), axis=0)
    return (errs[1] - errs[0]) <= 1e-5 * errs[0] + 1e-12


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_quantize_pack_clipped_matches_up_to_ties(fmt):
    w = _rng(1).normal(size=(512, 256)).astype(np.float32)
    cands = j_l4.CLIP_CANDS
    jp, js = j_i4.quantize_pack(jnp.asarray(w), clip_cands=cands, fmt=fmt)
    tp, ts = i4.quantize_pack(torch.from_numpy(w), clip_cands=cands, fmt=fmt)
    differ = ts.numpy() != _np(js)  # [K/g, N]
    ties = _clip_ties(w, cands)
    assert not (differ & ~ties).any(), f"{int((differ & ~ties).sum())} non-tie cells differ"
    cols = np.repeat(differ, 128, axis=0)
    q_t, q_j = i4.unpack_ref(tp, fmt).numpy(), _np(j_i4.unpack_ref(jp, fmt))
    np.testing.assert_array_equal(q_t[~cols], q_j[~cols])


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lead", [(3,), (2, 37)])
def test_int4_matmul_stacked_matches_the_pallas_kernel(fmt, dtype, lead):
    L, K, N = 3, 256, 384
    rng = _rng(2)
    w = rng.normal(size=(L, K, N)).astype(np.float32)
    packed, scales = zip(*(j_i4.quantize_pack(jnp.asarray(w[i]), fmt=fmt) for i in range(L)))
    jp, js = jnp.stack(packed), jnp.stack(scales)
    x = rng.normal(size=(*lead, K)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xj = jnp.asarray(x).astype(jdt)
    xt = _t(xj)
    for planes in (False, True):
        want = j_i4.int4_matmul_stacked(xj, jp, js, jnp.int32(1), interpret=True,
                                        return_planes=planes, fmt=fmt)
        got = i4.int4_matmul_stacked(xt, _t(jp), _t(js), 1, return_planes=planes, fmt=fmt)
        want = [want] if not planes else list(want)
        got = [got] if not planes else list(got)
        for g, wv in zip(got, want):
            assert g.dtype == tdt and tuple(g.shape) == wv.shape
            wv = np.asarray(wv, np.float32)
            scale = np.abs(wv).max()
            if dtype == "f32":
                np.testing.assert_allclose(g.float().numpy(), wv, rtol=0, atol=1e-5 * scale)
            else:
                np.testing.assert_allclose(g.float().numpy(), wv, rtol=2.0 ** -7,
                                           atol=1e-2 * scale)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M", [1, 5])
def test_mlp_int4_stacked_matches_the_pallas_kernel(fmt, M):
    L, K, Fd, D = 2, 256, 512, 256
    rng = _rng(3)
    gu = rng.normal(size=(L, K, 2 * Fd)).astype(np.float32)
    dn = rng.normal(size=(L, Fd, D)).astype(np.float32) * 0.1

    def q(w):
        p, s = zip(*(j_i4.quantize_pack(jnp.asarray(w[i]), fmt=fmt) for i in range(L)))
        return jnp.stack(p), jnp.stack(s)

    (gp, gs), (dp, ds) = q(gu), q(dn)
    x = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32))
    chunk = 256
    want = j_mlp4.mlp_int4_stacked(x, gp, gs, dp, ds, jnp.int32(1), chunk=chunk,
                                   interpret=True, fmt=fmt)
    got = mlp4.mlp_int4_stacked(_t(x), _t(gp), _t(gs), _t(dp), _t(ds), 1, chunk=chunk, fmt=fmt)
    scale = float(jnp.abs(want).max())
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=0, atol=1e-5 * scale)
    ref = mlp4.mlp_int4_stacked_ref(_t(x), _t(gp), _t(gs), _t(dp), _t(ds), 1,
                                    compute_dtype=torch.float32, fmt=fmt)
    np.testing.assert_allclose(ref.numpy(), _np(want), rtol=0, atol=1e-5 * scale)
    assert mlp4.pick_chunk(8192) == 512 and mlp4.pick_chunk(384) == 384
    assert mlp4.pick_chunk(100) is None
    assert mlp4.geometry_ok(3072, 8192, 3072) and not mlp4.geometry_ok(128, 256, 128)
    assert mlp4.kernel_chunk(8192, 1536) == 128 and mlp4.kernel_chunk(100, 64) is None


@pytest.fixture(scope="module")
def trees():
    params = j_llama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    jp = jax.tree.map(np.asarray, params)
    return params, bridge.from_jax(jp, "cpu")


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_quantize_llama_int4_leaf_for_leaf(trees, fmt):
    jparams, tparams = trees
    jq = j_l4.quantize_llama_int4(jparams, fmt=fmt)
    tq = llama_int4.quantize_llama_int4(tparams, fmt=fmt)
    assert llama_int4.is_int4(tq) and not llama_int4.is_int4(tparams)
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jq)[0]}
    tflat = {n: p.detach().numpy() for n, p in tq.named_parameters()}
    tkeys = {"".join(f"['{part}']" for part in n.split(".")): n for n in tflat}
    assert set(tkeys) == set(jflat)
    for key, arr in jflat.items():
        got = tflat[tkeys[key]]
        assert got.dtype == arr.dtype and got.shape == arr.shape, key
        # JAX quantizes the slabs under lax.map, where XLA turns absmax / 7
        # into absmax * (1 / 7): its scales sit within one f32 ulp of the
        # eager division (which the port and eager JAX share bit for bit,
        # test_quantize_pack_bit_identical). Bytes then differ only where
        # that ulp or a clip tie moves a rounding boundary.
        if key.endswith("['w_s']"):
            far = ~np.isclose(got, arr, rtol=2.5e-7, atol=0)
            assert far.mean() < 1e-3, key
        elif key.endswith("['w_p']"):
            assert (got != arr).mean() < 1e-3, key
        else:
            np.testing.assert_array_equal(got, arr, err_msg=key)
    deq_t = llama_int4.dequantize_llama_int4(tq)
    deq_j = j_l4.dequantize_llama_int4(jq)
    np.testing.assert_allclose(deq_t["layers"]["q_proj"].numpy(),
                               _np(deq_j["layers"]["q_proj"]), atol=0.05)
    with pytest.raises(ValueError, match="already-quantized"):
        llama_int4.quantize_llama_int4(tq)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        llama_int4.quantize_llama_int4(tparams, smooth=True)


def test_merge_into_llama(trees):
    jparams, tparams = trees
    lcfg = JLoraCfg(rank=4, alpha=8)
    jl = j_lora.init_params(JCFG, lcfg, jax.random.PRNGKey(5))
    rng = _rng(5)
    for br in jl["layers"].values():
        br["a"] = jnp.asarray(rng.normal(size=br["a"].shape).astype(np.float32) * 0.1)
    tl = bridge.from_jax(jax.tree.map(np.asarray, jl), "cpu")
    want = j_lora.merge_into_llama(jparams, j_lora.with_scaling(jl, lcfg))
    got = lora.merge_into_llama(tparams, lora.with_scaling(tl, LoraConfig(rank=4, alpha=8)))
    for name in ("q_proj", "gate_proj", "down_proj", "o_proj"):
        np.testing.assert_allclose(got["layers"][name].numpy(), _np(want["layers"][name]),
                                   atol=1e-6, rtol=1e-6)
    assert not torch.equal(got["layers"]["q_proj"], tparams["layers"]["q_proj"])


@pytest.fixture(scope="module", params=["pair", "obin"])
def int4_model(request, trees):
    jparams, _ = trees
    jq = j_l4.quantize_llama_int4(jparams, fmt=request.param)
    return jq, bridge.from_jax(jax.tree.map(np.asarray, jq), "cpu")


def test_llama_forward_int4_matches_jax(int4_model):
    """Full (no cache), fresh-cache prefill, then two T == 1 decode steps on
    an f32 cache (the fused MLP kernel's plain version runs at decode)."""
    jq, tq = int4_model
    rng = _rng(6)
    B, T, extra = 2, 9, 3
    ids = rng.integers(3, 500, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 7:] = 0
    full_j, _ = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(ids),
                                      attention_mask=jnp.asarray(mask),
                                      compute_dtype=jnp.float32, attn_impl="xla")
    full_t, _ = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(ids),
                                    attention_mask=torch.from_numpy(mask),
                                    compute_dtype=torch.float32)
    np.testing.assert_allclose(full_t.numpy()[mask == 1], _np(full_j)[mask == 1], atol=2e-4)

    fmask = np.concatenate([mask, np.ones((B, extra), np.int32)], axis=1)
    jc = j_llama.KVCache.zeros(JCFG, B, T + extra, dtype=jnp.float32)
    tc = llama.KVCache.zeros(CFG, B, T + extra, dtype=torch.float32)
    _, jc, jh = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(ids),
                                      attention_mask=jnp.asarray(fmask), kv_cache=jc,
                                      compute_dtype=jnp.float32, assume_fresh_cache=True,
                                      return_hidden=True)
    _, tc, th = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(ids),
                                    attention_mask=torch.from_numpy(fmask), kv_cache=tc,
                                    compute_dtype=torch.float32, assume_fresh_cache=True,
                                    return_hidden=True)
    np.testing.assert_allclose(th.numpy()[mask == 1], _np(jh)[mask == 1], atol=2e-4)
    real = mask.sum(1)
    for i in range(2):
        tok = rng.integers(3, 500, (B, 1)).astype(np.int32)
        pos = (real + i)[:, None]
        jl, jc = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(tok),
                                       attention_mask=jnp.asarray(fmask),
                                       positions=jnp.asarray(pos), kv_cache=jc,
                                       compute_dtype=jnp.float32)
        tl, tc = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(tok),
                                     attention_mask=torch.from_numpy(fmask),
                                     positions=torch.from_numpy(pos), kv_cache=tc,
                                     compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=2e-4)


def test_embed_and_unembed_on_the_int8_table(int4_model):
    jq, tq = int4_model
    ids = _rng(7).integers(0, 512, (2, 5)).astype(np.int32)
    want = j_llama.embed_tokens(jq, jnp.asarray(ids), jnp.float32)
    got = llama.embed_tokens(tq, torch.from_numpy(ids), torch.float32)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    x = _rng(8).normal(size=(2, 3, 128)).astype(np.float32)
    np.testing.assert_allclose(
        llama.unembed(tq, CFG, torch.from_numpy(x), torch.float32).numpy(),
        _np(j_llama.unembed(jq, JCFG, jnp.asarray(x), jnp.float32)), rtol=1e-5, atol=1e-5)
