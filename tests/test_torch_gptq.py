"""The port's GPTQ int4 quantizer against the JAX package's.

Follows tests/test_llama_gptq.py at its toy dims (hidden 128, F 256, 2
layers). Bars:
  - an identity Gram gives RTN (`quantize_pack`) bit for bit;
  - error feedback beats RTN under correlated, hot-channel inputs (JAX's
    test: half the proxy loss, 0.7 of the output error) and dead inputs
    stay inert;
  - `gptq_pack` against JAX on the same W and H (JAX's correlated case,
    clip off and on): scales within 1e-5 relative, at most 1e-3 of the
    bytes apart, the proxy loss within 1e-4 relative (0 bytes, 3.6e-7 and
    2e-6 measured: only the f32 inverse and Cholesky round differently); a
    stack of layers equals the layers one at a time;
  - the calibration Grams of `llama_forward(collect_quant_stats=...)`
    against JAX's: masked, and on inputs_embeds, within 1e-5 of their scale;
  - the GPTQ tree: the layout of `quantize_llama_int4(fuse=True)`; against
    JAX's on the same Grams at most 1e-3 of the bytes apart, at most 1% of
    the scales beyond 1e-5 relative and each slab's proxy loss within 2e-2
    relative and below RTN's (a byte that rounds the other way feeds a whole
    step of error into the later groups, whose scales then move: up to 9 of
    2048 down scales and 7.8e-3 of one down slab's loss measured);
  - logits on a JAX GPTQ tree passed through the bridge within 2e-4 of
    JAX's (f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_gptq as j_gq  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.models import llama, llama_gptq, llama_int4  # noqa: E402
from audio_llama_tpu_torch.ops import int4_matmul as i4  # noqa: E402

DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position_embeddings=2048, rope_scaling=None,
            tie_word_embeddings=True)
JCFG, CFG = JLlamaCfg(**DIMS), LlamaConfig(**DIMS)
SLAB_ROLES = {"qkv_proj": "qkv", "gateup_proj": "gateup", "o_proj": "o", "down_proj": "down"}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _correlated(K=128, N=64, seed=1):
    """JAX's test case: w [K, N] and the Gram of mixed inputs with four hot
    channels."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(K, N)) * 0.02).astype(np.float32)
    X = rng.normal(size=(512, K)).astype(np.float32)
    mix = (rng.normal(size=(K, K)) * 0.2 + np.eye(K)).astype(np.float32)
    X = X @ mix
    X[:, :4] *= 20.0
    return w, X, (X.T @ X).astype(np.float32)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_identity_gram_gives_rtn(fmt):
    w = torch.from_numpy((np.random.default_rng(0).normal(size=(128, 64)) * 0.02)
                         .astype(np.float32))
    pg, sg = llama_gptq.gptq_pack(w, torch.eye(128), group=32, fmt=fmt)
    p0, s0 = i4.quantize_pack(w, group=32, fmt=fmt)
    assert torch.equal(pg, p0) and torch.equal(sg, s0)


def test_error_feedback_beats_rtn_under_correlation():
    w, X, H = _correlated()
    G = 32
    pg, sg = llama_gptq.gptq_pack(_t(w), _t(H), group=G)
    p0, s0 = i4.quantize_pack(_t(w), group=G)
    l_g = float(llama_gptq.gptq_proxy_loss(_t(w), pg, sg, _t(H), G))
    l_r = float(llama_gptq.gptq_proxy_loss(_t(w), p0, s0, _t(H), G))
    assert l_g < 0.5 * l_r, (l_g, l_r)
    y = X @ w
    e_g = np.sqrt(np.mean((X @ i4.dequantize_ref(pg, sg, G).numpy() - y) ** 2))
    e_r = np.sqrt(np.mean((X @ i4.dequantize_ref(p0, s0, G).numpy() - y) ** 2))
    assert e_g < 0.7 * e_r, (e_g, e_r)


def test_dead_inputs_are_inert():
    rng = np.random.default_rng(4)
    w = (rng.normal(size=(64, 32)) * 0.02).astype(np.float32)
    X = rng.normal(size=(256, 64)).astype(np.float32)
    X[:, 10] = 0.0
    pg, sg = llama_gptq.gptq_pack(_t(w), _t(X.T @ X), group=32)
    deq = i4.dequantize_ref(pg, sg, 32).numpy()
    assert np.isfinite(deq).all() and np.abs(deq[10]).max() == 0.0


@pytest.mark.parametrize("clip", [None, j_l4.CLIP_CANDS], ids=["rtn-scales", "clip"])
def test_gptq_pack_matches_jax(clip):
    w, _, H = _correlated()
    G = 32
    pj, sj = j_gq.gptq_pack(jnp.asarray(w), jnp.asarray(H), group=G, clip_cands=clip)
    pt, st = llama_gptq.gptq_pack(_t(w), _t(H), group=G, clip_cands=clip)
    assert pt.dtype == torch.int8 and tuple(pt.shape) == pj.shape
    assert st.dtype == torch.float32 and tuple(st.shape) == sj.shape
    assert (pt.numpy() != _np(pj)).mean() <= 1e-3
    np.testing.assert_allclose(st.numpy(), _np(sj), rtol=1e-5, atol=0)
    l_t = float(llama_gptq.gptq_proxy_loss(_t(w), pt, st, _t(H), G))
    l_j = float(j_gq.gptq_proxy_loss(jnp.asarray(w), pj, sj, jnp.asarray(H), G))
    assert abs(l_t - l_j) <= 1e-4 * l_j, (l_t, l_j)
    # a stack of layers runs together and equals the layers one at a time
    w2, _, H2 = _correlated(seed=2)
    ps, ss = llama_gptq.gptq_pack(_t(np.stack([w, w2])), _t(np.stack([H, H2])), group=G,
                                  clip_cands=clip)
    p2, s2 = llama_gptq.gptq_pack(_t(w2), _t(H2), group=G, clip_cands=clip)
    assert torch.equal(ps[0], pt) and torch.equal(ps[1], p2)
    assert torch.equal(ss[0], st) and torch.equal(ss[1], s2)


def test_gptq_pack_refuses_bad_shapes():
    with pytest.raises(ValueError, match="even N and group"):
        llama_gptq.gptq_pack(torch.zeros(100, 64), torch.eye(100))


@pytest.fixture(scope="module")
def calib():
    jp = j_llama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 500, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 12:] = 0
    jstats = j_gq.collect_llama_stats(jp, JCFG, jnp.asarray(ids), jnp.asarray(mask))
    return jp, tp, ids, mask, jstats


def _check_grams(got, want):
    assert set(got) == set(want)
    for role, w in want.items():
        w = _np(w)
        assert got[role].dtype == torch.float32 and tuple(got[role].shape) == w.shape, role
        np.testing.assert_allclose(got[role].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=role)


def test_collect_stats_match_jax(calib):
    jp, tp, ids, mask, jstats = calib
    D, F, Dq = CFG.hidden_size, CFG.intermediate_size, CFG.num_heads * CFG.head_dim
    stats = llama_gptq.collect_llama_stats(tp, CFG, torch.from_numpy(ids), torch.from_numpy(mask))
    assert {r: tuple(v.shape) for r, v in stats.items()} == {
        "qkv": (2, D, D), "o": (2, Dq, Dq), "gateup": (2, D, D), "down": (2, F, F)}
    _check_grams(stats, jstats)
    # masked: zeroing more positions lowers the trace, as JAX's
    less = mask.copy()
    less[:, 8:] = 0
    st2 = llama_gptq.collect_llama_stats(tp, CFG, torch.from_numpy(ids), torch.from_numpy(less))
    assert float(torch.trace(st2["qkv"][0])) < float(torch.trace(stats["qkv"][0]))


def test_collect_stats_on_inputs_embeds_match_jax(calib):
    """The calibration of the outlier gate: an embedded splice, no ids, a
    subset of the roles, through llama_forward itself with return_hidden."""
    jp, tp, _, mask, _ = calib
    emb = (np.random.default_rng(2).normal(size=(2, 16, 128)) * 0.5).astype(np.float32)
    roles = ("qkv", "down")
    jl, _, jh, jst = j_llama.llama_forward(jp, JCFG, inputs_embeds=jnp.asarray(emb),
                                           attention_mask=jnp.asarray(mask),
                                           compute_dtype=jnp.float32, attn_impl="xla",
                                           return_hidden=True, collect_quant_stats=roles)
    tl, _, th, tst = llama.llama_forward(tp, CFG, inputs_embeds=torch.from_numpy(emb),
                                         attention_mask=torch.from_numpy(mask),
                                         compute_dtype=torch.float32, attn_impl="xla",
                                         return_hidden=True, collect_quant_stats=roles)
    _check_grams(tst, jst)
    valid = mask == 1
    np.testing.assert_allclose(tl.numpy()[valid], _np(jl)[valid], atol=2e-4)
    np.testing.assert_allclose(th.numpy()[valid], _np(jh)[valid], atol=2e-4)
    stats = llama_gptq.collect_llama_stats(tp, CFG, attention_mask=torch.from_numpy(mask),
                                           inputs_embeds=torch.from_numpy(emb), roles=roles)
    _check_grams(stats, jst)


def test_collect_stats_and_xla_refusals(calib):
    _, tp, ids, mask, _ = calib
    qt = llama_int4.quantize_llama_int4(tp)
    with pytest.raises(ValueError, match="FULL-PRECISION"):
        llama.llama_forward(qt, CFG, input_ids=torch.from_numpy(ids),
                            compute_dtype=torch.float32, collect_quant_stats=("qkv",))
    with pytest.raises(ValueError, match="roles"):
        llama.llama_forward(tp, CFG, input_ids=torch.from_numpy(ids), collect_quant_stats=("x",))
    cache = llama.KVCache.zeros(CFG, 2, 32, dtype=torch.float32)
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        llama.llama_forward(tp, CFG, input_ids=torch.from_numpy(ids), kv_cache=cache,
                            attn_impl="xla")


@pytest.fixture(scope="module")
def gptq_trees(calib):
    jp, tp, _, _, jstats = calib
    stats = {r: _t(v) for r, v in jstats.items()}
    return (j_gq.quantize_llama_int4_gptq(jp, jstats, group=32),
            llama_gptq.quantize_llama_int4_gptq(tp, stats, group=32), stats)


def test_gptq_tree_matches_jax(calib, gptq_trees):
    _, tp, _, _, _ = calib
    jq, tq, stats = gptq_trees
    jflat = {jax.tree_util.keystr(k): np.asarray(v)
             for k, v in jax.tree_util.tree_flatten_with_path(jq)[0]}
    tflat = {"".join(f"['{part}']" for part in n.split(".")): t.detach().numpy()
             for n, t in tq.named_parameters()}
    assert set(jflat) == set(tflat)
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if key.endswith("['w_p']"):
            assert (got != want).mean() <= 1e-3, key
        elif key.endswith("['w_s']") and "layers" in key:
            assert (np.abs(got - want) > 1e-5 * np.abs(want)).mean() <= 1e-2, key
        elif key.endswith("['w_s']") or key.endswith("['scale']"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    lp = tp["layers"]
    full = {"qkv_proj": torch.cat([lp["q_proj"], lp["k_proj"], lp["v_proj"]], dim=-1),
            "gateup_proj": torch.cat([lp["gate_proj"], lp["up_proj"]], dim=-1),
            "o_proj": lp["o_proj"], "down_proj": lp["down_proj"]}
    for name, role in SLAB_ROLES.items():
        for li in range(CFG.num_layers):
            def loss(tree):
                w = tree["layers"][name]
                return float(llama_gptq.gptq_proxy_loss(full[name][li], _t(w["w_p"][li]),
                                                        _t(w["w_s"][li]), stats[role][li], 32))
            l_t, l_j = loss(tq), loss(jq)
            assert abs(l_t - l_j) <= 2e-2 * l_j, (name, li, l_t, l_j)
            rtn = i4.quantize_pack(full[name][li], 32)
            assert l_t <= float(llama_gptq.gptq_proxy_loss(full[name][li], *rtn,
                                                           stats[role][li], 32)), (name, li)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_gptq_tree_layout_is_the_fused_tree(calib, gptq_trees, fmt):
    _, tp, _, _, _ = calib
    stats = gptq_trees[2]
    qt = llama_gptq.quantize_llama_int4_gptq(tp, stats, fmt=fmt)
    rt = llama_int4.quantize_llama_int4(tp, fmt=fmt)
    shapes = {n: (tuple(t.shape), t.dtype) for n, t in qt.named_parameters()}
    assert shapes == {n: (tuple(t.shape), t.dtype) for n, t in rt.named_parameters()}
    assert llama_int4.is_int4(qt) and ("int4_obin" in qt) == (fmt == "obin")
    with pytest.raises(ValueError, match="full-precision"):
        llama_gptq.quantize_llama_int4_gptq(qt, stats)
    # a role missing from the stats falls back to plain RTN
    part = llama_gptq.quantize_llama_int4_gptq(tp, {"qkv": stats["qkv"]}, fmt=fmt)
    down = part["layers"]["down_proj"]
    p0, s0 = i4.quantize_pack(tp["layers"]["down_proj"][1], fmt=fmt)
    assert torch.equal(down["w_p"][1], p0) and torch.equal(down["w_s"][1], s0)


def test_logits_on_a_jax_gptq_tree_match_jax(calib, gptq_trees):
    _, _, ids, mask, _ = calib
    jq = gptq_trees[0]
    tq = bridge.from_jax(jax.tree.map(np.asarray, jq), "cpu")
    want, _ = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    compute_dtype=jnp.float32, attn_impl="xla")
    got, _ = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(ids),
                                 attention_mask=torch.from_numpy(mask),
                                 compute_dtype=torch.float32)
    valid = mask == 1
    np.testing.assert_allclose(got.numpy()[valid], _np(want)[valid], atol=2e-4)
    # and a decode step (the fused MLP without dn_r, the port's own GPTQ tree too)
    for tree, jtree in ((tq, jq), (gptq_trees[1], None)):
        cache = llama.KVCache.zeros(CFG, 2, 20, dtype=torch.float32)
        _, cache = llama.llama_forward(tree, CFG, input_ids=torch.from_numpy(ids),
                                       attention_mask=torch.ones(2, 20, dtype=torch.int32),
                                       kv_cache=cache, compute_dtype=torch.float32,
                                       assume_fresh_cache=True)
        step, _ = llama.llama_forward(tree, CFG, input_ids=torch.tensor([[7], [9]]),
                                      kv_cache=cache, compute_dtype=torch.float32)
        assert torch.isfinite(step).all() and tuple(step.shape) == (2, 1, 512)
        if jtree is not None:
            jc = j_llama.KVCache.zeros(JCFG, 2, 20, dtype=jnp.float32)
            _, jc = j_llama.llama_forward(jtree, JCFG, input_ids=jnp.asarray(ids),
                                          attention_mask=jnp.ones((2, 20), jnp.int32),
                                          kv_cache=jc, compute_dtype=jnp.float32,
                                          assume_fresh_cache=True)
            jstep, _ = j_llama.llama_forward(jtree, JCFG, input_ids=jnp.asarray([[7], [9]]),
                                             kv_cache=jc, compute_dtype=jnp.float32)
            np.testing.assert_allclose(step.numpy(), _np(jstep), atol=2e-4)
