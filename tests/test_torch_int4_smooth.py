"""The port's smoothed int4 trees against the JAX package's.

Toy dims (hidden 128, F 256, 2 layers, as tests/test_int4_smooth.py).
Bars:
  - `_equalize_rows`: r within 1e-6 relative (about 8 f32 ulps; XLA's f32
    log and exp differ from PyTorch's in the last bit for ~10% of inputs and
    the mean of the logs is summed in another order, which moves the
    geometric mean by a few ulps: 5 measured), and the port's m / r exactly
    its own division;
  - `quantize_llama_int4(smooth=True)`, fused, unfused and tp = 2, clip off
    and on: leaf for leaf, w_r and w_s within 1e-6 relative (w_s inherits
    r's ulps), bytes equal except where a clip tie or one of those ulps
    moves a rounding boundary (at most 1e-3 of them; 0 measured);
  - `mlp_int4_stacked(dn_r=...)`'s plain version against JAX's kernel in
    interpret mode: f32 x to 1e-5 of the output's scale, bf16 x to one bf16
    rounding (2^-7 relative plus 1e-2 of the scale), as
    tests/test_torch_int4.py holds the mode without dn_r;
  - `llama_forward` on a JAX smoothed tree passed through the bridge (fused
    and unfused, both pack formats): full forward, fresh prefill and two
    T == 1 steps at f32 within 2e-4, with LoRA too;
  - greedy `generate` at B = 1 on a smoothed tree with an int4 KV cache:
    tokens equal to JAX's; the megakernel gate refuses the tree (w_r), which
    it takes without w_r.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.config import LoraConfig as JLoraCfg  # noqa: E402
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.models import lora as j_lora  # noqa: E402
from audio_llama_tpu.ops import int4_matmul as j_i4  # noqa: E402
from audio_llama_tpu.ops import mlp_int4 as j_mlp4  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig, LlamaConfig, LoraConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import llama, llama_int4, lora  # noqa: E402
from audio_llama_tpu_torch.ops import decode_megakernel as mk  # noqa: E402
from audio_llama_tpu_torch.ops import mlp_int4 as mlp4  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position_embeddings=2048, rope_scaling=None,
            tie_word_embeddings=True)
JCFG, CFG = JLlamaCfg(**DIMS), LlamaConfig(**DIMS)
REL = 1e-6  # w_r and w_s against JAX (see the module docstring)


def _np(x):
    return np.asarray(x)


def _t(x):
    return bridge.to_tensor(np.asarray(x), torch.device("cpu"))


def _outlier_rows(seed, K, N, n_hot=3, scale=8.0):
    """A random [K, N] matrix with a few 8x input rows (the regime that
    smoothing is for)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, N)).astype(np.float32) * 0.02
    w[rng.integers(0, K, n_hot)] *= scale
    return w


def test_equalize_rows_matches_jax():
    m = _outlier_rows(3, 256, 96)
    m2_j, r_j = j_l4._equalize_rows(jnp.asarray(m))
    m2_t, r_t = llama_int4._equalize_rows(torch.from_numpy(m))
    assert r_t.dtype == torch.float32 and m2_t.dtype == torch.float32
    np.testing.assert_allclose(r_t.numpy(), _np(r_j), rtol=REL, atol=0)
    np.testing.assert_array_equal(m2_t.numpy(), (torch.from_numpy(m) / r_t[:, None]).numpy())
    np.testing.assert_allclose(m2_t.numpy(), _np(m2_j), rtol=REL, atol=0)
    assert 0.5 < float(torch.exp(torch.log(r_t).mean())) < 2.0  # geometric-mean centred
    # bf16 rows keep their dtype, r stays f32
    m2_b, r_b = llama_int4._equalize_rows(torch.from_numpy(m).to(torch.bfloat16))
    assert m2_b.dtype == torch.bfloat16 and r_b.dtype == torch.float32


@pytest.fixture(scope="module")
def params():
    jp = j_llama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, bridge.from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _flat_jax(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree):
    return {"".join(f"['{part}']" for part in n.split(".")): t.detach().numpy()
            for n, t in tree.named_parameters()}


@pytest.mark.parametrize("layout", [dict(), dict(fuse=False), dict(tp=2, group=64)],
                         ids=["fused", "unfused", "tp2"])
@pytest.mark.parametrize("clip", [False, True])
def test_quantize_llama_int4_smooth_leaf_for_leaf(params, layout, clip):
    jp, tp = params
    jq = j_l4.quantize_llama_int4(jp, smooth=True, clip=clip, **layout)
    tq = llama_int4.quantize_llama_int4(tp, smooth=True, clip=clip, **layout)
    jflat, tflat = _flat_jax(jq), _flat_port(tq)
    assert set(jflat) == set(tflat)
    n_r = 0
    for key, want in jflat.items():
        got = tflat[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        if key.endswith("['w_r']") or key.endswith("['w_s']"):
            n_r += key.endswith("['w_r']")
            np.testing.assert_allclose(got, want, rtol=REL, atol=0, err_msg=key)
        elif key.endswith("['w_p']"):
            assert (got != want).mean() <= 1e-3, key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    assert n_r == (4 if "fuse" not in layout and "tp" not in layout else 7)
    # the dequantized tree carries diag(w_r) @ dequant, as JAX's
    deq_t = llama_int4.dequantize_llama_int4(tq)
    deq_j = j_l4.dequantize_llama_int4(jq)
    for name in ("q_proj", "v_proj", "o_proj", "up_proj", "down_proj"):
        want = _np(deq_j["layers"][name])
        np.testing.assert_allclose(deq_t["layers"][name].numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_smooth_unfused_and_tp_dequantize_alike(params):
    """w_r rides the unfused and pack-after-shard layouts: the two dequantize
    to the same weights (JAX's test_smoothed_unfused_and_tp_layouts)."""
    _, tp = params
    d_unf = llama_int4.dequantize_llama_int4(
        llama_int4.quantize_llama_int4(tp, fuse=False, smooth=True, group=64))
    d_tp = llama_int4.dequantize_llama_int4(
        llama_int4.quantize_llama_int4(tp, tp=2, smooth=True, group=64))
    for name in llama_int4.LINEAR_NAMES:
        np.testing.assert_allclose(d_unf["layers"][name].numpy(), d_tp["layers"][name].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M", [1, 5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mlp_int4_stacked_dnr_matches_the_pallas_kernel(fmt, M, dtype):
    L, K, Fd, D = 2, 256, 512, 256
    rng = np.random.default_rng(8)
    gu = rng.normal(size=(L, K, 2 * Fd)).astype(np.float32)
    dn = rng.normal(size=(L, Fd, D)).astype(np.float32) * 0.1

    def q(w):
        p, s = zip(*(j_i4.quantize_pack(jnp.asarray(w[i]), fmt=fmt) for i in range(L)))
        return jnp.stack(p), jnp.stack(s)

    (gp, gs), (dp, ds) = q(gu), q(dn)
    dn_r = rng.uniform(0.25, 4.0, size=(L, Fd)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    xj = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32) * 0.1).astype(jdt)
    args = [_t(a) for a in (gp, gs, dp, ds)]
    for li in (0, 1):
        want = j_mlp4.mlp_int4_stacked(xj, gp, gs, dp, ds, jnp.int32(li), chunk=256,
                                       interpret=True, dn_r=jnp.asarray(dn_r), fmt=fmt)
        got = mlp4.mlp_int4_stacked(_t(xj), *args, li, chunk=256, fmt=fmt,
                                    dn_r=torch.from_numpy(dn_r))
        want = np.asarray(want, np.float32)
        scale = np.abs(want).max()
        assert got.dtype == _t(xj).dtype and tuple(got.shape) == want.shape
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
            ref = mlp4.mlp_int4_stacked_ref(_t(xj), *args, li, compute_dtype=torch.float32,
                                            fmt=fmt, dn_r=torch.from_numpy(dn_r))
            jref = j_mlp4.mlp_int4_stacked_ref(xj, gp, gs, dp, ds, jnp.int32(li),
                                               compute_dtype=jnp.float32,
                                               dn_r=jnp.asarray(dn_r), fmt=fmt)
            np.testing.assert_allclose(ref.numpy(), _np(jref), rtol=0, atol=1e-5 * scale)
        else:
            np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                                       atol=1e-2 * scale)
        # the equalizer matters: without it the output moves far past the bar
        plain = mlp4.mlp_int4_stacked(_t(xj), *args, li, chunk=256, fmt=fmt)
        assert np.abs(plain.float().numpy() - want).max() > 0.1 * scale


@pytest.fixture(scope="module", params=[("pair", True), ("obin", True), ("pair", False)],
                ids=["fused-pair", "fused-obin", "unfused-pair"])
def smooth_model(request, params):
    fmt, fuse = request.param
    jp, _ = params
    jq = j_l4.quantize_llama_int4(jp, smooth=True, clip=True, fuse=fuse, fmt=fmt)
    return jq, bridge.from_jax(jax.tree.map(np.asarray, jq), "cpu")


def test_from_jax_keeps_w_r_f32_under_a_bf16_cast(smooth_model):
    """from_jax(dtype=bf16) casts a smoothed tree's float leaves but keeps the
    row equalizers f32, as JAX stores them (the fused MLP's dn_r must be f32)."""
    jq, _ = smooth_model
    got = bridge.from_jax(jax.tree.map(np.asarray, jq), "cpu", dtype=torch.bfloat16)
    jflat = _flat_jax(jq)
    n_r = 0
    for name, t in got.named_parameters():
        key = "".join(f"['{part}']" for part in name.split("."))
        want = jflat[key]
        if key.endswith("['w_r']"):
            n_r += 1
            assert t.dtype == torch.float32, key
            np.testing.assert_array_equal(t.numpy(), want)
        elif key.endswith("['w_s']"):
            assert t.dtype == torch.float32, key
        elif want.dtype == np.float32:
            assert t.dtype == torch.bfloat16, key
    assert n_r == sum(k.endswith("['w_r']") for k in jflat) > 0


def test_llama_forward_smooth_matches_jax(smooth_model):
    """Full (no cache), fresh-cache prefill, then two T == 1 steps on an f32
    cache (the fused tree's decode runs the fused MLP with dn_r)."""
    jq, tq = smooth_model
    assert "w_r" in tq["layers"]["down_proj"]
    rng = np.random.default_rng(6)
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


def test_smooth_decode_passes_dn_r_to_the_fused_mlp(smooth_model, monkeypatch):
    jq, tq = smooth_model
    calls = []
    real = mlp4.mlp_int4_stacked

    def counted(*a, dn_r=None, **k):
        calls.append(dn_r)
        return real(*a, dn_r=dn_r, **k)

    monkeypatch.setattr(mlp4, "mlp_int4_stacked", counted)
    cache = llama.KVCache.zeros(CFG, 1, 8, dtype=torch.float32)
    _, cache = llama.llama_forward(tq, CFG, input_ids=torch.tensor([[5, 6, 7]]), kv_cache=cache,
                                   compute_dtype=torch.float32, assume_fresh_cache=True)
    llama.llama_forward(tq, CFG, input_ids=torch.tensor([[9]]), kv_cache=cache,
                        compute_dtype=torch.float32)
    fused = "gateup_proj" in tq["layers"]  # the prefill's 3 rows and the step's 1: both fused
    assert len(calls) == (2 * CFG.num_layers if fused else 0)
    assert all(r is tq["layers"]["down_proj"]["w_r"] for r in calls)


def test_smooth_lora_matches_jax(smooth_model):
    """LoRA sees the raw input (w_r belongs to the frozen product alone), as
    JAX's test_smoothed_lora_parity."""
    jq, tq = smooth_model
    lcfg = JLoraCfg(rank=4, alpha=8)
    jlt = j_lora.init_params(JCFG, lcfg, jax.random.PRNGKey(7))
    jlt = jax.tree_util.tree_map(lambda x: x + 0.01 if x.ndim == 3 else x, jlt)
    tlt = bridge.from_jax(jax.tree.map(np.asarray, jlt), "cpu")
    ids = np.random.default_rng(6).integers(3, 500, (1, 12)).astype(np.int32)
    mask = np.ones((1, 12), np.int32)
    want, _ = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(ids),
                                    attention_mask=jnp.asarray(mask),
                                    lora=j_lora.with_scaling(jlt, lcfg),
                                    compute_dtype=jnp.float32, attn_impl="xla")
    got, _ = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(ids),
                                 attention_mask=torch.from_numpy(mask),
                                 lora=lora.with_scaling(tlt, LoraConfig(rank=4, alpha=8)),
                                 compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-4)
    # a decode step with LoRA on the MLP takes the gate|up planes path
    cache = llama.KVCache.zeros(CFG, 1, 16, dtype=torch.float32)
    jcache = j_llama.KVCache.zeros(JCFG, 1, 16, dtype=jnp.float32)
    kw_t = dict(lora=lora.with_scaling(tlt, LoraConfig(rank=4, alpha=8)),
                compute_dtype=torch.float32)
    kw_j = dict(lora=j_lora.with_scaling(jlt, lcfg), compute_dtype=jnp.float32)
    _, cache = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(ids), kv_cache=cache,
                                   assume_fresh_cache=True, **kw_t)
    _, jcache = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(ids), kv_cache=jcache,
                                      assume_fresh_cache=True, **kw_j)
    got, _ = llama.llama_forward(tq, CFG, input_ids=torch.tensor([[9]]), kv_cache=cache, **kw_t)
    want, _ = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray([[9]]), kv_cache=jcache,
                                    **kw_j)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-4)


# the megakernel's geometry (tests/test_torch_megakernel.py): hd 128, groups of 128
MK_DIMS = dict(vocab_size=512, hidden_size=256, intermediate_size=256, num_layers=2,
               num_heads=2, num_kv_heads=1, head_dim=128, rms_norm_eps=1e-5)
START, END = 512, 513


def test_generate_greedy_b1_on_a_smoothed_tree_matches_jax(monkeypatch):
    jcfg = dataclasses.replace(JCfg.tiny(), llama=JLlamaCfg(**MK_DIMS))
    cfg = dataclasses.replace(AudioLLMConfig.tiny(), llama=LlamaConfig(**MK_DIMS))
    frozen = j_allm.init_frozen(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_l4.quantize_llama_int4(
        j_llama.resize_embeddings(frozen["llama"], 514, jcfg.llama), smooth=True, clip=True)
    trainable = {"projector": j_allm.init_trainable(jcfg, jax.random.PRNGKey(1))["projector"]}
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(jax.tree.map(np.asarray, trainable), "cpu")
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 500, (1, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    wav = (rng.normal(size=(1, cfg.mel.max_samples)) * 0.1).astype(np.float32)

    lp = tf["llama"]["layers"]
    assert not mk.ok_for(cfg.llama, lp, 64, 7)  # w_r: the gate refuses the tree
    bare = {n: {k: v for k, v in lp[n].items() if k != "w_r"} for n in mk.SLABS}
    assert mk.ok_for(cfg.llama, bare, 64, 7)  # and takes it without w_r
    calls = []
    real = mk.decode_megakernel
    monkeypatch.setattr(mk, "decode_megakernel", lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(max_new_tokens=5, greedy=True, eos_id=-1, pad_id=0, audio_start_id=START,
              audio_end_id=END, has_audio=True, kv_quant=4)
    want = j_gen.generate(frozen, trainable, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                          jnp.asarray(wav), jax.random.PRNGKey(0), compute_dtype=jnp.float32,
                          **kw)
    got = t_gen.generate(tf, tt, cfg, ids, mask, wav, compute_dtype=torch.float32,
                         device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))
    assert not calls
