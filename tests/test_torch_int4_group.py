"""The int4 kernels' scale-group argument: the port at groups 32 and 64
against the JAX package's.

Toy dims (hidden 128, F 256, hd 32, 2 layers, as tests/test_torch_int4.py).
Bars, as that module's:
  - the plain kernels (`int4_matmul_stacked` whole K and K-split, both pack
    formats, M 4 and 72; `int4_matmul`; `mlp_int4_stacked` with and without
    dn_r) against the JAX Pallas kernels in interpret mode at the same
    group: f32 x to 1e-5 of the output's scale (the same f32 group sums in
    another order); bf16 x to one bf16 rounding (2^-7 relative plus 1e-2 of
    the scale);
  - `llama_forward` on group-32 JAX trees passed through the bridge (RTN
    with clip on and off, smoothed, GPTQ): full forward and two decode steps
    at f32 within 2e-4; greedy `generate` with an int4 KV cache at f32:
    tokens equal to JAX's, token for token;
  - the card kernels' geometry in Python (`check_group`, `decode_split`,
    `kernel_chunk`): exact.
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
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_gptq as j_gq  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.ops import int4_matmul as j_i4  # noqa: E402
from audio_llama_tpu.ops import mlp_int4 as j_mlp4  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig, LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import llama  # noqa: E402
from audio_llama_tpu_torch.ops import decode_megakernel as mk  # noqa: E402
from audio_llama_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from audio_llama_tpu_torch.ops import mlp_int4 as mlp4  # noqa: E402

DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position_embeddings=2048, rope_scaling=None,
            tie_word_embeddings=True)
JCFG, CFG = JLlamaCfg(**DIMS), LlamaConfig(**DIMS)
GROUPS = (32, 64)
START, END = 512, 513


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return bridge.to_tensor(np.asarray(x), torch.device("cpu"))


def _assert_bar(got, want, dtype):
    want = _np(want)
    scale = np.abs(want).max()
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-2 * scale)


def _packed(w, group, fmt):
    """Stacked [L, K, N] f32 -> JAX (packed, scales) at the group."""
    p, s = zip(*(j_i4.quantize_pack(jnp.asarray(w[i]), group=group, fmt=fmt)
                 for i in range(w.shape[0])))
    return jnp.stack(p), jnp.stack(s)


def _x(rng, M, K, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    return jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(jdt)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M", [4, 72])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_int4_matmul_stacked_at_the_group_matches_the_pallas_kernel(group, fmt, M, dtype):
    L, K, N = 2, 256, 256
    rng = np.random.default_rng(group + M)
    jp, js = _packed(rng.normal(size=(L, K, N)).astype(np.float32), group, fmt)
    assert js.shape == (L, K // group, N)
    xj = _x(rng, M, K, dtype)
    for block_k in (0, 128):  # whole K; two K blocks of 128 / group groups
        want = j_i4.int4_matmul_stacked(xj, jp, js, jnp.int32(1), group=group, interpret=True,
                                        block_k=block_k, fmt=fmt)
        got = i4.int4_matmul_stacked(_t(xj), _t(jp), _t(js), 1, group=group, fmt=fmt,
                                     block_k=block_k)
        assert got.dtype == _t(xj).dtype
        _assert_bar(got, want, dtype)


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("M", [4, 72])
def test_int4_matmul_2d_at_the_group_matches_the_pallas_kernel(group, fmt, M):
    K, N = 256, 384
    rng = np.random.default_rng(3 * group + M)
    p, s = j_i4.quantize_pack(jnp.asarray(rng.normal(size=(K, N)).astype(np.float32)),
                              group=group, fmt=fmt)
    xj = _x(rng, M, K, "f32")
    want = j_i4.int4_matmul(xj, p, s, group=group, interpret=True, fmt=fmt)
    _assert_bar(i4.int4_matmul(_t(xj), _t(p), _t(s), group=group, fmt=fmt), want, "f32")


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("dnr", [False, True])
def test_mlp_int4_stacked_at_the_group_matches_the_pallas_kernel(group, fmt, dnr):
    L, K, Fd, D, M = 2, 256, 512, 256, 3
    rng = np.random.default_rng(group + 7 * dnr)
    gp, gs = _packed(rng.normal(size=(L, K, 2 * Fd)).astype(np.float32), group, fmt)
    dp, ds = _packed(rng.normal(size=(L, Fd, D)).astype(np.float32) * 0.1, group, fmt)
    dn_r = rng.uniform(0.25, 4.0, size=(L, Fd)).astype(np.float32) if dnr else None
    xj = _x(rng, M, K, "f32") * 0.1
    chunk = mlp4.kernel_chunk(Fd, D // 2, group)  # the card kernel's chunk
    assert chunk == 128
    for li in (0, 1):
        want = j_mlp4.mlp_int4_stacked(xj, gp, gs, dp, ds, jnp.int32(li), group=group,
                                       chunk=256, interpret=True, fmt=fmt,
                                       dn_r=None if dn_r is None else jnp.asarray(dn_r))
        got = mlp4.mlp_int4_stacked(_t(xj), _t(gp), _t(gs), _t(dp), _t(ds), li, group=group,
                                    chunk=chunk, fmt=fmt,
                                    dn_r=None if dn_r is None else torch.from_numpy(dn_r))
        _assert_bar(got, want, "f32")


def test_group_check_and_geometry():
    for g in (32, 64, 128, 256):
        assert i4.group_ok(g)
        i4.check_group("k", 3072 if g != 256 else 2048, g)
    for g in (0, 8, 24, 48, 96, 192):
        assert not i4.group_ok(g)
        with pytest.raises(ValueError, match="multiple of 16"):
            i4.check_group("k", 3072, g)
    with pytest.raises(ValueError, match="divide K"):
        i4.check_group("k", 384, 256)  # 256 does not divide K
    with pytest.raises(ValueError, match="K a multiple of 128"):
        i4.check_group("k", 96, 32)  # the kernels stage 128-row tiles
    # the decode shape: a group below 128 keeps group 128's blocks and rows
    for M, K, Nh in ((4, 3072, 2560), (1, 8192, 1536), (8, 3072, 1536), (37, 512, 256)):
        base = i4.decode_split(M, K, Nh, 128)
        assert i4.decode_split(M, K, Nh, 32) == base == i4.decode_split(M, K, Nh, 64)
        mc, kr, ksplit = base
        assert kr % 128 == 0 and ksplit == -(-K // kr)
        mc, kr, ksplit = i4.decode_split(M, K, Nh, 256)
        assert kr % 256 == 0 and ksplit == -(-K // kr) and kr <= 1024
    # the fused MLP's chunk: 128 columns up to group 128, the group above it
    assert mlp4.kernel_chunk(8192, 1536, 32) == mlp4.kernel_chunk(8192, 1536, 128) == 128
    assert mlp4.kernel_chunk(8192, 1536, 256) == 256
    assert mlp4.kernel_chunk(8192, 1536, 48) is None  # 48 divides no 128-multiple chunk


# -- whole trees at group 32 -------------------------------------------------

def _llama_f32():
    return j_llama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)


def _gptq(jp, group):
    rng = np.random.default_rng(9)
    ids = jnp.asarray(rng.integers(3, 500, (2, 16)).astype(np.int32))
    stats = j_gq.collect_llama_stats(jp, JCFG, ids, jnp.ones_like(ids))
    return j_gq.quantize_llama_int4_gptq(jp, stats, group=group, clip_cands=j_l4.CLIP_CANDS)


TREES = {
    "clip": lambda jp: j_l4.quantize_llama_int4(jp, group=32, clip=True),
    "rtn": lambda jp: j_l4.quantize_llama_int4(jp, group=32, clip=False),
    "smooth": lambda jp: j_l4.quantize_llama_int4(jp, group=32, smooth=True, clip=True),
    "gptq": lambda jp: _gptq(jp, 32),
}


@pytest.fixture(scope="module", params=sorted(TREES))
def tree32(request):
    jq = TREES[request.param](_llama_f32())
    assert jq["layers"]["qkv_proj"]["w_s"].shape[-2] == DIMS["hidden_size"] // 32
    return request.param, jq, bridge.from_jax(jax.tree.map(np.asarray, jq), "cpu")


def test_llama_forward_on_a_group32_tree_matches_jax(tree32):
    name, jq, tq = tree32
    assert llama._int4_group(tq["layers"]["gateup_proj"]) == 32
    rng = np.random.default_rng(6)
    B, T, extra = 2, 9, 2
    ids = rng.integers(3, 500, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 7:] = 0
    full_j, _ = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(ids),
                                      attention_mask=jnp.asarray(mask),
                                      compute_dtype=jnp.float32, attn_impl="xla")
    full_t, _ = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(ids),
                                    attention_mask=torch.from_numpy(mask),
                                    compute_dtype=torch.float32)
    np.testing.assert_allclose(full_t.numpy()[mask == 1], _np(full_j)[mask == 1], atol=2e-4,
                               err_msg=name)
    fmask = np.concatenate([mask, np.ones((B, extra), np.int32)], axis=1)
    jc = j_llama.KVCache.zeros(JCFG, B, T + extra, dtype=jnp.float32)
    tc = llama.KVCache.zeros(CFG, B, T + extra, dtype=torch.float32)
    _, jc = j_llama.llama_forward(jq, JCFG, input_ids=jnp.asarray(ids),
                                  attention_mask=jnp.asarray(fmask), kv_cache=jc,
                                  compute_dtype=jnp.float32, assume_fresh_cache=True)
    _, tc = llama.llama_forward(tq, CFG, input_ids=torch.from_numpy(ids),
                                attention_mask=torch.from_numpy(fmask), kv_cache=tc,
                                compute_dtype=torch.float32, assume_fresh_cache=True)
    real = mask.sum(1)
    for i in range(extra):  # T == 1 steps: the fused int4 MLP at group 32
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
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=2e-4, err_msg=name)


def test_generate_on_a_group32_tree_matches_jax(tree32, monkeypatch):
    """Greedy tokens at B = 2 with an int4 KV cache, token for token; the
    fused MLP runs at group 32 every decode step (the megakernel refuses the
    tree: its group is not 128)."""
    name, jq, _ = tree32
    jcfg = dataclasses.replace(JCfg.tiny(), llama=JCFG)
    cfg = dataclasses.replace(AudioLLMConfig.tiny(), llama=CFG)
    frozen = j_allm.init_frozen(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    jq = dict(jq)
    for key in ("embed", "lm_head"):  # the two audio tokens' rows, as resize_embeddings
        if key in jq:
            jq[key] = {k: jnp.concatenate([v, v[:2]], axis=0) for k, v in jq[key].items()}
    frozen["llama"] = jq
    trainable = {"projector": j_allm.init_trainable(jcfg, jax.random.PRNGKey(1))["projector"]}
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(jax.tree.map(np.asarray, trainable), "cpu")
    assert not mk.ok_for(cfg.llama, tf["llama"]["layers"], 64, 7)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 500, (2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    wav = (rng.normal(size=(2, cfg.mel.max_samples)) * 0.1).astype(np.float32)
    calls = []
    real = mlp4.mlp_int4_stacked
    monkeypatch.setattr(mlp4, "mlp_int4_stacked",
                        lambda *a, **k: calls.append(k.get("group")) or real(*a, **k))
    kw = dict(max_new_tokens=5, greedy=True, eos_id=-1, pad_id=0, audio_start_id=START,
              audio_end_id=END, has_audio=True, kv_quant=4)
    want = j_gen.generate(frozen, trainable, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                          jnp.asarray(wav), jax.random.PRNGKey(0), compute_dtype=jnp.float32,
                          **kw)
    got = t_gen.generate(tf, tt, cfg, ids, mask, wav, compute_dtype=torch.float32,
                         device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens), err_msg=name)
    assert calls and set(calls) == {32}
