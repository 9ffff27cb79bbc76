"""The port's decode megakernel against the JAX package's.

At the JAX megakernel test's geometry (tests/test_megakernel.py: D 256,
F 256, 2 layers, 2 query heads on 1 KV head, hd 128, Tk 64), both pack
formats:
- the plain version against JAX `decode_megakernel(..., interpret=True)` on
  the same bridged slabs and cache: the hidden state within rel-L2 1e-2 at
  bf16, the fresh scales within 1e-6 relative, the cache nibbles within +-1
  on under 1% of bytes and identical elsewhere (the JAX test's own bar: the
  two are separately ordered f32 programs, so an ulp can flip a rounding);
- one request through the port's dispatch (prefill, then 3 decode steps,
  each one megakernel step) against JAX's megakernel run (MEGA_DECODE=interp,
  MLP_FUSED=interp, attn_impl='decode_mono', TPU interpret mode), on a plain
  and a rotated tree: the greedy argmax equal at every step, logits within
  the JAX test's rtol 0.1 / atol 0.15; the per-layer arm
  (`megakernel=False`) gives the same argmax chain;
- the gate: `ok_for` refuses a timeline not a multiple of 32, head_dim 64
  and a full cache (offset == Tk); the dispatch skips the megakernel with
  LoRA or per-row offsets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.models import llama_rotate as j_rt  # noqa: E402
from audio_llama_tpu.ops import decode_megakernel as j_mk  # noqa: E402
from audio_llama_tpu.ops import int4_matmul as j_i4  # noqa: E402
from audio_llama_tpu.ops import rope as j_rope  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.models import llama  # noqa: E402
from audio_llama_tpu_torch.ops import decode_megakernel as mk  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

DIMS = dict(vocab_size=512, hidden_size=256, intermediate_size=256, num_layers=2, num_heads=2,
            num_kv_heads=1, head_dim=128, rms_norm_eps=1e-5)
JCFG, CFG = JLlamaCfg(**DIMS), LlamaConfig(**DIMS)
TK = 64
SLABS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")


def _np(x):
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.name == "bfloat16" \
        else np.asarray(x)


def _tree(fmt, seed=0, rotate=False):
    key = jax.random.PRNGKey(seed)
    params = j_llama.init_params(JCFG, key, dtype=jnp.bfloat16)
    if rotate:
        params = j_rt.rotate_llama(params, JCFG, jax.random.fold_in(key, 7))
    return j_l4.quantize_llama_int4(params, fuse=True, fmt=fmt, group=128)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
def test_megakernel_plain_matches_the_pallas_kernel(fmt):
    qp = _tree(fmt)
    lp = qp["layers"]
    rng = np.random.default_rng(1)
    off = 23
    # a cache holding int4 rows in slots [0, off) and stale rows after it
    ckv, ks, vs = (np.array(a) for a in j_llama.quantize_kv_rows4(
        jnp.asarray(rng.normal(size=(2, 1, 1, TK, 128)).astype(np.float32)),
        jnp.asarray(rng.normal(size=(2, 1, 1, TK, 128)).astype(np.float32))))
    x = jnp.asarray(rng.normal(size=(1, 256)) * 0.5, jnp.bfloat16)
    cos, sin = j_rope.rope_tables(jnp.array([[off]]), j_rope.rope_for_config(JCFG))
    valid = (np.arange(TK)[None, :] <= off).astype(np.int32)
    valid[0, 4:7] = 0
    kw = dict(eps=JCFG.rms_norm_eps, scale=128 ** -0.5, fmt=fmt)
    want_h, want_c, want_fs = j_mk.decode_megakernel(
        x, *(lp[n] for n in SLABS), lp["input_ln"], lp["post_attn_ln"], cos[0, 0], sin[0, 0],
        jnp.asarray(ckv), jnp.asarray(ks), jnp.asarray(vs), jnp.int32(off), jnp.asarray(valid),
        interpret=True, **kw)

    tp = bridge.from_jax(jax.tree.map(np.asarray, qp), "cpu")["layers"]
    t_ckv, t_ks, t_vs = (torch.from_numpy(a.copy()) for a in (ckv, ks, vs))
    got_h, got_c, got_fs = mk.decode_megakernel(
        bridge.to_tensor(np.asarray(x), torch.device("cpu")), *(tp[n] for n in SLABS),
        tp["input_ln"], tp["post_attn_ln"], torch.from_numpy(np.array(cos[0, 0])),
        torch.from_numpy(np.array(sin[0, 0])), t_ckv, t_ks, t_vs, torch.tensor(off),
        torch.from_numpy(valid), **kw)
    assert got_c.data_ptr() == t_ckv.data_ptr()  # appended in place
    gh, wh = got_h.float().numpy(), _np(want_h)
    assert np.linalg.norm(gh - wh) <= 1e-2 * np.linalg.norm(wh)
    np.testing.assert_allclose(got_fs.numpy(), _np(want_fs)[..., :2], rtol=1e-6, atol=0)
    # the fresh scales also land in the slabs at the offset (the JAX caller
    # scatters them there)
    np.testing.assert_allclose(t_ks[:, 0, :, off].numpy(), _np(want_fs)[..., 0], rtol=1e-6)
    np.testing.assert_allclose(t_vs[:, 0, :, off].numpy(), _np(want_fs)[..., 1], rtol=1e-6)
    kg, kw_ = got_c.numpy().astype(np.int32), _np(want_c).astype(np.int32)
    lo_d, hi_d = np.abs((kg & 0xF) - (kw_ & 0xF)), np.abs((kg >> 4) - (kw_ >> 4))
    assert lo_d.max() <= 1 and hi_d.max() <= 1
    assert ((lo_d + hi_d) > 0).mean() < 0.01
    untouched = np.ones(TK, bool)
    untouched[off] = False
    np.testing.assert_array_equal(kg[..., untouched, :], ckv.astype(np.int32)[..., untouched, :])


def _jax_run(qp, ids, mega, steps, monkeypatch):
    """The JAX megakernel test's _run: prefill on the XLA path, then decode
    steps on the megakernel (interpret mode) or the per-layer kernels."""
    from jax.experimental.pallas import tpu as pltpu

    monkeypatch.setenv("MEGA_DECODE", "interp" if mega else "0")
    monkeypatch.setenv("MLP_FUSED", "interp")
    monkeypatch.setattr(j_i4, "available", lambda: True)
    cache = j_llama.KVCache.zeros(JCFG, 1, TK, quantized=4)
    with pltpu.force_tpu_interpret_mode():
        logits, cache = j_llama.llama_forward(
            qp, JCFG, input_ids=jnp.asarray(ids), kv_cache=cache, compute_dtype=jnp.bfloat16,
            attn_impl="xla", assume_fresh_cache=True)
    cache = j_llama.KVCache(k=cache.k, v=cache.v, length=jnp.int32(ids.shape[1]),
                            k_scale=cache.k_scale, v_scale=cache.v_scale)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    trail = []
    with pltpu.force_tpu_interpret_mode():
        for _ in range(steps):
            logits, cache = j_llama.llama_forward(
                qp, JCFG, input_ids=tok[:, None], kv_cache=cache, compute_dtype=jnp.bfloat16,
                attn_impl="decode_mono")
            trail.append(_np(logits[:, 0].astype(jnp.float32)))
            tok = jnp.argmax(logits[:, 0], axis=-1).astype(jnp.int32)
    return trail


def _port_run(tree, ids, mega, steps, monkeypatch):
    """Prefill, then `steps` greedy decode steps through llama_forward ->
    (logit trail, megakernel steps taken)."""
    calls = []
    real = mk.decode_megakernel

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mk, "decode_megakernel", counted)
    cache = llama.KVCache.zeros(CFG, 1, TK, quantized=4)
    logits, cache = llama.llama_forward(tree, CFG, input_ids=torch.from_numpy(ids),
                                        kv_cache=cache, compute_dtype=torch.bfloat16,
                                        assume_fresh_cache=True)
    tok = logits[:, -1].argmax(-1)
    trail = []
    for _ in range(steps):
        logits, cache = llama.llama_forward(tree, CFG, input_ids=tok[:, None], kv_cache=cache,
                                            compute_dtype=torch.bfloat16, megakernel=mega)
        trail.append(logits[:, 0].float().numpy())
        tok = logits[:, 0].argmax(-1)
    return trail, len(calls)


@pytest.mark.parametrize("fmt,rotate", [("pair", False), ("obin", False), ("obin", True)])
def test_one_request_through_the_dispatch_matches_jax(fmt, rotate, monkeypatch):
    seed = 3 if rotate else 0
    qp = _tree(fmt, seed=seed, rotate=rotate)
    ids = np.random.RandomState(seed + 1).randint(3, JCFG.vocab_size - 3, (1, 7)).astype(np.int32)
    want = _jax_run(qp, ids, True, 3, monkeypatch)
    tree = bridge.from_jax(jax.tree.map(np.asarray, qp), "cpu")
    assert ("rot" in tree) == rotate
    got, n_mega = _port_run(tree, ids, True, 3, monkeypatch)
    per_layer, n_off = _port_run(tree, ids, False, 3, monkeypatch)
    assert (n_mega, n_off) == (3, 0)
    for t, (g, w, pl_) in enumerate(zip(got, want, per_layer)):
        np.testing.assert_allclose(g, w, rtol=0.1, atol=0.15, err_msg=f"step {t}")
        assert g.argmax(-1) == w.argmax(-1) == pl_.argmax(-1), f"step {t}"


def test_gate_refuses(monkeypatch):
    tree = bridge.from_jax(jax.tree.map(np.asarray, _tree("pair")), "cpu")
    lp = tree["layers"]
    assert mk.ok_for(CFG, lp, 64, 7)
    assert not mk.ok_for(CFG, lp, 63, 7)  # timeline not 32-aligned
    assert not mk.ok_for(CFG, lp, 64, 64)  # a full cache: the append slot is outside
    assert not mk.ok_for(LlamaConfig(**{**DIMS, "head_dim": 64}), lp, 64, 7)
    assert not mk.ok_for(CFG, {n: lp[n] for n in SLABS[:3]}, 64, 7)

    calls = []
    monkeypatch.setattr(mk, "decode_megakernel", lambda *a, **k: calls.append(1))
    cache = llama.KVCache.zeros(CFG, 1, TK, quantized=4)
    cache = cache._replace(length=torch.tensor(5, dtype=torch.int32), host_length=5)
    tok = torch.tensor([[11]])
    llama.llama_forward(tree, CFG, input_ids=tok, kv_cache=cache,
                        cache_offsets=torch.tensor([5], dtype=torch.int32))
    lora = {"layers": {"q_proj": {"a": torch.zeros(2, 256, 4), "b": torch.zeros(2, 4, 256)}},
            "scaling": 1.0}
    llama.llama_forward(tree, CFG, input_ids=tok, kv_cache=cache, lora=lora)
    llama.llama_forward(tree, CFG, input_ids=tok, kv_cache=cache._replace(host_length=TK))
    assert calls == []


# (D, F, Hq, Hkv): the 3B widths (G 3), the JAX test's geometry (G 2), and
# the card tests' G 1 and G 4 geometries
PLAN_WIDTHS = [(3072, 8192, 24, 8), (256, 256, 2, 1), (1024, 2816, 8, 8), (2048, 5632, 16, 4)]


@pytest.mark.parametrize("widths", PLAN_WIDTHS)
@pytest.mark.parametrize("tk", [32, 64, 1568, 3040, mk.MAX_TK])
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 1), (114, 2), (16, 1)])
def test_launch_plan_covers_every_column_row_and_slot_once(widths, tk, sms, per_sm):
    """The kernel's work split (the formulas `plan`, `shares`, `tile_slices`
    and `splits` share with csrc/decode_megakernel.cu): every product's
    units (a group of 128 K rows of a tile of 128 packed columns) go to
    exactly one block, each tile's K slices cover its groups once in K
    order under distinct partial keys, every share fits the block's x-row
    slots, and each KV head's timeline groups go to exactly one split, one
    split a block."""
    D, F, Hq, Hkv = widths
    pl = mk.plan(D, F, Hq, Hkv, tk, sms, per_sm)
    P = pl.grid
    assert P == sms * per_sm and pl.smem == mk.smem_bytes(pl.maxj, D, pl.splits, Hq // Hkv)
    assert mk.ok_for(LlamaConfig(**{**DIMS, "hidden_size": D, "intermediate_size": F,
                                    "num_heads": Hq, "num_kv_heads": Hkv}),
                     {n: {"w_p": torch.empty((1, K, Nh), dtype=torch.int8),
                          "w_s": torch.empty((1, K // 128, 2 * Nh))}
                      for n, (K, Nh) in zip(SLABS, mk.products(D, F, Hq, Hkv))}, tk, tk - 1)
    for K, Nh in mk.products(D, F, Hq, Hkv):
        T, Gk = Nh // mk.TILE, K // 128
        assert T * mk.TILE == Nh and Gk * 128 == K  # every column and K row in some unit
        W = T * Gk
        sh = mk.shares(W, P)
        assert sh[0][0] == 0 and sh[-1][1] == W
        assert all(a[1] == b[0] for a, b in zip(sh, sh[1:]))  # each unit in one share
        assert max(e - s for s, e in sh) <= pl.maxj and W <= pl.stages and T <= pl.tiles
        keys = []
        for t in range(T):
            sl = mk.tile_slices(t, Gk, W, P)
            assert [g for _, lo, hi in sl for g in range(lo, hi)] == list(range(t * Gk, t * Gk + Gk))
            for b, lo, hi in sl:
                assert (lo, hi) == (max(sh[b][0], t * Gk), min(sh[b][1], t * Gk + Gk))
            keys += [lo for _, lo, _ in sl]
        assert len(set(keys)) == len(keys)
    ng = tk // 32
    sp = mk.splits(ng, pl.splits)
    assert Hkv * pl.splits <= P
    assert [g for lo, hi in sp for g in range(lo, hi)] == list(range(ng))
    assert all(hi > lo for lo, hi in sp)  # every split arrives at its head's merge
