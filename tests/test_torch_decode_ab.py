"""The inference path's A/B decode kernels (`--decode_impl decode_kernel` and
`decode_packed`) of the port against the JAX package's.

- Ops: the plain versions of the normalized db kernels (`db_plain`,
  `db_q8_plain`, `db_q4_plain`) and of the timeline-chunked kernel
  (`packed_plain`, bf16/f32 and int8 caches) against JAX's
  `decode_attention_{,quantized_,quantized4_}db` and
  `decode_attention_{,quantized_}packed` with interpret=True, in the pattern
  of tests/test_decode_packed.py: L 2-3, B 2, Hq 4, Hkv 2, S 64-96, hd
  32-64; offsets 0, mid-chunk, at a chunk edge and S - 1; padding holes; a
  fully masked leading chunk; chunks of 32 and 64 (NC > 1). Bars: f32
  outputs within 2e-5 (JAX's own tests' bar), bf16 outputs within 2e-2
  absolute and relative (outputs of order 0.1-1: the same bf16 roundings of
  P, where a one-ulp flip of an f32 logit can move a bf16 rounding); the
  caches bit-equal, the appended slot included. `pick_chunk` equals JAX's
  for every 32-multiple timeline from 32 to 4096.
- One decoder step: `llama_forward` T == 1 with attn_impl 'decode_kernel' and
  'decode_packed' against JAX's under `pltpu.force_tpu_interpret_mode()`,
  on f32, int8 and int4 caches filled from the same numpy arrays: logits
  within 1e-4 (test_torch_models.py's bar), every slot but the appended one
  bit-equal; the appended rows within 1e-4 (f32), and their int8/int4 bytes
  and scales equal (each package quantizes its own f32 projection).
  'decode_packed' on an int4 cache raises ValueError in both packages,
  with per-row `cache_offsets` too; per-row offsets under 'decode_kernel'
  take JAX's XLA cached path (logits within 1e-4 of JAX's).
- The slice: greedy `generate` of the port and JAX (interpret mode), f32,
  2 layers, 4 new tokens, identical tokens for decode_kernel (full-precision,
  int8 and, on the int4 tree at tests/test_torch_megakernel.py's geometry,
  int4 KV at B = 1, where the megakernel stays unlaunched) and decode_packed
  (full-precision and int8 KV); the port's CLI with each value gives the
  text of the port's `generate`, and `decode_packed --kv_quant --kv_bits 4`
  raises ValueError in both CLIs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.inference import cli as j_cli  # noqa: E402
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_int4 as j_l4  # noqa: E402
from audio_llama_tpu.ops import decode_attention_db as j_db  # noqa: E402
from audio_llama_tpu.ops import decode_attention_packed as j_pk  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig, LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.inference import cli  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import llama  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_db as db  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_packed as pk  # noqa: E402
from audio_llama_tpu_torch.ops import decode_megakernel as mk  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _t(x):
    """numpy (or a JAX array) -> torch, bf16 kept."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _valid(B, S, off, holes=True, lead_masked=0):
    valid = (np.arange(S)[None, :] <= off).astype(np.int32).repeat(B, 0)
    if holes and off > 8:
        valid[1, 3:6] = 0  # padding holes
    valid[:, :lead_masked] = 0
    return valid


def _case(fmt, dtype, L, B, S, hd, seed):
    """Seeded inputs in numpy: q, the fresh rows and the caches (with their
    scales) of one cache format."""
    rng = np.random.default_rng(seed)
    Hq, Hkv = 4, 2
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q = jnp.asarray(rng.normal(size=(B, Hq, hd)).astype(np.float32), jdt)
    if fmt == "cache":
        rows = [jnp.asarray(rng.normal(size=(B, Hkv, hd)).astype(np.float32), jdt)
                for _ in range(2)]
        caches = [jnp.asarray(rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32), jdt)
                  for _ in range(2)]
        return dict(q=q, rows=rows, caches=caches)
    big = [jnp.asarray(rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32))
           for _ in range(2)]
    new = [jnp.asarray(rng.normal(size=(B, Hkv, hd)).astype(np.float32)) for _ in range(2)]
    if fmt == "int8":
        (ck, ks), (cv, vs) = (j_llama.quantize_kv_rows(c) for c in big)
        (kn, ksn), (vn, vsn) = (j_llama.quantize_kv_rows(r) for r in new)
        return dict(q=q, rows=[kn, vn], caches=[ck, cv], scales=[ks, vs], fresh=[ksn, vsn])
    ckv, ks, vs = j_llama.quantize_kv_rows4(*big)
    kvn, ksn, vsn = j_llama.quantize_kv_rows4(*new)
    return dict(q=q, rows=[kvn], caches=[ckv], scales=[ks, vs], fresh=[ksn, vsn])


def _check(got, want, got_caches, want_caches, dtype):
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=tol, rtol=tol)
    for g, w in zip(got_caches, want_caches):
        np.testing.assert_array_equal(g.float().numpy() if g.dtype == torch.bfloat16
                                      else g.numpy(), _np(w))


DB_CASES = [(fmt, dtype, off) for fmt in ("cache", "int8", "int4")
            for dtype, off in (("f32", 0), ("f32", 63), ("bf16", 37))]


@pytest.mark.parametrize("fmt,dtype,off", DB_CASES)
def test_db_plain_matches_the_pallas_kernel(fmt, dtype, off):
    L, B, S, hd, li = 3, 2, 64, 32 if dtype == "f32" else 64, 1
    c = _case(fmt, dtype, L, B, S, hd, seed=off + len(fmt))
    valid = _valid(B, S, off)
    scale = hd ** -0.5
    tc = [_t(x) for x in c["caches"]]
    args = (li, off, jnp.asarray(valid), scale)
    targs = (li, off, torch.from_numpy(valid), scale)
    if fmt == "cache":
        want = j_db.decode_attention_db(c["q"], *c["rows"], *c["caches"], *args, interpret=True)
        got = db.decode_attention_db(_t(c["q"]), *map(_t, c["rows"]), *tc, *targs)
    elif fmt == "int8":
        ks, vs = (s[li] for s in c["scales"])  # JAX's kernel takes one layer's slabs
        want = j_db.decode_attention_quantized_db(c["q"], *c["rows"], *c["caches"], ks, vs,
                                                  *c["fresh"], *args, interpret=True)
        got = db.decode_attention_quantized_db(_t(c["q"]), *map(_t, c["rows"]), *tc,
                                               *map(_t, c["scales"]), *map(_t, c["fresh"]),
                                               *targs)
    else:
        ks, vs = (s[li] for s in c["scales"])
        want = j_db.decode_attention_quantized4_db(c["q"], c["rows"][0], c["caches"][0], ks,
                                                   vs, *c["fresh"], *args, interpret=True)
        got = db.decode_attention_quantized4_db(_t(c["q"]), _t(c["rows"][0]), tc[0],
                                                *map(_t, c["scales"]), *map(_t, c["fresh"]),
                                                *targs)
    assert got[1].data_ptr() == tc[0].data_ptr()  # appended in place
    assert got[0].dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    _check(got[0], want[0], got[1:], want[1:], dtype)


PACKED_CASES = [  # (cache format, dtype, S, offset, chunk, leading masked slots)
    ("cache", "f32", 64, 0, 32, 0), ("cache", "f32", 64, 40, 32, 0),  # mid-chunk
    ("cache", "f32", 96, 31, 32, 0),  # the last slot of a chunk
    ("cache", "bf16", 96, 95, 32, 0),  # S - 1
    ("cache", "f32", 64, 39, 32, 33),  # the whole first chunk masked
    ("int8", "f32", 128, 100, 64, 0),  # chunk 64, NC 2
    ("int8", "bf16", 96, 64, 32, 0),  # the first slot of a chunk
    ("int8", "f32", 64, 39, 32, 33),
]


@pytest.mark.parametrize("fmt,dtype,S,off,chunk,lead", PACKED_CASES)
def test_packed_plain_matches_the_pallas_kernel(fmt, dtype, S, off, chunk, lead):
    L, B, hd, li = 2, 2, 32 if dtype == "f32" else 64, 1
    c = _case(fmt, dtype, L, B, S, hd, seed=off + S + lead)
    valid = _valid(B, S, off, lead_masked=lead)
    scale = hd ** -0.5
    tc = [_t(x) for x in c["caches"]]
    args = (li, off, jnp.asarray(valid), scale)
    targs = (li, off, torch.from_numpy(valid), scale)
    if fmt == "cache":
        want = j_pk.decode_attention_packed(c["q"], *c["rows"], *c["caches"], *args,
                                            chunk=chunk, interpret=True)
        got = pk.decode_attention_packed(_t(c["q"]), *map(_t, c["rows"]), *tc, *targs,
                                         chunk=chunk)
    else:
        ks, vs = (s[li] for s in c["scales"])
        want = j_pk.decode_attention_quantized_packed(c["q"], *c["rows"], *c["caches"], ks, vs,
                                                      *c["fresh"], *args, chunk=chunk,
                                                      interpret=True)
        got = pk.decode_attention_quantized_packed(_t(c["q"]), *map(_t, c["rows"]), *tc,
                                                   *map(_t, c["scales"]),
                                                   *map(_t, c["fresh"]), *targs, chunk=chunk)
    assert got[1].data_ptr() == tc[0].data_ptr()
    _check(got[0], want[0], got[1:], want[1:], dtype)


def test_pick_chunk_matches_jax():
    assert pk.DEFAULT_CHUNK == j_pk.DEFAULT_CHUNK
    for n in range(32, 4097, 32):
        for chunk in (32, 64, pk.DEFAULT_CHUNK):
            assert pk.pick_chunk(n, chunk) == j_pk._pick_chunk(n, chunk), (n, chunk)
    assert (pk.pick_chunk(3040, 512), 3040 // pk.pick_chunk(3040, 512)) == (160, 19)


def test_wrappers_refuse_a_device_offset():
    c = _case("cache", "f32", 1, 1, 32, 32, seed=0)
    with pytest.raises(TypeError, match="Python int"):
        db.decode_attention_db(_t(c["q"]), *map(_t, c["rows"]), *map(_t, c["caches"]), 0,
                               torch.tensor(3), torch.ones(1, 32, dtype=torch.int32), 0.1)
    with pytest.raises(TypeError, match="Python int"):
        pk.decode_attention_packed(_t(c["q"]), *map(_t, c["rows"]), *map(_t, c["caches"]), 0,
                                   torch.tensor(3), torch.ones(1, 32, dtype=torch.int32), 0.1)


# ---------------------------------------------------------------------------
# one decoder step through llama_forward
# ---------------------------------------------------------------------------

JCFG = JCfg.tiny()
CFG = AudioLLMConfig.tiny()


@pytest.fixture(scope="module")
def tiny():
    frozen = j_allm.init_frozen(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_llama.resize_embeddings(frozen["llama"], JCFG.llama.vocab_size + 2,
                                                JCFG.llama)
    trainable = j_allm.init_trainable(JCFG, jax.random.PRNGKey(1))
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(jax.tree.map(np.asarray, trainable), "cpu")
    return frozen, trainable, tf, tt


def _filled_cache(kv, B, S, off, seed=7):
    """The same cache contents for both packages: (JAX KVCache, port KVCache)."""
    rng = np.random.default_rng(seed)
    lc = JCFG.llama
    shape = (lc.num_layers, B, lc.num_kv_heads, S, lc.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    if kv == "f32":
        arrays = dict(k=k, v=v)
    elif kv == "int8":
        (kq, ks), (vq, vs) = j_llama.quantize_kv_rows(jnp.asarray(k)), \
            j_llama.quantize_kv_rows(jnp.asarray(v))
        arrays = dict(k=kq, v=vq, k_scale=ks, v_scale=vs)
    else:
        kv4, ks, vs = j_llama.quantize_kv_rows4(jnp.asarray(k), jnp.asarray(v))
        arrays = dict(k=kv4, v=None, k_scale=ks, v_scale=vs)
    arrays = {n: None if a is None else np.array(a) for n, a in arrays.items()}
    jc = j_llama.KVCache(length=jnp.int32(off),
                         **{n: None if a is None else jnp.asarray(a) for n, a in arrays.items()})
    tc = llama.KVCache(length=torch.tensor(off, dtype=torch.int32), host_length=off,
                       **{n: None if a is None else torch.from_numpy(a.copy())
                          for n, a in arrays.items()})
    return jc, tc, arrays


def _step(tiny, kv, impl, B=2, S=32, off=20):
    jf, _, tf, _ = tiny
    jc, tc, before = _filled_cache(kv, B, S, off)
    rng = np.random.default_rng(3)
    tok = rng.integers(3, 500, (B, 1)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    mask[1, 4:7] = 0
    pos = np.array([[off], [off - 3]], np.int32)
    with pltpu.force_tpu_interpret_mode():
        jlog, jc = j_llama.llama_forward(
            jf["llama"], JCFG.llama, input_ids=jnp.asarray(tok),
            attention_mask=jnp.asarray(mask), positions=jnp.asarray(pos), kv_cache=jc,
            compute_dtype=jnp.float32, attn_impl=impl)
    tlog, tc = llama.llama_forward(
        tf["llama"], CFG.llama, input_ids=torch.from_numpy(tok),
        attention_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos), kv_cache=tc,
        compute_dtype=torch.float32, attn_impl=impl)
    return jlog, jc, tlog, tc, off


@pytest.mark.parametrize("impl,kv", [("decode_kernel", "f32"), ("decode_kernel", "int8"),
                                     ("decode_kernel", "int4"), ("decode_packed", "f32"),
                                     ("decode_packed", "int8")])
def test_decode_step_matches_jax(tiny, impl, kv):
    jlog, jc, tlog, tc, off = _step(tiny, kv, impl)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4, rtol=1e-4)
    assert tc.host_length == int(jc.length) == off + 1
    others = np.ones(tc.k.shape[3], bool)
    others[off] = False
    for name in ("k", "v", "k_scale", "v_scale"):
        got, want = getattr(tc, name), getattr(jc, name)
        if got is None:
            assert want is None
            continue
        got, want = got.numpy(), _np(want)
        np.testing.assert_array_equal(got[:, :, :, others], want[:, :, :, others])
        if kv == "f32":
            np.testing.assert_allclose(got[:, :, :, off], want[:, :, :, off], atol=1e-4)
        else:  # quantized rows: the same bytes and scales
            np.testing.assert_allclose(got[:, :, :, off], want[:, :, :, off], rtol=1e-6)


def test_decode_packed_refuses_an_int4_cache(tiny):
    with pytest.raises(ValueError, match="no int4-KV variant"):
        _step(tiny, "int4", "decode_packed")
    jc, tc, _ = _filled_cache("int4", 2, 32, 20)
    tok = torch.ones((2, 1), dtype=torch.int64)
    with pytest.raises(ValueError, match="no int4-KV variant"):
        llama.llama_forward(tiny[2]["llama"], CFG.llama, input_ids=tok, kv_cache=tc,
                            compute_dtype=torch.float32, attn_impl="decode_packed")
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        llama.llama_forward(tiny[2]["llama"], CFG.llama, input_ids=tok, kv_cache=tc,
                            compute_dtype=torch.float32, attn_impl="xla")
    offs = np.array([20, 13], np.int32)  # per-row offsets: refused too, as in JAX
    with pytest.raises(ValueError, match="no int4-KV variant"):
        j_llama.llama_forward(tiny[0]["llama"], JCFG.llama, input_ids=jnp.ones((2, 1), jnp.int32),
                              kv_cache=jc, cache_offsets=jnp.asarray(offs),
                              compute_dtype=jnp.float32, attn_impl="decode_packed")
    with pytest.raises(ValueError, match="no int4-KV variant"):
        llama.llama_forward(tiny[2]["llama"], CFG.llama, input_ids=tok, kv_cache=tc,
                            cache_offsets=torch.from_numpy(offs), compute_dtype=torch.float32,
                            attn_impl="decode_packed")
    # per-row offsets under decode_kernel take JAX's XLA cached path (the db
    # kernels take one scalar offset): logits within 1e-4 of JAX's
    want, _ = j_llama.llama_forward(tiny[0]["llama"], JCFG.llama,
                                    input_ids=jnp.ones((2, 1), jnp.int32), kv_cache=jc,
                                    cache_offsets=jnp.asarray(offs), compute_dtype=jnp.float32,
                                    attn_impl="decode_kernel")
    got, _ = llama.llama_forward(tiny[2]["llama"], CFG.llama, input_ids=tok, kv_cache=tc,
                                 cache_offsets=torch.from_numpy(offs),
                                 compute_dtype=torch.float32, attn_impl="decode_kernel")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the slice: greedy generate, port against JAX
# ---------------------------------------------------------------------------

def _generate_both(jf, jt, tf, tt, jcfg, cfg, ids, mask, impl, kv_quant, n=4):
    kw = dict(max_new_tokens=n, greedy=True, eos_id=-1, pad_id=0, audio_start_id=512,
              audio_end_id=513, has_audio=False, kv_quant=kv_quant)
    with pltpu.force_tpu_interpret_mode():
        want = j_gen.generate(jf, jt, jcfg, jnp.asarray(ids), jnp.asarray(mask), None,
                              jax.random.PRNGKey(0), compute_dtype=jnp.float32,
                              attn_impl=impl, **kw)
    got = t_gen.generate(tf, tt, cfg, ids, mask, None, compute_dtype=torch.float32,
                         device="cpu", attn_impl=impl, **kw)
    return got, want


@pytest.mark.parametrize("impl,kv_quant", [("decode_kernel", False), ("decode_kernel", True),
                                           ("decode_packed", False), ("decode_packed", True)])
def test_greedy_tokens_match_jax(tiny, impl, kv_quant):
    jf, jt, tf, tt = tiny
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 500, (2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0  # row 1 right-padded
    counts = (db.launches_norm, db.launches_norm_q8, pk.launches, pk.launches_q8)
    got, want = _generate_both(jf, jt, tf, tt, JCFG, CFG, ids, mask, impl, kv_quant)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(), np.asarray(want.num_generated))
    # on the host the plain versions ran, never a kernel
    assert counts == (db.launches_norm, db.launches_norm_q8, pk.launches, pk.launches_q8)


INT4_DIMS = dict(vocab_size=512, hidden_size=256, intermediate_size=256, num_layers=2,
                 num_heads=2, num_kv_heads=1, head_dim=128, rms_norm_eps=1e-5,
                 rope_scaling=None, tie_word_embeddings=True)


def test_int4_decoder_with_int4_kv_b1_matches_jax(tiny, monkeypatch):
    """The int4 tree at tests/test_torch_megakernel.py's geometry, B = 1, an
    int4 KV cache: decode_kernel runs the int4 db kernel on every step and
    leaves the megakernel off (its gate would pass at 'auto')."""
    jcfg = dataclasses.replace(JCfg.tiny(), llama=JLlamaCfg(**INT4_DIMS))
    cfg = dataclasses.replace(AudioLLMConfig.tiny(), llama=LlamaConfig(**INT4_DIMS))
    frozen = j_allm.init_frozen(jcfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    frozen["llama"] = j_l4.quantize_llama_int4(
        j_llama.resize_embeddings(frozen["llama"], 514, jcfg.llama), fuse=True)
    jt = {"projector": j_allm.init_trainable(jcfg, jax.random.PRNGKey(3))["projector"]}
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(jax.tree.map(np.asarray, jt), "cpu")
    ids = np.random.default_rng(6).integers(3, 500, (1, 9)).astype(np.int32)
    mask = np.ones_like(ids)
    calls = []
    real = mk.decode_megakernel
    monkeypatch.setattr(mk, "decode_megakernel", lambda *a, **k: calls.append(1) or real(*a, **k))
    got, want = _generate_both(frozen, jt, tf, tt, jcfg, cfg, ids, mask, "decode_kernel", 4)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert not calls and mk.launches == 0
    # the same request at 'auto' does go through the megakernel
    t_gen.generate(tf, tt, cfg, ids, mask, None, compute_dtype=torch.float32, device="cpu",
                   max_new_tokens=2, greedy=True, eos_id=-1, audio_start_id=512,
                   audio_end_id=513, has_audio=False, kv_quant=4)
    assert calls


@pytest.mark.parametrize("flags", [["--decode_impl", "decode_kernel"],
                                   ["--decode_impl", "decode_kernel", "--kv_quant"],
                                   ["--decode_impl", "decode_kernel", "--kv_quant", "--kv_bits",
                                    "4"],
                                   ["--decode_impl", "decode_packed"],
                                   ["--decode_impl", "decode_packed", "--kv_quant"]])
def test_cli_decode_impl_gives_generates_text(flags):
    n = 3
    text = cli.main(["--platform", "cpu", "--toy_model", "--tokenizer", "byte", "--prompt",
                     "x", "--greedy", "--max_new_tokens", str(n)] + flags)
    cfg, frozen, trainable, tk = cli.load_audio_llm(None, tokenizer="byte", toy_model=True,
                                                    device="cpu")
    ids, mask = tk.encode("x")
    kv = (4 if "4" in flags else True) if "--kv_quant" in flags else False
    res = t_gen.generate(frozen, trainable, cfg, ids[None], mask[None], None,
                         max_new_tokens=n, greedy=True, eos_id=tk.eos_id, pad_id=tk.pad_id,
                         compute_dtype=torch.bfloat16, has_audio=False, kv_quant=kv,
                         device="cpu", attn_impl=flags[1])
    tokens = res.tokens[0, : int(res.num_generated[0])].numpy()
    assert text == tk.decode(tokens, skip_special_tokens=True)


def test_cli_decode_packed_refuses_int4_kv_in_both_packages():
    argv = ["--platform", "cpu", "--toy_model", "--tokenizer", "byte", "--prompt", "x",
            "--greedy", "--max_new_tokens", "2", "--decode_impl", "decode_packed",
            "--kv_quant", "--kv_bits", "4"]
    with pytest.raises(ValueError, match="no int4-KV variant"):
        cli.main(argv)
    with pytest.raises(ValueError, match="no int4-KV variant"):
        j_cli.main(argv)
