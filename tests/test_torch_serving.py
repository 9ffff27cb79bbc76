"""The port's continuous-batching pool against the JAX package's, on CPU.

After tests/test_serving.py, test_prefix_cache.py, test_batched_admission.py,
test_chunked_prefill.py, test_per_request_sampling.py and
test_cache_offsets.py, at AudioLLMConfig.tiny() in f32 on the same bridged
weights (LoRA with a non-zero delta):

- The pool: one request stream (text prompts of several buckets, 30 s-window
  audio requests, suffixes on a registered text prefix, auto-matched
  prefixes, more requests than rows) through JAX's `ServingEngine` and the
  port's, for bf16/f32, int8 and int4 KV caches and three admission modes
  (whole-prompt, chunked prefill in pieces of 3, batched admission of 2):
  the greedy tokens equal JAX's token for token. Each JAX engine runs once
  per module (a module-scoped cache of the streams).
- The port's pool equals the port's own `generate` on text and audio
  requests; a mixed greedy/sampled pool keeps its greedy rows exact; EOS
  retires a row early; an oversized prompt is rejected with [] as in JAX.
- `filtered_logits_per_row` equals JAX's; with uniform parameters it equals
  `filtered_logits`; `sample_token_per_row` takes greedy rows by argmax.
- `llama_forward`'s cached arms against JAX's: T > 1 rows into a filled
  cache at a scalar offset, with the window clamped to fit, at per-row
  offsets, and T == 1 per-row steps under attn_impl 'decode_kernel' (JAX's
  XLA fallback) with one row past the timeline (dropped), on f32, int8 and
  int4 caches: logits within 1e-4, every slot outside the written windows
  bit-equal; the written rows within 1e-4 (f32) or on the same int8/int4
  levels, one apart at a rounding tie, with scales within 1e-5 relative
  (each package quantizes its own f32 projection).
- The decode chunk reads nothing back from the device (Tensor.item, int,
  bool, tolist, cpu, numpy counted); the harvest does one copy. The splice
  writes only its row. draft_params and a dp > 1 mesh raise
  NotImplementedError naming ROADMAP queue 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.inference.serving import ServingEngine as JEngine  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.ops import sampling as j_sampling  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.inference.serving import ServingEngine  # noqa: E402
from audio_llama_tpu_torch.models import llama  # noqa: E402
from audio_llama_tpu_torch.ops import sampling  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

JCFG = JCfg.tiny()
CFG = AudioLLMConfig.tiny()
AUDIO_START, AUDIO_END = 512, 513
KVS = [False, 8, 4]
MODES = {"whole": {}, "staged": {"prefill_chunk_tokens": 3}, "batched": {"admit_batch": 2}}


@pytest.fixture(scope="module")
def model():
    frozen = j_allm.init_frozen(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_llama.resize_embeddings(frozen["llama"], JCFG.llama.vocab_size + 2,
                                                JCFG.llama)
    trainable = j_allm.init_trainable(JCFG, jax.random.PRNGKey(1))
    trainable = jax.tree.map(np.asarray, trainable)
    rng = np.random.default_rng(5)
    for br in trainable["lora"]["layers"].values():  # a non-zero LoRA delta
        br["a"] = (rng.normal(size=br["a"].shape) * 0.05).astype(np.float32)
    jt = jax.tree.map(jnp.asarray, trainable)
    tf = bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")
    tt = bridge.from_jax(trainable, "cpu")
    return frozen, jt, tf, tt


KW = dict(rows=2, max_len=128, prefill_buckets=(8, 16), chunk_steps=4, greedy=True, eos_id=-1,
          audio_start_id=AUDIO_START, audio_end_id=AUDIO_END)


def _jax_engine(model, **kw):
    return JEngine(model[0], model[1], JCFG, compute_dtype=jnp.float32, **dict(KW, **kw))


def _engine(model, **kw):
    return ServingEngine(model[2], model[3], CFG, compute_dtype=torch.float32, device="cpu",
                         **dict(KW, **kw))


def _stream():
    """A seeded request stream: (prefix ids, [(kind, ids, wav or None)])."""
    rng = np.random.default_rng(0)
    ids = lambda n: rng.integers(3, CFG.llama.vocab_size, (n,)).astype(np.int32)  # noqa: E731
    wav = lambda: (rng.normal(size=(CFG.mel.max_samples,)) * 0.1).astype(np.float32)  # noqa
    prefix = ids(6)
    reqs = [("text", ids(5), None), ("text", ids(3), None), ("audio", ids(4), wav()),
            ("audio", ids(6), wav()), ("suffix", ids(3), None), ("text", ids(11), None),
            ("suffix", ids(7), None), ("auto", np.concatenate([prefix, ids(2)]), None)]
    return prefix, reqs


def _serve(eng, max_new=5):
    prefix, reqs = _stream()
    pid = eng.register_prefix(prefix)
    rids = []
    for kind, ids, wav in reqs:
        kw = dict(max_new_tokens=max_new)
        if kind == "suffix":
            kw["prefix"] = pid
        if kind == "audio":
            kw["audio_features"] = wav
        rids.append(eng.submit(ids, **kw))
    out = eng.run(max_chunks=200)
    return [list(map(int, out[r])) for r in rids], eng


_RUNS = {}


def _pair(model, kv, mode):
    """(JAX tokens, port tokens, port engine) of the stream, run once per
    module for each (cache, mode)."""
    key = (kv, mode)
    if key not in _RUNS:
        kw = dict(MODES[mode], kv_quant=kv, auto_prefix=True)
        jt, _ = _serve(_jax_engine(model, **kw))
        tt, eng = _serve(_engine(model, **kw))
        _RUNS[key] = (jt, tt, eng)
    return _RUNS[key]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kv", KVS)
def test_pool_tokens_equal_jax(model, kv, mode):
    jt, tt, eng = _pair(model, kv, mode)
    assert tt == jt
    assert all(len(t) == 5 for t in tt)
    assert eng.prefix_admits == 3  # two explicit suffixes, one auto-matched
    if mode == "batched":
        assert 2 in eng.admit_sizes


def _generate(model, ids, wav=None, n=5, kv=False):
    return t_gen.generate(model[2], model[3], CFG, ids[None], np.ones_like(ids)[None],
                          None if wav is None else wav[None], greedy=True, max_new_tokens=n,
                          eos_id=-1, compute_dtype=torch.float32, has_audio=wav is not None,
                          device="cpu", kv_quant=kv, audio_start_id=AUDIO_START,
                          audio_end_id=AUDIO_END).tokens[0].tolist()


def test_pool_tokens_equal_generate(model):
    _, tt, _ = _pair(model, False, "whole")
    prefix, reqs = _stream()
    for (kind, ids, wav), toks in zip(reqs, tt):
        full = np.concatenate([prefix, ids]) if kind == "suffix" else ids
        assert toks == _generate(model, full, wav), kind


def test_mixed_greedy_and_sampled_rows(model):
    """A sampled neighbour does not move a greedy row (rows 4: they decode
    side by side); the sampled rows give well-formed tokens."""
    prefix, reqs = _stream()
    texts = [ids for kind, ids, _ in reqs if kind == "text"]
    eng = _engine(model, rows=4, greedy=False, temperature=0.7, top_p=0.9)
    rg = [eng.submit(ids, max_new_tokens=6, greedy=True) for ids in texts]
    rs = [eng.submit(ids, max_new_tokens=6, temperature=0.9, top_p=0.8, top_k=20)
          for ids in texts[:1]]
    out = eng.run(max_chunks=50)
    for ids, r in zip(texts, rg):
        assert out[r] == _generate(model, ids, n=6)
    V = CFG.llama.vocab_size + 2
    assert all(len(out[r]) == 6 and all(0 <= t < V for t in out[r]) for r in rs)


def test_eos_retires_and_oversized_is_rejected(model):
    _, reqs = _stream()
    ids = reqs[0][1]
    first = _generate(model, ids, n=5)
    eng = _engine(model, eos_id=first[2])
    r = eng.submit(ids, max_new_tokens=5)
    big = eng.submit(np.arange(3, 40, dtype=np.int32), max_new_tokens=5)  # > every bucket
    out = eng.run(max_chunks=20)
    assert out[r] == first[:3] and out[big] == []
    jeng = JEngine(model[0], model[1], JCFG, compute_dtype=jnp.float32,
                   **dict(KW, eos_id=first[2]))
    jr = jeng.submit(ids, max_new_tokens=5)
    jbig = jeng.submit(np.arange(3, 40, dtype=np.int32), max_new_tokens=5)
    jout = jeng.run(max_chunks=20)
    assert list(map(int, jout[jr])) == out[r] and jout[jbig] == []


def test_filtered_logits_per_row_matches_jax():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(4, 97)) * 3).astype(np.float32)
    temp = np.array([0.7, 1.0, 1.3, 0.5], np.float32)
    top_p = np.array([0.9, 1.0, 0.5, 0.95], np.float32)
    top_k = np.array([0, 10, 5, 200], np.int32)
    want = j_sampling.filtered_logits_per_row(jnp.asarray(logits), jnp.asarray(temp),
                                              jnp.asarray(top_p), jnp.asarray(top_k))
    got = sampling.filtered_logits_per_row(*(torch.from_numpy(a) for a in
                                             (logits, temp, top_p, top_k)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # uniform parameters: the static filter's logits
    uni = sampling.filtered_logits_per_row(
        torch.from_numpy(logits), torch.full((4,), 0.8), torch.full((4,), 0.9),
        torch.full((4,), 12, dtype=torch.int32))
    stat = sampling.filtered_logits(torch.from_numpy(logits), 0.8, 0.9, 12)
    np.testing.assert_array_equal(uni.numpy(), stat.numpy())
    probs = sampling.filtered_probs(torch.from_numpy(logits), 0.8, 0.9, 12)
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_sampling.filtered_probs(
        jnp.asarray(logits), 0.8, 0.9, 12)), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    greedy = torch.tensor([True, False, True, False])
    tok = sampling.sample_token_per_row(torch.from_numpy(logits), g, *(torch.from_numpy(a) for a
                                        in (temp, top_p, top_k)), greedy)
    arg = logits.argmax(-1)
    assert tok[0] == arg[0] and tok[2] == arg[2]
    kept = np.asarray(want)[[1, 3], tok[[1, 3]].numpy()]
    assert (kept > -1e30).all()  # sampled rows draw kept tokens


def _filled(kv, B, Tk, seed=7):
    """Seeded cache contents for both packages -> (JAX fields, torch fields)."""
    rng = np.random.default_rng(seed)
    Lc, Hkv, hd = JCFG.llama.num_layers, JCFG.llama.num_kv_heads, JCFG.llama.head_dim
    big = [jnp.asarray(rng.normal(size=(Lc, B, Hkv, Tk, hd)).astype(np.float32))
           for _ in range(2)]
    if kv is False:
        f = dict(k=big[0], v=big[1], k_scale=None, v_scale=None)
    elif kv == 8:
        (k, ks), (v, vs) = (j_llama.quantize_kv_rows(c) for c in big)
        f = dict(k=k, v=v, k_scale=ks, v_scale=vs)
    else:
        kvp, ks, vs = j_llama.quantize_kv_rows4(*big)
        f = dict(k=kvp, v=None, k_scale=ks, v_scale=vs)
    t = {n: None if a is None else torch.from_numpy(np.array(a)) for n, a in f.items()}
    return f, t


CACHED_CASES = {  # name -> (T, scalar offset or per-row offsets, attn_impl)
    "scalar": (5, 10, "auto"),
    "scalar_clamped": (5, 62, "auto"),  # the window [59, 64) of a 64-slot timeline
    "per_row": (5, [3, 20], "auto"),
    "per_row_clamped": (5, [40, 61], "auto"),
    "per_row_t1_decode_kernel": (1, [17, 64], "decode_kernel"),  # row 1 dropped
}


@pytest.mark.parametrize("kv", KVS)
@pytest.mark.parametrize("case", list(CACHED_CASES))
def test_cached_forward_matches_jax(model, kv, case):
    T, off, impl = CACHED_CASES[case]
    B, Tk = 2, 64
    jf, tf = _filled(kv, B, Tk)
    rng = np.random.default_rng(11)
    ids = rng.integers(3, CFG.llama.vocab_size, (B, T)).astype(np.int32)
    per_row = isinstance(off, list)
    offs = np.asarray(off if per_row else [off] * B, np.int32)
    pos = np.minimum(offs, Tk - 1)[:, None] + np.arange(T)[None, :]
    mask = np.ones((B, Tk), np.int32)
    mask[1, 2:4] = 0  # padding holes
    jcache = j_llama.KVCache(length=jnp.int32(0 if per_row else off), **jf)
    jl, jc = j_llama.llama_forward(
        model[0]["llama"], JCFG.llama, input_ids=jnp.asarray(ids), attention_mask=jnp.asarray(mask),
        positions=jnp.asarray(pos), kv_cache=jcache,
        cache_offsets=jnp.asarray(offs) if per_row else None,
        lora=None, compute_dtype=jnp.float32, attn_impl=impl)
    tcache = llama.KVCache(length=torch.tensor(0 if per_row else off, dtype=torch.int32),
                           host_length=None if per_row else off, **tf)
    tl, tc = llama.llama_forward(
        model[2]["llama"], CFG.llama, input_ids=torch.from_numpy(ids),
        attention_mask=torch.from_numpy(mask), positions=torch.from_numpy(pos),
        kv_cache=tcache, cache_offsets=torch.from_numpy(offs) if per_row else None,
        compute_dtype=torch.float32, attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    written = np.zeros((B, Tk), bool)
    for b in range(B):
        if T == 1:
            if offs[b] < Tk:
                written[b, offs[b]] = True
        else:
            s = min(max(int(offs[b]), 0), Tk - T)
            written[b, s:s + T] = True
    for n in ("k", "v", "k_scale", "v_scale"):
        ja, ta = getattr(jc, n), getattr(tc, n)
        if ja is None:
            assert ta is None
            continue
        ja, ta = np.asarray(ja), ta.numpy()
        w = np.broadcast_to(written[None, :, None, :], ta.shape[:4])
        np.testing.assert_array_equal(ta[~w], ja[~w])
        if kv is False or n.endswith("scale"):
            # each package quantizes its own f32 projection: ulps apart
            np.testing.assert_allclose(ta[w], ja[w], atol=1e-4, rtol=1e-5)
        else:  # the same levels, or one apart at a rounding tie
            if kv == 4:
                ta, ja = (np.stack([p.numpy() for p in llama.unpack_kv4(torch.from_numpy(np.array(a)))])
                          for a in (ta, ja))
                w = np.broadcast_to(w, ta.shape[:5])
            diff = np.abs(ta[w].astype(np.int32) - ja[w].astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.02


class _HostReads:
    """Counts the tensor -> host reads made inside a block."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__int__", "__bool__", "__float__")

    def __init__(self, monkeypatch):
        self.n = 0
        self.by_name = {}
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, _name=name, **k):
                self.n += 1
                self.by_name[_name] = self.by_name.get(_name, 0) + 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)


def test_decode_chunk_reads_nothing_back(model, monkeypatch):
    eng = _engine(model, kv_quant=4, chunk_steps=6)
    _, reqs = _stream()
    for kind, ids, wav in reqs[:3]:
        if kind != "suffix":
            eng.submit(ids, audio_features=wav, max_new_tokens=4)
    eng._admit_pending()
    reads = _HostReads(monkeypatch)
    emit, fire = eng._decode_chunk()
    assert reads.n == 0, f"{reads.n} host reads inside the chunk"
    eng._harvest(emit, fire)
    # the harvest's one copy of the chunk's tokens and flags (then its numpy view)
    assert reads.by_name == {"cpu": 1, "numpy": 1}


@pytest.mark.parametrize("kv", KVS)
def test_splice_writes_only_its_row(model, kv):
    eng = _engine(model, kv_quant=kv)
    before = {n: t.clone() for n, t in eng._state["cache"]._asdict().items()
              if isinstance(t, torch.Tensor) and t.dim() >= 4}
    _, reqs = _stream()
    eng.submit(reqs[0][1], max_new_tokens=3)
    eng._admit_pending()
    row = next(r for r, x in enumerate(eng._rows) if not x.free)
    for n, b in before.items():
        after = getattr(eng._state["cache"], n)
        others = [r for r in range(eng.rows) if r != row]
        assert torch.equal(after[:, others], b[:, others]), n
        assert not torch.equal(after[:, row], b[:, row]), n
    assert int(eng._state["offsets"][row]) == len(reqs[0][1])
    assert bool(eng._state["active"][row]) and int(eng._state["remaining"][row]) == 2


def test_reset_and_unported_arms(model):
    eng = _engine(model)
    pid = eng.register_prefix(np.arange(3, 9, dtype=np.int32))
    eng.submit(np.arange(3, 8, dtype=np.int32), max_new_tokens=3)
    eng.step_chunk()
    eng.reset(seed=1)
    assert all(r.free for r in eng._rows) and not eng._queue and pid in eng._prefixes
    assert not bool(eng._state["active"].any())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        _engine(model, draft_params=model[2]["llama"])

    @dataclasses.dataclass
    class Mesh:
        shape: dict

    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        _engine(model, mesh=Mesh({"dp": 2, "tp": 1}))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        _engine(model, mesh=Mesh({"dp": 1, "tp": 2}))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        eng._decode_chunk_spec()
    with pytest.raises(RuntimeError, match="CUDA"):
        if torch.cuda.is_available():
            raise RuntimeError("CUDA present: the default device is the card")
        ServingEngine(model[2], model[3], CFG)
