"""The JAX package's last three Pallas kernels against the port's plain
versions, on CPU.

- `decode_attention` / `decode_attention_quantized` (single-buffered decode
  attention on a bf16/f32 or int8 cache, softmax normalized before PV)
  against JAX's with interpret=True: L 3, B 2, S 64, three head
  geometries; offsets 0, mid-timeline, S - 1 and past the timeline (no row
  written, the slab attended as it is); padding holes and a fully masked
  row. Bars: f32 outputs within 1e-5, bf16 within 2e-2 absolute and
  relative (a one-ulp f32 logit flip can move a bf16 rounding of p); the
  caches bit-equal, only the offset's slot of the layer changed; the int8
  variant leaves its scale arrays untouched. `max_len % 32 != 0` raises
  ValueError in both packages.
- `int4_matmul` (unstacked W4A16) against JAX's with interpret=True, both
  pack formats, leading dims and a decode-sized M: within 1e-5 of the
  output's largest magnitude (the same f32 group sums in another order;
  tests/test_torch_int4.py's bar).
- `models/llama.py::_linear`'s int4 `w_p` branch against JAX's `_linear` on
  the same bridged weights, both formats (JAX reads the format from
  INT4_FMT, the port from `fmt`), with LoRA, with a `w_r` smoothing vector
  (the frozen product's input only), a [K, 1, N/2] pack-after-shard block
  squeezed, and group 64 read from the shapes: within the same bar; a
  [K, 2, N/4] block raises ValueError in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.ops import decode_attention as j_da  # noqa: E402
from audio_llama_tpu.ops import int4_matmul as j_i4  # noqa: E402
from audio_llama_tpu_torch.models import llama  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention as da  # noqa: E402
from audio_llama_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

L, B, S = 3, 2, 64
LAYER = 1
GEOMS = [(4, 2, 16), (8, 8, 32), (6, 2, 128)]  # (Hq, Hkv, hd), as tests/test_decode_attention.py
OFFSETS = [0, 10, S - 1, S, S + 5]  # S and past: no row written


def _t(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x):
    """A JAX array or a torch tensor -> numpy (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _valid(off, masked_row=False):
    valid = (np.arange(S)[None, :] <= off).astype(np.int32).repeat(B, 0)
    valid[1, 3:5] = 0  # padding holes
    if masked_row:
        valid[0] = 0  # every slot masked: the softmax spreads evenly
    return valid


def _check_caches(got, want, before, off):
    for g, w, b in zip(got, want, before):
        np.testing.assert_array_equal(_np(g), _np(w))
        changed = np.any(_np(g) != _np(b), axis=-1)
        if off < S:
            changed[LAYER, :, :, off] = False
        assert not changed.any(), "a slot other than the offset's changed"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("off", OFFSETS)
def test_decode_attention_plain_matches_the_pallas_kernel(dtype, geom, off):
    Hq, Hkv, hd = geom
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    rng = np.random.default_rng(off * 7 + hd)
    q, kn, vn = (jnp.asarray(rng.normal(size=s).astype(np.float32), jdt)
                 for s in ((B, Hq, hd), (B, Hkv, hd), (B, Hkv, hd)))
    ck, cv = (jnp.asarray(rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32), jdt)
              for _ in range(2))
    valid = _valid(min(off, S - 1), masked_row=off == 10)
    scale = hd ** -0.5
    jo, jck, jcv = j_da.decode_attention(q, kn, vn, ck, cv, jnp.int32(LAYER), jnp.int32(off),
                                         jnp.asarray(valid), scale, interpret=True)
    tck, tcv = _t(ck), _t(cv)
    to, rck, rcv = da.decode_attention(_t(q), _t(kn), _t(vn), tck, tcv, LAYER, off,
                                       torch.from_numpy(valid), scale)
    assert rck is tck and rcv is tcv  # in place
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(to.float().numpy(), _np(jo), atol=tol, rtol=tol)
    _check_caches((rck, rcv), (jck, jcv), (ck, cv), off)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("off", OFFSETS)
def test_decode_attention_quantized_plain_matches_the_pallas_kernel(dtype, geom, off):
    Hq, Hkv, hd = geom
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    rng = np.random.default_rng(off * 11 + hd)
    q = jnp.asarray(rng.normal(size=(B, Hq, hd)).astype(np.float32), jdt)
    (ck, ks), (cv, vs) = (j_llama.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(L, B, Hkv, S, hd)).astype(np.float32))) for _ in range(2))
    (kn, ksn), (vn, vsn) = (j_llama.quantize_kv_rows(
        jnp.asarray(rng.normal(size=(B, Hkv, hd)).astype(np.float32))) for _ in range(2))
    valid = _valid(min(off, S - 1), masked_row=off == 10)
    scale = hd ** -0.5
    jo, jck, jcv = j_da.decode_attention_quantized(
        q, kn, vn, ck, cv, ks[LAYER], vs[LAYER], ksn, vsn, jnp.int32(LAYER), jnp.int32(off),
        jnp.asarray(valid), scale, interpret=True)
    tck, tcv, tks, tvs = _t(ck), _t(cv), _t(ks[LAYER]), _t(vs[LAYER])
    ks0, vs0 = tks.clone(), tvs.clone()
    to, rck, rcv = da.decode_attention_quantized(
        _t(q), _t(kn), _t(vn), tck, tcv, tks, tvs, _t(ksn), _t(vsn), LAYER, off,
        torch.from_numpy(valid), scale)
    assert rck is tck and rcv is tcv
    assert torch.equal(tks, ks0) and torch.equal(tvs, vs0), "the scale arrays were written"
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(to.float().numpy(), _np(jo), atol=tol, rtol=tol)
    _check_caches((rck, rcv), (jck, jcv), (ck, cv), off)


def test_decode_attention_refuses_an_unrounded_timeline():
    Hq, Hkv, hd, S_bad = 4, 2, 16, 40
    q = np.zeros((1, Hq, hd), np.float32)
    row = np.zeros((1, Hkv, hd), np.float32)
    cache = np.zeros((1, 1, Hkv, S_bad, hd), np.float32)
    valid = np.ones((1, S_bad), np.int32)
    with pytest.raises(ValueError, match="max_len % 32"):
        j_da.decode_attention(jnp.asarray(q), jnp.asarray(row), jnp.asarray(row),
                              jnp.asarray(cache), jnp.asarray(cache), 0, 0, jnp.asarray(valid),
                              1.0, interpret=True)
    with pytest.raises(ValueError, match="max_len % 32"):
        da.decode_attention(*(torch.from_numpy(a) for a in (q, row, row, cache, cache.copy())),
                            0, 0, torch.from_numpy(valid), 1.0)
    qc = np.zeros((1, 1, Hkv, S_bad, hd), np.int8)
    sc = np.ones((1, Hkv, S_bad), np.float32)
    sn = np.ones((1, Hkv), np.float32)
    with pytest.raises(ValueError, match="max_len % 32"):
        j_da.decode_attention_quantized(
            jnp.asarray(q), jnp.asarray(row, jnp.int8), jnp.asarray(row, jnp.int8),
            jnp.asarray(qc), jnp.asarray(qc), jnp.asarray(sc), jnp.asarray(sc), jnp.asarray(sn),
            jnp.asarray(sn), 0, 0, jnp.asarray(valid), 1.0, interpret=True)
    with pytest.raises(ValueError, match="max_len % 32"):
        da.decode_attention_quantized(
            torch.from_numpy(q), torch.zeros((1, Hkv, hd), dtype=torch.int8),
            torch.zeros((1, Hkv, hd), dtype=torch.int8), torch.from_numpy(qc),
            torch.from_numpy(qc.copy()), torch.from_numpy(sc), torch.from_numpy(sc.copy()),
            torch.from_numpy(sn), torch.from_numpy(sn.copy()), 0, 0, torch.from_numpy(valid),
            1.0)


def _rel(got, want):
    """max |got - want| over max |want| (tests/test_torch_int4.py's bar)."""
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("lead,K,N", [((3,), 256, 256), ((2, 5), 384, 512), ((20,), 128, 1024)])
def test_int4_matmul_plain_matches_the_pallas_kernel(fmt, lead, K, N):
    rng = np.random.default_rng(K + N)
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05)
    packed, scales = j_i4.quantize_pack(w, fmt=fmt)
    x = jnp.asarray(rng.normal(size=lead + (K,)).astype(np.float32))
    want = j_i4.int4_matmul(x, packed, scales, interpret=True, fmt=fmt)
    got = i4.int4_matmul(_t(x), _t(packed), _t(scales), fmt=fmt)
    assert tuple(got.shape) == lead + (N,) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5
    # the port's own packing of the same weight is the same bytes
    tp, ts = i4.quantize_pack(_t(w), fmt=fmt)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(packed))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(scales))


def _lora(rng, K, N, r=4):
    a = rng.normal(size=(K, r)).astype(np.float32) * 0.1
    b = rng.normal(size=(r, N)).astype(np.float32) * 0.1
    return a, b, 2.0


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("case", ["plain", "lora", "smoothed", "block_axis", "group64"])
def test_linear_int4_branch_matches_jax(fmt, case, monkeypatch):
    K, N = 256, 384
    group = 64 if case == "group64" else 128
    rng = np.random.default_rng(len(case))
    w = jnp.asarray(rng.normal(size=(K, N)).astype(np.float32) * 0.05)
    packed, scales = j_i4.quantize_pack(w, group=group, fmt=fmt)
    jw = {"w_p": packed, "w_s": scales}
    if case == "block_axis":  # pack-after-shard [K, tp=1, N/2]
        jw["w_p"] = packed[:, None, :]
    if case == "smoothed":
        jw["w_r"] = jnp.asarray(rng.uniform(0.5, 2.0, size=(K,)).astype(np.float32))
    x = rng.normal(size=(2, 3, K)).astype(np.float32)
    lora = _lora(rng, K, N) if case in ("lora", "smoothed") else None
    monkeypatch.setattr(j_i4, "INT4_FMT", fmt)  # JAX's _linear reads the format from it
    want = j_llama._linear(jnp.asarray(x), jw, None if lora is None else
                           (jnp.asarray(lora[0]), jnp.asarray(lora[1]), lora[2]), jnp.float32)
    tw = {k: _t(v) for k, v in jw.items()}
    got = llama._linear(torch.from_numpy(x), tw, None if lora is None else
                        (torch.from_numpy(lora[0]), torch.from_numpy(lora[1]), lora[2]),
                        torch.float32, fmt=fmt)
    assert _rel(got.numpy(), want) < 1e-5


def test_linear_int4_refuses_tp_blocks():
    K, N = 256, 256
    w = jnp.asarray(np.random.default_rng(0).normal(size=(K, N)).astype(np.float32))
    packed, scales = j_i4.quantize_pack(w)
    blocks = packed.reshape(K, 2, N // 4)  # packed for tp = 2
    x = np.ones((1, K), np.float32)
    with pytest.raises(ValueError, match="tp=2"):
        j_llama._linear(jnp.asarray(x), {"w_p": blocks, "w_s": scales}, None, jnp.float32)
    with pytest.raises(ValueError, match="tp=2"):
        llama._linear(torch.from_numpy(x), {"w_p": _t(blocks), "w_s": _t(scales)}, None,
                      torch.float32)


def test_int4_matmul_cuda_refuses_cpu_tensors():
    x = torch.zeros((1, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        i4.int4_matmul_cuda(x, torch.zeros((128, 128), dtype=torch.int8),
                            torch.zeros((1, 256)))
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(torch.zeros((1, 2, 16)), torch.zeros((1, 1, 16)),
                                 torch.zeros((1, 1, 16)), torch.zeros((1, 1, 1, 32, 16)),
                                 torch.zeros((1, 1, 1, 32, 16)), 0, 0,
                                 torch.ones((1, 32), dtype=torch.int32), 1.0)
