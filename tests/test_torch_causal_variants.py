"""The port's causal forward variants (`causal_mha(fwd_impl=...,
softmax_mode=...)`) against the JAX package's Pallas kernels in interpret
mode: `_fwd_call` (tri 'always' / 'cond', softmax 'online' / 'bounded' /
'twopass') and `_fwd_call_dma` (dma, dma2).

Toy dims as tests/test_causal_attention.py: B 2, T 256, Hq 4, Hkv 2, hd 32,
row 0's keys padded from 200, inputs made with numpy from a seed and handed
to both packages. On the CPU the port runs each variant's plain version.
Bars:
  o, l, c: o within 2e-5 on the valid rows (tests/test_causal_attention.py:
      36-39), l and c within 1e-5 relative, at f32 (the same f32 products
      summed in another order);
  gradients: against jax.grad through the same JAX variant, 5e-4 (twopass
      5e-3), JAX's own bars; dq on the valid rows (padded query rows are
      garbage in both packages);
  outliers (tests/test_causal_attention.py:146-163, its shapes): bounded,
      dma and dma2 lose rows to exp underflow in both packages (more than 0.1
      from XLA's `mha`, the same rows zeroed); twopass and cond within 2e-4.
The port's kernels keep their own tiles (64 x 64; the wgmma twopass and dma2
kernels 128 x 128 and 128 x 64), so block_q / chunk_k change nothing in the
port (checked here) and JAX's results at 128 or 256 agree with the port's
within the bars.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.ops import causal_attention as j_ca  # noqa: E402
from audio_llama_tpu.ops.attention import causal_bias, mha  # noqa: E402
from audio_llama_tpu_torch.ops import causal_attention as ca  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

B, T, HQ, HKV, HD, PAD_FROM = 2, 256, 4, 2, 32, 200
VARIANTS = [(f, s) for f in ("blocks", "blocks_cond", "dma", "dma2")
            for s in ("online", "twopass", "bounded")]


def _case(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, T, h, HD)).astype(np.float32) * 0.5
               for h in (HQ, HKV, HKV))
    mask = np.ones((B, T), np.int32)
    mask[0, PAD_FROM:] = 0
    w = rng.normal(size=(B, T, HQ, HD)).astype(np.float32)
    return q, k, v, mask, w


def _jax_fwd(q, k, v, mask, fwd_impl, softmax, bq=128, ck=128):
    """o [B, T, Hq, hd], l and c [B*Hq, T] of JAX's kernel for the variant,
    with the inputs `_causal_mha_local` would hand it (T is a multiple of
    128 here, so nothing is padded)."""
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    qs = jnp.swapaxes(qj * jnp.asarray(HD ** -0.5, qj.dtype), 1, 2).reshape(B * HQ, T, HD)
    kh = jnp.swapaxes(kj, 1, 2).reshape(B * HKV, T, HD)
    vh = jnp.swapaxes(vj, 1, 2).reshape(B * HKV, T, HD)
    mb = jnp.where(jnp.asarray(mask).astype(bool), 0.0, j_ca.NEG).astype(jnp.float32)[:, None]
    kn = jnp.sqrt(jnp.max(jnp.sum(kh.astype(jnp.float32) ** 2, axis=-1), axis=-1)).reshape(
        B * HKV, 1, 1)
    o, l, c = j_ca._fwd_dispatch(fwd_impl, softmax)(qs, kh, vh, mb, kn, HQ, HKV, bq=bq, ck=ck,
                                                     interpret=True)
    o = np.asarray(o).reshape(B, HQ, T, HD).transpose(0, 2, 1, 3)
    return o, np.asarray(l)[:, 0], np.asarray(c)[:, 0]


def _port_fwd(q, k, v, mask, fwd_impl, softmax, **kw):
    out = ca.causal_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(mask), fwd_impl=fwd_impl,
                                  softmax_mode=softmax, **kw)
    return out.o.numpy(), out.l.numpy(), out.m.numpy()


@pytest.mark.parametrize("fwd_impl,softmax", VARIANTS)
def test_forward_matches_the_pallas_kernel(fwd_impl, softmax):
    q, k, v, mask, _ = _case()
    want = _jax_fwd(q, k, v, mask, fwd_impl, softmax)
    got = _port_fwd(q, k, v, mask, fwd_impl, softmax)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got[0][valid], want[0][valid], atol=2e-5, rtol=2e-5)
    for g, w, name in zip(got[1:], want[1:], "lc"):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=0, err_msg=name)


@pytest.mark.parametrize("fwd_impl,softmax,tol", [
    ("blocks_cond", "online", 5e-4), ("blocks", "twopass", 5e-3),
    ("blocks_cond", "twopass", 5e-3), ("blocks", "bounded", 5e-4),
    ("blocks_cond", "bounded", 5e-4), ("dma", "bounded", 5e-4), ("dma2", "online", 5e-4)])
def test_gradients_match_jax(fwd_impl, softmax, tol):
    q, k, v, mask, w = _case(seed=1)

    def loss(q_, k_, v_):
        o = j_ca.causal_mha(q_, k_, v_, mask=jnp.asarray(mask), interpret=True, block_q=128,
                            chunk_k=128, fwd_impl=fwd_impl, softmax_mode=softmax)
        return jnp.sum(o * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = ca.causal_mha(*ts, mask=torch.from_numpy(mask), fwd_impl=fwd_impl, softmax_mode=softmax)
    got = torch.autograd.grad(o, ts, torch.from_numpy(w))
    valid = mask.astype(bool)
    for g, wnt, name in zip(got, want, "qkv"):
        g, wnt = g.numpy(), np.asarray(wnt)
        if name == "q":
            g, wnt = g[valid], wnt[valid]
        np.testing.assert_allclose(g, wnt, atol=tol, rtol=tol, err_msg=name)


def _outlier_case(seed=7, Tn=256, Hq=2, Hkv=1, hd=128):
    """tests/test_causal_attention.py::_outlier_setup with numpy's generator:
    q, k ~ 2 N(0, 1), key 0 of every batch and head a unit direction times
    1500, v ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, Tn, Hq, hd)).astype(np.float32) * 2.0
    k = rng.normal(size=(1, Tn, Hkv, hd)).astype(np.float32) * 2.0
    d = rng.normal(size=(hd,)).astype(np.float32)
    k[:, 0] = d / np.linalg.norm(d) * 1500.0
    v = rng.normal(size=(1, Tn, Hkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("fwd_impl,softmax,safe", [
    ("blocks", "bounded", False), ("dma", "bounded", False), ("dma2", "bounded", False),
    ("blocks", "twopass", True), ("blocks_cond", "online", True)])
def test_outlier_magnitudes(fwd_impl, softmax, safe):
    q, k, v = _outlier_case()
    Tn = q.shape[1]
    ref = np.asarray(mha(*(jnp.asarray(x) for x in (q, k, v)), bias=causal_bias(Tn, Tn)))
    jax_out = np.asarray(j_ca.causal_mha(*(jnp.asarray(x) for x in (q, k, v)), interpret=True,
                                         block_q=128, chunk_k=128, fwd_impl=fwd_impl,
                                         softmax_mode=softmax))
    got = ca.causal_mha(*(torch.from_numpy(x) for x in (q, k, v)), fwd_impl=fwd_impl,
                        softmax_mode=softmax).numpy()
    assert np.isfinite(got).all()
    if safe:
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    else:  # the bounded family's kept failure, reproduced rather than hidden
        assert np.abs(jax_out - ref).max() > 0.1 and np.abs(got - ref).max() > 0.1
        np.testing.assert_array_equal((got == 0).all(axis=-1), (jax_out == 0).all(axis=-1))


def test_dma_variants_take_the_bounded_softmax_whatever_is_asked():
    """causal_attention.py:871-872: fwd_impl 'dma' / 'dma2' run the bounded
    mode for any softmax_mode; the shift residual m is then the bound c."""
    q, k, v, mask, _ = _case(seed=2)
    bounded = _port_fwd(q, k, v, mask, "blocks", "bounded")
    online = _port_fwd(q, k, v, mask, "blocks", "online")
    for impl in ("dma", "dma2"):
        for softmax in ("online", "twopass", "bounded"):
            got = _port_fwd(q, k, v, mask, impl, softmax)
            for g, w in zip(got, bounded):
                np.testing.assert_array_equal(g, w)
    assert not np.allclose(bounded[2], online[2])  # c is the bound, not the row max


def test_block_sizes_are_checked_and_change_nothing():
    q, k, v, mask, _ = _case(seed=3)
    base = _port_fwd(q, k, v, mask, "blocks", "online")
    for bq, ck in ((128, 256), (256, 128), (256, 256)):
        got = _port_fwd(q, k, v, mask, "blocks", "online", block_q=bq, chunk_k=ck)
        for g, w in zip(got, base):
            np.testing.assert_array_equal(g, w)
        want = _jax_fwd(q, k, v, mask, "blocks", "online", bq=bq, ck=ck)
        valid = mask.astype(bool)
        np.testing.assert_allclose(got[0][valid], want[0][valid], atol=2e-5, rtol=2e-5)
    for kw in (dict(block_q=96), dict(chunk_k=100), dict(block_q=-128), dict(chunk_k=512)):
        with pytest.raises(ValueError):
            _port_fwd(q, k, v, mask, "blocks", "online", **kw)
    with pytest.raises(ValueError):
        _port_fwd(q, k, v, mask, "flash", "online")
    with pytest.raises(ValueError):
        _port_fwd(q, k, v, mask, "blocks", "exact")


def test_kn_is_per_kv_head_over_every_key():
    """kn [B, Hkv]: each (batch, KV head)'s largest key norm over all T keys,
    padded and future keys included, as JAX's wrapper computes it
    (causal_attention.py:867-869)."""
    _, k, _, _, _ = _case(seed=4)
    k = k.copy()
    k[0, 250, 1] *= 4  # a padded key (row 0 from 200) of KV head 1
    got = ca.key_norm_max(torch.from_numpy(k)).numpy()
    kh = jnp.swapaxes(jnp.asarray(k), 1, 2).reshape(B * HKV, T, HD)
    want = np.asarray(jnp.sqrt(jnp.max(jnp.sum(kh ** 2, axis=-1), axis=-1))).reshape(B, HKV)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 1] > 2 * got[0, 0]


def test_tma_bias_hands_the_kernels_an_aligned_f32_row():
    """The twopass and dma2 wrappers hand TMA the key bias f32, contiguous and
    on a 16-byte boundary: a view that starts 4 bytes into its storage is
    copied, an aligned f32 row passes as it is, a bf16 one is cast."""
    buf = torch.arange(2 * T + 1, dtype=torch.float32)
    view = buf[1:].view(2, T)
    assert view.data_ptr() % 16 == 4
    out = ca._tma_bias(view)
    assert out.data_ptr() % 16 == 0 and out.is_contiguous() and torch.equal(out, view)
    aligned = torch.zeros(2, T)
    assert ca._tma_bias(aligned) is aligned
    cast = ca._tma_bias(torch.full((2, T), -2.0, dtype=torch.bfloat16))
    assert cast.dtype == torch.float32 and cast.data_ptr() % 16 == 0
    assert torch.equal(cast, torch.full((2, T), -2.0))
