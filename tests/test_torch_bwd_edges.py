"""The causal attention backward at the edges of its wgmma kernels' tiles, on
the CPU against the JAX package, and the planted-fault references that the
card tests hold those kernels to.

The backward kernels (`csrc/causal_attention_bwd.cu`) own 128 queries (dq)
or 128 keys (dk/dv) a block and step through 64 rows a ring stage; the card
tests (tests/test_torch_cuda.py) run them at T 128, 384 and 2048, G = Hq /
Hkv of 1, 3 and 6, hd 16 to 128 and tails padded inside a step, against
`causal_attention_bwd_plain`. Here that plain backward meets the JAX
package's `_dq_call` / `_dkv_call` (interpret mode) at those geometries, in
both modes, fed the same f32 inputs, residuals and D (numpy from a seed),
within 5e-5, the f32 bar of tests/test_torch_train.py. And
`chip_smoke.bwd_fault_reference` (the faulty functions of the card tests)
gives the plain backward when no fault is planted (1e-5: the same f32
products, dk/dv summed over the group in another order), while each planted
fault moves every output it names past the kernels' bar (bf16, as on the
card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.ops import causal_attention as j_ca  # noqa: E402
from audio_llama_tpu_torch.ops import causal_attention as ca  # noqa: E402
from chip_smoke import (ATOL_ROW_RMS_FRAC, BWD_FAULTS, GRAD_RMS_DIMS,  # noqa: E402
                        bwd_fault_reference, tol_ratio)
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

OUTS = ("dq", "dk", "dv")
BARS = ("causal_attention_dq", "causal_attention_dkv", "causal_attention_dkv")


def _case(B, T, Hq, Hkv, hd, pad, dtype=torch.float32, seed=0, tri="always"):
    """qs (pre-scaled), k, v, dO and a key bias with the last row's `pad`
    tail keys padded, from numpy; o, l, m from the plain forward in mode
    `tri` (for 'never', the statistics of rows that see every key)."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)

    qs = randn(B, T, Hq, hd) * torch.tensor(hd ** -0.5, dtype=dtype)
    k, v, do = randn(B, T, Hkv, hd), randn(B, T, Hkv, hd), randn(B, T, Hq, hd)
    mask = np.ones((B, T), np.int32)
    if pad:
        mask[-1, T - pad:] = 0
    key_bias = torch.where(torch.from_numpy(mask) != 0, 0.0, ca.NEG)
    o, l, m = ca.causal_attention_plain(qs, k, v, key_bias, tri=tri)
    return qs, k, v, key_bias, o, l, m, do


def _heads(x):  # [B, T, H, hd] -> [B*H, T, hd]
    B, T, H, hd = x.shape
    return jnp.asarray(x.numpy().transpose(0, 2, 1, 3).reshape(B * H, T, hd))


def _rows(x):  # [B*H, T] -> [B*H, 1, T]
    return jnp.asarray(x.numpy())[:, None, :]


@pytest.mark.parametrize("B,T,Hq,Hkv,hd,pad,tri", [
    (1, 384, 6, 1, 128, 40, "always"), (2, 384, 9, 3, 64, 20, "always"),
    (1, 128, 6, 1, 16, 0, "always"), (2, 128, 3, 3, 32, 5, "never"),
    (1, 384, 6, 2, 64, 40, "never")])
def test_bwd_plain_matches_the_jax_kernels_at_the_tile_edges(B, T, Hq, Hkv, hd, pad, tri):
    qs, k, v, key_bias, o, l, m, do = _case(B, T, Hq, Hkv, hd, pad, tri=tri)
    got = ca.causal_attention_bwd_plain(qs, k, v, key_bias, o, l, m, do, tri=tri)
    d = ca.attention_bwd_prologue(o, do)
    args = (_heads(qs), _heads(k), _heads(v), jnp.asarray(key_bias.numpy())[:, None, :],
            _rows(m), _heads(do), _rows(l), _rows(d), Hq, Hkv)
    kw = dict(bq=128, ck=128, interpret=True, tri=tri)
    want = (j_ca._dq_call(*args, **kw), *j_ca._dkv_call(*args, **kw))
    for name, g, w in zip(OUTS, got, want):
        w = np.asarray(w).reshape(B, -1, T, hd).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=5e-5, rtol=5e-5, err_msg=name)


def test_fault_reference_without_a_fault_is_the_plain_backward():
    case = _case(2, 384, 6, 2, 64, 20)
    qs, k, v, key_bias, o, l, m, do = case
    got = bwd_fault_reference(qs, k, v, key_bias, l, m, do, ca.attention_bwd_prologue(o, do))
    for name, g, w in zip(OUTS, got, ca.causal_attention_bwd_plain(*case)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("fault", list(BWD_FAULTS))
def test_each_planted_fault_moves_its_outputs_past_the_bar(fault):
    case = _case(2, 384, 6, 2, 64, 20, dtype=torch.bfloat16, seed=1)
    qs, k, v, key_bias, o, l, m, do = case
    d = ca.attention_bwd_prologue(o, do)
    want = ca.causal_attention_bwd_plain(*case)
    clean = bwd_fault_reference(qs, k, v, key_bias, l, m, do, d)
    faulty = bwd_fault_reference(qs, k, v, key_bias, l, m, do, d, fault)

    def ratio(got, i):
        return tol_ratio(got[i], want[i], ATOL_ROW_RMS_FRAC[BARS[i]], GRAD_RMS_DIMS)

    for i in range(3):
        assert ratio(clean, i) <= 1, OUTS[i]
    for out in BWD_FAULTS[fault]:
        assert ratio(faulty, OUTS.index(out)) > 1, (fault, out)
