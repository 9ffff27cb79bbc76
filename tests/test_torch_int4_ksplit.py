"""The port's contraction-split W4A16 (`int4_matmul_stacked(block_k=...)` and
the `INT4_BK` default) against the JAX package's `_kernel_stacked_ksplit` in
interpret mode.

Toy dims as tests/test_int4_matmul.py:123-160: L 2, K 512, N 512 (four
scale groups), block_k 256 (two K blocks), both pack formats, M 4 and 72
(the kernel's two launch shapes on the card). Bars, as
tests/test_torch_int4.py's: f32 x to 1e-5 of the output's scale (the same
f32 block sums in another order inside a group); bf16 x to one bf16 rounding
of the output (2^-7 relative plus 1e-2 of its scale). The geometry fallbacks
and the default are exact: the same plain arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.ops import int4_matmul as j_i4  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.ops import int4_matmul as i4  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

L, K, N, BK = 2, 512, 512, 256


def _t(x):
    return bridge.to_tensor(np.asarray(x), torch.device("cpu"))


def _case(fmt, M, dtype, seed=5):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(L, K, N)).astype(np.float32)
    packed, scales = zip(*(j_i4.quantize_pack(jnp.asarray(w[i]), fmt=fmt) for i in range(L)))
    jp, js = jnp.stack(packed), jnp.stack(scales)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    xj = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(jdt)
    return xj, jp, js, _t(xj), _t(jp), _t(js)


def _assert_bar(got, want, dtype):
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=1e-2 * scale)


@pytest.mark.parametrize("fmt", ["pair", "obin"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M", [4, 72])
def test_ksplit_plain_matches_the_pallas_kernel(fmt, dtype, M):
    xj, jp, js, xt, tp, ts = _case(fmt, M, dtype)
    for planes in (False, True):
        want = j_i4.int4_matmul_stacked(xj, jp, js, jnp.int32(1), interpret=True, block_k=BK,
                                        return_planes=planes, fmt=fmt)
        got = i4.int4_matmul_stacked_ksplit_plain(xt, tp, ts, 1, BK, return_planes=planes,
                                                  fmt=fmt)
        for g, w in zip(got if planes else [got], want if planes else [want]):
            assert tuple(g.shape) == w.shape and g.dtype == xt.dtype
            _assert_bar(g, w, dtype)
        # the dispatcher runs the same plain arithmetic on CPU tensors
        via = i4.int4_matmul_stacked(xt, tp, ts, 1, return_planes=planes, fmt=fmt, block_k=BK)
        for a, b in zip(via if planes else [via], got if planes else [got]):
            assert torch.equal(a, b)


def test_ksplit_sums_blocks_in_order():
    """The K-split's f32 order (a fresh sum per block, blocks added in order)
    differs from the whole-K sum, so the two are computed apart: within f32
    rounding of each other, not always the same bits."""
    xj, jp, js, xt, tp, ts = _case("pair", 72, "f32", seed=9)
    split = i4.int4_matmul_stacked_ksplit_plain(xt, tp, ts, 0, BK)
    whole = i4.int4_matmul_stacked_plain(xt, tp, ts, 0)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=0,
                               atol=1e-5 * whole.abs().max().item())
    # by hand: block 0's groups, then block 1's, each from zero
    lo, hi = i4._unpack_planes(tp[0], "pair")
    s = ts[0]
    blocks = []
    for b0 in (0, 2):
        acc = torch.zeros((72, N // 2))
        for g in (b0, b0 + 1):
            rows = slice(g * 128, (g + 1) * 128)
            acc = acc + (xt[:, rows] @ lo[rows].float()) * s[g, :N // 2]
        blocks.append(acc)
    assert torch.equal(split[:, :N // 2], torch.zeros_like(blocks[0]) + blocks[0] + blocks[1])


@pytest.mark.parametrize("bad", [384, 192, 100])
@pytest.mark.parametrize("M", [4, 72])
def test_geometry_fallback_is_the_whole_k_grid(bad, M):
    """A block_k that does not divide K (384) or is not a multiple of the
    group (192, 100) falls back to the whole K, as JAX's (int4_matmul.py:
    460-462): bit-equal to the whole-K plain version, and to JAX's within the
    bar."""
    xj, jp, js, xt, tp, ts = _case("obin", M, "f32")
    assert i4.ksplit_block(K, bad) == 0
    got = i4.int4_matmul_stacked(xt, tp, ts, 1, fmt="obin", block_k=bad)
    assert torch.equal(got, i4.int4_matmul_stacked_plain(xt, tp, ts, 1, fmt="obin"))
    want = j_i4.int4_matmul_stacked(xj, jp, js, jnp.int32(1), interpret=True, block_k=bad,
                                    fmt="obin")
    _assert_bar(got, want, "f32")


def test_int4_bk_is_the_default(monkeypatch):
    """INT4_BK (read from the environment at import) is the block when the
    caller gives none; an explicit block_k wins; 0 keeps the whole K."""
    xj, jp, js, xt, tp, ts = _case("pair", 4, "bf16")
    split = i4.int4_matmul_stacked_ksplit_plain(xt, tp, ts, 1, BK)
    whole = i4.int4_matmul_stacked_plain(xt, tp, ts, 1)
    monkeypatch.setattr(i4, "INT4_BK", BK)
    assert i4.ksplit_block(K, 0) == BK
    assert torch.equal(i4.int4_matmul_stacked(xt, tp, ts, 1), split)
    assert torch.equal(i4.int4_matmul_stacked(xt, tp, ts, 1, block_k=K),
                       i4.int4_matmul_stacked_ksplit_plain(xt, tp, ts, 1, K))
    monkeypatch.setattr(i4, "INT4_BK", 0)
    assert torch.equal(i4.int4_matmul_stacked(xt, tp, ts, 1), whole)


def test_ksplit_plain_refuses_a_block_that_does_not_split_k():
    _, _, _, xt, tp, ts = _case("pair", 4, "f32")
    for bad in (0, 384, 192):
        with pytest.raises(ValueError):
            i4.int4_matmul_stacked_ksplit_plain(xt, tp, ts, 1, bad)
