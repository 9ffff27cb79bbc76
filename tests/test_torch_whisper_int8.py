"""The port's W8A8 int8 encoder (models/whisper_int8.py) against the JAX
package's, at f32 on `WhisperConfig.tiny()`.

Bars:
- `quantize_encoder` naive: bit-identical (the same symmetric per-column
  rounding in f32). Smoothed, fold True and False, fed the same activation
  statistics: the f32 scales (w_s, a_s, the folded LayerNorm leaves and
  v_proj) within SCALE_ULPS f32 ulps and at most W_Q_FLIPS of the int8
  weights one level apart, because `a ** 0.5` is torch's correctly rounded
  sqrt, XLA's pow on the CPU differs from it by an ulp now and then, and the
  median division and the folds carry that on (3 ulps at most measured on
  this tree, no int8 weight apart).
- `calibrate_encoder`: within 1e-6 relative to each statistic's scale.
- `_int8_linear`: bit-identical to JAX's compiled one without a bias (the
  same int8 activations, exact int32 sums, the same f32 rescale), within
  one f32 ulp with one (XLA on the CPU may contract the bias add into an
  FMA).
- `encode_int8` against JAX's `attn_impl='enc_kernel_interpret'` arm (which
  pads the stack to 128 as the port does): rel-L2 3e-3 for every algo and
  both folds. Not 2e-4 elementwise: the W8A8 stack re-quantizes every
  activation row, so an f32 ulp of difference upstream (LayerNorm's and
  attention's f32 sums taken in another order) carries a value across an
  int8 rounding boundary now and then, and one level moves that row's
  product by ~1/127 of its scale. Measured on this tree: folded v3 and
  twopass 1.9e-4, bounded 5.2e-5, v3q 1.3e-7 (exact integer attention, no
  level moved); unfolded, with a runtime smoother on every linear, 1.3e-3
  to 1.7e-3 (with the same LayerNorm input the linears are bit-identical,
  `test_int8_linear_bit_identical_to_jax`).
- Twins of tests/test_whisper_int8.py's accuracy tests, with its bars.
- `allm.process_audio_features` dispatches on `w_q`: within rel-L2 3e-3 of
  JAX's (as `encode_int8`).
- A greedy `generate` chain on the quantized encoder equals JAX's.
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
from audio_llama_tpu.config import WhisperConfig as JWCfg  # noqa: E402
from audio_llama_tpu.inference import generate as j_gen  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import outliers as j_out  # noqa: E402
from audio_llama_tpu.models import whisper as j_wm  # noqa: E402
from audio_llama_tpu.models import whisper_int8 as j_w8  # noqa: E402
from audio_llama_tpu.ops import mel as j_mel  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig, LlamaConfig, WhisperConfig  # noqa: E402
from audio_llama_tpu_torch.inference import generate as t_gen  # noqa: E402
from audio_llama_tpu_torch.models import allm, whisper, whisper_int8 as w8  # noqa: E402

JWC, WC = JWCfg.tiny(), WhisperConfig.tiny()
W_Q_FLIPS = 1e-3  # share of the int8 weights allowed one level apart (smoothed)
SCALE_ULPS = 4


def _np(x):
    return np.asarray(x)


def _to_port(tree):
    return bridge.from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.fixture(scope="module")
def tiny():
    params = j_wm.init_params(JWC, jax.random.PRNGKey(0), jnp.float32)
    mel = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, JWC.num_mel_bins, 128))) * 0.5
    stats = j_w8.calibrate_encoder(params, JWC, jnp.asarray(mel), jnp.float32)
    return params, mel.astype(np.float32), stats


def _compare_trees(got, want, exact):
    fg, fw = _flat(jax.tree.map(lambda t: t.numpy(), got.to_dict())), _flat(want)
    assert fg.keys() == fw.keys()
    flips = total = 0
    for path, w in fw.items():
        g, w = fg[path], _np(w)
        assert g.dtype == w.dtype, path
        if exact or g.dtype != np.float32:
            if g.dtype == np.int8 and not exact:
                d = np.abs(g.astype(np.int32) - w.astype(np.int32))
                assert d.max() <= 1, path
                flips, total = flips + int((d > 0).sum()), total + d.size
            else:
                np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            np.testing.assert_array_max_ulp(g, w, maxulp=SCALE_ULPS)
    return flips, total


def test_quantize_encoder_naive_bit_identical(tiny):
    params, _, _ = tiny
    got = w8.quantize_encoder(_to_port(params))
    _compare_trees(got, j_w8.quantize_encoder(params), exact=True)
    assert w8.is_quantized(got) and not w8.is_quantized(_to_port(params))
    for name in w8.QUANT_TARGETS:
        assert "w" not in got["layers"][name] and got["layers"][name]["w_q"].dtype == torch.int8


@pytest.mark.parametrize("fold", [True, False])
def test_quantize_encoder_smoothed_matches_jax(tiny, fold):
    params, _, stats = tiny
    t_stats = {k: torch.from_numpy(np.array(v)) for k, v in stats.items()}
    got = w8.quantize_encoder(_to_port(params), t_stats, fold=fold)
    flips, total = _compare_trees(got, j_w8.quantize_encoder(params, stats, fold=fold),
                                  exact=False)
    assert flips <= W_Q_FLIPS * total, (flips, total)
    for name in w8.QUANT_TARGETS:
        assert ("a_s" in got["layers"][name]) == (not fold or name == "fc2"), name


def test_median_of_an_even_width_is_the_mean_of_the_middle_pair():
    s = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 1.0, 9.0, 7.0]])
    np.testing.assert_array_equal(w8._median(s).numpy(), [[2.5], [6.0]])
    np.testing.assert_array_equal(w8._median(s[:, :3]).numpy(), [[3.0], [5.0]])
    # the smoother is normalised by JAX's median; torch.median's lower middle
    # value would give other scales
    rng = np.random.default_rng(4)
    act, w = rng.random((2, 64)).astype(np.float32) + 0.1, rng.normal(size=(2, 64, 32))
    want = _np(j_w8.smooth_scales(jnp.asarray(act), jnp.asarray(w, jnp.float32)))
    got = w8.smooth_scales(torch.from_numpy(act), torch.from_numpy(w).float()).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-7)
    raw = (torch.from_numpy(act) ** 0.5 / w8._row_absmax(torch.from_numpy(w)) ** 0.5)
    lower = (raw / raw.median(dim=-1, keepdim=True).values).numpy()
    assert np.abs(lower - want).max() > 1e-3


def test_calibrate_encoder_matches_jax(tiny):
    params, mel, stats = tiny
    got = w8.calibrate_encoder(_to_port(params), WC, torch.from_numpy(mel), torch.float32)
    assert got.keys() == stats.keys()
    for key, want in stats.items():
        want = _np(want)
        assert got[key].shape == want.shape
        assert np.abs(got[key].numpy() - want).max() <= 1e-6 * np.abs(want).max(), key


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


REL_L2 = 3e-3


def test_int8_linear_bit_identical_to_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 24, 64)).astype(np.float32) * 3
    wq = rng.integers(-127, 128, (64, 40)).astype(np.int8)
    ws, b = (rng.random(40).astype(np.float32) * 0.01 + 1e-3 for _ in range(2))
    a_s = rng.random(64).astype(np.float32) + 0.5
    for bias, smoother in ((None, None), (None, a_s), (b, None), (b, a_s)):
        args = [None if a is None else jnp.asarray(a) for a in (x, wq, ws, bias, smoother)]
        want = _np(jax.jit(j_w8._int8_linear)(*args))
        got = w8._int8_linear(*(None if a is None else torch.from_numpy(np.array(a))
                                for a in args)).numpy()
        if bias is None:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("algo", ["v3", "v3q", "bounded", "twopass"])
def test_encode_int8_matches_jax_kernel_arm(tiny, algo):
    params, mel, stats = tiny
    qp = j_w8.quantize_encoder(params, stats)
    want = _np(j_w8.encode_int8(qp, JWC, jnp.asarray(mel), jnp.float32,
                                attn_impl="enc_kernel_interpret", attn_algo=algo))
    got = w8.encode_int8(_to_port(qp), WC, torch.from_numpy(mel), torch.float32,
                         attn_algo=algo).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) < REL_L2, _rel_l2(got, want)


def test_encode_int8_unfolded_tree_matches_jax(tiny):
    params, mel, stats = tiny
    qp = j_w8.quantize_encoder(params, stats, fold=False)
    want = _np(j_w8.encode_int8(qp, JWC, jnp.asarray(mel), jnp.float32,
                                attn_impl="enc_kernel_interpret"))
    got = w8.encode_int8(_to_port(qp), WC, torch.from_numpy(mel), torch.float32).numpy()
    assert _rel_l2(got, want) < REL_L2, _rel_l2(got, want)


def _rel_err(out, ref):
    return np.abs(out - ref) / (np.abs(ref).mean() + 1e-6)


def test_int8_encoder_close_to_f32(tiny):
    """tests/test_whisper_int8.py's twins on the port's own quantization:
    naive and smoothed (fold and not) W8A8 within JAX's bars of the f32
    encoder."""
    params, mel, _ = tiny
    tp, tmel = _to_port(params), torch.from_numpy(mel)
    ref = whisper.encode(tp, WC, tmel, torch.float32).numpy()
    for qp in (w8.quantize_encoder(tp),
               w8.quantize_encoder_smoothed(tp, WC, tmel, compute_dtype=torch.float32),
               w8.quantize_encoder(tp, w8.calibrate_encoder(tp, WC, tmel, torch.float32),
                                   fold=False)):
        rel = _rel_err(w8.encode_int8(qp, WC, tmel, torch.float32).numpy(), ref)
        assert rel.mean() < 0.03 and rel.max() < 0.5, (rel.mean(), rel.max())


def test_smoothing_rescues_the_outlier_regime(tiny):
    """JAX's outlier twin on the JAX-injected tree through the bridge: naive
    W8A8 degrades, smoothing restores (smoothed < 0.7 naive and < 0.05)."""
    params, mel, _ = tiny
    tp = _to_port(j_out.inject_whisper_outliers(params, jax.random.PRNGKey(7), scale=30.0))
    tmel = torch.from_numpy(mel)
    ref = whisper.encode(tp, WC, tmel, torch.float32).numpy()

    def err(qp):
        return float(_rel_err(w8.encode_int8(qp, WC, tmel, torch.float32).numpy(), ref).mean())

    naive = err(w8.quantize_encoder(tp))
    smooth = err(w8.quantize_encoder_smoothed(tp, WC, tmel, compute_dtype=torch.float32))
    assert smooth < naive * 0.7 and smooth < 0.05, (naive, smooth)


DIMS = dict(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=32, max_position_embeddings=2048, rope_scaling=None)
START, END = 512, 513


@pytest.fixture(scope="module")
def int8_encoder_model():
    jcfg = dataclasses.replace(JCfg.tiny(), llama=JLlamaCfg(**DIMS))
    cfg = dataclasses.replace(AudioLLMConfig.tiny(), llama=LlamaConfig(**DIMS))
    frozen = j_allm.init_frozen(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_llama.resize_embeddings(frozen["llama"], 514, jcfg.llama)
    rng = np.random.default_rng(3)
    wav = (rng.normal(size=(2, 2 * cfg.mel.max_samples)) * 0.1).astype(np.float32)
    calib = j_mel.log_mel(jnp.asarray(wav[:, :cfg.mel.max_samples]), jcfg.mel)
    frozen["whisper"] = j_w8.quantize_encoder_smoothed(frozen["whisper"], jcfg.whisper, calib,
                                                       compute_dtype=jnp.float32)
    trainable = {"projector": j_allm.init_trainable(jcfg, jax.random.PRNGKey(1))["projector"]}
    return jcfg, cfg, frozen, trainable, _to_port(frozen), _to_port(trainable), wav


@pytest.mark.parametrize("windows", [1, 2])
def test_process_audio_features_dispatches_on_w_q(int8_encoder_model, windows):
    """One 30 s window and the long-audio arm (two windows folded into the
    batch): the W8A8 encoder on both sides."""
    jcfg, cfg, jf, _, tf, _, wav = int8_encoder_model
    audio = wav[:, :windows * cfg.mel.max_samples]
    want = _np(j_allm.process_audio_features(jf, jcfg, jnp.asarray(audio), jnp.float32,
                                             enc_attn_impl="enc_kernel_interpret",
                                             mel_impl="xla"))
    got = allm.process_audio_features(tf, cfg, torch.from_numpy(audio), torch.float32).numpy()
    assert got.shape == want.shape
    assert _rel_l2(got, want) < REL_L2, _rel_l2(got, want)
    plain = j_allm.process_audio_features(
        {**jf, "whisper": j_wm.init_params(jcfg.whisper, jax.random.PRNGKey(9))}, jcfg,
        jnp.asarray(audio), jnp.float32, mel_impl="xla")
    assert np.abs(_np(plain) - want).max() > 1e-2  # the dispatch mattered


def test_int8_encoder_greedy_tokens_match_jax(int8_encoder_model):
    jcfg, cfg, jf, jt, tf, tt, wav = int8_encoder_model
    rng = np.random.default_rng(5)
    ids = rng.integers(3, 500, (2, 7)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    audio = wav[:, :cfg.mel.max_samples]
    kw = dict(max_new_tokens=6, greedy=True, eos_id=-1, pad_id=0, audio_start_id=START,
              audio_end_id=END, has_audio=True)
    want = j_gen.generate(jf, jt, jcfg, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(audio),
                          jax.random.PRNGKey(0), compute_dtype=jnp.float32, **kw)
    got = t_gen.generate(tf, tt, cfg, ids, mask, audio, compute_dtype=torch.float32,
                         device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), _np(want.tokens))


def test_from_jax_keeps_the_scales_f32_under_a_bf16_cast(tiny):
    """from_jax(dtype=bf16) casts the float leaves of a quantized encoder tree
    but never its quantization scales; int8 weights stay int8."""
    params, _, stats = tiny
    qp = j_w8.quantize_encoder(params, stats, fold=False)
    got = bridge.from_jax(jax.tree.map(np.asarray, qp), "cpu", dtype=torch.bfloat16)
    for name in w8.QUANT_TARGETS:
        mod = got["layers"][name]
        assert mod["w_q"].dtype == torch.int8
        assert mod["w_s"].dtype == torch.float32 and mod["a_s"].dtype == torch.float32
        np.testing.assert_array_equal(mod["w_s"].numpy(), _np(qp["layers"][name]["w_s"]))
        if "b" in mod:
            assert mod["b"].dtype == torch.bfloat16
    assert got["layers"]["attn_ln"]["scale"].dtype == torch.bfloat16
