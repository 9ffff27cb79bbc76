"""The port's outlier-channel injection (models/outliers.py) against the
JAX package's, and `--toy_outliers` through the port's trainer and inference
CLI.

- JAX's own multiplier fields (its `_channel_mults` on its split keys) fed
  to the port's application: the trees bit-identical to JAX's
  `inject_whisper_outliers` / `inject_llama_outliers` (the same f32
  products rounded back to each leaf's dtype).
- The port's draw (a torch.Generator; not JAX's numbers): n channels a layer
  and site, the rest ones; deterministic in (seed, scale, targets).
- `--toy_outliers` trains one step at toy dims; the inference CLI rebuilds
  the same frozen tree from the checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.config import WhisperConfig as JWCfg  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import outliers as j_out  # noqa: E402
from audio_llama_tpu.models import whisper as j_wm  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.data.audio_io import write_wav  # noqa: E402
from audio_llama_tpu_torch.device import make_generator  # noqa: E402
from audio_llama_tpu_torch.inference import cli  # noqa: E402
from audio_llama_tpu_torch.models import allm, outliers  # noqa: E402
from audio_llama_tpu_torch.training.train import build_frozen, parse_args, train  # noqa: E402


def _to_port(tree):
    return bridge.from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _assert_trees_equal(got, want):
    fw = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    fg = dict(jax.tree_util.tree_flatten_with_path(bridge.to_numpy(got))[0])
    assert fg.keys() == fw.keys()
    for path, w in fw.items():
        g, w = fg[path], np.asarray(w)
        assert g.dtype == w.dtype, path
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8), err_msg=str(path))


def _fields(keys, shapes, n, scales):
    return {name: torch.from_numpy(np.array(j_out._channel_mults(key, L, C, n, s)))
            for name, key, (L, C), s in zip(shapes, keys, shapes.values(), scales)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_whisper_application_of_jax_fields_is_bit_identical(dtype):
    cfg = JWCfg.tiny()
    params = j_wm.init_params(cfg, jax.random.PRNGKey(0), dtype)
    key = jax.random.PRNGKey(7)
    want = j_out.inject_whisper_outliers(params, key, scale=30.0)
    L, D, F = cfg.num_layers, cfg.d_model, cfg.ffn_dim
    shapes = {"attn_ln": (L, D), "mlp_ln": (L, D), "v_out": (L, D), "fc1_out": (L, F)}
    shapes.update({f"rows/{n}": (L, F if n == "fc2" else D) for n in outliers.WHISPER_ROW_SITES})
    mults = _fields(jax.random.split(key, 10), shapes, 4, [30.0] * 4 + [8.0] * 6)
    _assert_trees_equal(outliers.apply_whisper_outliers(_to_port(params), mults), want)


def test_llama_application_of_jax_fields_is_bit_identical():
    cfg = JLlamaCfg.tiny()
    params = j_llama.init_params(cfg, jax.random.PRNGKey(1), jnp.float32)
    key = jax.random.PRNGKey(3)
    want = j_out.inject_llama_outliers(params, key)
    lay = params["layers"]
    L, D = lay["input_ln"].shape
    kv = lay["k_proj"].shape[-1]
    shapes = {"input_ln": (L, D), "post_attn_ln": (L, D), "k_out": (L, kv), "v_out": (L, kv)}
    shapes.update({f"rows/{n}": (L, lay[n].shape[1]) for n in outliers.LLAMA_ROW_SITES})
    mults = _fields(jax.random.split(key, 11), shapes, 4, [20.0] * 4 + [8.0] * 7)
    _assert_trees_equal(outliers.apply_llama_outliers(_to_port(params), mults), want)


def test_port_draw_puts_n_channels_per_layer_and_site():
    gen = make_generator(5, "cpu")
    m = outliers.draw_whisper_mults(gen, 3, 64, 128, n=4, scale=40.0)
    assert set(m) == {"attn_ln", "mlp_ln", "v_out", "fc1_out",
                      *(f"rows/{n}" for n in outliers.WHISPER_ROW_SITES)}
    assert m["fc1_out"].shape == (3, 128) and m["rows/fc2"].shape == (3, 128)
    for name, field in m.items():
        hot = (field != 1).sum(dim=1)
        assert ((hot >= 1) & (hot <= 4)).all(), name  # 4 draws a layer (repeats collapse)
        assert (field > 0).all()
    # heavy-tailed around the scale: lognormal sigma 0.5
    hot = m["attn_ln"][m["attn_ln"] != 1]
    assert (hot > 40.0 * np.exp(-3 * 0.5)).all() and (hot < 40.0 * np.exp(3 * 0.5)).all()


def test_init_frozen_outliers_deterministic_in_seed_scale_and_targets():
    cfg = AudioLLMConfig.tiny()

    def frozen(seed, scale, targets=("whisper",)):
        return allm.init_frozen(cfg, make_generator(seed, "cpu"), torch.float32,
                                outlier_scale=scale, outlier_targets=targets)

    def leaf(tree, *path):
        for p in path:
            tree = tree[p]
        return tree.detach()

    base, a, b = frozen(0, 0.0), frozen(0, 20.0), frozen(0, 20.0)
    ln = ("whisper", "layers", "attn_ln", "scale")
    assert torch.equal(leaf(a, *ln), leaf(b, *ln))
    assert not torch.equal(leaf(a, *ln), leaf(base, *ln))
    assert not torch.equal(leaf(a, *ln), leaf(frozen(1, 20.0), *ln))
    assert not torch.equal(leaf(a, *ln), leaf(frozen(0, 30.0), *ln))
    # whisper only by default: the Llama tree is the plain one
    assert torch.equal(leaf(a, "llama", "layers", "k_proj"), leaf(base, "llama", "layers", "k_proj"))
    both = frozen(0, 20.0, ("whisper", "llama"))
    assert not torch.equal(leaf(both, "llama", "layers", "k_proj"),
                           leaf(base, "llama", "layers", "k_proj"))
    hot = (leaf(a, *ln) != 1).sum(dim=1)
    assert ((hot >= 1) & (hot <= 4)).all()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("outlier_corpus")
    audio_dir = root / "audio"
    audio_dir.mkdir()
    rng = np.random.RandomState(1)
    entries = []
    for i in range(4):
        write_wav(str(audio_dir / f"c{i}.wav"), (rng.randn(12800) * 0.05).astype(np.float32),
                  16000)
        entries.append({"text": "Transcribe: <audio>", "audio_paths": f"c{i}.wav",
                        "response": f"clip {i}"})
    (root / "examples.json").write_text(json.dumps(entries))
    return str(root / "examples.json"), str(audio_dir)


def test_toy_outliers_train_and_reload(corpus, tmp_path):
    """--toy_outliers trains one step through the port's trainer CLI; the
    inference CLI rebuilds the frozen tree with the same outliers."""
    out = str(tmp_path / "run")
    args = parse_args([
        "--data_path", corpus[0], "--audio_dir", corpus[1], "--output_dir", out,
        "--toy_model", "--tokenizer", "byte", "--platform", "cpu", "--batch_size", "2",
        "--grad_accum_steps", "1", "--num_epochs", "1", "--max_steps", "1", "--eval_steps", "0",
        "--save_steps", "0", "--num_workers", "1", "--no_tensorboard",
        "--compute_dtype", "float32", "--toy_outliers", "20", "--seed", "3"])
    result = train(args)
    assert result["steps"] == 1 and os.path.isdir(result["final_checkpoint"])
    cfg, frozen, _, _ = cli.load_audio_llm(result["final_checkpoint"], device="cpu")
    want = build_frozen(cfg, 3, torch.device("cpu"), outlier_scale=20.0)
    plain = build_frozen(cfg, 3, torch.device("cpu"))
    for name, p in want.named_parameters():
        assert torch.equal(dict(frozen.named_parameters())[name], p), name
    ln = "whisper.layers.attn_ln.scale"
    assert not torch.equal(dict(plain.named_parameters())[ln], dict(want.named_parameters())[ln])
