"""The port's QuaRot rotation against the JAX package's.

- A rotated tree from the JAX package, bridged: the port's llama_forward
  applies the sandwich (x @ rot after the embedding, x @ rot^T before the
  final norm), so its f32 logits equal JAX's within 1e-5 relative to their
  scale, argmax equal.
- `rotate_llama` / `rotate_lora` with the same explicit rot [D, D] and R2
  [hd, hd] (JAX's own R2, drawn from PRNGKey(0x52)): every leaf within 1e-6
  of its scale (the same f32 products summed in another order).
- The transform is exact: a rotated full-precision tree's logits equal the
  unrotated tree's within 1e-4 of their scale, and a rotated LoRA overlay
  keeps the adapted logits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import LlamaConfig as JLlamaCfg  # noqa: E402
from audio_llama_tpu.config import LoraConfig as JLoraCfg  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.models import llama_rotate as j_rt  # noqa: E402
from audio_llama_tpu.models import lora as j_lora  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import LlamaConfig  # noqa: E402
from audio_llama_tpu_torch.models import llama, llama_rotate  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

JCFG, CFG = JLlamaCfg.tiny(), LlamaConfig.tiny()


def _np(x):
    return np.asarray(x)


def _rot(d, seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(d, d)))
    return (q * np.sign(np.diag(r))[None, :]).astype(np.float32)


def _ids(seed, shape=(2, 9)):
    return np.random.default_rng(seed).integers(3, JCFG.vocab_size, shape).astype(np.int32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def params():
    return j_llama.init_params(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)


def _port_logits(tree, ids, lora_overlay=None):
    logits, _ = llama.llama_forward(tree, CFG, input_ids=torch.from_numpy(ids),
                                    compute_dtype=torch.float32, lora=lora_overlay)
    return logits.numpy()


def test_bridged_rotated_tree_matches_jax(params):
    """The sandwich repair: a rotated tree crosses the bridge and gives JAX's
    logits."""
    rot = _rot(JCFG.hidden_size, 1)
    jtree = j_rt.rotate_llama(params, JCFG, jnp.asarray(rot))
    ids = _ids(2)
    want = _np(j_llama.llama_forward(jtree, JCFG, input_ids=jnp.asarray(ids),
                                     compute_dtype=jnp.float32)[0])
    got = _port_logits(bridge.from_jax(jax.tree.map(np.asarray, jtree), "cpu"), ids)
    assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def _lora_overlay(seed):
    jcfg = JLoraCfg(rank=4, alpha=8.0, target_modules=(
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"))
    ov = j_lora.init_params(JCFG, jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    ov = {"layers": {n: {"a": rng.normal(size=br["a"].shape).astype(np.float32) * 0.05,
                         "b": rng.normal(size=br["b"].shape).astype(np.float32) * 0.05}
                     for n, br in ov["layers"].items()}}
    return ov, jcfg.scaling


def test_rotate_llama_and_lora_trees_match_jax(params):
    rot = _rot(JCFG.hidden_size, 3)
    r2 = np.array(j_rt.random_rotation(jax.random.PRNGKey(0x52), JCFG.head_dim))
    ov, _ = _lora_overlay(4)
    jtree, jlora = j_rt.rotate_llama(params, JCFG, jnp.asarray(rot),
                                     lora=jax.tree.map(jnp.asarray, ov))
    ttree, tlora = llama_rotate.rotate_llama(
        bridge.from_jax(jax.tree.map(np.asarray, params), "cpu"), CFG, torch.from_numpy(rot),
        lora=bridge.from_jax(ov, "cpu"), r2=torch.from_numpy(r2))
    got = {**ttree.to_dict(), "lora": tlora.to_dict()}
    want = {**jtree, "lora": jlora}
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_g = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0])
    assert flat_g.keys() == flat_w.keys()
    for path, w in flat_w.items():
        w = _np(w)
        np.testing.assert_allclose(flat_g[path], w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=str(path))


def test_rotation_is_exact_and_keeps_lora(params):
    tree = bridge.from_jax(jax.tree.map(np.asarray, params), "cpu")
    ov, scaling = _lora_overlay(5)
    overlay = {"layers": bridge.from_jax(ov, "cpu")["layers"], "scaling": scaling}
    ids = _ids(6)
    gen = torch.Generator().manual_seed(7)
    rtree, rlora = llama_rotate.rotate_llama(tree, CFG, gen, lora=overlay)
    assert "rot" in rtree and rlora["scaling"] == scaling
    base = _port_logits(tree, ids)
    assert _rel(_port_logits(rtree, ids), base) <= 1e-4
    adapted = _port_logits(tree, ids, overlay)
    assert _rel(adapted, base) > 1e-3  # the overlay changes the output
    assert _rel(_port_logits(rtree, ids, rlora), adapted) <= 1e-4
    with pytest.raises(ValueError, match="already rotated"):
        llama_rotate.rotate_llama(rtree, CFG, gen)
    with pytest.raises(ValueError, match="explicit r2"):
        llama_rotate.rotate_llama(tree, CFG, torch.from_numpy(_rot(CFG.hidden_size, 8)))
