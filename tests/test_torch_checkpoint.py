"""Checkpoints between the packages, on the CPU.

The port's msgpack codec (`training/msgpack_io.py`) writes the bytes that
`flax.serialization` writes and reads what it writes, `msgpack`'s own
encodings of every width included. A checkpoint saved by the JAX package's
`save_checkpoint` loads in the port, and the port's loads in the JAX
package's `load_checkpoint`, bit-equal, the optimizer state included; the
reference trainer's `.pt` imports as the JAX package imports it.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.training import checkpoint as j_ckpt  # noqa: E402
from audio_llama_tpu.training import optim as j_optim  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.device import make_generator  # noqa: E402
from audio_llama_tpu_torch.models import allm  # noqa: E402
from audio_llama_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from audio_llama_tpu_torch.training import msgpack_io, optim  # noqa: E402

JCFG, CFG = JCfg.tiny(), AudioLLMConfig.tiny()


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


# --- the codec ------------------------------------------------------------------

TREES = {
    "checkpoint-like": {
        "model": {"trainable": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                                "b": np.zeros(0, np.float32)}},
        "optimizer": {"0": {}, "1": {"0": {"count": np.asarray(3, np.int32)}}},
        "step": 7, "epoch": 0,
    },
    "dtypes": {name: np.arange(6).astype(name).reshape(2, 3)
               for name in ("float16", "float32", "float64", "int8", "int16", "int32",
                            "int64", "uint8", "uint32", "bool")},
    "scalars": {"i": -5, "big": 2 ** 40, "neg": -2 ** 33, "f": 0.1, "t": True, "s": "x" * 40,
                "np_scalar": np.float32(1.5), "np_int": np.int64(-7), "none": None,
                "list": [1, "a", [2.5, False]], "zero_d": np.asarray(2.0, np.float64)},
    "wide": {f"k{i}": i for i in range(20)},
}


@pytest.mark.parametrize("name", list(TREES))
def test_codec_writes_flax_bytes(name):
    tree = TREES[name]
    want = serialization.msgpack_serialize(tree)
    assert msgpack_io.serialize(tree) == want


@pytest.mark.parametrize("name", list(TREES))
def test_codec_round_trips_both_ways(name):
    tree = TREES[name]
    _assert_tree_equal(msgpack_io.restore(serialization.msgpack_serialize(tree)),
                       serialization.msgpack_restore(serialization.msgpack_serialize(tree)))
    _assert_tree_equal(serialization.msgpack_restore(msgpack_io.serialize(tree)),
                       msgpack_io.restore(msgpack_io.serialize(tree)))


@pytest.mark.parametrize("value", [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                                   2 ** 63, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
                                   -2 ** 31 - 1, -2 ** 63, 1.25, "", "é" * 20, "y" * 300,
                                   "z" * 70000, b"", b"\x00" * 300, b"\x01" * 70000,
                                   list(range(16)), list(range(70000)),
                                   {str(i): i for i in range(70000)}])
def test_codec_matches_msgpack_at_every_width(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert msgpack_io.packb(value) == want
    assert msgpack_io.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_chunks_large_arrays_as_flax(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(100, dtype=np.float32).reshape(10, 10), "small": np.ones(3)}
    data = msgpack_io.serialize(tree)
    assert data == serialization.msgpack_serialize(tree)
    _assert_tree_equal(msgpack_io.restore(data), tree)


def test_codec_rejects_bad_input():
    with pytest.raises(TypeError):
        msgpack_io.packb({"x": object()})
    with pytest.raises(ValueError):
        msgpack_io.unpackb(b"\x92\x01")  # an array of 2 holding 1 item
    with pytest.raises(ValueError):
        msgpack_io.unpackb(b"\x01\x02")  # trailing bytes


# --- checkpoints across the packages ----------------------------------------------

def _jax_state(steps=2):
    """A JAX trainable and optax state after `steps` updates (non-zero
    moments)."""
    trainable = j_allm.init_trainable(JCFG, jax.random.PRNGKey(3))
    opt = j_optim.make_optimizer(j_optim.cosine_schedule_with_warmup(1e-3, 1, 5))
    state = opt.init(trainable)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        grads = jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype),
                             trainable)
        updates, state = opt.update(grads, state, trainable)
        trainable = optax.apply_updates(trainable, updates)
    return trainable, state, opt


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    jt, jstate, _ = _jax_state()
    path = j_ckpt.save_checkpoint(str(tmp_path), trainable=jt, opt_state=jstate, step=2, epoch=1,
                                  model_cfg=JCFG, args={"seed": 3})
    template = allm.init_trainable(CFG, make_generator(0, "cpu"))
    tt, topt, step, epoch = ckpt.load_checkpoint(path, trainable_template=template)
    assert (step, epoch) == (2, 1)
    _assert_tree_equal(bridge.to_numpy(tt), jax.tree.map(np.asarray, jt))
    want_opt = serialization.to_state_dict(jax.tree.map(np.asarray, jstate))
    _assert_tree_equal(topt, want_opt)
    # and into the optimizer: its state reads back in optax's layout
    tt.requires_grad_(True)
    opt = optim.OptaxAdamW(list(tt.parameters()), lambda c: 0.0)
    opt.load_optax_state(tt, topt)
    _assert_tree_equal(opt.optax_state(tt), want_opt)
    assert ckpt.load_metadata(path) == j_ckpt.load_metadata(path)


def test_port_checkpoint_loads_in_jax(tmp_path):
    tt = allm.init_trainable(CFG, make_generator(5, "cpu")).requires_grad_(True)
    opt = optim.OptaxAdamW(list(tt.parameters()), optim.cosine_schedule_with_warmup(1e-3, 1, 5))
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        for p in tt.parameters():
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    path = ckpt.save_checkpoint(str(tmp_path), trainable=tt, opt_state=opt.optax_state(tt),
                                step=2, epoch=0, model_cfg=CFG, final=True)
    assert path.endswith("final_checkpoint")
    template = jax.device_get(j_allm.init_trainable(JCFG, jax.random.PRNGKey(0)))
    jopt = j_optim.make_optimizer(j_optim.cosine_schedule_with_warmup(1e-3, 1, 5))
    jt, jstate, step, _ = j_ckpt.load_checkpoint(path, trainable_template=template,
                                                 opt_state_template=jopt.init(template))
    assert step == 2
    _assert_tree_equal(jax.tree.map(np.asarray, jt), bridge.to_numpy(tt))
    _assert_tree_equal(serialization.to_state_dict(jax.tree.map(np.asarray, jstate)),
                       opt.optax_state(tt))
    assert int(jstate[1][0].count) == 2 and int(jstate[1][2].count) == 2
    # the JAX optimizer continues from the port's state
    grads = jax.tree.map(jnp.ones_like, jt)
    jopt.update(grads, jstate, jt)


def test_bare_trainable_dump_loads(tmp_path):
    jt, _, _ = _jax_state(steps=1)
    path = tmp_path / "bare.msgpack"
    path.write_bytes(serialization.to_bytes(jax.tree.map(np.asarray, jt)))
    tt, topt, step, epoch = ckpt.load_checkpoint(
        str(path), trainable_template=allm.init_trainable(CFG, make_generator(0, "cpu")))
    assert topt is None and (step, epoch) == (0, 0)
    _assert_tree_equal(bridge.to_numpy(tt), jax.tree.map(np.asarray, jt))


def test_load_keeps_the_template_device_dtype_and_grad_flag(tmp_path):
    tt = allm.init_trainable(CFG, make_generator(5, "cpu"))
    path = ckpt.save_checkpoint(str(tmp_path), trainable=tt, opt_state={}, step=0, epoch=0,
                                model_cfg=CFG)
    template = bridge.from_jax(bridge.to_numpy(tt), "cpu", torch.float64).requires_grad_(True)
    got, _, _, _ = ckpt.load_checkpoint(path, trainable_template=template)
    assert all(p.dtype == torch.float64 and p.requires_grad for p in got.parameters())


def test_checkpoint_shape_mismatch_raises(tmp_path):
    tt = allm.init_trainable(CFG.replace(lora=CFG.lora.replace(rank=2)), make_generator(5, "cpu"))
    path = ckpt.save_checkpoint(str(tmp_path), trainable=tt, opt_state={}, step=0, epoch=0,
                                model_cfg=CFG)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(path, trainable_template=allm.init_trainable(
            CFG, make_generator(0, "cpu")))


def _reference_pt(path, L, dims, seed=0):
    """A reference-trainer checkpoint: projector Sequential state dict and
    per-module LoRA state dicts for layers 0 and L-1 of q_proj and up_proj."""
    g = torch.Generator().manual_seed(seed)
    i, h, o = CFG.projector.input_dim, CFG.projector.hidden, CFG.projector.output_dim
    proj = {"layers.0.weight": torch.randn(h, i, generator=g),
            "layers.0.bias": torch.randn(h, generator=g),
            "layers.2.weight": torch.randn(o, h, generator=g),
            "layers.2.bias": torch.randn(o, generator=g),
            "layers.3.weight": torch.randn(o, generator=g),
            "layers.3.bias": torch.randn(o, generator=g)}
    lora = {}
    for layer in (0, L - 1):
        for target, sub in (("q_proj", "self_attn"), ("up_proj", "mlp")):
            din, dout = dims[target]
            lora[f"model.layers.{layer}.{sub}.{target}"] = {
                "lora_A": torch.randn(CFG.lora.rank, din, generator=g),
                "lora_B": torch.randn(dout, CFG.lora.rank, generator=g)}
    torch.save({"model": {"projector": proj, "lora_layers": lora}, "step": 11, "epoch": 2},
               path)


def test_reference_pt_imports_as_in_jax(tmp_path):
    lc = CFG.llama
    dims = {"q_proj": (lc.hidden_size, lc.q_dim),
            "up_proj": (lc.hidden_size, lc.intermediate_size)}
    d = tmp_path / "ref_ckpt"
    d.mkdir()
    _reference_pt(str(d / "checkpoint.pt"), lc.num_layers, dims)
    template = allm.init_trainable(CFG, make_generator(0, "cpu"))
    before = bridge.to_numpy(template)
    tt, topt, step, epoch = ckpt.load_checkpoint(str(d), trainable_template=template)
    jt, _, jstep, jepoch = j_ckpt.load_checkpoint(str(d),
                                                  trainable_template=bridge.to_numpy(template))
    assert (step, epoch) == (jstep, jepoch) == (11, 2) and topt is None
    _assert_tree_equal(bridge.to_numpy(tt), jax.tree.map(np.asarray, jt))
    _assert_tree_equal(bridge.to_numpy(template), before)  # the template is untouched


def test_reference_pt_without_lora_target_raises(tmp_path):
    path = str(tmp_path / "x.pt")
    torch.save({"projector": {}}, path)
    with pytest.raises(ValueError, match="projector state dict missing"):
        ckpt.load_checkpoint(path, trainable_template=allm.init_trainable(
            CFG, make_generator(0, "cpu")))
    torch.save({"nothing": 1}, path)
    with pytest.raises(ValueError, match="not a recognized reference checkpoint"):
        ckpt.load_reference_checkpoint(path, trainable_template=allm.init_trainable(
            CFG, make_generator(0, "cpu")))


def test_checkpoint_names(tmp_path):
    tt = allm.init_trainable(CFG, make_generator(5, "cpu"))
    kw = dict(trainable=tt, opt_state={}, step=3, epoch=0, model_cfg=CFG)
    assert os.path.basename(ckpt.save_checkpoint(str(tmp_path), **kw)) == "checkpoint-3"
    assert os.path.basename(ckpt.save_checkpoint(str(tmp_path), best=True, **kw)) == "best_model"
