"""Timeline-sharded (sp) generation of the port against the JAX package's
`make_sp_generate` on the 8-device CPU mesh (tests/conftest.py).

The cases mirror `tests/test_sp_generate.py`: a 40-token prompt against
32-slot windows, so the prefill's rows span both ranks and every decode
append lands on rank 1 (the cross-rank merge carries the answer); dp 2 x
sp 2; right-padded rows (the global mask sliced into windows); audio with
sp 4; an int8 KV cache; and the JAX decode-kernel runs (the db stats
kernels in interpret mode) with bf16/f32, int8 and int4 KV caches. The port
runs in one gloo world of 4 CPU ranks, spawned once (the rank side in
`test_torch_world.py`), on the same bridged f32 params, through its stats
kernels' plain versions (the 'auto' that ends each case's name).
Bar: greedy tokens and counts equal token for token, on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.parallel.seq_parallel import make_sp_generate as j_make_sp  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.models import llama as t_llama  # noqa: E402
from audio_llama_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from audio_llama_tpu_torch.parallel.seq_parallel import make_sp_generate  # noqa: E402

import test_torch_world as ranks  # noqa: E402  (the rank side; no JAX)
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

JCFG = JCfg.tiny()
CFG = AudioLLMConfig.tiny()


def _static(**over):
    s = dict(max_new_tokens=8, greedy=True, eos_id=-1, pad_id=0, audio_start_id=260,
             audio_end_id=261, has_audio=False)
    s.update(over)
    return s


def _text_inputs(B, T, seed=0, pad_last=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 250, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for r in range(1, pad_last + 1):  # right-pad the last rows, shorter and shorter
        mask[-r, T - 2 * r:] = 0
    return ids, mask


def _case(name, axes, ids, mask, audio=None, jax_impl="auto", **over):
    return dict(name=name, kind="sp", axes=axes, tree="f32", ids=ids, mask=mask, audio=audio,
                static=_static(**over), jax_impl=jax_impl)


def _cases():
    out = []
    ids, mask = _text_inputs(4, 40, seed=1)
    out.append(_case("sp2 auto", [("sp", 2)], ids, mask))
    out.append(_case("dp2 sp2", [("dp", 2), ("sp", 2)], ids, mask))
    out.append(_case("sp2 right-padded", [("sp", 2)], *_text_inputs(4, 40, seed=2, pad_last=2)))
    ids, mask = _text_inputs(2, 10, seed=3)
    audio = (np.random.RandomState(3).randn(2, CFG.mel.max_samples) * 0.1).astype(np.float32)
    out.append(_case("sp4 audio", [("sp", 4)], ids, mask, audio, has_audio=True,
                     max_new_tokens=5))
    out.append(_case("sp2 kv8", [("sp", 2)], *_text_inputs(2, 40, seed=4), kv_quant=True))
    ids, mask = _text_inputs(2, 40, seed=5, pad_last=1)
    for kv in (False, True, 4):
        out.append(_case(f"sp2 decode kernel kv{kv} auto", [("sp", 2)], ids, mask,
                         jax_impl="decode_kernel", kv_quant=kv))
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def model():
    kf, kt = jax.random.split(jax.random.PRNGKey(0))
    frozen = j_allm.init_frozen(JCFG, kf, dtype=jnp.float32)
    trainable = j_allm.init_trainable(JCFG, kt)
    return frozen, trainable


@pytest.fixture(scope="module")
def jax_tokens(model):
    """JAX make_sp_generate per case (one run per distinct JAX program)."""
    from jax.experimental.pallas import tpu as pltpu

    frozen, trainable = model
    out, seen = {}, {}
    for c in CASES:
        key = (str(c["axes"]), c["jax_impl"], c["ids"].tobytes(), c["mask"].tobytes(),
               str(sorted(c["static"].items())))
        if key not in seen:
            devs = np.array(jax.devices()[:int(np.prod([s for _, s in c["axes"]]))])
            mesh = jax.sharding.Mesh(devs.reshape([s for _, s in c["axes"]]),
                                     tuple(a for a, _ in c["axes"]))
            fn = j_make_sp(JCFG, mesh, attn_impl=c["jax_impl"], compute_dtype=jnp.float32,
                           **c["static"])
            args = (frozen, trainable, jnp.asarray(c["ids"]), jnp.asarray(c["mask"]),
                    None if c["audio"] is None else jnp.asarray(c["audio"]),
                    jax.random.PRNGKey(0))
            if c["jax_impl"] == "decode_kernel":
                with pltpu.force_tpu_interpret_mode():
                    res = fn(*args)
            else:
                res = fn(*args)
            seen[key] = (np.asarray(res.tokens), np.asarray(res.num_generated))
        out[c["name"]] = seen[key]
    return out


@pytest.fixture(scope="module")
def world(model):
    trees = {"f32": tuple(jax.tree.map(np.asarray, t) for t in model)}
    cases = [{k: v for k, v in c.items() if k != "jax_impl"} for c in CASES]
    return ranks.Spawned(ranks.generate_cases, 4, args=(trees, cases), threads=1,
                         timeout=240)


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_sp_generate_matches_jax(world, jax_tokens, name):
    case = next(c for c in CASES if c["name"] == name)
    want_tokens, want_num = jax_tokens[name]
    n = int(np.prod([s for _, s in case["axes"]]))
    for r in range(n):
        tokens, num = world[r][name]
        np.testing.assert_array_equal(tokens.numpy(), want_tokens, err_msg=f"rank {r}")
        np.testing.assert_array_equal(num.numpy(), want_num, err_msg=f"rank {r}")


def test_sp_generate_validates():
    with pytest.raises(ValueError, match="no 'sp' axis"):
        make_sp_generate(CFG, t_mesh.Mesh([("dp", 2)], 0), **_static())
    with pytest.raises(ValueError, match="extra non-trivial axes"):
        make_sp_generate(CFG, t_mesh.Mesh([("sp", 2), ("tp", 2)], 0), **_static())
    with pytest.raises(TypeError, match="unknown generation arguments"):
        make_sp_generate(CFG, t_mesh.Mesh([("sp", 2)], 0), max_len=3)


def test_llama_forward_sp_guards():
    params = t_llama.init_params(CFG.llama, torch.Generator().manual_seed(0))
    ids = torch.zeros((1, 1), dtype=torch.long)
    cache = t_llama.KVCache.zeros(CFG.llama, 1, 32, dtype=torch.float32)
    sp2, sp1 = t_mesh.MeshAxis("sp", 2, 0), t_mesh.MeshAxis("sp", 1, 0)
    kw = dict(input_ids=ids, compute_dtype=torch.float32)
    with pytest.raises(ValueError, match="requires kv_cache"):
        t_llama.llama_forward(params, CFG.llama, sp_axis=sp2, **kw)
    with pytest.raises(ValueError, match="static sp_size"):
        t_llama.llama_forward(params, CFG.llama, kv_cache=cache, sp_axis=sp1, **kw)
    with pytest.raises(ValueError, match="cache_offsets"):
        t_llama.llama_forward(params, CFG.llama, kv_cache=cache, sp_axis=sp2,
                              cache_offsets=torch.zeros(1, dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match="fresh prefill or T==1"):
        t_llama.llama_forward(params, CFG.llama, input_ids=torch.zeros((1, 3), dtype=torch.long),
                              kv_cache=cache, sp_axis=sp2, compute_dtype=torch.float32)
