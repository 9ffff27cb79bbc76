"""The port's training path against the JAX package, on the CPU.

Inputs are drawn with numpy and weights cross through `bridge.from_jax`, so
both packages see the same numbers: the causal attention backward (the
JAX kernels in interpret mode), the gradients of `allm.forward` for both
splices, a text-only batch and the chunked loss, three accumulated AdamW
steps with optax's schedule, and the train CLI end to end (the twins of
tests/test_train_cli.py), its refusals and its checkpoints in the JAX
package's format.

Tolerances: f32 gradients within 5e-4 (attention, as the JAX package's own
kernel test) and 1e-4 of the largest element (the whole model: the same f32
arithmetic summed in other orders); the bf16 attention case within 2e-2
relative L2 (each package rounds o, P and dS to bf16 at its own places).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.data.audio_io import write_wav  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.ops import causal_attention as j_ca  # noqa: E402
from audio_llama_tpu.training import checkpoint as j_ckpt  # noqa: E402
from audio_llama_tpu.training import optim as j_optim  # noqa: E402
from audio_llama_tpu.training import train_step as j_steps  # noqa: E402
from audio_llama_tpu_torch import bridge  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.inference import cli  # noqa: E402
from audio_llama_tpu_torch.models import allm, llama  # noqa: E402
from audio_llama_tpu_torch.ops import causal_attention as ca  # noqa: E402
from audio_llama_tpu_torch.training import checkpoint as ckpt  # noqa: E402
from audio_llama_tpu_torch.training import msgpack_io, optim, train_step  # noqa: E402
from audio_llama_tpu_torch.training.train import (  # noqa: E402
    _to_batch, group_by_modality, parse_args, train)

JCFG, CFG = JCfg.tiny(), AudioLLMConfig.tiny()
SID, EID = JCFG.llama.vocab_size, JCFG.llama.vocab_size + 1  # rows added by the resize


def _np(x):
    return np.asarray(x, np.float32)


def _close(got, want, rel=1e-4):
    """max |got - want| <= rel * max |want| (and finite)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale + 1e-9, (err, scale)


# --- (a) the causal attention backward ---------------------------------------

def _attn_case(B=2, T=256, Hq=4, Hkv=2, hd=32, pad_from=200):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, T, h, hd)).astype(np.float32) * 0.5
               for h in (Hq, Hkv, Hkv))
    mask = np.ones((B, T), np.int32)
    mask[0, pad_from:] = 0
    w = rng.normal(size=(B, T, Hq, hd)).astype(np.float32)
    return q, k, v, mask, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_mha_gradients_match_jax(dtype):
    q, k, v, mask, w = _attn_case()
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def loss(q_, k_, v_):
        o = j_ca.causal_mha(q_, k_, v_, mask=jnp.asarray(mask), interpret=True, block_q=128,
                            chunk_k=128)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jdt) for x in (q, k, v)))
    ts = [torch.from_numpy(x).to(tdt).requires_grad_(True) for x in (q, k, v)]
    o = ca.causal_mha(*ts, mask=torch.from_numpy(mask))
    got = torch.autograd.grad(o, ts, torch.from_numpy(w).to(tdt))
    valid = mask.astype(bool)
    for g, wnt, name in zip(got, want, "qkv"):
        g, wnt = g.float().numpy(), _np(wnt)
        if name == "q":  # padded query rows are garbage in both packages
            g, wnt = g[valid], wnt[valid]
        if dtype == "float32":
            np.testing.assert_allclose(g, wnt, atol=5e-4, rtol=5e-4, err_msg=name)
        else:
            assert np.linalg.norm(g - wnt) <= 2e-2 * np.linalg.norm(wnt), name


def test_bwd_plain_matches_the_jax_kernels_on_the_same_residuals():
    """`causal_attention_bwd_plain` against JAX's `_dq_call` / `_dkv_call`
    (interpret mode) fed the same qs, k, v, bias, m, l and D."""
    q, k, v, mask, w = _attn_case()
    B, T, Hq, hd = q.shape
    Hkv = k.shape[2]
    qs = torch.from_numpy(q) * hd ** -0.5
    kt, vt, do = torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(w)
    key_bias = torch.where(torch.from_numpy(mask) != 0, 0.0, ca.NEG)
    o, l, m = ca.causal_attention_plain(qs, kt, vt, key_bias)
    got = ca.causal_attention_bwd_plain(qs, kt, vt, key_bias, o, l, m, do)
    d = ca.attention_bwd_prologue(o, do)

    def heads(x):  # [B, T, H, hd] -> [B*H, T, hd]
        return jnp.asarray(x.numpy().transpose(0, 2, 1, 3).reshape(-1, T, hd))

    args = (heads(qs), heads(kt), heads(vt), jnp.asarray(key_bias.numpy())[:, None, :],
            jnp.asarray(m.numpy())[:, None, :], heads(do), jnp.asarray(l.numpy())[:, None, :],
            jnp.asarray(d.numpy())[:, None, :], Hq, Hkv)
    kw = dict(bq=128, ck=128, interpret=True)
    jdq = j_ca._dq_call(*args, **kw)
    jdk, jdv = j_ca._dkv_call(*args, **kw)
    for g, wnt in zip(got, (jdq, jdk, jdv)):
        wnt = _np(wnt).reshape(B, -1, T, hd).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), wnt, atol=5e-5, rtol=5e-5)


# --- (b) gradients of allm.forward --------------------------------------------

@pytest.fixture(scope="module")
def params():
    frozen = j_allm.init_frozen(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_llama.resize_embeddings(frozen["llama"], JCFG.llama.vocab_size + 2,
                                                JCFG.llama)
    trainable = j_allm.init_trainable(JCFG, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    for br in trainable["lora"]["layers"].values():  # 'ref' init has a = 0
        br["a"] = jnp.asarray(rng.normal(size=br["a"].shape).astype(np.float32) * 0.1)
    jt = jax.tree.map(np.asarray, trainable)
    return frozen, jt, bridge.from_jax(jax.tree.map(np.asarray, frozen), "cpu")


def _batch(seed, audio=True, lead=(), B=2, T=12):
    """A numpy batch: ids with '<audio>' at position 3 of each row, labels on
    the second half, the last row right-padded; log-mel audio."""
    rng = np.random.default_rng(seed)
    shape = (*lead, B, T)
    ids = rng.integers(3, 500, shape).astype(np.int32)
    ids[..., 3] = SID
    mask = np.ones(shape, np.int32)
    mask[..., -1, T - 3:] = 0
    labels = np.where(np.arange(T) >= T // 2, ids, -100).astype(np.int32)
    labels[mask == 0] = -100
    mel = None
    if audio:
        mel = rng.normal(size=(*lead, B, CFG.whisper.num_mel_bins,
                               2 * CFG.whisper.max_source_positions)).astype(np.float32)
    return ids, mask, mel, labels


def _jax_batch(b):
    return j_allm.AudioLLMBatch(*(None if x is None else jnp.asarray(x) for x in b))


def _torch_batch(b):
    return allm.AudioLLMBatch(*(None if x is None else torch.from_numpy(x) for x in b))


def _port_trainable(jt):
    return bridge.from_jax(jt, "cpu").requires_grad_(True)


@pytest.mark.parametrize("splice,audio,chunk", [("prepend", True, 0), ("inplace", True, 0),
                                                 ("prepend", False, 0), ("prepend", True, 5),
                                                 ("inplace", False, 4)])
def test_forward_gradients_match_jax(params, splice, audio, chunk):
    jf, jt, tf = params
    jcfg, cfg = JCFG.replace(splice_mode=splice), CFG.replace(splice_mode=splice)
    b = _batch(1, audio)

    def jloss(t, batch):
        return j_allm.forward(jf, t, jcfg, batch, SID, EID, jnp.float32,
                              loss_chunk_size=chunk)[0]

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(jt, _jax_batch(b))
    tt = _port_trainable(jt)
    loss, _ = allm.forward(tf, tt, cfg, _torch_batch(b), SID, EID, torch.float32,
                           loss_chunk_size=chunk)
    grads = train_step.gradients(loss, list(tt.parameters()))
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    flat = dict(zip((n for n, _ in tt.named_parameters()), grads))
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        name = ".".join(p.key for p in path)
        _close(flat[name].numpy(), leaf)


def test_chunked_loss_equals_the_dense_loss(params):
    jf, jt, tf = params
    tt = _port_trainable(jt)
    b = _torch_batch(_batch(2))
    dense, logits = allm.forward(tf, tt, CFG, b, SID, EID, torch.float32)
    for chunk in (3, 7, 64):
        chunked, none = allm.forward(tf, tt, CFG, b, SID, EID, torch.float32,
                                     loss_chunk_size=chunk)
        assert none is None
        assert abs(chunked.item() - dense.item()) <= 1e-6 * dense.item()
    assert logits.dtype == torch.float32
    ignored = torch.full(logits.shape[:2], -100, dtype=torch.int64)
    assert float(llama.causal_lm_loss(logits, ignored)) == 0.0  # nothing to score


def test_remat_gives_the_same_gradients(params):
    jf, jt, tf = params
    b = _torch_batch(_batch(3))
    out = []
    for remat in (False, True):
        tt = _port_trainable(jt)
        loss, _ = allm.forward(tf, tt, CFG, b, SID, EID, torch.float32, remat=remat)
        out.append(torch.autograd.grad(loss, list(tt.parameters())))
    for a, c in zip(*out):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=1e-6)


def test_the_encoder_and_the_frozen_tree_get_no_gradients(params):
    jf, jt, tf = params
    tt = _port_trainable(jt)
    loss, _ = allm.forward(tf, tt, CFG, _torch_batch(_batch(4)), SID, EID, torch.float32)
    loss.backward()
    assert all(p.grad is None for p in tf.parameters())
    assert all(p.grad is not None for p in tt.parameters())
    assert allm.num_trainable_params(tt) == j_allm.num_trainable_params(jt)


# --- (c) accumulated AdamW steps ----------------------------------------------

def test_schedule_equals_optax():
    for peak, warm, total in ((1e-3, 1, 3), (2e-5, 50, 400), (3e-4, 10, 11), (1e-3, 0, 5)):
        want = j_optim.cosine_schedule_with_warmup(peak, warm, total)
        got = optim.cosine_schedule_with_warmup(peak, warm, total)
        for i in range(total + 3):
            np.testing.assert_allclose(got(i), float(want(i)), rtol=1e-6, atol=0)
    assert optim.cosine_schedule_with_warmup(1e-3, 5, 10)(0) == 0.0


def test_three_accumulated_steps_match_jax(params):
    jf, jt, tf = params
    schedule_args = (1e-3, 1, 3)
    opt = j_optim.make_optimizer(j_optim.cosine_schedule_with_warmup(*schedule_args),
                                 weight_decay=0.01, max_grad_norm=1.0)
    jstate = j_steps.init_train_state(jax.tree.map(jnp.asarray, jt), opt)
    jstep = jax.jit(j_steps.make_train_step(JCFG, opt, SID, EID, jnp.float32, accum_steps=2))
    schedule = optim.cosine_schedule_with_warmup(*schedule_args)
    tstate = train_step.init_train_state(_port_trainable(jt), lambda p: optim.OptaxAdamW(
        p, schedule, weight_decay=0.01, max_grad_norm=1.0))
    tstep = train_step.make_train_step(CFG, SID, EID, torch.float32, accum_steps=2)
    clipped = []
    for i in range(3):
        b = _batch(10 + i, lead=(2,))
        jstate, jm = jstep(jstate, jf, _jax_batch(b))
        tstate, tm = tstep(tstate, tf, _torch_batch(b))
        assert tstate.step == int(jstate.step) == i + 1
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= 1e-4 * abs(float(jm[key])), key
        clipped.append(float(jm["grad_norm"]) > 1.0)
        got = dict(tstate.trainable.named_parameters())
        for path, leaf in jax.tree_util.tree_flatten_with_path(jstate.trainable)[0]:
            _close(got[".".join(p.key for p in path)].detach().numpy(), leaf)
    assert any(clipped)  # the clip ran
    state = tstate.optimizer.optax_state(tstate.trainable)
    jopt = jax.tree.map(np.asarray, jstate.opt_state)
    assert int(state["1"]["0"]["count"]) == int(jopt[1][0].count) == 3
    assert int(state["1"]["2"]["count"]) == int(jopt[1][2].count) == 3
    for key in ("mu", "nu"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(getattr(jopt[1][0], key))[0]:
            node = state["1"]["0"][key]
            for p in path:
                node = node[p.key]
            _close(node, leaf, rel=1e-3)


# --- (f) the train CLI, twins of tests/test_train_cli.py -----------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    audio_dir = root / "audio"
    audio_dir.mkdir()
    rng = np.random.RandomState(0)
    entries = []
    for i in range(12):
        rel = f"clip_{i}.wav"
        write_wav(str(audio_dir / rel), (rng.randn(12800) * 0.05).astype(np.float32), 16000)
        entries.append({"text": f"Transcribe clip {i}: <audio>", "audio_paths": rel,
                        "response": f"this is clip number {i}"})
    data_path = root / "examples.json"
    data_path.write_text(json.dumps(entries))
    return str(data_path), str(audio_dir)


def _args(corpus, out, extra=()):
    data_path, audio_dir = corpus
    return parse_args([
        "--data_path", data_path, "--audio_dir", audio_dir, "--output_dir", out,
        "--toy_model", "--tokenizer", "byte", "--platform", "cpu",
        "--batch_size", "2", "--eval_batch_size", "2", "--grad_accum_steps", "2",
        "--num_epochs", "1", "--log_steps", "1", "--eval_steps", "2", "--save_steps", "2",
        "--warmup_steps", "1", "--num_workers", "2", "--no_tensorboard",
        "--compute_dtype", "float32", *extra])


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_end_to_end(corpus, tmp_path):
    out = str(tmp_path / "run")
    result = train(_args(corpus, out))
    assert result["steps"] >= 2
    assert os.path.isdir(result["final_checkpoint"])
    assert os.path.exists(os.path.join(out, "training.log"))
    lines = _metrics(out)
    keys = set().union(*(line.keys() for line in lines))
    assert "train/loss" in keys and "eval/loss" in keys and "perf/tokens_per_sec" in keys
    assert os.path.isdir(os.path.join(out, "best_model"))
    assert os.path.isdir(os.path.join(out, "checkpoint-2"))
    assert all(np.isfinite([line["train/loss"] for line in lines if "train/loss" in line]))


def test_training_is_deterministic(corpus, tmp_path):
    losses = []
    for run in ("a", "b"):
        out = str(tmp_path / run)
        train(_args(corpus, out, ["--max_steps", "3", "--eval_steps", "0"]))
        losses.append([line["train/loss"] for line in _metrics(out) if "train/loss" in line])
    assert losses[0] == losses[1] and len(losses[0]) == 2  # 11 rows -> 5 batches -> 2 steps


def test_resume_from_checkpoint(corpus, tmp_path):
    out1 = str(tmp_path / "run1")
    r1 = train(_args(corpus, out1, ["--max_steps", "1", "--eval_steps", "0"]))
    assert r1["steps"] == 1
    out2 = str(tmp_path / "run2")
    r2 = train(_args(corpus, out2, ["--resume_from", r1["final_checkpoint"], "--max_steps", "2",
                                    "--eval_steps", "0"]))
    assert r2["steps"] == 2  # continued from step 1, ran 1 more
    with open(os.path.join(r2["final_checkpoint"], ckpt.CKPT_FILE), "rb") as f:
        raw = msgpack_io.restore(f.read())
    assert raw["step"] == 2  # the optimizer's counts carried over too
    assert int(raw["optimizer"]["1"]["0"]["count"]) == int(raw["optimizer"]["1"]["2"]["count"]) == 2


def test_final_checkpoint_loads_in_jax_and_in_the_inference_cli(corpus, tmp_path):
    out = str(tmp_path / "run")
    final = train(_args(corpus, out, ["--max_steps", "1", "--eval_steps", "0"]))[
        "final_checkpoint"]
    meta = ckpt.load_metadata(final)
    jcfg = JCfg.from_dict(meta["model_config"])
    template = jax.device_get(j_allm.init_trainable(jcfg, jax.random.PRNGKey(0)))
    opt = j_optim.make_optimizer(j_optim.cosine_schedule_with_warmup(2e-5, 1, 2))
    jt, jo, step, _ = j_ckpt.load_checkpoint(final, trainable_template=template,
                                             opt_state_template=opt.init(template))
    assert step == 1 and int(jo[1][0].count) == 1
    with open(os.path.join(final, ckpt.CKPT_FILE), "rb") as f:
        raw = msgpack_io.restore(f.read())["model"]["trainable"]
    cfg, frozen, tt, tk = cli.load_audio_llm(final, device="cpu")
    got = dict(tt.named_parameters())
    for path, leaf in jax.tree_util.tree_flatten_with_path(jt)[0]:
        names = [p.key for p in path]
        node = raw
        for n in names:
            node = node[n]
        np.testing.assert_array_equal(np.asarray(leaf), node)
        np.testing.assert_array_equal(got[".".join(names)].detach().numpy(), node)
    assert cfg.to_json() == AudioLLMConfig.from_dict(meta["model_config"]).to_json()
    text = cli.main(["--platform", "cpu", "--checkpoint_path", final, "--prompt", "Transcribe",
                     "--audio", os.path.join(corpus[1], "clip_0.wav"), "--greedy",
                     "--max_new_tokens", "3"])
    assert isinstance(text, str)


def test_group_by_modality_keeps_audio():
    def mk(has_audio, tag):
        return {"input_ids": np.full((2, 4), tag, np.int32),
                "attention_mask": np.ones((2, 4), np.int32),
                "audio": np.ones((2, 8), np.float32) * tag if has_audio else None,
                "labels": np.ones((2, 4), np.int32)}

    stream = [mk(True, 1), mk(False, 2), mk(True, 3), mk(False, 4), mk(True, 5), mk(True, 6)]
    groups = list(group_by_modality(stream, accum=2))
    audio_groups = [g for g in groups if g.audio_features is not None]
    assert len(audio_groups) == 2 and len(groups) == 3
    assert all(g.audio_features.shape == (2, 2, 8) for g in audio_groups)
    with pytest.raises(ValueError, match="mixes audio"):
        _to_batch([mk(True, 1), mk(False, 2)])


@pytest.mark.parametrize("flags,error,match", [
    (["--attn_impl", "xla"], ValueError, "'auto' only"),
    (["--mel_impl", "pallas_interpret"], ValueError, "'auto' only"),
    (["--mesh_fsdp", "2"], NotImplementedError, "ROADMAP queue 1 item 7"),
    (["--distributed"], NotImplementedError, "ROADMAP queue 1 item 7"),
    (["--toy_outliers", "4"], NotImplementedError, "outliers"),
])
def test_train_refusals(corpus, tmp_path, flags, error, match):
    with pytest.raises(error, match=match):
        train(_args(corpus, str(tmp_path / "x"), flags))


def test_train_refuses_hf_paths_and_the_host_without_a_card(corpus, tmp_path, monkeypatch):
    args = _args(corpus, str(tmp_path / "x"))
    args.toy_model = False
    with pytest.raises(NotImplementedError, match="hf_loader"):
        train(args)
    args = _args(corpus, str(tmp_path / "y"))
    args.platform = None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(args)


@pytest.mark.parametrize("argv", [
    [],
    ["--toy_model", "--remat", "--loss_chunk_size", "256", "--label_mode", "reference",
     "--splice_mode", "inplace", "--audio_placeholder", "1", "--max_steps", "7"],
    ["--config", "CONFIG_YAML", "--batch_size", "3"],
    ["--config", "CONFIG_JSON"],
])
def test_flags_and_config_files_parse_as_in_jax(tmp_path, argv):
    from audio_llama_tpu.training.train import parse_args as j_parse_args

    yaml_path = tmp_path / "c.yaml"
    yaml_path.write_text("batch_size: 5  # comment\nremat: true\nlearning_rate: 3e-4\n"
                         "splice_mode: 'inplace'\n")
    json_path = tmp_path / "c.json"
    json_path.write_text(json.dumps({"grad_accum_steps": 2, "no_lora": True}))
    argv = [{"CONFIG_YAML": str(yaml_path), "CONFIG_JSON": str(json_path)}.get(a, a)
            for a in argv]
    base = ["--data_path", "d.json", "--audio_dir", "a"]
    assert vars(parse_args(base + argv)) == vars(j_parse_args(base + argv))


def test_unknown_config_keys_are_refused(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"not_a_flag": 1}))
    with pytest.raises(ValueError, match="unknown config keys"):
        parse_args(["--data_path", "d", "--audio_dir", "a", "--config", str(path)])


def test_profile_steps_write_a_trace(corpus, tmp_path):
    out = str(tmp_path / "run")
    train(_args(corpus, out, ["--max_steps", "2", "--eval_steps", "0", "--profile_steps",
                              "0:1"]))
    assert os.path.getsize(os.path.join(out, "profile", "trace.json")) > 0
