"""The port's sharded trainer against the JAX package, on the CPU.

- Two sharded train steps of the dp2, tp2 and sp2 arms (a gloo world of 2
  CPU ranks) and of dp2 x tp2 and dp2 x sp2 (4 ranks; the rank side in
  `test_torch_shard_world.py`) against JAX's `make_sharded_train_step` on
  the 8-device CPU mesh of the same shape, from the same bridged weights
  and global batches: loss, grad norm (the clip norm summed over tp),
  trainables and Adam's first moments, gathered whole; the replicated
  trainables bit-equal on every rank after every step.
- `collate(force_audio=)` and the loader's process arm (dp row slices, the
  global modality vote, the refusals) against JAX's `collate` and
  `DataLoader(process_index=, process_count=)` on the same entries, batch
  for batch; the cases of `tests/test_distributed.py` among them.
- The trainer CLI with 2 processes (dp=2, then tp=2) in the same world:
  its final checkpoint against the single-process run's.
- The refusals: fsdp > 1, and sp together with tp.

Tolerance at f32: 1e-4 of the largest element (loss, grad norm and
trainables: the same arithmetic summed in other orders), 1e-3 for the
moments (as `test_torch_train.py`).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.config import AudioLLMConfig as JCfg  # noqa: E402
from audio_llama_tpu.data import dataset as j_ds  # noqa: E402
from audio_llama_tpu.data import loader as j_loader  # noqa: E402
from audio_llama_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from audio_llama_tpu.models import allm as j_allm  # noqa: E402
from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.parallel import MeshConfig as JMeshConfig  # noqa: E402
from audio_llama_tpu.parallel import init_sharded_state as j_init_sharded  # noqa: E402
from audio_llama_tpu.parallel import make_mesh as j_make_mesh  # noqa: E402
from audio_llama_tpu.parallel import make_sharded_train_step as j_make_step  # noqa: E402
from audio_llama_tpu.parallel import sharding as j_shd  # noqa: E402
from audio_llama_tpu.training import optim as j_optim  # noqa: E402
from audio_llama_tpu_torch.config import AudioLLMConfig  # noqa: E402
from audio_llama_tpu_torch.data.audio_io import write_wav  # noqa: E402
from audio_llama_tpu_torch.data.dataset import AudioLLMDataset, DatasetConfig, collate  # noqa: E402
from audio_llama_tpu_torch.data.loader import DataLoader  # noqa: E402
from audio_llama_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from audio_llama_tpu_torch.parallel import distributed, sharded_train  # noqa: E402
from audio_llama_tpu_torch.parallel import mesh as t_mesh  # noqa: E402
from audio_llama_tpu_torch.training import msgpack_io  # noqa: E402
from audio_llama_tpu_torch.training.train import parse_args, train  # noqa: E402

import test_torch_shard_world as ranks  # noqa: E402  (the rank side; no JAX)

JCFG, CFG = JCfg.tiny(), AudioLLMConfig.tiny()
SID, EID = JCFG.llama.vocab_size, JCFG.llama.vocab_size + 1
SCHEDULE = (1e-3, 1, 4)  # warm-up 1: step 1 moves only the moments, step 2 the weights
ARMS2 = [("dp2", (2, 1, 1)), ("tp2", (1, 2, 1)), ("sp2", (1, 1, 2))]
ARMS4 = [("dp2tp2", (2, 2, 1)), ("dp2sp2", (2, 1, 2))]


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale + 1e-9, (err, scale)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def trees():
    frozen = j_allm.init_frozen(JCFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    frozen["llama"] = j_llama.resize_embeddings(frozen["llama"], JCFG.llama.vocab_size + 2,
                                                JCFG.llama)
    trainable = j_allm.init_trainable(JCFG, jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    for br in trainable["lora"]["layers"].values():  # 'ref' init has a = 0
        br["a"] = jnp.asarray(rng.normal(size=br["a"].shape).astype(np.float32) * 0.1)
    return jax.tree.map(np.asarray, frozen), jax.tree.map(np.asarray, trainable)


def _batch(seed, B=4, T=12):
    """A global numpy batch: '<audio>' at position 3, labels on the second
    half, the last row right-padded; log-mel audio."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 500, (B, T)).astype(np.int32)
    ids[:, 3] = SID
    mask = np.ones((B, T), np.int32)
    mask[-1, T - 3:] = 0
    labels = np.where(np.arange(T) >= T // 2, ids, -100).astype(np.int32)
    labels[mask == 0] = -100
    mel = rng.normal(size=(B, CFG.whisper.num_mel_bins,
                           2 * CFG.whisper.max_source_positions)).astype(np.float32)
    return ids, mask, mel, labels


BATCHES = [_batch(10), _batch(11)]


# --- the CLI corpus -----------------------------------------------------------

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
    return str(data_path), str(audio_dir), root


def _argv(corpus, out, extra=()):
    data_path, audio_dir, _ = corpus
    return ["--data_path", data_path, "--audio_dir", audio_dir, "--output_dir", str(out),
            "--toy_model", "--tokenizer", "byte", "--platform", "cpu",
            "--batch_size", "2", "--eval_batch_size", "2", "--grad_accum_steps", "2",
            "--num_epochs", "1", "--log_steps", "1", "--eval_steps", "2", "--save_steps", "2",
            "--warmup_steps", "1", "--num_workers", "2", "--no_tensorboard",
            "--compute_dtype", "float32", *extra]


CLI_MESHES = {"dp2": ["--mesh_dp", "2"], "tp2": ["--mesh_dp", "1", "--mesh_tp", "2"]}


# --- the worlds -----------------------------------------------------------------

@pytest.fixture(scope="module")
def world2(trees, corpus):
    fz, tr = trees
    root = corpus[2]
    items = [("train_arms", (CFG.to_dict(), fz, tr, BATCHES, [(n, m, 1) for n, m in ARMS2],
                             SCHEDULE, SID, EID))]
    items += [("train_cli", (_argv(corpus, root / f"run_{name}", flags),))
              for name, flags in CLI_MESHES.items()]
    return distributed.spawn(ranks.jobs, 2, args=(items,), threads=1,
                             timeout=ranks.WORLD_TIMEOUT)


@pytest.fixture(scope="module")
def world4(trees):
    fz, tr = trees
    return distributed.spawn(ranks.train_arms, 4, args=(
        CFG.to_dict(), fz, tr, BATCHES, [(n, m, 1) for n, m in ARMS4], SCHEDULE, SID, EID),
        threads=1, timeout=ranks.WORLD_TIMEOUT)


def _arm(world2, world4, name):
    """[rank] -> that rank's steps of the arm."""
    if name in dict(ARMS2):
        return [r[0][name] for r in world2]
    return [r[name] for r in world4]


def _jax_steps(trees, shape):
    """JAX's sharded steps on the mesh of `shape` (dp, tp, sp): per step
    (loss, grad norm, trainables, mu)."""
    fz, tr = trees
    dp, tp, sp = shape
    mesh = j_make_mesh(JMeshConfig(dp=dp, fsdp=1, tp=tp, sp=sp),
                       devices=jax.devices()[:dp * tp * sp])
    opt = j_optim.make_optimizer(j_optim.cosine_schedule_with_warmup(*SCHEDULE),
                                 weight_decay=0.01, max_grad_norm=1.0)
    frozen = j_shd.shard_frozen(mesh, jax.tree.map(jnp.asarray, fz))
    state = j_init_sharded(mesh, jax.tree.map(jnp.asarray, tr), opt)
    batches = [j_allm.AudioLLMBatch(*(jnp.asarray(x) for x in b)) for b in BATCHES]
    step = j_make_step(JCFG, opt, mesh, batches[0], SID, EID, jnp.float32, donate_state=False)
    out = []
    for b in batches:
        state, m = step(state, frozen, b)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    jax.tree.map(np.asarray, state.trainable),
                    jax.tree.map(np.asarray, state.opt_state[1][0].mu)))
    return out


@pytest.fixture(scope="module")
def jax_steps(trees):
    """shape -> `_jax_steps` on it, each mesh shape run once."""
    return functools.lru_cache(maxsize=None)(functools.partial(_jax_steps, trees))


# --- the arms -------------------------------------------------------------------

@pytest.mark.parametrize("name,shape", ARMS2 + ARMS4, ids=[n for n, _ in ARMS2 + ARMS4])
def test_sharded_steps_match_jax(world2, world4, jax_steps, name, shape):
    got = _arm(world2, world4, name)[0]
    want = jax_steps(shape)
    assert len(got) == len(want) == 2
    for step, (g, (loss, gnorm, trainable, mu)) in enumerate(zip(got, want)):
        assert abs(g["loss"] - loss) <= 1e-4 * abs(loss), (step, g["loss"], loss)
        assert abs(g["grad_norm"] - gnorm) <= 1e-4 * abs(gnorm), (step, g["grad_norm"], gnorm)
        port = dict(_leaves(g["trainable"]))
        port_mu = dict(_leaves(g["mu"]))
        for path, leaf in jax.tree_util.tree_flatten_with_path(trainable)[0]:
            _close(port[".".join(p.key for p in path)], leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(mu)[0]:
            _close(port_mu[".".join(p.key for p in path)], leaf, rel=1e-3)


def test_replicated_trainables_stay_bit_equal_on_every_rank(world2, world4):
    for name, _ in ARMS2 + ARMS4:
        steps = _arm(world2, world4, name)
        for i in range(len(steps[0])):
            first = steps[0][i]["replicated"]
            assert first, name
            for other in steps[1:]:
                for leaf, t in other[i]["replicated"].items():
                    assert torch.equal(t, first[leaf]), (name, i, leaf)


def test_clip_norm_under_tp_is_the_whole_trees(world2, world4, jax_steps):
    """The tp ranks hold halves of the LoRA b (and down a) leaves; the norm
    that clips is still the whole tree's (JAX's), and the clip ran."""
    for name, shape in (("tp2", (1, 2, 1)), ("dp2tp2", (2, 2, 1))):
        for r, steps in enumerate(_arm(world2, world4, name)):
            for g, want in zip(steps, jax_steps(shape)):
                assert abs(g["grad_norm"] - want[1]) <= 1e-4 * want[1], (name, r)
                assert want[1] > 1.0  # max_grad_norm: the clip scaled the step


def test_refusals():
    fsdp = t_mesh.Mesh([("dp", 1), ("fsdp", 2), ("tp", 1), ("sp", 1)], rank=0)
    sp_tp = t_mesh.Mesh([("dp", 1), ("fsdp", 1), ("tp", 2), ("sp", 2)], rank=0)
    for mesh in (fsdp, sp_tp):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
            sharded_train.make_sharded_train_step(CFG, None, mesh, None, SID, EID)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 2"):
            sharded_train.make_sharded_eval_step(CFG, mesh, None, SID, EID)


@pytest.mark.parametrize("flag,value", [("attn_impl", "xla"), ("enc_attn_impl", "v2"),
                                        ("mel_impl", "pallas_interpret")])
def test_kernel_choice_flags_take_auto_only(flag, value):
    one = t_mesh.Mesh([("dp", 1), ("fsdp", 1), ("tp", 1), ("sp", 1)], rank=0)
    with pytest.raises(ValueError, match="'auto' only"):
        sharded_train.make_sharded_train_step(CFG, None, one, None, SID, EID, **{flag: value})
    with pytest.raises(ValueError, match="'auto' only"):
        sharded_train.make_sharded_eval_step(CFG, one, None, SID, EID, **{flag: value})


# --- the trainer CLI with 2 processes -----------------------------------------

@pytest.fixture(scope="module")
def single_cli(corpus):
    return train(parse_args(_argv(corpus, corpus[2] / "run_single")))


def _ckpt(path):
    with open(f"{path}/checkpoint.msgpack", "rb") as f:
        return msgpack_io.restore(f.read())


@pytest.mark.parametrize("mesh", list(CLI_MESHES))
def test_cli_two_processes_write_the_single_process_checkpoint(world2, single_cli, mesh):
    results = [r[1 + list(CLI_MESHES).index(mesh)] for r in world2]
    assert [r["steps"] for r in results] == [single_cli["steps"]] * 2
    assert results[1]["final_checkpoint"] is None  # only the coordinator writes
    got, want = _ckpt(results[0]["final_checkpoint"]), _ckpt(single_cli["final_checkpoint"])
    assert (got["step"], got["epoch"]) == (want["step"], want["epoch"])
    g_leaves = dict(_leaves(got["model"]["trainable"]))
    w_leaves = dict(_leaves(want["model"]["trainable"]))
    assert g_leaves.keys() == w_leaves.keys()
    for key, leaf in w_leaves.items():
        assert g_leaves[key].shape == leaf.shape and g_leaves[key].dtype == leaf.dtype
        _close(g_leaves[key], leaf)
    for moment in ("mu", "nu"):
        g_m = dict(_leaves(got["optimizer"]["1"]["0"][moment]))
        for key, leaf in _leaves(want["optimizer"]["1"]["0"][moment]):
            _close(g_m[key], leaf, rel=1e-3)


# --- collate(force_audio=) and the loader's process arm ----------------------

AUDIO_ROWS = (0, 1, 2, 3, 4)  # unshuffled, batches of 4: all audio, mixed, all text


def _datasets(tmp_path, audio_rows=AUDIO_ROWS, n=12):
    """The port's and JAX's datasets over the same entries: entry i has a
    clip when i is in `audio_rows`."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir(exist_ok=True)
    rng = np.random.RandomState(0)
    entries = []
    for i in range(n):
        e = {"text": f"say {i}", "response": f"resp {i}"}
        if i in audio_rows:
            rel = f"c{i}.wav"
            write_wav(str(audio_dir / rel), (rng.randn(1600) * 0.05).astype(np.float32), 16000)
            e["audio_paths"] = rel
        entries.append(e)
    kw = dict(text_max_length=16, max_audio_seconds=0.32)
    return (AudioLLMDataset(entries, str(audio_dir), ByteTokenizer(), DatasetConfig(**kw)),
            j_ds.AudioLLMDataset(entries, str(audio_dir), JByteTokenizer(),
                                 j_ds.DatasetConfig(**kw)))


def _same_batch(got, want):
    """input_ids, attention_mask, labels, audio (or None) and metadata equal."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert isinstance(got[key], np.ndarray) and got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w)
        else:
            assert got[key] == w, key


def _loaders(td, jd, **kw):
    return DataLoader(td, 4, num_workers=1, **kw), j_loader.DataLoader(jd, 4, num_workers=1, **kw)


def test_loader_process_shards_cover_the_global_batch(tmp_path):
    td, _ = _datasets(tmp_path, audio_rows=range(12))
    full = DataLoader(td, 4, shuffle=True, seed=7, num_workers=1)
    shards = [DataLoader(td, 4, shuffle=True, seed=7, num_workers=1, process_index=i,
                         process_count=2) for i in (0, 1)]
    for epoch in (0, 1):
        for loader in (full, *shards):
            loader.set_epoch(epoch)
        for g, a, b in zip(list(full), *[list(s) for s in shards]):
            np.testing.assert_array_equal(np.concatenate([a["input_ids"], b["input_ids"]]),
                                          g["input_ids"])
            assert a["input_ids"].shape[0] == 2


@pytest.mark.parametrize("process_count", [2, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_process_arm_matches_jax(tmp_path, process_count, shuffle):
    """Every rank's batches equal JAX's `DataLoader(process_index=,
    process_count=)`'s, batch for batch over two epochs: all-audio, mixed
    (some local slices all text) and all-text global batches."""
    td, jd = _datasets(tmp_path)
    for index in range(process_count):
        got, want = _loaders(td, jd, shuffle=shuffle, seed=7, process_index=index,
                             process_count=process_count)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            g_batches, w_batches = list(got), list(want)
            assert len(g_batches) == len(w_batches) == 3
            for g, w in zip(g_batches, w_batches):
                _same_batch(g, w)


def test_loader_modality_vote_is_global(tmp_path):
    """A mixed batch whose local slice is all text still builds an audio
    batch on that rank (zero audio, -100 labels): every rank runs the
    encoder and the same collectives. An all-text batch stays text-only on
    every rank. Each as JAX's loader builds it."""
    td, jd = _datasets(tmp_path)
    for index in (0, 1):
        got, want = _loaders(td, jd, process_index=index, process_count=2)
        g_batches = list(got)
        for g, w in zip(g_batches, want):
            _same_batch(g, w)
        all_audio, mixed, text = g_batches
        assert all_audio["audio"].any(axis=1).all() and text["audio"] is None
        assert mixed["audio"] is not None and mixed["audio"].shape == all_audio["audio"].shape
    # rank 1's slice of the mixed batch (entries 6 and 7) has no clip
    assert not mixed["audio"].any() and (mixed["labels"] == -100).all()


def test_loader_rejects_indivisible_and_ragged(tmp_path):
    td, jd = _datasets(tmp_path)
    for make, ds in ((DataLoader, td), (j_loader.DataLoader, jd)):
        with pytest.raises(ValueError, match="divisible"):
            make(ds, 3, process_index=0, process_count=2)
        with pytest.raises(ValueError, match="drop_last"):
            make(ds, 4, drop_last=False, process_index=0, process_count=2)


@pytest.mark.parametrize("rows,force", [
    ([6, 7], True), ([6, 7], False), ([6, 7], None), ([4, 5], True), ([4, 5], None),
    ([0, 1], True)], ids=["text-forced", "text-unforced", "text", "mixed-forced", "mixed",
                          "audio-forced"])
def test_collate_force_audio_matches_jax(tmp_path, rows, force):
    """The zero-audio filler rows (audio_samples long, -100 labels), a
    mixed slice's copies of its clip row and the text-only batch, as JAX's
    `collate(force_audio=)` builds them."""
    td, jd = _datasets(tmp_path)
    kw = {} if force is None else dict(force_audio=force, audio_samples=td.cfg.max_samples)
    _same_batch(collate([td[i] for i in rows], **kw), j_ds.collate([jd[i] for i in rows], **kw))


def test_collate_force_audio(tmp_path):
    td, jd = _datasets(tmp_path)
    text_rows = [td[6], td[7]]
    forced = collate(text_rows, force_audio=True, audio_samples=td.cfg.max_samples)
    assert forced["audio"].shape == (2, td.cfg.max_samples) and not forced["audio"].any()
    assert (forced["labels"] == -100).all()
    assert collate(text_rows, force_audio=False)["audio"] is None
    for coll, ds in ((collate, td), (j_ds.collate, jd)):
        with pytest.raises(ValueError, match="force_audio=False"):
            coll([ds[4], ds[5]], force_audio=False)
        with pytest.raises(ValueError, match="audio_samples"):
            coll([ds[6], ds[7]], force_audio=True)
