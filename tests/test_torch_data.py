"""The port's dataset, collate and loaders against the JAX package's, on a
WAV corpus written here: the same arrays item for item (both label modes,
the placeholder option, cropped, padded, resampled, missing and text-only
entries) and the same batches in the same order from the seeded loaders
(threads and worker processes).
"""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.data import dataset as j_ds  # noqa: E402
from audio_llama_tpu.data import loader as j_loader  # noqa: E402
from audio_llama_tpu.data.audio_io import write_wav  # noqa: E402
from audio_llama_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer  # noqa: E402
from audio_llama_tpu_torch.data import dataset as ds  # noqa: E402
from audio_llama_tpu_torch.data import loader  # noqa: E402
from audio_llama_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402

SECONDS = 0.5  # max_audio_seconds: 8000 samples at 16 kHz


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Clips shorter and longer than the window, one stereo at 22.05 kHz,
    one under `audio/`, one missing file, one text-only entry."""
    root = tmp_path_factory.mktemp("data")
    audio = root / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    entries = []
    for i in range(10):
        n = int(16000 * (0.3 + 0.1 * i))
        write_wav(str(audio / f"c{i}.wav"), (rng.normal(size=n) * 0.1).astype(np.float32), 16000)
        entries.append({"text": f"Transcribe clip {i}" + (" <audio>" if i % 2 else ""),
                        "audio_paths": f"c{i}.wav", "response": f"clip {i} says {'ab' * i}"})
    stereo = (rng.normal(size=(11025, 2)) * 0.1).astype(np.float32)
    write_wav(str(audio / "stereo.wav"), stereo, 22050)
    entries.append({"text": "Stereo <audio>", "audio_paths": ["stereo.wav"], "response": "two"})
    entries.append({"text": "Nested", "audio_paths": "audio/c1.wav", "response": "prefixed"})
    entries.append({"text": "Missing", "audio_paths": "gone.wav", "response": "none"})
    entries.append({"text": "Text only question", "response": "text answer"})
    data_path = root / "examples.json"
    data_path.write_text(json.dumps(entries))
    return str(data_path), str(root), entries


def _cfgs(**kw):
    return (j_ds.DatasetConfig(max_audio_seconds=SECONDS, text_max_length=48, **kw),
            ds.DatasetConfig(max_audio_seconds=SECONDS, text_max_length=48, **kw))


def _item_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("label_mode", ["concat", "reference"])
@pytest.mark.parametrize("placeholder", [False, True])
def test_items_match_jax(corpus, label_mode, placeholder):
    _, root, entries = corpus
    jc, tc = _cfgs(label_mode=label_mode, audio_placeholder=placeholder)
    want = j_ds.AudioLLMDataset(entries, root, JByteTokenizer(), jc)
    got = ds.AudioLLMDataset(entries, root, ByteTokenizer(), tc)
    assert len(got) == len(want)
    for i in range(len(want)):
        _item_equal(got[i], want[i])
    assert got[len(entries) - 2]["audio"] is None  # the missing file
    assert got[len(entries) - 1]["audio"] is None  # text only


def test_missing_file_policies_match_jax(corpus):
    _, root, entries = corpus
    for kw in ({"skip_missing_files": True}, {"use_dummy_audio_for_missing": True}):
        jc, tc = _cfgs(**kw)
        want = j_ds.AudioLLMDataset(entries, root, JByteTokenizer(), jc)
        got = ds.AudioLLMDataset(entries, root, ByteTokenizer(), tc)
        assert len(got) == len(want)
        for i in range(len(want)):
            _item_equal(got[i], want[i])


@pytest.mark.parametrize("rows", [[0, 1, 2], [3, 12, 4], [13, 12], [13]])
def test_collate_matches_jax(corpus, rows):
    """Mixed, failed-audio and text-only batches (a failed row becomes a
    zero-loss copy of a good one)."""
    _, root, entries = corpus
    jc, tc = _cfgs()
    jd = j_ds.AudioLLMDataset(entries, root, JByteTokenizer(), jc)
    td = ds.AudioLLMDataset(entries, root, ByteTokenizer(), tc)
    want = j_ds.collate([jd[i] for i in rows])
    got = ds.collate([td[i] for i in rows])
    _item_equal(got, want)


def test_collate_refuses_an_empty_batch():
    with pytest.raises(ValueError, match="empty batch"):
        ds.collate([])


@pytest.mark.parametrize("kw", [dict(batch_size=3), dict(batch_size=2, val_batch_size=5),
                                dict(batch_size=4, max_samples=9, val_split=0.3)])
def test_dataloaders_match_jax(corpus, kw):
    data_path, root, _ = corpus
    jc, tc = _cfgs()
    jtrain, jval, _ = j_loader.create_dataloaders(data_path, root, JByteTokenizer(),
                                                  dataset_config=jc, num_workers=2, **kw)
    ttrain, tval, cfg = loader.create_dataloaders(data_path, root, ByteTokenizer(),
                                                  dataset_config=tc, num_workers=2, **kw)
    assert cfg is tc
    for jl, tl in ((jtrain, ttrain), (jval, tval)):
        assert len(tl) == len(jl) and tl.batch_size == jl.batch_size
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            tl.set_epoch(epoch)
            want, got = list(jl), list(tl)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                _item_equal(g, w)


def test_worker_processes_match_jax(corpus):
    """Batches built in spawned worker processes equal the JAX package's
    threaded loader's, batch for batch."""
    _, root, entries = corpus
    jc, tc = _cfgs()
    jd = j_ds.AudioLLMDataset(entries, root, JByteTokenizer(), jc)
    td = ds.AudioLLMDataset(entries, root, ByteTokenizer(), tc)
    want = list(j_loader.DataLoader(jd, 4, shuffle=True, seed=3, num_workers=2))
    got = list(loader.DataLoader(td, 4, shuffle=True, seed=3, worker_processes=2))
    assert len(got) == len(want) == len(entries) // 4
    for g, w in zip(got, want):
        _item_equal(g, w)


def test_dataset_config_key_mapping(corpus, tmp_path):
    _, root, entries = corpus
    renamed = [{"q": e.get("text"), "a": e.get("response"), "wav": e.get("audio_paths")}
               for e in entries]
    keymap = tmp_path / "dataset_config.json"
    keymap.write_text(json.dumps({"audio_key": "wav", "text_key": "q", "response_key": "a"}))
    data_path = tmp_path / "renamed.json"
    data_path.write_text(json.dumps({"examples": renamed}))
    jc, tc = _cfgs()
    jtrain, _, _ = j_loader.create_dataloaders(str(data_path), root, JByteTokenizer(),
                                               batch_size=2, dataset_config=jc,
                                               dataset_config_path=str(keymap))
    ttrain, _, cfg = loader.create_dataloaders(str(data_path), root, ByteTokenizer(),
                                               batch_size=2, dataset_config=tc,
                                               dataset_config_path=str(keymap))
    assert (cfg.audio_key, cfg.text_key, cfg.response_key) == ("wav", "q", "a")
    _item_equal(loader.get_sample_batch(ttrain), j_loader.get_sample_batch(jtrain))
    assert ds.DatasetConfig.from_json_file(str(keymap)).__dict__ == \
        j_ds.DatasetConfig.from_json_file(str(keymap)).__dict__
