"""Batches from the dataset: a seeded, prefetching loader.

Counterpart of `audio_llama_tpu/data/loader.py`: `create_dataloaders`
loads the JSON, shuffles it with the seed, splits off `val_split` for
validation and wraps both halves in `DataLoader`s. A `DataLoader` builds
batches in a thread pool (the FLAC decoder releases the GIL) or, with
`worker_processes`, in a pool of spawned processes that receive the dataset
once per worker, and yields them in order with a bounded prefetch.

The process arm (a sharded trainer, `process_index` / `process_count` =
this rank's dp coordinate and the dp size, not its world rank: tp and sp
peers load the same rows): every rank computes the same seeded global
batch index lists and loads only its contiguous batch_size / process_count
rows; the batch's modality comes from a vote over the GLOBAL batch's
metadata, so a rank whose rows are all text still builds an audio batch
(zero-audio, -100 rows) when its peers run the encoder, and the ranks'
collectives stay in step.
"""

from __future__ import annotations

import json
import logging
import multiprocessing
import random
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Tuple

from .dataset import AudioLLMDataset, DatasetConfig, collate

logger = logging.getLogger(__name__)

# Per-process dataset of a ProcessPoolExecutor worker: the dataset is
# pickled ONCE per worker (initializer), not once per task.
_WORKER_DATASET: Optional[AudioLLMDataset] = None


def _pool_init(dataset: AudioLLMDataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _pool_build(batch_idx: List[int], force_audio: Optional[bool] = None) -> Dict[str, Any]:
    ds = _WORKER_DATASET
    if ds is None:
        raise RuntimeError("worker pool not initialized")
    return _collate(ds, batch_idx, force_audio)


def _collate(ds: AudioLLMDataset, idx: List[int], force_audio: Optional[bool]):
    if force_audio is None:
        return collate([ds[i] for i in idx])
    return collate([ds[i] for i in idx], force_audio=force_audio,
                   audio_samples=ds.cfg.max_samples)


class DataLoader:
    """Map-style loader with in-order prefetch (threads or worker processes)."""

    def __init__(
        self,
        dataset: AudioLLMDataset,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 42,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 4,
        worker_processes: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        """process_index / process_count: see the module docstring;
        batch_size stays the GLOBAL batch size."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.worker_processes = max(0, worker_processes)
        if self.worker_processes:
            # keep every pool process busy: at least one in-flight batch each
            self.prefetch = max(self.prefetch, self.worker_processes)
        self._epoch = 0
        self.process_index = process_index
        self.process_count = max(1, process_count)
        if self.process_count > 1:
            if batch_size % self.process_count:
                raise ValueError(f"global batch_size {batch_size} must be divisible by "
                                 f"process_count {self.process_count}")
            if not drop_last:
                raise ValueError("multi-process loading requires drop_last=True (ragged "
                                 "final batches cannot be split evenly across ranks)")

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _batches(self) -> List[List[int]]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        out = []
        for i in range(0, len(idx), self.batch_size):
            b = idx[i : i + self.batch_size]
            if len(b) < self.batch_size and self.drop_last:
                continue
            out.append(b)
        return out

    def _local(self, batch_idx: List[int]):
        """(this rank's indices, the modality vote or None)."""
        if self.process_count == 1:
            return batch_idx, None
        # a metadata-only vote over the GLOBAL batch: every rank agrees
        force_audio = any(self.dataset.entry_has_audio(i) for i in batch_idx)
        lbs = self.batch_size // self.process_count
        return batch_idx[self.process_index * lbs:(self.process_index + 1) * lbs], force_audio

    def _build(self, batch_idx: List[int]) -> Dict[str, Any]:
        return _collate(self.dataset, *self._local(batch_idx))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        batches = self._batches()
        if self.worker_processes:
            # spawned, not forked: this process runs threads (PyTorch's)
            pool = ProcessPoolExecutor(
                max_workers=self.worker_processes,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_pool_init,
                initargs=(self.dataset,),
            )
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
        with pool as ex:
            def submit(batch_idx):
                if self.worker_processes:
                    return ex.submit(_pool_build, *self._local(batch_idx))
                return ex.submit(self._build, batch_idx)

            inflight = [submit(b) for b in batches[: self.prefetch]]
            for i in range(len(batches)):
                fut = inflight.pop(0)
                if i + self.prefetch < len(batches):
                    inflight.append(submit(batches[i + self.prefetch]))
                yield fut.result()


def create_dataloaders(
    data_path: str,
    audio_dir: str,
    tokenizer,
    batch_size: int = 8,
    val_split: float = 0.1,
    seed: int = 42,
    num_workers: int = 4,
    dataset_config: Optional[DatasetConfig] = None,
    dataset_config_path: Optional[str] = None,
    max_samples: Optional[int] = None,
    val_batch_size: Optional[int] = None,
    worker_processes: int = 0,
    process_index: int = 0,
    process_count: int = 1,
) -> Tuple[DataLoader, DataLoader, DatasetConfig]:
    """JSON -> (train_loader, val_loader, dataset_config).

    Matches the reference semantics (src/dataloaders.py:10-113): seeded
    shuffle, (1-val_split)/val_split split, train shuffled / val not. The key
    mapping from dataset_config.json IS honored here (reference bug fixed).
    """
    cfg = dataset_config if dataset_config is not None else DatasetConfig()
    if dataset_config_path:
        # The file's key mapping wins over the object's defaults — the
        # trainer passes both (object = shape/policy flags, file = keymap
        # produced by the corpus builder; reference src/get_librispeech.py:
        # 319-333). Ignoring the file when an object is present would
        # recreate the reference's ignored-keymap bug.
        file_cfg = DatasetConfig.from_json_file(dataset_config_path)
        cfg.audio_key = file_cfg.audio_key
        cfg.text_key = file_cfg.text_key
        cfg.response_key = file_cfg.response_key

    with open(data_path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "examples" in data:
        data = data["examples"]
    if max_samples:
        data = data[:max_samples]

    rng = random.Random(seed)
    rng.shuffle(data)
    n_val = max(1, int(len(data) * val_split)) if len(data) > 1 else 0
    val_entries = data[:n_val]
    train_entries = data[n_val:]
    logger.info(
        "dataset: %d train / %d val entries", len(train_entries), len(val_entries)
    )

    train_ds = AudioLLMDataset(train_entries, audio_dir, tokenizer, cfg)
    val_ds = AudioLLMDataset(val_entries, audio_dir, tokenizer, cfg)
    shards = dict(process_index=process_index, process_count=process_count)
    train = DataLoader(
        train_ds, batch_size, shuffle=True, seed=seed, drop_last=True,
        num_workers=num_workers, worker_processes=worker_processes, **shards,
    )
    # Static-shape eval: clamp to the dataset and drop ragged tails only
    # when at least one full batch exists.
    vbs = min(val_batch_size or batch_size, max(len(val_ds), 1))
    if process_count > 1:  # global val batches must split evenly across ranks
        vbs = max(vbs - vbs % process_count, process_count)
    val = DataLoader(
        val_ds, vbs, shuffle=False, seed=seed,
        drop_last=len(val_ds) >= vbs or process_count > 1,
        num_workers=num_workers, worker_processes=worker_processes, **shards,
    )
    return train, val, cfg


def get_sample_batch(loader: DataLoader) -> Dict[str, Any]:
    """First batch (debug helper; reference src/dataloaders.py:115-126)."""
    return next(iter(loader))
