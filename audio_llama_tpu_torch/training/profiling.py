"""Tracing and timed sections.

Counterpart of `audio_llama_tpu/training/profiling.py`:

    with trace("/tmp/trace"):              # torch.profiler, CPU + CUDA
        step(...)

    with timed_section("prefill", sync=True) as t:
        out = prefill(...)
    print(t.seconds)

The trainer's `--profile_steps N:M` traces global steps [N, M).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch

logger = logging.getLogger("audio_llama_tpu_torch")


def start_trace(log_dir: str):
    """Start a torch.profiler trace (CPU, and CUDA when a card is present);
    `stop_trace` writes it to log_dir as a Chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    prof.log_dir = log_dir
    return prof


def stop_trace(prof) -> str:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(prof.log_dir, exist_ok=True)
    path = os.path.join(prof.log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace of the block -> {log_dir}/trace.json."""
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof)


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.seconds: Optional[float] = None


@contextlib.contextmanager
def timed_section(name: str, sync: bool = False) -> Iterator[_Timer]:
    """Wall-clock a section. sync=True waits for the card at the exit
    (`torch.cuda.synchronize`), so the time covers the device work the
    section enqueued."""
    t = _Timer(name)
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        if sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        t.seconds = time.perf_counter() - t0
        logger.info("section %s: %.4fs", name, t.seconds)
