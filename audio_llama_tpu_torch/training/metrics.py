"""Logging and scalar sinks: file + stderr logging, JSONL, TensorBoard, wandb.

Counterpart of `audio_llama_tpu/training/metrics.py`: the JSONL scalar
stream is always written; TensorBoard and wandb are each gated and never
take training down when they are missing. `Throughput` gives windowed
tokens/s, audio-s/s and MFU; its peak is the H100's dense bf16 tensor-core
rate, 989 TFLOP/s (the same constant as `chip_smoke.H100_BF16_FLOPS`), where
the JAX package's is the TPU v5e's.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Optional

logger = logging.getLogger("audio_llama_tpu_torch")

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM


def setup_logging(output_dir: Optional[str] = None, level=logging.INFO) -> logging.Logger:
    """Root logger -> stderr + {output_dir}/training.log."""
    root = logging.getLogger()
    root.setLevel(level)
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
    if not any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler)
               for h in root.handlers):
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        root.addHandler(sh)
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.abspath(os.path.join(output_dir, "training.log"))
        if not any(isinstance(h, logging.FileHandler) and getattr(h, "baseFilename", "") == path
                   for h in root.handlers):
            fh = logging.FileHandler(path)
            fh.setFormatter(fmt)
            root.addHandler(fh)
    return logger


class MetricsWriter:
    """Fan-out scalar writer: JSONL (always) + TensorBoard + wandb (optional)."""

    def __init__(self, output_dir: str, use_tensorboard: bool = True, use_wandb: bool = False,
                 wandb_project: str = "audio-llm", wandb_config: Optional[dict] = None):
        os.makedirs(output_dir, exist_ok=True)
        self._jsonl = open(os.path.join(output_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(output_dir, "logs"))
            except Exception as e:  # optional sink
                logger.warning("tensorboard unavailable (%s); skipping", e)
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, config=wandb_config or {})
                self._wandb = wandb
            except Exception as e:  # optional sink
                logger.warning("wandb unavailable (%s); continuing without", e)

    def log(self, step: int, scalars: dict):
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(scalars, step=step)

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullWriter:
    """A MetricsWriter that writes nothing (a process that is not the
    coordinator of a multi-process run)."""

    def log(self, step: int, scalars: dict):
        pass

    def close(self):
        pass


class Throughput:
    """Windowed steps/s, tokens/s, audio-s/s and MFU (against `peak_flops`)."""

    def __init__(self, flops_per_step: float = 0.0, peak_flops: float = H100_BF16_FLOPS):
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0
        self._tokens = 0
        self._audio_sec = 0.0

    def update(self, steps: int = 1, tokens: int = 0, audio_sec: float = 0.0):
        self._steps += steps
        self._tokens += tokens
        self._audio_sec += audio_sec

    def window(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        out = {
            "steps_per_sec": self._steps / dt,
            "tokens_per_sec": self._tokens / dt,
            "audio_sec_per_sec": self._audio_sec / dt,
        }
        if self.flops_per_step:
            out["mfu"] = (self._steps * self.flops_per_step / dt) / self.peak_flops
        self.reset()
        return out
