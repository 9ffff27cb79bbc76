"""Logit KL between two frozen trees: the distribution-level quantization
measure.

Counterpart of `audio_llama_tpu/eval/kl.py`. Greedy transcripts (WER) move
only once an error crosses a decision boundary; the KL of a quantized tree's
next-token distribution against the unquantized one's measures the shift
directly. Both logit tensors come from the port's `models/allm.forward`
(teacher-forced, the batch's own tokens), so a quantized tree on the card
runs its kernels there: an int4 tree's W4A16 products at its scale group.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models import allm


@torch.no_grad()
def batch_logit_kl(
    cfg,
    frozen_ref,
    frozen_test,
    trainable,
    batch: allm.AudioLLMBatch,
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype=torch.float32,
    trainable_test: Optional[dict] = None,
) -> dict:
    """Teacher-forced mean and max KL(ref || test) over the batch's
    loss-masked (response) positions -> {'kl_mean', 'kl_max',
    'n_positions'}. The batch's tensors live on the trees' device.

    trainable_test: the overlay to pair with frozen_test where it differs
    from the reference's (a QuaRot-rotated tree needs its rotated LoRA,
    `models/llama_rotate.rotate_lora`).

    Each f32 logits tensor is B x T x V (3.3 GB at B 4, T ~1600 and the
    3B vocabulary): each becomes its log-softmax in place of the raw
    logits, and the KL is summed one row at a time."""

    def log_probs(frozen, tr):
        _, logits = allm.forward(frozen, tr, cfg, batch, audio_start_id, audio_end_id,
                                 compute_dtype=compute_dtype)
        return torch.log_softmax(logits.float(), dim=-1)

    pa = log_probs(frozen_ref, trainable)
    pb = log_probs(frozen_test, trainable if trainable_test is None else trainable_test)
    per_pos = torch.stack([(pa[b].exp() * (pa[b] - pb[b])).sum(-1) for b in range(pa.shape[0])])
    del pa, pb
    # forward pads the labels with -100 for the audio block: the logits
    # cover the combined timeline, so the label mask aligns to its end
    T = per_pos.shape[1]
    mask = batch.labels.to(per_pos.device) != allm.IGNORE_INDEX
    if mask.shape[1] != T:
        mask = torch.nn.functional.pad(mask.to(torch.int32), (T - mask.shape[1], 0)).bool()
    per_pos = torch.where(mask, per_pos, torch.zeros_like(per_pos))
    n = max(int(mask.sum()), 1)
    return {
        "kl_mean": float(per_pos.sum() / n),
        "kl_max": float(per_pos.max()),
        "n_positions": n,
    }
