"""Training CLI: projector + LoRA on a frozen Whisper and a frozen Llama.

Counterpart of `audio_llama_tpu/training/train.py`, with its flags: seeded
runs, AdamW with a cosine warm-up schedule (optax's arithmetic,
`training/optim.py`), gradient accumulation and clipping, periodic eval
(loss, perplexity) with best-model checkpoints, periodic and final
checkpoints in the JAX package's format, resume, JSONL / TensorBoard / wandb
scalars. It runs on one device: the card unless `--platform cpu`, where the
plain PyTorch versions of the kernels run.

    python -m audio_llama_tpu_torch.training.train --platform cpu --toy_model \\
        --tokenizer byte --data_path examples.json --audio_dir ./audio --num_epochs 1

`--synthetic_flagship` trains the published widths (Llama-3.2-3B,
Whisper-large-v3-turbo, LoRA r64) on seeded random frozen weights. Refused
with NotImplementedError: `--llama_path` / `--whisper_path` checkpoints (they
wait for `models/hf_loader.py`), `--toy_outliers` (`models/outliers.py`),
a mesh or several processes (`--mesh_dp`/`--mesh_fsdp`/`--mesh_tp` other
than 1 or auto, `--distributed`: ROADMAP queue 1 item 7) and an
`--attn_impl` / `--enc_attn_impl` / `--mel_impl` other than `auto` (the
kernels on the card, the plain versions on the host).
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import random
import sys
import time

import numpy as np
import torch

logger = logging.getLogger("audio_llama_tpu_torch")

MESH_QUEUE = "ROADMAP queue 1 item 7 (multi-device)"


def parse_args(argv=None):
    """The flags; `--config FILE` (JSON or flat YAML) supplies defaults that
    explicit flags override."""
    p = _build_parser()
    argv_list = list(argv if argv is not None else sys.argv[1:])
    if "--config" in argv_list:
        i = argv_list.index("--config")
        path = argv_list[i + 1]
        del argv_list[i:i + 2]
        p.set_defaults(**_load_config_file(path, p))
    return p.parse_args(argv_list)


def _load_config_file(path: str, parser) -> dict:
    import json

    with open(path) as f:
        text = f.read()
    try:
        data = json.loads(text)
    except ValueError:
        data = _parse_simple_yaml(text)
    unknown = set(data) - {a.dest for a in parser._actions}
    if unknown:
        raise ValueError(f"unknown config keys in {path}: {sorted(unknown)}")
    return data


def _parse_simple_yaml(text: str) -> dict:
    """Flat `key: value` YAML (no yaml dependency)."""
    out = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        k, v = line.split(":", 1)
        v = v.strip().strip("'\"")
        if v.lower() in ("true", "false"):
            out[k.strip()] = v.lower() == "true"
            continue
        for cast in (int, float):
            try:
                out[k.strip()] = cast(v)
                break
            except ValueError:
                pass
        else:
            out[k.strip()] = v
    return out


def _build_parser():
    p = argparse.ArgumentParser(description="Train AudioLLM (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default=None,
                   help="YAML/JSON file of flag defaults (CLI flags override)")
    p.add_argument("--llama_path", type=str, default="meta-llama/Llama-3.2-3B-Instruct")
    p.add_argument("--whisper_path", type=str, default="openai/whisper-large-v3-turbo")
    p.add_argument("--synthetic_flagship", action="store_true",
                   help="seeded random frozen weights at the published widths "
                        "(Llama-3.2-3B + whisper-large-v3-turbo), byte tokenizer by default")
    p.add_argument("--toy_model", action="store_true",
                   help="random tiny model + byte tokenizer (offline smoke/CI)")
    p.add_argument("--toy_outliers", type=float, default=0.0,
                   help="outlier-channel injection into the toy frozen weights (not ported)")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="'byte' or a local tokenizer path (default: llama_path)")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--audio_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./checkpoints")
    p.add_argument("--dataset_config", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--eval_batch_size", type=int, default=16)
    p.add_argument("--grad_accum_steps", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--weight_decay", type=float, default=0.01)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--max_grad_norm", type=float, default=2.0)
    p.add_argument("--lora_rank", type=int, default=64)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--no_lora", action="store_true", help="projector-only training")
    p.add_argument("--save_steps", type=int, default=50)
    p.add_argument("--eval_steps", type=int, default=100)
    p.add_argument("--log_steps", type=int, default=5)
    p.add_argument("--max_steps", type=int, default=0, help="0 = no cap")
    p.add_argument("--max_audio_length", type=int, default=30)
    p.add_argument("--text_max_length", type=int, default=512)
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--wandb_project", type=str, default="audio-llm")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--fp16", action="store_true",
                   help="accepted for reference-CLI compatibility; compute stays bf16")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--worker_processes", type=int, default=0,
                   help="build batches in N processes instead of threads")
    p.add_argument("--skip_missing_files", action="store_true")
    p.add_argument("--use_dummy_audio", action="store_true")
    p.add_argument("--mesh_dp", type=int, default=-1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--mesh_tp", type=int, default=1)
    p.add_argument("--resume_from", type=str, default=None)
    p.add_argument("--label_mode", type=str, default="concat", choices=["concat", "reference"])
    p.add_argument("--splice_mode", type=str, default="prepend", choices=["prepend", "inplace"])
    p.add_argument("--audio_placeholder", type=int, default=-1, choices=[-1, 0, 1],
                   help="insert '<audio></audio>' into audio prompts that lack one; "
                        "-1 = auto (on iff --splice_mode inplace)")
    p.add_argument("--max_samples", type=int, default=0, help="0 = all data")
    p.add_argument("--val_split", type=float, default=0.1)
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs the plain PyTorch versions on the host; the default is "
                        "the CUDA card")
    p.add_argument("--profile_steps", type=str, default=None, metavar="N:M",
                   help="torch.profiler trace over global steps [N, M) into "
                        "{output_dir}/profile")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection and a finite-loss check every step")
    p.add_argument("--remat", action="store_true",
                   help="recompute each decoder layer in the backward")
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=0)
    p.add_argument("--process_id", type=int, default=-1)
    p.add_argument("--loss_chunk_size", type=int, default=0,
                   help="cross-entropy in sequence chunks of this size without [B, T, V] "
                        "logits (256 at 3B / 128k vocab)")
    p.add_argument("--attn_impl", type=str, default="auto")
    p.add_argument("--enc_attn_impl", type=str, default="auto")
    p.add_argument("--mel_impl", type=str, default="auto")
    return p


def check_supported(args) -> None:
    """Refuse what the port does not run yet, before any work."""
    for flag in ("attn_impl", "enc_attn_impl", "mel_impl"):
        if getattr(args, flag) != "auto":
            raise ValueError(
                f"--{flag} {getattr(args, flag)!r}: the port takes 'auto' only (its kernels on "
                "the card, their plain versions on the host); the JAX package's A/B and "
                "interpret values have no counterpart here")
    if args.distributed or args.num_processes > 1:
        raise NotImplementedError(f"--distributed: multi-process training waits for {MESH_QUEUE}")
    if args.mesh_dp not in (-1, 1) or args.mesh_fsdp != 1 or args.mesh_tp not in (-1, 1):
        raise NotImplementedError(f"--mesh_dp/--mesh_fsdp/--mesh_tp: a device mesh waits for "
                                  f"{MESH_QUEUE}; one device runs with 1 (or -1 = auto)")
    if args.toy_outliers:
        raise NotImplementedError("--toy_outliers: models/outliers.py is not ported yet")
    if not (args.toy_model or args.synthetic_flagship):
        raise NotImplementedError(
            "--llama_path / --whisper_path: models/hf_loader.py is not ported yet and needs the "
            "checkpoints on disk; use --toy_model or --synthetic_flagship")


def set_seed(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def build_model_config(args, vocab_size: int):
    """The AudioLLMConfig of a toy or synthetic-flagship run (`vocab_size`:
    the tokenizer's, which sizes the toy model's table)."""
    from ..config import AudioLLMConfig, LlamaConfig, LoraConfig, MelConfig, WhisperConfig

    if args.toy_model:
        whisper_cfg = WhisperConfig.tiny()
        return AudioLLMConfig(
            llama=LlamaConfig.tiny(vocab_size=max(vocab_size, 384)),
            whisper=whisper_cfg,
            mel=MelConfig(num_mel_bins=whisper_cfg.num_mel_bins,
                          max_audio_seconds=min(args.max_audio_length, 1.28)),
            lora=None if args.no_lora else LoraConfig(rank=4, alpha=8),
            splice_mode=args.splice_mode,
        )
    return AudioLLMConfig(
        mel=MelConfig(num_mel_bins=128, max_audio_seconds=float(min(args.max_audio_length, 30))),
        lora=None if args.no_lora else LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha),
        splice_mode=args.splice_mode,
    )


def build_frozen(cfg, seed: int, device):
    """The seeded random frozen tree (bf16) of a toy or synthetic run: the
    trainer and a later inference load rebuild the same tree from the seed
    on the same kind of device."""
    from ..device import make_generator
    from ..models import allm

    return allm.init_frozen(cfg, make_generator(seed, device), torch.bfloat16)


def _to_batch(accum_group):
    """Stack collated host batches into an AudioLLMBatch of numpy arrays
    ([A, B, ...] when the group has more than one, else [B, ...])."""
    from ..models.allm import AudioLLMBatch

    def stack(key):
        arrs = [b[key] for b in accum_group]
        return np.stack(arrs) if len(arrs) > 1 else arrs[0]

    flags = [b["audio"] is not None for b in accum_group]
    if any(flags) and not all(flags):
        raise ValueError("accumulation group mixes audio and text-only microbatches")
    return AudioLLMBatch(
        input_ids=stack("input_ids"),
        attention_mask=stack("attention_mask"),
        audio_features=stack("audio") if flags[0] else None,
        labels=stack("labels"),
    )


def group_by_modality(batches, accum):
    """Accumulation groups of `accum` collated micro-batches, each all-audio
    or all-text (a mixed group would train audio rows without their audio);
    a ragged per-modality tail at the end of an epoch is dropped."""
    groups = {True: [], False: []}
    for np_batch in batches:
        g = groups[np_batch["audio"] is not None]
        g.append(np_batch)
        if len(g) == accum:
            yield _to_batch(g)
            g.clear()


def to_device(batch, device):
    """An AudioLLMBatch of numpy arrays -> tensors on `device`."""
    from ..models.allm import AudioLLMBatch

    return AudioLLMBatch(*(None if x is None else torch.from_numpy(np.asarray(x)).to(device)
                           for x in batch))


def _flops_per_step(cfg, tokens_per_micro, audio_frames, micros):
    """The JAX trainer's FLOPs per step for MFU: the encoder forward (2 x
    params x frames) and the decoder forward + backward (6 x params x
    tokens), leaving out attention and the unembedding."""
    lc, wc = cfg.llama, cfg.whisper
    n_llama = lc.num_layers * (lc.hidden_size * (lc.q_dim + 2 * lc.kv_dim)
                               + lc.q_dim * lc.hidden_size
                               + 3 * lc.hidden_size * lc.intermediate_size)
    n_whisper = wc.num_layers * (4 * wc.d_model ** 2 + 2 * wc.d_model * wc.ffn_dim)
    return (2 * n_whisper * audio_frames + 6 * n_llama * tokens_per_micro) * micros


def evaluate(eval_step, trainable, frozen, val_loader, device) -> dict:
    """Mean validation loss over the loader's batches, and its perplexity."""
    total, n = None, 0
    for np_batch in val_loader:
        loss = eval_step(trainable, frozen, to_device(_to_batch([np_batch]), device))
        total = loss if total is None else total + loss
        n += 1
    if n == 0:
        return {"eval/loss": float("nan"), "eval/perplexity": float("nan")}
    mean = float(total) / n
    return {"eval/loss": mean, "eval/perplexity": math.exp(min(mean, 30.0))}


def train(args) -> dict:
    """Run training; returns {"steps", "final_checkpoint", "step_seconds"
    (host wall time between the ends of consecutive steps, after their
    logging), the last train and eval scalars}."""
    from ..data.dataset import DatasetConfig
    from ..data.loader import create_dataloaders
    from ..data.tokenizer import load_tokenizer
    from ..device import make_generator, resolve_device
    from ..models import allm
    from . import checkpoint as ckpt
    from . import profiling
    from . import train_step as steps_mod
    from .metrics import MetricsWriter, Throughput, setup_logging
    from .optim import OptaxAdamW, cosine_schedule_with_warmup

    check_supported(args)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    set_seed(args.seed)
    setup_logging(args.output_dir)
    logger.info("device: %s", torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")

    tokenizer = load_tokenizer(args.tokenizer or "byte")
    cfg = build_model_config(args, tokenizer.vocab_size)
    frozen = build_frozen(cfg, args.seed, device)
    sid = tokenizer.token_to_id(cfg.audio_start_token)
    eid = tokenizer.token_to_id(cfg.audio_end_token)
    compute_dtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32

    ds_cfg = DatasetConfig(
        text_max_length=args.text_max_length,
        max_audio_seconds=cfg.mel.max_audio_seconds if args.toy_model
        else float(args.max_audio_length),
        label_mode=args.label_mode,
        skip_missing_files=args.skip_missing_files,
        use_dummy_audio_for_missing=args.use_dummy_audio,
        audio_placeholder=(args.splice_mode == "inplace") if args.audio_placeholder == -1
        else bool(args.audio_placeholder),
    )
    train_loader, val_loader, ds_cfg = create_dataloaders(
        args.data_path, args.audio_dir, tokenizer, batch_size=args.batch_size,
        val_split=args.val_split, seed=args.seed, num_workers=args.num_workers,
        dataset_config=ds_cfg, dataset_config_path=args.dataset_config,
        max_samples=args.max_samples or None, val_batch_size=args.eval_batch_size,
        worker_processes=args.worker_processes,
    )

    accum = max(1, args.grad_accum_steps)
    steps_per_epoch = max(len(train_loader) // accum, 1)
    total_steps = steps_per_epoch * args.num_epochs
    if args.max_steps:
        total_steps = min(total_steps, args.max_steps)
    schedule = cosine_schedule_with_warmup(args.learning_rate, args.warmup_steps, total_steps)

    trainable = allm.init_trainable(cfg, make_generator(args.seed + 1, device))
    state = steps_mod.init_train_state(trainable, lambda params: OptaxAdamW(
        params, schedule, weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm))
    logger.info("trainable params: %s", f"{allm.num_trainable_params(trainable):,}")

    start_step, start_epoch = 0, 0
    if args.resume_from:
        loaded, opt, start_step, start_epoch = ckpt.load_checkpoint(
            args.resume_from, trainable_template=trainable)
        with torch.no_grad():
            for p, q in zip(trainable.parameters(), loaded.parameters()):
                p.copy_(q)
        if opt is not None:
            state.optimizer.load_optax_state(trainable, opt)
        state = state._replace(step=start_step)
        logger.info("resumed from %s at step %d", args.resume_from, start_step)

    writer = MetricsWriter(args.output_dir, use_tensorboard=not args.no_tensorboard,
                           use_wandb=args.use_wandb, wandb_project=args.wandb_project,
                           wandb_config=vars(args))
    train_step = steps_mod.make_train_step(cfg, sid, eid, compute_dtype, accum_steps=accum,
                                           loss_chunk_size=args.loss_chunk_size,
                                           remat=args.remat)
    eval_step = steps_mod.make_eval_step(cfg, sid, eid, compute_dtype)

    n_windows = max(1, int(args.max_audio_length) // 30) if not args.toy_model else 1
    tokens_per_micro = args.batch_size * (args.text_max_length + n_windows * cfg.audio_seq_len + 2)
    tput = Throughput(flops_per_step=_flops_per_step(
        cfg, tokens_per_micro, args.batch_size * cfg.audio_seq_len, accum))

    def save(step, epoch, **kind):
        return ckpt.save_checkpoint(
            args.output_dir, trainable=state.trainable,
            opt_state=state.optimizer.optax_state(state.trainable), step=step, epoch=epoch,
            model_cfg=cfg, args=vars(args), dataset_config=ds_cfg.__dict__, **kind)

    profile_window = None
    if args.profile_steps:
        lo, hi = (int(x) for x in args.profile_steps.split(":"))
        profile_window = (lo, hi, os.path.join(args.output_dir, "profile"))
    prof = None

    best_eval = float("inf")
    global_step = start_step
    last_metrics, step_seconds = {}, []
    t_start = t_last = time.perf_counter()
    done = False
    for epoch in range(start_epoch, args.num_epochs):
        if done:
            break
        train_loader.set_epoch(epoch)
        for np_batch in group_by_modality(train_loader, accum):
            if profile_window is not None:
                lo, hi, pdir = profile_window
                if prof is None and global_step == lo:
                    prof = profiling.start_trace(pdir)
                elif prof is not None and global_step >= hi:
                    profiling.stop_trace(prof)
                    prof, profile_window = None, None
            batch = to_device(np_batch, device)
            state, metrics = train_step(state, frozen, batch)
            global_step += 1
            if args.debug_nans and not torch.isfinite(metrics["loss"]):
                raise FloatingPointError(f"non-finite loss at step {global_step}")
            tput.update(steps=1, tokens=tokens_per_micro * accum,
                        audio_sec=args.batch_size * accum * n_windows * cfg.mel.max_audio_seconds
                        if batch.audio_features is not None else 0.0)

            if global_step % args.log_steps == 0:
                loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
                lr = schedule(min(global_step, total_steps) - 1)
                scalars = {"train/loss": loss, "train/grad_norm": gnorm, "train/lr": lr,
                           "train/epoch": epoch,
                           **{f"perf/{k}": v for k, v in tput.window().items()}}
                writer.log(global_step, scalars)
                logger.info("step %d/%d epoch %d loss %.4f lr %.2e", global_step, total_steps,
                            epoch, loss, lr)
                last_metrics = scalars
            now = time.perf_counter()
            step_seconds.append(now - t_last)

            if args.eval_steps and global_step % args.eval_steps == 0 and len(val_loader):
                ev = evaluate(eval_step, state.trainable, frozen, val_loader, device)
                writer.log(global_step, ev)
                logger.info("eval @ %d: loss %.4f ppl %.4f", global_step, ev["eval/loss"],
                            ev["eval/perplexity"])
                last_metrics.update(ev)
                if ev["eval/loss"] < best_eval:
                    best_eval = ev["eval/loss"]
                    save(global_step, epoch, best=True)
            if args.save_steps and global_step % args.save_steps == 0:
                save(global_step, epoch)
            t_last = time.perf_counter()
            if args.max_steps and global_step >= args.max_steps:
                done = True
                break

    if prof is not None:
        profiling.stop_trace(prof)
    if len(val_loader):
        ev = evaluate(eval_step, state.trainable, frozen, val_loader, device)
        writer.log(global_step, ev)
        logger.info("final eval: loss %.4f ppl %.4f", ev["eval/loss"], ev["eval/perplexity"])
        last_metrics.update(ev)
    path = save(global_step, args.num_epochs - 1, final=True)
    writer.close()
    logger.info("done: %d steps in %.1fs; final checkpoint %s", global_step,
                time.perf_counter() - t_start, path)
    return {"steps": global_step, "final_checkpoint": path, "step_seconds": step_seconds,
            **last_metrics}


def main(argv=None):
    train(parse_args(argv))


if __name__ == "__main__":
    main()
