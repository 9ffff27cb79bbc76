"""Inference: model load, audio processing, generation, as a function and a CLI.

Counterpart of `audio_llama_tpu/inference/cli.py`, with the same flags:

    python -m audio_llama_tpu_torch.inference.cli --platform cpu --toy_model \\
        --tokenizer byte --audio a.wav --prompt "Transcribe:" --kv_quant --kv_bits 4

Audio is decoded, mixed down to mono, resampled to 16 kHz and padded or cut
to one 30 s window on the host; log-mel, the encoder and KV-cached decode
run on the device (the card unless `--platform cpu`). `--int4_decoder` and
`--int8_decoder` merge LoRA into the frozen Llama, rotate it with `--rotate`
(QuaRot, a rotation drawn from a generator seeded 7), then quantize it to
the fused int4 tree or the weight-only int8 tree. `--kv_quant` keeps an int8
KV cache, or int4 with `--kv_bits 4`. `--decode_impl` picks the decode
steps' attention kernel, as JAX's does: `auto` (the mono kernels, and at
B = 1 on the fused int4 tree with an int4 KV cache the whole-stack
megakernel), `decode_kernel` (the db kernels' normalized mode,
`csrc/decode_attention_db.cu`, any KV cache) or `decode_packed` (the
timeline-chunked kernel, `csrc/decode_attention_packed.cu`; bf16 or int8 KV
only: with `--kv_bits 4` it raises ValueError, as JAX's does). Either A/B
value keeps the megakernel off.

`--checkpoint_path` loads a trainer's checkpoint (either package's): the
model config from its `config.json`, the toy or synthetic frozen tree
rebuilt from the seed the trainer recorded (on the same kind of device the
trainer ran on: CPU and CUDA generators draw different numbers), and the
trained projector + LoRA.

Not ported yet, and refused with NotImplementedError: `--llama_path` /
`--whisper_path` (wait for models/hf_loader.py and checkpoints on disk) and
`--draft_llama_path` (queue 1 item 2, serving: speculative decoding).
"""

from __future__ import annotations

import argparse
import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger("audio_llama_tpu_torch")


def load_audio_llm(checkpoint_path: Optional[str], llama_path: Optional[str] = None,
                   whisper_path: Optional[str] = None, tokenizer: Optional[str] = None,
                   toy_model: bool = False, seed: int = 0, device=None):
    """-> (cfg, frozen, trainable, tokenizer): bf16 frozen and f32
    trainables. Without a checkpoint, the toy model (`AudioLLMConfig.tiny()`
    weights drawn from `seed`); with one, its config, the frozen tree of its
    toy or synthetic run rebuilt from the run's seed, and its trainables."""
    from ..config import AudioLLMConfig
    from ..data.tokenizer import load_tokenizer
    from ..device import make_generator
    from ..models import allm
    from ..training import checkpoint as ckpt
    from ..training.train import build_frozen

    meta = ckpt.load_metadata(checkpoint_path) if checkpoint_path else {}
    meta_args = meta.get("args", {})
    cfg = AudioLLMConfig.from_dict(meta["model_config"]) if meta.get("model_config") else None
    seeded_run = meta_args.get("toy_model") or meta_args.get("synthetic_flagship")
    small = cfg is not None and llama_path is None and cfg.llama.num_layers <= 4
    if not (toy_model or seeded_run or small):
        raise NotImplementedError(
            "--llama_path / --whisper_path: models/hf_loader.py is not ported yet and needs "
            "the checkpoints on disk (ROADMAP queue 1 item 6); use --toy_model or a "
            "checkpoint of a --toy_model / --synthetic_flagship run")
    if meta_args.get("toy_outliers"):
        raise NotImplementedError("the checkpoint's frozen tree has injected outliers: "
                                  "models/outliers.py is not ported yet")
    del whisper_path
    tk = load_tokenizer(tokenizer or "byte")
    cfg = cfg or AudioLLMConfig.tiny()
    frozen = build_frozen(cfg, meta_args.get("seed", seed), device)
    trainable = allm.init_trainable(cfg, make_generator(seed + 1, device), torch.float32)
    if checkpoint_path:
        trainable, _, step, _ = ckpt.load_checkpoint(checkpoint_path, trainable_template=trainable)
        logger.info("loaded checkpoint %s (step %d)", checkpoint_path, step)
    return cfg, frozen, trainable, tk


def process_audio(audio_path: str, mel_cfg) -> np.ndarray:
    """Decode -> mono -> resample to the config's rate -> pad or cut to one
    window. Returns the waveform [1, S] f32 (log-mel runs on the device)."""
    from ..data import audio_io

    audio = audio_io.load_audio(audio_path, target_sr=mel_cfg.sample_rate)
    S = mel_cfg.max_samples
    out = np.zeros(S, np.float32)
    n = min(len(audio), S)
    out[:n] = audio[:n]
    return out[None, :]


ROTATE_SEED = 7  # the JAX CLI rotates with PRNGKey(7)


def quantize_decoder(cfg, frozen, trainable, bits: int = 4, rotate: bool = False):
    """Merge LoRA into the frozen Llama, rotate it (QuaRot, a generator seeded
    ROTATE_SEED on the weights' device) when asked, then quantize it to the
    fused int4 tree (`models/llama_int4.py`, bits 4) or the weight-only int8
    tree (`models/llama_int8.py`, bits 8). Returns (frozen, trainable without
    LoRA)."""
    from ..bridge import ParamTree
    from ..models import llama_int4, llama_int8, llama_rotate, lora as lora_mod

    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    frozen = ParamTree(dict(frozen.items()))
    llama = frozen["llama"]
    if cfg.lora is not None and "lora" in trainable:
        llama = lora_mod.merge_into_llama(llama, lora_mod.with_scaling(trainable["lora"],
                                                                       cfg.lora))
        trainable = ParamTree({k: v for k, v in trainable.items() if k != "lora"})
    if rotate:  # LoRA is merged, so only the base tree rotates
        gen = torch.Generator(device=llama["embed"]["weight"].device)
        gen.manual_seed(ROTATE_SEED)
        llama = llama_rotate.rotate_llama(llama, cfg.llama, gen)
    if bits == 4:
        frozen["llama"] = llama_int4.quantize_llama_int4(llama)
    else:
        frozen["llama"] = llama_int8.quantize_llama(llama)
    return frozen, trainable


def generate_response(cfg, frozen, trainable, tokenizer, prompt: str,
                      audio_path: Optional[str] = None, max_new_tokens: int = 256,
                      temperature: float = 0.7, top_p: float = 0.9, top_k: int = 0,
                      greedy: bool = False, seed: int = 0, kv_quant=False, draft=None,
                      gamma: int = 4, decode_impl: str = "auto", device=None,
                      compute_dtype=torch.bfloat16, return_tokens: bool = False):
    """Tokenize the prompt, load the audio, generate, decode: exactly the
    new text. With `return_tokens`, (text, tokens [1, max_new_tokens])."""
    from ..device import make_generator, resolve_device
    from . import generate as gen

    if draft is not None:
        raise NotImplementedError(
            "speculative decoding is not ported yet (ROADMAP queue 1 item 2, serving)")
    del gamma
    dev = resolve_device(device)
    if audio_path and cfg.splice_mode == "inplace" and cfg.audio_start_token not in prompt:
        prompt = f"{cfg.audio_start_token}{cfg.audio_end_token} {prompt}"
    ids, mask = tokenizer.encode(prompt)
    audio = process_audio(audio_path, cfg.mel) if audio_path else None
    result = gen.generate(
        frozen, trainable, cfg, ids[None, :], mask[None, :], audio,
        None if greedy else make_generator(seed, dev),
        max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p, top_k=top_k,
        greedy=greedy, eos_id=tokenizer.eos_id, pad_id=tokenizer.pad_id,
        audio_start_id=tokenizer.token_to_id(cfg.audio_start_token),
        audio_end_id=tokenizer.token_to_id(cfg.audio_end_token),
        compute_dtype=compute_dtype, has_audio=audio is not None, kv_quant=kv_quant,
        device=dev, attn_impl=decode_impl,
    )
    tokens = result.tokens[0, : int(result.num_generated[0])].cpu().numpy()
    text = tokenizer.decode(tokens, skip_special_tokens=True)
    return (text, result.tokens) if return_tokens else text


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="AudioLLM inference (PyTorch/CUDA port)")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--llama_path", type=str, default=None)
    p.add_argument("--whisper_path", type=str, default=None)
    p.add_argument("--tokenizer", type=str, default=None)
    p.add_argument("--prompt", type=str, required=True)
    p.add_argument("--audio", type=str, default=None)
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--toy_model", action="store_true")
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu' runs the plain PyTorch versions on the host; the default "
                        "is the CUDA card")
    p.add_argument("--kv_quant", action="store_true",
                   help="quantized KV cache during generation (int8 rows; int4 with "
                        "--kv_bits 4)")
    p.add_argument("--kv_bits", type=int, default=8, choices=[8, 4],
                   help="KV-cache precision with --kv_quant: int8 rows or K/V-combined int4 "
                        "rows")
    p.add_argument("--int4_decoder", action="store_true",
                   help="weight-only int4 (W4A16) frozen decoder, LoRA merged first")
    p.add_argument("--rotate", action="store_true",
                   help="QuaRot residual-stream rotation before the decoder is quantized "
                        "(with --int4_decoder or --int8_decoder)")
    p.add_argument("--int8_decoder", action="store_true",
                   help="weight-only int8 (W8A16) frozen decoder, LoRA merged first")
    p.add_argument("--draft_llama_path", type=str, default=None,
                   help="speculative decoding draft model (not ported yet)")
    p.add_argument("--gamma", type=int, default=4)
    p.add_argument("--decode_impl", type=str, default="auto",
                   choices=["auto", "decode_kernel", "decode_packed"],
                   help="decode-step attention kernel: auto (the mono kernels; at B = 1 on "
                        "the fused int4 tree with an int4 KV cache, the whole-stack "
                        "megakernel), decode_kernel (the db kernels' normalized mode, any KV "
                        "cache) or decode_packed (the timeline-chunked kernel; bf16 or int8 "
                        "KV). Either A/B value keeps the megakernel off")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.draft_llama_path:
        raise NotImplementedError("--draft_llama_path: speculative decoding is not ported "
                                  "yet (ROADMAP queue 1 item 2, serving)")
    device = "cpu" if args.platform == "cpu" else None
    cfg, frozen, trainable, tk = load_audio_llm(
        args.checkpoint_path, llama_path=args.llama_path, whisper_path=args.whisper_path,
        tokenizer=args.tokenizer, toy_model=args.toy_model, seed=args.seed, device=device)
    if args.int4_decoder or args.int8_decoder:
        frozen, trainable = quantize_decoder(cfg, frozen, trainable,
                                             bits=4 if args.int4_decoder else 8,
                                             rotate=args.rotate)
    text = generate_response(
        cfg, frozen, trainable, tk, prompt=args.prompt, audio_path=args.audio,
        max_new_tokens=args.max_new_tokens, temperature=args.temperature, top_p=args.top_p,
        top_k=args.top_k, greedy=args.greedy, seed=args.seed,
        kv_quant=(4 if args.kv_bits == 4 else True) if args.kv_quant else False,
        decode_impl=args.decode_impl, device=device)
    print(text)
    return text


if __name__ == "__main__":
    main()
