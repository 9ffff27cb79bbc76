"""KV-cached autoregressive generation.

Counterpart of `audio_llama_tpu/inference/generate.py::generate`: build the
<audio>+text embedding prefix, prefill a fresh static-shape KV cache, then
decode one token per step with temperature/top-p/top-k sampling and EOS
latching; exactly the new tokens come back. The decode loop is a Python
loop; positions, cache offsets and the done flags stay on the device, so a
step needs no host sync.

Multi-process generation (`parallel/`), as the JAX package's `shard_map`
entry points: every rank of a world calls the function `make_dp_generate`,
`make_tp_generate` or `parallel.make_sp_generate` returned with the same
full inputs; each runs `_generate_impl` on its shard (its dp rows, its tp
block of the decoder, its sp window of the KV cache) and every rank returns
the whole `GenerateResult` (the dp rows gathered).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..bridge import ParamTree
from ..config import AudioLLMConfig
from ..device import DeviceLike, resolve_device
from ..models import allm
from ..models import llama as llama_mod
from ..models import lora as lora_mod
from ..models import projector as proj_mod
from ..ops import sampling
from ..parallel import collectives


class GenerateResult(NamedTuple):
    tokens: torch.Tensor  # [B, max_new_tokens] int32, pad_id after EOS
    num_generated: torch.Tensor  # [B] int32, tokens up to and incl. EOS


def build_prefix(
    frozen: ParamTree,
    trainable: Optional[ParamTree],
    cfg: AudioLLMConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    audio_features: Optional[torch.Tensor],
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype=torch.bfloat16,
):
    """(embeds, mask) for the prompt (+ optional audio), laid out by
    cfg.splice_mode ('prepend' or 'inplace')."""
    if audio_features is None:
        return llama_mod.embed_tokens(frozen["llama"], input_ids, compute_dtype), attention_mask
    enc = allm.process_audio_features(frozen, cfg, audio_features, compute_dtype)
    audio_embeds = proj_mod.project(trainable["projector"], enc, compute_dtype)
    if cfg.splice_mode == "inplace":
        text = llama_mod.embed_tokens(frozen["llama"], input_ids, compute_dtype)
        embeds, mask, _ = allm.splice_inplace(
            text, audio_embeds, input_ids, attention_mask, None, audio_start_id
        )
        return embeds, mask
    return allm.combine_text_and_audio_embeddings(
        frozen, trainable, cfg, input_ids, attention_mask, audio_embeds,
        audio_start_id, audio_end_id, compute_dtype,
    )


class Prefilled(NamedTuple):
    lora: Optional[dict]  # the LoRA branches with their scaling, or None
    cache: "llama_mod.KVCache"  # filled with the prefix
    full_mask: torch.Tensor  # [B, P + max_new_tokens] the timeline mask
    real_len: torch.Tensor  # [B] int32 real prefix lengths
    next_logits: torch.Tensor  # [B, V] f32 at each row's last real position


@torch.no_grad()
def prefill(frozen, trainable, cfg: AudioLLMConfig, input_ids, attention_mask, audio_features,
            dev, *, max_new_tokens: int, compute_dtype, kv_quant, audio_start_id: int,
            audio_end_id: int, tp_axis=None, sp_axis=None) -> Prefilled:
    """The prefix (`build_prefix`) into a fresh KV cache sized for
    max_new_tokens more slots, and the next-token logits. Under `tp_axis`
    the decoder tree is this rank's tp block and the cache holds
    num_kv_heads / tp heads; under `sp_axis` it holds ceil(total / sp)
    slots of the timeline (models/llama.py)."""
    lora = None
    if trainable is not None and "lora" in trainable and cfg.lora is not None:
        lora = lora_mod.with_scaling(trainable["lora"], cfg.lora)
    embeds, mask = build_prefix(
        frozen, trainable, cfg, input_ids, attention_mask, audio_features,
        audio_start_id, audio_end_id, compute_dtype,
    )
    B, P, _ = embeds.shape
    total = P + max_new_tokens
    full_mask = torch.cat(
        [mask.to(torch.int32), torch.ones((B, max_new_tokens), dtype=torch.int32, device=dev)],
        dim=1,
    )
    sp, tp = collectives.axis_size(sp_axis), collectives.axis_size(tp_axis)
    cache = llama_mod.KVCache.zeros(cfg.llama, B, -(-total // sp), dtype=compute_dtype,
                                    device=dev, kv_heads=cfg.llama.num_kv_heads // tp,
                                    quantized=kv_quant)
    _, cache, hidden = llama_mod.llama_forward(
        frozen["llama"], cfg.llama,
        # sp prefill attends the fresh tokens: the prompt mask; the timeline
        # mask is for the decode steps
        inputs_embeds=embeds, attention_mask=mask if sp_axis is not None else full_mask,
        kv_cache=cache, lora=lora,
        compute_dtype=compute_dtype, assume_fresh_cache=True,
        return_hidden=True, unembed_logits=False, tp_axis=tp_axis, sp_axis=sp_axis,
    )
    # each row's last real position holds its next-token state
    real_len = mask.sum(dim=1).to(torch.int32)  # [B]
    idx = (real_len - 1).long()[:, None, None].expand(B, 1, hidden.shape[-1])
    last_hidden = torch.gather(hidden, 1, idx)
    next_logits = llama_mod.unembed_with_tp(frozen["llama"], cfg.llama, last_hidden,
                                            compute_dtype, tp_axis)[:, 0]
    return Prefilled(lora, cache, full_mask, real_len, next_logits)


@torch.no_grad()
def _generate_impl(
    frozen: ParamTree,
    trainable: Optional[ParamTree],
    cfg: AudioLLMConfig,
    input_ids: torch.Tensor,  # [B, T] int64 on dev
    attention_mask: torch.Tensor,  # [B, T] int32 on dev
    audio_features: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
    dev: torch.device,
    *,
    max_new_tokens: int,
    temperature: float,
    top_p: float,
    top_k: int,
    greedy: bool,
    eos_id: int,
    pad_id: int,
    audio_start_id: int,
    audio_end_id: int,
    compute_dtype,
    kv_quant,
    megakernel: bool,
    attn_impl: str = "auto",
    tp_axis=None,
    sp_axis=None,
) -> GenerateResult:
    """The generation program of one rank (or of the single device): the
    prefill, then the decode loop (see `prefill` for the axes)."""
    lora, cache, full_mask, real_len, next_logits = prefill(
        frozen, trainable, cfg, input_ids, attention_mask, audio_features, dev,
        max_new_tokens=max_new_tokens, compute_dtype=compute_dtype, kv_quant=kv_quant,
        audio_start_id=audio_start_id, audio_end_id=audio_end_id, tp_axis=tp_axis,
        sp_axis=sp_axis)

    def sample(logits):
        return sampling.sample_token(
            logits, generator, temperature=temperature, top_p=top_p, top_k=top_k,
            greedy=greedy,
        )

    tok = sample(next_logits)
    done = tok == eos_id
    out = [tok]
    for i in range(max_new_tokens - 1):
        # RoPE position: real prompt length + tokens generated so far (pad
        # slots do not advance positions; the cache mask is slot-causal)
        positions = (real_len + i)[:, None]
        step_logits, cache = llama_mod.llama_forward(
            frozen["llama"], cfg.llama,
            input_ids=tok[:, None], attention_mask=full_mask, positions=positions,
            kv_cache=cache, lora=lora, compute_dtype=compute_dtype, megakernel=megakernel,
            # the decode steps' kernel choice only; the prefill stays auto
            attn_impl=attn_impl, tp_axis=tp_axis, sp_axis=sp_axis,
        )
        nxt = sample(step_logits[:, 0])
        nxt = torch.where(done, torch.full_like(nxt, pad_id), nxt)
        done = done | (nxt == eos_id)
        tok = nxt
        out.append(nxt)
    tokens = torch.stack(out, dim=1)

    hit = tokens == eos_id
    first = hit.to(torch.int32).argmax(dim=1)
    num = torch.where(hit.any(dim=1), first + 1, torch.full_like(first, max_new_tokens))
    return GenerateResult(tokens=tokens, num_generated=num.to(torch.int32))


def _inputs(frozen, input_ids, attention_mask, audio_features, device, has_audio):
    """-> (dev, ids int64, mask int32, audio or None) on the requested device,
    where the weights must be."""
    dev = resolve_device(device)
    weights_dev = frozen["llama"]["embed"]["weight"].device
    if weights_dev.type != dev.type:
        raise ValueError(f"weights are on {weights_dev}, generation asked for {dev}")
    input_ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
    attention_mask = torch.as_tensor(attention_mask, device=dev).to(torch.int32)
    if not has_audio:
        audio_features = None
    if audio_features is not None:
        audio_features = torch.as_tensor(audio_features, device=dev)
    return dev, input_ids, attention_mask, audio_features


@torch.no_grad()
def generate(
    frozen: ParamTree,
    trainable: Optional[ParamTree],
    cfg: AudioLLMConfig,
    input_ids,  # [B, T] (right-padded)
    attention_mask,  # [B, T]
    audio_features=None,  # [B, S] waveform, [B, n_mels, F] log-mel, or None
    generator: Optional[torch.Generator] = None,
    *,
    max_new_tokens: int = 256,
    temperature: float = 0.7,
    top_p: float = 0.9,
    top_k: int = 0,
    greedy: bool = False,
    eos_id: int = 2,
    pad_id: int = 0,
    audio_start_id: int = 0,
    audio_end_id: int = 0,
    compute_dtype=torch.bfloat16,
    has_audio: bool = True,
    kv_quant=False,
    device: DeviceLike = None,
    megakernel: bool = True,
    attn_impl: str = "auto",
) -> GenerateResult:
    """Sampling defaults mirror the reference CLI (temperature 0.7, top_p
    0.9, 256 new tokens). Runs on `device` (the card unless the caller asks
    for the CPU), where the weights must already be. Sampling draws from
    `generator`, which must live on that device.

    kv_quant: False (a compute-dtype cache), True or 8 (int8 rows with
    per-row scales, decoded by the int8-KV kernel) or 4 (K/V-combined int4
    rows, decoded by the int4-KV kernel, or at B = 1 on the fused int4 tree
    by the decode megakernel; `megakernel=False` keeps those steps on the
    per-layer kernels).

    attn_impl: the decode steps' attention kernel (the inference CLI's
    `--decode_impl`): 'auto' (the mono kernels and the megakernel),
    'decode_kernel' (the db kernels' normalized mode) or 'decode_packed'
    (the timeline-chunked kernel; no int4 KV cache); the prefill stays
    'auto' (`models/llama.py`)."""
    if not greedy and generator is None:
        raise ValueError("sampling needs an explicit torch.Generator")
    dev, input_ids, attention_mask, audio_features = _inputs(
        frozen, input_ids, attention_mask, audio_features, device, has_audio)
    return _generate_impl(
        frozen, trainable, cfg, input_ids, attention_mask, audio_features, generator, dev,
        max_new_tokens=max_new_tokens, temperature=temperature, top_p=top_p, top_k=top_k,
        greedy=greedy, eos_id=eos_id, pad_id=pad_id, audio_start_id=audio_start_id,
        audio_end_id=audio_end_id, compute_dtype=compute_dtype, kv_quant=kv_quant,
        megakernel=megakernel, attn_impl=attn_impl,
    )


# the keyword arguments of the sharded entry points, with generate's defaults
_STATIC = dict(
    max_new_tokens=256, temperature=0.7, top_p=0.9, top_k=0, greedy=False, eos_id=2, pad_id=0,
    audio_start_id=0, audio_end_id=0, compute_dtype=torch.bfloat16, has_audio=True,
    kv_quant=False, device=None, megakernel=True, attn_impl="auto",
)


def fold_seed(seed: int, index: int) -> int:
    """The sampling seed of dp rank group `index` (the JAX package folds the
    shard index into the key, `jax.random.fold_in`)."""
    return (seed * 1_000_003 + index * 7_919 + 1) % (2 ** 63)


def sharded_generate_fn(cfg: AudioLLMConfig, mesh, static_kw: dict, tp_axis=None,
                        sp_axis=None, prepare=None):
    """fn(frozen, trainable, input_ids, attention_mask, audio=None, seed=0)
    -> the whole GenerateResult on every rank of `mesh`: this rank's dp rows
    (the batch split over a 'dp' axis when the mesh has one) through
    `_generate_impl` with the given axes, sampling from a generator seeded
    by `fold_seed(seed, dp index)`, the rows gathered back over dp.
    `prepare(frozen, trainable)` -> this rank's trees (tp blocks)."""
    unknown = set(static_kw) - set(_STATIC)
    if unknown:
        raise TypeError(f"unknown generation arguments {sorted(unknown)}")
    kw = dict(_STATIC, **static_kw)
    has_audio, device = kw.pop("has_audio"), kw.pop("device")
    dp_axis = mesh.axis("dp") if "dp" in mesh.shape else None

    def fn(frozen, trainable, input_ids, attention_mask, audio=None, seed: int = 0):
        if prepare is not None:
            frozen, trainable = prepare(frozen, trainable)
        dev, ids, mask, audio = _inputs(frozen, input_ids, attention_mask, audio, device,
                                        has_audio)
        dp, i = collectives.axis_size(dp_axis), collectives.axis_index(dp_axis)
        B = ids.shape[0]
        if B % dp:
            raise ValueError(f"dp={dp} must divide the batch ({B} rows)")
        rows = slice(i * (B // dp), (i + 1) * (B // dp))
        gen = None
        if not kw["greedy"]:
            gen = torch.Generator(device=dev)
            gen.manual_seed(fold_seed(seed, i))
        out = _generate_impl(
            frozen, trainable, cfg, ids[rows], mask[rows],
            None if audio is None else audio[rows], gen, dev,
            tp_axis=tp_axis, sp_axis=sp_axis, **kw)
        return GenerateResult(*(collectives.all_gather(t, dp_axis, dim=0) for t in out))

    return fn


def make_dp_generate(cfg: AudioLLMConfig, mesh, **static_kw):
    """Data-parallel generation over the mesh's 'dp' axis: the weights whole
    on every rank, the batch split (dp must divide it), each rank's rows
    through the single-device program. Returns fn(frozen, trainable,
    input_ids, attention_mask, audio=None, seed=0); every rank of the mesh
    calls it with the same full inputs. `static_kw`: `generate`'s keyword
    arguments, `device` included (the card unless "cpu")."""
    if mesh.shape.get("fsdp", 1) != 1 or mesh.shape.get("tp", 1) != 1:
        raise ValueError("make_dp_generate shards over 'dp' only; use a dp-only mesh for "
                         "generation")
    return sharded_generate_fn(cfg, mesh, static_kw)


def _check_int4_layout(frozen, tp: int) -> None:
    """An int4 tree must be packed after the shard for THIS tp
    (quantize_llama_int4(..., tp=tp, fuse=False)): the canonical packing
    pairs output column j with j + N/2, which a tp shard would split."""
    lyr = frozen["llama"]["layers"]
    if "qkv_proj" in lyr:
        raise ValueError(f"fused int4 tree (quantize_llama_int4 fuse=True) is tp=1 only; "
                         f"quantize with tp={tp}, fuse=False for make_tp_generate")
    w = lyr["q_proj"]
    if not (isinstance(w, ParamTree) and "w_p" in w):
        return
    p = w["w_p"]
    if p.dim() != 4 or p.shape[2] != tp:
        got = p.shape[2] if p.dim() == 4 else 1
        raise ValueError(f"make_tp_generate(tp={tp}) needs an int4 tree quantized with "
                         f"quantize_llama_int4(..., tp={tp}); this one was packed for tp={got}")
    dw = lyr["down_proj"]
    K = dw["w_p"].shape[1]
    g = K // dw["w_s"].shape[1]
    if K % tp or (K // tp) % g:
        raise ValueError(f"int4 row-parallel scales misalign: need group ({g}) | K/tp ({K}/{tp})")


def make_tp_generate(cfg: AudioLLMConfig, mesh, **static_kw):
    """Tensor-parallel generation over the mesh's 'tp' axis (with the batch
    over 'dp' on top): each rank runs the decoder on its Megatron block
    (num_heads / tp heads, intermediate_size / tp MLP columns; the two
    row-parallel outputs summed over tp), the encoder and projector whole.
    Needs tp | num_heads and num_kv_heads and fsdp = 1. Returns
    fn(frozen, trainable, input_ids, attention_mask, audio=None, seed=0)
    taking the full trees; each call cuts this rank's block. An int4 tree
    must be the unfused one packed for this tp."""
    from ..parallel import sharding as shd

    tp = mesh.shape["tp"]
    if cfg.llama.num_kv_heads % tp or cfg.llama.num_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.llama.num_heads} and "
                         f"num_kv_heads={cfg.llama.num_kv_heads}")
    if mesh.shape.get("fsdp", 1) != 1:
        raise ValueError("make_tp_generate needs fsdp=1: the fsdp axis shards weight "
                         "contraction dims, which generation keeps whole")
    tp_axis = mesh.axis("tp")

    def prepare(frozen, trainable):
        _check_int4_layout(frozen, tp)
        return (shd.shard_frozen_for_generation(mesh, frozen),
                shd.shard_trainable(trainable, tp_axis))

    return sharded_generate_fn(cfg, mesh, static_kw, tp_axis=tp_axis, prepare=prepare)
