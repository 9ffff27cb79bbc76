"""Llama-3.x decoder with a static KV cache.

Counterpart of `audio_llama_tpu/models/llama.py`, unquantized trees, one
device (no tensor or sequence parallelism). Parameters keep the JAX tree:
stacked `[L, ...]` layer leaves, linear weights `[in, out]` (forward is
`x @ w`); the decoder body is a Python loop over the layer index.

Three call shapes, as `generate` uses them:
  - no cache: full causal self-attention over T positions (the causal
    kernel, `ops/causal_attention.py`);
  - fresh-cache prefill (`assume_fresh_cache=True`, T > 1): the T new K/V
    rows are written into the cache at slot 0 and attention runs over the
    fresh tokens with the causal kernel;
  - T == 1 decode: the decode kernel (`ops/decode_attention_mono.py`)
    appends the new row IN PLACE at the cache offset (`cache.length`, or
    per-row `cache_offsets` [B]) and attends the slots `<= offset` that the
    attention mask allows.
The cache tensors are updated in place (PyTorch's counterpart of the JAX
package's aliased scan carry); the returned `KVCache` holds the same tensors
with the new length.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..bridge import ParamTree
from ..config import LlamaConfig
from ..ops.causal_attention import causal_mha
from ..ops.decode_attention_mono import decode_attention_mono
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_for_config, rope_tables

LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def init_params(cfg: LlamaConfig, generator: torch.Generator, dtype=torch.float32) -> ParamTree:
    """Random init on the generator's device: the JAX init's tree and scales
    (N(0, fan_in^-1/2) linears, N(0, 0.02) embedding, unit norms)."""
    D, Fd, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    Hq, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device

    def normal(shape, std):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def dense(shape):
        return normal(shape, shape[-2] ** -0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    tree = {
        "embed": {"weight": normal((cfg.vocab_size, D), 0.02)},
        "layers": {
            "input_ln": ones(L, D),
            "post_attn_ln": ones(L, D),
            "q_proj": dense((L, D, Hq * hd)),
            "k_proj": dense((L, D, Hkv * hd)),
            "v_proj": dense((L, D, Hkv * hd)),
            "o_proj": dense((L, Hq * hd, D)),
            "gate_proj": dense((L, D, Fd)),
            "up_proj": dense((L, D, Fd)),
            "down_proj": dense((L, Fd, D)),
        },
        "final_ln": ones(D),
    }
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = dense((D, cfg.vocab_size))
    return ParamTree(tree)


def resize_embeddings(params: ParamTree, new_vocab: int, cfg: LlamaConfig) -> ParamTree:
    """Grow the embedding table (and an untied lm_head) for added special
    tokens; new rows are the mean of the existing rows (deterministic)."""
    emb = params["embed"]["weight"]
    old_vocab = emb.shape[0]
    if new_vocab <= old_vocab:
        return params
    n_new = new_vocab - old_vocab
    tree = params.to_dict()
    mean_row = emb.float().mean(dim=0, keepdim=True).to(emb.dtype)
    tree["embed"] = {"weight": torch.cat([emb.data, mean_row.expand(n_new, -1)], dim=0)}
    if "lm_head" in params:
        head = params["lm_head"]
        mean_col = head.float().mean(dim=1, keepdim=True).to(head.dtype)
        tree["lm_head"] = torch.cat([head.data, mean_col.expand(-1, n_new)], dim=1)
    return ParamTree(tree)


class KVCache(NamedTuple):
    """Static-shape KV cache. k/v: [L, B, Hkv, max_len, hd] (each (batch,
    head) timeline a contiguous [max_len, hd] slab); length: int32 [] on the
    cache's device, the current fill."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def rounded_len(max_len: int) -> int:
        """Timeline slots after the 32-slot rounding `zeros` applies."""
        return -(-max_len // 32) * 32

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
              device=None, kv_heads: Optional[int] = None) -> "KVCache":
        max_len = cls.rounded_len(max_len)
        heads = kv_heads if kv_heads is not None else cfg.num_kv_heads
        shape = (cfg.num_layers, batch, heads, max_len, cfg.head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            length=torch.zeros((), dtype=torch.int32, device=device),
        )


def embed_tokens(params: ParamTree, input_ids: torch.Tensor, compute_dtype=torch.bfloat16):
    return params["embed"]["weight"][input_ids.long()].to(compute_dtype)


def unembed(params: ParamTree, cfg: LlamaConfig, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Hidden states -> vocab logits (tied or untied head), returned in f32.
    The product runs in compute_dtype, so bf16 logits are bf16-rounded."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        w = params["embed"]["weight"].to(compute_dtype)  # [V, D]
        return (x.to(compute_dtype) @ w.t()).float()
    return (x.to(compute_dtype) @ params["lm_head"].to(compute_dtype)).float()


def _linear(x, w, lora_branch, compute_dtype):
    """x @ w, plus the LoRA delta x @ a @ b * scaling when given."""
    y = x @ w.to(compute_dtype)
    if lora_branch is not None:
        a, b, scaling = lora_branch
        y = y + (x @ a.to(compute_dtype)) @ b.to(compute_dtype) * scaling
    return y


@torch.no_grad()
def llama_forward(
    params: ParamTree,
    cfg: LlamaConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,  # [B, T]
    inputs_embeds: Optional[torch.Tensor] = None,  # [B, T, D]
    attention_mask: Optional[torch.Tensor] = None,  # [B, T_total] 1 = attend
    positions: Optional[torch.Tensor] = None,  # [B, T]
    kv_cache: Optional[KVCache] = None,
    cache_offsets: Optional[torch.Tensor] = None,  # [B] int32 per-row offsets
    lora: Optional[dict] = None,
    compute_dtype=torch.bfloat16,
    return_hidden: bool = False,
    assume_fresh_cache: bool = False,
    unembed_logits: bool = True,
):
    """Decoder forward. Without a cache returns (logits [B, T, V], None);
    with one, (logits, cache). `return_hidden` appends the final-norm hidden
    states; `unembed_logits=False` returns None for the logits (a caller that
    needs only some positions unembeds them itself)."""
    cd = compute_dtype
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, cd)
    x = inputs_embeds.to(cd)
    B, T, _ = x.shape
    dev = x.device

    if cache_offsets is not None:
        if kv_cache is None:
            raise ValueError("cache_offsets requires kv_cache")
        if assume_fresh_cache:
            raise ValueError("cache_offsets contradicts assume_fresh_cache")
    fresh = kv_cache is not None and assume_fresh_cache and T > 1
    decode = kv_cache is not None and T == 1
    if kv_cache is not None and not (fresh or decode):
        raise NotImplementedError(
            "cached forward supports a fresh-cache prefill or T == 1 decode steps"
        )
    if kv_cache is not None:
        offset = kv_cache.length if cache_offsets is None else cache_offsets
        offset = offset.to(device=dev, dtype=torch.int32)
        Tk = kv_cache.k.shape[3]
        if attention_mask is not None and attention_mask.shape[1] < Tk:
            attention_mask = F.pad(attention_mask, (0, Tk - attention_mask.shape[1]))
        off_col = offset.reshape(-1, 1)  # [1|B, 1]
    else:
        offset = None
        off_col = torch.zeros((1, 1), dtype=torch.int32, device=dev)

    if positions is None:
        positions = torch.arange(T, device=dev)[None, :] + off_col
    cos, sin = rope_tables(positions, rope_for_config(cfg))  # [1|B, T, hd]

    valid = None
    if decode:
        # slot-causal validity over the cache timeline, times the mask;
        # shared by every layer of this step
        valid = (torch.arange(Tk, device=dev)[None, :] <= off_col).to(torch.int32)
        valid = valid.expand(B, Tk)
        if attention_mask is not None:
            valid = valid * attention_mask.to(torch.int32)
    attn_mask = attention_mask
    if fresh and attn_mask is not None:
        attn_mask = attn_mask[:, :T]

    lp = params["layers"]
    lora_layers = lora["layers"] if lora is not None else None
    scale = cfg.head_dim ** -0.5
    eps = cfg.rms_norm_eps
    ck = kv_cache.k if kv_cache is not None else None
    cv = kv_cache.v if kv_cache is not None else None

    for li in range(cfg.num_layers):
        def lb(name):
            if lora_layers is None or name not in lora_layers:
                return None
            br = lora_layers[name]
            return (br["a"][li], br["b"][li], lora["scaling"])

        h = rms_norm(x, lp["input_ln"][li].to(cd), eps)
        q = _linear(h, lp["q_proj"][li], lb("q_proj"), cd).view(B, T, -1, cfg.head_dim)
        k = _linear(h, lp["k_proj"][li], lb("k_proj"), cd).view(B, T, -1, cfg.head_dim)
        v = _linear(h, lp["v_proj"][li], lb("v_proj"), cd).view(B, T, -1, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if decode:
            attn, ck, cv = decode_attention_mono(
                q[:, 0], k[:, 0], v[:, 0], ck, cv, li, offset, valid, scale
            )
            attn = attn[:, None]
        else:
            if fresh:  # in place: the fresh rows fill slots [0, T)
                ck[li, :, :, :T] = k.transpose(1, 2).to(ck.dtype)
                cv[li, :, :, :T] = v.transpose(1, 2).to(cv.dtype)
            attn = causal_mha(q, k, v, mask=attn_mask, scale=scale)
        attn = _linear(attn.reshape(B, T, -1), lp["o_proj"][li], lb("o_proj"), cd)
        x = x + attn

        h = rms_norm(x, lp["post_attn_ln"][li].to(cd), eps)
        g = _linear(h, lp["gate_proj"][li], lb("gate_proj"), cd)
        u = _linear(h, lp["up_proj"][li], lb("up_proj"), cd)
        x = x + _linear(F.silu(g) * u, lp["down_proj"][li], lb("down_proj"), cd)

    x = rms_norm(x, params["final_ln"].to(cd), eps)
    logits = unembed(params, cfg, x, cd) if unembed_logits else None

    new_cache = None
    if kv_cache is not None:
        if cache_offsets is None:
            new_len = offset + T
        else:
            new_len = offset.max() + T  # upper bound; the caller tracks rows
        new_cache = KVCache(k=ck, v=cv, length=new_len.to(torch.int32))
    if return_hidden:
        return logits, new_cache, x
    return logits, new_cache
