"""Llama-3.x decoder with a static KV cache.

Counterpart of `audio_llama_tpu/models/llama.py`, for full-precision trees,
the weight-only int8 tree of `models/llama_int8.py` and the int4 trees of
`models/llama_int4.py` (fused, unfused, or packed after a tensor-parallel
shard), rotated (`models/llama_rotate.py`) or not. Parameters keep the JAX tree:
stacked `[L, ...]` layer leaves, linear weights `[in, out]` (forward is
`x @ w`); the decoder body is a Python loop over the layer index. A rotated
tree carries its rotation as `params["rot"]`: the stream is rotated once
after the embedding and un-rotated once before the final norm (the QuaRot
sandwich).

Three call shapes, as `generate` uses them:
  - no cache: full causal self-attention over T positions (the causal
    kernel, `ops/causal_attention.py`);
  - fresh-cache prefill (`assume_fresh_cache=True`, T > 1): the T new K/V
    rows are written into the cache at slot 0 (quantized to int8 or int4
    rows on a quantized cache) and attention runs over the fresh tokens with
    the causal kernel;
  - T == 1 decode: the decode kernel (`ops/decode_attention_mono.py`, the
    bf16, int8-KV or int4-KV one) appends the new row IN PLACE at the cache
    offset (`cache.length`, or per-row `cache_offsets` [B]) and attends the
    slots `<= offset` that the attention mask allows.
The cache tensors are updated in place (PyTorch's counterpart of the JAX
package's aliased scan carry); the returned `KVCache` holds the same tensors
with the new length.

Inside a process world (`parallel/`), as the JAX package's code inside
`shard_map`:
  - `tp_axis` (a `parallel.mesh.MeshAxis`): the tree is this rank's
    Megatron block (`parallel/sharding.py`): head counts follow the local
    shapes, the row-parallel o and down outputs are summed over the axis
    (`collectives.psum`) and an untied lm_head's vocab columns gathered;
  - `sp_axis`: the cache holds this rank's window of the timeline (global
    slots [index * S, (index + 1) * S)). A fresh prefill attends the fresh
    tokens and stores the window's rows; a T == 1 step appends the row on
    the rank that owns its slot, and every rank computes flash statistics
    over its slab with the stats kernels (`ops/decode_attention_db.py`),
    merged across the axis by `ops.attention.merge_partial_stats`. The
    owner and the local slot come from the cache's host-side fill
    (`KVCache.host_length`), so a step adds no device sync.
  - training under `tp_axis` (no cache): the collectives are differentiable,
    as GSPMD's are in the JAX trainer: Megatron's f (`collectives.copy_to`:
    identity forward, psum of the cotangent) at the input of the
    column-parallel q/k/v/gate/up products and g (`reduce_from`: psum
    forward, identity backward) after the row-parallel o/down ones. A LoRA
    branch of a column target takes f after its replicated `a` product (the
    input of its sharded `b`); a row target's whole `b` takes f, since the
    branch's output is a partial sum until g. Tied embeddings stay whole;
    an untied lm_head's vocab shards are gathered by `gather_from`.
  - training under `seq_axis` (no cache): the inputs are this rank's slice
    of the sequence, tokens [index * T, (index + 1) * T) of the caller's
    tile-padded rows; RoPE positions are global (arange(T) + index * T), and
    causal attention runs as the kernel ring (`parallel/ring_kernel.py`)
    over the axis. Everything else is token-parallel.

Training differentiates the no-cache call: `llama_forward` keeps autograd on
(`generate` turns it off for itself), the causal kernel's backward kernels
serve attention, and `remat=True` runs each layer under
`torch.utils.checkpoint`, so its activations are recomputed in the backward
(the causal forward kernel then runs twice per layer). `token_nll_sum` and
`nll_sum_from_hidden` (sequence chunks under `torch.utils.checkpoint`, no
[B, T, V] logits) give the summed NLL and count of the JAX package's two
cross-entropies; the caller shifts the targets (`models/allm.py`).

On an int4 tree every projection runs the W4A16 kernel
(`ops/int4_matmul.py`): on the fused tree q|k|v as one slab read as two
column planes, o, and for more than 64 rows gate|up then down; on the
unfused tree each of the seven projections (a tp-packed slab's block axis,
a singleton inside the shard, squeezed first). Up to 64 rows with no LoRA
on the MLP, the fused int4 MLP kernel (`ops/mlp_int4.py`) runs the whole
MLP. A single-token step of one request (B * T == 1) on a fused int4 tree
with an int4 KV cache and no LoRA runs the whole layer stack as one launch
of the decode megakernel (`ops/decode_megakernel.py`) where its gate
`ok_for` passes; `megakernel=False` takes the per-layer kernels instead (the
JAX package's MEGA_DECODE=0). On an int8 tree the projections are
`(x @ w_q) * w_s` in the compute dtype, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..bridge import ParamTree
from ..config import LlamaConfig
from ..ops import int4_matmul as i4
from ..ops import mlp_int4 as mlp4
from ..ops import decode_attention_db as db
from ..ops import decode_megakernel as mk
from ..ops.attention import merge_partial_stats
from ..ops.causal_attention import causal_mha
from ..ops.decode_attention_mono import (decode_attention_mono, decode_attention_quantized4_mono,
                                         decode_attention_quantized_mono)
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_for_config, rope_tables
from ..parallel import collectives
from ..parallel.ring_kernel import ring_causal_mha_kernel

LINEAR_NAMES = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
ROW_PARALLEL = ("o_proj", "down_proj")  # tensor parallelism shards their input dim


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
    cache's device, the current fill.

    int8 mode (`zeros(quantized=True)` or 8): `k` and `v` are int8 slabs
    (`quantize_kv_rows`). int4 mode (`zeros(quantized=4)`): `k` is ONE
    K/V-combined int8 slab (byte d of a row: K's dim d offset-binary in the
    low nibble, V's signed in the high nibble, `quantize_kv_rows4`) and `v`
    is None. Both keep per-row scales in k_scale / v_scale [L, B, Hkv,
    max_len] f32.

    host_length: the fill as a Python int where the host knows it (None
    otherwise); the megakernel's gate reads it instead of syncing on
    `length`."""

    k: torch.Tensor
    v: Optional[torch.Tensor]
    length: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    host_length: Optional[int] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def kv_bits(self) -> int:
        if not self.quantized:
            return 16
        return 4 if self.v is None else 8

    @staticmethod
    def rounded_len(max_len: int) -> int:
        """Timeline slots after the 32-slot rounding `zeros` applies."""
        return -(-max_len // 32) * 32

    @classmethod
    def zeros(cls, cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
              device=None, kv_heads: Optional[int] = None, quantized=False) -> "KVCache":
        """quantized: False (store `dtype`), True or 8 (int8 rows) or 4 (the
        combined int4 rows)."""
        max_len = cls.rounded_len(max_len)
        heads = kv_heads if kv_heads is not None else cfg.num_kv_heads
        shape = (cfg.num_layers, batch, heads, max_len, cfg.head_dim)
        length = torch.zeros((), dtype=torch.int32, device=device)
        if quantized is not False and quantized not in (True, 4, 8):
            raise ValueError(f"quantized must be False, True, 8 or 4; got {quantized!r}")
        if quantized is False:
            return cls(
                k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                length=length, host_length=0,
            )
        return cls(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=None if quantized == 4 else torch.zeros(shape, dtype=torch.int8, device=device),
            length=length,
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            host_length=0,
        )


def quantize_kv_rows(x: torch.Tensor):
    """[..., hd] -> (int8 [..., hd], f32 scales [...]): symmetric per-row
    absmax / 127."""
    xf = x.to(torch.float32)
    scale = i4.absmax_scale(xf.abs().amax(dim=-1), 127.0)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_kv_rows4(k: torch.Tensor, v: torch.Tensor):
    """(k, v) [..., hd] -> (combined packed int8 [..., hd], k_scale f32 [...],
    v_scale f32 [...]): symmetric per-row absmax / 7 for each; byte d holds
    K's dim d offset-binary (k + 8) in the low nibble and V's signed in the
    high nibble."""
    def q4(x):
        xf = x.to(torch.float32)
        scale = i4.absmax_scale(xf.abs().amax(dim=-1), 7.0)
        q = torch.clamp(torch.round(xf / scale[..., None]), -7, 7).to(torch.int32)
        return q, scale

    kq, ks = q4(k)
    vq, vs = q4(v)
    packed = (((kq + 8) & 0xF) | ((vq & 0xF) << 4)).to(torch.int8)
    return packed, ks, vs


def unpack_kv4(packed: torch.Tensor):
    """Combined int8 [..., hd] -> (k, v) int32 [..., hd], scales not applied."""
    b = packed.to(torch.int32)
    return (b & 0xF) - 8, b >> 4


def embed_tokens(params: ParamTree, input_ids: torch.Tensor, compute_dtype=torch.bfloat16):
    """Token-embedding lookup; an int8 table ({'weight' int8 [V, D], 'scale'
    f32 [V]}) is scaled per gathered row."""
    emb = params["embed"]
    ids = input_ids.long()
    rows = emb["weight"][ids].to(compute_dtype)
    if "scale" in emb:
        rows = rows * emb["scale"][ids][..., None].to(compute_dtype)
    return rows


class _MatmulF32Out(torch.autograd.Function):
    """x [N, D] @ wt [D, V] in a 16-bit type, accumulated and returned in
    f32 (one cuBLAS call, no f32 copy of the table). The backward gives x's
    gradient only: the table is frozen. The f32 cotangent is rounded to the
    table's type for the product dy @ wt^T, which accumulates in f32 and is
    rounded to x's type, as the JAX package's f32 cotangent meets its bf16
    table in one product and lands in x's type."""

    @staticmethod
    def forward(ctx, x, wt):
        ctx.save_for_backward(wt)
        return torch.mm(x, wt, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, dy):
        (wt,) = ctx.saved_tensors
        if ctx.needs_input_grad[1]:
            raise NotImplementedError("the unembedding table is frozen: no gradient for it")
        dx = torch.mm(dy.to(wt.dtype), wt.t(), out_dtype=torch.float32)
        return dx.to(wt.dtype), None


def _logits_f32(x: torch.Tensor, w: torch.Tensor, compute_dtype, vocab_major: bool):
    """x [..., D] @ w ([V, D] if vocab_major, else [D, V]) with both operands
    in compute_dtype, accumulated and returned in f32 with no rounding of the
    output to compute_dtype. On the card the product is one bf16 x bf16 ->
    f32 matmul (no f32 copy of the table; `_MatmulF32Out`); an int8 table is
    cast to compute_dtype for it."""
    x2 = x.reshape(-1, x.shape[-1]).to(compute_dtype)
    wc = w.to(compute_dtype)
    wt = wc.t() if vocab_major else wc
    if x2.device.type == "cuda":
        if compute_dtype == torch.float32:
            y = x2 @ wt
        else:
            y = _MatmulF32Out.apply(x2, wt)
    else:
        y = x2.to(torch.float32) @ wt.to(torch.float32)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def unembed_with_tp(params: ParamTree, cfg: LlamaConfig, x: torch.Tensor,
                    compute_dtype=torch.bfloat16, tp_axis=None):
    """`unembed`, then under tensor parallelism the gather of an untied
    lm_head's vocab-column shards (a column-parallel product: its input
    takes f, its output is gathered); the tied table is replicated."""
    if tp_axis is not None and not cfg.tie_word_embeddings and "lm_head" in params:
        logits = unembed(params, cfg, collectives.copy_to(x, tp_axis), compute_dtype)
        return collectives.gather_from(logits, tp_axis, dim=-1)
    return unembed(params, cfg, x, compute_dtype)


def unembed(params: ParamTree, cfg: LlamaConfig, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Hidden states -> vocab logits (tied or untied head), f32: the product
    of the compute-dtype operands accumulates and stays in f32, as the JAX
    package's `preferred_element_type=float32`. An int8 table's per-row
    scales become per-logit scales; an int8 lm_head's per-column scales
    likewise."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        emb = params["embed"]
        logits = _logits_f32(x, emb["weight"], compute_dtype, vocab_major=True)
        if "scale" in emb:
            logits = logits * emb["scale"]
        return logits
    head = params["lm_head"]
    if isinstance(head, ParamTree):
        return _logits_f32(x, head["w_q"], compute_dtype, vocab_major=False) * head["w_s"]
    return _logits_f32(x, head, compute_dtype, vocab_major=False)


def _lora_delta(x, lora_branch, compute_dtype, tp_axis=None, row=False):
    """x @ a @ b * scaling. Under tensor parallelism a column target's b is
    this rank's out block, so the whole product x @ a enters it through f;
    a row target's a is this rank's in block and the branch a partial sum
    until g, so its whole b takes f (b's cotangent is then whole)."""
    a, b, scaling = lora_branch
    u = x @ a.to(compute_dtype)
    if row:
        b = collectives.copy_to(b, tp_axis)
    else:
        u = collectives.copy_to(u, tp_axis)
    return u @ b.to(compute_dtype) * scaling


def _layer_weight(w, li: int):
    """Layer li of a stacked linear leaf: a tensor [in, out], or the int8
    tree's (w_q int8 [in, out], w_s f32 [out])."""
    if isinstance(w, ParamTree):
        return w["w_q"][li], w["w_s"][li]
    return w[li]


def _linear(x, w, lora_branch, compute_dtype, x_main=None, tp_axis=None, row=False):
    """x @ w, plus the LoRA delta x @ a @ b * scaling when given. An int8
    weight (w_q, w_s) computes (x @ w_q) * w_s in the compute dtype.
    `x_main` (x through f under tensor parallelism) feeds the frozen
    product in place of x."""
    xm = x if x_main is None else x_main
    if isinstance(w, tuple):
        w_q, w_s = w
        y = (xm @ w_q.to(compute_dtype)) * w_s.to(compute_dtype)
    else:
        y = xm @ w.to(compute_dtype)
    if lora_branch is not None:
        y = y + _lora_delta(x, lora_branch, compute_dtype, tp_axis, row)
    return y


def _vslice(lo: torch.Tensor, hi: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """Columns [start, start + size) of the virtual concatenation [lo | hi]
    of a fused slab's two output planes."""
    half = lo.shape[-1]
    if start >= half:
        return hi[..., start - half:start - half + size]
    if start + size <= half:
        return lo[..., start:start + size]
    return torch.cat([lo[..., start:], hi[..., :start + size - half]], dim=-1)


def _squeeze_int4_blocks(w) -> dict:
    """An unfused int4 slab {'w_p', 'w_s'}, its pack-after-shard w_p [L, K,
    tp, N/(2 tp)] squeezed to the canonical [L, K, N/2] where the block axis
    is a singleton (inside a tensor-parallel shard). A slab of several
    blocks outside tensor parallelism would permute the output columns, so
    it is refused."""
    p = w["w_p"]
    if p.dim() == 4:
        if p.shape[2] != 1:
            raise ValueError(
                f"int4 tree packed for tp={p.shape[2]} used without tensor-parallel sharding "
                "(make_tp_generate); quantize with tp=1 for dp/single-device serving")
        p = p.reshape(p.shape[0], p.shape[1], p.shape[3])
    return {"w_p": p, "w_s": w["w_s"]}


def _write_scales(ks_all, vs_all, k_s, v_s, layer, offset):
    """The fresh rows' scales [B, Hkv] into slot offset[b] of the layer's
    scale slabs (an offset outside the cache writes nothing)."""
    B, S = ks_all.shape[1], ks_all.shape[3]
    off = offset.reshape(-1).expand(B)
    rows = torch.arange(B, device=ks_all.device)
    inside = ((off >= 0) & (off < S))[:, None]
    slot = off.clamp(0, S - 1).long()
    ks_all[layer, rows, :, slot] = torch.where(inside, k_s, ks_all[layer, rows, :, slot])
    vs_all[layer, rows, :, slot] = torch.where(inside, v_s, vs_all[layer, rows, :, slot])


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
    megakernel: bool = True,
    remat: bool = False,
    tp_axis=None,
    sp_axis=None,
    seq_axis=None,
):
    """Decoder forward. Without a cache returns (logits [B, T, V], None);
    with one, (logits, cache). `return_hidden` appends the final-norm hidden
    states; `unembed_logits=False` returns None for the logits (a caller that
    needs only some positions unembeds them itself). `megakernel=False`
    keeps single-request int4 decode steps on the per-layer kernels.
    `remat=True` (no cache) recomputes each layer in the backward
    (`torch.utils.checkpoint`), as the JAX package's `jax.checkpoint`.
    `tp_axis` / `sp_axis` / `seq_axis`: see the module docstring."""
    cd = compute_dtype
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, cd)
    x = inputs_embeds.to(cd)
    rot = params.get("rot")
    if rot is not None:  # into the rotated basis (QuaRot sandwich)
        x = x @ rot.to(cd)
    B, T, _ = x.shape
    dev = x.device

    if cache_offsets is not None:
        if kv_cache is None:
            raise ValueError("cache_offsets requires kv_cache")
        if assume_fresh_cache:
            raise ValueError("cache_offsets contradicts assume_fresh_cache")
    if seq_axis is not None and kv_cache is not None:
        raise ValueError("seq_axis shards a training forward: no kv_cache")
    fresh = kv_cache is not None and assume_fresh_cache and T > 1
    decode = kv_cache is not None and T == 1
    if sp_axis is not None:
        if kv_cache is None:
            raise ValueError("sp_axis requires kv_cache (timeline-sharded)")
        if cache_offsets is not None:
            raise ValueError("sp_axis does not compose with cache_offsets")
        if sp_axis.size <= 1:
            raise ValueError("sp_axis needs its static sp_size (> 1)")
        if not (fresh or decode):
            raise ValueError("sp decode supports fresh prefill or T==1 steps")
    if kv_cache is not None and not (fresh or decode):
        raise NotImplementedError(
            "cached forward supports a fresh-cache prefill or T == 1 decode steps"
        )
    host_offset = None
    if kv_cache is not None:
        offset = kv_cache.length if cache_offsets is None else cache_offsets
        offset = offset.to(device=dev, dtype=torch.int32)
        if cache_offsets is None:
            host_offset = 0 if fresh else kv_cache.host_length
        Tk = kv_cache.k.shape[3]
        if sp_axis is None and attention_mask is not None and attention_mask.shape[1] < Tk:
            attention_mask = F.pad(attention_mask, (0, Tk - attention_mask.shape[1]))
        off_col = offset.reshape(-1, 1)  # [1|B, 1]
    else:
        offset = None
        off_col = torch.zeros((1, 1), dtype=torch.int32, device=dev)

    if positions is None:
        positions = torch.arange(T, device=dev)[None, :] + off_col
        if seq_axis is not None:  # this rank's slice of the global positions
            positions = positions + collectives.axis_index(seq_axis) * T
    cos, sin = rope_tables(positions, rope_for_config(cfg))  # [1|B, T, hd]

    valid = None
    sp_g0 = sp_loc = None
    if decode and sp_axis is not None:
        # this rank's window of global slots [sp_g0, sp_g0 + Tk): global
        # slot-causality against the host's fill, times the mask's window
        if host_offset is None:  # a cache built by hand: read its fill once
            host_offset = int(offset.reshape(-1)[0])
        sp_g0 = sp_axis.index * Tk
        sp_loc = host_offset - sp_g0  # the local append slot; outside [0, Tk) off the owner
        kpos = sp_g0 + torch.arange(Tk, device=dev)[None, :]
        valid = (kpos <= host_offset).to(torch.int32).expand(B, Tk)
        if attention_mask is not None:
            am = attention_mask
            if am.shape[1] != Tk:  # the global timeline mask: take the window
                full = Tk * sp_axis.size
                if am.shape[1] < full:  # slots past it are never <= the offset
                    am = F.pad(am, (0, full - am.shape[1]), value=1)
                am = am[:, sp_g0:sp_g0 + Tk]
            valid = valid * am.to(torch.int32)
    elif decode:
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
    int4 = "qkv_proj" in lp  # the fused int4 tree
    int4_slabs = {}  # the unfused int4 tree's slabs, block axis squeezed
    if not int4 and isinstance(lp["q_proj"], ParamTree) and "w_p" in lp["q_proj"]:
        int4_slabs = {n: _squeeze_int4_blocks(lp[n]) for n in LINEAR_NAMES}
    fmt = "obin" if "int4_obin" in params else "pair"
    # each stacked LoRA leaf split into its layers once: under autograd the
    # backward then stacks a leaf's layer gradients in one op, where indexing
    # the stack per layer would add a zero-padded [L, ...] gradient per layer
    lora_layers = None
    if lora is not None:
        lora_layers = {name: (br["a"].unbind(0), br["b"].unbind(0))
                       for name, br in lora["layers"].items()}
    scale = cfg.head_dim ** -0.5
    eps = cfg.rms_norm_eps
    hd = cfg.head_dim
    ck = kv_cache.k if kv_cache is not None else None
    cv = kv_cache.v if kv_cache is not None else None
    kv_bits = kv_cache.kv_bits if kv_cache is not None else 16
    ks_all = kv_cache.k_scale if kv_cache is not None else None
    vs_all = kv_cache.v_scale if kv_cache is not None else None
    mlp_chunk = None
    if int4:
        mlp_chunk = mlp4.kernel_chunk(lp["gateup_proj"]["w_p"].shape[-1],
                                      lp["down_proj"]["w_p"].shape[-1])

    use_mega = (megakernel and decode and int4 and kv_bits == 4 and B == 1 and lora is None
                and cache_offsets is None and tp_axis is None and sp_axis is None)
    if use_mega:
        if host_offset is None:  # a cache built by hand: read its fill once
            host_offset = int(offset.reshape(-1)[0])
        use_mega = mk.ok_for(cfg, lp, Tk, host_offset, dev)
    if use_mega:
        # the whole layer stack in one launch; the scale slabs and the cache
        # are written in place at the offset
        hidden, ck, _ = mk.decode_megakernel(
            x[0], lp["qkv_proj"], lp["o_proj"], lp["gateup_proj"], lp["down_proj"],
            lp["input_ln"], lp["post_attn_ln"], cos[0, 0], sin[0, 0], ck, ks_all, vs_all,
            offset, valid, eps=eps, scale=scale, fmt=fmt)
        x = hidden[None]

    def write_rows(kh, vh, li, slots):
        """K/V rows [B, Hkv, (n,) hd] into `slots` (a slot or a slice) of layer
        li, quantized to the cache's format with their scales."""
        if kv_bits == 4:
            kvh, khs, vhs = quantize_kv_rows4(kh, vh)
            ck[li, :, :, slots] = kvh
            ks_all[li, :, :, slots], vs_all[li, :, :, slots] = khs, vhs
        elif kv_bits == 8:
            (khq, khs), (vhq, vhs) = quantize_kv_rows(kh), quantize_kv_rows(vh)
            ck[li, :, :, slots], cv[li, :, :, slots] = khq, vhq
            ks_all[li, :, :, slots], vs_all[li, :, :, slots] = khs, vhs
        else:
            ck[li, :, :, slots], cv[li, :, :, slots] = kh.to(ck.dtype), vh.to(cv.dtype)

    def sp_decode_attention(q, k, v, li):
        """A T == 1 step under sp -> [B, 1, Hq, hd]: the owner of the slot
        appends the row, every rank's statistics over its slab, merged."""
        nonlocal ck, cv
        owner = 0 <= sp_loc < Tk
        q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]
        if kv_bits == 4:
            kvp, kq_s, vq_s = quantize_kv_rows4(k1, v1)
            m, l, acc, ck = db.decode_attention_quantized4_db_stats(
                q1, kvp, ck, ks_all, vs_all, kq_s, vq_s, li, sp_loc, valid, scale)
        elif kv_bits == 8:
            (kq, kq_s), (vq, vq_s) = quantize_kv_rows(k1), quantize_kv_rows(v1)
            m, l, acc, ck, cv = db.decode_attention_quantized_db_stats(
                q1, kq, vq, ck, cv, ks_all, vs_all, kq_s, vq_s, li, sp_loc, valid, scale)
        else:
            m, l, acc, ck, cv = db.decode_attention_db_stats(
                q1, k1.to(ck.dtype), v1.to(cv.dtype), ck, cv, li, sp_loc, valid, scale)
        if owner and kv_bits != 16:  # the kernels write the row's values only
            ks_all[li, :, :, sp_loc], vs_all[li, :, :, sp_loc] = kq_s, vq_s
        return merge_partial_stats(m, l, acc, sp_axis, out_dtype=q.dtype)[:, None]

    def layer_step(x, li):
        nonlocal ck, cv
        def lb(name):
            if lora_layers is None or name not in lora_layers:
                return None
            a, b = lora_layers[name]
            return (a[li], b[li], lora["scaling"])

        def lora_add(y, name, x_in):
            """LoRA stays per projection on the fused int4 slabs, added after
            the fused output is split."""
            br = lb(name)
            return y if br is None else y + _lora_delta(x_in, br, cd, tp_axis,
                                                        name in ROW_PARALLEL)

        def int4_linear(x_in, name, lora_name=None):
            w = int4_slabs.get(name) or lp[name]
            g = w["w_p"].shape[-2] // w["w_s"].shape[-2]
            y = i4.int4_matmul_stacked(x_in, w["w_p"], w["w_s"], li, group=g, fmt=fmt)
            return lora_add(y, lora_name, x_in) if lora_name else y

        def linear(x_in, name, x_main=None):
            return _linear(x_in, _layer_weight(lp[name], li), lb(name), cd, x_main, tp_axis,
                           name in ROW_PARALLEL)

        h = rms_norm(x, lp["input_ln"][li].to(cd), eps)
        hf = collectives.copy_to(h, tp_axis)  # f: the column-parallel products' input
        if int4:
            nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
            w = lp["qkv_proj"]
            lo, hi = i4.int4_matmul_stacked(h, w["w_p"], w["w_s"], li, return_planes=True,
                                            fmt=fmt)
            q = lora_add(_vslice(lo, hi, 0, nq), "q_proj", h)
            k = lora_add(_vslice(lo, hi, nq, nkv), "k_proj", h)
            v = lora_add(_vslice(lo, hi, nq + nkv, nkv), "v_proj", h)
        elif int4_slabs:
            q, k, v = (int4_linear(h, n, n) for n in ("q_proj", "k_proj", "v_proj"))
        else:
            q, k, v = (linear(h, n, hf) for n in ("q_proj", "k_proj", "v_proj"))
        q = apply_rope(q.reshape(B, T, -1, hd), cos, sin)
        k = apply_rope(k.reshape(B, T, -1, hd), cos, sin)
        v = v.reshape(B, T, -1, hd)

        if decode and sp_axis is not None:
            attn = sp_decode_attention(q, k, v, li)
        elif decode and kv_bits == 4:
            kvp, kq_s, vq_s = quantize_kv_rows4(k[:, 0], v[:, 0])
            # the append slot's scales go in BEFORE the kernel, which never
            # reads them (the slot is dead in its slab pass)
            _write_scales(ks_all, vs_all, kq_s, vq_s, li, offset)
            attn, ck = decode_attention_quantized4_mono(
                q[:, 0], kvp, ck, ks_all, vs_all, kq_s, vq_s, li, offset, valid, scale)
            attn = attn[:, None]
        elif decode and kv_bits == 8:
            kq, kq_s = quantize_kv_rows(k[:, 0])
            vq, vq_s = quantize_kv_rows(v[:, 0])
            _write_scales(ks_all, vs_all, kq_s, vq_s, li, offset)  # before, as above
            attn, ck, cv = decode_attention_quantized_mono(
                q[:, 0], kq, vq, ck, cv, ks_all, vs_all, kq_s, vq_s, li, offset, valid, scale)
            attn = attn[:, None]
        elif decode:
            attn, ck, cv = decode_attention_mono(
                q[:, 0], k[:, 0], v[:, 0], ck, cv, li, offset, valid, scale
            )
            attn = attn[:, None]
        else:
            if fresh:
                # in place: the fresh rows fill slots [0, T), or under sp the
                # rows of this rank's window of global slots
                g0 = 0 if sp_axis is None else sp_axis.index * Tk
                n = max(0, min(T - g0, Tk))
                if n:
                    write_rows(k[:, g0:g0 + n].transpose(1, 2), v[:, g0:g0 + n].transpose(1, 2),
                               li, slice(0, n))
            if seq_axis is not None:
                attn = ring_causal_mha_kernel(q, k, v, axis=seq_axis, mask=attn_mask,
                                              scale=scale)
            else:
                attn = causal_mha(q, k, v, mask=attn_mask, scale=scale)
        attn = attn.reshape(B, T, -1)
        if int4 or int4_slabs:
            attn = int4_linear(attn, "o_proj", "o_proj")
        else:
            attn = linear(attn, "o_proj")
        x = x + collectives.reduce_from(attn, tp_axis)  # g: the row-parallel sum over tp

        h = rms_norm(x, lp["post_attn_ln"][li].to(cd), eps)
        hf = collectives.copy_to(h, tp_axis)
        mlp_lora = any(lb(n) is not None for n in ("gate_proj", "up_proj", "down_proj"))
        if int4 and B * T <= mlp4.MAX_M and not mlp_lora and mlp_chunk is not None:
            gu, dn = lp["gateup_proj"], lp["down_proj"]
            d = mlp4.mlp_int4_stacked(h, gu["w_p"], gu["w_s"], dn["w_p"], dn["w_s"], li,
                                      chunk=mlp_chunk, fmt=fmt)
        elif int4:  # the planes are exactly gate and up
            gu = lp["gateup_proj"]
            g, u = i4.int4_matmul_stacked(h, gu["w_p"], gu["w_s"], li, return_planes=True,
                                          fmt=fmt)
            g, u = lora_add(g, "gate_proj", h), lora_add(u, "up_proj", h)
            d = int4_linear(F.silu(g) * u, "down_proj", "down_proj")
        elif int4_slabs:
            g, u = int4_linear(h, "gate_proj", "gate_proj"), int4_linear(h, "up_proj", "up_proj")
            d = int4_linear(F.silu(g) * u, "down_proj", "down_proj")
        else:
            g, u = linear(h, "gate_proj", hf), linear(h, "up_proj", hf)
            d = linear(F.silu(g) * u, "down_proj")
        x = x + collectives.reduce_from(d, tp_axis)  # g: the row-parallel sum over tp
        return x

    for li in range(0 if use_mega else cfg.num_layers):
        if remat and kv_cache is None and torch.is_grad_enabled():
            x = checkpoint(layer_step, x, li, use_reentrant=False)
        else:
            x = layer_step(x, li)
    if rot is not None:  # out of the rotated basis
        x = x @ rot.to(cd).T
    x = rms_norm(x, params["final_ln"].to(cd), eps)
    logits = unembed_with_tp(params, cfg, x, cd, tp_axis) if unembed_logits else None

    new_cache = None
    if kv_cache is not None:
        if cache_offsets is None:
            new_len = offset + T
        else:
            new_len = offset.max() + T  # upper bound; the caller tracks rows
        new_cache = KVCache(k=ck, v=cv, length=new_len.to(torch.int32),
                            k_scale=ks_all, v_scale=vs_all,
                            host_length=None if host_offset is None else host_offset + T)
    if return_hidden:
        return logits, new_cache, x
    return logits, new_cache


def token_nll_sum(logits: torch.Tensor, targets: torch.Tensor):
    """(summed NLL, count) of the targets that are not -100: logits [B, T, V]
    (f32) scored against targets [B, T] position by position (no shift)."""
    mask = targets != -100
    safe = torch.where(mask, targets, torch.zeros_like(targets)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(mask, -token_ll, torch.zeros_like(token_ll)).sum(), mask.sum()


def nll_sum_from_hidden(
    params: ParamTree, cfg: LlamaConfig, hidden: torch.Tensor, targets: torch.Tensor,
    chunk_size: int = 256, compute_dtype=torch.bfloat16, tp_axis=None,
):
    """`token_nll_sum(unembed(hidden), targets)` without the [B, T, V]
    logits: sequence chunks of `chunk_size` positions, each unembedded,
    reduced to its summed NLL and count, and recomputed in the backward
    (`torch.utils.checkpoint`). hidden [B, T, D] is the final-norm output;
    targets [B, T] are scored position by position (no shift)."""
    xs, ys = hidden, targets
    T = xs.shape[1]
    pad = (-T) % chunk_size
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        ys = F.pad(ys, (0, pad), value=-100)

    def chunk_loss(xc, yc):
        logits = unembed_with_tp(params, cfg, xc, compute_dtype, tp_axis)  # [B, c, V] f32
        lse = torch.logsumexp(logits, dim=-1)
        mask = yc != -100
        safe = torch.where(mask, yc, torch.zeros_like(yc)).long()
        tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
        return torch.where(mask, lse - tgt, torch.zeros_like(lse)).sum(), mask.sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, T + pad, chunk_size):
        xc, yc = xs[:, c0:c0 + chunk_size], ys[:, c0:c0 + chunk_size]
        if torch.is_grad_enabled():
            s, n = checkpoint(chunk_loss, xc, yc, use_reentrant=False)
        else:
            s, n = chunk_loss(xc, yc)
        total, count = total + s, count + n
    return total, count
