"""Whole-stack int4 decode step for one request: every layer of the decoder
(rms norm, q|k|v, rope, int4 KV-row quantization, attention with the fresh
row entered analytically, o and the residual, rms norm, gate|up, SiLU * up,
down and the residual) in ONE kernel launch.

Counterpart of `audio_llama_tpu/ops/decode_megakernel.py`; the kernel
`decode_megakernel` replaces `_kernel`. Its CUDA kernel is
`csrc/decode_megakernel.cu` (the source note gives the bound and the
design: one cooperative launch of a persistent grid, every product split
over (128-column tile, K slice) and the attention over (KV head, timeline
split) so every block works in every phase, one stream of weight and cache
stages a block that runs on across the grid barriers, the partials summed
in a fixed order by the last block to arrive). The launch plan is computed
here (`plan`, `shares`, `tile_slices`, `splits`: the formulas the kernel
repeats). `decode_megakernel_plain` is the same
arithmetic in PyTorch, with the TPU kernel's rounding points: the q|k|v
planes summed in f32 and rounded to the compute dtype, rope in f32 rounded
to the compute dtype before the int4 row quantization, the int4-KV
attention of `decode_attention_q4_plain`, o rounded to the compute dtype
before its residual add, a = g * sigmoid(g) * u in f32 rounded to the
compute dtype, and each down column summed over its 128-row groups in
order (the TPU kernel's `dn_acc`) before its residual add.

Layouts (the fused int4 tree of `models/llama_int4.py`, one request):
  x [1, D] compute dtype (the embedded token, after the QuaRot rotation);
  qkv, o, gu, dn: {'w_p' int8 [L, K, N/2], 'w_s' f32 [L, K/128, N]};
  input_ln, post_attn_ln [L, D]; cos, sin [hd] f32 at the append position;
  cache_kv [L, 1, Hkv, Tk, hd] int8 (K/V-combined int4 rows);
  k_scales, v_scales [L, 1, Hkv, Tk] f32; offset a scalar int32 tensor;
  valid [1, Tk] int32.
Returns (hidden [1, D], cache_kv, fresh [L, Hkv, 2] f32): the fresh rows'
(k, v) scales. The packed rows and their scales are written in place at
slot `offset` of every layer (nothing for an offset outside the cache).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _cuda
from .decode_attention_mono import decode_attention_q4_plain
from .int4_matmul import FMT_CODE, GROUP, _fmt, _unpack_planes, int4_matmul_stacked_plain
from .norms import rms_norm
from .rope import apply_rope

launches = 0  # kernel launches through `decode_megakernel`

SLABS = ("qkv_proj", "o_proj", "gateup_proj", "down_proj")
KV_GROUPS = (1, 2, 3, 4)  # query heads per KV head the kernel is built for
TILE = 128  # packed columns per work tile of the kernel (kTW)
STAGES = 5  # ring slots of a block (kStages)
CHUNK = 4  # timeline groups of an attention stage (kChunk)
SLOTS = 32  # cache slots of a timeline group
SLOT = GROUP * TILE + 3 * CHUNK * SLOTS * 4  # bytes of a ring slot: a unit's rows, the scales
SPLIT_GROUPS = 4  # timeline groups a split aims at (fewer splits: a shorter merge)
PER_SM = (2, 1)  # blocks per SM the launch plan tries, in order
SMEM_LIMIT = 227 * 1024 - 8 * 1024  # dynamic shared memory of a block; 8 KB left for its static
MAX_TK = 131072  # the longest cache the gate takes (Llama 3.2's context)
ALL_PHASES = 0b11111  # q|k|v, attention, o, gate|up, down
PHASES = ("qkv", "attention", "o", "gate_up", "down")  # the phase mask's bits, in order


def products(D: int, F: int, Hq: int, Hkv: int, hd: int = 128):
    """(K, packed width) of q|k|v, o, gate|up and down, in phase order."""
    return ((D, (Hq + 2 * Hkv) * hd // 2), (Hq * hd, D // 2), (D, F), (F, D // 2))


@dataclass(frozen=True)
class Plan:
    grid: int  # blocks (P), per_sm on every SM
    per_sm: int
    splits: int  # S: timeline splits of each KV head
    maxj: int  # x-row slots of a block: the most units in a share of a product
    smem: int  # dynamic shared memory of a block
    tiles: int  # the most tiles of a product (its arrival counts)
    stages: int  # the most units of a product (rows of the partials)


def smem_bytes(maxj: int, D: int, S: int, G: int) -> int:
    """Dynamic shared memory of one block (the kernel's smem_need): 1024
    bytes to align the ring, the ring, then the largest of a product's x
    rows (maxj 128-row slots and a D-wide row for the rms), the attention's
    logits and p of a chunk (2 x 4 heads x CHUNK x 32 slots, f32) and the
    split merge's m and l (2 S G floats)."""
    return 1024 + STAGES * SLOT + max(maxj * GROUP * 2 + D * 2, 2 * 4 * CHUNK * SLOTS * 4,
                                      S * G * 8)


def shares(W: int, P: int):
    """[(start, end)] of the P blocks' units of a W-unit product (unit i:
    group i % Gk of tile i // Gk)."""
    return [(b * W // P, (b + 1) * W // P) for b in range(P)]


def tile_slices(t: int, Gk: int, W: int, P: int):
    """Tile t's K slices as the last one to arrive sums them, in K order:
    [(block, first unit, end unit)] of the blocks whose share meets the
    tile (the kernel walks the blocks from the one holding unit t Gk)."""
    t0, t1 = t * Gk, t * Gk + Gk
    out = []
    for b in range(((t0 + 1) * P - 1) // W, (t1 * P - 1) // W + 1):
        lo, hi = max(b * W // P, t0), min((b + 1) * W // P, t1)
        if lo < hi:
            out.append((b, lo, hi))
    return out


def splits(ng: int, S: int):
    """[(first, end)] timeline groups of a KV head's S splits."""
    return [(s * ng // S, (s + 1) * ng // S) for s in range(S)]


def plan(D: int, F: int, Hq: int, Hkv: int, Tk: int, sms: int, per_sm: int) -> Plan:
    """The launch plan of a grid of P = sms * per_sm blocks: a product of T
    tiles of 128 packed columns and Gk groups of 128 rows has W = T * Gk
    units, unit i group i % Gk of tile i // Gk, and block b takes units
    [b W / P, (b + 1) W / P) (`shares`): its units of one tile are a K
    slice, and a tile's slices are summed in K order (`tile_slices`). Each
    KV head's Tk / 32 timeline groups go to S splits (`splits`), about
    SPLIT_GROUPS groups each and at most P / Hkv, unit b = head * S + split
    on block b."""
    P = sms * per_sm
    dims = [(nh // TILE, k // GROUP) for k, nh in products(D, F, Hq, Hkv)]
    maxj = max(-(-T * Gk // P) for T, Gk in dims)
    S = max(1, min(-(-(Tk // SLOTS) // SPLIT_GROUPS), P // Hkv))
    return Plan(grid=P, per_sm=per_sm, splits=S, maxj=maxj, smem=smem_bytes(maxj, D, S, Hq // Hkv),
                tiles=max(T for T, _ in dims), stages=max(T * Gk for T, Gk in dims))


def _fits(pl: Plan, Hkv: int) -> bool:
    return (pl.smem <= SMEM_LIMIT and Hkv * pl.splits <= pl.grid
            and max(pl.stages, MAX_TK) * pl.grid < 2 ** 31)


@functools.lru_cache(maxsize=None)
def _launch_plan(device_index: int, D: int, F: int, Hq: int, Hkv: int, Tk: int):
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    lib = _cuda.library()
    for per_sm in PER_SM:
        pl = plan(D, F, Hq, Hkv, Tk, sms, per_sm)
        if _fits(pl, Hkv) and lib.al_megakernel_blocks_per_sm(Hq // Hkv, pl.smem) >= per_sm:
            return pl
    return None


def launch_plan(device, D: int, F: int, Hq: int, Hkv: int, Tk: int):
    """The plan the kernel runs on a CUDA device: two blocks per SM where the
    occupancy API says they are resident, else one; None when not even one
    is."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _launch_plan(index, D, F, Hq, Hkv, Tk)


def kernel_info(G: int, pl: Plan, D: int) -> dict:
    """Registers per thread, local (spilled) bytes, the dynamic and static
    shared memory of a block, resident blocks per SM, ring slots and
    threads of the kernel's instance for G query heads per KV head at the
    plan `pl` of a D-wide model, from the CUDA runtime."""
    import ctypes

    out = (ctypes.c_int * 7)()
    _cuda.check(_cuda.library().al_megakernel_info(G, pl.maxj, D, pl.splits,
                                                   ctypes.cast(out, ctypes.c_void_p)),
                "decode_megakernel info")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2], static_smem_bytes=out[3],
                blocks_per_sm=out[4], ring_stages=out[5], threads=out[6])


def ok_for(cfg, slabs, Tk: int, offset: int, device=None) -> bool:
    """Whether the megakernel takes this step: the fused int4 slabs with 128-row
    groups, head_dim 128, tile-aligned packed widths, a supported number of
    query heads per KV head, a 32-slot cache timeline of at most MAX_TK slots
    with the append slot inside it (a full cache keeps the per-layer path),
    and on the card a launch plan whose grid is resident (`launch_plan`)."""
    if any(n not in slabs for n in SLABS) or any("w_r" in slabs[n] for n in SLABS):
        return False
    hd = cfg.head_dim
    if hd != 128 or cfg.num_heads % cfg.num_kv_heads:
        return False
    G = cfg.num_heads // cfg.num_kv_heads
    if G not in KV_GROUPS:
        return False
    for n in SLABS:
        w = slabs[n]
        if w["w_p"].shape[-2] != GROUP * w["w_s"].shape[-2] or w["w_p"].shape[-1] % TILE:
            return False
    if Tk % SLOTS or Tk > MAX_TK or not 0 <= int(offset) < Tk:
        return False
    F = slabs["gateup_proj"]["w_p"].shape[-1]
    D, Hq, Hkv = cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads
    if device is not None and torch.device(device).type == "cuda":
        return launch_plan(device, D, F, Hq, Hkv, Tk) is not None
    return _fits(plan(D, F, Hq, Hkv, Tk, 132, 1), Hkv)


def _mlp_plain(hn, gu, dn, li: int, fmt):
    """gate|up planes in f32, a = g * sigmoid(g) * u rounded to hn's dtype,
    down summed over its groups in order, rounded to hn's dtype."""
    g, u = int4_matmul_stacked_plain(hn.to(torch.float32), gu["w_p"], gu["w_s"], li,
                                     return_planes=True, fmt=fmt)
    a = (g * torch.sigmoid(g) * u).to(hn.dtype).to(torch.float32)
    lo, hi = _unpack_planes(dn["w_p"][li], fmt)
    s = dn["w_s"][li].to(torch.float32)
    dh = lo.shape[-1]
    acc = torch.zeros((a.shape[0], 2 * dh), dtype=torch.float32, device=a.device)
    for g2 in range(lo.shape[0] // GROUP):
        rows = slice(g2 * GROUP, (g2 + 1) * GROUP)
        part = torch.cat([a[:, rows] @ lo[rows].to(torch.float32),
                          a[:, rows] @ hi[rows].to(torch.float32)], dim=-1)
        acc = acc + part * s[g2]
    return acc.to(hn.dtype)


def decode_megakernel_plain(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv,
                            k_scales, v_scales, offset, valid, *, eps: float, scale: float,
                            fmt=None):
    """The kernel's arithmetic in PyTorch (writes the cache and the scale
    slabs in place)."""
    from ..models.llama import _write_scales, quantize_kv_rows4

    L, _, Hkv, Tk, hd = cache_kv.shape
    cd = x.dtype
    h = x.reshape(1, -1)
    Hq = o["w_p"].shape[1] // hd
    cs, sn = cos.reshape(1, 1, hd), sin.reshape(1, 1, hd)
    off = torch.as_tensor(offset, dtype=torch.int32, device=x.device).reshape(1)
    fresh = torch.empty((L, Hkv, 2), dtype=torch.float32, device=x.device)
    for li in range(L):
        hn = rms_norm(h, input_ln[li].to(cd), eps)
        lo, hi = int4_matmul_stacked_plain(hn, qkv["w_p"], qkv["w_s"], li, return_planes=True,
                                           fmt=fmt)
        qkv_out = torch.cat([lo, hi], dim=-1)
        q = apply_rope(qkv_out[:, :Hq * hd].reshape(1, 1, Hq, hd), cs, sn)
        k = apply_rope(qkv_out[:, Hq * hd:(Hq + Hkv) * hd].reshape(1, 1, Hkv, hd), cs, sn)
        v = qkv_out[:, (Hq + Hkv) * hd:].reshape(1, Hkv, hd)
        kvp, ks, vs = quantize_kv_rows4(k[:, 0], v)
        attn, _ = decode_attention_q4_plain(q[:, 0], kvp, cache_kv, k_scales, v_scales, ks, vs,
                                            li, off, valid, scale)
        _write_scales(k_scales, v_scales, ks, vs, li, off)
        fresh[li] = torch.stack([ks[0], vs[0]], dim=-1)
        h = h + int4_matmul_stacked_plain(attn.reshape(1, Hq * hd), o["w_p"], o["w_s"], li,
                                          fmt=fmt)
        hn = rms_norm(h, post_attn_ln[li].to(cd), eps)
        h = h + _mlp_plain(hn, gu, dn, li, fmt)
    return h, cache_kv, fresh


def _require(name, cond, msg):
    if not cond:
        raise ValueError(f"{name}: {msg}")


def decode_megakernel_cuda(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv,
                           k_scales, v_scales, offset, valid, *, eps: float, scale: float,
                           fmt=None, phases: int = ALL_PHASES, skip_split: int = -1,
                           skip_slice: int = -1, stale: bool = False):
    """Launch the kernel (same arguments as the plain version).
    `phases` is a mask of the phases that run (bit i: PHASES[i]); the
    launch keeps every grid barrier, so a partial mask times those phases
    alone and 0 the barriers alone (their outputs are not meaningful, and
    such a launch is not counted). `skip_split`, `skip_slice` and `stale`
    plant the faults of chip_smoke's check (csrc/decode_megakernel.cu)."""
    global launches
    name = "decode_megakernel"
    slabs = (qkv, o, gu, dn)
    _cuda.require_cuda(name, x, cos, sin, cache_kv, k_scales, v_scales, valid,
                       *(t for w in slabs for t in (w["w_p"], w["w_s"])))
    L, B, Hkv, Tk, hd = cache_kv.shape
    D = x.shape[-1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x must be bfloat16, got {x.dtype}")
    if cache_kv.dtype != torch.int8 or k_scales.dtype != torch.float32 \
            or v_scales.dtype != torch.float32:
        raise TypeError(f"{name}: expected an int8 cache and f32 scale slabs")
    for w in slabs:
        if w["w_p"].dtype != torch.int8 or w["w_s"].dtype != torch.float32:
            raise TypeError(f"{name}: expected int8 slabs and f32 scales")
        _require(name, w["w_p"].is_contiguous() and w["w_s"].is_contiguous()
                 and _cuda.aligned16(w["w_p"]) and _cuda.aligned16(w["w_s"]),
                 "the slabs must be contiguous and aligned")
    Nh = qkv["w_p"].shape[-1]
    Hq = o["w_p"].shape[1] // hd
    F = gu["w_p"].shape[-1]
    G = Hq // Hkv if Hkv else 0
    _require(name, B == 1 and x.numel() == D, "one request (B = 1, one token)")
    _require(name, hd == 128 and G in KV_GROUPS and Hq == G * Hkv,
             f"needs head_dim 128 and Hq/Hkv in {KV_GROUPS}")
    _require(name, 2 * Nh == (Hq + 2 * Hkv) * hd, "q|k|v slab width")
    for w, K, N in ((qkv, D, 2 * Nh), (o, Hq * hd, D), (gu, D, 2 * F), (dn, F, D)):
        _cuda.require_shape(name, w["w_p"], (L, K, N // 2))
        _cuda.require_shape(name, w["w_s"], (L, K // GROUP, N))
        _require(name, K % GROUP == 0 and (N // 2) % TILE == 0, "group and tile alignment")
    _cuda.require_shape(name, k_scales, (L, 1, Hkv, Tk))
    _cuda.require_shape(name, v_scales, (L, 1, Hkv, Tk))
    _cuda.require_shape(name, input_ln, (L, D))
    _cuda.require_shape(name, post_attn_ln, (L, D))
    _cuda.require_shape(name, valid, (1, Tk))
    _require(name, cos.numel() == hd and sin.numel() == hd, "cos/sin are [hd]")
    _require(name, Tk % SLOTS == 0 and Tk <= MAX_TK, f"Tk % {SLOTS} == 0, Tk <= {MAX_TK}")
    _require(name, all(t.is_contiguous() and _cuda.aligned16(t)
                       for t in (cache_kv, k_scales, v_scales)),
             "the cache and scale slabs must be contiguous and aligned")
    _require(name, 0 <= phases <= ALL_PHASES, "phases is a mask of five bits")
    dev = x.device
    pl = launch_plan(dev, D, F, Hq, Hkv, Tk)
    _require(name, pl is not None, "no resident grid for these widths")
    off = torch.as_tensor(offset, dtype=torch.int32, device=dev).reshape(1).contiguous()
    x = _cuda.contiguous16(x.reshape(D))
    iln = input_ln.to(torch.bfloat16).contiguous()
    pln = post_attn_ln.to(torch.bfloat16).contiguous()
    cos = cos.to(torch.float32).reshape(hd).contiguous()
    sin = sin.to(torch.float32).reshape(hd).contiguous()
    valid = _cuda.contiguous16(valid.to(torch.int32).reshape(Tk))
    # scratch: the q|k|v planes (f32), the attention output and the MLP
    # activation (bf16), the residual (the output), the fresh scales, the
    # K-slice partials and the timeline splits' (acc, m, l)
    f32 = dict(dtype=torch.float32, device=dev)
    qkv_out = torch.empty(2 * Nh, **f32)
    attn = torch.empty(Hq * hd, dtype=torch.bfloat16, device=dev)
    act = torch.empty(F, dtype=torch.bfloat16, device=dev)
    hidden = torch.empty(D, dtype=torch.bfloat16, device=dev)
    fresh = torch.empty((L, Hkv, 2), **f32)
    part = torch.empty(pl.stages * 2 * TILE, **f32)
    apart = torch.empty(Hkv * pl.splits * G * (hd + 2), **f32)
    cnt = _cuda.counters(dev, pl.tiles + Hkv)
    err = _cuda.library().al_decode_megakernel(
        x.data_ptr(), iln.data_ptr(), pln.data_ptr(), cos.data_ptr(), sin.data_ptr(),
        qkv["w_p"].data_ptr(), qkv["w_s"].data_ptr(), o["w_p"].data_ptr(), o["w_s"].data_ptr(),
        gu["w_p"].data_ptr(), gu["w_s"].data_ptr(), dn["w_p"].data_ptr(), dn["w_s"].data_ptr(),
        cache_kv.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(), off.data_ptr(),
        valid.data_ptr(), qkv_out.data_ptr(), attn.data_ptr(), act.data_ptr(),
        hidden.data_ptr(), fresh.data_ptr(), part.data_ptr(), apart.data_ptr(), cnt.data_ptr(),
        _cuda.barrier_words(dev).data_ptr(), L, D, F, Hq, Hkv, Tk, hd, FMT_CODE[_fmt(fmt)],
        float(eps), float(scale), pl.grid, pl.splits, pl.maxj, int(phases), int(skip_split),
        int(skip_slice), int(bool(stale)), _cuda.stream_handle(x),
    )
    _cuda.check(err, name)
    if phases == ALL_PHASES:
        launches += 1
    return hidden.reshape(1, D), cache_kv, fresh


def decode_megakernel(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv, k_scales,
                      v_scales, offset, valid, *, eps: float, scale: float, fmt=None):
    """One decode step of one request through every layer -> (hidden [1, D],
    cache_kv, fresh scales [L, Hkv, 2]); see the module docstring. The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    fn = decode_megakernel_plain if x.device.type == "cpu" else decode_megakernel_cuda
    return fn(x, qkv, o, gu, dn, input_ln, post_attn_ln, cos, sin, cache_kv, k_scales, v_scales,
              offset, valid, eps=eps, scale=scale, fmt=fmt)
