"""The timeline decode core (csrc/decode_timeline.cuh) on the host: its
launch plan and the order of its arithmetic across a cluster.

- (a) `ops.decode_timeline.timeline_plan`, exactly, for every G the kernels
  take, hd 64 and 128, the bf16, f32, int8 and int4 cache formats, and S from
  32 up to the planner's cap (`max_slots`; one slot group past it raises
  ValueError): block rank r of C takes the 32-slot groups [r ng / C, (r + 1)
  ng / C) of the kernel's formula, mirrored here, so every slot is taken
  once, in rank order, in whole groups; a block's shared memory
  (`block_smem` at the largest range) fits 227 KB; the block that writes
  the fresh row is the one whose range holds the offset, and no block owns
  an offset outside the timeline; at the 3B decoder's shapes (Hkv 8, G 3, hd
  128) at B 1 the plan puts at least 64 blocks on the card; the planner's
  constants equal the header's.
- (b) `cluster_attend`, a mirror of the cluster's arithmetic kept in this
  file: each range's max, the cluster max (clamped to -5e29 in the stats
  mode), p = exp(logit - M) (stats: 0 on an invalid slot), each range's sum
  and their sum in rank order, p divided by it (normalized), times the V
  scale, rounded to the compute dtype, each range's f32 P V partial and
  their sum in rank order. It is held against the JAX package's
  `decode_attention`, `decode_attention_quantized`, the three `*_db` and the
  three `*_db_stats` functions with interpret=True at L 2, B 2, Hkv 2, G 3,
  hd 64, S 128 in the plan's 4 ranges: offsets on a range boundary,
  mid-range, at S - 1 and past the timeline, a fully masked range and a
  fully masked slab. Bars of tests/test_torch_decode_ref.py and
  tests/test_torch_decode_ab.py: f32 within 1e-5, bf16 within 2e-2
  (absolute and relative), the stats' m and l within 1e-5 relative.
- (c) the mono mode (row 4, `decode_attention_mono`): the stats mode's p
  (max clamped to -5e29, 0 on an invalid slot), rounded to the cache dtype,
  divided after P V (0 where l = 0), with one offset a batch row, held
  against the port's `decode_attention_plain` and JAX's
  `decode_attention_mono` with interpret=True at the same size: rows at
  different offsets (a range boundary, past the timeline), a fully masked
  range, a fully masked row (0 in the port's contract; JAX's kernel averages
  that row's slab, and is held on the other row).
- (d) the chunk mode (row 19, `decode_attention_packed` and
  `decode_attention_quantized_packed`): ranges of whole chunks, each
  block's running max started from the max over the ranks before it, its
  chunks walked in order (p rounded against each chunk's running max), the
  blocks' (l, acc) chained in rank order by their products of alphas, held
  against JAX's kernels with interpret=True at chunk lengths that give an
  uneven number of chunks a rank: a fully masked leading chunk, the offset
  on a chunk boundary. The mirror with one rank left out of the later
  ranks' running max (the card checks' planted fault) falls outside the bar.
  The planner in the chunk mode: every chunk taken once, in rank order, a
  block's shared memory within 227 KB.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from audio_llama_tpu.models import llama as j_llama  # noqa: E402
from audio_llama_tpu.ops import decode_attention as j_da  # noqa: E402
from audio_llama_tpu.ops import decode_attention_db as j_db  # noqa: E402
from audio_llama_tpu.ops import decode_attention_mono as j_dm  # noqa: E402
from audio_llama_tpu.ops import decode_attention_packed as j_pk  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_mono as dm  # noqa: E402
from audio_llama_tpu_torch.ops import decode_attention_packed as pk  # noqa: E402
from audio_llama_tpu_torch.ops import decode_timeline as tl  # noqa: E402
from test_torch_jax_cache import jax_compile_cache  # noqa: E402,F401  (autouse)

GS = (1, 2, 3, 4, 6, 8)
FMTS = ("bf16", "f32", "int8", "int4")
SMEM = 227 * 1024


def kernel_ranges(S, C):
    """decode_timeline.cuh's assignment: rank r's groups g0 = r ng / C to
    (r + 1) ng / C, integer division."""
    ng = S // 32
    return [(r * ng // C * 32, (r + 1) * ng // C * 32) for r in range(C)]


def owners(ranges, off):
    return [r for r, (s, e) in enumerate(ranges) if s <= off < e]


def timelines(cap):
    """Every slot count up to 2048, then a stride of 37 groups to the cap."""
    return list(range(32, 2049, 32)) + list(range(2048 + 37 * 32, cap, 37 * 32)) + [cap]


def check_plan(B, Hkv, S, G, hd, fmt):
    p = tl.timeline_plan(B, Hkv, S, G, hd, fmt)
    assert 1 <= p.C <= tl.MAX_CLUSTER and p.C <= S // 32 and 2 <= p.stages <= tl.MAX_STAGES
    ranges = kernel_ranges(S, p.C)
    assert ranges == p.ranges(S)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # each slot once, in order
    assert all(e > s and (e - s) % 32 == 0 for s, e in ranges)  # whole groups, none empty
    assert p.slots == max(e - s for s, e in ranges)
    assert p.smem == tl.block_smem(fmt, G, hd, p.slots, p.stages) <= SMEM
    for off in {0, ranges[-1][0], ranges[-1][0] - 1, S // 2, S - 1} - {-1}:
        assert len(owners(ranges, off)) == 1
    for off in (-5, -1, S, S + 31):
        assert owners(ranges, off) == []
    return p


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("hd", [64, 128])
def test_timeline_plan_covers_the_timeline_in_rank_order(fmt, hd):
    for G in GS:
        cap = tl.max_slots(G, hd, fmt)
        for S in timelines(cap):
            for B, Hkv in ((1, 8), (4, 8)):
                check_plan(B, Hkv, S, G, hd, fmt)
        for B, Hkv in ((2, 2), (16, 8), (64, 8)):
            check_plan(B, Hkv, cap, G, hd, fmt)
        with pytest.raises(ValueError, match="shared memory"):
            tl.timeline_plan(1, 8, cap + 32, G, hd, fmt)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("S", [1568, 3040])
def test_timeline_plan_fills_the_card_at_the_3b_shapes(fmt, S):
    p = tl.timeline_plan(1, 8, S, 3, 128, fmt)
    assert p.blocks >= 64 and p.C == 8
    p4 = tl.timeline_plan(4, 8, S, 3, 128, fmt)
    assert p4.blocks == 128 and p4.C == 4
    # past the one-block kernels' cap (the [G, S] logits in 227 KB)
    assert tl.max_slots(3, 128, fmt) > 20000


def header_constants():
    """The `constexpr` integers of csrc/decode_timeline.cuh, evaluated."""
    text = (Path(tl.__file__).resolve().parent.parent / "csrc" / "decode_timeline.cuh").read_text()
    values = {}
    for name, expr in re.findall(r"^constexpr (?:int|size_t) (k\w+) = ([^;]+);", text, re.M):
        values[name] = int(eval(expr, {"__builtins__": {}}, dict(values)))
    return values


def test_planner_constants_equal_the_kernels():
    """The planner's copy of the kernels' layout constants is the header's:
    the card tests hold whole layouts equal, this one holds it on the host."""
    k = header_constants()
    assert (k["kThreads"] // 32, k["kGroup"], k["kStageBytes"], k["kMaxStages"], k["kMaxCluster"],
            k["kHead"], k["kSmemMax"], k["kMaxG"]) == (tl.WARPS, tl.GROUP, tl.STAGE_BYTES,
                                                       tl.MAX_STAGES, tl.MAX_CLUSTER, tl.HEAD,
                                                       tl.SMEM_MAX, tl.MAX_G)
    assert tl.MAX_INBOX == k["kMaxCluster"]


def test_timeline_plan_refuses_an_unrounded_timeline():
    with pytest.raises(ValueError, match="S % 32"):
        tl.timeline_plan(1, 8, 100, 3, 128, "bf16")
    with pytest.raises(ValueError, match="chunk"):
        tl.timeline_plan(1, 8, 1568, 3, 128, "bf16", chunk=160)


def check_chunk_plan(B, Hkv, S, G, hd, fmt):
    CH = pk.pick_chunk(S, pk.DEFAULT_CHUNK)
    p = tl.timeline_plan(B, Hkv, S, G, hd, fmt, chunk=CH)
    nc = S // CH
    assert p.unit == CH and 1 <= p.C <= min(tl.MAX_CLUSTER, nc)
    if nc < tl.MAX_CLUSTER and B * Hkv * nc <= tl.SMS:
        assert p.C == nc  # fewer chunks than blocks shrink the cluster
    ranges = p.ranges(S)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))  # each chunk once, in order
    assert all(e > s and s % CH == 0 and (e - s) % CH == 0 for s, e in ranges)
    assert p.slots == max(e - s for s, e in ranges)
    assert p.smem == tl.block_smem(fmt, G, hd, p.slots, p.stages, p.slots // CH) <= SMEM
    return p


@pytest.mark.parametrize("fmt", ("bf16", "f32", "int8"))
def test_chunk_plan_takes_whole_chunks_in_rank_order(fmt):
    for G in GS:
        for S in list(range(32, 4097, 32)) + [6080, 8192]:
            for B, Hkv in ((1, 8), (4, 8), (2, 2)):
                check_chunk_plan(B, Hkv, S, G, 128, fmt)
    p = check_chunk_plan(1, 8, 3040, 3, 128, fmt)  # 19 chunks of 160
    assert p.C == 8 and [(e - s) // 160 for s, e in p.ranges(3040)] == [2, 2, 3, 2, 2, 3, 2, 3]
    assert check_chunk_plan(1, 8, 1568, 3, 128, fmt).C == 7  # 7 chunks of 224
    assert check_chunk_plan(4, 8, 3040, 3, 128, fmt).C == 4


# ---- (b) the cluster's arithmetic against the JAX package -------------------

L, B, HKV, G, HD, S, LAYER = 2, 2, 2, 3, 64, 128, 1
HQ = HKV * G
SCALE = HD ** -0.5
DEAD, FLOOR = -1e30, -5e29


def cluster_attend(q, k, v, valid, ranges, mode, p_dtype, k_scale=None, v_scale=None, unit=32,
                   skip_rank=-1):
    """The kernel's order over q [B, Hq, hd], K and V values k, v [B, Hkv,
    S, hd] (f32, the fresh row in place), per-slot scales [B, Hkv, S] (the
    fresh row's in place) or None, in a mode ('norm', 'stats', 'mono',
    'chunk': ranges of whole chunks of `unit` slots) -> out [B, Hq, hd] in
    q's dtype, or f32 (m, l, acc) in the stats mode."""
    normalized = mode == "norm"
    qg = q.float().reshape(B, HKV, G, HD)
    ok = (valid > 0)[:, None, None, :]
    logits, maxes = [], []
    for s, e in ranges:
        lg = torch.einsum("bhgd,bhsd->bhgs", qg, k[:, :, s:e])
        lg = lg * SCALE if k_scale is None else lg * (k_scale[:, :, s:e] * SCALE)[:, :, None, :]
        lg = torch.where(ok[..., s:e], lg, DEAD)
        logits.append(lg)
        maxes.append(lg.amax(dim=-1))
    if mode == "chunk":
        return chunk_attend(q, v, ok, ranges, logits, maxes, p_dtype, v_scale, unit, skip_rank)
    m = maxes[0]
    for mx in maxes[1:]:
        m = torch.maximum(m, mx)
    if not normalized:
        m = m.clamp(min=FLOOR)
    ps, l = [], torch.zeros_like(m)
    for (s, e), lg in zip(ranges, logits):
        p = torch.exp(lg - m[..., None])
        if not normalized:
            p = torch.where(ok[..., s:e], p, 0.0)
        ps.append(p)
        l = l + p.sum(dim=-1)  # the ranges' sums in rank order
    acc = torch.zeros((B, HKV, G, HD))
    for (s, e), p in zip(ranges, ps):
        pv = p / l[..., None] if normalized else p
        if v_scale is not None:
            pv = pv * v_scale[:, :, None, s:e]
        pv = pv.to(p_dtype).float()
        acc = acc + torch.einsum("bhgs,bhsd->bhgd", pv, v[:, :, s:e])  # in rank order
    if normalized:
        return acc.reshape(B, HQ, HD).to(q.dtype)
    if mode == "mono":
        out = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, 1.0)[..., None], 0.0)
        return out.reshape(B, HQ, HD).to(q.dtype)
    return m.reshape(B, HQ), l.reshape(B, HQ), acc.reshape(B, HQ, HD)


def chunk_attend(q, v, ok, ranges, logits, maxes, cdt, v_scale, unit, skip_rank):
    """The chunk mode's order: rank r starts from M_pre, the max over the
    ranks before it (-1e30 on rank 0; skip_rank left out, a planted fault),
    walks its chunks (m_c, alpha_c), weights chunk c's p by w_c, the product
    of its later chunks' alphas, and the ranks' (l_r, acc_r) are chained in
    rank order by their products of alphas A_r."""
    l = torch.zeros((B, HKV, G))
    acc = torch.zeros((B, HKV, G, HD))
    for r, ((s, e), lg) in enumerate(zip(ranges, logits)):
        m = torch.full((B, HKV, G), DEAD)
        for rr in range(r):
            if rr != skip_rank:
                m = torch.maximum(m, maxes[rr])
        ms, alphas = [], []
        for c0 in range(0, e - s, unit):
            m_new = torch.maximum(m, lg[..., c0:c0 + unit].amax(dim=-1))
            alphas.append(torch.exp(m - m_new))
            ms.append(m_new)
            m = m_new
        w, ws = torch.ones_like(m), [None] * len(ms)
        for j in reversed(range(len(ms))):
            ws[j] = w
            w = w * alphas[j]
        l_r, acc_r = torch.zeros_like(l), torch.zeros_like(acc)
        for j, c0 in enumerate(range(0, e - s, unit)):
            sl = slice(c0, c0 + unit)
            okc = ok[..., s + c0:s + c0 + unit]
            p = torch.where(okc, torch.exp((lg[..., sl] - ms[j][..., None]).to(cdt)).float(), 0.0)
            pv = p if v_scale is None else (p * v_scale[:, :, None, s + c0:s + c0 + unit]).to(
                cdt).float()
            l_r = l_r + (ws[j][..., None] * p).sum(dim=-1)
            acc_r = acc_r + torch.einsum("bhgs,bhsd->bhgd", ws[j][..., None] * pv,
                                         v[:, :, s + c0:s + c0 + unit])
        l = w * l + l_r  # w is A_r
        acc = w[..., None] * acc + acc_r
    return (acc / l[..., None]).reshape(B, HQ, HD).to(q.dtype)


def _t(x):
    a = np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def _valid(off, mask, S=S):
    """Slots up to each row's offset (off: an int or one a row), padding
    holes in row 1; `mask`: 'range' rank 1's range of 4 (slots 32-63),
    'slab' every slot of row 0, 'lead' the first `mask_n` slots."""
    offs = np.broadcast_to(np.asarray(off), (B,))
    valid = (np.arange(S)[None, :] <= np.minimum(offs, S - 1)[:, None]).astype(np.int32)
    valid[1, 3:6] = 0  # padding holes
    if mask == "range":
        valid[:, 32:64] = 0  # the whole of rank 1's range
    elif mask == "slab":
        valid[0] = 0  # every slot of a row
    elif isinstance(mask, int):
        valid[:, :mask] = 0  # the leading chunk(s)
    return valid


def _case(fmt, dtype, seed, S=S):
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    q = jnp.asarray(rng.normal(size=(B, HQ, HD)).astype(np.float32), jdt)
    if fmt == "cache":
        rows = [jnp.asarray(rng.normal(size=(B, HKV, HD)).astype(np.float32), jdt)
                for _ in range(2)]
        caches = [jnp.asarray(rng.normal(size=(L, B, HKV, S, HD)).astype(np.float32), jdt)
                  for _ in range(2)]
        return dict(q=q, rows=rows, caches=caches)
    big = [jnp.asarray(rng.normal(size=(L, B, HKV, S, HD)).astype(np.float32))
           for _ in range(2)]
    new = [jnp.asarray(rng.normal(size=(B, HKV, HD)).astype(np.float32)) for _ in range(2)]
    if fmt == "int8":
        (ck, ks), (cv, vs) = (j_llama.quantize_kv_rows(c) for c in big)
        (kn, ksn), (vn, vsn) = (j_llama.quantize_kv_rows(r) for r in new)
        return dict(q=q, rows=[kn, vn], caches=[ck, cv], scales=[ks, vs], fresh=[ksn, vsn])
    ckv, ks, vs = j_llama.quantize_kv_rows4(*big)
    kvn, ksn, vsn = j_llama.quantize_kv_rows4(*new)
    return dict(q=q, rows=[kvn], caches=[ckv], scales=[ks, vs], fresh=[ksn, vsn])


def _slab(c, fmt, off):
    """The layer's K and V values (f32) and scales with the fresh row (and
    its scales) at the offset (an int or one a row), as every read of the
    kernel sees them."""
    offs = np.broadcast_to(np.asarray(off), (B,))

    def patched(slab, new):
        slab = slab.clone()
        for b, o in enumerate(offs):
            if 0 <= o < slab.shape[2]:
                slab[b, :, o] = new[b]
        return slab

    rows = [_t(r) for r in c["rows"]]
    slabs = [_t(x)[LAYER] for x in c["caches"]]
    if fmt == "cache":
        return patched(slabs[0], rows[0]).float(), patched(slabs[1], rows[1]).float(), None, None
    ks, vs = (patched(_t(s)[LAYER], _t(n)) for s, n in zip(c["scales"], c["fresh"]))
    if fmt == "int8":
        return patched(slabs[0], rows[0]).float(), patched(slabs[1], rows[1]).float(), ks, vs
    kv = patched(slabs[0], rows[0]).to(torch.int32)
    return ((kv & 0xF) - 8).float(), (kv >> 4).float(), ks, vs


def _jax_call(kind, fmt, c, off, valid):
    v = jnp.asarray(valid)
    if kind == "single":
        if fmt == "cache":
            return j_da.decode_attention(c["q"], *c["rows"], *c["caches"], jnp.int32(LAYER),
                                         jnp.int32(off), v, SCALE, interpret=True)[0]
        ks, vs = (s[LAYER] for s in c["scales"])
        return j_da.decode_attention_quantized(c["q"], *c["rows"], *c["caches"], ks, vs,
                                               *c["fresh"], jnp.int32(LAYER), jnp.int32(off),
                                               v, SCALE, interpret=True)[0]
    stats = kind == "stats"
    if fmt == "cache":
        fn = j_db.decode_attention_db_stats if stats else j_db.decode_attention_db
        out = fn(c["q"], *c["rows"], *c["caches"], LAYER, off, v, SCALE, interpret=True)
    elif fmt == "int8":
        fn = j_db.decode_attention_quantized_db_stats if stats else \
            j_db.decode_attention_quantized_db
        ks, vs = (s[LAYER] for s in c["scales"])
        out = fn(c["q"], *c["rows"], *c["caches"], ks, vs, *c["fresh"], LAYER, off, v, SCALE,
                 interpret=True)
    else:
        fn = j_db.decode_attention_quantized4_db_stats if stats else \
            j_db.decode_attention_quantized4_db
        ks, vs = (s[LAYER] for s in c["scales"])
        out = fn(c["q"], c["rows"][0], c["caches"][0], ks, vs, *c["fresh"], LAYER, off, v,
                 SCALE, interpret=True)
    return out[:3] if stats else out[0]


MIRROR_CASES = [  # (kernel, cache format, dtype, offset, masked)
    ("single", "cache", "f32", 64, "range"),  # the first slot of rank 2's range
    ("single", "cache", "bf16", S - 1, "slab"),
    ("single", "int8", "f32", 50, None),  # mid-range
    ("single", "int8", "bf16", S + 5, "range"),  # past the timeline
    ("db", "cache", "f32", 95, "slab"),  # the last slot of rank 2's range
    ("db", "int8", "f32", S - 1, "range"),
    ("db", "int4", "bf16", 32, None),
    ("stats", "cache", "f32", 64, "slab"),
    ("stats", "int8", "f32", S + 5, None),
    ("stats", "int4", "f32", 50, "range"),
    ("stats", "cache", "bf16", 31, "range"),
]


@pytest.mark.parametrize("kind,fmt,dtype,off,mask", MIRROR_CASES)
def test_cluster_order_matches_the_pallas_kernels(kind, fmt, dtype, off, mask):
    c = _case(fmt, dtype, seed=off + len(fmt) + len(kind))
    valid = _valid(off, mask)
    plan = tl.timeline_plan(B, HKV, S, G, HD, "bf16" if fmt == "cache" else fmt)
    ranges = plan.ranges(S)
    assert len(ranges) == 4
    k, v, ks, vs = _slab(c, fmt, off)
    q = _t(c["q"])
    want = _jax_call(kind, fmt, c, off, valid)
    got = cluster_attend(q, k, v, torch.from_numpy(valid), ranges,
                         "stats" if kind == "stats" else "norm", q.dtype, ks, vs)
    tol = 1e-5 if dtype == "f32" else 2e-2
    if kind == "stats":
        for g, w in zip(got[:2], want[:2]):  # m and l
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=0)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=tol, rtol=tol)
        if mask == "slab":  # an all-invalid slab: (-5e29, 0, 0)
            assert (got[0][0] == FLOOR).all() and not got[1][0].any() and not got[2][0].any()
    else:
        assert got.dtype == q.dtype
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(jnp.asarray(want, jnp.float32)), atol=tol, rtol=tol)


# ---- (c) the mono mode: division after P V, one offset a row ----------------

MONO_CASES = [  # (dtype, row offsets, masked)
    ("f32", (64, S + 5), None),  # row 0 on rank 2's first slot, row 1 past the timeline
    ("bf16", (64, S + 5), None),
    ("f32", (31, 100), "range"),  # rank 1's range fully masked; row 0 on rank 0's last slot
    ("bf16", (95, 50), "slab"),  # row 0 fully masked
    ("f32", (S - 1, 32), "slab"),
]


@pytest.mark.parametrize("dtype,offs,mask", MONO_CASES)
def test_mono_mode_matches_the_pallas_kernel(dtype, offs, mask):
    """Every row against the port's contract, `decode_attention_plain`, and
    every row with a valid slot against JAX's kernel. A fully masked row is
    0 in the contract; JAX's kernel weights each of its -1e30 slots exp(0)
    there (the slab's average), a row no decode step reads."""
    c = _case("cache", dtype, seed=sum(offs) + len(dtype))
    valid = _valid(np.asarray(offs), mask)
    ranges = tl.timeline_plan(B, HKV, S, G, HD, dtype).ranges(S)
    assert len(ranges) == 4
    k, v, _, _ = _slab(c, "cache", np.asarray(offs))
    q = _t(c["q"])
    want = j_dm.decode_attention_mono(c["q"], *c["rows"], *c["caches"], jnp.int32(LAYER),
                                      jnp.asarray(offs, jnp.int32), jnp.asarray(valid), SCALE,
                                      interpret=True)[0]
    want = np.asarray(jnp.asarray(want, jnp.float32))
    plain = dm.decode_attention_plain(q, *map(_t, c["rows"]), *map(_t, c["caches"]), LAYER,
                                      torch.tensor(offs, dtype=torch.int32),
                                      torch.from_numpy(valid), SCALE)[0]
    got = cluster_attend(q, k, v, torch.from_numpy(valid), ranges, "mono", q.dtype)
    assert got.dtype == q.dtype
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=tol, rtol=tol)
    live = [b for b in range(B) if valid[b].any()]
    np.testing.assert_allclose(got.float().numpy()[live], want[live], atol=tol, rtol=tol)
    if mask == "slab":  # a fully masked row: l = 0, the output 0
        assert not got[0].any() and not plain[0].any()


# ---- (d) the chunk mode: the packed kernel's online softmax ------------------

CHUNK_CASES = [  # (cache format, dtype, S, chunk, offset, leading masked slots)
    ("cache", "f32", 640, 64, 256, 64),  # 10 chunks on 8 ranks; offset on a chunk boundary
    ("cache", "bf16", 640, 64, 639, 0),
    ("cache", "f32", 352, 32, 200, 0),  # 11 chunks of 32 on 8 ranks
    ("int8", "f32", 352, 32, 160, 32),  # a masked leading chunk, offset on a chunk boundary
    ("int8", "bf16", 640, 64, 300, 0),
    ("int8", "f32", 640, 64, 192, 128),  # rank 0's two chunks masked; offset on rank 2's start
]


def _chunk_run(fmt, dtype, S_, chunk, off, lead):
    c = _case(fmt, dtype, seed=off + S_ + lead, S=S_)
    valid = _valid(off, lead or None, S=S_)
    CH = pk.pick_chunk(S_, chunk)
    plan = tl.timeline_plan(B, HKV, S_, G, HD, "int8" if fmt == "int8" else dtype, chunk=CH)
    ranges = plan.ranges(S_)
    counts = [(e - s) // CH for s, e in ranges]
    assert len(set(counts)) > 1 and sum(counts) == S_ // CH  # uneven chunks a rank
    k, v, ks, vs = _slab(c, fmt, off)
    q = _t(c["q"])
    args = (LAYER, off, jnp.asarray(valid), SCALE)
    if fmt == "cache":
        want = j_pk.decode_attention_packed(c["q"], *c["rows"], *c["caches"], *args, chunk=CH,
                                            interpret=True)[0]
    else:
        sk, sv = (x[LAYER] for x in c["scales"])
        want = j_pk.decode_attention_quantized_packed(c["q"], *c["rows"], *c["caches"], sk, sv,
                                                      *c["fresh"], *args, chunk=CH,
                                                      interpret=True)[0]

    def mirror(skip_rank=-1):
        return cluster_attend(q, k, v, torch.from_numpy(valid), ranges, "chunk", q.dtype, ks, vs,
                              unit=CH, skip_rank=skip_rank)
    return mirror, np.asarray(jnp.asarray(want, jnp.float32)), ranges, CH


@pytest.mark.parametrize("fmt,dtype,S_,chunk,off,lead", CHUNK_CASES)
def test_chunk_mode_matches_the_pallas_kernel(fmt, dtype, S_, chunk, off, lead):
    mirror, want, _, _ = _chunk_run(fmt, dtype, S_, chunk, off, lead)
    got = mirror()
    assert got.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    tol = 1e-5 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("fmt", ["cache", "int8"])
def test_chunk_mode_without_a_rank_in_the_running_max_is_rejected(fmt):
    """The card checks' planted fault: the ranks after rank 1 start their walk
    without its chunks' maxima, so the products of alphas that chain the
    earlier ranks' sums are taken from the wrong max."""
    mirror, want, ranges, _ = _chunk_run(fmt, "f32", 352, 32, 340, 0)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(mirror().numpy(), want, atol=1e-5, rtol=1e-5)
    wrong = mirror(skip_rank=1).numpy()
    assert not (np.isfinite(wrong).all() and np.allclose(wrong, want, atol=2e-2, rtol=2e-2))
