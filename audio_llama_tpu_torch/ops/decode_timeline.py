"""The launch plan of the timeline decode kernels (csrc/decode_timeline.cuh).

The single-buffered decode attention (`ops/decode_attention.py`, rows 29
and 30), the db kernels (`ops/decode_attention_db.py`, rows 13-18), the
bf16 main path's decode attention (`ops/decode_attention_mono.py`, row 4)
and the packed kernel (`ops/decode_attention_packed.py`, row 19) run on one
core: each (batch row, KV head) is a thread-block cluster of C blocks along
the timeline, block rank r taking the slots [`block_range(S, C, r, unit)`),
a whole number of units in timeline order: 32-slot groups, or the packed
kernel's chunks (its online softmax rounds p per chunk). A block streams
its K rows, then its V rows, through a ring of `stages` shared-memory
stages of `stage_rows` rows; the cluster's blocks exchange their softmax
max and sum and add their P V partials in rank order through distributed
shared memory.

`timeline_plan` picks C and the ring. C brings the blocks B * Hkv * C near
the card's 132 SMs, at most 8 (the portable cluster size) and at most the
units of the timeline; a timeline whose ranges do not fit one block's
shared memory takes more blocks, then fewer stages, and past that raises
ValueError. `block_smem` is the byte
count the kernels lay out (decode_timeline.cuh's `layout`); the card
tests hold the two equal through `kernel_info`, and
tests/test_torch_decode_timeline.py holds the constants here to the
header's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

SMS = 132  # streaming multiprocessors of the H100
MAX_CLUSTER = 8  # the portable cluster size
MAX_G = 8  # the most query heads a KV head
GROUP = 32  # slots of a range's unit
STAGE_BYTES = 32 * 1024  # a ring stage's target size
WARPS = 8  # a block's warps (decode_timeline.cuh's kThreads / 32)
HEAD = 1024  # bytes of a block's barriers, reduction scratch and exchange inboxes
RING_BYTES = 64 * 1024  # the ring's budget before the timeline needs its bytes
MAX_STAGES = 12
MAX_INBOX = MAX_CLUSTER  # the partials' inbox pads q's bytes by up to C floats
SMEM_MAX = 227 * 1024  # shared memory a block can use on the H100
ELEM_BYTES = {"bf16": 2, "f32": 4, "int8": 1, "int4": 1}
QUANT = ("int8", "int4")


def row_bytes(fmt: str, hd: int) -> int:
    """Bytes of one cache row a pass reads (int4: the K/V-combined row)."""
    return hd * ELEM_BYTES[fmt]


def stage_rows(fmt: str, hd: int) -> int:
    """Rows of a ring stage: STAGE_BYTES of rows, 32 to 256, a multiple of
    32 (decode_timeline.cuh's `stage_rows`)."""
    return max(GROUP, min(256, STAGE_BYTES // row_bytes(fmt, hd) // GROUP * GROUP))


def block_range(S: int, C: int, r: int, unit: int = GROUP) -> Tuple[int, int]:
    """The slots [start, end) of block rank r of C over S slots, in units of
    `unit` slots."""
    ng = S // unit
    return r * ng // C * unit, (r + 1) * ng // C * unit


def range_slots(S: int, C: int, unit: int = GROUP) -> int:
    """The most slots any block of C takes (what its shared memory holds)."""
    return -(-(S // unit) // C) * unit


def block_smem(fmt: str, G: int, hd: int, n: int, stages: int, chunks: int = 0) -> int:
    """Dynamic shared memory of a block over at most n slots: the barriers,
    scratch and inboxes, the ring (later the warps' P V partials), q (later
    the partials' inbox, up to MAX_CLUSTER floats longer), the [G, n] logits,
    the valid flags and, quantized, the K and V scales; in the chunk mode
    (at most `chunks` chunks a block) the blocks' products of alphas and
    each head's chunk maxima and weights."""
    ring = max(stages * stage_rows(fmt, hd) * row_bytes(fmt, hd), WARPS * G * hd * 4)
    meta = n * 4 * (3 if fmt in QUANT else 1)
    chunk = 4 * (MAX_CLUSTER * MAX_G + 2 * G * chunks) if chunks else 0
    return HEAD + ring + 4 * (G * hd + MAX_INBOX) + 4 * G * n + meta + chunk


class TimelinePlan(NamedTuple):
    """C blocks a cluster, `stages` ring stages, `slots` the most slots a
    block takes, `smem` bytes a block; `clusters` B * Hkv; `unit` the slots
    of a range's unit (32, or the chunk mode's chunk)."""
    C: int
    stages: int
    slots: int
    smem: int
    clusters: int
    unit: int = GROUP

    @property
    def blocks(self) -> int:
        return self.clusters * self.C

    def ranges(self, S: int):
        return [block_range(S, self.C, r, self.unit) for r in range(self.C)]


@functools.lru_cache(maxsize=None)
def timeline_plan(B: int, Hkv: int, S: int, G: int, hd: int, fmt: str,
                  chunk: int = 0) -> TimelinePlan:
    """The launch for B batch rows, Hkv KV heads of G query heads, S slots
    (S % 32 == 0) and head dim hd of a cache format ('bf16', 'f32', 'int8',
    'int4'); chunk > 0: the chunk mode, each block a whole number of chunks
    of `chunk` slots (a multiple of 32 dividing S). ValueError where no
    plan fits a block's shared memory."""
    if S % GROUP or S <= 0:
        raise ValueError(f"timeline decode needs S % {GROUP} == 0 (got {S})")
    unit = chunk or GROUP
    if unit % GROUP or S % unit:
        raise ValueError(f"timeline decode: the chunk {chunk} must be a multiple of {GROUP} "
                         f"dividing S = {S}")
    ng = S // unit
    C = min(max(1, min(MAX_CLUSTER, SMS // max(1, B * Hkv))), ng)
    stages = max(2, min(MAX_STAGES, RING_BYTES // (stage_rows(fmt, hd) * row_bytes(fmt, hd))))
    top = min(MAX_CLUSTER, ng)
    while True:
        n = range_slots(S, C, unit)
        smem = block_smem(fmt, G, hd, n, stages, n // unit if chunk else 0)
        if smem <= SMEM_MAX:
            return TimelinePlan(C, stages, n, smem, B * Hkv, unit)
        if C < top:
            C += 1
        elif stages > 2:
            stages -= 1
        else:
            raise ValueError(
                f"timeline decode: {S} slots of G {G}, hd {hd}, {fmt} need {smem} bytes of "
                f"shared memory a block at {C} blocks a cluster, past the {SMEM_MAX} a block "
                f"can use")


def max_slots(G: int, hd: int, fmt: str) -> int:
    """The longest timeline `timeline_plan` places (any B, Hkv)."""
    ring = max(2 * stage_rows(fmt, hd) * row_bytes(fmt, hd), WARPS * G * hd * 4)
    per_slot = 4 * G + 4 * (3 if fmt in QUANT else 1)
    per = (SMEM_MAX - HEAD - ring - 4 * (G * hd + MAX_INBOX)) // per_slot
    return MAX_CLUSTER * (per // GROUP) * GROUP


def cache_fmt(dtype_or_fmt) -> str:
    """'bf16' / 'f32' for a torch dtype, or the quantized format's name."""
    import torch

    if dtype_or_fmt in QUANT:
        return dtype_or_fmt
    return {torch.bfloat16: "bf16", torch.float32: "f32"}[dtype_or_fmt]


KINDS = ("db_stats", "db", "mono", "packed")  # the core's modes, by kernel_info's names


def kernel_info(kind: str, fmt: str, dtype_code: int, G: int, S: int, hd: int,
                plan: TimelinePlan) -> dict:
    """Registers per thread, local (spilled) bytes, the shared memory the
    launch lays out and the clusters of plan.C blocks resident at once of
    the instance of `kind` (KINDS: 'db_stats', 'db' the normalized mode,
    which the single-buffered kernel's calls share, 'mono' row 4's mode,
    'packed' the chunk mode at plan.unit), from the CUDA runtime."""
    import ctypes

    from . import _cuda

    out = (ctypes.c_int * 4)()
    fmt_code = {"bf16": 0, "f32": 0, "int8": 1, "int4": 2}[fmt]
    err = _cuda.library().al_decode_timeline_info(
        KINDS.index(kind), fmt_code, dtype_code, G, S, hd, plan.C, plan.stages, plan.unit,
        ctypes.cast(out, ctypes.c_void_p))
    _cuda.check(err, f"timeline decode info ({kind})")
    return dict(registers=out[0], local_bytes=out[1], smem_bytes=out[2],
                clusters_resident=out[3])
