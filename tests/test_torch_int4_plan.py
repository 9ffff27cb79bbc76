"""The launch plans of the card's int4 decode kernels, on the host.

`ops.int4_matmul.decode_plan` (the W4A16 up to 64 rows) and
`ops.mlp_int4.mlp_plan` (the fused MLP) pick the clusters, row ranges and
K chunks that csrc/int4_common.cuh's `run_unit` walks: a cluster of C
blocks along K, block rank r taking rows [k0 + r kn, k0 + (r + 1) kn) of a
tile of 64 packed columns in 64-row ring stages. These tests mirror
that assignment and check, for every M <= 64, group 32-256, K of the 3B
widths (3072, 8192) and toy widths, and the K-split's blocks: every K row
is taken once by each tile; a block's rows are whole stages and whole
groups inside one K block, so `unit_sum`'s order (ranks in order inside a K
block, then the blocks) is the K-split's; shared memory fits a block; the
3B decode shapes put at least 132 blocks on the card; a down unit of the
MLP waits only on gate|up tiles that exist. Exact, no tolerance.
"""

import pytest

from audio_llama_tpu_torch.ops import int4_matmul as i4
from audio_llama_tpu_torch.ops import mlp_int4 as mlp4

GROUPS = (32, 64, 128, 256)
ROWS = range(1, i4.DECODE_MAX_M + 1)
SMS = 132


def block_rows(C, K, k0=0):
    """run_unit's row ranges by block rank, in unit_sum's order."""
    kn = K // C
    return [(k0 + r * kn, k0 + (r + 1) * kn) for r in range(C)]


def check_unit(C, K, span, group, k0=0):
    assert 1 <= C <= 8 and K % C == 0
    rows = block_rows(C, K, k0)
    assert rows[0][0] == k0 and rows[-1][1] == k0 + K
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))  # each row once, in order
    for s, e in rows:
        assert (e - s) % i4.KROWS == 0  # whole ring stages
        assert s % group == 0 and e % group == 0  # whole groups
        assert (s - k0) // span == (e - 1 - k0) // span  # inside one K block


@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("K,Nh", [(3072, 2560), (3072, 1536), (8192, 1536), (3072, 8192),
                                  (256, 128), (512, 384), (1536, 384)])
def test_decode_plan_takes_every_row_once_in_the_k_splits_order(group, K, Nh):
    for bk in (0, 128, 256, 768, 1536):
        if bk and (K % bk or bk % group) or (K % group):
            continue
        if bk and (bk % i4.KROWS or 8 * bk < K):  # K blocks the ring cannot take
            for M in ROWS:  # the wrappers launch the prefill kernel, every K block
                with pytest.raises(ValueError, match="no launch"):
                    i4.decode_plan(M, K, Nh, group, bk)
                assert i4.decode_plan_or_none(M, K, Nh, group, bk) is None
            continue
        for M in ROWS:
            p = i4.decode_plan(M, K, Nh, group, bk)
            assert p.nt == i4.decode_instance(M) and 8 * p.nt >= M
            assert p.bk == (bk or K)
            check_unit(p.C, K, p.bk, group)
            assert p.tiles * i4.TILE == Nh  # every packed column in one tile
            assert p.smem == i4.unit_smem(p.nt, K // p.C, group) <= i4._SMEM_MAX
            # the largest cluster that tiles K so
            assert all(K % C or (K // C) % i4.KROWS or (K // C) % group or p.bk % (K // C)
                       or i4.unit_smem(p.nt, K // C, group) > i4._SMEM_MAX
                       for C in range(p.C + 1, 9))


@pytest.mark.parametrize("group,K,F,D", [
    (g, K, F, D) for g in GROUPS
    for K, F, D in ((3072, 8192, 3072), (256, 1024, 256), (512, 1536, 768), (256, 512, 256))
    if K % g == 0 and F % g == 0])
def test_mlp_plan_takes_every_row_once_and_waits_on_earlier_tiles(group, K, F, D):
    dh = D // 2
    for M in ROWS:
        p = mlp4.mlp_plan(M, K, F, dh, group)
        assert p is not None and p.nt == i4.decode_instance(M)
        tw = i4.TILE
        assert p.tiles_g * tw == F and p.tiles_d * tw == dh
        check_unit(p.C, K, K, group)  # gate|up: all K, one K block
        kcr = F // p.n_kc
        assert kcr * p.n_kc == F
        ready = set()
        for kc in range(p.n_kc):  # down: each K chunk of F rows
            check_unit(p.C, kcr, kcr, group, k0=kc * kcr)
            for kb, ke in block_rows(p.C, kcr, kc * kcr):  # the gate|up tiles a block waits on
                tiles = range(kb // tw, (ke - 1) // tw + 1)
                assert all(0 <= t < p.tiles_g for t in tiles)
                ready.update(tiles)
        assert ready == set(range(p.tiles_g))  # every activation is read
        assert p.units == p.tiles_g + p.n_kc * p.tiles_d
        assert p.counters == 2 + p.tiles_g + p.tiles_d
        smem = max(i4.unit_smem(p.nt, K // p.C, group),
                   i4.unit_smem(p.nt, kcr // p.C, group))
        assert p.smem == smem <= i4._SMEM_MAX


@pytest.mark.parametrize("group", GROUPS)
def test_plans_fill_the_card_at_the_3b_decode_shapes(group):
    """q|k|v, o and q_proj, whole K and under the K-split, at every M <= 64,
    and the fused MLP's two products: at least one block an SM. (At group 256
    a 768-row K block holds blocks of 256 or 768 rows only, three or one: o's
    24 tiles cannot reach 132 blocks there, and it is left out.)"""
    for M in ROWS:
        for K, Nh in ((3072, 2560), (3072, 1536)):
            for bk in (0, 768, 1536):
                if bk % group or (group, bk, Nh) == (256, 768, 1536):
                    continue
                assert i4.decode_plan(M, K, Nh, group, bk).blocks >= SMS, (M, K, Nh, bk)
        p = mlp4.mlp_plan(M, 3072, 8192, 1536, group)
        assert p.tiles_g * p.C >= SMS and p.n_kc * p.tiles_d * p.C >= SMS, (M, p)


def test_decode_plan_refuses_what_the_ring_cannot_tile():
    # K blocks of 32 rows: below one 64-row stage
    with pytest.raises(ValueError, match="no launch"):
        i4.decode_plan(4, 8192, 1536, 32, 32)
    assert i4.decode_plan_or_none(4, 8192, 1536, 32, 32) is None
    assert i4.decode_plan_or_none(65, 3072, 2560, 128) is None  # past 64 rows
    assert i4.decode_plan_or_none(64, 3072, 2560, 128) is not None
    assert mlp4.kernel_chunk(8192, 1536, 32) == 128
    assert mlp4.kernel_chunk(8192, 1568, 32) is None  # D/2 not in 64-column tiles
