// Causal GQA attention forward, bounded shift, software-pipelined: the
// `dma2` arm, on wgmma and TMA.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_fwd_kernel_dma2 (:321,
// called at :436; `causal_mha(fwd_impl='dma2')`). The TPU kernel copies K/V
// chunk by chunk by hand, only for the chunks at or before the diagonal,
// triple-buffered, and carries chunk j's scores through its loop so that
// chunk j+1's QK^T (MXU) is emitted beside chunk j's softmax (VPU). The
// function (the bounded family's): c_i = ||qs_i|| * kn[b, kv head]
// (`row_bound`), p = exp(s + bias - c) in f32 with the causal mask's -1e9,
// l summed from that f32 p, P rounded to bf16 for P V, o = l > 0 ? O / l : 0
// (a row whose exp all underflow is 0), l and c written. T % 64 == 0.
// Shapes: qs [B, 2560, 24, 128] pre-scaled bf16, k/v [B, 2560, 8, 128], a
// [B, T] key bias, kn [B, 8] f32.
//
// Bound on the H100: operations, 4 * hd * Hq * B * T (T + 1) / 2 FLOP (QK^T
// and PV over the causal half): 0.0815 ms at B 2, T 2560 at 989 TFLOP/s bf16.
//
// The first version (the PIPELINED half of the WMMA dma kernel) ran the
// WMMA tile loop behind three cp.async stages: S and O went
// through shared memory, and at 195 KB of it one block of 4 warps an SM fed
// the tensor cores. This design keeps what dma2 is and moves it onto
// Hopper's units:
//   - a block owns 128 queries of one (b, q head): two consumer warpgroups of
//     64 rows and a producer warpgroup whose first thread issues TMA (its
//     other warps leave); setmaxnreg moves the producer's registers to the
//     consumers: 40 against 232, the 168 a thread of 384 at launch;
//   - K, V and the key bias of the valid 64-key tiles only (nv = q0 / 64 + 2
//     for the block, capped at T / 64) stream through a three-deep ring with
//     full and empty mbarriers; a stage is released only after the P V that
//     reads its V has retired;
//   - FA3's intra-warpgroup overlap in place of the MXU / VPU overlap: for
//     tile j, (1) issue S_{j+1} = Q K_{j+1}^T (wgmma SS, async), (2) form
//     tile j's p and l from S_j in registers, (3) wait for S_{j+1}, (4) issue
//     P_j V_j (wgmma RS, P from registers, V through the transpose bit),
//     which retires before tile j's stage is released. Two score tiles are
//     live, so the tiles are 64 keys wide; no product stays in flight from
//     one tile to the next (ptxas serializes an RS product carried over);
//   - O stays in registers; the causal mask applies only on tiles that reach
//     past the warpgroup's first query (a no-op elsewhere); blocks run
//     longest first.
// hd 16, 32, 64 and 128. Sums are in a fixed order (no atomics): two launches
// give the same bits. The bounded kernel (causal_attention_fixed.cu: 128-key
// tiles, no S_{j+1} overlap) visits each thread's keys, and P V's k-steps, in
// the same order, and a masked key adds an exact 0, so on the card the two
// have given the same bits; the checks hold them to row 3's bar.
#include "sm90.cuh"

namespace al {
namespace dma2 {

constexpr int BK = 64;     // keys a tile (two live score tiles a thread)
constexpr int STAGES = 3;  // the K/V ring

template <int HD>
__global__ void __launch_bounds__(sm90::kAttnThreads, 1)
    dma2_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                const AttnParams p, int B) {
  extern __shared__ unsigned char smem_raw[];
  const sm90::AttnRing<HD, BK, STAGES> ring(smem_raw);
  const sm90::AttnPlace at(p, B);
  const int nv = min(p.T / BK, at.q0 / BK + 2);  // the block's valid tiles
  ring.init();

  if (at.wg == 2) {  // producer
    sm90::regs_dec<40>();
    if (threadIdx.x == 256) {
      ring.load_q(&tq, at.h, at.q0, at.b);
      for (int j = 0; j < nv; ++j) ring.load(j, &tk, &tv, &tb, at.kvh, j, at.b, p.T);
    }
    return;
  }

  sm90::regs_inc<232>();
  const int n = min(p.T / BK, at.wrow / BK + 1);  // this warpgroup's tiles (nv or nv - 1)
  const uint32_t sq = ring.q_rows(at.wg);

  const __nv_bfloat16* qb = p.q + at.b * p.q_sb + at.h * p.q_sh;
  const float kn = p.kn[at.b * p.Hkv + at.kvh];
  const float c0 = sm90::row_norm<HD>(qb + (long long)at.row0 * p.q_st, at.row0 < p.T) * kn;
  const float c1 = sm90::row_norm<HD>(qb + (long long)at.row1 * p.q_st, at.row1 < p.T) * kn;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  uint32_t pb[BK / 4];
  float sa[BK / 2], sb[BK / 2];

  auto issue_scores = [&](float (&s)[BK / 2], int j) {
    const int st = ring.acquire(j);
    sm90::wgmma_fence();
    sm90::issue_qk<HD, sm90::kAttnBQ, BK>(s, sq, sm90::smem_u32(ring.k(st)));
    sm90::wgmma_commit();
  };
  // tile j from its retired scores `cur`, with tile j+1's QK^T into `nxt`
  auto step = [&](float (&cur)[BK / 2], float (&nxt)[BK / 2], int j) {
    const bool more = j + 1 < n;
    if (more) issue_scores(nxt, j + 1);  // (1)
    const int st = j % STAGES;  // (2)
    const bool mask = j * BK + BK - 1 > at.wrow;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float2 x = sm90::logits<BK>(cur, i, j, mask, ring.bias(st), at);
      const float c = (i & 2) ? c1 : c0;
      const float e0 = expf(x.x - c), e1 = expf(x.y - c);
      if (i & 2) l1 += e0 + e1;
      else l0 += e0 + e1;
      pb[i / 2] = sm90::bf16_pair(__floats2bfloat162_rn(e0, e1));
    }
    if (more) {  // (3)
      sm90::wgmma_wait<0>();
      sm90::keep(nxt);
    }
    sm90::wgmma_fence();  // (4)
    sm90::issue_pv<HD, BK>(o, pb, sm90::smem_u32(ring.v(st)));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // P_j V_j retires: the stage is free, P may be rewritten
    sm90::keep(o);
    sm90::keep(pb);
    ring.release(j);
  };

  sm90::mbar_wait(ring.q_full, 0);
  issue_scores(sa, 0);
  sm90::wgmma_wait<0>();
  sm90::keep(sa);
  for (int j = 0; j < n; j += 2) {
    step(sa, sb, j);
    if (j + 1 < n) step(sb, sa, j + 1);
  }
  for (int j = n; j < nv; ++j) {  // a tile past this warpgroup's rows: release it
    ring.acquire(j);
    ring.release(j);
  }
  sm90::store_rows<HD>(o, l0, l1, c0, c1, p, at);
}

}  // namespace dma2

// The pipelined bounded forward on Hopper (al_causal_attention_dma's
// pipelined branch). T % 64 == 0, checked by the caller.
cudaError_t dma2_fwd_sm90(const AttnParams& p, int B, int hd, cudaStream_t stream) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return sm90::launch_attn<HD, dma2::BK>(
        dma2::dma2_kernel<HD>, sm90::AttnRing<HD, dma2::BK, dma2::STAGES>::kSmem, p, B, stream);
  });
}

cudaError_t dma2_fwd_sm90_info(int hd, int* out) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return sm90::kernel_info(dma2::dma2_kernel<HD>, sm90::kAttnThreads,
                             sm90::AttnRing<HD, dma2::BK, dma2::STAGES>::kSmem, out);
  });
}

}  // namespace al
