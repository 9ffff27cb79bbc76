// Causal GQA attention forward, two-pass softmax, on wgmma and TMA.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_fwd_kernel_twopass
// (:188, called at :593; `causal_mha(softmax_mode='twopass')`). The function
// is the one causal_attention_fixed.cu's note defines: pass 1 takes the TRUE
// row max c of s + bias + causal mask over the key tiles at or before the
// diagonal; pass 2 forms p = exp(bf16(s + bias - c)) (with exp_bf16), rounds
// p to bf16, sums l from the rounded p and accumulates P V with no rescale;
// out o = l > 0 ? O / l : 0, l and c (the backward kernels' residuals).
// Shapes: qs [B, 2560, 24, 128] pre-scaled bf16, k/v [B, 2560, 8, 128], a
// [B, T] key bias of 0 / -1e9.
//
// Bound on the H100: operations, 4 * hd * Hq * B * T (T + 1) / 2 FLOP (QK^T
// and PV over the causal half; the repeated QK^T of pass 1 is not part of the
// function's work): 0.0815 ms at B 2, T 2560 at 989 TFLOP/s bf16.
//
// What held the first version back (attention_fwd.cuh's kSoftmaxTwoPass
// mode: 64 x 64 tiles of 4 warps, WMMA from shared memory, S stored as f32
// and read back, O loaded and stored for every key tile, K and V copied
// synchronously between barriers, 113 KB of shared memory for 8 warps an
// SM) and what this design does about it:
//   - a block owns 128 queries of one (b, q head): two consumer warpgroups of
//     64 rows and a producer warpgroup whose first thread issues TMA (its
//     other warps leave); setmaxnreg moves the producer's registers to the
//     consumers: 40 against 232, the 168 a thread of 384 at launch;
//   - K (pass 1) and K, V (pass 2) tiles of 128 keys, with the key bias's
//     128 values, stream through a ring of 2 stages with full and empty
//     mbarriers: the copies run ahead of the products;
//   - S = Q K^T is a wgmma SS product whose accumulator stays in registers;
//     the row max and sum use the quad shuffles of its layout; P is rounded
//     to bf16 in registers and is the A operand of P V (wgmma RS), V the B
//     operand through the transpose bit; O stays in registers to the end;
//   - the causal mask applies only on key tiles that reach past the
//     warpgroup's first query (elsewhere it is a no-op: 'cond');
//   - blocks run longest first (the highest query tile first), so the causal
//     half's long rows do not leave a tail.
// hd 16, 32, 64 and 128 (the column blocks and swizzle follow hd). Sums are
// in a fixed order (no atomics), so two launches give the same bits.
#include "sm90.cuh"

namespace al {
namespace twopass {

constexpr int BK = 128;    // keys a tile
constexpr int STAGES = 2;  // the K/V ring

template <int HD>
__global__ void __launch_bounds__(sm90::kAttnThreads, 1)
    twopass_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                   const AttnParams p, int B) {
  extern __shared__ unsigned char smem_raw[];
  const sm90::AttnRing<HD, BK, STAGES> ring(smem_raw);
  const sm90::AttnPlace at(p, B);
  const int n = (min(p.T, at.q0 + sm90::kAttnBQ) + BK - 1) / BK;  // tiles to the diagonal
  ring.init();

  if (at.wg == 2) {  // producer
    sm90::regs_dec<40>();
    if (threadIdx.x == 256) {
      ring.load_q(&tq, at.h, at.q0, at.b);
      for (int it = 0; it < 2 * n; ++it)  // pass 1: K; pass 2: K and V
        ring.load(it, &tk, it < n ? nullptr : &tv, &tb, at.kvh, it < n ? it : it - n, at.b, p.T);
    }
    return;
  }

  sm90::regs_inc<232>();
  const uint32_t sq = ring.q_rows(at.wg);
  float s[BK / 2];
  // S = Q K^T of the tile in stage st, retired
  auto scores = [&](int st) {
    sm90::wgmma_fence();
    sm90::issue_qk<HD, sm90::kAttnBQ, BK>(s, sq, sm90::smem_u32(ring.k(st)));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(s);
  };

  sm90::mbar_wait(ring.q_full, 0);
  float c0 = kNeg, c1 = kNeg;
  for (int j = 0; j < n; ++j) {  // pass 1: the true row max
    const int st = ring.acquire(j);
    scores(st);
    const bool mask = j * BK + BK - 1 > at.wrow;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float2 x = sm90::logits<BK>(s, i, j, mask, ring.bias(st), at);
      if (i & 2) c1 = fmaxf(c1, fmaxf(x.x, x.y));
      else c0 = fmaxf(c0, fmaxf(x.x, x.y));
    }
    ring.release(j);
  }
  c0 = sm90::quad_max(c0);
  c1 = sm90::quad_max(c1);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n; ++j) {  // pass 2: p, l and P V
    const int st = ring.acquire(n + j);
    scores(st);
    const bool mask = j * BK + BK - 1 > at.wrow;
    uint32_t pb[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float2 x = sm90::logits<BK>(s, i, j, mask, ring.bias(st), at);
      const float c = (i & 2) ? c1 : c0;
      float e0 = x.x - c, e1 = x.y - c;
      if (p.exp_bf16) {
        e0 = __bfloat162float(__float2bfloat16(e0));
        e1 = __bfloat162float(__float2bfloat16(e1));
      }
      const __nv_bfloat162 pr = __floats2bfloat162_rn(expf(e0), expf(e1));
      const float2 pf = __bfloat1622float2(pr);
      if (i & 2) l1 += pf.x + pf.y;
      else l0 += pf.x + pf.y;
      pb[i / 2] = sm90::bf16_pair(pr);
    }
    sm90::wgmma_fence();
    sm90::issue_pv<HD, BK>(o, pb, sm90::smem_u32(ring.v(st)));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(o);
    sm90::keep(pb);
    ring.release(n + j);
  }
  sm90::store_rows<HD>(o, l0, l1, c0, c1, p, at);
}

}  // namespace twopass

// The two-pass forward on Hopper (al_causal_attention_fixed's softmax == 2).
cudaError_t twopass_fwd_sm90(const AttnParams& p, int B, int hd, cudaStream_t stream) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return sm90::launch_attn<HD, twopass::BK>(twopass::twopass_kernel<HD>,
                                             sm90::AttnRing<HD, twopass::BK,
                                                            twopass::STAGES>::kSmem,
                                             p, B, stream);
  });
}

cudaError_t twopass_fwd_sm90_info(int hd, int* out) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return sm90::kernel_info(twopass::twopass_kernel<HD>, sm90::kAttnThreads,
                             sm90::AttnRing<HD, twopass::BK, twopass::STAGES>::kSmem, out);
  });
}

}  // namespace al

// out[4]: registers per thread, local (spilled) bytes, dynamic shared memory
// and resident blocks per SM of a wgmma / TMA attention forward at head_dim
// hd; kind 0: the two-pass forward, 1: dma2.
AL_EXPORT int al_sm90_kernel_info(int kind, int hd, int* out) {
  if (kind == 0) return al::twopass_fwd_sm90_info(hd, out);
  if (kind == 1) return al::dma2_fwd_sm90_info(hd, out);
  return cudaErrorInvalidValue;
}
