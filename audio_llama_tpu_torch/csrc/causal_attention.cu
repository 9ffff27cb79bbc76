// Causal GQA attention forward, online softmax, on wgmma and TMA: the
// prefill's and training's causal attention and the sp ring's hops.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_fwd_kernel (:101;
// causal_mha, softmax_mode='online') in its three masks:
//   tri='always': the main path. q [1, 1536, 24, 128] pre-scaled bf16, k/v
//       [1, 1536, 8, 128], a [B, T] key-padding bias of 0 / -1e9, 28 calls
//       a prefill; B 2, T 2048 in training, 224 calls a train A step;
//   tri='cond' (:125-131, fwd_impl='blocks_cond'): the causal mask only on
//       the key tiles that reach past a tile's first query;
//   tri='never' (:114-132): every hop of the sequence-parallel ring whose
//       keys come from an earlier shard (ring_kernel.py:46): no causal mask,
//       every key tile, the source shard's key bias.
// Writes o and the row statistics l (denominator) and m (the true row max)
// as [B*Hq, T] f32, the residuals the backward kernels and the ring's merge
// read.
//
// The function: over the key tiles of s + bias (the causal mask's finite
// -1e9 where a key lies in the query's future, so a row whose every key is
// masked stays finite), m' = max(m, rowmax), r = exp(m - m'), P =
// bf16(exp(s + bias - m')) with exp in f32 (the TPU kernel runs it in
// bf16), l = l r + the row sum of the ROUNDED P (the denominator from the P
// that meets V, as the TPU kernel's ones column), O = O r + P V; o = O / l.
//
// Bound on the H100: operations. Causal: 4 * hd * Hq * B * T (T + 1) / 2
// FLOP (14.5 GFLOP at B 1, T 1536: 0.0147 ms at 989 TFLOP/s bf16; 80.6 at B
// 2, T 2560: 0.0815 ms). 'never': 4 * hd * Hq * B * T^2 (25.8 GFLOP at the
// sp = 2 hop of training, B 2, T 1024: 0.0261 ms).
//
// The first version (a WMMA tile loop, since removed: 64 x 64 tiles of four
// warps, WMMA from shared memory, S stored as f32 and read back, O loaded
// and stored for every key tile, K and V copied synchronously between
// barriers) ran at 29-38 TFLOP/s. This design is dma2's (causal_attention_dma2.cu) with the
// online softmax:
//   - a block owns 128 queries of one (b, q head): two consumer warpgroups
//     of 64 rows and a producer warpgroup whose first thread issues TMA;
//     setmaxnreg gives the consumers 232 registers, the producer 40;
//   - K, V and the key bias of 64-key tiles stream through a three-deep
//     ring with full and empty mbarriers: in the causal modes only the tiles
//     at or before the block's diagonal, in 'never' all of them;
//   - per tile j: (1) issue S_{j+1} = Q K_{j+1}^T (wgmma SS) ahead; (2) from
//     S_j in registers take the row max (quad shuffles), r, P and l; (3)
//     wait for S_{j+1}; (4) rescale O by r in registers (P_{j-1} V_{j-1} has
//     retired) and issue P_j V_j (wgmma RS, V through the transpose bit),
//     which retires before the stage is released. Two score tiles are live,
//     so the tiles are 64 keys wide;
//   - 'always' and 'cond' run one loop, the mask on only the tiles that
//     reach past the warpgroup's first query (a no-op elsewhere), so the two
//     give the same bits; 'never' masks only the keys at or past T;
//   - blocks run longest first.
// hd 16, 32, 64 and 128; any T (TMA zero-fills rows past T, and the mask
// hides those keys). Sums are in a fixed order (no atomics): two launches
// give the same bits.
#include "sm90.cuh"

namespace al {
namespace online {

constexpr int BK = 64;     // keys a tile (two live score tiles a thread)
constexpr int STAGES = 3;  // the K/V ring

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(sm90::kAttnThreads, 1)
    online_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                  const AttnParams p, int B) {
  extern __shared__ unsigned char smem_raw[];
  const sm90::AttnRing<HD, BK, STAGES> ring(smem_raw);
  const sm90::AttnPlace at(p, B);
  const int nt = (p.T + BK - 1) / BK;
  const int nv = CAUSAL ? min(nt, at.q0 / BK + 2) : nt;  // the block's tiles
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
  const int n = CAUSAL ? min(nt, at.wrow / BK + 1) : nt;  // this warpgroup's tiles
  const uint32_t sq = ring.q_rows(at.wg);
  // the last key a row sees: the row itself (causal), T - 1 ('never')
  sm90::AttnPlace last = at;
  if (!CAUSAL) last.row0 = last.row1 = p.T - 1;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
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
    const bool mask = CAUSAL ? j * BK + BK - 1 > at.wrow : (j + 1) * BK > p.T;
    // cur is only read: a write to an accumulator while S_{j+1} is in flight
    // makes ptxas serialize the wgmma, so the exp pass forms the logits again
    float x0 = m0, x1 = m1;  // the new row maxima
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float2 x = sm90::logits<BK>(cur, i, j, mask, ring.bias(st), last);
      if (i & 2) x1 = fmaxf(x1, fmaxf(x.x, x.y));
      else x0 = fmaxf(x0, fmaxf(x.x, x.y));
    }
    x0 = sm90::quad_max(x0);
    x1 = sm90::quad_max(x1);
    const float r0 = __expf(m0 - x0), r1 = __expf(m1 - x1);
    m0 = x0;
    m1 = x1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float2 x = sm90::logits<BK>(cur, i, j, mask, ring.bias(st), last);
      const float m = (i & 2) ? m1 : m0;
      const __nv_bfloat162 pr = __floats2bfloat162_rn(__expf(x.x - m), __expf(x.y - m));
      const float2 pf = __bfloat1622float2(pr);
      if (i & 2) s1 += pf.x + pf.y;
      else s0 += pf.x + pf.y;
      pb[i / 2] = sm90::bf16_pair(pr);
    }
    l0 = l0 * r0 + s0;
    l1 = l1 * r1 + s1;
    if (more) {  // (3)
      sm90::wgmma_wait<0>();
      sm90::keep(nxt);
    }
#pragma unroll
    for (int i = 0; i < HD / 2; i += 4) {  // (4)
      o[i] *= r0;
      o[i + 1] *= r0;
      o[i + 2] *= r1;
      o[i + 3] *= r1;
    }
    sm90::wgmma_fence();
    sm90::issue_pv<HD, BK>(o, pb, sm90::smem_u32(ring.v(st)));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // P_j V_j retires: the stage is free, P and O may be rewritten
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
  sm90::store_rows<HD>(o, l0, l1, m0, m1, p, at);
}

template <bool CAUSAL>
cudaError_t launch(const AttnParams& p, int B, int hd, cudaStream_t stream) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return sm90::launch_attn<HD, BK>(online_kernel<HD, CAUSAL>,
                                     sm90::AttnRing<HD, BK, STAGES>::kSmem, p, B, stream);
  });
}

}  // namespace online

cudaError_t online_fwd_sm90_info(int hd, bool causal, int* out) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    constexpr size_t smem = sm90::AttnRing<HD, online::BK, online::STAGES>::kSmem;
    if (causal)
      return sm90::kernel_info(online::online_kernel<HD, true>, sm90::kAttnThreads, smem, out);
    return sm90::kernel_info(online::online_kernel<HD, false>, sm90::kAttnThreads, smem, out);
  });
}

}  // namespace al

// q (pre-scaled) and o: [B, T, Hq, hd]-strided bf16; k, v: [B, T, Hkv, hd]-
// strided (16-byte strides and bases: TMA); key_bias: [B, T] f32, 16-byte
// aligned; l_out, m_out: [B*Hq, T] f32. tri: 1 for 'always', 0 for 'never',
// 2 for 'cond' (the same kernel as 'always').
AL_EXPORT int al_causal_attention(const void* q, const void* k, const void* v, void* o,
                                  void* l_out, void* m_out, const void* key_bias, int B,
                                  int T, int Hq, int Hkv, int hd, long long q_sb,
                                  long long q_st, long long q_sh, long long k_sb,
                                  long long k_st, long long k_sh, long long v_sb,
                                  long long v_st, long long v_sh, long long o_sb,
                                  long long o_st, long long o_sh, int tri,
                                  void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || key_bias == nullptr) return cudaErrorInvalidValue;
  al::AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.l_out = static_cast<float*>(l_out);
  p.m_out = static_cast<float*>(m_out);
  p.key_bias = static_cast<const float*>(key_bias);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tri) {
    case 0: return al::online::launch<false>(p, B, hd, s);
    case 1:
    case 2: return al::online::launch<true>(p, B, hd, s);
    default: return cudaErrorInvalidValue;
  }
}
