// Causal GQA attention forward with a fixed per-row shift, on wgmma and TMA:
// the bounded and the two-pass softmax of the training attention's A/B arms,
// and the `dma` arm.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_fwd_kernel with
// softmax='bounded' (:109-143, :175-178; `causal_mha(softmax_mode=
// 'bounded')`, fwd_impl 'blocks' or 'blocks_cond'), ::_fwd_kernel_dma
// (:250, called at :436; fwd_impl='dma', bounded only) and
// ::_fwd_kernel_twopass (:188-247; softmax_mode='twopass'), called at :593.
// Shapes at the JAX package's A/B geometry (experiments/causal_dma_bench.py):
// qs [B, 2560, 24, 128] pre-scaled bf16, k/v [B, 2560, 8, 128], a [B, T] key
// bias of 0 / -1e9, kn [B, 8] f32 (the max key norm of each KV head over all
// T keys). Writes o and the row statistics l and c as [B*Hq, T] f32, the
// residuals the backward kernels (causal_attention_bwd.cu) take as (l, m).
//
//   bounded: c_i = ||qs_i|| * kn[b, kv head]; p = exp(s + bias - c) in f32,
//       the causal mask -1e9 before the exp; l summed from that f32 p (the
//       TPU kernel's explicit row sum); P rounded to bf16 for P V; o = l > 0
//       ? O / l : 0, so a row whose exp all underflow (c far above the true
//       max: outlier keys) is 0, as the TPU kernel's is.
//   twopass: pass 1 takes the TRUE row max c of s + bias + causal mask over
//       the key tiles at or before the diagonal (K read, V not); pass 2 forms
//       p = exp(bf16(s + bias - c)) (the TPU kernel's bf16 exp argument for
//       bf16 V), rounds it to bf16, sums l from the rounded p (its ones
//       column) and accumulates P V with no rescale.
// The bounded blocks mode ('always' or 'cond') and `dma` are one function
// and run one kernel here. On the TPU they differ in how K/V reach VMEM: a
// BlockSpec grid fetches even the future chunks that @pl.when skips, `dma`
// copies only the valid chunks by hand, double-buffered. TMA loads only the
// valid tiles in both, so that difference has no Hopper counterpart, and
// the three give the same bits. 'cond' (the mask only on tiles past the
// warpgroup's first query) is what every mode here does: a no-op elsewhere.
//
// Bound on the H100: operations, 4 * hd * Hq * B * T (T + 1) / 2 FLOP (QK^T
// and PV over the causal half; twopass's repeated QK^T is not part of the
// function's work): 0.0815 ms at B 2, T 2560 at 989 TFLOP/s bf16.
//
// What held the first versions back (the WMMA tile loop's bounded and
// two-pass modes, and the dma kernel's two cp.async stages: 64 x 64 tiles of
// 4 warps, WMMA from shared memory, S stored as f32 and read back, O loaded
// and stored for every key tile; 26-27x the bound) and what this design does
// about it:
//   - a block owns 128 queries of one (b, q head): two consumer warpgroups of
//     64 rows and a producer warpgroup whose first thread issues TMA (its
//     other warps leave); setmaxnreg moves the producer's registers to the
//     consumers: 40 against 232, the 168 a thread of 384 at launch;
//   - tiles of 128 keys (pass 1: K; the rest: K and V) with the key bias's
//     128 values stream through a two-stage ring (the TPU dma's double
//     buffer) with full and empty mbarriers: the copies run ahead of the
//     products;
//   - a sequential body a tile: S = Q K^T (wgmma SS) retires into
//     registers, p and l form there (quad shuffles for the row max), P is
//     rounded to bf16 in registers and is the A operand of P V (wgmma RS), V
//     the B operand through the transpose bit; O stays in registers. The two
//     consumer warpgroups interleave on the tensor cores; dma2's S_{j+1}
//     overlap (causal_attention_dma2.cu) is left out;
//   - blocks run longest first (the highest query tile first), so the causal
//     half's long rows do not leave a tail.
// hd 16, 32, 64 and 128 (the column blocks and swizzle follow hd); any T.
// Sums are in a fixed order (no atomics), so two launches give the same bits.
#include "sm90.cuh"

namespace al {
namespace fixed {

constexpr int BK = 128;    // keys a tile
constexpr int STAGES = 2;  // the K/V ring

template <int HD, bool BOUNDED>
__global__ void __launch_bounds__(sm90::kAttnThreads, 1)
    fixed_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
                 const AttnParams p, int B) {
  extern __shared__ unsigned char smem_raw[];
  const sm90::AttnRing<HD, BK, STAGES> ring(smem_raw);
  const sm90::AttnPlace at(p, B);
  const int n = (min(p.T, at.q0 + sm90::kAttnBQ) + BK - 1) / BK;  // tiles to the diagonal
  const int first = BOUNDED ? 0 : n;  // ring steps of twopass's pass 1 (K only)
  ring.init();

  if (at.wg == 2) {  // producer
    sm90::regs_dec<40>();
    if (threadIdx.x == 256) {
      ring.load_q(&tq, at.h, at.q0, at.b);
      for (int it = 0; it < first + n; ++it)
        ring.load(it, &tk, it < first ? nullptr : &tv, &tb, at.kvh, it < first ? it : it - first,
                  at.b, p.T);
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

  float c0 = kNeg, c1 = kNeg;  // the shift
  if constexpr (BOUNDED) {
    const __nv_bfloat16* qb = p.q + at.b * p.q_sb + at.h * p.q_sh;
    const float kn = p.kn[at.b * p.Hkv + at.kvh];
    c0 = sm90::row_norm<HD>(qb + (long long)at.row0 * p.q_st, at.row0 < p.T) * kn;
    c1 = sm90::row_norm<HD>(qb + (long long)at.row1 * p.q_st, at.row1 < p.T) * kn;
  }
  sm90::mbar_wait(ring.q_full, 0);
  if constexpr (!BOUNDED) {
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
  }

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n; ++j) {  // p, l and P V
    const int st = ring.acquire(first + j);
    scores(st);
    const bool mask = j * BK + BK - 1 > at.wrow;
    uint32_t pb[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float2 x = sm90::logits<BK>(s, i, j, mask, ring.bias(st), at);
      const float c = (i & 2) ? c1 : c0;
      if constexpr (BOUNDED) {  // f32 p and l
        const float e0 = expf(x.x - c), e1 = expf(x.y - c);
        if (i & 2) l1 += e0 + e1;
        else l0 += e0 + e1;
        pb[i / 2] = sm90::bf16_pair(__floats2bfloat162_rn(e0, e1));
      } else {  // l from the rounded p
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
    }
    sm90::wgmma_fence();
    sm90::issue_pv<HD, BK>(o, pb, sm90::smem_u32(ring.v(st)));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(o);
    sm90::keep(pb);
    ring.release(first + j);
  }
  sm90::store_rows<HD>(o, l0, l1, c0, c1, p, at);
}

}  // namespace fixed

// The fixed-shift forward on Hopper: bounded (al_causal_attention_fixed's
// softmax 1, al_causal_attention_dma's unpipelined branch) or twopass.
cudaError_t fixed_fwd_sm90(const AttnParams& p, int B, int hd, bool bounded,
                           cudaStream_t stream) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    constexpr size_t smem = sm90::AttnRing<HD, fixed::BK, fixed::STAGES>::kSmem;
    if (bounded)
      return sm90::launch_attn<HD, fixed::BK>(fixed::fixed_kernel<HD, true>, smem, p, B, stream);
    return sm90::launch_attn<HD, fixed::BK>(fixed::fixed_kernel<HD, false>, smem, p, B, stream);
  });
}

cudaError_t fixed_fwd_sm90_info(int hd, bool bounded, int* out) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    constexpr size_t smem = sm90::AttnRing<HD, fixed::BK, fixed::STAGES>::kSmem;
    if (bounded)
      return sm90::kernel_info(fixed::fixed_kernel<HD, true>, sm90::kAttnThreads, smem, out);
    return sm90::kernel_info(fixed::fixed_kernel<HD, false>, sm90::kAttnThreads, smem, out);
  });
}

// The AttnParams of a causal forward from the C entries' arguments.
static AttnParams fwd_params(const void* q, const void* k, const void* v, void* o, void* l_out,
                             void* m_out, const void* key_bias, const void* kn, int T, int Hq,
                             int Hkv, long long q_sb, long long q_st, long long q_sh,
                             long long k_sb, long long k_st, long long k_sh, long long v_sb,
                             long long v_st, long long v_sh, long long o_sb, long long o_st,
                             long long o_sh) {
  AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.l_out = static_cast<float*>(l_out);
  p.m_out = static_cast<float*>(m_out);
  p.key_bias = static_cast<const float*>(key_bias);
  p.kn = static_cast<const float*>(kn);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  return p;
}

}  // namespace al

// q (pre-scaled) and o: [B, T, Hq, hd]-strided bf16; k, v: [B, T, Hkv, hd]-
// strided (16-byte strides and bases: TMA); key_bias: [B, T] f32, 16-byte
// aligned; kn: [B*Hkv] f32 (bounded; ignored by twopass); l_out, m_out:
// [B*Hq, T] f32 (m_out receives c). softmax: 1 bounded, 2 twopass; tri: 1
// 'always', 2 'cond' (bounded only; the same kernel); exp_bf16: round the
// two-pass mode's exp argument to bf16.
AL_EXPORT int al_causal_attention_fixed(const void* q, const void* k, const void* v, void* o,
                                        void* l_out, void* m_out, const void* key_bias,
                                        const void* kn, int B, int T, int Hq, int Hkv, int hd,
                                        long long q_sb, long long q_st, long long q_sh,
                                        long long k_sb, long long k_st, long long k_sh,
                                        long long v_sb, long long v_st, long long v_sh,
                                        long long o_sb, long long o_st, long long o_sh,
                                        int softmax, int tri, int exp_bf16, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || key_bias == nullptr) return cudaErrorInvalidValue;
  al::AttnParams p = al::fwd_params(q, k, v, o, l_out, m_out, key_bias, kn, T, Hq, Hkv, q_sb,
                                    q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st,
                                    o_sh);
  p.exp_bf16 = exp_bf16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (softmax == al::kSoftmaxBounded && kn != nullptr && (tri == 1 || tri == 2))
    return al::fixed_fwd_sm90(p, B, hd, true, s);
  if (softmax == al::kSoftmaxTwoPass && tri == 1) return al::fixed_fwd_sm90(p, B, hd, false, s);
  return cudaErrorInvalidValue;
}

// The `dma` and `dma2` arms (their arguments as al_causal_attention_fixed's,
// the bounded softmax; kn: [B*Hkv] f32). T % 64 == 0. pipelined: 0 for dma
// (the bounded kernel above), 1 for dma2 (causal_attention_dma2.cu).
AL_EXPORT int al_causal_attention_dma(const void* q, const void* k, const void* v, void* o,
                                      void* l_out, void* m_out, const void* key_bias,
                                      const void* kn, int B, int T, int Hq, int Hkv, int hd,
                                      long long q_sb, long long q_st, long long q_sh,
                                      long long k_sb, long long k_st, long long k_sh,
                                      long long v_sb, long long v_st, long long v_sh,
                                      long long o_sb, long long o_st, long long o_sh,
                                      int pipelined, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || T % 64 != 0) return cudaErrorInvalidValue;
  if (key_bias == nullptr || kn == nullptr) return cudaErrorInvalidValue;
  const al::AttnParams p = al::fwd_params(q, k, v, o, l_out, m_out, key_bias, kn, T, Hq, Hkv,
                                          q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
                                          o_sb, o_st, o_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pipelined ? al::dma2_fwd_sm90(p, B, hd, s) : al::fixed_fwd_sm90(p, B, hd, true, s);
}

// out[4]: registers per thread, local (spilled) bytes, dynamic shared memory
// and resident blocks per SM of a wgmma / TMA attention forward at head_dim
// hd; kind 0: twopass, 1: dma2, 2: online causal ('always', 'cond'), 3:
// online 'never', 4: bounded (blocks, blocks_cond and dma); 5 and 6: the
// W4A16 prefill (int4_matmul.cu), whole K and K-split, with hd the scale
// group; 7-10: the encoder's forward (enc_attention.cu), online, bounded,
// twopass and twopass with the bf16 exp argument.
AL_EXPORT int al_sm90_kernel_info(int kind, int hd, int* out) {
  switch (kind) {
    case 0: return al::fixed_fwd_sm90_info(hd, false, out);
    case 1: return al::dma2_fwd_sm90_info(hd, out);
    case 2: return al::online_fwd_sm90_info(hd, true, out);
    case 3: return al::online_fwd_sm90_info(hd, false, out);
    case 4: return al::fixed_fwd_sm90_info(hd, true, out);
    case 5: return al::w4_prefill_sm90_info(hd, false, out);
    case 6: return al::w4_prefill_sm90_info(hd, true, out);
    case 7: return al::enc_fwd_sm90_info(hd, al::kSoftmaxOnline, false, out);
    case 8: return al::enc_fwd_sm90_info(hd, al::kSoftmaxBounded, false, out);
    case 9: return al::enc_fwd_sm90_info(hd, al::kSoftmaxTwoPass, false, out);
    case 10: return al::enc_fwd_sm90_info(hd, al::kSoftmaxTwoPass, true, out);
    default: return cudaErrorInvalidValue;
  }
}
