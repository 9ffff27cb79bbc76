// Whisper encoder self-attention on wgmma and TMA: non-causal MHA over
// [B, T, H, hd] with a static valid-key length, in three softmax modes.
//
// Replaces audio_llama_tpu/ops/enc_attention.py:
//   ::_kernel_v3 (:102; enc_attention(algo='v3')), softmax='safe': the main
//       path's, q/k/v [B, 1536, 1280] bf16 seen as [B, 1536, 20, 64], 1500
//       valid keys, 32 calls per clip (al_enc_attention);
//   ::_kernel_v2 (:54; algo='bounded', head-major [B*H, 1536, 64] blocks) and
//       _kernel_v3's softmax='bounded' mode, the same function in the
//       [B, T, H*hd] layout (al_enc_attention_bounded);
//   ::_kernel (:232; algo='twopass', head-major, exp in f32 or on a bf16
//       argument) (al_enc_attention_twopass).
// All three read q, k and v through (batch, time, head) element strides, so
// either layout needs no transpose.
//
// The modes (the plain versions' rules, ops/enc_attention.py):
//   online: a running TRUE row max m over the key tiles; keys at or past
//       valid_len get -1e9; P = bf16(exp(s - m')) (ex2.approx on an FFMA of
//       s and m' in base 2), l = l r + the row sum of that ROUNDED P with r =
//       exp(m - m'), O = O r + P V; o = O / l.
//   bounded: the fixed Cauchy-Schwarz shift c = ||q_i|| * kn[b, h] (f32
//       squares of the bf16 q row); p = expf(s - c), 0 at or past valid_len;
//       l summed from the bf16-ROUNDED p; o = l > 0 ? O / l : 0, so a row
//       whose every exp underflows (outlier keys) is 0. expf keeps
//       subnormal p as the plain version's exp does (ex2.approx.ftz would
//       flush them and zero other rows).
//   twopass: pass 1 takes the TRUE row max m over the valid keys; pass 2
//       forms p = exp(s - m), its argument rounded to bf16 when exp_bf16 is
//       set, l from the rounded p, O + P V with no rescale (valid_len >= 1).
//       The exp is ex2.approx, as online's: the row's max key gives p = 1,
//       so no row is zeroed.
// In every mode P is rounded to bf16 before P V, sums run in a fixed order
// (no atomics: two launches give the same bits) and padded query rows are
// unspecified.
//
// Bound on the H100: operations. QK^T and P V are 4 * B * H * T * valid *
// hd = 11.8 GFLOP per layer at B 1, T 1536, 1500 valid, H 20, hd 64: 0.01193
// ms at 989 TFLOP/s bf16 (0.0954 ms at B 8), against 15.7 MB of q/k/v/o
// (4.7 us at 3.35 TB/s). At hd 64 the exps are a second limit of the same
// size: one exp per 256 FLOP of products, 46 M exps per layer at B 1 take
// ~12 us at the ~3.9 T exps/s of the H100's special-function units.
//
// The first version (a WMMA tile loop of 64-query blocks of four warps: S
// stored to shared memory as f32 and read back, O loaded and stored there
// for every key tile, K and V copied between two __syncthreads) ran at 4% of
// the tensor-core peak. This design is the causal forwards' block
// (sm90.cuh):
//   - a block owns 128 queries of one (b, head): two consumer warpgroups of
//     64 rows and a producer warpgroup whose first thread issues TMA;
//     setmaxnreg gives the consumers 240 registers, the producer 24 (with
//     232 / 40 the online mode at hd 64 spilled one register);
//   - Q lands once; the key tiles that hold a valid key (and no others)
//     stream K and V through a three-deep ring behind full and empty
//     mbarriers, with no key bias: the keys past valid_len are masked in
//     registers, on the last valid tile only; twopass's pass 1 streams K
//     alone over the same tiles (each tile's S waited for: ptxas serialized
//     a pass 1 with S_{j+1} issued ahead), then pass 2 streams K and V;
//   - per tile j: issue S_{j+1} = Q K_{j+1}^T (wgmma SS) ahead, form tile j's
//     row max, p and l from S_j in registers (S_j is only read, and O not
//     written, while S_{j+1} is in flight: ptxas serializes a wgmma when
//     other instructions write accumulators in its window), wait for
//     S_{j+1}, then rescale O (online) and issue P_j V_j (wgmma RS: P from
//     registers, V through the transpose bit), which retires before the
//     stage is released. Both accumulators stay in registers; the exps of
//     one warpgroup run under the other's products and its own S_{j+1};
//   - tiles of 128 keys at hd <= 64 (two live 64-f32 score tiles, O's 32 f32
//     and P's 32 packed words), 64 at hd 128 (O alone holds 64 f32).
// hd 16, 32, 64 and 128; any T (TMA zero-fills rows past T, and the mask
// hides those keys).
//
// Where it stands (H100 80GB HBM3, 700 W; scripts/enc_attention_timing.py,
// CUPTI): at B 1 online 0.0445 ms (3.7x the operations bound, 1.27x cuDNN's
// SDPA on the valid keys), bounded 0.060 (expf), twopass 0.055 (exp_bf16
// 0.063); at B 8 0.339, 0.416 and 0.404 (0.46) against a 0.0954 ms bound
// and SDPA's 0.249. Measured and not kept: 64-key tiles at hd 64 (online
// 0.0517 / 0.395 ms at B 1 / 8), and FA3's ping-pong of the two warpgroups
// on named barriers (0.0480 against 0.0475 ms at B 1, no gain elsewhere).
#include "sm90.cuh"

namespace al {
namespace enc {

template <int HD>
constexpr int kBK = HD == 128 ? 64 : 128;  // keys a tile
constexpr int STAGES = 3;                  // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

// s of the accumulator's element pair (i, i + 1) in key tile j; -1e9 at the
// keys at or past n_keys when `mask` is on (the last valid tile). cq: the
// thread's first column in each group of 8.
template <int BK>
__device__ __forceinline__ float2 logits(const float (&s)[BK / 2], int i, int j, bool mask,
                                         int cq, int n_keys) {
  const int key = j * BK + (i / 4) * 8 + cq;
  return make_float2(mask && key >= n_keys ? kNeg : s[i],
                     mask && key + 1 >= n_keys ? kNeg : s[i + 1]);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD, int MODE, bool EXP_BF16>
__global__ void __launch_bounds__(sm90::kAttnThreads, 1)
    enc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tb,
               const AttnParams p, int B) {
  constexpr int BK = kBK<HD>;
  extern __shared__ unsigned char smem_raw[];
  const sm90::AttnRing<HD, BK, STAGES> ring(smem_raw);
  const sm90::AttnPlace at(p, B);
  const int n = (p.n_keys + BK - 1) / BK;  // the tiles that hold a valid key
  const int first = MODE == kSoftmaxTwoPass ? n : 0;  // ring steps of pass 1 (K only)
  ring.init();

  if (at.wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 256) {
      ring.load_q(&tq, at.h, at.q0, at.b);
      for (int it = 0; it < first + n; ++it)
        ring.load(it, &tk, it < first ? nullptr : &tv, nullptr, at.kvh,
                  it < first ? it : it - first, at.b, p.T);
    }
    return;
  }

  sm90::regs_inc<240>();
  const uint32_t sq = ring.q_rows(at.wg);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // the shift: online the running max, twopass the true max, both in log2
  // units (twopass with exp_bf16: in nats); bounded ||q_i|| kn in nats
  float c0 = kNeg, c1 = kNeg, l0 = 0.f, l1 = 0.f;
  uint32_t pb[BK / 4];
  float sa[BK / 2], sb[BK / 2];

  if constexpr (MODE == kSoftmaxBounded) {
    const __nv_bfloat16* qb = p.q + at.b * p.q_sb + at.h * p.q_sh;
    const float kn = p.kn[at.b * p.Hkv + at.kvh];
    c0 = sm90::row_norm<HD>(qb + (long long)at.row0 * p.q_st, at.row0 < p.T) * kn;
    c1 = sm90::row_norm<HD>(qb + (long long)at.row1 * p.q_st, at.row1 < p.T) * kn;
  }

  auto issue_scores = [&](float (&s)[BK / 2], int it) {
    const int st = ring.acquire(it);
    sm90::wgmma_fence();
    sm90::issue_qk<HD, sm90::kAttnBQ, BK>(s, sq, sm90::smem_u32(ring.k(st)));
    sm90::wgmma_commit();
  };
  auto retire = [&](float (&s)[BK / 2]) {
    sm90::wgmma_wait<0>();
    sm90::keep(s);
  };
  // tile j (ring step first + j) from its retired scores `cur`: p, l and
  // P V, with tile j+1's QK^T into `nxt`
  auto step = [&](float (&cur)[BK / 2], float (&nxt)[BK / 2], int j) {
    const bool more = j + 1 < n;
    if (more) issue_scores(nxt, first + j + 1);
    const int st = (first + j) % STAGES;
    const bool mask = (j + 1) * BK > p.n_keys;
    float r0 = 1.f, r1 = 1.f;
    if constexpr (MODE == kSoftmaxOnline) {  // the new row maxima
      float x0 = kNeg, x1 = kNeg;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const float2 x = logits<BK>(cur, i, j, mask, at.cq, p.n_keys);
        if (i & 2) x1 = fmaxf(x1, fmaxf(x.x, x.y));
        else x0 = fmaxf(x0, fmaxf(x.x, x.y));
      }
      x0 = fmaxf(c0, sm90::quad_max(x0) * kLog2e);
      x1 = fmaxf(c1, sm90::quad_max(x1) * kLog2e);
      r0 = exp2_approx(c0 - x0);
      r1 = exp2_approx(c1 - x1);
      c0 = x0;
      c1 = x1;
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const float2 x = logits<BK>(cur, i, j, mask, at.cq, p.n_keys);
      const float c = (i & 2) ? c1 : c0;
      float e0, e1;
      if constexpr (MODE == kSoftmaxBounded) {  // expf: p down to the subnormals
        e0 = expf(x.x - c);
        e1 = expf(x.y - c);
      } else if constexpr (EXP_BF16) {
        const float2 a = __bfloat1622float2(__floats2bfloat162_rn(x.x - c, x.y - c));
        e0 = exp2_approx(a.x * kLog2e);
        e1 = exp2_approx(a.y * kLog2e);
      } else {
        e0 = exp2_approx(fmaf(x.x, kLog2e, -c));
        e1 = exp2_approx(fmaf(x.y, kLog2e, -c));
      }
      const __nv_bfloat162 pr = __floats2bfloat162_rn(e0, e1);
      const float2 pf = __bfloat1622float2(pr);
      if (i & 2) s1 += pf.x + pf.y;
      else s0 += pf.x + pf.y;
      pb[i / 2] = sm90::bf16_pair(pr);
    }
    if constexpr (MODE == kSoftmaxOnline) {
      l0 = l0 * r0 + s0;
      l1 = l1 * r1 + s1;
    } else {
      l0 += s0;
      l1 += s1;
    }
    if (more) retire(nxt);
    if constexpr (MODE == kSoftmaxOnline) {  // P_{j-1} V_{j-1} has retired
#pragma unroll
      for (int i = 0; i < HD / 2; i += 4) {
        o[i] *= r0;
        o[i + 1] *= r0;
        o[i + 2] *= r1;
        o[i + 3] *= r1;
      }
    }
    sm90::wgmma_fence();
    sm90::issue_pv<HD, BK>(o, pb, sm90::smem_u32(ring.v(st)));
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // P_j V_j retires: the stage is free, P and O may be rewritten
    sm90::keep(o);
    sm90::keep(pb);
    ring.release(first + j);
  };

  sm90::mbar_wait(ring.q_full, 0);
  if (n > 0) {
    if constexpr (MODE == kSoftmaxTwoPass) {
      for (int j = 0; j < n; ++j) {  // pass 1: the true row max
        issue_scores(sa, j);
        retire(sa);
        const bool mask = (j + 1) * BK > p.n_keys;
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const float2 x = logits<BK>(sa, i, j, mask, at.cq, p.n_keys);
          if (i & 2) c1 = fmaxf(c1, fmaxf(x.x, x.y));
          else c0 = fmaxf(c0, fmaxf(x.x, x.y));
        }
        ring.release(j);
      }
      c0 = sm90::quad_max(c0);
      c1 = sm90::quad_max(c1);
      if constexpr (!EXP_BF16) {  // exp2 of the logits in log2 units
        c0 *= kLog2e;
        c1 *= kLog2e;
      }
    }
    issue_scores(sa, first);
    retire(sa);
    for (int j = 0; j < n; j += 2) {
      step(sa, sb, j);
      if (j + 1 < n) step(sb, sa, j + 1);
    }
  }
  sm90::store_rows<HD>(o, l0, l1, c0, c1, p, at);
}

template <int MODE, bool EXP_BF16 = false>
cudaError_t launch(const AttnParams& p, int B, int hd, cudaStream_t stream) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    return sm90::launch_attn<HD, kBK<HD>>(enc_kernel<HD, MODE, EXP_BF16>,
                                          sm90::AttnRing<HD, kBK<HD>, STAGES>::kSmem, p, B,
                                          stream);
  });
}

// The AttnParams of an encoder launch (MHA: the KV head is the query head;
// no key bias, no row statistics).
AttnParams params(const void* q, const void* k, const void* v, void* o, int T, int H,
                  int valid_len, long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh, long long v_sb,
                  long long v_st, long long v_sh, long long o_sb, long long o_st,
                  long long o_sh) {
  AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.T = T;
  p.n_keys = valid_len;
  p.Hq = H;
  p.Hkv = H;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  return p;
}

}  // namespace enc

cudaError_t enc_fwd_sm90_info(int hd, int mode, bool exp_bf16, int* out) {
  return sm90::with_hd(hd, [&](auto c) -> cudaError_t {
    constexpr int HD = decltype(c)::value;
    constexpr size_t smem = sm90::AttnRing<HD, enc::kBK<HD>, enc::STAGES>::kSmem;
    constexpr int T = sm90::kAttnThreads;
    switch (mode) {
      case kSoftmaxOnline:
        return sm90::kernel_info(enc::enc_kernel<HD, kSoftmaxOnline, false>, T, smem, out);
      case kSoftmaxBounded:
        return sm90::kernel_info(enc::enc_kernel<HD, kSoftmaxBounded, false>, T, smem, out);
      case kSoftmaxTwoPass:
        if (exp_bf16)
          return sm90::kernel_info(enc::enc_kernel<HD, kSoftmaxTwoPass, true>, T, smem, out);
        return sm90::kernel_info(enc::enc_kernel<HD, kSoftmaxTwoPass, false>, T, smem, out);
      default: return cudaErrorInvalidValue;
    }
  });
}

}  // namespace al

// q (pre-scaled), k, v, o: bf16 [B, T, H, hd] with element strides (batch,
// time, head) and a unit stride along hd; 16-byte strides and bases (TMA).
// Keys at index >= valid_len are masked. The online softmax (v3 'safe').
AL_EXPORT int al_enc_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int T, int H, int hd, int valid_len, long long q_sb,
                               long long q_st, long long q_sh, long long k_sb, long long k_st,
                               long long k_sh, long long v_sb, long long v_st, long long v_sh,
                               long long o_sb, long long o_st, long long o_sh, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  const al::AttnParams p = al::enc::params(q, k, v, o, T, H, valid_len, q_sb, q_st, q_sh, k_sb,
                                           k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh);
  return al::enc::launch<al::kSoftmaxOnline>(p, B, hd, static_cast<cudaStream_t>(stream));
}

// The bounded shift (layouts as al_enc_attention); kn: [B*H] f32 max key
// norms (over every row of the padded timeline).
AL_EXPORT int al_enc_attention_bounded(const void* q, const void* k, const void* v,
                                       const void* kn, void* o, int B, int T, int H, int hd,
                                       int valid_len, long long q_sb, long long q_st,
                                       long long q_sh, long long k_sb, long long k_st,
                                       long long k_sh, long long v_sb, long long v_st,
                                       long long v_sh, long long o_sb, long long o_st,
                                       long long o_sh, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (kn == nullptr) return cudaErrorInvalidValue;
  al::AttnParams p = al::enc::params(q, k, v, o, T, H, valid_len, q_sb, q_st, q_sh, k_sb, k_st,
                                     k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh);
  p.kn = static_cast<const float*>(kn);
  return al::enc::launch<al::kSoftmaxBounded>(p, B, hd, static_cast<cudaStream_t>(stream));
}

// The exact two-pass softmax (layouts as al_enc_attention); valid_len >= 1.
// exp_bf16: round exp's argument to bf16 (exp_dtype=bfloat16).
AL_EXPORT int al_enc_attention_twopass(const void* q, const void* k, const void* v, void* o,
                                       int B, int T, int H, int hd, int valid_len,
                                       int exp_bf16, long long q_sb, long long q_st,
                                       long long q_sh, long long k_sb, long long k_st,
                                       long long k_sh, long long v_sb, long long v_st,
                                       long long v_sh, long long o_sb, long long o_st,
                                       long long o_sh, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (valid_len < 1) return cudaErrorInvalidValue;
  const al::AttnParams p = al::enc::params(q, k, v, o, T, H, valid_len, q_sb, q_st, q_sh, k_sb,
                                           k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? al::enc::launch<al::kSoftmaxTwoPass, true>(p, B, hd, s)
                  : al::enc::launch<al::kSoftmaxTwoPass>(p, B, hd, s);
}
