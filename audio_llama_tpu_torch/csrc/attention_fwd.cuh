// Tiled attention forward on the tensor cores (bf16 in, f32 accumulate):
// the encoder's kernels (enc_attention.cu, enc_attention_bounded.cu,
// enc_attention_twopass.cu; non-causal, a static valid-key length), and
// AttnParams and the row copy that the port's other attention kernels share.
// The causal forwards left this tile loop for wgmma and TMA (sm90.cuh).
//
// A block owns BQ = 64 query rows of one (batch, query head); each of its
// four warps owns 16 rows. The keys stream through shared memory in tiles of
// BK = 64 with a running TRUE row max (never a bound): per tile,
//   S = Q K^T            (WMMA 16x16x16 bf16 -> f32)
//   m' = max(m, rowmax S); r = exp(m - m')
//   P = bf16(exp(S - m'))  and  l' = l r + rowsum(P)   (the denominator is
//       summed from the SAME bf16-rounded P that meets V, as the TPU kernels'
//       ones column does)
//   O = O r + P V        (WMMA, O kept as f32 in shared memory)
// and the epilogue writes O / l. Inputs are read through (batch, time, head)
// element strides, so [B, T, H*hd] projection outputs need no transpose.
//
// Two more softmax modes of the same tile loop serve the encoder's A/B
// kernels; both shift every tile by one FIXED per-row value, so neither
// rescales O (r = 1) and the order of the key tiles only changes f32 sums:
//   kSoftmaxBounded (enc_attention_bounded.cu): the Cauchy-Schwarz bound
//       ||q_i|| * kn[b, kv head] in place of the row max, p = 0 past the
//       valid keys, out = l > 0 ? O / l : 0 (a row whose exp all underflows
//       is 0); the denominator is summed from bf16(p) (the encoder's ones
//       column);
//   kSoftmaxTwoPass (enc_attention_twopass.cu): a first pass over the key
//       tiles takes the TRUE row max of S (-1e9 past the valid keys), then
//       the main loop forms p = exp(S - m), optionally through a bf16 exp
//       argument (exp_bf16).
// Both use expf (not __expf) for the row's p.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace al {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;

constexpr int kSoftmaxOnline = 0;   // running true max (enc v3, causal)
constexpr int kSoftmaxBounded = 1;  // fixed shift ||q_i|| kn (enc bounded)
constexpr int kSoftmaxTwoPass = 2;  // max pass, then exp and PV (enc twopass)

struct AttnParams {
  const __nv_bfloat16* q;  // pre-scaled
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* l_out;            // [B*Hq, T] row denominators (the causal forwards)
  float* m_out;            // [B*Hq, T] row shifts (the causal forwards)
  const float* key_bias;   // [B, T] additive key bias (the causal forwards)
  const float* kn;         // [B*Hkv] max key norm per (batch, KV head) (bounded)
  int exp_bf16;            // two-pass: round exp's argument to bf16
  int T;                   // rows of q/k/v/o along time
  int n_keys;              // keys at index >= n_keys are masked (the encoder)
  int Hq, Hkv;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
};

// Padded shared-memory row pitches (elements): keep every WMMA tile pointer
// 32-byte aligned and spread the softmax pass's row reads over the banks.
template <int HD>
struct AttnSmem {
  static constexpr int LDQ = HD + 8;      // bf16 rows of Q, K, V
  static constexpr int LDS = kBK + 4;     // f32 scores
  static constexpr int LDP = kBK + 8;     // bf16 probabilities
  static constexpr int LDO = HD + 4;      // f32 output accumulator
  static constexpr size_t q_bytes = (size_t)kBQ * LDQ * 2;
  static constexpr size_t kv_bytes = (size_t)kBK * LDQ * 2;
  static constexpr size_t s_bytes = (size_t)kBQ * LDS * 4;
  static constexpr size_t p_bytes = (size_t)kBQ * LDP * 2;
  static constexpr size_t o_bytes = (size_t)kBQ * LDO * 4;
  static constexpr size_t total = q_bytes + 2 * kv_bytes + s_bytes + p_bytes + o_bytes;
};

__device__ __forceinline__ void copy_rows_bf16(__nv_bfloat16* dst, int ld_dst,
                                               const __nv_bfloat16* src, long long st,
                                               int row0, int rows, int T, int hd) {
  // 16-byte vectors; rows past T are zero-filled
  const int vpr = hd / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * ld_dst + c) = val;
  }
}

// S = Q K^T for one warp's 16 rows of the tile, into sS (f32).
template <int HD>
__device__ __forceinline__ void scores_tile(const __nv_bfloat16* sQ, const __nv_bfloat16* sK,
                                            float* sS, int warp) {
  using namespace nvcuda;
  using Sm = AttnSmem<HD>;
  for (int n = 0; n < kBK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, sQ + warp * 16 * Sm::LDQ + kk * 16, Sm::LDQ);
      wmma::load_matrix_sync(fb, sK + n * 16 * Sm::LDQ + kk * 16, Sm::LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sS + warp * 16 * Sm::LDS + n * 16, acc, Sm::LDS,
                            wmma::mem_row_major);
  }
}

// O += P V for one warp's 16 rows (P bf16 in sP, V a bf16 tile, O f32 in sO).
template <int HD>
__device__ __forceinline__ void pv_tile(const __nv_bfloat16* sP, const __nv_bfloat16* sV,
                                        float* sO, int warp) {
  using namespace nvcuda;
  using Sm = AttnSmem<HD>;
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* optr = sO + warp * 16 * Sm::LDO + n * 16;
    wmma::load_matrix_sync(acc, optr, Sm::LDO, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sP + warp * 16 * Sm::LDP + kk * 16, Sm::LDP);
      wmma::load_matrix_sync(fb, sV + kk * 16 * Sm::LDQ + n * 16, Sm::LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(optr, acc, Sm::LDO, wmma::mem_row_major);
  }
}

// The bounded shift of the lane pair's row: ||q_i|| (f32 squares of the
// pre-scaled bf16 q row in shared memory) times the (batch, KV head)'s kn.
template <int HD>
__device__ __forceinline__ float row_bound(const __nv_bfloat16* sQ, int row, int half, float kn) {
  using Sm = AttnSmem<HD>;
  const __nv_bfloat16* qrow_s = sQ + row * Sm::LDQ + half * (HD / 2);
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < HD / 2; ++c) {
    const float x = __bfloat162float(qrow_s[c]);
    ss += x * x;
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  return sqrtf(ss) * kn;
}

// A fixed-shift mode's p over this lane's kBK / 2 columns of its row (srow:
// its scores; key0: the key of its first column), written to prow as bf16;
// returns the lane pair's sum of the rounded p.
template <int MODE>
__device__ __forceinline__ float fixed_softmax_lane(const float* srow, __nv_bfloat16* prow,
                                                    int key0, const AttnParams& p, float shift) {
  constexpr int HC = kBK / 2;
  float psum = 0.f;
#pragma unroll
  for (int j = 0; j < HC; ++j) {
    const int key = key0 + j;
    const float x = srow[j];
    float e;
    if constexpr (MODE == kSoftmaxBounded) {
      e = key < p.n_keys ? expf(x - shift) : 0.f;
    } else {
      float a = (key >= p.n_keys ? x + kNeg : x) - shift;
      if (p.exp_bf16) a = __bfloat162float(__float2bfloat16(a));
      e = expf(a);
    }
    const __nv_bfloat16 pb = __float2bfloat16(e);
    prow[j] = pb;
    psum += __bfloat162float(pb);
  }
  return psum + __shfl_xor_sync(0xffffffffu, psum, 1);
}

template <int HD, int MODE>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(AttnParams p) {
  using namespace nvcuda;
  using Sm = AttnSmem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + Sm::q_bytes);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + Sm::q_bytes + Sm::kv_bytes);
  float* sS = reinterpret_cast<float*>(smem + Sm::q_bytes + 2 * Sm::kv_bytes);
  __nv_bfloat16* sP =
      reinterpret_cast<__nv_bfloat16*>(smem + Sm::q_bytes + 2 * Sm::kv_bytes + Sm::s_bytes);
  float* sO = reinterpret_cast<float*>(smem + Sm::q_bytes + 2 * Sm::kv_bytes + Sm::s_bytes +
                                       Sm::p_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);  // GQA by index: K/V are never repeated
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  copy_rows_bf16(sQ, Sm::LDQ, qb, p.q_st, q0, kBQ, p.T, HD);
  for (int i = tid; i < kBQ * Sm::LDO; i += blockDim.x) sO[i] = 0.f;

  // softmax ownership: lane pair (2r, 2r+1) holds row r of this warp's 16,
  // each lane half of the tile's columns and half of the output columns
  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qrow = q0 + row;
  float m_run = kNeg, l_run = 0.f;

  const int n_tiles = (p.n_keys + kBK - 1) / kBK;
  constexpr int HC = kBK / 2;

  if constexpr (MODE == kSoftmaxBounded) {
    __syncthreads();  // sQ is written
    m_run = row_bound<HD>(sQ, row, half, p.kn[b * p.Hkv + kvh]);
  }
  if constexpr (MODE == kSoftmaxTwoPass) {
    // pass 1: the true row max of S over every tile that holds a valid key
    // (later tiles only add -1e9 terms)
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * kBK;
      __syncthreads();
      copy_rows_bf16(sK, Sm::LDQ, kb, p.k_st, k0, kBK, p.T, HD);
      __syncthreads();
      scores_tile<HD>(sQ, sK, sS, warp);
      __syncwarp();
      const float* srow = sS + row * Sm::LDS + half * HC;
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int key = k0 + half * HC + j;
        m_run = fmaxf(m_run, key >= p.n_keys ? srow[j] + kNeg : srow[j]);
      }
      __syncwarp();
    }
    m_run = fmaxf(m_run, __shfl_xor_sync(0xffffffffu, m_run, 1));
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // every warp is done with the previous K/V tile
    copy_rows_bf16(sK, Sm::LDQ, kb, p.k_st, k0, kBK, p.T, HD);
    copy_rows_bf16(sV, Sm::LDQ, vb, p.v_st, k0, kBK, p.T, HD);
    __syncthreads();

    scores_tile<HD>(sQ, sK, sS, warp);
    __syncwarp();

    // softmax over this lane's 32 columns of its row
    const float* srow = sS + row * Sm::LDS + half * HC;
    __nv_bfloat16* prow = sP + row * Sm::LDP + half * HC;
    if constexpr (MODE == kSoftmaxOnline) {
      float s[HC];
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int key = k0 + half * HC + j;
        const float v = key >= p.n_keys ? kNeg : srow[j];
        s[j] = v;
        tmax = fmaxf(tmax, v);
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      const float m_new = fmaxf(m_run, tmax);
      const float r = __expf(m_run - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const __nv_bfloat16 pb = __float2bfloat16(__expf(s[j] - m_new));
        prow[j] = pb;
        psum += __bfloat162float(pb);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l_run = l_run * r + psum;
      m_run = m_new;
      float* orow = sO + row * Sm::LDO + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; ++c) orow[c] *= r;
    } else {
      l_run += fixed_softmax_lane<MODE>(srow, prow, k0 + half * HC, p, m_run);
    }
    __syncwarp();

    pv_tile<HD>(sP, sV, sO, warp);
    __syncwarp();
  }

  if (qrow < p.T) {
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
    const float* orow = sO + row * Sm::LDO + half * (HD / 2);
    __nv_bfloat16* dst = p.o + b * p.o_sb + (long long)qrow * p.o_st + h * p.o_sh + half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 2) {
      __nv_bfloat162 two = __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = two;
    }
  }
}

template <int HD, int MODE>
cudaError_t launch_attn_fwd(const AttnParams& p, int B, cudaStream_t stream) {
  const size_t smem = AttnSmem<HD>::total;
  cudaError_t err = allow_smem(attn_fwd_kernel<HD, MODE>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.T + kBQ - 1) / kBQ, B * p.Hq);
  attn_fwd_kernel<HD, MODE><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The encoder's forward (no causal mask, no key bias, no row statistics).
template <int MODE = kSoftmaxOnline>
cudaError_t dispatch_attn_fwd(const AttnParams& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_attn_fwd<16, MODE>(p, B, stream);
    case 32: return launch_attn_fwd<32, MODE>(p, B, stream);
    case 64: return launch_attn_fwd<64, MODE>(p, B, stream);
    case 128: return launch_attn_fwd<128, MODE>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace al
