// Causal GQA attention backward: dq, and dk / dv.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_dq_kernel (:471) and
// ::_dkv_kernel (:514) (tri='always'), which the custom VJP of causal_mha
// runs whenever the decoder is differentiated (training). Inputs, as the
// forward (causal_attention.cu) left them: qs (pre-scaled), k, v and o's
// cotangent dO, bf16 [B, T, H, hd] contiguous; the forward's row statistics
// l (denominator) and m (row max) and the prologue's D = rowsum(dO * O),
// [B*Hq, T] f32; the key-padding bias [B, T] f32. Training shape: B 2, T 2048
// (1500 audio frames + 2 delimiters + 512 text tokens, padded), Hq 24, Hkv 8,
// hd 128; each kernel runs once per decoder layer per micro-batch.
//
// For query row i and key j <= i:
//   s = qs_i . k_j + bias_j,  P = exp(s - m_i) / l_i  (0 where l_i == 0),
//   dP = dO_i . v_j,  dS = P (dP - D_i);
//   dq_i = sum_j bf16(dS_ij) k_j                       (dq kernel)
//   dv_j = sum_{g, i} bf16(P_ij) dO_i                   (dkv kernel, over the
//   dk_j = sum_{g, i} bf16(dS_ij) qs_i                   G heads of j's group)
// with f32 sums, as the TPU kernels round P and dS to the input type before
// their products.
//
// Bound on the H100: operations. dq runs 3 and dk/dv 4 products of hd-deep
// tiles over the causal half, 2 hd T (T + 1) / 2 FLOP per product and head:
// 7.7e10 and 1.0e11 FLOP at the training shape, 0.078 and 0.104 ms at 989
// TFLOP/s; the bytes (about 92 and 88 MB) take 0.03 ms.
//
// Design: WMMA tensor-core tiles (16x16x16 bf16 -> f32), as attention_fwd.cuh.
// dq: one block per (b, q head, 64-row q tile); each of four warps owns 16
// rows and keeps their dq in accumulator fragments while the key tiles at or
// below the diagonal stream through shared memory. dkv: one block per (b, kv
// head, 64-key tile); each warp owns 16 keys and keeps their dk and dv in
// fragments while the G query heads of the group, and for each the query
// tiles at or past the diagonal, stream through. Every sum stays inside one
// block in a fixed order (no atomics), so dq, dk and dv are the same on every
// run. The blocks with the most tiles are launched first. S and dP share one
// f32 tile (P waits in registers while dP is computed), which keeps each
// block near 100 KB of shared memory: two blocks fit an SM. A simple first
// version otherwise: no cp.async or TMA pipeline, no wgmma.
#include "attention_fwd.cuh"

namespace al {
namespace bwd {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;  // rows of a q tile and of a k tile
constexpr int kWarps = kTile / 16;
constexpr int kThreads = kWarps * 32;

struct Params {
  const bf16* q;  // pre-scaled
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* l;
  const float* m;
  const float* d;
  const float* key_bias;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int T, Hq, Hkv;
};

template <int HD>
struct Smem {
  static constexpr int LDH = HD + 8;     // bf16 [64, hd] tiles
  static constexpr int LDS = kTile + 4;  // f32 [64, 64] products
  static constexpr int LDP = kTile + 8;  // bf16 [64, 64] P / dS
  static constexpr int LDO = HD + 4;     // f32 epilogue staging
  static constexpr size_t h_bytes = (size_t)kTile * LDH * 2;
  static constexpr size_t s_bytes = (size_t)kTile * LDS * 4;
  static constexpr size_t p_bytes = (size_t)kTile * LDP * 2;
  static_assert((size_t)kTile * LDO * 4 <= 2 * h_bytes, "staging must fit two [64, hd] tiles");
  static constexpr size_t dq_total = 4 * h_bytes + s_bytes + p_bytes;
  static constexpr size_t dkv_total = 4 * h_bytes + s_bytes + 2 * p_bytes + 3 * kTile * 4;
};

using namespace nvcuda;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBcol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBrow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// This warp's 16 rows of X Y^T, [16, 64] into the f32 shared tile `out`: X
// holds the warp's rows; Y holds 64 rows that become columns.
template <int HD>
__device__ __forceinline__ void product(const bf16* X, const bf16* Y, float* out, int warp) {
  using Sm = Smem<HD>;
#pragma unroll
  for (int n = 0; n < kTile / 16; ++n) {
    FragAcc a;
    wmma::fill_fragment(a, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragA fa;
      FragBcol fb;
      wmma::load_matrix_sync(fa, X + warp * 16 * Sm::LDH + kk * 16, Sm::LDH);
      wmma::load_matrix_sync(fb, Y + n * 16 * Sm::LDH + kk * 16, Sm::LDH);
      wmma::mma_sync(a, fa, fb, a);
    }
    wmma::store_matrix_sync(out + warp * 16 * Sm::LDS + n * 16, a, Sm::LDS,
                            wmma::mem_row_major);
  }
}

// acc[n] += A[this warp's 16 rows, 64] @ Bm[64, n-th 16 columns of hd]
template <int HD>
__device__ __forceinline__ void accumulate(FragAcc (&acc)[HD / 16], const bf16* A,
                                           const bf16* Bm, int warp) {
  using Sm = Smem<HD>;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      FragA fa;
      FragBrow fb;
      wmma::load_matrix_sync(fa, A + warp * 16 * Sm::LDP + kk * 16, Sm::LDP);
      wmma::load_matrix_sync(fb, Bm + kk * 16 * Sm::LDH + n * 16, Sm::LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// The warp's 16 accumulated rows -> bf16 rows of `dst` (row stride `st`),
// through f32 staging in shared memory; lane pair (2r, 2r+1) writes row r.
template <int HD>
__device__ __forceinline__ void store_rows(FragAcc (&acc)[HD / 16], float* stage, bf16* dst,
                                           long long st, int row0, int warp, int lane) {
  using Sm = Smem<HD>;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * Sm::LDO + n * 16, acc[n], Sm::LDO,
                            wmma::mem_row_major);
  __syncwarp();
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const float* src = stage + r * Sm::LDO + half * (HD / 2);
  bf16* out = dst + (long long)(row0 + r) * st + half * (HD / 2);
#pragma unroll
  for (int c = 0; c < HD / 2; c += 2)
    *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(src[c], src[c + 1]);
  __syncwarp();
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  using Sm = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sDO = reinterpret_cast<bf16*>(smem + Sm::h_bytes);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * Sm::h_bytes);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * Sm::h_bytes);
  float* sS = reinterpret_cast<float*>(smem + 4 * Sm::h_bytes);  // S, then dP
  bf16* sDS = reinterpret_cast<bf16*>(smem + 4 * Sm::h_bytes + Sm::s_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;  // the longest rows first
  const int q0 = qt * kTile;
  const int bh = blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);  // GQA by index
  const long long qst = (long long)p.Hq * HD, kst = (long long)p.Hkv * HD;
  const bf16* qb = p.q + (long long)b * p.T * qst + h * HD;
  const bf16* ob = p.dout + (long long)b * p.T * qst + h * HD;
  const bf16* kb = p.k + (long long)b * p.T * kst + kvh * HD;
  const bf16* vb = p.v + (long long)b * p.T * kst + kvh * HD;
  const float* bias = p.key_bias + (long long)b * p.T;

  copy_rows_bf16(sQ, Sm::LDH, qb, qst, q0, kTile, p.T, HD);
  copy_rows_bf16(sDO, Sm::LDH, ob, qst, q0, kTile, p.T, HD);

  // elementwise ownership: lane pair (2r, 2r+1) holds row r of the warp's 16,
  // each lane half of the tile's 64 columns
  const int row = warp * 16 + (lane >> 1), half = lane & 1;
  const int qrow = q0 + row;
  const long long stat = (long long)bh * p.T + qrow;
  const float m_i = p.m[stat], l_i = p.l[stat], d_i = p.d[stat];
  const float inv_l = l_i > 0.f ? 1.f / l_i : 0.f;

  FragAcc acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int t = 0; t <= qt; ++t) {  // key tiles at or below the diagonal
    const int k0 = t * kTile;
    __syncthreads();  // every warp is done with the previous K/V tile
    copy_rows_bf16(sK, Sm::LDH, kb, kst, k0, kTile, p.T, HD);
    copy_rows_bf16(sV, Sm::LDH, vb, kst, k0, kTile, p.T, HD);
    __syncthreads();
    constexpr int HC = kTile / 2;
    const float* s_row = sS + row * Sm::LDS + half * HC;
    bf16* ds_row = sDS + row * Sm::LDP + half * HC;
    float pr[HC];
    product<HD>(sQ, sK, sS, warp);  // S = Q K^T
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int key = k0 + half * HC + j;
      float s = s_row[j] + bias[key];
      if (key > qrow) s = kNeg;
      pr[j] = __expf(s - m_i) * inv_l;
    }
    __syncwarp();
    product<HD>(sDO, sV, sS, warp);  // dP = dO V^T, over S: the warp's own rows
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HC; ++j) ds_row[j] = __float2bfloat16(pr[j] * (s_row[j] - d_i));
    __syncwarp();
    accumulate<HD>(acc, sDS, sK, warp);  // dQ += dS K
  }
  __syncthreads();  // the staging area overlaps the Q and dO tiles
  store_rows<HD>(acc, reinterpret_cast<float*>(smem),
                 p.dq + (long long)b * p.T * qst + h * HD, qst, q0, warp, lane);
}

template <int HD>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Params p) {
  using Sm = Smem<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + Sm::h_bytes);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * Sm::h_bytes);
  bf16* sDO = reinterpret_cast<bf16*>(smem + 3 * Sm::h_bytes);
  float* sS = reinterpret_cast<float*>(smem + 4 * Sm::h_bytes);  // S^T, then dP^T
  bf16* sPT = reinterpret_cast<bf16*>(smem + 4 * Sm::h_bytes + Sm::s_bytes);
  bf16* sDST = reinterpret_cast<bf16*>(smem + 4 * Sm::h_bytes + Sm::s_bytes + Sm::p_bytes);
  float* sM = reinterpret_cast<float*>(smem + 4 * Sm::h_bytes + Sm::s_bytes + 2 * Sm::p_bytes);
  float* sIL = sM + kTile;
  float* sD = sIL + kTile;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = p.T / kTile;
  const int kt = blockIdx.y;  // key tile 0 meets every query tile: launched first
  const int k0 = kt * kTile;
  const int bkv = blockIdx.x;
  const int b = bkv / p.Hkv, kvh = bkv % p.Hkv;
  const int G = p.Hq / p.Hkv;
  const long long qst = (long long)p.Hq * HD, kst = (long long)p.Hkv * HD;
  const bf16* kb = p.k + (long long)b * p.T * kst + kvh * HD;
  const bf16* vb = p.v + (long long)b * p.T * kst + kvh * HD;

  copy_rows_bf16(sK, Sm::LDH, kb, kst, k0, kTile, p.T, HD);
  copy_rows_bf16(sV, Sm::LDH, vb, kst, k0, kTile, p.T, HD);

  // elementwise ownership: lane pair (2r, 2r+1) holds key r of the warp's 16,
  // each lane half of the tile's 64 queries
  const int key = warp * 16 + (lane >> 1), half = lane & 1;
  const int kg = k0 + key;
  const float bias_j = p.key_bias[(long long)b * p.T + kg];

  FragAcc acc_k[HD / 16], acc_v[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(acc_k[n], 0.f);
    wmma::fill_fragment(acc_v[n], 0.f);
  }

  for (int g = 0; g < G; ++g) {  // the query heads of the group, in order
    const int h = kvh * G + g;
    const long long bh = (long long)b * p.Hq + h;
    const bf16* qb = p.q + (long long)b * p.T * qst + h * HD;
    const bf16* ob = p.dout + (long long)b * p.T * qst + h * HD;
    for (int qt = kt; qt < n_tiles; ++qt) {  // query tiles at or past the diagonal
      const int q0 = qt * kTile;
      __syncthreads();  // every warp is done with the previous Q/dO tile
      copy_rows_bf16(sQ, Sm::LDH, qb, qst, q0, kTile, p.T, HD);
      copy_rows_bf16(sDO, Sm::LDH, ob, qst, q0, kTile, p.T, HD);
      for (int i = tid; i < kTile; i += kThreads) {
        const long long s = bh * p.T + q0 + i;
        const float l = p.l[s];
        sM[i] = p.m[s];
        sIL[i] = l > 0.f ? 1.f / l : 0.f;
        sD[i] = p.d[s];
      }
      __syncthreads();
      constexpr int HC = kTile / 2;
      const float* s_row = sS + key * Sm::LDS + half * HC;
      bf16* p_row = sPT + key * Sm::LDP + half * HC;
      bf16* ds_row = sDST + key * Sm::LDP + half * HC;
      float pr[HC];
      product<HD>(sK, sQ, sS, warp);  // S^T = K Q^T
      __syncwarp();
#pragma unroll
      for (int j = 0; j < HC; ++j) {
        const int c = half * HC + j;
        float s = s_row[j] + bias_j;
        if (kg > q0 + c) s = kNeg;
        pr[j] = __expf(s - sM[c]) * sIL[c];
        p_row[j] = __float2bfloat16(pr[j]);
      }
      __syncwarp();
      product<HD>(sV, sDO, sS, warp);  // dP^T = V dO^T, over S^T: the warp's own rows
      __syncwarp();
#pragma unroll
      for (int j = 0; j < HC; ++j)
        ds_row[j] = __float2bfloat16(pr[j] * (s_row[j] - sD[half * HC + j]));
      __syncwarp();
      accumulate<HD>(acc_v, sPT, sDO, warp);  // dV += P^T dO
      accumulate<HD>(acc_k, sDST, sQ, warp);  // dK += dS^T Q
    }
  }
  __syncthreads();  // the staging area overlaps the K and V tiles
  float* stage = reinterpret_cast<float*>(smem);
  store_rows<HD>(acc_k, stage, p.dk + (long long)b * p.T * kst + kvh * HD, kst, k0, warp, lane);
  store_rows<HD>(acc_v, stage, p.dv + (long long)b * p.T * kst + kvh * HD, kst, k0, warp, lane);
}

// The dynamic shared-memory limit, and the whole of L1 given to shared
// memory so that two blocks fit an SM.
template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD>
cudaError_t launch(const Params& p, int B, bool dq, cudaStream_t stream) {
  const int n_tiles = p.T / kTile;
  if (dq) {
    const size_t smem = Smem<HD>::dq_total;
    cudaError_t err = prepare(dq_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    dq_kernel<HD><<<dim3(B * p.Hq, n_tiles), kThreads, smem, stream>>>(p);
  } else {
    const size_t smem = Smem<HD>::dkv_total;
    cudaError_t err = prepare(dkv_kernel<HD>, smem);
    if (err != cudaSuccess) return err;
    dkv_kernel<HD><<<dim3(B * p.Hkv, n_tiles), kThreads, smem, stream>>>(p);
  }
  return cudaGetLastError();
}

inline int run(const void* q, const void* k, const void* v, const void* dout, const void* l,
               const void* m, const void* d, const void* key_bias, void* dq, void* dk, void* dv,
               int B, int T, int Hq, int Hkv, int hd, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || T % kTile != 0) return cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.l = static_cast<const float*>(l);
  p.m = static_cast<const float*>(m);
  p.d = static_cast<const float*>(d);
  p.key_bias = static_cast<const float*>(key_bias);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  const bool is_dq = dq != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(p, B, is_dq, s);
    case 32: return launch<32>(p, B, is_dq, s);
    case 64: return launch<64>(p, B, is_dq, s);
    case 128: return launch<128>(p, B, is_dq, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace al

// q (pre-scaled), dout, dq: [B, T, Hq, hd] bf16; k, v: [B, T, Hkv, hd] bf16;
// l, m, d: [B*Hq, T] f32; key_bias: [B, T] f32. All contiguous, T % 64 == 0.
AL_EXPORT int al_causal_attention_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* l, const void* m,
                                     const void* d, const void* key_bias, void* dq, int B,
                                     int T, int Hq, int Hkv, int hd, void* stream) {
  if (dq == nullptr) return cudaErrorInvalidValue;
  return al::bwd::run(q, k, v, dout, l, m, d, key_bias, dq, nullptr, nullptr, B, T, Hq, Hkv, hd,
                      stream);
}

// dk, dv: [B, T, Hkv, hd] bf16, summed over the G query heads of each group.
AL_EXPORT int al_causal_attention_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* l, const void* m,
                                      const void* d, const void* key_bias, void* dk, void* dv,
                                      int B, int T, int Hq, int Hkv, int hd, void* stream) {
  if (dk == nullptr || dv == nullptr) return cudaErrorInvalidValue;
  return al::bwd::run(q, k, v, dout, l, m, d, key_bias, nullptr, dk, dv, B, T, Hq, Hkv, hd,
                      stream);
}
