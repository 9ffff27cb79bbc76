// Whisper encoder self-attention on int8 tensor cores (v3q).
//
// Replaces audio_llama_tpu/ops/enc_attention.py::_kernel_v3q (enc_attention,
// algo='v3q'): q/k/v int8 [B, 1536, 1280] (H = 20, hd = 64), f32 per-row
// logit scales c [B, T, H] and V scales sv [B, H*hd]; 1500 valid keys, 32
// calls per clip on the `--enc_algo v3q` path. The quantization (q row
// scales, K mean-subtracted with one scale per (b, h), V per channel, c =
// sq * sk * softmax scale) stays outside, in ops/enc_attention.py::
// v3q_quantize, as it stays in XLA on the TPU; that wrapper writes V's int8
// copy transposed, [B, H, hd, T], the k-major layout PV's B operand needs.
//
// What the TPU kernel computes, per (b, h) and query row i:
//   s_ij = q_i . k_j in int32;  m_i = max over the VALID keys of s_ij (masked
//   keys carry -2^30);  p_ij = exp((s_ij - m_i) * c_i), 0 past the valid keys;
//   pq_ij = round(127 p_ij) in [0, 127];  den_i = sum_j pq_ij (the TPU's ones
//   column);  out_i = den_i > 0 ? (sum_j pq_ij v_j) * sv / den_i : 0.
// pq is rounded against the TRUE row max, and PV accumulates in int32, which
// no exp factor can rescale; a running max cannot reproduce either. So this
// kernel makes two passes over the key tiles: int8 QK^T for the row max,
// then int8 QK^T again, pq, and int8 PV. expf (not __expf) forms p; a pq at
// a rounding tie may still land one level from the host's.
//
// Bound on the H100: operations, 4 * T * valid * hd * H = 11.8 GOP per layer
// at B = 1, ~6 us at 1,979 TOPS int8 (q/k/v/o move 9.8 MB, ~2.9 us); the
// recomputed QK^T is not part of the function's work. Design: a block owns
// 64 query rows of one (b, h), 16 per warp, and streams 64-key tiles of K
// and V^T through shared memory (80-byte row pitch: the 32-bit fragment
// loads below hit 32 distinct banks). Both products are
// mma.sync.m16n8k32.s32.s8.s8.s32. Q's A fragments stay in registers for the
// whole block. QK's s32 accumulator holds, per thread, keys 8n + 2t and
// 8n + 2t + 1 of rows g and g + 8 (g = lane / 4, t = lane % 4); PV's A
// fragment wants four consecutive k positions 4t..4t+3. Rather than stage pq
// through shared memory, the kernel packs pq straight from the accumulator
// and lets k position 4t + e of a 32-key step stand for key
// {2t, 2t+1, 2t+8, 2t+9}[e] (and 16 + 4t + e for 16 + that key): the sum over
// keys does not depend on their order, and V's B fragment loads the same
// keys (two 16-bit loads per register). Integer sums are exact, so the only
// rounding is expf, the pq rounding and the f32 epilogue, as on the TPU.
#include "common.cuh"

namespace {

constexpr int kHD = 64;
constexpr int kBQ = 64;  // query rows a block: 4 warps of 16
constexpr int kBK = 64;  // keys a tile
constexpr int kThreads = 128;
constexpr int kPitch = 80;  // bytes per shared row (64 + 16)
constexpr int kMasked = -(1 << 30);

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// rows x 64 bytes from global (row stride `stride` bytes) into shared rows of
// kPitch bytes, as 16-byte vectors
__device__ __forceinline__ void copy_tile(int8_t* dst, const int8_t* src, long long stride,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * 4; i += blockDim.x) {
    const int r = i >> 2, c = (i & 3) * 16;
    *reinterpret_cast<uint4*>(dst + r * kPitch + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

__device__ __forceinline__ unsigned load_u32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned load_u16(const int8_t* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// S for this warp's 16 rows x the 64 keys of the tile: s[n] covers keys
// 8n..8n+7 (C fragment: rows g, g + 8; keys 8n + 2t, 8n + 2t + 1)
__device__ __forceinline__ void qk_tile(int (&s)[8][4], const unsigned (&qa)[2][4],
                                        const int8_t* sK, int g, int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int8_t* kr = sK + (n * 8 + g) * kPitch + ks * 32 + 4 * t;
      const unsigned b[2] = {load_u32(kr), load_u32(kr + 16)};
      mma_s8(s[n], qa[ks], b);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    v3q_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
               const int8_t* __restrict__ vt, const float* __restrict__ c,
               const float* __restrict__ sv, __nv_bfloat16* __restrict__ o, int T, int H,
               int n_valid) {
  __shared__ __align__(16) int8_t sQ[kBQ * kPitch];
  __shared__ __align__(16) int8_t sK[kBK * kPitch];
  __shared__ __align__(16) int8_t sV[kHD * kPitch];  // V^T tile: [channel][key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long D = (long long)H * kHD;
  const int8_t* kb = k + (long long)b * T * D + h * kHD;
  const int8_t* vb = vt + (long long)bh * kHD * T;

  copy_tile(sQ, q + ((long long)b * T + q0) * D + h * kHD, D, kBQ);
  __syncthreads();
  unsigned qa[2][4];  // A fragments of this warp's rows: hd 0..31, 32..63
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int8_t* r0 = sQ + (warp * 16 + g) * kPitch + ks * 32 + 4 * t;
    const int8_t* r1 = r0 + 8 * kPitch;
    qa[ks][0] = load_u32(r0);
    qa[ks][1] = load_u32(r1);
    qa[ks][2] = load_u32(r0 + 16);
    qa[ks][3] = load_u32(r1 + 16);
  }

  const int n_tiles = (n_valid + kBK - 1) / kBK;  // later tiles hold masked keys only
  int s[8][4];

  // pass 1: the row max of the raw int32 scores over the valid keys
  int m0 = kMasked, m1 = kMasked;  // rows g, g + 8
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();
    copy_tile(sK, kb + (long long)k0 * D, D, kBK);
    __syncthreads();
    qk_tile(s, qa, sK, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + n * 8 + 2 * t + e < n_valid) {
          m0 = max(m0, s[n][e]);
          m1 = max(m1, s[n][2 + e]);
        }
      }
    }
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {  // the 4 lanes of a row group
    m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, x));
    m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, x));
  }

  // pass 2: pq against that max, int8 PV, the integer denominator
  const int row0 = q0 + warp * 16 + g;
  const float c0 = c[((long long)b * T + row0) * H + h];
  const float c1 = c[((long long)b * T + row0 + 8) * H + h];
  int acc[8][4];  // PV: channel groups 8j..8j+7 (C fragment layout)
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  int den0 = 0, den1 = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();
    copy_tile(sK, kb + (long long)k0 * D, D, kBK);
    copy_tile(sV, vb + k0, T, kHD);
    __syncthreads();
    qk_tile(s, qa, sK, g, t);
    unsigned pq[8][2];  // per key group n: bytes of keys (8n+2t, 8n+2t+1), rows g | g + 8
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (k0 + n * 8 + 2 * t + e < n_valid) {
          const unsigned a = (unsigned)rintf(expf((float)(s[n][e] - m0) * c0) * 127.f);
          const unsigned z = (unsigned)rintf(expf((float)(s[n][2 + e] - m1) * c1) * 127.f);
          den0 += (int)a;
          den1 += (int)z;
          lo |= a << (8 * e);
          hi |= z << (8 * e);
        }
      }
      pq[n][0] = lo;
      pq[n][1] = hi;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // k position 4t + e <-> key 32 ks + {2t, 2t+1, 2t+8, 2t+9}[e];
      // 16 + 4t + e <-> 16 + that key
      const unsigned a[4] = {
          pq[4 * ks][0] | (pq[4 * ks + 1][0] << 16),      // row g
          pq[4 * ks][1] | (pq[4 * ks + 1][1] << 16),      // row g + 8
          pq[4 * ks + 2][0] | (pq[4 * ks + 3][0] << 16),  // row g, keys + 16
          pq[4 * ks + 2][1] | (pq[4 * ks + 3][1] << 16),  // row g + 8, keys + 16
      };
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int8_t* vr = sV + (j * 8 + g) * kPitch + ks * 32 + 2 * t;
        const unsigned bf[2] = {load_u16(vr) | (load_u16(vr + 8) << 16),
                                load_u16(vr + 16) | (load_u16(vr + 24) << 16)};
        mma_s8(acc[j], a, bf);
      }
    }
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    den0 += __shfl_xor_sync(0xffffffffu, den0, x);
    den1 += __shfl_xor_sync(0xffffffffu, den1, x);
  }

  // out = (acc * sv) / den, 0 where den is 0
  const float* svb = sv + (long long)bh * kHD;
  const float d0 = (float)den0, d1 = (float)den1;
  __nv_bfloat16* o0 = o + ((long long)b * T + row0) * D + h * kHD;
  __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ch = j * 8 + 2 * t;
    const float s0 = svb[ch], s1 = svb[ch + 1];
    const float a0 = den0 > 0 ? ((float)acc[j][0] * s0) / d0 : 0.f;
    const float a1 = den0 > 0 ? ((float)acc[j][1] * s1) / d0 : 0.f;
    const float b0 = den1 > 0 ? ((float)acc[j][2] * s0) / d1 : 0.f;
    const float b1 = den1 > 0 ? ((float)acc[j][3] * s1) / d1 : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(o0 + ch) = __floats2bfloat162_rn(a0, a1);
    *reinterpret_cast<__nv_bfloat162*>(o1 + ch) = __floats2bfloat162_rn(b0, b1);
  }
}

}  // namespace

// q, k: int8 [B, T, H, 64]; vt: int8 [B, H, 64, T]; c: f32 [B, T, H];
// sv: f32 [B, H, 64]; o: bf16 [B, T, H, 64]; all contiguous, T % 64 == 0.
// Keys at index >= valid_len are masked.
AL_EXPORT int al_enc_attention_v3q(const void* q, const void* k, const void* vt, const void* c,
                                   const void* sv, void* o, int B, int T, int H,
                                   int valid_len, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (T % kBQ != 0 || valid_len < 0 || valid_len > T) return cudaErrorInvalidValue;
  dim3 grid(T / kBQ, B * H);
  v3q_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(vt), static_cast<const float*>(c),
      static_cast<const float*>(sv), static_cast<__nv_bfloat16*>(o), T, H, valid_len);
  return cudaGetLastError();
}
