// Shared pieces of the int4 weight kernels (int4_matmul.cu, mlp_int4.cu).
//
// Pack format (audio_llama_tpu_torch/ops/int4_matmul.py): a weight w [K, N]
// is stored as packed [K, N/2] int8, byte j of a row holding output column j
// in its low nibble and column j + N/2 in its high nibble, with f32 scales
// [K/128, N], one per 128-row group and output column. Low nibble: `pair`
// stores the signed value, `obin` the value + 8. High nibble: signed in both,
// read as (sign-extended byte) >> 4.
#pragma once

#include "common.cuh"

namespace al {

constexpr int kGroup = 128;  // contraction rows per scale group
constexpr int kFmtPair = 0;
constexpr int kFmtObin = 1;

__device__ __forceinline__ int nib_lo(int v, int fmt) {
  return fmt == kFmtObin ? (v & 0xF) - 8 : (v << 28) >> 28;
}
__device__ __forceinline__ int nib_hi(int v) { return v >> 4; }

// Loads VB consecutive packed bytes (VB = 4 or 8, naturally aligned).
template <int VB>
struct Bytes;
template <>
struct Bytes<4> {
  uint32_t w[1];
  __device__ __forceinline__ void load(const int8_t* p) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
};
template <>
struct Bytes<8> {
  uint32_t w[2];
  __device__ __forceinline__ void load(const int8_t* p) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
};

// One thread's share of a group-scaled int4 product over packed rows
// [kb, ke) (group aligned): the thread owns VB packed columns starting at
// `col` and the rows kb + slice, kb + slice + nslices, ... of every group.
// Per group it sums x[m, k] * q[k, col + i] in f32 (products of a bf16 value
// and a small integer are exact), multiplies that partial by the group's f32
// scale of the column, and adds it to acc: acc[m][i] for the low-nibble
// column col + i, acc[m][VB + i] for the high-nibble column nh + col + i.
// xs is f32 [MC, ldx] in shared memory, holding rows k - xk0.
template <int MC, int VB>
__device__ __forceinline__ void w4_accumulate(float (&acc)[MC][2 * VB], const float* xs, int ldx,
                                              int xk0, const int8_t* p, long long ldp, int col,
                                              int kb, int ke, int slice, int nslices,
                                              const float* s, long long lds, int nh, int fmt) {
  for (int g0 = kb; g0 < ke; g0 += kGroup) {
    float part[MC][2 * VB];
#pragma unroll
    for (int m = 0; m < MC; ++m)
#pragma unroll
      for (int i = 0; i < 2 * VB; ++i) part[m][i] = 0.f;
#pragma unroll 4
    for (int k = g0 + slice; k < g0 + kGroup; k += nslices) {
      Bytes<VB> b;
      b.load(p + (long long)k * ldp + col);
      float lo[VB], hi[VB];
#pragma unroll
      for (int i = 0; i < VB; ++i) {
        const int v = (int)(signed char)((b.w[i / 4] >> (8 * (i % 4))) & 0xFF);
        lo[i] = (float)nib_lo(v, fmt);
        hi[i] = (float)nib_hi(v);
      }
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        const float xv = xs[m * ldx + (k - xk0)];
#pragma unroll
        for (int i = 0; i < VB; ++i) {
          part[m][i] = fmaf(xv, lo[i], part[m][i]);
          part[m][VB + i] = fmaf(xv, hi[i], part[m][VB + i]);
        }
      }
    }
    const float* sg = s + (long long)(g0 / kGroup) * lds;
#pragma unroll
    for (int i = 0; i < VB; ++i) {
      const float slo = __ldg(sg + col + i), shi = __ldg(sg + nh + col + i);
#pragma unroll
      for (int m = 0; m < MC; ++m) {
        acc[m][i] += part[m][i] * slo;
        acc[m][VB + i] += part[m][VB + i] * shi;
      }
    }
  }
}

// x rows [m0, m0 + MC) x columns [k0, k0 + kn) of a bf16 [M, ld] matrix into
// f32 shared memory [MC, kn]; rows at or past M read as 0.
template <int MC>
__device__ __forceinline__ void stage_rows_f32(float* xs, const __nv_bfloat16* x, long long ld,
                                               int M, int m0, int k0, int kn) {
  for (int i = threadIdx.x; i < MC * kn; i += blockDim.x) {
    const int m = i / kn, k = i % kn;
    xs[i] = (m0 + m < M) ? __bfloat162float(x[(long long)(m0 + m) * ld + k0 + k]) : 0.f;
  }
}

}  // namespace al
