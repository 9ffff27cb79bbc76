// Fused int4 decode MLP: silu(x @ Wgate) * (x @ Wup) @ Wdown in one launch.
//
// Replaces audio_llama_tpu/ops/mlp_int4.py::_kernel (mlp_int4_stacked) for
// M <= 64 rows: x [M, K] bf16; the layer's gate|up slab [K, F] int8 (low
// nibble gate column j, high nibble up column j) with scales [K/G, 2F];
// the layer's down slab [F, D/2] int8 with scales [F/G, D]; pack formats
// and group numerics as int4_matmul.cu, the scale group G a run-time
// argument (32, 64, 128 or 256; int4_common.cuh).
//
// Bound on the H100: the weight bytes, 3 * K * F / 2 per layer (40.1 MB at
// 3B dims, 12.0 us at 3.35 TB/s; a smoothed tree's down equalizer adds F * 4
// bytes, 32 KB; group 32 adds 3 scale bytes for every 4 of group 128, 47.2 MB
// in all). Design: block c owns F-chunk c (`chunk` columns; the wrapper takes
// 128, which holds 128 / G down groups (scale rows c * chunk / G + i), or G
// above 128; so 64 blocks run at F = 8192, where the TPU kernel walks
// 512-column chunks in order on one core). Its 256 threads
// stream the chunk's gate|up columns (8 bytes a thread, chunk / 8 threads a
// row, the rest as row slices), add the slices in a fixed order, form
// a = g * sigmoid(g) * u in f32, multiply it by the layer's down equalizer
// dn_r[j] where one is given (the TPU kernel's has_dnr mode, for smoothed
// trees: the down product's effective weight is diag(dn_r) @ dequant) and
// round it to bf16 (the TPU kernel's cast to x's dtype), then stream the
// chunk's down rows and write the chunk's f32 contribution to every output
// column into a workspace. The down sum crosses blocks: the last block to
// finish (atomic counter) adds the chunks' partials in chunk order and casts
// to bf16, so the result does not depend on block timing (no float
// atomics). Rows are taken four at a time; more than four re-read the
// weights (from L2). That final sum reads every chunk's partial in one
// block, and 64 blocks still leave half the SMs idle: the next steps for
// speed.
#include "int4_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMC = 4;  // rows per pass
constexpr int kVB = 8;  // packed bytes per thread and row

// dynamic shared memory: 4 * (kMC * K + 4096 * kMC + kMC * chunk) bytes
__global__ void __launch_bounds__(kThreads)
mlp4_kernel(const __nv_bfloat16* __restrict__ x, int M, int K, const int8_t* __restrict__ gup,
            const float* __restrict__ gus, const int8_t* __restrict__ dn,
            const float* __restrict__ dns, const float* __restrict__ dnr, int F, int dh,
            int chunk, int fmt, int group, __nv_bfloat16* __restrict__ out,
            float* __restrict__ ws, int* __restrict__ counter) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  const int tid = threadIdx.x;
  const int c = blockIdx.x, nc = gridDim.x;
  const int tpr = chunk / kVB;       // threads per gate|up row
  const int nsl = kThreads / tpr;    // row slices
  const int slice = tid / tpr;
  const int cw = 2 * chunk;          // gate | up columns of the chunk
  float* xs = smem;                  // [kMC, K]
  float* red = xs + kMC * K;         // [nsl, kMC, 2 * chunk]
  float* as = red + nsl * kMC * cw;  // [kMC, chunk] activations, bf16-rounded
  const long long D = 2LL * dh;

  for (int m0 = 0; m0 < M; m0 += kMC) {
    const int mc = min(kMC, M - m0);
    __syncthreads();
    al::stage_rows_f32<kMC>(xs, x, K, M, m0, 0, K);
    __syncthreads();

    float acc[kMC][2 * kVB];
#pragma unroll
    for (int m = 0; m < kMC; ++m)
#pragma unroll
      for (int i = 0; i < 2 * kVB; ++i) acc[m][i] = 0.f;
    const int colc = (tid % tpr) * kVB;  // within the chunk
    al::w4_accumulate<kMC, kVB>(acc, xs, K, 0, gup, F, c * chunk + colc, 0, K, slice, nsl, gus,
                                2LL * F, F, fmt, group);
#pragma unroll
    for (int m = 0; m < kMC; ++m)
#pragma unroll
      for (int i = 0; i < kVB; ++i) {
        red[(slice * kMC + m) * cw + colc + i] = acc[m][i];
        red[(slice * kMC + m) * cw + chunk + colc + i] = acc[m][kVB + i];
      }
    __syncthreads();
    for (int idx = tid; idx < kMC * chunk; idx += kThreads) {
      const int m = idx / chunk, j = idx % chunk;
      float g = 0.f, u = 0.f;
      for (int sl = 0; sl < nsl; ++sl) {
        g += red[(sl * kMC + m) * cw + j];
        u += red[(sl * kMC + m) * cw + chunk + j];
      }
      float a = g * (1.f / (1.f + expf(-g))) * u;
      if (dnr != nullptr) a *= dnr[c * chunk + j];  // in f32, before the rounding
      as[idx] = __bfloat162float(__float2bfloat16(a));
    }
    __syncthreads();

    for (int col = tid * kVB; col < dh; col += kThreads * kVB) {
      float acc2[kMC][2 * kVB];
#pragma unroll
      for (int m = 0; m < kMC; ++m)
#pragma unroll
        for (int i = 0; i < 2 * kVB; ++i) acc2[m][i] = 0.f;
      al::w4_accumulate<kMC, kVB>(acc2, as, chunk, c * chunk, dn, dh, col, c * chunk,
                                  (c + 1) * chunk, 0, 1, dns, D, dh, fmt, group);
      for (int m = 0; m < mc; ++m) {
        float* row = ws + ((long long)c * M + m0 + m) * D;
#pragma unroll
        for (int i = 0; i < kVB; ++i) {
          row[col + i] = acc2[m][i];
          row[dh + col + i] = acc2[m][kVB + i];
        }
      }
    }
  }

  if (!al::last_to_arrive(counter, nc, &flag)) return;
  const long long n4 = (long long)M * D / 4;  // D % 8 == 0
  const float4* part = reinterpret_cast<const float4*>(ws);
  for (long long i = tid; i < n4; i += kThreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c2 = 0; c2 < nc; ++c2) {
      const float4 t = __ldcg(part + (long long)c2 * n4 + i);
      v.x += t.x;
      v.y += t.y;
      v.z += t.z;
      v.w += t.w;
    }
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(out + 4 * i);
    o[0] = __floats2bfloat162_rn(v.x, v.y);
    o[1] = __floats2bfloat162_rn(v.z, v.w);
  }
  if (tid == 0) *counter = 0;
}

}  // namespace

// x [M, K] bf16; gup: the layer's [K, F] int8; gus: [K/group, 2F] f32; dn:
// the layer's [F, dh] int8; dns: [F/group, 2*dh] f32; dnr: the layer's [F]
// f32 down equalizer of a smoothed tree, or nullptr (the mode without one);
// out [M, 2*dh] bf16; ws f32 [F/chunk, M, 2*dh]; counter: one int, zero at
// entry (left zero).
// Requires M <= 64, al::group_ok(group), K % group == 0, chunk % group == 0,
// F % chunk == 0, 256 % (chunk / 8) == 0, dh % 8 == 0, 8-byte aligned slabs
// (checked by the wrapper).
AL_EXPORT int al_mlp_int4(const void* x, int M, int K, const void* gup, const void* gus,
                          const void* dn, const void* dns, const void* dnr, int F, int dh,
                          int chunk, int fmt, int group, void* out, void* ws, void* counter,
                          void* stream) {
  if (M == 0) return cudaSuccess;
  if (!al::group_ok(group) || K % group || chunk % group || F % chunk ||
      kThreads % (chunk / kVB) || dh % kVB)
    return cudaErrorInvalidValue;
  const int nsl = kThreads / (chunk / kVB);
  const size_t smem =
      sizeof(float) * ((size_t)kMC * K + (size_t)nsl * kMC * 2 * chunk + (size_t)kMC * chunk);
  cudaError_t err = al::allow_smem(mlp4_kernel, smem);
  if (err != cudaSuccess) return err;
  mlp4_kernel<<<F / chunk, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), M, K, static_cast<const int8_t*>(gup),
      static_cast<const float*>(gus), static_cast<const int8_t*>(dn),
      static_cast<const float*>(dns), static_cast<const float*>(dnr), F, dh, chunk, fmt, group,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(ws), static_cast<int*>(counter));
  return cudaGetLastError();
}
