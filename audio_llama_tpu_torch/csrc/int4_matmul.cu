// W4A16 matmul on one layer of a stacked int4 weight slab.
//
// Replaces audio_llama_tpu/ops/int4_matmul.py::_kernel_stacked
// (int4_matmul_stacked): x [M, K] bf16 @ dequant(packed_all[layer]) with the
// layer picked by a pointer offset into the [L, K, N/2] slab (no copy), for
// both pack formats (int4_common.cuh), writing the low-nibble columns
// [0, N/2) and the high-nibble columns [N/2, N) either as two planes or as
// one [M, N] row (a row stride and a high-plane offset say where).
// Numerics follow the TPU kernel: per 128-row group the dot of x with the
// integer nibble values is summed in f32, multiplied by the group's f32 scale
// and added to an f32 accumulator; the result is rounded to bf16 once.
//
// Two launch shapes of one function, by M:
//  - M <= 64 (decode): bound by the weight bytes, K * N / 2 per call plus
//    the scales (q|k|v at 3B dims: 8.4 MB, 2.5 us at 3.35 TB/s). A block owns 128 packed
//    columns (one 4-byte load a lane, a warp reads 128 contiguous bytes of
//    a row) and a range of scale groups; its 8 warps split the group's rows.
//    x stays in shared memory as f32. So that enough blocks stream the slab,
//    the groups are split over blocks (split-K); each block writes its f32
//    partial to a workspace and the last block of a column tile (by an
//    atomic counter) adds the partials in split order, so the sum does not
//    depend on which block finishes first.
//  - M > 64 (prefill): bound by the tensor cores (q|k|v at B = 1: 48 GFLOP,
//    49 us at 989 TFLOP/s). A block owns 64 rows x 64 packed columns (128
//    output columns); per group it stages the x tile and the weight tile
//    unpacked to bf16 in shared memory, runs mma.sync m16n8k16 (bf16 in,
//    f32 out) into a per-group partial, and scales the partial into the f32
//    accumulator in registers, where the accumulator layout of mma.sync is
//    known. Loads are not pipelined yet: TMA and wgmma come later.
#include "int4_common.cuh"

namespace {

using al::kGroup;

constexpr int kDecodeThreads = 256;  // 8 warps
constexpr int kDecodeCols = 128;     // packed columns per block (32 lanes x 4 bytes)

__device__ __forceinline__ void store_col(__nv_bfloat16* out, long long ldo, long long hi_off,
                                          int tile, int row, int c, float v) {
  const long long at = c < kDecodeCols ? (long long)row * ldo + tile * kDecodeCols + c
                                       : hi_off + (long long)row * ldo + tile * kDecodeCols +
                                             (c - kDecodeCols);
  out[at] = __float2bfloat16(v);
}

__device__ __forceinline__ long long ws_col(int nh, int tile, int c) {
  return c < kDecodeCols ? tile * kDecodeCols + c : nh + tile * kDecodeCols + (c - kDecodeCols);
}

// grid (nh / 128, ksplit, ceil(M / MC)); dynamic shared memory
// 4 * (MC * gps * 128 + 8 * MC * 256) bytes.
template <int MC>
__global__ void __launch_bounds__(kDecodeThreads)
w4_decode_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                 const int8_t* __restrict__ p, int nh, const float* __restrict__ s, int fmt,
                 int gps, __nv_bfloat16* __restrict__ out, long long ldo, long long hi_off,
                 float* __restrict__ ws, int* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  const int tile = blockIdx.x, ks = blockIdx.y, mz = blockIdx.z;
  const int ksplit = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = mz * MC, mc = min(MC, M - m0);
  const int kb = ks * gps * kGroup, ke = min(K, kb + gps * kGroup), kn = ke - kb;
  float* xs = smem;                    // [MC, kn]
  float* red = smem + MC * gps * kGroup;  // [8 warps, MC, 256 columns]

  al::stage_rows_f32<MC>(xs, x, K, M, m0, kb, kn);
  __syncthreads();
  float acc[MC][8];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[m][i] = 0.f;
  const int col = tile * kDecodeCols + lane * 4;
  al::w4_accumulate<MC, 4>(acc, xs, kn, kb, p, nh, col, kb, ke, warp, 8, s, 2LL * nh, nh, fmt);
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[(warp * MC + m) * 256 + lane * 4 + i] = acc[m][i];
      red[(warp * MC + m) * 256 + kDecodeCols + lane * 4 + i] = acc[m][4 + i];
    }
  __syncthreads();

  if (ksplit == 1) {
    for (int idx = threadIdx.x; idx < mc * 256; idx += blockDim.x) {
      const int m = idx / 256, c = idx % 256;
      float v = 0.f;
      for (int w = 0; w < 8; ++w) v += red[(w * MC + m) * 256 + c];
      store_col(out, ldo, hi_off, tile, m0 + m, c, v);
    }
    return;
  }
  const long long wrow = 2LL * nh;
  float* part = ws + (long long)(mz * ksplit + ks) * MC * wrow;
  for (int idx = threadIdx.x; idx < mc * 256; idx += blockDim.x) {
    const int m = idx / 256, c = idx % 256;
    float v = 0.f;
    for (int w = 0; w < 8; ++w) v += red[(w * MC + m) * 256 + c];
    part[m * wrow + ws_col(nh, tile, c)] = v;
  }
  int* counter = counters + mz * gridDim.x + tile;
  if (!al::last_to_arrive(counter, ksplit, &flag)) return;
  for (int idx = threadIdx.x; idx < mc * 256; idx += blockDim.x) {
    const int m = idx / 256, c = idx % 256;
    float v = 0.f;
    for (int k2 = 0; k2 < ksplit; ++k2)
      v += __ldcg(ws + (long long)(mz * ksplit + k2) * MC * wrow + m * wrow + ws_col(nh, tile, c));
    store_col(out, ldo, hi_off, tile, m0 + m, c, v);
  }
  if (threadIdx.x == 0) *counter = 0;
}

constexpr int kPM = 64;        // rows per prefill block
constexpr int kPN = 64;        // packed columns per prefill block (128 output columns)
constexpr int kLD = kGroup + 8;  // bf16 pitch of the staged tiles
constexpr int kPrefillThreads = 128;
constexpr size_t kPrefillSmem = (size_t)kPM * kLD * 2 + (size_t)2 * kPN * kLD * 2 + 2 * kPN * 4;

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid (nh / 64, ceil(M / 64)); 4 warps, warp w owns rows w*16 .. w*16+15 of
// the block and all 128 output columns (16 n-tiles of 8).
__global__ void __launch_bounds__(kPrefillThreads)
w4_prefill_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                  const int8_t* __restrict__ p, int nh, const float* __restrict__ s, int fmt,
                  __nv_bfloat16* __restrict__ out, long long ldo, long long hi_off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64 rows][kLD]
  __nv_bfloat16* sW = sX + kPM * kLD;  // [128 output columns][kLD], column-major in k
  float* sS = reinterpret_cast<float*>(sW + 2 * kPN * kLD);  // [128] this group's scales
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kPN, m0 = blockIdx.y * kPM;
  const int n_groups = K / kGroup;

  float acc[16][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;

  for (int g = 0; g < n_groups; ++g) {
    __syncthreads();  // every warp is done with the previous group's tiles
    for (int i = tid; i < kPM * (kGroup / 8); i += kPrefillThreads) {
      const int r = i / (kGroup / 8), c = (i % (kGroup / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K + g * kGroup + c);
      *reinterpret_cast<uint4*>(sX + r * kLD + c) = v;
    }
    for (int i = tid; i < kGroup * (kPN / 16); i += kPrefillThreads) {
      const int k = i / (kPN / 16), cb = (i % (kPN / 16)) * 16;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          p + (long long)(g * kGroup + k) * nh + n0 + cb));
      const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int val = (int)(signed char)bytes[j];
        sW[(cb + j) * kLD + k] = __float2bfloat16((float)al::nib_lo(val, fmt));
        sW[(kPN + cb + j) * kLD + k] = __float2bfloat16((float)al::nib_hi(val));
      }
    }
    if (tid < kPN) {
      const float* sg = s + (long long)g * 2 * nh;
      sS[tid] = sg[n0 + tid];
      sS[kPN + tid] = sg[nh + n0 + tid];
    }
    __syncthreads();

    float part[16][4];
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[t][i] = 0.f;
    const __nv_bfloat16* xa = sX + (warp * 16 + gid) * kLD + tig * 2;
#pragma unroll
    for (int kk = 0; kk < kGroup; kk += 16) {
      const uint32_t a0 = lds32(xa + kk), a1 = lds32(xa + 8 * kLD + kk);
      const uint32_t a2 = lds32(xa + kk + 8), a3 = lds32(xa + 8 * kLD + kk + 8);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const __nv_bfloat16* wb = sW + (t * 8 + gid) * kLD + kk + tig * 2;
        mma_bf16(part[t], a0, a1, a2, a3, lds32(wb), lds32(wb + 8));
      }
    }
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int c = t * 8 + tig * 2;
      const float s0 = sS[c], s1 = sS[c + 1];
      acc[t][0] += part[t][0] * s0;
      acc[t][1] += part[t][1] * s1;
      acc[t][2] += part[t][2] * s0;
      acc[t][3] += part[t][3] * s1;
    }
  }

  const int r0 = m0 + warp * 16 + gid;
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int c = t * 8 + tig * 2;
    __nv_bfloat16* base = c < kPN ? out + n0 + c : out + hi_off + n0 + (c - kPN);
    if (r0 < M)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)r0 * ldo) =
          __floats2bfloat162_rn(acc[t][0], acc[t][1]);
    if (r0 + 8 < M)
      *reinterpret_cast<__nv_bfloat162*>(base + (long long)(r0 + 8) * ldo) =
          __floats2bfloat162_rn(acc[t][2], acc[t][3]);
  }
}

template <int MC>
cudaError_t launch_decode(const __nv_bfloat16* x, int M, int K, const int8_t* p, int nh,
                          const float* s, int fmt, int gps, int ksplit, __nv_bfloat16* out,
                          long long ldo, long long hi_off, float* ws, int* counters,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)MC * gps * kGroup + (size_t)8 * MC * 256);
  cudaError_t err = al::allow_smem(w4_decode_kernel<MC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nh / kDecodeCols, ksplit, (M + MC - 1) / MC);
  w4_decode_kernel<MC><<<grid, kDecodeThreads, smem, stream>>>(x, M, K, p, nh, s, fmt, gps, out,
                                                               ldo, hi_off, ws, counters);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 row-major; packed: the layer's [K, nh] int8 slab; scales:
// the layer's [K/128, 2*nh] f32; out bf16: low-nibble column j of row m at
// out[m*ldo + j], high-nibble column j at out[hi_off + m*ldo + j].
// M <= 64 takes the decode shape with mc rows per block (1, 2, 4 or 8), gps
// groups per block and ksplit = ceil(K/128 / gps) blocks along K; ws holds
// f32 [ceil(M/mc), ksplit, mc, 2*nh] and counters ceil(M/mc) * nh/128 ints
// that are zero at entry (and left zero). Requires K % 128 == 0,
// nh % 128 == 0, 16-byte aligned x and packed (checked by the wrapper).
AL_EXPORT int al_int4_matmul(const void* x, int M, int K, const void* packed, int nh,
                             const void* scales, int fmt, void* out, long long ldo,
                             long long hi_off, void* ws, void* counters, int mc, int gps,
                             int ksplit, void* stream) {
  if (M == 0) return cudaSuccess;
  if (K % kGroup || nh % kDecodeCols) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* p = static_cast<const int8_t*>(packed);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* w = static_cast<float*>(ws);
  auto* c = static_cast<int*>(counters);
  if (M > 64) {
    cudaError_t err = al::allow_smem(w4_prefill_kernel, kPrefillSmem);
    if (err != cudaSuccess) return err;
    dim3 grid(nh / kPN, (M + kPM - 1) / kPM);
    w4_prefill_kernel<<<grid, kPrefillThreads, kPrefillSmem, st>>>(xb, M, K, p, nh, s, fmt, o,
                                                                   ldo, hi_off);
    return cudaGetLastError();
  }
  switch (mc) {
    case 1: return launch_decode<1>(xb, M, K, p, nh, s, fmt, gps, ksplit, o, ldo, hi_off, w, c, st);
    case 2: return launch_decode<2>(xb, M, K, p, nh, s, fmt, gps, ksplit, o, ldo, hi_off, w, c, st);
    case 4: return launch_decode<4>(xb, M, K, p, nh, s, fmt, gps, ksplit, o, ldo, hi_off, w, c, st);
    case 8: return launch_decode<8>(xb, M, K, p, nh, s, fmt, gps, ksplit, o, ldo, hi_off, w, c, st);
    default: return cudaErrorInvalidValue;
  }
}
