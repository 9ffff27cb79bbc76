// W4A16 matmul on one layer of a stacked int4 weight slab.
//
// Replaces audio_llama_tpu/ops/int4_matmul.py::_kernel_stacked
// (int4_matmul_stacked): x [M, K] bf16 @ dequant(packed_all[layer]) with the
// layer picked by a pointer offset into the [L, K, N/2] slab (no copy), for
// both pack formats (int4_common.cuh), writing the low-nibble columns
// [0, N/2) and the high-nibble columns [N/2, N) either as two planes or as
// one [M, N] row (a row stride and a high-plane offset say where).
// Numerics follow the TPU kernel: per scale group (`group` rows, a run-time
// argument: 32, 64, 128 or 256, int4_common.cuh) the dot of x with the
// integer nibble values is summed in f32, multiplied by the group's f32 scale
// and added to an f32 accumulator; the result is rounded to bf16 once.
//
// Two launch shapes of one function, by M:
//  - M <= 64 (decode): bound by the weight bytes, K * N / 2 per call plus
//    the scales (q|k|v at 3B dims, group 128: 8.4 MB, 2.5 us at 3.35 TB/s;
//    group 32: 9.8 MB, 2.9 us). A block owns 128 packed columns (one 4-byte
//    load a lane, a warp reads 128 contiguous bytes of a row) and a range of
//    K rows, a multiple of 128 and of the group (so the block count and
//    shared memory do not depend on the group; a smaller group only reads
//    more scales); its 8 warps split each group's rows.
//    x stays in shared memory as f32. So that enough blocks stream the slab,
//    the K rows are split over blocks (split-K); each block writes its f32
//    partial to a workspace and the last block of a column tile (by an
//    atomic counter) adds the partials in split order, so the sum does not
//    depend on which block finishes first.
//  - M > 64 (prefill): bound by the tensor cores (q|k|v at B = 1: 48 GFLOP,
//    49 us at 989 TFLOP/s). A block owns 64 rows x 64 packed columns (128
//    output columns); per 128-row tile it stages the x tile, the weight tile
//    unpacked to bf16 and the scales of the tile's groups in shared memory,
//    runs mma.sync m16n8k16 (bf16 in, f32 out) into a per-group partial, and
//    at each group's end (every group / 16 k-steps; a group above 128 spans
//    tiles) scales the partial into the f32 accumulator in registers, where
//    the accumulator layout of mma.sync is known. A small group costs no
//    more barriers, only more scale multiplies. Loads are not pipelined yet:
//    TMA and wgmma come later.
//
// The contraction-split twin, replacing ::_kernel_stacked_ksplit (:393;
// block_k or the INT4_BK default, 768 or 1536 at K 3072): K is cut into
// blocks of bk rows; each block's groups are summed into a fresh f32 partial
// in order, and the partials are added into the accumulator in block order,
// then rounded once (the TPU kernel's VMEM scratch across its minor grid
// axis). Its bounds are the whole-K kernel's (the same bytes and FLOP). In
// the decode shape the blocks along K are the split-K blocks, bk rows each,
// whose workspace reduce already adds the partials in block order; in the
// prefill shape (KSPLIT) the block walks the K blocks in order itself, each
// in a register partial added to the accumulator at the block's last group,
// with no workspace.
#include "int4_common.cuh"

namespace {

using al::kTile;

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

// grid (nh / 128, ksplit, ceil(M / MC)); block ks takes K rows
// [ks * kr, min(K, (ks + 1) * kr)); dynamic shared memory
// 4 * (MC * kr + 8 * MC * 256) bytes.
template <int MC>
__global__ void __launch_bounds__(kDecodeThreads)
w4_decode_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                 const int8_t* __restrict__ p, int nh, const float* __restrict__ s, int fmt,
                 int group, int kr, __nv_bfloat16* __restrict__ out, long long ldo,
                 long long hi_off, float* __restrict__ ws, int* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int flag;
  const int tile = blockIdx.x, ks = blockIdx.y, mz = blockIdx.z;
  const int ksplit = gridDim.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = mz * MC, mc = min(MC, M - m0);
  const int kb = ks * kr, ke = min(K, kb + kr), kn = ke - kb;
  float* xs = smem;             // [MC, kn]
  float* red = smem + MC * kr;  // [8 warps, MC, 256 columns]

  al::stage_rows_f32<MC>(xs, x, K, M, m0, kb, kn);
  __syncthreads();
  float acc[MC][8];
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[m][i] = 0.f;
  const int col = tile * kDecodeCols + lane * 4;
  al::w4_accumulate<MC, 4>(acc, xs, kn, kb, p, nh, col, kb, ke, warp, 8, s, 2LL * nh, nh, fmt,
                           group);
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

constexpr int kPM = 64;         // rows per prefill block
constexpr int kPN = 64;         // packed columns per prefill block (128 output columns)
constexpr int kLD = kTile + 8;  // bf16 pitch of the staged tiles
constexpr int kTileGroups = kTile / 16;  // scale groups a tile holds at the smallest group
constexpr int kPrefillThreads = 128;
constexpr size_t kPrefillSmem =
    (size_t)kPM * kLD * 2 + (size_t)2 * kPN * kLD * 2 + (size_t)kTileGroups * 2 * kPN * 4;

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

// dst[t][i] += part[t][i] * the scale of its column (sc: 128 columns of one
// group), then part = 0.
__device__ __forceinline__ void scale_into(float (&dst)[16][4], float (&part)[16][4],
                                           const float* sc, int tig) {
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int c = t * 8 + tig * 2;
    const float s0 = sc[c], s1 = sc[c + 1];
    dst[t][0] += part[t][0] * s0;
    dst[t][1] += part[t][1] * s1;
    dst[t][2] += part[t][2] * s0;
    dst[t][3] += part[t][3] * s1;
#pragma unroll
    for (int i = 0; i < 4; ++i) part[t][i] = 0.f;
  }
}

// A group's last k-step: its partial joins the sum; under KSPLIT the K
// block's, which joins acc at the block's last group (gpb groups).
template <bool KSPLIT>
__device__ __forceinline__ void end_group(float (&acc)[16][4], float (&blk)[KSPLIT ? 16 : 1][4],
                                          float (&part)[16][4], const float* sc, int tig,
                                          int& done, int gpb) {
  if constexpr (KSPLIT) {
    scale_into(blk, part, sc, tig);
    if (++done == gpb) {
      done = 0;
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[t][i] += blk[t][i];
          blk[t][i] = 0.f;
        }
    }
  } else {
    scale_into(acc, part, sc, tig);
  }
}

// grid (nh / 64, ceil(M / 64)); 4 warps, warp w owns rows w*16 .. w*16+15 of
// the block and all 128 output columns (16 n-tiles of 8). The block walks K
// in tiles of 128 rows; a group ends every group / 16 k-steps, where its
// partial is scaled into the accumulator. TG is the number of groups a tile
// holds (128 / group, or 1), a template argument so that the group ends are
// known where the k-steps are unrolled; SPAN (a group above 128) carries the
// partial over tiles and ends it at the group's last tile. KSPLIT: gpb
// groups a K block, each block's groups summed in `blk` and added to acc at
// its last group.
template <bool KSPLIT, int TG, bool SPAN>
__global__ void __launch_bounds__(kPrefillThreads)
w4_prefill_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                  const int8_t* __restrict__ p, int nh, const float* __restrict__ s, int fmt,
                  int group, int gpb, __nv_bfloat16* __restrict__ out, long long ldo,
                  long long hi_off) {
  constexpr int kSteps = kTile / 16 / TG;  // m16n8k16 k-steps a group, inside a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64 rows][kLD]
  __nv_bfloat16* sW = sX + kPM * kLD;  // [128 output columns][kLD], column-major in k
  float* sS = reinterpret_cast<float*>(sW + 2 * kPN * kLD);  // [TG][128]: the tile's groups
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kPN, m0 = blockIdx.y * kPM;
  const int n_tiles = K / kTile;
  int done = 0;  // groups into the current K block (KSPLIT)

  float acc[16][4], carry[SPAN ? 16 : 1][4];  // carry: a spanning group's partial
  float blk[KSPLIT ? 16 : 1][4];
#pragma unroll
  for (int t = 0; t < 16; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = carry[SPAN ? t : 0][i] = 0.f;
  if constexpr (KSPLIT) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) blk[t][i] = 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kTile;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kPM * (kTile / 8); i += kPrefillThreads) {
      const int r = i / (kTile / 8), c = (i % (kTile / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M)
        v = *reinterpret_cast<const uint4*>(x + (long long)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(sX + r * kLD + c) = v;
    }
    for (int i = tid; i < kTile * (kPN / 16); i += kPrefillThreads) {
      const int k = i / (kPN / 16), cb = (i % (kPN / 16)) * 16;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          p + (long long)(k0 + k) * nh + n0 + cb));
      const unsigned char* bytes = reinterpret_cast<const unsigned char*>(&v);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int val = (int)(signed char)bytes[j];
        sW[(cb + j) * kLD + k] = __float2bfloat16((float)al::nib_lo(val, fmt));
        sW[(kPN + cb + j) * kLD + k] = __float2bfloat16((float)al::nib_hi(val));
      }
    }
    for (int i = tid; i < TG * kPN; i += kPrefillThreads) {
      const int j = i / kPN, c = i % kPN;
      const int g = SPAN ? k0 / group : tile * TG + j;  // the tile's groups
      const float* sg = s + (long long)g * 2 * nh;
      sS[j * 2 * kPN + c] = sg[n0 + c];
      sS[j * 2 * kPN + kPN + c] = sg[nh + n0 + c];
    }
    __syncthreads();

    float part[16][4];
#pragma unroll
    for (int t = 0; t < 16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (SPAN)
          part[t][i] = carry[t][i];
        else
          part[t][i] = 0.f;
      }
    const __nv_bfloat16* xa = sX + (warp * 16 + gid) * kLD + tig * 2;
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      const uint32_t a0 = lds32(xa + kk), a1 = lds32(xa + 8 * kLD + kk);
      const uint32_t a2 = lds32(xa + kk + 8), a3 = lds32(xa + 8 * kLD + kk + 8);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const __nv_bfloat16* wb = sW + (t * 8 + gid) * kLD + kk + tig * 2;
        mma_bf16(part[t], a0, a1, a2, a3, lds32(wb), lds32(wb + 8));
      }
      if constexpr (!SPAN) {
        if ((kk / 16 + 1) % kSteps == 0)  // known once the k-steps are unrolled
          end_group<KSPLIT>(acc, blk, part, sS + (kk / 16 / kSteps) * 2 * kPN, tig, done, gpb);
      }
    }
    if constexpr (SPAN) {
      if ((k0 + kTile) % group == 0)  // the group's last tile
        end_group<KSPLIT>(acc, blk, part, sS, tig, done, gpb);
#pragma unroll
      for (int t = 0; t < 16; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) carry[t][i] = part[t][i];
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

template <bool KSPLIT, int TG, bool SPAN = false>
cudaError_t launch_prefill(dim3 grid, const __nv_bfloat16* x, int M, int K, const int8_t* p,
                           int nh, const float* s, int fmt, int group, int gpb,
                           __nv_bfloat16* out, long long ldo, long long hi_off,
                           cudaStream_t stream) {
  cudaError_t err = al::allow_smem(w4_prefill_kernel<KSPLIT, TG, SPAN>, kPrefillSmem);
  if (err != cudaSuccess) return err;
  w4_prefill_kernel<KSPLIT, TG, SPAN><<<grid, kPrefillThreads, kPrefillSmem, stream>>>(
      x, M, K, p, nh, s, fmt, group, gpb, out, ldo, hi_off);
  return cudaGetLastError();
}

template <int MC>
cudaError_t launch_decode(const __nv_bfloat16* x, int M, int K, const int8_t* p, int nh,
                          const float* s, int fmt, int group, int kr, int ksplit,
                          __nv_bfloat16* out, long long ldo, long long hi_off, float* ws,
                          int* counters, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)MC * kr + (size_t)8 * MC * 256);
  cudaError_t err = al::allow_smem(w4_decode_kernel<MC>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(nh / kDecodeCols, ksplit, (M + MC - 1) / MC);
  w4_decode_kernel<MC><<<grid, kDecodeThreads, smem, stream>>>(
      x, M, K, p, nh, s, fmt, group, kr, out, ldo, hi_off, ws, counters);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] bf16 row-major; packed: the layer's [K, nh] int8 slab; scales:
// the layer's [K/group, 2*nh] f32; out bf16: low-nibble column j of row m at
// out[m*ldo + j], high-nibble column j at out[hi_off + m*ldo + j].
// M <= 64 takes the decode shape with mc rows per block (1, 2, 4 or 8), kr
// K rows per block (a multiple of the group) and ksplit = ceil(K / kr)
// blocks along K (a K-split call passes kr = bk and ksplit = K / bk); ws
// holds f32 [ceil(M/mc), ksplit, mc, 2*nh] and counters ceil(M/mc) * nh/128
// ints that are zero at entry (and left zero). M > 64 takes the prefill
// shape; gpb > 0 (groups per K block, dividing K / group) makes it the
// K-split kernel, 0 the whole-K one. Requires al::group_ok(group),
// K % group == 0, K % 128 == 0, nh % 128 == 0, 16-byte aligned x and packed
// (checked by the wrapper).
AL_EXPORT int al_int4_matmul(const void* x, int M, int K, const void* packed, int nh,
                             const void* scales, int fmt, void* out, long long ldo,
                             long long hi_off, void* ws, void* counters, int mc, int kr,
                             int ksplit, int gpb, int group, void* stream) {
  if (M == 0) return cudaSuccess;
  if (!al::group_ok(group) || K % group || K % kTile || nh % kDecodeCols)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* p = static_cast<const int8_t*>(packed);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* w = static_cast<float*>(ws);
  auto* c = static_cast<int*>(counters);
  if (M > 64) {
    if (gpb > 0 && (K / group) % gpb) return cudaErrorInvalidValue;
    const dim3 grid(nh / kPN, (M + kPM - 1) / kPM);
    // groups a tile (0: a group above 128, spanning tiles), K-split
    const int tg = group <= kTile ? kTile / group : 0;
#define AL_PREFILL(KS, TG, SPAN) \
  launch_prefill<KS, TG, SPAN>(grid, xb, M, K, p, nh, s, fmt, group, gpb, o, ldo, hi_off, st)
    switch ((gpb > 0 ? 16 : 0) + tg) {
      case 0: return AL_PREFILL(false, 1, true);
      case 1: return AL_PREFILL(false, 1, false);
      case 2: return AL_PREFILL(false, 2, false);
      case 4: return AL_PREFILL(false, 4, false);
      case 8: return AL_PREFILL(false, 8, false);
      case 16: return AL_PREFILL(true, 1, true);
      case 17: return AL_PREFILL(true, 1, false);
      case 18: return AL_PREFILL(true, 2, false);
      case 20: return AL_PREFILL(true, 4, false);
      case 24: return AL_PREFILL(true, 8, false);
      default: return cudaErrorInvalidValue;
    }
#undef AL_PREFILL
  }
  if (kr <= 0 || kr % group || ksplit != (K + kr - 1) / kr) return cudaErrorInvalidValue;
#define AL_DECODE(MC) \
  launch_decode<MC>(xb, M, K, p, nh, s, fmt, group, kr, ksplit, o, ldo, hi_off, w, c, st)
  switch (mc) {
    case 1: return AL_DECODE(1);
    case 2: return AL_DECODE(2);
    case 4: return AL_DECODE(4);
    case 8: return AL_DECODE(8);
    default: return cudaErrorInvalidValue;
  }
#undef AL_DECODE
}

// The unstacked W4A16, replacing audio_llama_tpu/ops/int4_matmul.py::_kernel
// (int4_matmul): x [M, K] bf16 @ dequant(packed [K, N/2], scales [K/group, N])
// -> out [M, N] bf16 with f32 accumulation, the TPU kernel's lo and hi planes
// written side by side as one row (its [2, M, N/2] output concatenated). The
// same device code as the stacked launch with the layer's slab the whole
// weight: the decode shape (split-K workspace `ws`, `counters`) up to 64
// rows, the prefill shape past them, whole K.
AL_EXPORT int al_int4_matmul_2d(const void* x, int M, int K, const void* packed, int nh,
                                const void* scales, int fmt, void* out, void* ws,
                                void* counters, int mc, int kr, int ksplit, int group,
                                void* stream) {
  return al_int4_matmul(x, M, K, packed, nh, scales, fmt, out, 2LL * nh, nh, ws, counters, mc,
                        kr, ksplit, 0, group, stream);
}
