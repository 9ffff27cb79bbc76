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
//  - M > 64 (prefill): bound by the tensor cores, 2 M K N FLOP at 989
//    TFLOP/s bf16 (M 6104: gate|up 614.4 GFLOP, 0.621 ms; down 0.311 ms;
//    q|k|v 0.194 ms; o 0.1165 ms; the bytes, ~263 MB at gate|up, take 0.08
//    ms at 3.35 TB/s). On wgmma and TMA (sm90.cuh), with the operands
//    swapped: a block computes out^T = W^T x^T for 64 tokens x 128 packed
//    columns (256 output columns). The weight is wgmma's A, from registers,
//    so no bf16 weight tile is ever stored; the x tile is B, K-major in
//    shared memory as TMA lands it (128B swizzle). A producer warpgroup's
//    first thread streams 128-row K tiles (the x tile, the packed [K, nh]
//    bytes of the layer through a 2-D map at the layer's address, and the
//    tile's scale rows) through a 4-stage ring behind full and empty
//    mbarriers; setmaxnreg gives the two consumer warpgroups 232 registers
//    and the producer 40. Consumer warpgroup v runs two m64n64k16 products a
//    k-step over packed columns 64 v .. 64 v + 63: one of their low nibbles,
//    one of their high. A thread's accumulator rows r and r + 8 are packed
//    columns c and c + 1, so one ldmatrix.trans word (the 128B swizzle keeps
//    it free of bank conflicts) holds the bytes of both columns at two k
//    rows, and feeds both products: each nibble becomes a bf16 by an
//    exponent-bias trick (0x4300 | (value + 8), less 136: exact). A group's
//    first k-step starts the two partials afresh (scale_d 0); its last waits
//    for them and adds partial x the group's scale (one f32 pair a thread
//    per product) into the f32 accumulators. A group above 128 carries its
//    partials over tiles (SPAN). The epilogue writes bf16 pairs of the two
//    columns per token, skipping rows past M; TMA zero-fills them on the way
//    in. Up to 4 k-steps go out as one wgmma commit group (1 under the
//    K-split, whose running sums leave no registers for more): 9% faster
//    than one at group 128. On an H100 80GB HBM3 at 700 W
//    (scripts/int4_group_timing.py) gate|up at M 6104 takes 1.22 ms at
//    group 128, 51% of the bound's rate and 1.6x cuBLAS's bf16 product on
//    the dequantized weight, 1.59 ms at group 32; every prefill product at
//    M 6104 runs within 1.55-2.4x cuBLAS. Not yet: a persistent grid,
//    clusters multicasting x (x is read nh / 128 times through L2).
//    Ping-pong of the two warpgroups (one scales while the other's wgmma
//    runs) was tried: no gain at group 128, 2-9% at group 32, a loss under
//    the K-split.
//
// The contraction-split twin, replacing ::_kernel_stacked_ksplit (:393;
// block_k or the INT4_BK default, 768 or 1536 at K 3072): K is cut into
// blocks of bk rows; each block's groups are summed into a fresh f32 partial
// in order, and the partials are added into the accumulator in block order,
// then rounded once (the TPU kernel's VMEM scratch across its minor grid
// axis). Its bounds are the whole-K kernel's (the same bytes and FLOP). In
// the decode shape the blocks along K are the split-K blocks, bk rows each,
// whose workspace reduce already adds the partials in block order; in the
// prefill shape (KSPLIT) the register accumulators hold the K block's sum,
// added at the block's last group to the running sum of the blocks, also in
// registers, with no workspace.
#include "int4_common.cuh"
#include "sm90.cuh"

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

// --- the prefill shape (M > 64) on wgmma and TMA --------------------------------

constexpr int kPTokens = 64;    // tokens a block: wgmma's N
constexpr int kPCols = 128;     // packed columns a block, 64 a consumer warpgroup
constexpr int kPStages = 4;     // the ring
constexpr int kPThreads = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kPXBytes = kPTokens * kTile * 2;  // the x tile: two 64-column blocks
constexpr int kPWBytes = kTile * kPCols;        // the packed tile

// One instance: TG scale groups a 128-row tile (128 / group; 1 with SPAN, a
// group above 128 spanning tiles), KSPLIT the K-split's block partials.
template <bool KSPLIT_, int TG_, bool SPAN_>
struct Prefill {
  static constexpr bool KSPLIT = KSPLIT_, SPAN = SPAN_;
  static constexpr int TG = TG_;
  static constexpr int kSBytes = TG * kPCols * 4;  // the tile's scale rows of one half
  static constexpr int kStage = kPXBytes + kPWBytes + 2 * kSBytes;
  static constexpr int kBars = kPStages * kStage;
  static constexpr size_t kSmem = kBars + 16 * kPStages + 1024;  // + base alignment
  static_assert(kStage % 1024 == 0, "stages stay on 1024-byte boundaries");
  static_assert(kSmem <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The nibbles at bits 0-3 and 16-19 of w (offset-binary: value + 8) as a
// bf16 pair of their values: 0x4300 | u is 128 + u, and 128 + u - 136 is
// exact.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t w) {
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"((w & 0x000F000Fu) | 0x43004300u), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

// A word of ldmatrix.trans (bytes 0, 2: packed column c at rows k, k + 1;
// bytes 1, 3: column c + 1) -> the A fragment's two registers of those rows
// for the low-nibble product (lo[0]: row c, lo[1]: row c + 1) and the
// high-nibble one.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t& lo0, uint32_t& lo1,
                                            uint32_t& hi0, uint32_t& hi1) {
  lo0 = nibble_pair(w);
  lo1 = nibble_pair(w >> 8);
  hi0 = nibble_pair(w >> 4);
  hi1 = nibble_pair(w >> 12);
}

// acc += part * the scale of its accumulator row (s.x: the thread's first
// row, s.y: its second).
__device__ __forceinline__ void scale_rows(float (&acc)[32], const float (&part)[32], float2 s) {
#pragma unroll
  for (int j = 0; j < 32; j += 4) {
    acc[j] = fmaf(part[j], s.x, acc[j]);
    acc[j + 1] = fmaf(part[j + 1], s.x, acc[j + 1]);
    acc[j + 2] = fmaf(part[j + 2], s.y, acc[j + 2]);
    acc[j + 3] = fmaf(part[j + 3], s.y, acc[j + 3]);
  }
}

// grid (nh / 128, ceil(M / 64)). A block owns 64 tokens x 128 packed columns
// (256 output columns); consumer warpgroup v the packed columns 64 v ..
// 64 v + 63 as two m64n64 products out^T = W^T x^T, one of the low nibbles
// and one of the high, with W^T from registers (A) and the x tile from
// shared memory (B, K-major). The producer's first thread streams 128-row K
// tiles (x, packed bytes, the tile's scale rows) through the ring by TMA.
// Per k-step each consumer thread turns one ldmatrix.trans word pair into
// its A fragments; up to 4 k-steps of one group go out as one commit group,
// converted while the previous one runs. A group's first k-step starts its
// partials afresh (scale_d 0), its last waits for them and scales them into
// the f32 accumulators. KSPLIT: the accumulators hold a K block's sum, added
// to the running sum of the blocks (more registers) at the block's last
// group.
template <class P>
__global__ void __launch_bounds__(kPThreads, 1)
    w4_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap ts, int M, int K, int nh, int fmt,
                    int group, int gpb, __nv_bfloat16* __restrict__ out, long long ldo,
                    long long hi_off) {
  constexpr int kSteps = kTile / 16 / P::TG;  // k-steps a group inside a tile
  // k-steps a commit group: up to 4 inside a group; 1 where the K-split's
  // running sums take 64 more registers (2 spill)
  constexpr int kC = P::KSPLIT ? 1 : kSteps < 4 ? kSteps : 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = al::sm90::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBars);
  uint64_t* empty = full + kPStages;
  const int n0 = blockIdx.x * kPCols, m0 = blockIdx.y * kPTokens;
  const int n_tiles = K / kTile;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      al::sm90::mbar_init(&full[s], 1);
      al::sm90::mbar_init(&empty[s], 256);
    }
    al::sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    al::sm90::regs_dec<40>();
    if (threadIdx.x == 256) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kPStages;
        unsigned char* s = smem + st * P::kStage;
        const int k0 = t * kTile, g0 = k0 / group;
        al::sm90::mbar_wait(&empty[st], ((t / kPStages) & 1) ^ 1);
        al::sm90::mbar_arrive_tx(&full[st], P::kStage);
        al::sm90::tma_load_2d(s, &tx, &full[st], k0, m0);
        al::sm90::tma_load_2d(s + kPXBytes / 2, &tx, &full[st], k0 + 64, m0);
        al::sm90::tma_load_2d(s + kPXBytes, &tw, &full[st], n0, k0);
        al::sm90::tma_load_2d(s + kPXBytes + kPWBytes, &ts, &full[st], n0, g0);
        al::sm90::tma_load_2d(s + kPXBytes + kPWBytes + P::kSBytes, &ts, &full[st], nh + n0, g0);
      }
    }
    return;
  }

  al::sm90::regs_inc<232>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int col = wg * 64 + warp * 16 + 2 * (lane >> 2);  // the thread's packed columns col, col+1
  const int chunk = wg * 4 + warp;  // the warp's 16 columns: a 16-byte chunk of a packed row
  // every nibble to offset-binary: pair flips both sign bits, obin the high one
  const uint32_t flip = fmt == al::kFmtObin ? 0x80808080u : 0x88888888u;
  // acc: the sum of the groups so far (KSPLIT: of the K block's), tot: of
  // the K blocks so far (KSPLIT)
  constexpr int kTot = P::KSPLIT ? 32 : 1;
  float acc_lo[32], acc_hi[32], part_lo[32], part_hi[32], tot_lo[kTot], tot_hi[kTot];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_lo[i] = acc_hi[i] = part_lo[i] = part_hi[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTot; ++i) tot_lo[i] = tot_hi[i] = 0.f;
  int done = 0;  // groups into the current K block (KSPLIT)

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kPStages;
    const unsigned char* s = smem + st * P::kStage;
    const int k0 = t * kTile;
    al::sm90::mbar_wait(&full[st], (t / kPStages) & 1);
    const uint32_t xs = al::sm90::smem_u32(s);
    // ldmatrix row addresses: lane i -> packed row 32 p + i, the warp's chunk
    // where the 128B swizzle put it
    const uint32_t wl =
        al::sm90::smem_u32(s + kPXBytes) + lane * kPCols + ((chunk ^ (lane & 7)) << 4);
    const float* slo = reinterpret_cast<const float*>(s + kPXBytes + kPWBytes) + col;
    const float* shi = slo + P::TG * kPCols;
    const bool fresh = !P::SPAN || k0 % group == 0;  // the tile starts a group
    uint32_t wd[4];  // k-steps 2p, 2p + 1: packed rows 32p + 0..7, 8..15, 16..23, 24..31
#pragma unroll
    for (int c = 0; c < 8 / kC; ++c) {  // kC k-steps a commit group, inside one group
      uint32_t a_lo[kC][4], a_hi[kC][4];
#pragma unroll
      for (int h = 0; h < kC; ++h) {
        const int ks = c * kC + h;
        if (ks % 2 == 0) ldsm_x4_trans(wd, wl + ks / 2 * 32 * kPCols);
        unpack_word(wd[2 * (ks % 2)] ^ flip, a_lo[h][0], a_lo[h][1], a_hi[h][0], a_hi[h][1]);
        unpack_word(wd[2 * (ks % 2) + 1] ^ flip, a_lo[h][2], a_lo[h][3], a_hi[h][2],
                    a_hi[h][3]);
      }
      al::sm90::wgmma_fence();
#pragma unroll
      for (int h = 0; h < kC; ++h) {
        const int ks = c * kC + h;
        const int keep_d = ks % kSteps != 0 || !fresh;
        const uint64_t b = al::sm90::RowTile<kTile, kPTokens>::kmajor(xs, ks);
        al::sm90::Mma<64>::rs<0>(part_lo, a_lo[h], b, keep_d);
        al::sm90::Mma<64>::rs<0>(part_hi, a_hi[h], b, keep_d);
      }
      al::sm90::wgmma_commit();
      const int ks = c * kC + kC - 1;  // the commit group's last k-step
      if ((ks + 1) % kSteps == 0) {  // a group's last k-step (SPAN: the tile's)
        al::sm90::wgmma_wait<0>();
        al::sm90::keep(part_lo);
        al::sm90::keep(part_hi);
        if (!P::SPAN || (k0 + kTile) % group == 0) {
          const int j = P::SPAN ? 0 : ks / kSteps;  // the group's scale row in the tile
          scale_rows(acc_lo, part_lo, *reinterpret_cast<const float2*>(slo + j * kPCols));
          scale_rows(acc_hi, part_hi, *reinterpret_cast<const float2*>(shi + j * kPCols));
          if constexpr (P::KSPLIT) {
            if (++done == gpb) {  // the K block's last group
              done = 0;
#pragma unroll
              for (int i = 0; i < kTot; ++i) {
                tot_lo[i] += acc_lo[i];
                tot_hi[i] += acc_hi[i];
                acc_lo[i] = acc_hi[i] = 0.f;
              }
            }
          }
        }
      } else {
        al::sm90::wgmma_wait<1>();  // the previous commit group retired: its A registers free
      }
    }
    al::sm90::mbar_arrive(&empty[st]);
  }

  if constexpr (P::KSPLIT) {
#pragma unroll
    for (int i = 0; i < kTot; ++i) {
      acc_lo[i] = tot_lo[i];
      acc_hi[i] = tot_hi[i];
    }
  }
  // accumulator rows col, col + 1 (packed columns), columns 8 j + 2 (lane % 4)
  // + e (tokens): one bf16 pair a token and plane, rows past M not written
  const long long c = n0 + col;
  const int tok = m0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = tok + 8 * j + e;
      if (row < M) {
        __nv_bfloat16* o = out + (long long)row * ldo + c;
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc_lo[4 * j + e], acc_lo[4 * j + 2 + e]);
        *reinterpret_cast<__nv_bfloat162*>(o + hi_off) =
            __floats2bfloat162_rn(acc_hi[4 * j + e], acc_hi[4 * j + 2 + e]);
      }
    }
}

// f(Prefill<...>()) for the instance of `group` (al::group_ok) and the K-split.
template <typename F>
cudaError_t with_prefill(int group, bool ksplit, F&& f) {
  const int tg = group <= kTile ? kTile / group : 0;  // 0: a group spanning tiles
  switch ((ksplit ? 16 : 0) + tg) {
    case 0: return f(Prefill<false, 1, true>());
    case 1: return f(Prefill<false, 1, false>());
    case 2: return f(Prefill<false, 2, false>());
    case 4: return f(Prefill<false, 4, false>());
    case 8: return f(Prefill<false, 8, false>());
    case 16: return f(Prefill<true, 1, true>());
    case 17: return f(Prefill<true, 1, false>());
    case 18: return f(Prefill<true, 2, false>());
    case 20: return f(Prefill<true, 4, false>());
    case 24: return f(Prefill<true, 8, false>());
    default: return cudaErrorInvalidValue;
  }
}

template <class P>
cudaError_t launch_inst(const __nv_bfloat16* x, int M, int K, const int8_t* p, int nh,
                        const float* s, int fmt, int group, int gpb, __nv_bfloat16* out,
                        long long ldo, long long hi_off, cudaStream_t stream) {
  CUtensorMap tx, tw, ts;
  if (!al::sm90::tile_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2LL * K, 64,
                             kPTokens, true) ||
      !al::sm90::tile_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, p, nh, K, nh, kPCols, kTile,
                             true) ||
      !al::sm90::tile_map_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s, 2LL * nh, K / group,
                             8LL * nh, kPCols, P::TG, false))
    return cudaErrorInvalidValue;
  cudaError_t err = al::allow_smem(w4_wgmma_kernel<P>, P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(nh / kPCols, (M + kPTokens - 1) / kPTokens);
  w4_wgmma_kernel<P><<<grid, kPThreads, P::kSmem, stream>>>(tx, tw, ts, M, K, nh, fmt, group, gpb,
                                                             out, ldo, hi_off);
  return cudaGetLastError();
}

cudaError_t launch_prefill(const __nv_bfloat16* x, int M, int K, const int8_t* p, int nh,
                           const float* s, int fmt, int group, int gpb, __nv_bfloat16* out,
                           long long ldo, long long hi_off, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(p) |
       reinterpret_cast<uintptr_t>(s)) % 16)
    return cudaErrorInvalidValue;  // TMA
  return with_prefill(group, gpb > 0, [&](auto inst) {
    return launch_inst<decltype(inst)>(x, M, K, p, nh, s, fmt, group, gpb, out, ldo, hi_off,
                                       stream);
  });
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
    return launch_prefill(xb, M, K, p, nh, s, fmt, group, gpb, o, ldo, hi_off, st);
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

namespace al {

// The prefill kernel's instance at `group` (whole K or K-split): registers,
// local bytes, shared memory and resident blocks per SM (al_sm90_kernel_info).
cudaError_t w4_prefill_sm90_info(int group, bool ksplit, int* out) {
  if (!group_ok(group)) return cudaErrorInvalidValue;
  return with_prefill(group, ksplit, [&](auto inst) {
    using P = decltype(inst);
    return sm90::kernel_info(w4_wgmma_kernel<P>, kPThreads, P::kSmem, out);
  });
}

}  // namespace al
