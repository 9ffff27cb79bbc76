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
//    group 32: 9.8 MB, 2.9 us). On the weight-streaming core of
//    int4_common.cuh: a cluster of C blocks along K (C <= 8) owns a tile
//    of 64 packed columns, each block K / C rows streamed through a
//    4-stage cp.async ring in shared memory; its warps turn the nibbles
//    into bf16 in registers and run mma.sync (x as B, 8 tokens an n-tile,
//    every weight byte read once whatever M); the blocks' f32 partials meet
//    through distributed shared memory in rank order. No workspace, no
//    counter. ops/int4_matmul.py::decode_plan picks C: the largest
//    cluster, as the card's sweeps ranked it (PERF.md, the int4 decode
//    products).
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
// the decode shape every block's rows lie inside one K block (bk a multiple
// of K / C), and the cluster adds the blocks' partials in order inside each
// K block, then the K blocks in order (a K block that no C <= 8 divides into
// whole 64-row stages falls back to the prefill kernel); in the prefill
// shape (KSPLIT) the register accumulators hold the K block's sum, added at
// the block's last group to the running sum of the blocks, also in
// registers, with no workspace.
#include "int4_common.cuh"
#include "sm90.cuh"

namespace {

using al::kTile;
using al::unpack_word;

// --- the decode shape (M <= 64) on the weight-streaming core ------------------

// grid (nh / kTW) x C blocks in clusters of C along K (blockIdx.x = tile * C
// + rank); the block partials are summed in rank order inside K blocks of
// bk rows (bk = K: one block).
template <int NT>
__global__ void __launch_bounds__(al::w4::kThreads)
    w4_decode_kernel(const __nv_bfloat16* __restrict__ x, int M, int K,
                     const int8_t* __restrict__ p, int nh, const float* __restrict__ s, int fmt,
                     int group, int bk, __nv_bfloat16* __restrict__ out, long long ldo,
                     long long hi_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x / (int)al::w4::cg::this_cluster().num_blocks();
  constexpr int tw = al::w4::kTW;
  const al::w4::Product P{x, K, p, s, nh, group, fmt};
  const al::w4::Unit u{0, K, bk};
  al::w4::run_unit<NT>(P, M, tile, u, smem, [](int, int) {},
                       [&](int tok, int c, float lo, float hi) {
                         const long long at = (long long)tok * ldo + tile * tw + c;
                         out[at] = __float2bfloat16(lo);
                         out[hi_off + at] = __float2bfloat16(hi);
                       });
}

template <int NT>
struct Decode {
  static cudaError_t run(const __nv_bfloat16* x, int M, int K, const int8_t* p, int nh,
                         const float* s, int fmt, int group, int C, int bk,
                         __nv_bfloat16* out, long long ldo, long long hi_off,
                         cudaStream_t stream) {
    if (nh % al::w4::kTW) return cudaErrorInvalidValue;
    return al::w4::launch_clustered(w4_decode_kernel<NT>, nh / al::w4::kTW * C, C,
                                    al::w4::unit_smem<NT>(K / C, group), stream, x, M, K, p, nh,
                                    s, fmt, group, bk, out, ldo, hi_off);
  }
};

// The instance's info at the shared memory of a block over kn rows.
template <int NT>
struct DecodeInfo {
  static cudaError_t run(int kn, int group, int* out) {
    return al::sm90::kernel_info(w4_decode_kernel<NT>, al::w4::kThreads,
                                 al::w4::unit_smem<NT>(kn, group), out);
  }
};

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

}  // namespace

// x [M, K] bf16 row-major; packed: the layer's [K, nh] int8 slab; scales:
// the layer's [K/group, 2*nh] f32; out bf16: low-nibble column j of row m at
// out[m*ldo + j], high-nibble column j at out[hi_off + m*ldo + j].
// M <= 64 with C > 0 takes the decode shape: clusters of C blocks over
// tiles of 64 packed columns, each block K / C rows (whole 64-row stages
// and groups), their partials summed in rank order inside K blocks of bk
// rows (bk = K for the whole-K call, the K-split's block otherwise;
// ops/int4_matmul.py::decode_plan picks C). M > 64, or C
// 0 (a K-split whose blocks the decode shape cannot take), takes the
// prefill shape; gpb > 0 (groups per K block, dividing K / group) makes it the
// K-split kernel, 0 the whole-K one. Requires al::group_ok(group),
// K % group == 0, K % 128 == 0, nh % 128 == 0, 16-byte aligned x, packed
// and scales (checked by the wrapper).
AL_EXPORT int al_int4_matmul(const void* x, int M, int K, const void* packed, int nh,
                             const void* scales, int fmt, void* out, long long ldo,
                             long long hi_off, int C, int bk, int gpb, int group,
                             void* stream) {
  if (M == 0) return cudaSuccess;
  if (!al::group_ok(group) || K % group || K % kTile || nh % kPCols)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* p = static_cast<const int8_t*>(packed);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (M > 64 || C == 0) {
    if (gpb > 0 && (K / group) % gpb) return cudaErrorInvalidValue;
    return launch_prefill(xb, M, K, p, nh, s, fmt, group, gpb, o, ldo, hi_off, st);
  }
  if (!al::w4::unit_ok(al::w4::Unit{0, K, bk}, C, group)) return cudaErrorInvalidValue;
  return al::w4::with_instance<Decode>(M, xb, M, K, p, nh, s, fmt, group, C, bk, o, ldo,
                                       hi_off, st);
}

// The unstacked W4A16, replacing audio_llama_tpu/ops/int4_matmul.py::_kernel
// (int4_matmul): x [M, K] bf16 @ dequant(packed [K, N/2], scales [K/group, N])
// -> out [M, N] bf16 with f32 accumulation, the TPU kernel's lo and hi planes
// written side by side as one row (its [2, M, N/2] output concatenated). The
// same device code as the stacked launch with the layer's slab the whole
// weight: the decode shape up to 64 rows (whole K: bk = K), the prefill
// shape past them, whole K.
AL_EXPORT int al_int4_matmul_2d(const void* x, int M, int K, const void* packed, int nh,
                                const void* scales, int fmt, void* out, int C, int group,
                                void* stream) {
  return al_int4_matmul(x, M, K, packed, nh, scales, fmt, out, 2LL * nh, nh, C, K, 0, group,
                        stream);
}

// The decode kernel's instance for M rows with blocks of kn rows at the
// scale group: registers, local bytes, the dynamic shared memory its launch
// asks for and resident blocks per SM.
AL_EXPORT int al_int4_decode_info(int M, int kn, int group, void* out) {
  return al::w4::with_instance<DecodeInfo>(M, kn, group, static_cast<int*>(out));
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
