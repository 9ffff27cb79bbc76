// Shared pieces of the int4 weight kernels (int4_matmul.cu, mlp_int4.cu,
// decode_megakernel.cu).
//
// Pack format (audio_llama_tpu_torch/ops/int4_matmul.py): a weight w [K, N]
// is stored as packed [K, N/2] int8, byte j of a row holding output column j
// in its low nibble and column j + N/2 in its high nibble, with f32 scales
// [K/group, N], one per group of `group` contraction rows and output column.
// Low nibble: `pair` stores the signed value, `obin` the value + 8. High
// nibble: signed in both, read as (sign-extended byte) >> 4.
//
// The group is a run-time argument of these kernels (the JAX package's
// kernels take it too): a multiple of 16 that divides 128 or is a multiple of
// 128 (`group_ok`), so 32, 64, 128 and 256. The decode megakernel keeps 128
// (its gate refuses other groups, as JAX's does).
//
// The weight-streaming core (namespace w4) is the device side of both decode
// products, the W4A16 at M <= 64 rows (int4_matmul.cu) and the fused MLP
// (mlp_int4.cu). A block of four warps owns a tile of kTW = 64 packed
// columns (64 bytes of every row) and kn rows of K; the blocks of a
// thread-block cluster (up to 8, along K) take consecutive row ranges. The
// block streams its rows through shared memory: a ring of kStages stages
// of 64 rows x 64 bytes, each filled by cp.async (16 bytes a thread, whole
// lines, kStages - 1 stages in flight; 16-byte chunks swizzled by row so
// the eight rows of an ldmatrix tile hit distinct banks), beside its x rows
// and its groups' scales, copied the same way once. Warp w computes its 16
// packed columns as out^T = W^T x^T on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 out): the weight is A (16 output columns x 16 k), the rows
// of x are B (8 tokens an n-tile, NT n-tiles). One ldmatrix.x4.trans of the
// stage gives a lane the bytes of its two packed columns at two rows, four
// times (two k-steps), as the W4A16 prefill takes them; the exponent-bias
// trick turns two nibbles into an exact bf16 pair with one lop3 (which also
// flips the format's sign bits) and one fma.bf16x2, with no conversion
// instruction; one ldmatrix.x4 of x gives the B fragments of two k-steps.
// Per scale group the mma sums (exact products of bf16 and small integers,
// f32 sums) start afresh; at the group's last k-step the f32 partial times
// the group's f32 scale is added to the f32 accumulator. Every weight byte
// is read from device memory once a call, whatever M. The blocks' f32
// partials meet in shared memory and are added in rank order through
// distributed shared memory (`unit_sum`: in order inside each K block of bk
// rows, then the K blocks in order), each block of the cluster a share of
// the outputs, so two launches give the same bits.
//
// The ring is fed by cp.async rather than TMA: a stage is 4 KB, two 16-byte
// copies a thread, so issuing it costs the block almost nothing, and the
// time follows a block's chain (the first stage's round trip, a few
// dozen dependent k-steps, the cluster sum), which a TMA feed does not
// shorten. A variant fed by TMA (a 2-D map of the packed bytes, 64 x 64
// boxes with the 64B swizzle this ring's `swizzle` matches, one mbarrier a
// stage) was timed against this one on an H100 (scripts/int4_group_timing.py,
// PERF.md's int4 decode finding): the fused MLP 4-5% faster at group 128,
// the W4A16 products at K 3072 1-7% slower; not kept, as one feed keeps
// one code path.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace al {
constexpr int kTile = 128;  // contraction rows a tile: a multiple of every group <= 128

__host__ __device__ __forceinline__ bool group_ok(int group) {
  return group > 0 && group % 16 == 0 && (kTile % group == 0 || group % kTile == 0);
}
constexpr int kFmtPair = 0;
constexpr int kFmtObin = 1;

__device__ __forceinline__ int nib_lo(int v, int fmt) {
  return fmt == kFmtObin ? (v & 0xF) - 8 : (v << 28) >> 28;
}
__device__ __forceinline__ int nib_hi(int v) { return v >> 4; }

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

// A word whose bytes 0, 2 hold packed column c at rows k, k + 1 and bytes 1,
// 3 column c + 1 (offset-binary nibbles) -> the bf16 pairs of those rows for
// the low-nibble product (lo0: column c, lo1: column c + 1) and the
// high-nibble one.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t& lo0, uint32_t& lo1,
                                            uint32_t& hi0, uint32_t& hi1) {
  lo0 = nibble_pair(w);
  lo1 = nibble_pair(w >> 8);
  hi0 = nibble_pair(w >> 4);
  hi1 = nibble_pair(w >> 12);
}

// unpack_word on a word whose nibbles are not yet offset-binary: the sign
// flip that makes them so (the format's) is folded into the lop3 that masks
// them. clo / chi: 0x43004300 with the flip bit (0x00080008) of the low /
// high nibbles of a byte (`nibble_magic`).
__device__ __forceinline__ uint32_t nibble_pair_flip(uint32_t w, uint32_t c) {
  uint32_t m, r;
  // m = ((w ^ c) & 0x000F000F) | (c & ~0x000F000F): lop3 (a, b, c) -> b ? a ^ c : c
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(m) : "r"(w), "r"(0x000F000Fu), "r"(c));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(m), "r"(0x3F803F80u), "r"(0xC308C308u));
  return r;
}

__device__ __forceinline__ void unpack_word_flip(uint32_t w, uint32_t clo, uint32_t chi,
                                                 uint32_t& lo0, uint32_t& lo1, uint32_t& hi0,
                                                 uint32_t& hi1) {
  lo0 = nibble_pair_flip(w, clo);
  lo1 = nibble_pair_flip(w >> 8, clo);
  hi0 = nibble_pair_flip(w >> 4, chi);
  hi1 = nibble_pair_flip(w >> 12, chi);
}

// nibble_pair_flip's constants of a format: pair flips both nibbles of a
// byte, obin the high one.
__host__ __device__ __forceinline__ uint32_t nibble_magic(int fmt, bool high) {
  return fmt == kFmtObin && !high ? 0x43004300u : 0x43084308u;
}

namespace w4 {

namespace cg = cooperative_groups;

constexpr int kRows = 64;      // rows a stage: four 16-row k-steps
constexpr int kStages = 4;     // the ring (kStages - 1 stages in flight)
constexpr int kCW = 16;        // packed columns a warp: one mma tile
constexpr int kWarps = 4;      // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTW = kCW * kWarps;  // packed columns a tile: bytes of a stage row
constexpr int kMaxCluster = 8;

// The stage's 16-byte chunk j of row r (four a row) lies at chunk
// j ^ swizzle(r): the eight rows of an ldmatrix tile (one chunk each) fall
// on eight distinct 16-byte bank groups.
__host__ __device__ __forceinline__ int swizzle(int r) { return (r >> 1) & 3; }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// d (+)= a b: m16n8k16, bf16 A (row) and B (col), f32 C and D; `fresh`
// starts from zero.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2],
                                    bool fresh) {
  if (fresh) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f), "f"(0.f),
          "f"(0.f), "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

// 16 bytes from global to shared memory, asynchronously, past L1 (zeros
// where !valid).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One unit: the cluster's C blocks take kn = K / C consecutive rows each
// from k0; their partials are added in rank order inside each K block of
// bk rows (whole block ranges; bk = K: one), then the K blocks in order.
struct Unit {
  int k0, K, bk;
};

// One product: x [M, ldx] bf16 (rows past M read as zero) times the
// layer's packed [K_total, nh] bytes and scales [K_total / group, 2 nh].
struct Product {
  const __nv_bfloat16* x;
  long long ldx;
  const int8_t* p;
  const float* s;
  int nh, group, fmt;
};

template <int NT>
struct Shape {
  static constexpr int TOK = 8 * NT;  // tokens (M rounded up to the n-tiles)
};

// x's row stride in shared memory (bf16): a block's kn rows rounded up to 64
// plus 8, so the eight token rows of an ldmatrix tile start 16 bytes apart
// modulo 128 and hit distinct bank groups.
__host__ __device__ __forceinline__ int xs_stride(int kn) { return (kn + 63) / 64 * 64 + 8; }

// Dynamic shared memory of a block over kn rows: the ring [kStages, kRows,
// kTW] bytes, x [TOK, xs_stride(kn)] bf16 and the scales [kn / group, 2,
// kTW] f32 while the rows stream; then the block's sums [2, TOK, kTW] f32
// over the same bytes. The launch plans' feasibility check
// (ops/int4_matmul.py::unit_smem) repeats this sum; the card tests compare
// the two through the kernels' info entries.
template <int NT>
__host__ __device__ __forceinline__ size_t unit_smem(int kn, int group) {
  const size_t stream = kStages * kRows * kTW + (size_t)Shape<NT>::TOK * xs_stride(kn) * 2 +
                        (size_t)(kn / group) * 2 * kTW * 4;
  const size_t red = 2 * (size_t)Shape<NT>::TOK * kTW * 4;
  return stream > red ? stream : red;
}

// Two k-steps of the block's rows, i and i + 1 (32 rows): the mma of the
// lane's A words a (ldmatrix.trans of the warp's 16 packed columns: rows
// 2t, 2t + 1 of each 8-row tile, columns 2g, 2g + 1; tiles 0, 1 are k-step
// i, tiles 2, 3 k-step i + 1) with the x words xb (ldmatrix of 8 tokens x
// 32 k an n-tile) into part, and at a group's last k-step part x its scales
// into acc. ss: the block's first group's scales at the lane's columns, in
// rows of two planes of tw floats; gk: the group's k-steps.
template <int NT>
__device__ __forceinline__ void ksteps(float (&acc)[2][NT][4], float (&part)[2][NT][4],
                                       const uint32_t (&a)[4], const uint32_t (&xb)[NT][4],
                                       int i, const float* ss, int tw, int gk, uint32_t clo,
                                       uint32_t chi) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = i + h;
    const bool fresh = k % gk == 0, last = (k + 1) % gk == 0;
    uint32_t lo[4], hi[4];
    unpack_word_flip(a[2 * h], clo, chi, lo[0], lo[1], hi[0], hi[1]);
    unpack_word_flip(a[2 * h + 1], clo, chi, lo[2], lo[3], hi[2], hi[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t b[2] = {xb[j][2 * h], xb[j][2 * h + 1]};
      mma(part[0][j], lo, b, fresh);
      mma(part[1][j], hi, b, fresh);
    }
    if (last) {
      const float* sg = ss + (k / gk) * 2 * tw;
      const float2 slo = *reinterpret_cast<const float2*>(sg);
      const float2 shi = *reinterpret_cast<const float2*>(sg + tw);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][j][e] = fmaf(part[0][j][e], e < 2 ? slo.x : slo.y, acc[0][j][e]);
          acc[1][j][e] = fmaf(part[1][j][e], e < 2 ? shi.x : shi.y, acc[1][j][e]);
        }
    }
  }
}

// The unit's sum of the cluster's block partials at one output (plane pl,
// token, column c of the tile), in rank order inside each K block, then the
// K blocks in order. Every partial is loaded before the first add, so the
// distributed shared memory reads overlap.
template <int NT>
__device__ __forceinline__ float unit_sum(cg::cluster_group& cluster, float* red, int tw, int kn,
                                          const Unit& u, int pl, int tok, int c) {
  const int off = (pl * Shape<NT>::TOK + tok) * tw + c;
  const int C = (int)cluster.num_blocks();
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    v[q] = q < C ? cluster.map_shared_rank(red, q)[off] : 0.f;
  float tot = 0.f, blk = 0.f;
  int cur = 0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < C) {
      const int b = q * kn / u.bk;
      if (b != cur) {
        tot += blk;
        blk = 0.f;
        cur = b;
      }
      blk += v[q];
    }
  return tot + blk;
}

// One unit on the calling cluster: every block runs this with the same
// arguments; `tile` is the block's column tile (kTW packed columns).
// `wait(kb, kn)` (the block's first row and its row count) runs after the
// first stages are in flight and before the block copies its x rows (the
// MLP's down product waits there for its activations); `epi(tok, c, lo,
// hi)` gets the unit's f32 sums of both planes at packed column
// tile * kTW + c for the block's share of the (token < M, column) pairs.
// Ends with the cluster synchronized.
template <int NT, class Wait, class Epi>
__device__ __forceinline__ void run_unit(const Product& P, int M, int tile, const Unit& u,
                                         unsigned char* smem, Wait&& wait, Epi&& epi) {
  constexpr int TOK = Shape<NT>::TOK;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int tw = kTW, nch = kTW / 16;  // a stage row's bytes and 16-byte chunks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int col0 = tile * tw;
  const int kn = u.K / C;     // the block's rows
  const int kb = u.k0 + rank * kn;
  const int ns = kn / kRows;  // its stages
  unsigned char* ring = smem;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ring + kStages * kRows * tw);
  const int xstride = xs_stride(kn);
  float* ss = reinterpret_cast<float*>(xs + TOK * xstride);

  // stage st's rows into ring slot st % kStages (one commit group a stage,
  // empty past the last)
  auto issue = [&](int st) {
    if (st < ns) {
      unsigned char* slot = ring + (st % kStages) * kRows * tw;
      const int8_t* src = P.p + (long long)(kb + st * kRows) * P.nh + col0;
      for (int i = tid; i < kRows * nch; i += kThreads) {
        const int r = i / nch, j = i % nch;
        cp_async16(slot + r * tw + ((j ^ swizzle(r)) << 4),
                   src + (long long)r * P.nh + 16 * j, true);
      }
    }
    cp_async_commit();
  };
  // commit order: stage 0, x and the scales, stages 1 .. kStages - 2; then
  // one stage an iteration, so stage st has landed once at most kStages - 2
  // groups are in flight
  issue(0);
  wait(kb, kn);
  // the block's x rows (tokens past M as zero) and its groups' scales at
  // the tile's columns: one group
  const int xv = kn / 8;
  for (int i = tid; i < TOK * xv; i += kThreads) {
    const int tok = i / xv, k = (i % xv) * 8;
    cp_async16(xs + tok * xstride + k, P.x + (tok < M ? tok : 0) * P.ldx + kb + k, tok < M);
  }
  const int ng = kn / P.group, sv = tw / 4;
  for (int i = tid; i < ng * 2 * sv; i += kThreads) {
    const int r = i / (2 * sv), pl = (i / sv) % 2, c = (i % sv) * 4;
    cp_async16(ss + (r * 2 + pl) * tw + c,
               P.s + (long long)(kb / P.group + r) * 2 * P.nh + pl * P.nh + col0 + c, true);
  }
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) issue(s);

  float acc[2][NT][4], part[2][NT][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = part[a][j][e] = 0.f;
  const float* sl = ss + warp * kCW + 2 * g;
  const uint32_t clo = nibble_magic(P.fmt, false), chi = nibble_magic(P.fmt, true);
  // ldmatrix rows: A, lane l row l of each 32-row half of a stage at the
  // warp's chunk; x, lane l token l % 8 at k 8 (l / 8) of the 32
  const __nv_bfloat16* xrow = xs + (lane & 7) * xstride + 8 * (lane >> 3);
  for (int st = 0; st < ns; ++st) {
    // stage st (and x and the scales) have landed; every warp is done with
    // stage st - 1, whose slot the next issue refills
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(st + kStages - 1);
    const unsigned char* slot = ring + (st % kStages) * kRows * tw;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 32 * half + lane;
      uint32_t a[4], xb[NT][4];
      ldsm_x4_trans(a, slot + row * tw + ((warp ^ swizzle(row)) << 4));
#pragma unroll
      for (int j = 0; j < NT; ++j)
        ldsm_x4(xb[j], xrow + 8 * j * xstride + st * kRows + 32 * half);
      ksteps<NT>(acc, part, a, xb, st * (kRows / 16) + 2 * half, sl, tw, P.group / 16, clo, chi);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring, x and the scales are done with: their bytes take the sums

  float* red = reinterpret_cast<float*>(smem);  // [2, TOK, tw]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * t + (e & 1), c = warp * kCW + 2 * g + (e >> 1);
        red[(a * TOK + tok) * tw + c] = acc[a][j][e];
      }
  cluster.sync();
  // the block's share of the (token, column) outputs, each plane on its own
  // lane (even: low, odd: high), the pair joined by a shuffle
  const int items = M * tw, per = 2 * ((items + C - 1) / C);
  const int end = min(2 * items, rank * per + per);
  for (int base = rank * per; base < end; base += kThreads) {
    const int it = base + tid, tok = (it >> 1) / tw, c = (it >> 1) % tw;
    const float v = it < end ? unit_sum<NT>(cluster, red, tw, kn, u, it & 1, tok, c) : 0.f;
    const float hi = __shfl_xor_sync(0xffffffffu, v, 1);
    if (it < end && !(it & 1)) epi(tok, c, v, hi);
  }
  cluster.sync();  // no block leaves while another reads its sums
}

// f(NT) for the instance of M <= 64 rows: the n-tiles of 8 tokens.
template <template <int> class Fn, class... A>
cudaError_t with_instance(int M, A&&... a) {
  if (M <= 8) return Fn<1>::run(a...);
  if (M <= 16) return Fn<2>::run(a...);
  if (M <= 32) return Fn<4>::run(a...);
  if (M <= 64) return Fn<8>::run(a...);
  return cudaErrorInvalidValue;
}

// Launch `kernel` on grid blocks of kThreads in clusters of C (along x).
template <class K, class... A>
cudaError_t launch_clustered(K kernel, int grid, int C, size_t smem, cudaStream_t stream,
                             A... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether a unit shape is one the kernels take: C in range, blocks of whole
// 64-row stages and whole groups inside one K block.
__host__ __forceinline__ bool unit_ok(const Unit& u, int C, int group) {
  if (C < 1 || C > kMaxCluster || u.K % C || u.bk <= 0 || u.K % u.bk) return false;
  const int kn = u.K / C;
  return kn % kRows == 0 && kn % group == 0 && u.bk % kn == 0;
}

}  // namespace w4
}  // namespace al
