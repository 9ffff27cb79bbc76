// The timeline decode core: single-token decode attention over one (batch
// row, KV head) slab of the KV-cache timeline, split along the timeline over
// a thread-block cluster, appending the fresh row in place. Its one kernel,
// db_kernel (below), has four output modes (`Mode`), each compiled in a unit
// of its own so the units build in parallel:
//   kStats  the db kernels' stats mode (rows 13-15; decode_attention_db.cu);
//   kNorm   their normalized mode on bf16/f32, int8 and int4 caches (rows
//           16-18), which the single-buffered decode attention's entry
//           shares (rows 29, 30; decode_attention_norm.cu);
//   kMono   the bf16 main path's decode attention (row 4,
//           decode_attention.cu): the stats mode's p, divided after P V,
//           with a per-row offset on the device;
//   kChunk  the timeline-chunked packed kernel (row 19,
//           decode_attention_packed.cu): the TPU kernel's online softmax
//           over chunks of the timeline, each block a whole number of
//           chunks.
// Their notes say which TPU kernels they replace.
//
// Bound on the H100: bytes. A call reads the slab's K and V rows once (at B
// 1, 3040 slots, 8 KV heads, hd 128 bf16: 12.4 MB, 3.7 us at 3.35 TB/s).
// A block per (batch row, KV head), as the first versions had, put 8 blocks
// on 132 SMs at B 1 and ran at 16-64x that bound. Here each (batch row, KV
// head) is a cluster of C blocks (ops/decode_timeline.py::timeline_plan
// picks C, bringing B * Hkv * C near 132, and the ring): block rank r takes
// the slots of 32-slot groups [r ng / C, (r + 1) ng / C) of the ng = S / 32,
// in timeline order, and serves all G query heads of the KV head, so each
// row is read once. One thread streams the block's K rows, then its V rows,
// in ~32 KB stages (`stage_rows`) through a ring of `stages` shared-memory
// slots with cp.async.bulk (contiguous rows need no tensor map) behind one
// mbarrier a slot; the valid flags and the int8 / int4 scales of the range
// land once, first. 256 threads a block. The logits of a bf16 q go on the
// tensor cores (mma.sync m16n8k16: a warp's 16 rows as A, q^T as B, the G <=
// 8 heads its columns; int8 / int4 keys made exact bf16 pairs in
// registers), of an f32 q and of the chunk mode on CUDA cores (a row's 16-byte chunks over up to
// 8 lanes, q in registers, folded by shuffles). P V is on CUDA cores: each
// thread a 16-byte column of every (256 / chunks)-th row of a stage, folded
// by shuffles and then over warps.
//
// What sets the pace (scripts/decode_attention_timing.py --sweep, PERF.md):
// at B 1 and 3040 slots most of a call goes to what every call pays (the
// clustered launch, the first stage's landing, three cluster exchanges, the
// output), the rest to the stages' loads and P V. Clusters of 16 (past the
// portable 8), deeper rings and 16 KB stages were timed and were not faster.
//
// The softmax keeps the TPU kernels' arithmetic, across the cluster:
//   1. logits = (q . k) * scale (int8/int4: * k_scale * scale), -1e30 on
//      an invalid slot; the cluster max M is the max of the blocks' maxes
//      (stats and mono modes: max(M, -5e29));
//   2. p = exp(logit - M) (stats and mono modes: 0 on an invalid slot); the
//      cluster sum l is the blocks' sums added in rank order;
//   3. normalized: p / l, then (int8/int4) * v_scale, rounded to the
//      compute dtype; stats and mono: p (* v_scale) rounded, not divided;
//   4. the blocks' f32 P V partials added in rank order; rank r writes
//      outputs [r G hd / C, (r + 1) G hd / C): the normalized output in q's
//      dtype, acc / l in q's dtype (mono: 0 where l = 0), or acc (f32) and,
//      on rank 0, m = M and l (stats).
// The mono mode is the contract of decode_attention_plain (-inf on a masked
// slot, the row max, or 0 when every slot is masked): with one valid slot
// its logit is far above -5e29, so M is the plain version's max and every
// valid p is the same; masked slots give p = 0 on both sides; a fully masked
// slab gives l = 0 and the output 0 on both sides.
//
// The chunk mode keeps the packed TPU kernel's recurrence over the chunks of
// CH = `unit` slots in timeline order (m starts at -1e30):
//   m_c = max(m_{c-1}, the chunk's max), alpha_c = exp(m_{c-1} - m_c);
//   p = valid ? exp(round_cdt(logit - m_c)) rounded to cdt : 0 (cdt: q's
//   dtype); l = alpha_c l + sum p; acc = alpha_c acc + sum p' V with p' = p,
//   or round_cdt(p * v_scale) quantized; out = acc / l in q's dtype.
// A block's range is a whole number of chunks. The K pass gives the block
// its chunks' maxima; the max exchange gives it M_pre, the max over the
// ranks before it (-1e30 on rank 0), which is m_{c-1} at its first chunk
// exactly (a max has no rounding). The block walks its chunks from M_pre:
// each chunk's running max m_c and alpha_c, then w_c, the product of the
// alphas of its later chunks, and A_r, the product of all of them. p is
// rounded against m_c as on the TPU; the V pass takes w_c p' and the
// block's sum is that of w_c p, so the block's (l_r, acc_r) are the chain
// over its chunks from zero. The sum exchange carries l_r and A_r, and the
// merge chains the ranks in order: l <- A_r l + l_r, acc <- A_r acc + acc_r.
// The result differs from the chain chunk by chunk only in the order of the
// f32 sums and products.
// The exchanges go through distributed shared memory: each block writes its
// values into the inboxes of the blocks that need them, one cluster barrier,
// then each reads its own inbox (three barriers a call). The flash-decoding
// merge (each block's own max, rescaled later) would round p at another
// place: a different function, not used. Sums run in a fixed order, so two
// calls on the same inputs give the same bits. The logits' f32 sums are not
// the plain version's (mma.sync accumulates in its own order): a logit an
// ulp away flips p's rounding to bf16, which the plain version itself shows
// with correctly rounded logits (decode_attention_timing.py --order).
//
// The fresh row: every read of slot `off` takes the fresh row (and its
// scales) from the arguments, never the cache. The block whose range holds
// `off` writes the row into the cache after its last load has landed; no
// block reads that slot from device memory afterwards, so no generic write
// meets an async-proxy read of one address in a call. An offset outside [0,
// S) writes nothing. Scale slabs are never written.
#pragma once

#include <cooperative_groups.h>

#include "decode_rows.cuh"
#include "sm90.cuh"

namespace al {
namespace tl {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;       // slots of a range's unit
constexpr int kStageBytes = 32 * 1024;  // a ring stage's target size
constexpr int kMaxStages = 12;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kMaxG = 8;
constexpr int kHead = 1024;      // barriers, the reduction scratch, the exchange inboxes
constexpr size_t kSmemMax = 227 * 1024;
constexpr float kDead = -1e30f;  // an invalid slot's logit
constexpr float kFloor = -5e29f; // the stats and mono modes' clamp of the max
static_assert(512 + 2 * kMaxCluster * kMaxG * 4 <= kHead, "the exchange inboxes fit the head");

// The output modes (module note).
enum Mode { kStats = 0, kNorm = 1, kMono = 2, kChunk = 3 };

// Blocks an SM holds at once, by register budget: two (128 registers a
// thread) up to G 4, so clusters of a B 4 launch pack their GPCs; one past
// that (q and the P V sums of G 6 and 8 heads take more registers).
constexpr int min_blocks(int G) { return G <= 4 ? 2 : 1; }

struct Params {
  const void* q;                  // [B, Hq, hd] in T
  const void* k_new;              // [B, Hkv, hd] fresh rows (int4: the combined row)
  const void* v_new;
  const float* ks_new;            // [B, Hkv] fresh rows' scales (int8 / int4)
  const float* vs_new;
  void* ck;                       // [L, B, Hkv, S, hd] (int4: ck == cv)
  void* cv;
  const float* ks;                // [Ls, B, Hkv, S] scales, layer scale_layer
  const float* vs;
  const int* valid;               // [B, S]
  const int* off_dev;             // the offset on the device, or null: `off`
  int off_stride;                 // row b's offset is off_dev[b * off_stride]
  int layer, scale_layer, off, B, Hkv, S, hd, stages;
  int unit;                       // slots of a range's unit: kGroup, or the chunk
  int skip_rank;                  // chunk mode, a planted fault: the later ranks'
                                  // M_pre leaves this rank out (-1: none)
  float scale;
  float* m_out;                   // stats: [B, Hq] f32
  float* l_out;
  void* out;                      // normalized: [B, Hq, hd] in T; stats: acc f32
};

// Rows of a ring stage: kStageBytes of rows, 32 to 256 of them, a multiple
// of 32 (ops/decode_timeline.py::stage_rows is the planner's copy). A
// stage's rows are one bulk copy and one barrier wait of the block's
// threads; the time a stage costs is mostly that chain, not its rows.
__host__ __device__ __forceinline__ int stage_rows(int row_bytes) {
  const int rows = kStageBytes / row_bytes / kGroup * kGroup;
  return rows < kGroup ? kGroup : rows > 256 ? 256 : rows;
}

// Byte offsets of a block's dynamic shared memory over at most n slots and
// nch chunks (the chunk mode, else 0): the chunk mode's region holds the
// blocks' A_r inbox and each head's chunk maxima and weights
// (ops/decode_timeline.py::block_smem is the planner's copy of `total`).
struct Layout {
  size_t ring, qs, lg, vld, ks, vs, ch, total;
};

__host__ __device__ __forceinline__ Layout layout(int row_bytes, bool quant, int G, int hd, int n,
                                                  int stages, int nch) {
  const size_t ring = (size_t)stages * stage_rows(row_bytes) * row_bytes;
  const size_t part = (size_t)kWarps * G * hd * 4;  // the warps' P V partials, later
  Layout L;
  L.ring = kHead;
  L.qs = L.ring + (ring > part ? ring : part);
  L.lg = L.qs + ((size_t)G * hd + kMaxCluster) * 4;  // q, later the partials' inbox
  L.vld = L.lg + (size_t)G * n * 4;
  L.ks = L.vld + (size_t)n * 4;
  L.vs = L.ks + (quant ? (size_t)n * 4 : 0);
  L.ch = L.vs + (quant ? (size_t)n * 4 : 0);
  L.total = L.ch + (nch ? ((size_t)kMaxCluster * kMaxG + 2 * (size_t)G * nch) * 4 : 0);
  return L;
}

// The most slots a block of C takes, in units of `unit` slots.
__host__ __device__ __forceinline__ int range_slots(int S, int C, int unit) {
  return (S / unit + C - 1) / C * unit;
}

__host__ __forceinline__ bool plan_ok(int S, int C, int stages, int unit) {
  return S > 0 && unit >= kGroup && unit % kGroup == 0 && S % unit == 0 && C >= 1 &&
         C <= kMaxCluster && C <= S / unit && stages >= 2 && stages <= kMaxStages;
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned; completes a transaction on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(sm90::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

// Wait for the phase of parity `parity` of `bar`; a wait that outlasts
// seconds (a load that never lands) traps rather than hang the card.
__device__ __forceinline__ void wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// d += a b: mma.sync m16n8k16, bf16 A (row) and B (col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, lo in the low half (exact for bf16 values and
// small integers).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The K values of cache bytes 0, 1 (lo) and 2, 3 (hi) of w as bf16 pairs:
// int8 signed; int4 the low nibble offset-binary (value + 8), through the
// exponent-bias trick (0x4300 | u is 128 + u; minus 136 is u - 8, exact).
template <int F>
__device__ __forceinline__ void key_pairs(uint32_t w, uint32_t& lo, uint32_t& hi) {
  if constexpr (F == kInt8) {
    lo = bf16_pair((float)(int)(int8_t)(w & 0xFF), (float)(int)(int8_t)((w >> 8) & 0xFF));
    hi = bf16_pair((float)(int)(int8_t)((w >> 16) & 0xFF), (float)(int)(int8_t)(w >> 24));
  } else {
    auto nib = [](uint32_t x) {
      uint32_t r;
      asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
          : "=r"(r)
          : "r"((x & 0x000F000Fu) | 0x43004300u), "r"(0x3F803F80u), "r"(0xC308C308u));
      return r;
    };
    lo = nib(__byte_perm(w, 0, 0x4140));  // bytes 0, 1 at bits 0 and 16
    hi = nib(__byte_perm(w, 0, 0x4342));
  }
}

// The attention of one block of the calling cluster (module note). T: q's
// dtype and the compute dtype; F: the cache format; M: the output mode.
template <typename T, int F, int G, int M>
__device__ __forceinline__ void attend(const Params& p) {
  using E = typename CacheElem<T, F>::type;
  constexpr int N = Vec16<E>::N;
  constexpr bool kQuant = F != kCacheT;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.y, b = bh / p.Hkv, kvh = bh % p.Hkv;
  const int hd = p.hd, nvec = hd / N, row_bytes = hd * (int)sizeof(E);
  const int unit = p.unit, ng = p.S / unit, R = p.stages, SR = stage_rows(row_bytes);
  const int g0 = rank * ng / C, start = g0 * unit;
  const int n = ((rank + 1) * ng / C - g0) * unit, nmax = range_slots(p.S, C, unit);
  const int ns = (n + SR - 1) / SR;  // stages a pass
  const int nch = M == kChunk ? nmax / unit : 0, nc = M == kChunk ? n / unit : 0;
  const Layout lay = layout(row_bytes, kQuant, G, hd, nmax, R, nch);

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // [R] ring slots, then the range's flags
  uint64_t* meta = full + kMaxStages;
  float* red = reinterpret_cast<float*>(smem + 128);   // [kWarps][kMaxG]
  float* Mg = red + kWarps * kMaxG;                     // [G] the cluster max
  float* Lg = Mg + kMaxG;                               // [G] the cluster sum
  float* Ag = Lg + kMaxG;                               // chunk mode: [G] the block's A_r
  float* in_max = reinterpret_cast<float*>(smem + 512);  // [rank][kMaxG] the blocks' maxes
  float* in_sum = in_max + kMaxCluster * kMaxG;          // [rank][kMaxG] the blocks' sums
  unsigned char* ring = smem + lay.ring;
  float* qs = reinterpret_cast<float*>(smem + lay.qs);  // q, later [rank][share] partials
  float* lg = reinterpret_cast<float*>(smem + lay.lg);  // [G][nmax] logits, then p
  int* vld = reinterpret_cast<int*>(smem + lay.vld);
  float* kss = reinterpret_cast<float*>(smem + lay.ks);
  float* vss = reinterpret_cast<float*>(smem + lay.vs);
  float* in_a = reinterpret_cast<float*>(smem + lay.ch);  // chunk mode: [rank][kMaxG] A_r
  float* cm = in_a + kMaxCluster * kMaxG;  // [G][nch] the chunks' maxima, then m_c
  float* cw = cm + G * nch;                // [G][nch] alpha_c, then w_c

  const size_t row0 = ((size_t)p.layer * p.B * p.Hkv + bh) * (size_t)p.S;
  E* kslab = static_cast<E*>(p.ck) + row0 * hd;
  E* vslab = static_cast<E*>(p.cv) + row0 * hd;
  const E* kfresh = static_cast<const E*>(p.k_new) + (size_t)bh * hd;
  const E* vfresh = static_cast<const E*>(p.v_new) + (size_t)bh * hd;
  const size_t srow = ((size_t)p.scale_layer * p.B * p.Hkv + bh) * (size_t)p.S;
  const int off = p.off_dev ? p.off_dev[b * p.off_stride] : p.off;
  const int loc = off - start;  // the fresh row's slot in the range, when in [0, n)
  const size_t stage_bytes = (size_t)SR * row_bytes;
  const int nst = 2 * ns;  // K stages, then V stages

  // stage st (K rows, then V rows: up to SR of the range's) into ring slot
  // st % R (thread 0)
  auto issue = [&](int st) {
    const int slot = st % R, r0 = (st < ns ? st : st - ns) * SR;
    const uint32_t bytes = (uint32_t)(min(SR, n - r0) * row_bytes);
    const E* src = (st < ns ? kslab : vslab) + (size_t)(start + r0) * hd;
    sm90::mbar_arrive_tx(&full[slot], bytes);
    bulk_load(ring + (size_t)slot * stage_bytes, src, bytes, &full[slot]);
  };

  if (tid == 0) {
    for (int s = 0; s < R; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_init(meta, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // a block writes into another's shared memory only once both have started:
  // this arrival, and its wait before the first exchange
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (tid == 0) {
    sm90::mbar_arrive_tx(meta, (uint32_t)n * 4u * (kQuant ? 3u : 1u));
    bulk_load(vld, p.valid + (size_t)b * p.S + start, n * 4, meta);
    if constexpr (kQuant) {
      bulk_load(kss, p.ks + srow + start, n * 4, meta);
      bulk_load(vss, p.vs + srow + start, n * 4, meta);
    }
    for (int st = 0; st < R && st < nst; ++st) issue(st);
  }
  const int Hq = p.Hkv * G;
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * G;
  const T* qp = static_cast<const T*>(p.q) + head0 * hd;
  for (int i = tid; i < G * hd; i += kThreads) qs[i] = to_f32(qp[i]);
  __syncthreads();

  // K pass. On the tensor cores (bf16 q, hd a multiple of 4 chunks, at
  // most 256): a warp's 16-row tile of the stage is A and q^T B of one
  // mma.sync m16n8k16 a 16-dim k-step, the G <= 8 query heads its columns.
  // The k order is permuted alike in A and B (each logit is the same sum
  // of exact bf16 products in another order): lane t of a group of 4 chunks
  // takes chunk t, one 16-byte load a row, 4 dims a k-step. int8 and int4
  // keys become bf16 pairs (exact) in registers. Otherwise (f32 q) on CUDA
  // cores: the lpr consecutive lanes of a row each take cpl of its nvec
  // chunks (c0 + j lpr), at most 16 elements a lane, q in registers, kU rows
  // a thread at once, the lanes' sums folded by log2(lpr) shuffles.
  // The chunk mode rounds logit - m_c to bf16, an absolute rounding (a
  // step of 2^-6 at 3): a logit a few ulps off flips it and moves that p by
  // percents, and mma.sync's f32 sums are a few ulps off a rounded sum. Its
  // logits take the CUDA-core path's fmaf chains, as the first packed kernel
  // did.
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value && M != kChunk;
  constexpr int kpg = N / 4;       // k-steps a 16-byte chunk holds
  constexpr int kMaxGroups = 64 / N;  // groups of 4 chunks in a row of hd <= 256
  const bool tc = kTC && hd % (4 * N) == 0 && hd <= 256;
  wait(meta, 0);
  if (tc) {
    const int tq = lane & 3, gq = lane >> 2, ngroups = hd / (4 * N);
    uint32_t qb[16][2];  // B fragments: head gq, the lane's dims of each k-step
#pragma unroll
    for (int b = 0; b < kMaxGroups; ++b)
#pragma unroll
      for (int j = 0; j < kpg; ++j) {
        const int d0 = b * 4 * N + tq * N + 4 * j;
        const bool on = b < ngroups && gq < G;
        const float* qg = qs + gq * hd + d0;
        qb[b * kpg + j][0] = on ? bf16_pair(qg[0], qg[1]) : 0u;
        qb[b * kpg + j][1] = on ? bf16_pair(qg[2], qg[3]) : 0u;
      }
    for (int st = 0; st < ns; ++st) {
      const int slot = st % R;
      wait(&full[slot], (uint32_t)(st / R) & 1u);
      const unsigned char* sb = ring + (size_t)slot * stage_bytes;
      const int rows_here = min(SR, n - st * SR);
      for (int tile = warp; tile < rows_here / 16; tile += kWarps) {
        const int ra = tile * 16 + gq, la = st * SR + ra, lb = la + 8;
        const uint4* pa = reinterpret_cast<const uint4*>(sb + ra * row_bytes);
        const uint4* pb = reinterpret_cast<const uint4*>(sb + (ra + 8) * row_bytes);
        const uint4* pf = reinterpret_cast<const uint4*>(kfresh);
        float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int b = 0; b < kMaxGroups; ++b) {
          if (b < ngroups) {
            uint4 wa = pa[4 * b + tq], wb = pb[4 * b + tq];
            if (la == loc) wa = pf[4 * b + tq];
            if (lb == loc) wb = pf[4 * b + tq];
            const uint32_t xa[4] = {wa.x, wa.y, wa.z, wa.w}, xb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int j = 0; j < kpg; ++j) {
              uint32_t a[4];
              if constexpr (F == kCacheT) {
                a[0] = xa[2 * j], a[2] = xa[2 * j + 1], a[1] = xb[2 * j], a[3] = xb[2 * j + 1];
              } else {
                key_pairs<F>(xa[j], a[0], a[2]);
                key_pairs<F>(xb[j], a[1], a[3]);
              }
              mma_bf16(d, a, qb[b * kpg + j][0], qb[b * kpg + j][1]);
            }
          }
        }
        // d: rows la (d0, d1) and lb (d2, d3), heads 2 tq and 2 tq + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int li = h ? lb : la;
          float f = p.scale;
          if constexpr (kQuant) f = (li == loc ? p.ks_new[bh] : kss[li]) * p.scale;
          const bool ok = vld[li] > 0;
          if (2 * tq < G) lg[2 * tq * nmax + li] = ok ? d[2 * h] * f : kDead;
          if (2 * tq + 1 < G) lg[(2 * tq + 1) * nmax + li] = ok ? d[2 * h + 1] * f : kDead;
        }
      }
      __syncthreads();  // every thread is done with the slot: refill it
      if (tid == 0 && st + R < nst) issue(st + R);
    }
  } else {
    constexpr int kJ = 16 / N;  // chunks a lane at most
    constexpr int kU = 4;       // rows a thread takes at once
    const int lpr = max(min(nvec, 8), nvec * N / 16), cpl = nvec / lpr;
    const int c0 = tid % lpr, kr0 = tid / lpr, kstep = kThreads / lpr;
    float qr[G][16];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int t = 0; t < N; ++t)
          qr[g][j * N + t] = j < cpl ? qs[g * hd + (c0 + j * lpr) * N + t] : 0.f;
    for (int st = 0; st < ns; ++st) {
      const int slot = st % R;
      wait(&full[slot], (uint32_t)(st / R) & 1u);
      const unsigned char* sb = ring + (size_t)slot * stage_bytes;
      const int rows_here = min(SR, n - st * SR);
      for (int rb = kr0; rb < rows_here; rb += kU * kstep) {
        float dot[kU][G];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int r = rb + u * kstep;
          float acc[G][2];  // two chains a head: even and odd elements
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0.f;
          if (r < rows_here) {  // the same for a row's lanes and the whole warp
            const Vec16<E>* krow = reinterpret_cast<const Vec16<E>*>(sb + r * row_bytes);
            const bool fresh = st * SR + r == loc;
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
              if (j < cpl) {
                Vec16<E> kv = krow[c0 + j * lpr];
                if (fresh) kv = reinterpret_cast<const Vec16<E>*>(kfresh)[c0 + j * lpr];
#pragma unroll
                for (int t = 0; t < N; ++t) {
                  const float kf = key_of<F>(kv.v[t]);
#pragma unroll
                  for (int g = 0; g < G; ++g)
                    acc[g][t & 1] = fmaf(qr[g][j * N + t], kf, acc[g][t & 1]);
                }
              }
            }
          }
#pragma unroll
          for (int g = 0; g < G; ++g) dot[u][g] = acc[g][0] + acc[g][1];
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          if (o < lpr) {
#pragma unroll
            for (int u = 0; u < kU; ++u)
#pragma unroll
              for (int g = 0; g < G; ++g)
                dot[u][g] += __shfl_xor_sync(0xffffffffu, dot[u][g], o);
          }
        }
        if (c0 == 0) {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int li = st * SR + rb + u * kstep;
            if (rb + u * kstep < rows_here) {
              const bool ok = vld[li] > 0;
              float f = p.scale;
              if constexpr (kQuant) f = (li == loc ? p.ks_new[bh] : kss[li]) * p.scale;
#pragma unroll
              for (int g = 0; g < G; ++g) lg[g * nmax + li] = ok ? dot[u][g] * f : kDead;
            }
          }
        }
      }
      __syncthreads();  // every thread is done with the slot: refill it
      if (tid == 0 && st + R < nst) issue(st + R);
    }
  }

  // 1. the cluster max (chunk mode: each chunk's max too, a warp a (head,
  // chunk))
  float v[G];
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = -INFINITY;
  for (int i = tid; i < n; i += kThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = fmaxf(v[g], lg[g * nmax + i]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    v[g] = warp_max(v[g]);
    if (lane == 0) red[warp * kMaxG + g] = v[g];
  }
  if constexpr (M == kChunk) {
    for (int t = warp; t < G * nc; t += kWarps) {
      const int g = t / nc, j = t % nc;
      float m = -INFINITY;
      for (int i = lane; i < unit; i += 32) m = fmaxf(m, lg[g * nmax + j * unit + i]);
      m = warp_max(m);
      if (lane == 0) cm[g * nch + j] = m;
    }
  }
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // each block pushes its maxes into every block's inbox (thread (r, g)
  // writes rank r's entry), then reads its own inbox after the barrier
  if (tid < C * G) {
    const int g = tid % G;
    float m = -INFINITY;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w * kMaxG + g]);
    cluster.map_shared_rank(in_max, tid / G)[rank * kMaxG + g] = m;
  }
  cluster.sync();
  if (tid < G) {
    if constexpr (M == kChunk) {
      // walk the block's chunks from M_pre: m_c and alpha_c, then w_c (the
      // product of the later chunks' alphas) and A_r
      float m = kDead;
      for (int r = 0; r < rank; ++r)
        if (r != p.skip_rank) m = fmaxf(m, in_max[r * kMaxG + tid]);
      float* cmg = cm + tid * nch;
      float* cwg = cw + tid * nch;
      for (int j = 0; j < nc; ++j) {
        const float m_new = fmaxf(m, cmg[j]);
        cwg[j] = expf(m - m_new);
        cmg[j] = m_new;
        m = m_new;
      }
      float w = 1.f;
      for (int j = nc - 1; j >= 0; --j) {
        const float alpha = cwg[j];
        cwg[j] = w;
        w *= alpha;
      }
      Ag[tid] = w;
    } else {
      float m = -INFINITY;
      for (int r = 0; r < C; ++r) m = fmaxf(m, in_max[r * kMaxG + tid]);
      Mg[tid] = M == kNorm ? m : fmaxf(m, kFloor);
    }
  }
  __syncthreads();

  // 2. p = exp(logit - M) and the cluster sum, in rank order (chunk mode:
  // p against its chunk's m_c, rounded, and w_c p' as P V takes it)
#pragma unroll
  for (int g = 0; g < G; ++g) v[g] = 0.f;
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = vld[i] > 0;
    if constexpr (M == kChunk) {
      const int j = i / unit;
      float vsc = 1.f;
      if constexpr (kQuant) vsc = i == loc ? p.vs_new[bh] : vss[i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float e =
            ok ? round_to<T>(expf(round_to<T>(lg[g * nmax + i] - cm[g * nch + j]))) : 0.f;
        const float w = cw[g * nch + j];
        lg[g * nmax + i] = w * (kQuant ? round_to<T>(e * vsc) : e);
        v[g] += w * e;
      }
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float e = (M == kNorm || ok) ? expf(lg[g * nmax + i] - Mg[g]) : 0.f;
        lg[g * nmax + i] = e;
        v[g] += e;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    v[g] = warp_sum(v[g]);
    if (lane == 0) red[warp * kMaxG + g] = v[g];
  }
  __syncthreads();
  if (tid < C * G) {  // the warps' sums in order, pushed as the maxes were
    const int g = tid % G;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kMaxG + g];
    cluster.map_shared_rank(in_sum, tid / G)[rank * kMaxG + g] = s;
    if constexpr (M == kChunk) cluster.map_shared_rank(in_a, tid / G)[rank * kMaxG + g] = Ag[g];
  }
  cluster.sync();
  if (tid < G) {
    float s = 0.f;
    for (int r = 0; r < C; ++r) {  // in rank order (chunk mode: chained)
      if constexpr (M == kChunk) s = in_a[r * kMaxG + tid] * s + in_sum[r * kMaxG + tid];
      else s += in_sum[r * kMaxG + tid];
    }
    Lg[tid] = s;
  }
  __syncthreads();

  // 3. p as P V takes it: normalized, times the V scale, rounded to T (the
  // chunk mode did this in step 2)
  if constexpr (M != kChunk) {
    for (int i = tid; i < n; i += kThreads) {
      float vsc = 1.f;
      if constexpr (kQuant) vsc = i == loc ? p.vs_new[bh] : vss[i];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float pv = lg[g * nmax + i];
        if constexpr (M == kNorm) pv = pv / Lg[g];
        lg[g * nmax + i] = round_to<T>(pv * vsc);
      }
    }
    __syncthreads();
  }

  // V pass: thread (row r0 of every `rows`, chunk c) of each stage
  const int c = tid % nvec, rows = kThreads / nvec, r0 = tid / nvec;
  float acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[g][j] = 0.f;
  for (int st = ns; st < nst; ++st) {
    const int slot = st % R;
    wait(&full[slot], (uint32_t)(st / R) & 1u);
    const unsigned char* sb = ring + (size_t)slot * stage_bytes;
    const int base = (st - ns) * SR, rows_here = min(SR, n - base);
#pragma unroll 2
    for (int r = r0; r < rows_here; r += rows) {
      const int li = base + r;
      Vec16<E> vv = reinterpret_cast<const Vec16<E>*>(sb + r * row_bytes)[c];
      if (li == loc) vv = reinterpret_cast<const Vec16<E>*>(vfresh)[c];
      float vf[N];
#pragma unroll
      for (int j = 0; j < N; ++j) vf[j] = value_of<F>(vv.v[j]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pg = lg[g * nmax + li];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[g][j] = fmaf(pg, vf[j], acc[g][j]);
      }
    }
    __syncthreads();
    if (tid == 0 && st + R < nst) issue(st + R);
  }

  // every load of the range has landed: the owner appends the fresh row(s)
  if (loc >= 0 && loc < n) {
    for (int i = tid; i < nvec; i += kThreads) {
      reinterpret_cast<uint4*>(kslab + (size_t)off * hd)[i] =
          reinterpret_cast<const uint4*>(kfresh)[i];
      if (F != kInt4)
        reinterpret_cast<uint4*>(vslab + (size_t)off * hd)[i] =
            reinterpret_cast<const uint4*>(vfresh)[i];
    }
  }

  // the block's partial: lanes of one chunk fold by shuffles, then the warps
  // in order (the ring's bytes hold the warps' partials)
  for (int o = 16; o >= nvec; o >>= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  }
  float* part = reinterpret_cast<float*>(ring);  // [kWarps][G][hd]
  if (lane < nvec) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < N; ++j) part[((size_t)warp * G + g) * hd + c * N + j] = acc[g][j];
  }
  __syncthreads();

  // 4. rank r owns outputs [e0(r), e0(r + 1)), e0(r) = r G hd / C: each
  // block pushes its partial of them into rank r's inbox (q's bytes, free
  // since the K pass), then sums its own inbox in rank order. No block
  // touches another's shared memory after the barrier, so each may leave.
  const int GH = G * hd, share = (GH + C - 1) / C;
  for (int i = tid; i < GH; i += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[(size_t)w * GH + i];
    const int r = ((i + 1) * C - 1) / GH;  // the owner: e0(r) <= i < e0(r + 1)
    cluster.map_shared_rank(qs, r)[rank * share + i - r * GH / C] = s;
  }
  cluster.sync();
  const int e0 = rank * GH / C, e1 = (rank + 1) * GH / C;
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int g = e / hd;
    float s = 0.f;
    for (int r = 0; r < C; ++r) {
      if constexpr (M == kChunk) s = in_a[r * kMaxG + g] * s + qs[r * share + e - e0];
      else s += qs[r * share + e - e0];
    }
    T* out = static_cast<T*>(p.out) + head0 * hd + e;
    if constexpr (M == kNorm) *out = from_f32<T>(s);
    else if constexpr (M == kMono) *out = from_f32<T>(Lg[g] > 0.f ? s / Lg[g] : 0.f);
    else if constexpr (M == kChunk) *out = from_f32<T>(s / Lg[g]);
    else static_cast<float*>(p.out)[head0 * hd + e] = s;
  }
  if constexpr (M == kStats) {
    if (rank == 0 && tid < G) {
      p.m_out[head0 + tid] = Mg[tid];
      p.l_out[head0 + tid] = Lg[tid];
    }
  }
}

// A launch of `kernel` on clusters of C blocks along x (grid (C, rows)):
// the attributes the plan's shared memory and cluster size need, and the
// configuration (its cluster attribute in *attr).
template <class K>
cudaError_t cluster_config(K kernel, int C, int rows, size_t smem, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(kernel, smem);
  *cfg = {};
  cfg->gridDim = dim3(C, rows);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// Launch `kernel` (a __global__ taking Params): one cluster per (batch row,
// KV head).
template <class K>
cudaError_t launch(K kernel, const Params& p, int C, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config(kernel, C, p.B * p.Hkv, smem, stream, &cfg, &attr);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// A kernel's registers, local (spilled) bytes, the shared memory of the
// plan and the clusters of C blocks resident at once on the card (out[4]).
template <class K>
cudaError_t info(K kernel, int C, size_t smem, int* out) {
  cudaFuncAttributes fa = {};
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (err == cudaSuccess) err = cluster_config(kernel, C, 1, smem, nullptr, &cfg, &attr);
  int clusters = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = (int)smem;
  out[3] = clusters;
  return err;
}

// G = Hq / Hkv as a template argument: f(std::integral_constant<int, G>).
template <class Fn>
cudaError_t with_g(int G, Fn&& f) {
  switch (G) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

// The core's one kernel: T q's dtype and the compute dtype, F the cache
// format, G the query heads a KV head, M the mode. Each mode's instances
// compile in a unit of their own (module note), so the units build in
// parallel.
template <typename T, int F, int G, int M>
__global__ void __launch_bounds__(kThreads, min_blocks(G)) db_kernel(const Params p) {
  attend<T, F, G, M>(p);
}

template <typename T, int F, int M>
cudaError_t run(int G, const Params& p, int C, bool info_only, int* out, cudaStream_t stream) {
  const int elem = F == kCacheT ? (int)sizeof(T) : 1;
  const int nmax = range_slots(p.S, C, p.unit);
  const size_t smem = layout(p.hd * elem, F != kCacheT, G, p.hd, nmax, p.stages,
                             M == kChunk ? nmax / p.unit : 0).total;
  return with_g(G, [&](auto g) {
    auto kernel = db_kernel<T, F, decltype(g)::value, M>;
    return info_only ? info(kernel, C, smem, out) : launch(kernel, p, C, smem, stream);
  });
}

// The cache formats a mode takes: mono only q's dtype, chunk also int8.
template <typename T, int M>
cudaError_t run_fmt(int fmt, int G, const Params& p, int C, bool info_only, int* out,
                    cudaStream_t stream) {
  if (fmt == kCacheT) return run<T, kCacheT, M>(G, p, C, info_only, out, stream);
  if constexpr (M != kMono) {
    if (fmt == kInt8) return run<T, kInt8, M>(G, p, C, info_only, out, stream);
  }
  if constexpr (M == kStats || M == kNorm) {
    if (fmt == kInt4) return run<T, kInt4, M>(G, p, C, info_only, out, stream);
  }
  return cudaErrorInvalidValue;
}

// Launch the mode's instance for q's dtype code, the cache format (0 q's
// dtype, 1 int8, 2 int4) and G at the plan (C blocks a cluster, p.stages,
// ranges in units of p.unit slots), or with info_only report it (out[4], as
// `info`).
template <int M>
cudaError_t dispatch(int fmt, int dtype, int G, const Params& p, int C, bool info_only,
                     int* out, cudaStream_t stream) {
  if (!plan_ok(p.S, C, p.stages, p.unit)) return cudaErrorInvalidValue;
  if (M != kChunk && p.unit != kGroup) return cudaErrorInvalidValue;
  if (dtype == kBF16) return run_fmt<__nv_bfloat16, M>(fmt, G, p, C, info_only, out, stream);
  if (dtype == kF32) return run_fmt<float, M>(fmt, G, p, C, info_only, out, stream);
  return cudaErrorInvalidValue;
}

// The Params of a call whose offset is the host's `off`, ranges in 32-slot
// groups (the db entries; the single-buffered and mono entries set off_dev
// after, the packed entry the chunk as the unit).
inline Params db_params(const void* q, const void* k_new, const void* v_new,
                        const void* ks_new, const void* vs_new, void* ck, void* cv,
                        const void* ks, const void* vs, const void* valid, int layer,
                        int scale_layer, int off, int B, int Hkv, int S, int hd, float scale,
                        int stages, void* m, void* l, void* out) {
  Params p{};
  p.q = q;
  p.k_new = k_new;
  p.v_new = v_new;
  p.ks_new = static_cast<const float*>(ks_new);
  p.vs_new = static_cast<const float*>(vs_new);
  p.ck = ck;
  p.cv = cv;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.valid = static_cast<const int*>(valid);
  p.off_dev = nullptr;
  p.off_stride = 0;
  p.unit = kGroup;
  p.skip_rank = -1;
  p.layer = layer;
  p.scale_layer = scale_layer;
  p.off = off;
  p.B = B;
  p.Hkv = Hkv;
  p.S = S;
  p.hd = hd;
  p.stages = stages;
  p.scale = scale;
  p.m_out = static_cast<float*>(m);
  p.l_out = static_cast<float*>(l);
  p.out = out;
  return p;
}

// dispatch<kStats>, defined in decode_attention_db.cu, dispatch<kNorm> in
// decode_attention_norm.cu, dispatch<kMono> in decode_attention.cu and
// dispatch<kChunk> in decode_attention_packed.cu: each mode is instantiated
// in one place.
cudaError_t dispatch_stats(int fmt, int dtype, int G, const Params& p, int C, bool info_only,
                           int* out, cudaStream_t stream);
cudaError_t dispatch_normalized(int fmt, int dtype, int G, const Params& p, int C,
                                bool info_only, int* out, cudaStream_t stream);
cudaError_t dispatch_mono(int fmt, int dtype, int G, const Params& p, int C, bool info_only,
                          int* out, cudaStream_t stream);
cudaError_t dispatch_chunk(int fmt, int dtype, int G, const Params& p, int C, bool info_only,
                           int* out, cudaStream_t stream);

}  // namespace tl
}  // namespace al
