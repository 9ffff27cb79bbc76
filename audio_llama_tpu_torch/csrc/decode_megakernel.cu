// One decode step of one request through the whole int4 decoder stack, in
// one cooperative launch.
//
// Replaces audio_llama_tpu/ops/decode_megakernel.py::_kernel
// (decode_megakernel). Inputs: the embedded token x [D] bf16; the fused int4
// slabs of every layer (q|k|v [L, D, Nq/2], o [L, Hq*hd, D/2], gate|up
// [L, D, F], down [L, F, D/2] int8 with f32 scales [L, K/128, N]; pack
// formats as int4_common.cuh); the LayerNorm scales [L, D] bf16; the rope
// row [hd] f32 at the append position; the K/V-combined int4 cache
// [L, Hkv, Tk, hd] int8 with its per-row scale slabs [L, Hkv, Tk] f32; the
// append slot (int32 [1] on the device) and the slot validity [Tk] int32.
// Per layer, five phases, as the TPU kernel:
//  (A) rms(h) (f32 stats, the normed row rounded to bf16 before the bf16
//      scale multiply), then q|k|v; both planes go out in f32;
//  (B) attention: q, k, v rounded to bf16 from the planes, rope in f32
//      rounded to bf16, the k and v rows quantized to int4 (absmax/7, round
//      half to even, clip to [-7, 7]); the slab read with the append slot
//      dead and the fresh row entered analytically (m = max(m1, lf), P
//      meeting V as (p * v_scale) rounded to bf16); the packed row and its
//      scales written at the offset once every read of the slab is done
//      (nothing for an offset outside the cache);
//  (C) o, then h += bf16(o) for each column;
//  (D) rms(h), gate|up (gate j and up j share a packed column), then
//      a = bf16(g * sigmoid(g) * u);
//  (E) down, then h += bf16(d).
// A grid-wide barrier closes each phase: 5 per layer, 5L - 1 in all. After
// the last layer h is the output.
//
// Bound on the H100: bytes, about 1.54 GB per step at 3B widths (1.409 GB of
// int4 slabs, 88 MB of scales, 45 MB of the int4 cache at 1568 slots):
// ~0.46 ms at 3.35 TB/s. The first design (one block per SM, 32-column
// tiles over all of K, 8 blocks on the attention, nibbles decoded one by one
// on the CUDA cores, the stream stopped at every barrier) ran at 8.6x that.
// This one:
//  - Every SM works in every phase. A product's work is its W = T * Gk
//    units (a unit: one 128-row group of one tile of 128 packed columns),
//    unit i being group i % Gk of tile i / Gk; block b of the P-block grid
//    takes units [b W / P, (b + 1) W / P), so the blocks' shares differ by
//    at most one unit, and a share cuts each tile it touches into a K
//    slice of whole groups. The attention is Hkv x S units, S splits of
//    each KV head's timeline (about 4 of its 32-slot groups each, at most
//    P / Hkv), each a contiguous range of groups. The plan is computed by
//    the same formulas in ops/decode_megakernel.py (`plan`, `shares`,
//    `tile_slices`, `splits`), whose CPU test checks that it covers every
//    column, K row and slot once.
//  - The partials meet in global f32 scratch, summed in a fixed order by
//    the last block to arrive (an arrival count a tile or a KV head): a
//    tile's K slices in K order (each slice its groups in order); a head's
//    splits by a fixed tree (the max exact, l by lane and tree, acc over
//    each parity of the splits in order, then the two), then the fresh
//    row. A block arrives at the tiles of its share at once, after its
//    last stage (one fence, one count a lane). DSMEM inside a cluster would
//    need every slice of a tile in one cluster, which the even split of
//    the grid does not give; the scratch round trip is one L2 write and
//    read of a few hundred KB a phase.
//  - The weight stream crosses the barriers. Each block walks one stream of
//    stages, every layer's five phases in turn (a stage: a unit, a TMA box
//    of 128 rows x 128 bytes, 128B-swizzled, and a TMA box of its scales;
//    or a chunk of up to 4 timeline groups of the cache with their scales
//    and validity, in bulk copies), through a ring of kStages shared-memory
//    slots behind one mbarrier each (kStages - 1 stages, ~70 KB, in flight
//    a block). Thread 0 is the producer: it walks a cursor (its phases'
//    maps and shapes in shared memory) and issues one stage each time the
//    block frees a slot. The stream depends on nothing the step computes,
//    so the stages of the next phase, or the next layer's q|k|v, are in
//    flight while the block waits at a barrier. Two blocks of 256 threads
//    an SM where they are resident (the wrapper asks the occupancy API),
//    else one. A phase's x rows (the rms-normed row, or the attention
//    output or activation) come from L2 in one round trip.
//  - Products on the tensor cores: int4_common.cuh's ldmatrix.trans of the
//    stage, the lop3 + fma.bf16x2 unpack into exact bf16 pairs and mma.sync
//    m16n8k16 with x as B (token 0 of the n-tile, the rest a zero row);
//    warp w takes the tile's columns 16 w .. 16 w + 15 over the whole
//    group, whose f32 mma sum times its scale joins the slice's f32
//    accumulator, as the plain version's per-group product.
//  - Attention on CUDA cores, split over the SMs: a split keeps its own
//    (m, l, acc[G, hd]) across its chunks (online: the running max
//    rescales l and acc, p is rounded against it), and the head's last
//    split merges all of them and the fresh row (`combine`).
// What holds it now (H100 timings in PERF.md): not the bytes (a launch
// with the copies removed takes ~95% of the time of one with them) but
// each phase's chain: the x rows from L2, the last slices' arrivals and
// ordered sums (the head's merge in the attention), the grid barrier.
// Barriers: an arrival count that only grows inside a launch (barrier k
// waits for k P arrivals), reset by the last block to leave. Every wait is
// bounded: past kWaitNs the block traps, so a grid that is not resident
// fails the run instead of hanging it. Data written inside the launch is
// read with ld.global.cg, past the SM's L1.
//
// `phases` is a mask of the five phases (bit 0: A ... bit 4: E): a phase
// left out has no stages and no work, every barrier stays (0: the barriers
// alone). The planted faults of chip_smoke's check: skip_split leaves
// split s of every head out of the merge, skip_slice the K slice j of every
// tile out of its sum, and stale fills each stage that crosses a barrier
// with the bytes of the stage its ring slot held before (the next layer's
// q|k|v fed the previous layer's bytes), as a ring that does not wait for
// its copies would.
#include <algorithm>

#include "int4_common.cuh"
#include "sm90.cuh"

namespace {

namespace w4 = al::w4;
namespace sm90 = al::sm90;

constexpr int kGroup = 128;  // scale group (ops/decode_megakernel.py::ok_for refuses others)
constexpr int kHd = 128;     // head_dim == the scale group
constexpr int kThreads = 256;
constexpr int kTW = 128;                // packed columns a tile (16 a warp)
constexpr int kWBytes = kGroup * kTW;   // a stage's rows (a multiple of 1024: TMA's swizzle)
constexpr int kSlots = 32;              // cache slots a timeline group
constexpr int kChunk = 4;               // timeline groups an attention stage
constexpr int kSBytes = 3 * kChunk * kSlots * 4;  // a stage's scales (and validity)
constexpr int kStages = 5;              // ring slots (kStages - 1 stages in flight)
constexpr int kMaxG = 4;                 // query heads per KV head
constexpr int kPhases = 5;
constexpr int kAttn = 1;  // the attention phase (B)
constexpr float kDead = -1e30f;
constexpr unsigned long long kWaitNs = 4000000000ull;  // a wait past this traps
constexpr int kQPad = 36;   // floats a 32-dim quarter of q in shared memory (bank spread)
constexpr int kBatch = 32;  // partials loaded together in an ordered sum
constexpr int kMerge = 16;  // (split, head) partials loaded together in the merge

struct Prod {
  const int8_t* p;  // [L, K, Nh] packed
  const float* s;   // [L, K / 128, 2 Nh]
  int K, Nh, T, Gk;
  __host__ __device__ int W() const { return T * Gk; }
};

struct Params {
  const __nv_bfloat16 *x, *iln, *pln;
  const float *cos, *sin;
  Prod pr[kPhases];  // by phase: A q|k|v, C o, D gate|up, E down (B unused)
  int8_t* ckv;
  float *ks, *vs;
  const int *offset, *valid;
  float* qkv_out;       // [2 Nh_qkv] scratch
  __nv_bfloat16* attn;  // [Hq hd] scratch
  __nv_bfloat16* act;   // [F] scratch
  __nv_bfloat16* h;     // [D] residual, the output
  float* fresh;         // [L, Hkv, 2]
  float* part;          // [max W, 2 kTW] the K slices' partials, keyed by their first unit
  float* apart;         // [Hkv S, G (hd + 2)] split partials: acc, then m, then l
  int* cnt;             // [max T] arrival counts of the tiles (zero between launches)
  int* hcnt;            // [Hkv] arrival counts of the heads' splits (the same)
  unsigned* bar;        // [2] barrier arrivals, blocks done
  int L, D, F, Hq, Hkv, Tk, fmt, S, maxj;
  float eps, scale;
  int phases, skip_split, skip_slice, stale;
};

// The four products' packed slabs as TMA maps: [L K rows, Nh bytes], boxes
// of 128 rows x 128 bytes, 128B-swizzled (chunk j of row r at j ^ (r % 8));
// and their scales: [L Gk 2 rows (a group's two planes), Nh f32], boxes of
// 2 rows x 128 values.
struct Maps {
  CUtensorMap m[4], s[4];
};

// The product of phase ph (not the attention's), by constant indices only:
// the Params stay in the kernel's parameter space.
__device__ __forceinline__ Prod prod(const Params& p, int ph) {
  Prod r = p.pr[0];
  if (ph == 2) r = p.pr[2];
  if (ph == 3) r = p.pr[3];
  if (ph == 4) r = p.pr[4];
  return r;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier k of the launch: every block arrives before any leaves (the count
// reaches k P). A wait past kWaitNs traps.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned long long t0 = globaltimer();
    for (unsigned spins = 1; ld_acquire(bar) < target; ++spins)
      if (!(spins & 255) && globaltimer() - t0 > kWaitNs) __trap();
    __threadfence();
  }
  __syncthreads();
}

// Wait for the phase of parity `parity` of a ring slot's mbarrier; a wait
// past kWaitNs (a copy that never lands) traps.
__device__ __forceinline__ void slot_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = sm90::smem_u32(bar);
  unsigned long long t0 = 0;
  for (unsigned spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == 0) t0 = globaltimer();
    else if (!(spins & 1023) && globaltimer() - t0 > kWaitNs) __trap();
  }
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

// The share plan (mirrored by ops/decode_megakernel.py): block b of P takes
// units [start(b), start(b + 1)) of a product's W = T Gk, unit i being
// group i % Gk of tile i / Gk; block_of(i) is the block whose share holds
// unit i (W P < 2^31: the wrapper checks it).
__host__ __device__ __forceinline__ int share_start(int b, int W, int P) { return b * W / P; }
__device__ __forceinline__ int block_of(int i, int W, int P) { return ((i + 1) * P - 1) / W; }

// What the producer needs of a phase, in shared memory (thread 0 fills it
// once): the product's maps and shapes, the block's first unit and its
// stages a layer.
struct FeedPhase {
  const CUtensorMap *map, *smap;
  int K, Gk, first, cnt;
};

// A block's stream of stages (every layer's phases in turn) and its ring.
// Thread 0 is the producer: it walks a cursor, one stage an issue, each two
// TMA boxes (a unit: a group of a tile and its scales) or bulk copies (a
// chunk of the cache) that complete a transaction on the slot's mbarrier.
struct Stream {
  int cnt[kPhases];  // the block's stages a layer, by phase
  int per_layer, total;
  int head, q0, ng;  // the attention unit: KV head, first timeline group, groups
  unsigned char* ring;   // kStages slots of kWBytes (1024-byte aligned)
  unsigned char* sring;  // kStages slots of kSBytes
  uint64_t* full;        // kStages mbarriers
  const FeedPhase* fp;   // [kPhases]
  int issued;            // stages issued
  int c_li, c_ph, c_i;   // the cursor: the next stage to issue
  int c_tile, c_g;       // its unit's tile and group (a product's)

  __device__ __forceinline__ void enter_phase() {
    while (c_i >= fp[c_ph].cnt) {  // skip phases without stages
      c_i = 0;
      if (++c_ph == kPhases) c_ph = 0, ++c_li;
    }
    if (c_ph != kAttn) {
      const FeedPhase& f = fp[c_ph];
      c_tile = (f.first + c_i) / f.Gk;
      c_g = (f.first + c_i) % f.Gk;
    }
  }

  __device__ __forceinline__ void locate(int n, int& li, int& ph, int& i) const {
    li = n / per_layer;
    i = n - li * per_layer;
    ph = 0;
#pragma unroll
    for (int q = 0; q < kPhases - 1; ++q)  // constant indices: cnt stays in registers
      if (ph == q && i >= cnt[q]) {
        i -= cnt[q];
        ph = q + 1;
      }
  }

  // the bytes of stage (li, ph, i) into ring slot k: chunk i of the
  // split's timeline groups (their rows; their k scales, v scales and
  // validity at 512-byte steps), or a unit (group g of tile `tile`): its 128
  // rows, then its scales, both planes
  __device__ __forceinline__ void copy(const Params& p, int k, int li, int ph, int i, int tile,
                                       int g) const {
    unsigned char* dst = ring + (size_t)k * kWBytes;
    unsigned char* sdst = sring + (size_t)k * kSBytes;
    uint64_t* bar = full + k;
    if (ph == kAttn) {
      const int n = min(kChunk, ng - i * kChunk) * kSlots;  // slots of the chunk
      const size_t row0 = ((size_t)li * p.Hkv + head) * p.Tk + (size_t)(q0 + i * kChunk) * kSlots;
      sm90::mbar_arrive_tx(bar, n * (kHd + 12));
      bulk_load(dst, p.ckv + row0 * kHd, n * kHd, bar);
      bulk_load(sdst, p.ks + row0, n * 4, bar);
      bulk_load(sdst + kChunk * kSlots * 4, p.vs + row0, n * 4, bar);
      bulk_load(sdst + 2 * kChunk * kSlots * 4, p.valid + (q0 + i * kChunk) * kSlots, n * 4, bar);
      return;
    }
    const FeedPhase& f = fp[ph];
    sm90::mbar_arrive_tx(bar, kWBytes + 2 * kTW * 4);
    sm90::tma_load_2d(dst, f.map, bar, tile * kTW, li * f.K + g * kGroup);
    sm90::tma_load_2d(sdst, f.smap, bar, tile * kTW, (li * f.Gk + g) * 2);
  }

  // (thread 0) Issue the next stage; nothing past the end. Under the stale
  // fault a weight stage issued across a barrier (its phase is not the one
  // of the stage being consumed) whose slot last held a weight stage gets
  // that stage's bytes again.
  __device__ __forceinline__ void issue(const Params& p) {
    const int n = issued++;
    if (n >= total) return;
    bool fault = false;
    if (p.stale && n >= kStages) {
      int l1, p1, i1, l2, p2, i2;
      locate(n - (kStages - 1), l1, p1, i1);
      locate(n - kStages, l2, p2, i2);
      fault = (c_li != l1 || c_ph != p1) && c_ph != kAttn && p2 != kAttn;
    }
    if (fault) {  // the slot's previous stage
      int li, ph, i;
      locate(n - kStages, li, ph, i);
      const int u = fp[ph].first + i;
      copy(p, n % kStages, li, ph, i, u / fp[ph].Gk, u % fp[ph].Gk);
    } else {
      copy(p, n % kStages, c_li, c_ph, c_i, c_tile, c_g);
    }
    // advance the cursor
    ++c_i;
    if (c_ph != kAttn && ++c_g == fp[c_ph].Gk) c_g = 0, ++c_tile;
    if (n + 1 < total && c_i >= fp[c_ph].cnt) enter_phase();
  }

  // Wait for stage n (its slot stays held) -> its slot index
  __device__ __forceinline__ int wait(int n) const {
    const int k = n % kStages;
    slot_wait(full + k, (uint32_t)((n / kStages) & 1));
    return k;
  }

  // Free the slot of stage n - 1 (every thread is done with it) and refill
  // it, then wait for stage n -> its slot index
  __device__ __forceinline__ int consume(const Params& p, int n) {
    __syncthreads();
    if (threadIdx.x == 0) issue(p);
    return wait(n);
  }
};

// xs[j] (128 bf16) <- the x rows of unit s + j's group, j < e - s: the bf16
// scale times the rms-normed row of src (ln != nullptr; hs: K bf16 of
// shared memory for the row), or the bf16 row src. One round trip to L2.
__device__ __forceinline__ void stage_x(const Params& p, __nv_bfloat16* xs, __nv_bfloat16* hs,
                                        const __nv_bfloat16* src, const __nv_bfloat16* ln, int K,
                                        int Gk, int s, int e, float* red) {
  const int tid = threadIdx.x;
  if (ln != nullptr) {
    // the scales of the share's rows, loaded beside the row (kLnRegs a thread)
    constexpr int kLnRegs = 8;
    const int nx = (e - s) * kGroup;
    float lnv[kLnRegs];
#pragma unroll
    for (int u = 0; u < kLnRegs; ++u) {
      const int c = tid + u * kThreads;
      lnv[u] = c < nx ? __bfloat162float(ln[((s + c / kGroup) % Gk) * kGroup + c % kGroup]) : 0.f;
    }
    float ss = 0.f;
#pragma unroll 4
    for (int i = tid * 8; i < K; i += kThreads * 8) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(src + i));
      *reinterpret_cast<uint4*>(hs + i) = v;
      const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float f = __bfloat162float(b[k]);
        ss += f * f;
      }
    }
    const float r = rsqrtf(al::block_sum(ss, red) / (float)K + p.eps);
    for (int c = tid, u = 0; c < nx; c += kThreads, ++u) {
      const int k = ((s + c / kGroup) % Gk) * kGroup + c % kGroup;
      float lv = 0.f;
#pragma unroll
      for (int q = 0; q < kLnRegs; ++q)
        if (u == q) lv = lnv[q];
      if (u >= kLnRegs) lv = __bfloat162float(ln[k]);
      xs[c] = __float2bfloat16(lv * bf16_round(__bfloat162float(hs[k]) * r));
    }
  } else {
    for (int c = tid; c < (e - s) * (kGroup / 8); c += kThreads) {
      const int k = ((s + c / (kGroup / 8)) % Gk) * kGroup + (c % (kGroup / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + c * 8) = __ldcg(reinterpret_cast<const uint4*>(src + k));
    }
  }
  __syncthreads();
}

// Tile t's K slices (t0 = t Gk): with W >= P every share holds a unit, so
// the blocks from the one holding unit t0 to the one holding unit t0 + Gk -
// 1 each hold a slice; with W < P each unit is a share of its own.
__device__ __forceinline__ int tile_slices(int t0, int Gk, int W, int P, int& bf) {
  bf = block_of(t0, W, P);
  return W >= P ? block_of(t0 + Gk - 1, W, P) - bf + 1 : Gk;
}

// Tile t's slices are all in: their partials summed in K order (0 for a
// slice planted out: x + 0 is x), thread c the output c < 128 of the low
// plane's column t 128 + c, else of the high plane's; then the phase's
// output. hin: the layer's input (x on layer 0), o's residual base. keys:
// kBatch ints of shared memory.
__device__ __forceinline__ void reduce_tile(const Params& p, int ph, const Prod& pr,
                                            const __nv_bfloat16* hin, int t, float* xch,
                                            int* keys) {
  const int c = threadIdx.x;
  const int W = pr.W(), P = gridDim.x, t0 = t * pr.Gk;
  int bf;
  const int nc = tile_slices(t0, pr.Gk, W, P, bf);
  const int col = (c < kTW ? 0 : pr.Nh) + t * kTW + (c & (kTW - 1));
  float hv = 0.f;
  if (ph == 2 || ph == 4) hv = __bfloat162float(__ldcg((ph == 2 ? hin : p.h) + col));
  float res = 0.f;
  for (int j0 = 0; j0 < nc; j0 += kBatch) {
    __syncthreads();  // keys is free
    if (c < kBatch && j0 + c < nc)  // slice j's first unit: its key
      keys[c] = W >= P ? max(share_start(bf + j0 + c, W, P), t0) : t0 + j0 + c;
    __syncthreads();
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u;
      v[u] = j < nc && j != p.skip_slice ? __ldcg(p.part + (size_t)keys[u] * 2 * kTW + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) res += v[u];
  }
  if (ph == 0) {
    p.qkv_out[col] = res;
  } else if (ph == 3) {  // gate j (low plane) and up j (high plane) -> a_j
    xch[c] = res;
    __syncthreads();
    if (c < kTW) {
      const float g = xch[c], u = xch[kTW + c];
      p.act[t * kTW + c] = __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
    }
    __syncthreads();
  } else {  // o (over hin) or down (over h): the residual
    p.h[col] = __float2bfloat16(hv + bf16_round(res));
  }
}

// One product phase of layer li on the block's share (hin: the layer's
// input, x on layer 0). A unit is one group of one tile, two stages; warp
// w takes the tile's packed columns 16 w .. 16 w + 15 over all its rows.
// The share's units of one tile are its K slice: the groups' f32 mma sums
// times their scales, added in group order, go to scratch at the slice's
// end; once the share is done the block arrives at its tiles, and the last
// slice of a tile to arrive sums the tile.
__device__ __forceinline__ void run_product(const Params& p, Stream& st, int li, int ph, int& n,
                                            const __nv_bfloat16* hin, unsigned char* aux,
                                            const uint4* zrow, float* red, float* xch,
                                            unsigned* lastmask, int* keys) {
  const Prod pr = prod(p, ph);
  const int P = gridDim.x, W = pr.W();
  const int s = share_start(blockIdx.x, W, P), e = share_start(blockIdx.x + 1, W, P);
  if (s >= e) return;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(aux);
  __nv_bfloat16* hs = xs + p.maxj * kGroup;
  if (ph == 0)
    stage_x(p, xs, hs, hin, p.iln + (size_t)li * p.D, pr.K, pr.Gk, s, e, red);
  else if (ph == 3)
    stage_x(p, xs, hs, p.h, p.pln + (size_t)li * p.D, pr.K, pr.Gk, s, e, red);
  else
    stage_x(p, xs, hs, ph == 2 ? p.attn : p.act, nullptr, pr.K, pr.Gk, s, e, red);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t clo = al::nibble_magic(p.fmt, false), chi = al::nibble_magic(p.fmt, true);
  float acc[2][4] = {};
  int key = s;
  for (int i = s; i < e; ++i) {
    float part[2][4];
    const int k = st.consume(p, n++);
    const unsigned char* slot = st.ring + (size_t)k * kWBytes;
    // x as B: lanes 0, 8, 16, 24 address token 0's four 8-wide k runs of
    // 32 rows, the other lanes a zero row
    const __nv_bfloat16* xrow = xs + (i - s) * kGroup + 8 * (lane >> 3);
#pragma unroll
    for (int q = 0; q < kGroup / 32; ++q) {
      const int row = 32 * q + lane;
      uint32_t a[4], xb[4];
      w4::ldsm_x4_trans(a, slot + row * kTW + ((warp ^ (row & 7)) << 4));
      w4::ldsm_x4(xb, (lane & 7) ? static_cast<const void*>(zrow)
                                 : static_cast<const void*>(xrow + 32 * q));
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t lo[4], hi[4];
        al::unpack_word_flip(a[2 * hh], clo, chi, lo[0], lo[1], hi[0], hi[1]);
        al::unpack_word_flip(a[2 * hh + 1], clo, chi, lo[2], lo[3], hi[2], hi[3]);
        const uint32_t b[2] = {xb[2 * hh], xb[2 * hh + 1]};
        const bool fresh = q == 0 && hh == 0;
        w4::mma(part[0], lo, b, fresh);
        w4::mma(part[1], hi, b, fresh);
      }
    }
    const float* sc = reinterpret_cast<const float*>(st.sring + (size_t)k * kSBytes) + warp * 16 +
                      2 * (lane >> 2);
    const float2 slo = *reinterpret_cast<const float2*>(sc);
    const float2 shi = *reinterpret_cast<const float2*>(sc + kTW);
    // the group's end: its f32 sum times its scales (token 0: d[0], d[2] at
    // columns 2g, 2g + 1)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[0][q] = fmaf(part[0][q], q < 2 ? slo.x : slo.y, acc[0][q]);
      acc[1][q] = fmaf(part[1][q], q < 2 ? shi.x : shi.y, acc[1][q]);
    }
    if (i + 1 == e || (i + 1) % pr.Gk == 0) {  // the tile's slice ends: write it
      if ((lane & 3) == 0) {
        float* dst = p.part + (size_t)key * 2 * kTW + warp * 16 + 2 * (lane >> 2);
        dst[0] = acc[0][0];
        dst[1] = acc[0][2];
        dst[kTW] = acc[1][0];
        dst[kTW + 1] = acc[1][2];
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[a][q] = 0.f;
      key = i + 1;
    }
  }
  // arrive at every tile the share touched (one lane a tile, the counts in
  // parallel); the last slice of a tile to arrive sums it
  const int tf = s / pr.Gk, tl = (e - 1) / pr.Gk;
  __threadfence();
  __syncthreads();
  for (int t0 = tf; t0 <= tl; t0 += 32) {
    if (warp == 0) {
      const int t = t0 + lane;
      bool last = false;
      if (t <= tl) {
        int bf;
        const int nc = tile_slices(t * pr.Gk, pr.Gk, W, P, bf);
        last = atomicAdd(p.cnt + t, 1) == nc - 1;
        if (last) p.cnt[t] = 0;  // for the next use, after a grid barrier
      }
      const unsigned m = __ballot_sync(0xffffffffu, last);
      if (lane == 0) *lastmask = m;
    }
    __syncthreads();
    const unsigned m = *lastmask;
    if (m) __threadfence();
    for (unsigned mm = m; mm; mm &= mm - 1)
      reduce_tile(p, ph, pr, hin, t0 + __ffs(mm) - 1, xch, keys);
    __syncthreads();
  }
}

// The shared memory of the attention phase.
struct AttnSmem {
  float qs[kMaxG * 4 * kQPad];  // q (roped, bf16 values), a 32-dim quarter a padded row
  float cr[kMaxG];              // the running max's rescale of a chunk
  float m1[kMaxG], l1[kMaxG];   // the merge's max and sum
  float lf[kMaxG];              // the fresh row's logits
  float ksn, vsn;               // the fresh row's scales
  float kf[kHd], vf[kHd];       // the raw k and v rows, then their int4 values
};

__device__ __forceinline__ int qidx(int g, int d) {
  return g * 4 * kQPad + (d >> 5) * kQPad + (d & 31);
}

// The head's last split: k and v roped and made int4 rows; the splits'
// (m, l, acc) merged in a fixed order (the max; l over the splits by lane
// and tree; acc over each parity of the splits in order, then the two),
// then the fresh row; the output, the packed row and the scales written.
// ml: 2 S G floats of shared memory; xch: G hd floats.
template <int G>
__device__ __forceinline__ void combine(const Params& p, int li, int head, int off, bool fresh_on,
                                        AttnSmem& sa, float* ml, float* xch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = tid & (kHd - 1), half = tid >> 7;
  const int stride = G * (kHd + 2), S = p.S, SG = S * G;
  const float* ap = p.apart + (size_t)head * S * stride;
  // every split's m and l (a skipped split: m -inf, l 0)
  for (int k = tid; k < SG; k += kThreads) {
    const int s = k / G, g = k - s * G;
    const bool skip = s == p.skip_split;
    ml[k] = skip ? -INFINITY : __ldcg(ap + (size_t)s * stride + G * kHd + g);
    ml[SG + k] = skip ? 0.f : __ldcg(ap + (size_t)s * stride + G * kHd + G + g);
  }
  // the fresh row: warp 0 ropes k and makes it int4 (absmax / 7, round half
  // to even, clip), warp 1 the same for v
  if (warp < 2) {
    float x[kHd / 32], mx = 0.f;
#pragma unroll
    for (int j = 0; j < kHd / 32; ++j) {
      const int dd = lane + 32 * j;
      if (warp == 0) {
        const float rv = dd < kHd / 2 ? -sa.kf[dd + kHd / 2] : sa.kf[dd - kHd / 2];
        x[j] = bf16_round(__fadd_rn(__fmul_rn(sa.kf[dd], __ldg(p.cos + dd)),
                                    __fmul_rn(rv, __ldg(p.sin + dd))));
      } else {
        x[j] = sa.vf[dd];
      }
      mx = fmaxf(mx, fabsf(x[j]));
    }
    const float sc = fmaxf(al::warp_max(mx), 1e-8f) / 7.f;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kHd / 32; ++j)
      (warp == 0 ? sa.kf : sa.vf)[lane + 32 * j] = fminf(fmaxf(rintf(x[j] / sc), -7.f), 7.f);
    if (lane == 0) (warp == 0 ? sa.ksn : sa.vsn) = sc;
  }
  __syncthreads();
  if (warp < G) {  // the fresh logit of head g; the max over the splits
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < kHd / 32; ++j) dot += sa.qs[qidx(warp, lane + 32 * j)] * sa.kf[lane + 32 * j];
    dot = al::warp_sum(dot);
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, ml[s * G + warp]);
    m = al::warp_max(m);
    if (lane == 0) {
      sa.lf[warp] = fresh_on ? dot * (sa.ksn * p.scale) : kDead;
      sa.m1[warp] = m;
    }
  }
  __syncthreads();
  for (int k = tid; k < SG; k += kThreads)  // the split's weight
    ml[k] = ml[k] == -INFINITY ? 0.f : expf(ml[k] - sa.m1[k % G]);
  __syncthreads();
  if (warp < G) {
    float l = 0.f;
    for (int s = lane; s < S; s += 32) l += ml[s * G + warp] * ml[SG + s * G + warp];
    l = al::warp_sum(l);
    if (lane == 0) sa.l1[warp] = l;
  }
  // acc: each half of the threads the splits of its parity, in order
  // (their (split, head) pairs kMerge at a time, the loads together)
  float a[G];
#pragma unroll
  for (int g = 0; g < G; ++g) a[g] = 0.f;
  const int np = ((S - half + 1) / 2) * G;  // the half's pairs
  for (int k0 = 0; k0 < np; k0 += kMerge) {
    float v[kMerge];
#pragma unroll
    for (int u = 0; u < kMerge; ++u) {
      const int k = k0 + u, sp = half + 2 * (k / G), g = k % G;
      v[u] = k < np ? __ldcg(ap + (size_t)sp * stride + g * kHd + d) * ml[sp * G + g] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kMerge; ++u) {
      const int g = (k0 + u) % G;
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
        if (g == gg) a[gg] += v[u];
    }
  }
  if (half) {
#pragma unroll
    for (int g = 0; g < G; ++g) xch[g * kHd + d] = a[g];
  }
  __syncthreads();
  if (half) return;
  const float ksn = sa.ksn, vsn = sa.vsn, kq = sa.kf[d], vq = sa.vf[d];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float a1 = a[g] + xch[g * kHd + d], m1 = sa.m1[g], l1 = sa.l1[g], lf = sa.lf[g];
    const float m = fmaxf(m1, lf);
    const float e1 = expf(m1 - m), pf = expf(lf - m);
    const float o = (e1 * a1 + (pf * vsn) * vq) / (e1 * l1 + pf);
    p.attn[(size_t)(head * G + g) * kHd + d] = __float2bfloat16(o);
  }
  const size_t row0 = ((size_t)li * p.Hkv + head) * p.Tk;
  if (off >= 0 && off < p.Tk) {
    p.ckv[(row0 + off) * kHd + d] = (int8_t)((((int)kq + 8) & 0xF) | (((int)vq & 0xF) << 4));
    if (d == 0) {
      p.ks[row0 + off] = ksn;
      p.vs[row0 + off] = vsn;
    }
  }
  if (d == 0) {
    p.fresh[((size_t)li * p.Hkv + head) * 2] = ksn;
    p.fresh[((size_t)li * p.Hkv + head) * 2 + 1] = vsn;
  }
}

// The attention phase of layer li on the block's split (if it has one).
template <int G>
__device__ __forceinline__ void run_attention(const Params& p, Stream& st, int li, int off,
                                              bool fresh_on, int& n, AttnSmem& sa,
                                              unsigned char* aux, float* xch, unsigned* lastmask) {
  const int count = st.cnt[kAttn];
  if (count == 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int head = st.head, split = blockIdx.x % p.S;
  // q, k, v from the planes, rounded to bf16 (one round trip)
#pragma unroll
  for (int i = tid; i < (G + 2) * kHd; i += kThreads) {
    const int j = i / kHd, d = i % kHd;
    const int c = j < G ? (head * G + j) * kHd + d
                        : (p.Hq + (j - G) * p.Hkv + head) * kHd + d;
    const float v = bf16_round(__ldcg(p.qkv_out + c));
    if (j < G)
      sa.qs[qidx(j, d)] = v;
    else
      (j == G ? sa.kf : sa.vf)[d] = v;
  }
  __syncthreads();
  // rope on q in f32, rounded to bf16
  float rope[(kMaxG * kHd + kThreads - 1) / kThreads];
#pragma unroll
  for (int t = 0; t < (G * kHd + kThreads - 1) / kThreads; ++t) {
    const int i = tid + t * kThreads;
    if (i < G * kHd) {
      const int g = i / kHd, d = i % kHd;
      const float rv = d < kHd / 2 ? -sa.qs[qidx(g, d + kHd / 2)] : sa.qs[qidx(g, d - kHd / 2)];
      rope[t] = bf16_round(__fadd_rn(__fmul_rn(sa.qs[qidx(g, d)], __ldg(p.cos + d)),
                                     __fmul_rn(rv, __ldg(p.sin + d))));
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < (G * kHd + kThreads - 1) / kThreads; ++t) {
    const int i = tid + t * kThreads;
    if (i < G * kHd) sa.qs[qidx(i / kHd, i % kHd)] = rope[t];
  }
  __syncthreads();

  // the split's groups, a stage of kChunk at a time: the logits of the
  // chunk's slots, its max and the running max's rescale, p = exp(logit -
  // m) rounded with v_scale to bf16, P V
  float* lg = reinterpret_cast<float*>(aux);  // [G, kChunk 32] logits
  float* pv = lg + kMaxG * kChunk * kSlots;   // [G, kChunk 32] (p * v_scale) in bf16
  float m_run = -INFINITY, l_run = 0.f, acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  const int r = tid >> 3, e8 = tid & 7;            // the logits: slot r, dims [16 e8, + 16)
  const int d = tid & (kHd - 1), half = tid >> 7;  // P V: dim d over the stages of a parity
  for (int i = 0; i < count; ++i) {
    const int c = min(kChunk, st.ng - i * kChunk);  // the chunk's groups
    const int k = st.consume(p, n++);
    const unsigned char* slot = st.ring + (size_t)k * kWBytes;  // rows, unswizzled
    const float* sks = reinterpret_cast<const float*>(st.sring + (size_t)k * kSBytes);
    const float* svs = sks + kChunk * kSlots;
    const int* sval = reinterpret_cast<const int*>(svs + kChunk * kSlots);
    for (int j = 0; j < c; ++j) {
      const int rr = j * kSlots + r;  // the slot in the chunk
      float a[G];
#pragma unroll
      for (int g = 0; g < G; ++g) a[g] = 0.f;
      const uint4 cw = *reinterpret_cast<const uint4*>(slot + rr * kHd + 16 * e8);
      const uint32_t wv[4] = {cw.x, cw.y, cw.z, cw.w};
      const float* qrow = sa.qs + (e8 >> 1) * kQPad + 16 * (e8 & 1);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float kv[4];
#pragma unroll
        for (int b = 0; b < 4; ++b)  // K: the offset-binary low nibble
          kv[b] = (float)((int)((wv[w] >> (8 * b)) & 0xF) - 8);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 q4 = *reinterpret_cast<const float4*>(qrow + g * 4 * kQPad + 4 * w);
          a[g] += q4.x * kv[0];
          a[g] += q4.y * kv[1];
          a[g] += q4.z * kv[2];
          a[g] += q4.w * kv[3];
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        a[g] += __shfl_xor_sync(0xffffffffu, a[g], 1);
        a[g] += __shfl_xor_sync(0xffffffffu, a[g], 2);
        a[g] += __shfl_xor_sync(0xffffffffu, a[g], 4);
      }
      const bool dead = sval[rr] <= 0 || (st.q0 + i * kChunk) * kSlots + rr == off;
      const float f = sks[rr] * p.scale;
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (e8 == g) lg[g * kChunk * kSlots + rr] = dead ? kDead : a[g] * f;
    }
    __syncthreads();
    if (warp < G) {  // warp g: the chunk's max, the rescale, the sum and rounded p of head g
      const float* lgg = lg + warp * kChunk * kSlots;
      float mx = -INFINITY;
      for (int t = lane; t < c * kSlots; t += 32) mx = fmaxf(mx, lgg[t]);
      const float mnew = fmaxf(m_run, al::warp_max(mx));
      const float corr = expf(m_run - mnew);
      float sum = 0.f;
      for (int t = lane; t < c * kSlots; t += 32) {
        const float e = expf(lgg[t] - mnew);
        sum += e;
        pv[warp * kChunk * kSlots + t] = bf16_round(e * svs[t]);
      }
      l_run = l_run * corr + al::warp_sum(sum);
      m_run = mnew;
      if (lane == 0) sa.cr[warp] = corr;
    }
    __syncthreads();
    // P V; V is the signed high nibble
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= sa.cr[g];
    for (int j = half; j < c; j += 2) {
      const unsigned char* col = slot + j * kSlots * kHd + d;
      const float* pj = pv + j * kSlots;
#pragma unroll 4
      for (int s2 = 0; s2 < kSlots; ++s2) {
        const float v = (float)(static_cast<int8_t>(col[s2 * kHd]) >> 4);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += pj[g * kChunk * kSlots + s2] * v;
      }
    }
  }
  // the split's partial (the halves added), then the head's last split merges
  if (half) {
#pragma unroll
    for (int g = 0; g < G; ++g) xch[g * kHd + d] = acc[g];
  }
  __syncthreads();
  const int stride = G * (kHd + 2);
  float* u = p.apart + ((size_t)head * p.S + split) * stride;
  if (!half) {
#pragma unroll
    for (int g = 0; g < G; ++g) u[g * kHd + d] = acc[g] + xch[g * kHd + d];
  }
  if (warp < G && lane == 0) {
    u[G * kHd + warp] = m_run;
    u[G * kHd + G + warp] = l_run;
  }
  int* hc = p.hcnt + head;
  if (!al::last_to_arrive(hc, p.S, reinterpret_cast<int*>(lastmask))) return;
  if (tid == 0) *hc = 0;
  combine<G>(p, li, head, off, fresh_on, sa, reinterpret_cast<float*>(aux), xch);
}

template <int G>
__global__ void __launch_bounds__(kThreads, 2)
    megakernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  extern __shared__ unsigned char dsm_raw[];
  __shared__ __align__(16) AttnSmem sa;
  __shared__ float red[32];
  __shared__ __align__(16) float xch[kMaxG * kHd];  // exchanges between the threads' halves
  __shared__ unsigned lastmask;
  __shared__ int keys[kBatch];
  __shared__ __align__(16) uint4 zrow;
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ FeedPhase fp[kPhases];
  const int tid = threadIdx.x;
  const int P = gridDim.x, b = blockIdx.x;
  const int off = *p.offset;
  const bool fresh_on = off >= 0 && off < p.Tk && p.valid[off] > 0;
  unsigned char* dsm = sm90::align1024(dsm_raw);
  unsigned char* aux = dsm + (size_t)kStages * (kWBytes + kSBytes);

  Stream st;
  st.ring = dsm;
  st.sring = dsm + (size_t)kStages * kWBytes;
  st.full = full;
  st.fp = fp;
  const int ng = p.Tk / kSlots;
  st.head = b / p.S;
  const int split = b % p.S;
  st.q0 = split * ng / p.S;
  st.ng = (split + 1) * ng / p.S - st.q0;
  st.per_layer = 0;
#pragma unroll
  for (int q = 0; q < kPhases; ++q) {
    int c = 0, first = 0;
    if (q != kAttn) first = share_start(b, p.pr[q].W(), P);
    if ((p.phases >> q) & 1) {
      if (q == kAttn)
        c = st.head < p.Hkv ? (st.ng + kChunk - 1) / kChunk : 0;
      else
        c = share_start(b + 1, p.pr[q].W(), P) - first;
    }
    st.cnt[q] = c;
    st.per_layer += c;
    if (tid == 0) {
      const Prod& pr = p.pr[q];
      const int m = q == 0 ? 0 : q - 1;
      fp[q] = FeedPhase{q == kAttn ? nullptr : &maps.m[m], q == kAttn ? nullptr : &maps.s[m],
                        pr.K, pr.Gk, first, c};
    }
  }
  st.total = st.per_layer * p.L;
  st.issued = 0;
  st.c_li = st.c_ph = st.c_i = st.c_tile = st.c_g = 0;
  if (tid == 0) {
    zrow = make_uint4(0u, 0u, 0u, 0u);
    for (int k = 0; k < kStages; ++k) sm90::mbar_init(full + k, 1);
    sm90::mbar_fence_init();
    if (st.total > 0) st.enter_phase();
    for (int k = 0; k < kStages - 1; ++k) st.issue(p);
  }
  __syncthreads();

  int n = 0;          // the next stage to consume
  unsigned nbar = 0;  // barriers passed
  for (int li = 0; li < p.L; ++li) {
    const __nv_bfloat16* hin = li == 0 ? p.x : p.h;
    for (int ph = 0; ph < kPhases; ++ph) {
      if ((p.phases >> ph) & 1) {
        if (ph == kAttn)
          run_attention<G>(p, st, li, off, fresh_on, n, sa, aux, xch, &lastmask);
        else
          run_product(p, st, li, ph, n, hin, aux, &zrow, red, xch, &lastmask, keys);
      }
      if (li + 1 < p.L || ph + 1 < kPhases) grid_sync(p.bar, ++nbar * (unsigned)P);
    }
  }
  // the last block to leave resets the barrier words for the next launch
  if (tid == 0 && atomicAdd(p.bar + 1, 1u) == (unsigned)P - 1) {
    atomicExch(p.bar, 0u);
    atomicExch(p.bar + 1, 0u);
  }
}

const void* kernel_for(int G) {
  switch (G) {
    case 1: return reinterpret_cast<const void*>(megakernel<1>);
    case 2: return reinterpret_cast<const void*>(megakernel<2>);
    case 3: return reinterpret_cast<const void*>(megakernel<3>);
    case 4: return reinterpret_cast<const void*>(megakernel<4>);
    default: return nullptr;
  }
}

// Dynamic shared memory of a block: 1024 bytes to align the ring, the ring
// (the stages' rows, then their scales), then the largest of the products'
// x rows (maxj slots and a D-wide row for the rms), the attention's logits
// and p of a chunk, and the merge's 2 S G floats
// (ops/decode_megakernel.py::smem_bytes repeats this).
size_t smem_need(int maxj, int D, int S, int G) {
  const size_t x = (size_t)maxj * kGroup * 2 + (size_t)D * 2, m = (size_t)S * G * 8;
  const size_t a = 2 * (size_t)kMaxG * kChunk * kSlots * 4;  // lg, pv
  return 1024 + (size_t)kStages * (kWBytes + kSBytes) + std::max(std::max(x, m), a);
}

}  // namespace

// Co-resident blocks of the megakernel for Hq/Hkv = G per SM with `smem`
// bytes of dynamic shared memory (0 when it cannot run).
AL_EXPORT int al_megakernel_blocks_per_sm(int G, int smem) {
  const void* kern = kernel_for(G);
  if (kern == nullptr) return 0;
  // always raise the dynamic limit: the block's static shared memory counts
  // against the default 48 KB too
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, smem) != cudaSuccess)
    return 0;
  return n;
}

// The instance for G with maxj x-row slots, a D-wide row and S timeline
// splits: out = registers, local (spilled) bytes, dynamic shared memory,
// static shared memory, resident blocks per SM, ring slots, threads.
AL_EXPORT int al_megakernel_info(int G, int maxj, int D, int S, void* out) {
  const void* kern = kernel_for(G);
  if (kern == nullptr || maxj < 1 || S < 1) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  const int smem = (int)smem_need(maxj, D, S, G);
  int* o = static_cast<int*>(out);
  o[0] = attr.numRegs;
  o[1] = (int)attr.localSizeBytes;
  o[2] = smem;
  o[3] = (int)attr.sharedSizeBytes;
  o[4] = al_megakernel_blocks_per_sm(G, smem);
  o[5] = kStages;
  o[6] = kThreads;
  return cudaGetLastError();
}

// See the note at the top for the layouts; the slabs are the stacked [L, ...]
// tensors, contiguous and 16-byte aligned (the scales and the cache's scale
// slabs too); scratch: qkv_out f32 [Nq], attn bf16 [Hq hd], act bf16 [F],
// hidden bf16 [D] (the output), fresh f32 [L, Hkv, 2], part f32 [max W, 128],
// apart f32 [Hkv S, G (hd + 2)], cnt int32 [max T + Hkv] zeros (left zero),
// bar: two words, zero at entry (left zero). The plan (grid, S, maxj) is
// ops/decode_megakernel.py::plan's. Requires hd == 128, Hq/Hkv in {1, 2, 3,
// 4}, every K a multiple of 128, every Nh of 64, Tk of 32, Hkv S <= grid and
// the grid co-resident. A refused launch returns its error.
AL_EXPORT int al_decode_megakernel(
    const void* x, const void* iln, const void* pln, const void* cos, const void* sin,
    const void* qkv_p, const void* qkv_s, const void* o_p, const void* o_s, const void* gu_p,
    const void* gu_s, const void* dn_p, const void* dn_s, void* ckv, void* ks, void* vs,
    const void* offset, const void* valid, void* qkv_out, void* attn, void* act, void* hidden,
    void* fresh, void* part, void* apart, void* cnt, void* bar, int L, int D, int F, int Hq,
    int Hkv, int Tk, int hd, int fmt, float eps, float scale, int grid, int S, int maxj,
    int phases, int skip_split, int skip_slice, int stale, void* stream) {
  if (hd != kHd || Hkv <= 0 || Hq % Hkv || D % kGroup || F % kGroup || Tk % kSlots || L < 1)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const void* kern = kernel_for(G);
  const int Nq = (Hq + 2 * Hkv) * kHd;
  if (kern == nullptr || (Nq / 2) % kTW || (D / 2) % kTW || F % kTW || S < 1 ||
      S > Tk / kSlots || Hkv * S > grid || maxj < 1 || (long long)Tk * grid >= (1ll << 31))
    return cudaErrorInvalidValue;
  Params p;
  p.pr[0] = {static_cast<const int8_t*>(qkv_p), static_cast<const float*>(qkv_s), D, Nq / 2,
             Nq / 2 / kTW, D / kGroup};
  p.pr[1] = {nullptr, nullptr, 0, 0, 0, 0};
  p.pr[2] = {static_cast<const int8_t*>(o_p), static_cast<const float*>(o_s), Hq * kHd, D / 2,
             D / 2 / kTW, Hq * kHd / kGroup};
  p.pr[3] = {static_cast<const int8_t*>(gu_p), static_cast<const float*>(gu_s), D, F, F / kTW,
             D / kGroup};
  p.pr[4] = {static_cast<const int8_t*>(dn_p), static_cast<const float*>(dn_s), F, D / 2,
             D / 2 / kTW, F / kGroup};
  Maps maps;
  for (int q = 0, m = 0; q < kPhases; ++q) {  // every share fits the x slots
    if (q == kAttn) continue;
    const Prod& pr = p.pr[q];
    if ((long long)pr.W() * grid >= (1ll << 31) || (pr.W() + grid - 1) / grid > maxj ||
        reinterpret_cast<uintptr_t>(pr.p) % 16 || reinterpret_cast<uintptr_t>(pr.s) % 16 ||
        !sm90::tile_map_2d(&maps.m[m], CU_TENSOR_MAP_DATA_TYPE_UINT8, pr.p, pr.Nh,
                           (long long)L * pr.K, pr.Nh, kTW, kGroup, true) ||
        !sm90::tile_map_2d(&maps.s[m], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, pr.s, pr.Nh,
                           (long long)L * pr.Gk * 2, 4LL * pr.Nh, kTW, 2, false))
      return cudaErrorInvalidValue;
    ++m;
  }
  const size_t smem = smem_need(maxj, D, S, G);
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if ((long long)al_megakernel_blocks_per_sm(G, (int)smem) * sms < grid)
    return cudaErrorCooperativeLaunchTooLarge;

  p.x = static_cast<const __nv_bfloat16*>(x);
  p.iln = static_cast<const __nv_bfloat16*>(iln);
  p.pln = static_cast<const __nv_bfloat16*>(pln);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.ckv = static_cast<int8_t*>(ckv);
  p.ks = static_cast<float*>(ks);
  p.vs = static_cast<float*>(vs);
  p.offset = static_cast<const int*>(offset);
  p.valid = static_cast<const int*>(valid);
  p.qkv_out = static_cast<float*>(qkv_out);
  p.attn = static_cast<__nv_bfloat16*>(attn);
  p.act = static_cast<__nv_bfloat16*>(act);
  p.h = static_cast<__nv_bfloat16*>(hidden);
  p.fresh = static_cast<float*>(fresh);
  p.part = static_cast<float*>(part);
  p.apart = static_cast<float*>(apart);
  p.cnt = static_cast<int*>(cnt);
  int maxT = 0;
  for (int q = 0; q < kPhases; ++q) maxT = std::max(maxT, p.pr[q].T);
  p.hcnt = p.cnt + maxT;
  p.bar = static_cast<unsigned*>(bar);
  p.L = L;
  p.D = D;
  p.F = F;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Tk = Tk;
  p.fmt = fmt;
  p.S = S;
  p.maxj = maxj;
  p.eps = eps;
  p.scale = scale;
  p.phases = phases;
  p.skip_split = skip_split;
  p.skip_slice = skip_slice;
  p.stale = stale;
  void* args[] = {&maps, &p};
  err = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(kThreads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
