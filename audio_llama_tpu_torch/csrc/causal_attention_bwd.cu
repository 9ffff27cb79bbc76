// Causal GQA attention backward on wgmma and TMA: dq, and dk / dv.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_dq_kernel (:471) and
// ::_dkv_kernel (:514), each in its tri='always' and tri='never' modes, which
// the custom VJP of causal_mha runs whenever the decoder is differentiated
// (training). Inputs, as the forwards left them: qs (pre-scaled), k, v and
// o's cotangent dO, bf16 [B, T, H, hd] contiguous; the forward's row
// statistics l (denominator) and m (its shift: the row max of the online and
// twopass arms, the bound c of the bounded, dma and dma2 arms; nothing here
// takes m for the max of the keys a block sees) and the prologue's D =
// rowsum(dO * O), [B*Hq, T] f32; the key-padding bias [B, T] f32. Training
// shape: B 2, T 2048 (1500 audio frames + 2 delimiters + 512 text tokens,
// padded), Hq 24, Hkv 8, hd 128; each kernel runs once per decoder layer per
// micro-batch (56 launches a train A step).
//
// For query row i and key j <= i:
//   s = qs_i . k_j + bias_j,  P = exp(s - m_i) / l_i  (0 where l_i == 0),
//   dP = dO_i . v_j,  dS = P (dP - D_i);
//   dq_i = sum_j bf16(dS_ij) k_j                       (dq kernel)
//   dv_j = sum_{g, i} bf16(P_ij) dO_i                   (dkv kernel, over the
//   dk_j = sum_{g, i} bf16(dS_ij) qs_i                   G heads of j's group)
// with f32 sums, as the TPU kernels round P and dS to the input type before
// their products. A key past the diagonal takes s = -1e9 before the exp, as
// the plain version's mask does.
//
// CAUSAL = false is the kernels' tri='never' mode (causal_attention.py:479-490,
// :525-533), which the ring's backward (parallel/ring_kernel.py) runs for
// every hop whose K/V block comes from an earlier shard: dq loops over ALL key
// tiles and dk/dv over ALL query tiles, with no diagonal mask; m, l and D are
// the caller's whole-row statistics (merged over the ring), so P of a hop is
// its share of the whole row's softmax.
//
// Bound on the H100: operations. dq runs 3 and dk/dv 4 products of hd-deep
// tiles over the causal half, 2 hd T (T + 1) / 2 FLOP per product and head:
// 77.3 and 103.1 GFLOP at the training shape, 0.0782 and 0.1043 ms at 989
// TFLOP/s; the bytes (about 92 and 88 MB) take 0.03 ms. 'never' (all T^2
// pairs): 0.0391 and 0.0521 ms at the sp = 2 hop (B 2, T 1024). The exps do
// not bind: each score costs 4 hd = 512 FLOP of tensor work against one exp.
//
// The first version (WMMA 16x16x16 from shared memory, S and dP stored
// there as f32 and read back, P and dS rounded through shared memory, K/V or
// Q/dO tiles copied between two __syncthreads, 64-row blocks of four warps)
// ran each kernel at ~69 TFLOP/s, 7% of the peak. This design is the
// forwards' block (sm90.cuh) with two fixed tiles and a ring of two streamed
// tiles and a slot of f32 rows:
//   - dq: a block owns 128 queries of one (b, q head): two consumer
//     warpgroups of 64 rows and a producer warpgroup whose first thread
//     issues TMA (setmaxnreg: 240 / 24 registers). Q and dO land once; K, V
//     and the keys' bias stream through a three-deep ring of 64-key stages
//     behind full and empty mbarriers (causal: the tiles at or below the
//     block's diagonal). Each thread keeps m, 1/l and D of its two rows in
//     registers. Per key tile: S = Q K^T and dP = dO V^T (wgmma SS, one
//     commit), then P and dS in registers (the mask only on the tile that
//     reaches past the warpgroup's first row), dS packed to bf16 pairs in the
//     accumulator layout, which is wgmma's register A: dQ += dS K (RS, K
//     through the transpose bit). dQ stays in registers (64 f32 at hd 128).
//   - dk/dv: a block owns 128 keys of one (b, KV head), 64 per consumer
//     warpgroup, so keys are the wgmma's rows. K and V land once; for each
//     query head of the group, the query tiles (64 queries) at or past the
//     diagonal stream Q, dO and their m, l and D (1-D TMA into the stage's
//     slot). Per step: S^T = K Q^T and dP^T = V dO^T (SS), P^T and dS^T in
//     registers (each column's m, 1/l, D read from the slot; the key bias is
//     two registers for the block's life), then dV += bf16(P^T) dO and dK +=
//     bf16(dS^T) Q (RS, dO and Q through the transpose bit). dK and dV stay
//     in registers (128 f32 at hd 128); warpgroup 1 skips the first tile of
//     each head, which lies wholly before its keys.
//   - no tile goes through shared memory between products; a step's
//     products retire before its stage is released and no instruction writes
//     an accumulator while a wgmma is in flight (ptxas would serialize it);
//     the two consumer warpgroups interleave on the tensor cores;
//   - blocks run longest first (dq: the highest query tile; dk/dv: the
//     lowest key tile), so the causal half does not leave a tail;
//   - the exp is __expf of s - m (one subtraction before the exp, so a row
//     whose shift and keys all sit near -1e9 keeps the plain version's p);
//     1/l is correctly rounded (__frcp_rn), as the plain version divides.
// Every sum stays inside one block in a fixed order (no atomics), so dq, dk
// and dv are the same on every run. hd 16, 32, 64 and 128; T a multiple of
// 128.
//
// Where it stands (H100 80GB HBM3, 700 W; scripts/bwd_timing.py, CUPTI): at
// B 2, T 2048 dq 0.179 ms (432 TFLOP/s, 2.3x its operations bound) and dk/dv
// 0.294 ms (350 TFLOP/s, 2.8x), 6.2x and 5.1x the WMMA version; together
// 1.2x SDPA's backward (0.39 ms, which runs 5 products where these run 7). At
// B 8 0.699 and 1.145 ms; 'never' at the hop 0.087 and 0.150 ms (2.2x and
// 2.9x the bound). Measured and not kept: dq with tile j+1's S and dP issued
// ahead of tile j's dS (ptxas spilled 8 bytes; 0.186 against 0.179 ms), and
// dk/dv in 64-key blocks of one consumer warpgroup at 232 registers, two
// blocks an SM (3-5% faster in the causal mode, no faster in 'never', and
// wrong at hd 128: two launches differed).
#include <initializer_list>

#include "sm90.cuh"

namespace al {
namespace bwd {

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;  // a block's fixed rows: queries (dq) or keys (dk/dv)
constexpr int kStep = 64;   // a ring step's rows: keys (dq) or queries (dk/dv)
constexpr int STAGES = 3;

struct Params {
  const bf16* q;  // pre-scaled
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* l;
  const float* m;
  const float* d;
  const float* key_bias;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, T, Hq, Hkv;
};

// The tensor maps of a launch: the two fixed tiles (dq: Q, dO; dk/dv: K, V)
// in boxes of kRows rows, the two streamed ones (dq: K, V; dk/dv: Q, dO) in
// boxes of kStep rows, and up to three f32 rows in boxes of kStep values (dq:
// the key bias; dk/dv: m, l, D).
struct Maps {
  CUtensorMap fa, fb, sa, sb, rows[3];
};

// The block's shared memory (from a 1024-byte boundary): the two fixed tiles,
// which land once on fixed_full; STAGES stages of two streamed tiles and a
// 1024-byte slot of f32 rows (kStep values each, 256 bytes apart); then the
// mbarriers: fixed_full, full[STAGES] (the producer's arrival and the TMA
// bytes) and empty[STAGES] (every consumer thread's). Ring step `it` uses
// stage it % STAGES.
template <int HD>
struct Ring {
  using FT = sm90::RowTile<HD, kRows>;
  using ST = sm90::RowTile<HD, kStep>;
  static constexpr size_t kStage = 2 * ST::BYTES + 1024;
  static constexpr size_t kBars = 2 * FT::BYTES + STAGES * kStage;
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * STAGES) + 1024;  // + base alignment

  unsigned char* smem;
  uint64_t* fixed_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Ring(unsigned char* raw)
      : smem(sm90::align1024(raw)),
        fixed_full(reinterpret_cast<uint64_t*>(smem + kBars)),
        full(fixed_full + 1),
        empty(fixed_full + 1 + STAGES) {}

  __device__ unsigned char* fixed(int t) const { return smem + t * FT::BYTES; }
  // warpgroup wg's 64 rows of fixed tile t
  __device__ uint32_t fixed_rows(int t, int wg) const {
    return sm90::smem_u32(fixed(t)) + 64 * wg * FT::ROW_BYTES;
  }
  __device__ unsigned char* tile(int s, int t) const {
    return smem + 2 * FT::BYTES + s * kStage + t * ST::BYTES;
  }
  __device__ uint32_t tile_u32(int s, int t) const { return sm90::smem_u32(tile(s, t)); }
  // the stage's f32 row r (kStep values)
  __device__ float* slot(int s, int r) const {
    return reinterpret_cast<float*>(tile(s, 2)) + r * kStep;
  }

  // Thread 0 initializes the barriers, then the block syncs.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      sm90::mbar_init(fixed_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        sm90::mbar_init(&full[s], 1);
        sm90::mbar_init(&empty[s], 2 * 128);
      }
      sm90::mbar_fence_init();
    }
    __syncthreads();
  }
  // Producer: the fixed tiles <- rows row0.. of head h of batch b.
  __device__ void load_fixed(const Maps& mp, int h, int row0, int b) const {
    sm90::mbar_arrive_tx(fixed_full, 2 * FT::BYTES);
    for (int cb = 0; cb < FT::NCB; ++cb) {
      const int c0 = cb * FT::CB;
      sm90::tma_load_4d(fixed(0) + cb * FT::CB_BYTES, &mp.fa, fixed_full, c0, h, row0, b);
      sm90::tma_load_4d(fixed(1) + cb * FT::CB_BYTES, &mp.fb, fixed_full, c0, h, row0, b);
    }
  }
  // Producer: ring step `it` <- rows row0.. of head h of batch b, and kStep
  // values from element c of each of the first n f32 row maps.
  __device__ void load(int it, const Maps& mp, int h, int row0, int b, int n, int c) const {
    const int s = it % STAGES;
    sm90::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    sm90::mbar_arrive_tx(&full[s], 2 * ST::BYTES + n * kStep * 4);
    for (int cb = 0; cb < ST::NCB; ++cb) {
      const int c0 = cb * ST::CB;
      sm90::tma_load_4d(tile(s, 0) + cb * ST::CB_BYTES, &mp.sa, &full[s], c0, h, row0, b);
      sm90::tma_load_4d(tile(s, 1) + cb * ST::CB_BYTES, &mp.sb, &full[s], c0, h, row0, b);
    }
    for (int r = 0; r < n; ++r)
      sm90::tma_load_1d(slot(s, r), &mp.rows[r], &full[s], c);
  }
  // Consumer: wait for ring step it's tiles; its stage.
  __device__ int acquire(int it) const {
    const int s = it % STAGES;
    sm90::mbar_wait(&full[s], (it / STAGES) & 1);
    return s;
  }
  // Consumer: ring step it's stage may be refilled.
  __device__ void release(int it) const { sm90::mbar_arrive(&empty[it % STAGES]); }
};

__device__ __forceinline__ float inv_or_zero(float l) { return l > 0.f ? __frcp_rn(l) : 0.f; }

// The thread's two rows of an m64n(HD) accumulator as bf16 at dst0 / dst1
// (the rows' first values), at its columns (cq: its first in each group of 8).
template <int HD>
__device__ __forceinline__ void store_acc(const float (&a)[HD / 2], bf16* dst0, bf16* dst1,
                                          int cq) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(dst0 + 8 * j + cq) =
        __floats2bfloat162_rn(a[4 * j], a[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst1 + 8 * j + cq) =
        __floats2bfloat162_rn(a[4 * j + 2], a[4 * j + 3]);
  }
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(sm90::kAttnThreads, 1)
    dq_kernel(const __grid_constant__ Maps mp, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<HD> ring(smem_raw);
  const sm90::AttnPlace at(p.T, p.Hq, p.Hkv, p.B);
  const int nt = p.T / kStep;
  const int nv = CAUSAL ? at.q0 / kStep + 2 : nt;  // the block's key tiles
  ring.init();

  if (at.wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 256) {
      ring.load_fixed(mp, at.h, at.q0, at.b);
      for (int j = 0; j < nv; ++j)
        ring.load(j, mp, at.kvh, j * kStep, at.b, 1, at.b * p.T + j * kStep);
    }
    return;
  }

  sm90::regs_inc<240>();
  const int n = CAUSAL ? at.wrow / kStep + 1 : nt;  // this warpgroup's tiles
  const long long stat = (long long)at.bh * p.T;
  const float m0 = p.m[stat + at.row0], m1 = p.m[stat + at.row1];
  const float il0 = inv_or_zero(p.l[stat + at.row0]), il1 = inv_or_zero(p.l[stat + at.row1]);
  const float d0 = p.d[stat + at.row0], d1 = p.d[stat + at.row1];
  const uint32_t sq = ring.fixed_rows(0, at.wg), sdo = ring.fixed_rows(1, at.wg);

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
  float s[kStep / 2], dp[kStep / 2];
  uint32_t ds[kStep / 4];

  sm90::mbar_wait(ring.fixed_full, 0);
  for (int j = 0; j < n; ++j) {
    const int st = ring.acquire(j);
    sm90::wgmma_fence();
    sm90::issue_qk<HD, kRows, kStep>(s, sq, ring.tile_u32(st, 0));    // S = Q K^T
    sm90::issue_qk<HD, kRows, kStep>(dp, sdo, ring.tile_u32(st, 1));  // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::keep(s);
    sm90::keep(dp);
    const bool mask = CAUSAL && j * kStep + kStep - 1 > at.wrow;
    const float* bias = ring.slot(st, 0);
#pragma unroll
    for (int i = 0; i < kStep / 2; i += 2) {
      const float2 x = sm90::logits<kStep>(s, i, j, mask, bias, at);
      const bool second = i & 2;
      const float mm = second ? m1 : m0, il = second ? il1 : il0, dd = second ? d1 : d0;
      const float p0 = __expf(x.x - mm) * il, p1 = __expf(x.y - mm) * il;
      ds[i / 2] =
          sm90::bf16_pair(__floats2bfloat162_rn(p0 * (dp[i] - dd), p1 * (dp[i + 1] - dd)));
    }
    sm90::wgmma_fence();
    sm90::issue_pv<HD, kStep>(dq, ds, ring.tile_u32(st, 0));  // dQ += dS K
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();  // retired: the stage is free, dS may be rewritten
    sm90::keep(dq);
    sm90::keep(ds);
    ring.release(j);
  }
  for (int j = n; j < nv; ++j) {  // a tile past this warpgroup's rows: release it
    ring.acquire(j);
    ring.release(j);
  }
  const long long st_row = (long long)p.Hq * HD;
  bf16* out = p.dq + (long long)at.b * p.T * st_row + at.h * HD;
  store_acc<HD>(dq, out + at.row0 * st_row, out + at.row1 * st_row, at.cq);
}

template <int HD, bool CAUSAL>
__global__ void __launch_bounds__(sm90::kAttnThreads, 1)
    dkv_kernel(const __grid_constant__ Maps mp, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const Ring<HD> ring(smem_raw);
  const int BH = p.B * p.Hkv, G = p.Hq / p.Hkv;
  const int k0 = (int)blockIdx.x / BH * kRows;  // key tile 0 meets every query tile: first
  const int b = (int)blockIdx.x % BH / p.Hkv, kvh = (int)blockIdx.x % p.Hkv;
  const int nt = p.T / kStep, first = CAUSAL ? k0 / kStep : 0;  // a head's query tiles
  const int wg = threadIdx.x / 128;
  ring.init();

  if (wg == 2) {  // producer
    sm90::regs_dec<24>();
    if (threadIdx.x == 256) {
      ring.load_fixed(mp, kvh, k0, b);
      for (int g = 0, it = 0; g < G; ++g) {
        const int h = kvh * G + g, c = (b * p.Hq + h) * p.T;
        for (int qt = first; qt < nt; ++qt, ++it)
          ring.load(it, mp, h, qt * kStep, b, 3, c + qt * kStep);
      }
    }
    return;
  }

  sm90::regs_inc<240>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int wkey = k0 + 64 * wg;  // this warpgroup's first key
  const int row0 = wkey + 16 * warp + (lane >> 2), row1 = row0 + 8, cq = (lane & 3) * 2;
  const float bias0 = p.key_bias[(long long)b * p.T + row0];
  const float bias1 = p.key_bias[(long long)b * p.T + row1];
  const uint32_t sk = ring.fixed_rows(0, wg), sv = ring.fixed_rows(1, wg);

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[kStep / 2], dp[kStep / 2];
  uint32_t pb[kStep / 4], ds[kStep / 4];

  sm90::mbar_wait(ring.fixed_full, 0);
  for (int g = 0, it = 0; g < G; ++g) {
    for (int qt = first; qt < nt; ++qt, ++it) {
      const int st = ring.acquire(it);
      const int q0 = qt * kStep;
      if (CAUSAL && q0 < wkey) {  // every query before this warpgroup's keys
        ring.release(it);
        continue;
      }
      sm90::wgmma_fence();
      sm90::issue_qk<HD, kRows, kStep>(s, sk, ring.tile_u32(st, 0));   // S^T = K Q^T
      sm90::issue_qk<HD, kRows, kStep>(dp, sv, ring.tile_u32(st, 1));  // dP^T = V dO^T
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::keep(s);
      sm90::keep(dp);
      const bool mask = CAUSAL && q0 == wkey;  // the diagonal tile
      const float *sm = ring.slot(st, 0), *sl = ring.slot(st, 1), *sd = ring.slot(st, 2);
#pragma unroll
      for (int jj = 0; jj < kStep / 8; ++jj) {  // the thread's query pair 8 jj + cq + {0, 1}
        const int col = 8 * jj + cq;
        const float2 m = *reinterpret_cast<const float2*>(sm + col);
        const float2 l = *reinterpret_cast<const float2*>(sl + col);
        const float2 d = *reinterpret_cast<const float2*>(sd + col);
        const float il0 = inv_or_zero(l.x), il1 = inv_or_zero(l.y);
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // the thread's two keys
          const int i = 4 * jj + 2 * r, key = r ? row1 : row0;
          const float bias = r ? bias1 : bias0;
          const float x0 = mask && key > q0 + col ? kNeg : s[i] + bias;
          const float x1 = mask && key > q0 + col + 1 ? kNeg : s[i + 1] + bias;
          const float p0 = __expf(x0 - m.x) * il0, p1 = __expf(x1 - m.y) * il1;
          pb[i / 2] = sm90::bf16_pair(__floats2bfloat162_rn(p0, p1));
          ds[i / 2] = sm90::bf16_pair(
              __floats2bfloat162_rn(p0 * (dp[i] - d.x), p1 * (dp[i + 1] - d.y)));
        }
      }
      sm90::wgmma_fence();
      sm90::issue_pv<HD, kStep>(dv, pb, ring.tile_u32(st, 1));  // dV += P^T dO
      sm90::issue_pv<HD, kStep>(dk, ds, ring.tile_u32(st, 0));  // dK += dS^T Q
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();  // retired: the stage is free, P and dS may be rewritten
      sm90::keep(dv);
      sm90::keep(dk);
      sm90::keep(pb);
      sm90::keep(ds);
      ring.release(it);
    }
  }
  const long long st_row = (long long)p.Hkv * HD;
  const long long base = (long long)b * p.T * st_row + kvh * HD;
  store_acc<HD>(dk, p.dk + base + row0 * st_row, p.dk + base + row1 * st_row, cq);
  store_acc<HD>(dv, p.dv + base + row0 * st_row, p.dv + base + row1 * st_row, cq);
}

using Kernel = void (*)(Maps, Params);

template <int HD, bool CAUSAL>
Kernel kernel(bool is_dq) {
  return is_dq ? &dq_kernel<HD, CAUSAL> : &dkv_kernel<HD, CAUSAL>;
}

template <int HD>
cudaError_t launch(const Params& p, bool is_dq, bool causal, cudaStream_t stream) {
  Maps mp{};
  const long long hq = (long long)p.Hq * HD, hkv = (long long)p.Hkv * HD;
  const long long n_stats = (long long)p.B * p.Hq * p.T;
  bool ok;
  if (is_dq)
    ok = sm90::rows_map(&mp.fa, p.q, HD, p.Hq, p.T, p.B, HD, hq, hq * p.T, kRows) &&
         sm90::rows_map(&mp.fb, p.dout, HD, p.Hq, p.T, p.B, HD, hq, hq * p.T, kRows) &&
         sm90::rows_map(&mp.sa, p.k, HD, p.Hkv, p.T, p.B, HD, hkv, hkv * p.T, kStep) &&
         sm90::rows_map(&mp.sb, p.v, HD, p.Hkv, p.T, p.B, HD, hkv, hkv * p.T, kStep) &&
         sm90::f32_map_1d(&mp.rows[0], p.key_bias, (long long)p.B * p.T, kStep);
  else
    ok = sm90::rows_map(&mp.fa, p.k, HD, p.Hkv, p.T, p.B, HD, hkv, hkv * p.T, kRows) &&
         sm90::rows_map(&mp.fb, p.v, HD, p.Hkv, p.T, p.B, HD, hkv, hkv * p.T, kRows) &&
         sm90::rows_map(&mp.sa, p.q, HD, p.Hq, p.T, p.B, HD, hq, hq * p.T, kStep) &&
         sm90::rows_map(&mp.sb, p.dout, HD, p.Hq, p.T, p.B, HD, hq, hq * p.T, kStep) &&
         sm90::f32_map_1d(&mp.rows[0], p.m, n_stats, kStep) &&
         sm90::f32_map_1d(&mp.rows[1], p.l, n_stats, kStep) &&
         sm90::f32_map_1d(&mp.rows[2], p.d, n_stats, kStep);
  if (!ok) return cudaErrorInvalidValue;
  const auto k = causal ? kernel<HD, true>(is_dq) : kernel<HD, false>(is_dq);
  constexpr size_t smem = Ring<HD>::kSmem;
  cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return err;
  const int blocks = p.T / kRows * p.B * (is_dq ? p.Hq : p.Hkv);
  k<<<blocks, sm90::kAttnThreads, smem, stream>>>(mp, p);
  return cudaGetLastError();
}

inline int run(const void* q, const void* k, const void* v, const void* dout, const void* l,
               const void* m, const void* d, const void* key_bias, void* dq, void* dk, void* dv,
               int B, int T, int Hq, int Hkv, int hd, int causal, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || T % kRows != 0) return cudaErrorInvalidValue;
  for (const void* t : {q, k, v, dout, l, m, d, key_bias})  // TMA: 16-byte aligned bases
    if (reinterpret_cast<uintptr_t>(t) % 16) return cudaErrorInvalidValue;
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.l = static_cast<const float*>(l);
  p.m = static_cast<const float*>(m);
  p.d = static_cast<const float*>(d);
  p.key_bias = static_cast<const float*>(key_bias);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  const bool is_dq = dq != nullptr;
  return sm90::with_hd(hd, [&](auto c) {
    return launch<decltype(c)::value>(p, is_dq, causal != 0, static_cast<cudaStream_t>(stream));
  });
}

}  // namespace bwd

cudaError_t bwd_sm90_info(int hd, bool dq, bool causal, int* out) {
  return sm90::with_hd(hd, [&](auto c) {
    constexpr int HD = decltype(c)::value;
    const auto k = causal ? bwd::kernel<HD, true>(dq) : bwd::kernel<HD, false>(dq);
    return sm90::kernel_info(k, sm90::kAttnThreads, bwd::Ring<HD>::kSmem, out);
  });
}

}  // namespace al

// q (pre-scaled), dout, dq: [B, T, Hq, hd] bf16; k, v: [B, T, Hkv, hd] bf16;
// l, m, d: [B*Hq, T] f32; key_bias: [B, T] f32. All contiguous with 16-byte
// aligned bases, T % 128 == 0. causal: 1 for tri='always', 0 for tri='never'
// (a ring hop, global m, l, d).
AL_EXPORT int al_causal_attention_dq(const void* q, const void* k, const void* v,
                                     const void* dout, const void* l, const void* m,
                                     const void* d, const void* key_bias, void* dq, int B,
                                     int T, int Hq, int Hkv, int hd, int causal,
                                     void* stream) {
  if (dq == nullptr) return cudaErrorInvalidValue;
  return al::bwd::run(q, k, v, dout, l, m, d, key_bias, dq, nullptr, nullptr, B, T, Hq, Hkv, hd,
                      causal, stream);
}

// dk, dv: [B, T, Hkv, hd] bf16, summed over the G query heads of each group.
AL_EXPORT int al_causal_attention_dkv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* l, const void* m,
                                      const void* d, const void* key_bias, void* dk, void* dv,
                                      int B, int T, int Hq, int Hkv, int hd, int causal,
                                      void* stream) {
  if (dk == nullptr || dv == nullptr) return cudaErrorInvalidValue;
  return al::bwd::run(q, k, v, dout, l, m, d, key_bias, nullptr, dk, dv, B, T, Hq, Hkv, hd,
                      causal, stream);
}
