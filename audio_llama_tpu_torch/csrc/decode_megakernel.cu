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
// Per layer, as the TPU kernel:
//  (a) every block recomputes rms(h) from the bf16 residual (f32 stats, the
//      normed row rounded to bf16 before the bf16 scale multiply); the q|k|v
//      packed columns are split over the blocks; each column sums its groups
//      in order (per group: the f32 dot of the row with the integer nibbles,
//      times the group's scale) and both planes go out in f32;
//  (b) one block per KV head: q, k, v rounded to bf16 from the planes, rope
//      in f32 rounded to bf16, the k and v rows quantized to int4 (absmax/7,
//      round half to even, clip to [-7, 7]); attention over the slab with the
//      append slot dead and the fresh row entered analytically (the int4-KV
//      decode kernel's softmax: p at the slab's max, merged with the fresh
//      row at the end, P meeting V as (p * v_scale) rounded to bf16); the
//      packed row and its scales are written at the offset after the slab
//      has been read (nothing for an offset outside the cache);
//  (c) o columns over the blocks, then h += bf16(o) for each column;
//  (d) rms(h), gate|up columns over the blocks (gate j and up j share a
//      packed column), then a = bf16(g * sigmoid(g) * u);
//  (e) down columns over the blocks, each summing its F/128 groups in
//      order (the TPU kernel's dn_acc order), then h += bf16(d).
// A grid-wide barrier closes each phase: 5 per layer, 5L - 1 in all. After
// the last layer h is the output.
//
// Bound on the H100: bytes, about 1.54 GB per step at 3B widths (1.409 GB of
// int4 slabs, 88 MB of scales, 45 MB of the int4 cache at 1568 slots):
// ~0.46 ms at 3.35 TB/s. On a TPU one core walks an (L, S) grid and keeps h
// in VMEM between steps; here the blocks of one persistent grid (one block
// per SM, sized by the occupancy API, launched cooperatively so all are
// resident) share h through global memory and meet at a sense-reversing
// barrier on a global counter. Work unit: a tile of 32 packed columns over
// all K rows. Each warp takes whole 128-row groups; its 8 row lanes x 4
// column lanes read 8 rows x 32 bytes a load (full 32-byte sectors, 8 loads
// in flight a thread) and sum their rows by shuffles, so every group's
// partial is one f32 value a column and the cross-group sum runs in order
// in shared memory. Data written inside the launch (the planes, the
// attention output, the activation, h) is read with ld.global.cg, past the
// SM's L1. Not done yet: wgmma/TMA, more than one block per SM, spreading
// the 8 attention blocks' slab reads over idle SMs.
#include <algorithm>

#include "int4_common.cuh"

namespace {

constexpr int kGroup = 128;  // scale group (ops/decode_megakernel.py::ok_for refuses others)

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // packed columns per work tile
constexpr int kHd = 128;   // head_dim == the scale group
constexpr int kMaxG = 4;   // query heads per KV head
constexpr float kDead = -1e30f;

struct Slab {
  const int8_t* p;  // [L, K, Nh] packed
  const float* s;   // [L, K / 128, 2 Nh]
  int K, Nh;
  __device__ const int8_t* packed(int li) const { return p + (size_t)li * K * Nh; }
  __device__ const float* scales(int li) const { return s + (size_t)li * (K / kGroup) * 2 * Nh; }
};

struct Params {
  const __nv_bfloat16 *x, *iln, *pln;
  const float *cos, *sin;
  Slab qkv, o, gu, dn;
  int8_t* ckv;
  float *ks, *vs;
  const int *offset, *valid;
  float* qkv_out;       // [2 Nh_qkv] scratch
  __nv_bfloat16* attn;  // [Hq hd] scratch
  __nv_bfloat16* act;   // [F] scratch
  __nv_bfloat16* h;     // [D] residual, the output
  float* fresh;         // [L, Hkv, 2]
  unsigned* bar;        // [2] arrival count, generation
  int L, D, F, Hq, Hkv, Tk, fmt;
  float eps, scale;
  int barriers_only;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Every block of the (co-resident) grid arrives before any leaves. The
// generation is read before arriving, so it is the pre-release value; the
// last block resets the count, then releases the others by bumping it.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g0) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// xs <- the bf16 scale times rms-normed row of hin (as f32 values of bf16)
__device__ void stage_rms(float* xs, const __nv_bfloat16* hin, const __nv_bfloat16* ln, int D,
                          float eps, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = __bfloat162float(__ldcg(hin + i));
    xs[i] = v;
    ss += v * v;
  }
  const float r = rsqrtf(al::block_sum(ss, red) / (float)D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads)
    xs[i] = bf16_round(__bfloat162float(ln[i]) * bf16_round(xs[i] * r));
  __syncthreads();
}

__device__ void stage_bf16(float* xs, const __nv_bfloat16* v, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) xs[i] = __bfloat162float(__ldcg(v + i));
  __syncthreads();
}

// One tile of xs @ dequant(packed): res[j] for the tile's low-nibble columns
// (j < 32) and high-nibble columns (j >= 32), each the in-order sum over the
// groups of (the group's f32 dot) * (the group's scale).
__device__ void gemv_tile(const float* xs, const int8_t* p, const float* s, int K, int Nh,
                          int tile, int fmt, float* part, float* res) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ct = lane & 3, rl = lane >> 2;  // column lane (8 bytes), row lane
  const int col = tile * kTile + ct * 8;
  const int ng = K / kGroup;
  for (int g = warp; g < ng; g += kWarps) {
    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.f;
    const int8_t* base = p + (size_t)(g * kGroup + rl) * Nh + col;
    const float* xg = xs + g * kGroup + rl;
#pragma unroll 8
    for (int r = 0; r < kGroup / 8; ++r) {
      const uint2 b = __ldg(reinterpret_cast<const uint2*>(base + (size_t)r * 8 * Nh));
      const float xv = xg[8 * r];
      const uint32_t w[2] = {b.x, b.y};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int v = (int)(signed char)((w[i / 4] >> (8 * (i % 4))) & 0xFF);
        acc[i] = fmaf(xv, (float)al::nib_lo(v, fmt), acc[i]);
        acc[8 + i] = fmaf(xv, (float)al::nib_hi(v), acc[8 + i]);
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
    if (rl == 0) {
      const float* sg = s + (size_t)g * 2 * Nh;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        part[g * 64 + ct * 8 + i] = acc[i] * __ldg(sg + col + i);
        part[g * 64 + 32 + ct * 8 + i] = acc[8 + i] * __ldg(sg + Nh + col + i);
      }
    }
  }
  __syncthreads();
  if (tid < 64) {
    float a = 0.f;
    for (int g = 0; g < ng; ++g) a += part[g * 64 + tid];
    res[tid] = a;
  }
  __syncthreads();
}

// h[c] = bf16(base[c] + bf16(res)) for the tile's columns of a D-wide output
__device__ __forceinline__ void residual_tile(const Params& p, const __nv_bfloat16* base,
                                              int Nh, int tile, const float* res) {
  const int tid = threadIdx.x;
  if (tid < 64) {
    const int c = (tid < 32 ? 0 : Nh) + tile * kTile + (tid & 31);
    const float hv = __bfloat162float(__ldcg(base + c));
    p.h[c] = __float2bfloat16(hv + bf16_round(res[tid]));
  }
}

// Phase (b) for KV head kvh.
template <int G>
__device__ void attention_head(const Params& p, int li, int kvh, int off, bool fresh_on,
                               float* sm, float* red) {
  __shared__ float lfs[kMaxG];
  __shared__ float fsc[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Tk = p.Tk, Hq = p.Hq, Hkv = p.Hkv;
  float* qs = sm;                        // [G, hd]; then kf [hd], vf [hd]
  float* kf = qs + G * kHd;
  float* vf = kf + kHd;
  float* logit = vf + kHd;               // [G, Tk], then p
  float* part = logit + (size_t)G * Tk;  // [kWarps, G, hd]

  // q, k, v from the planes, rounded to bf16; rope on q and k in f32,
  // rounded to bf16
  for (int i = tid; i < (G + 2) * kHd; i += kThreads) {
    const int j = i / kHd, d = i % kHd;
    const int c = j < G ? (kvh * G + j) * kHd + d
                        : (Hq + (j - G) * Hkv + kvh) * kHd + d;
    qs[i] = bf16_round(__ldcg(p.qkv_out + c));
  }
  __syncthreads();
  constexpr int kRope = ((kMaxG + 1) * kHd + kThreads - 1) / kThreads;
  float rope[kRope];
#pragma unroll
  for (int t = 0; t < kRope; ++t) {
    const int i = tid + t * kThreads;
    if (i < (G + 1) * kHd) {
      const int d = i % kHd, row = i - d;
      const float rv = d < kHd / 2 ? -qs[row + d + kHd / 2] : qs[row + d - kHd / 2];
      rope[t] = bf16_round(__fadd_rn(__fmul_rn(qs[i], __ldg(p.cos + d)),
                                     __fmul_rn(rv, __ldg(p.sin + d))));
    }
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kRope; ++t) {
    const int i = tid + t * kThreads;
    if (i < (G + 1) * kHd) qs[i] = rope[t];
  }
  __syncthreads();

  // int4 row quantization: warp 0 the k row, warp 1 the v row; kf / vf then
  // hold the integers
  if (warp < 2) {
    float* row = warp == 0 ? kf : vf;
    float mx = 0.f;
    for (int d = lane; d < kHd; d += 32) mx = fmaxf(mx, fabsf(row[d]));
    const float sc = fmaxf(al::warp_max(mx), 1e-8f) / 7.f;
    for (int d = lane; d < kHd; d += 32) row[d] = fminf(fmaxf(rintf(row[d] / sc), -7.f), 7.f);
    if (lane == 0) fsc[warp] = sc;
  }
  __syncthreads();
  const float ksn = fsc[0], vsn = fsc[1];

  // the fresh row's logit, one warp per query head
  if (warp < G) {
    float acc = 0.f;
    for (int d = lane; d < kHd; d += 32) acc += qs[warp * kHd + d] * kf[d];
    acc = al::warp_sum(acc);
    if (lane == 0) lfs[warp] = fresh_on ? acc * (ksn * p.scale) : kDead;
  }

  const size_t row0 = ((size_t)li * Hkv + kvh) * Tk;
  const int8_t* slab = p.ckv + row0 * kHd;
  const float* ksr = p.ks + row0;
  const float* vsr = p.vs + row0;

  // logits: one thread per key row; K is the offset-binary low nibble
  for (int pos = tid; pos < Tk; pos += kThreads) {
    if (p.valid[pos] <= 0 || pos == off) {
#pragma unroll
      for (int g = 0; g < G; ++g) logit[g * Tk + pos] = kDead;
      continue;
    }
    const uint4* krow = reinterpret_cast<const uint4*>(slab + (size_t)pos * kHd);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int c = 0; c < kHd / 16; ++c) {
      const uint4 v = krow[c];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float kv = (float)((int)((w[j / 4] >> (8 * (j % 4))) & 0xF) - 8);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += qs[g * kHd + c * 16 + j] * kv;
      }
    }
    const float f = ksr[pos] * p.scale;
#pragma unroll
    for (int g = 0; g < G; ++g) logit[g * Tk + pos] = acc[g] * f;
  }
  __syncthreads();

  // softmax over the slab per head: p = exp(l - m1) in place, l1 = sum p
  float m1[G], l1[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* lg = logit + (size_t)g * Tk;
    float mx = -INFINITY;
    for (int i = tid; i < Tk; i += kThreads) mx = fmaxf(mx, lg[i]);
    mx = al::block_max(mx, red);
    float sum = 0.f;
    for (int i = tid; i < Tk; i += kThreads) {
      const float e = expf(lg[i] - mx);
      lg[i] = e;
      sum += e;
    }
    m1[g] = mx;
    l1[g] = al::block_sum(sum, red);
  }
  __syncthreads();

  // PV: thread (row group r, 16-byte column c); V is the signed high nibble
  constexpr int kVec = kHd / 16;
  const int c = tid % kVec, r = tid / kVec;
  float acc[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[g][j] = 0.f;
  for (int pos = r; pos < Tk; pos += kThreads / kVec) {
    const uint4 v = reinterpret_cast<const uint4*>(slab + (size_t)pos * kHd)[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float vsc = vsr[pos];
    float vv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      vv[j] = (float)((int)(signed char)((w[j / 4] >> (8 * (j % 4))) & 0xFF) >> 4);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pv = bf16_round(logit[(size_t)g * Tk + pos] * vsc);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[g][j] += pv * vv[j];
    }
  }
#pragma unroll
  for (int o = 16; o >= kVec; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  if (lane < kVec) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 16; ++j) part[((size_t)warp * G + g) * kHd + c * 16 + j] = acc[g][j];
  }
  __syncthreads();

  // merge the fresh row: m = max(m1, lf), out = (a1 acc1 + pf vs_new v_new) / (a1 l1 + pf)
  for (int i = tid; i < G * kHd; i += kThreads) {
    const int g = i / kHd, d = i % kHd;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[((size_t)w * G + g) * kHd + d];
    float mg = 0.f, lg = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg == g) mg = m1[gg], lg = l1[gg];
    const float lf = lfs[g];
    const float m = fmaxf(mg, lf);
    const float a1 = expf(mg - m), pf = expf(lf - m);
    const float o = (a1 * s + (pf * vsn) * vf[d]) / (a1 * lg + pf);
    p.attn[(size_t)(kvh * G) * kHd + i] = __float2bfloat16(o);
  }
  __syncthreads();

  // append the packed row and its scales (after every read of the slab)
  if (off >= 0 && off < Tk) {
    if (tid < kHd) {
      const int kq = (int)kf[tid], vq = (int)vf[tid];
      p.ckv[(row0 + off) * kHd + tid] = (int8_t)(((kq + 8) & 0xF) | ((vq & 0xF) << 4));
    }
    if (tid == 0) {
      p.ks[row0 + off] = ksn;
      p.vs[row0 + off] = vsn;
    }
  }
  if (tid == 0) {
    p.fresh[((size_t)li * Hkv + kvh) * 2] = ksn;
    p.fresh[((size_t)li * Hkv + kvh) * 2 + 1] = vsn;
  }
  __syncthreads();
}

template <int G>
__global__ void __launch_bounds__(kThreads) megakernel(Params p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  __shared__ float res[64];
  const int tid = threadIdx.x;
  const int kmax = max(max(p.D, p.Hq * kHd), p.F);
  float* xs = sm;
  float* part = sm + kmax;  // [K / 128, 64]
  const int off = *p.offset;
  const bool fresh_on = off >= 0 && off < p.Tk && p.valid[off] > 0;
  const bool work = !p.barriers_only;

  for (int li = 0; li < p.L; ++li) {
    const __nv_bfloat16* hin = li == 0 ? p.x : p.h;
    // (a) q|k|v
    const int nq = p.qkv.Nh / kTile;
    if (work && blockIdx.x < nq) {
      stage_rms(xs, hin, p.iln + (size_t)li * p.D, p.D, p.eps, red);
      for (int t = blockIdx.x; t < nq; t += gridDim.x) {
        gemv_tile(xs, p.qkv.packed(li), p.qkv.scales(li), p.D, p.qkv.Nh, t, p.fmt, part, res);
        if (tid < 64) {
          const int j = t * kTile + (tid & 31);
          p.qkv_out[tid < 32 ? j : p.qkv.Nh + j] = res[tid];
        }
      }
    }
    grid_sync(p.bar);
    // (b) attention, one block per KV head
    if (work)
      for (int kvh = blockIdx.x; kvh < p.Hkv; kvh += gridDim.x)
        attention_head<G>(p, li, kvh, off, fresh_on, sm, red);
    grid_sync(p.bar);
    // (c) o, then the residual
    const int no = p.o.Nh / kTile;
    if (work && blockIdx.x < no) {
      stage_bf16(xs, p.attn, p.Hq * kHd);
      for (int t = blockIdx.x; t < no; t += gridDim.x) {
        gemv_tile(xs, p.o.packed(li), p.o.scales(li), p.o.K, p.o.Nh, t, p.fmt, part, res);
        residual_tile(p, hin, p.o.Nh, t, res);
      }
    }
    grid_sync(p.bar);
    // (d) gate|up, then the activation
    const int ngu = p.gu.Nh / kTile;
    if (work && blockIdx.x < ngu) {
      stage_rms(xs, p.h, p.pln + (size_t)li * p.D, p.D, p.eps, red);
      for (int t = blockIdx.x; t < ngu; t += gridDim.x) {
        gemv_tile(xs, p.gu.packed(li), p.gu.scales(li), p.D, p.gu.Nh, t, p.fmt, part, res);
        if (tid < 32) {
          const float g = res[tid], u = res[32 + tid];
          p.act[t * kTile + tid] = __float2bfloat16(g * (1.f / (1.f + expf(-g))) * u);
        }
      }
    }
    grid_sync(p.bar);
    // (e) down, then the residual
    const int nd = p.dn.Nh / kTile;
    if (work && blockIdx.x < nd) {
      stage_bf16(xs, p.act, p.F);
      for (int t = blockIdx.x; t < nd; t += gridDim.x) {
        gemv_tile(xs, p.dn.packed(li), p.dn.scales(li), p.F, p.dn.Nh, t, p.fmt, part, res);
        residual_tile(p, p.h, p.dn.Nh, t, res);
      }
    }
    if (li + 1 < p.L) grid_sync(p.bar);
  }
}

size_t smem_need(int D, int Hq, int F, int G, int Tk) {
  const size_t kmax = (size_t)std::max({D, Hq * kHd, F});
  const size_t gemv = kmax + kmax / 2;
  const size_t attn = (size_t)G * kHd * (1 + kWarps) + 2 * kHd + (size_t)G * Tk;
  return sizeof(float) * (gemv > attn ? gemv : attn);
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

// See the note at the top for the layouts; the slabs are the stacked [L, ...]
// tensors, contiguous and 16-byte aligned; scratch: qkv_out f32 [Nq], attn
// bf16 [Hq hd], act bf16 [F], hidden bf16 [D] (the output), fresh f32
// [L, Hkv, 2]; bar: two int32 words, the first zero at entry (left zero).
// Requires hd == 128, Hq/Hkv in {1, 2, 3, 4}, every K a multiple of 128,
// every Nh of 32, Tk of 32, and `smem` at least the launch's need (checked by
// the Python wrapper and here). A refused cooperative launch returns its
// error.
AL_EXPORT int al_decode_megakernel(
    const void* x, const void* iln, const void* pln, const void* cos, const void* sin,
    const void* qkv_p, const void* qkv_s, const void* o_p, const void* o_s, const void* gu_p,
    const void* gu_s, const void* dn_p, const void* dn_s, void* ckv, void* ks, void* vs,
    const void* offset, const void* valid, void* qkv_out, void* attn, void* act, void* hidden,
    void* fresh, void* bar, int L, int D, int F, int Hq, int Hkv, int Tk, int hd, int fmt,
    float eps, float scale, int smem, int barriers_only, void* stream) {
  if (hd != kHd || Hkv <= 0 || Hq % Hkv || D % kGroup || F % kGroup || Tk % 32)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const void* kern = kernel_for(G);
  const int Nq = (Hq + 2 * Hkv) * kHd;
  if (kern == nullptr || (Nq / 2) % kTile || (D / 2) % kTile || F % kTile ||
      (size_t)smem < smem_need(D, Hq, F, G, Tk))
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (al_megakernel_blocks_per_sm(G, smem) < 1) return cudaErrorCooperativeLaunchTooLarge;

  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.iln = static_cast<const __nv_bfloat16*>(iln);
  p.pln = static_cast<const __nv_bfloat16*>(pln);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.qkv = {static_cast<const int8_t*>(qkv_p), static_cast<const float*>(qkv_s), D, Nq / 2};
  p.o = {static_cast<const int8_t*>(o_p), static_cast<const float*>(o_s), Hq * kHd, D / 2};
  p.gu = {static_cast<const int8_t*>(gu_p), static_cast<const float*>(gu_s), D, F};
  p.dn = {static_cast<const int8_t*>(dn_p), static_cast<const float*>(dn_s), F, D / 2};
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
  p.bar = static_cast<unsigned*>(bar);
  p.L = L;
  p.D = D;
  p.F = F;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Tk = Tk;
  p.fmt = fmt;
  p.eps = eps;
  p.scale = scale;
  p.barriers_only = barriers_only;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(kern, dim3(sms), dim3(kThreads), args, (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
