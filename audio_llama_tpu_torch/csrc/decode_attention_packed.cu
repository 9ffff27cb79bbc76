// Timeline-chunked single-token decode attention with an online softmax
// across chunks, appending the fresh row in place.
//
// Replaces audio_llama_tpu/ops/decode_attention_packed.py::_kernel
// (decode_attention_packed on a bf16/f32 cache, and with quantized=True
// decode_attention_quantized_packed on an int8 cache with per-row f32
// scales): `attn_impl='decode_packed'`. The timeline of S slots is cut into
// NC chunks of CH slots (ops/decode_attention_packed.py::pick_chunk). As the
// TPU kernel computes it, for each (batch row, KV head, query head g) and
// each chunk c in order, with the fresh row standing at `offset`:
//   s = (q . k) * scale, or * (k_scale * scale); -1e30 where valid <= 0;
//   m_c = max(m_{c-1}, max s)   (m_{-1} = -1e30), alpha = exp(m_{c-1} - m_c);
//   p = valid ? exp(round_cdt(s - m_c)) rounded to cdt : 0, cdt = q's dtype;
//   l = alpha * l + sum p (f32);
//   acc = alpha * acc + sum (p, or round_cdt(p * v_scale)) * v;
//   after the last chunk, out = acc / l in q's dtype.
// A chunk whose every slot is invalid contributes exactly 0.
//
// Bound on the H100: bytes. Every valid row of the (b, head) timelines is
// read once (K and V: 4 hd bytes a row in bf16, 2 hd + 8 in int8): at S =
// 3040, 8 KV heads, B = 1, bf16: 12.5 MB a layer (3.7 us at 3.35 TB/s).
// Design: the TPU kernel walks the chunks in order inside one program; here
// the chunks run in parallel, one block per (chunk, KV head, batch row),
// NC x Hkv x B blocks (152 at B = 1, S = 3040: the db kernel fills 8), and
// the running max that the TPU kernel rounds p against is rebuilt exactly:
//   launch 1 (logits): each block reads its chunk's K rows once for the G
//     query heads of its KV head, writes the f32 logits s [B, Hkv, G, S] and
//     each head's chunk max [B, Hkv, G, NC];
//   launch 2 (PV): each block takes m_c as the max over the chunk maxima
//     0..c, forms p and its chunk's sum and P.V partials from its V rows,
//     and the last block of a (b, KV head) to finish (an atomic count, as
//     int4_matmul.cu's split sums) chains the partials in chunk order with
//     the TPU kernel's alpha rescaling and writes out.
// So p is rounded against the same max as on the TPU, and the result differs
// from the plain version only in the order of f32 sums. The owner chunk's
// block writes the fresh K and V rows into the cache in launch 2, after
// launch 1 has read every K row and after its own V reads.
#include "decode_rows.cuh"

namespace {

using al::CacheElem;
using al::Vec16;
using al::kCacheT;
using al::kInt8;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kDead = -1e30f;  // an invalid lane's logit and the initial running max

struct Args {
  const void *q, *k_new, *v_new, *ks_new, *vs_new;
  void *ck, *cv;
  const void *ks, *vs, *valid;
  int layer, scale_layer, off, B, Hkv, S, hd, CH;
  float scale;
  float *s, *cmax, *wl, *wacc;  // workspace: logits, chunk maxima, partial l and P.V
  int* counters;                // B * Hkv zeros, reset by the merging block
  void* out;
  cudaStream_t stream;
};

// launch 1: the logits of one (chunk, KV head, batch row) for its G heads
template <typename T, int F, int G>
__global__ void __launch_bounds__(kThreads) packed_logits_kernel(Args a) {
  using E = typename CacheElem<T, F>::type;
  constexpr int N = Vec16<E>::N;
  extern __shared__ __align__(16) float sm[];
  const int hd = a.hd, CH = a.CH, S = a.S;
  float* qs = sm;            // [G, hd]
  float* s = qs + G * hd;    // [G, CH]
  __shared__ float red[32];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = gridDim.x;
  const int tid = threadIdx.x;
  const int nvec = hd / N;  // 16-byte vectors a row; divides 32 (checked by the wrapper)
  const int sub = tid % nvec, r0 = tid / nvec, rpp = blockDim.x / nvec;
  const size_t bh = (size_t)b * a.Hkv + h;
  const E* kslab = static_cast<const E*>(a.ck) + ((size_t)a.layer * a.B * a.Hkv + bh) * S * hd;
  const E* kfresh = static_cast<const E*>(a.k_new) + bh * hd;
  const float* ks = static_cast<const float*>(a.ks) +
                    ((size_t)a.scale_layer * a.B * a.Hkv + bh) * S;
  const int* vrow = static_cast<const int*>(a.valid) + (size_t)b * S;
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.Hkv * G + (size_t)h * G) * hd;
  const int c0 = c * CH;

  for (int i = tid; i < G * hd; i += blockDim.x) qs[i] = al::to_f32(q[i]);
  __syncthreads();

  // nvec lanes per row, 16 bytes each; a warp's rows all pass or all fail
  // `j < CH` (CH is a multiple of 32), so every lane joins the shuffles
  for (int j = r0; j < CH; j += rpp) {
    const int pos = c0 + j;
    const bool ok = vrow[pos] > 0, fresh = pos == a.off;
    Vec16<E> kv = {};
    if (ok) kv = reinterpret_cast<const Vec16<E>*>(fresh ? kfresh : kslab + (size_t)pos * hd)[sub];
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float kf = al::key_of<F>(kv.v[e]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += qs[g * hd + sub * N + e] * kf;
    }
    for (int o = nvec >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], o);
    }
    if (sub == 0) {
      float f = a.scale;
      if constexpr (F != kCacheT)
        f = (fresh ? static_cast<const float*>(a.ks_new)[bh] : ks[pos]) * a.scale;
#pragma unroll
      for (int g = 0; g < G; ++g) s[g * CH + j] = ok ? acc[g] * f : kDead;
    }
  }
  __syncthreads();

#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int j = tid; j < CH; j += blockDim.x) mx = fmaxf(mx, s[g * CH + j]);
    mx = al::block_max(mx, red);
    if (tid == 0) a.cmax[(bh * G + g) * NC + c] = mx;
  }
  for (int i = tid; i < G * CH; i += blockDim.x) {
    const int g = i / CH, j = i % CH;
    a.s[(bh * G + g) * S + c0 + j] = s[i];
  }
}

// launch 2: p, l and P.V of one (chunk, KV head, batch row); the last block
// of each (batch row, KV head) merges the chunks
template <typename T, int F, int G>
__global__ void __launch_bounds__(kThreads) packed_pv_kernel(Args a) {
  using E = typename CacheElem<T, F>::type;
  constexpr int N = Vec16<E>::N;
  extern __shared__ __align__(16) float sm[];
  const int hd = a.hd, CH = a.CH, S = a.S;
  float* p = sm;                   // [G, CH]: p, then what meets V
  float* part = p + G * CH;        // [kWarps, G, hd]
  __shared__ float red[32];
  __shared__ float msh[G], lsh[G];
  __shared__ int flag;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, NC = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = hd / N;
  const int sub = tid % nvec, r0 = tid / nvec, rpp = blockDim.x / nvec;
  const size_t bh = (size_t)b * a.Hkv + h;
  const size_t row0 = ((size_t)a.layer * a.B * a.Hkv + bh) * S;
  E* kslab = static_cast<E*>(a.ck) + row0 * hd;
  E* vslab = static_cast<E*>(a.cv) + row0 * hd;
  const E* kfresh = static_cast<const E*>(a.k_new) + bh * hd;
  const E* vfresh = static_cast<const E*>(a.v_new) + bh * hd;
  const float* vs = static_cast<const float*>(a.vs) +
                    ((size_t)a.scale_layer * a.B * a.Hkv + bh) * S;
  const int* vrow = static_cast<const int*>(a.valid) + (size_t)b * S;
  const int c0 = c * CH;

  // the running max after this chunk: over the chunk maxima 0..c
  if (tid < G) {
    float m = kDead;
    for (int cc = 0; cc <= c; ++cc) m = fmaxf(m, a.cmax[(bh * G + tid) * NC + cc]);
    msh[tid] = m;
  }
  __syncthreads();
  for (int i = tid; i < G * CH; i += blockDim.x) {
    const int g = i / CH, pos = c0 + i % CH;
    float e = 0.f;
    if (vrow[pos] > 0)
      e = al::round_to<T>(expf(al::round_to<T>(a.s[(bh * G + g) * S + pos] - msh[g])));
    p[i] = e;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float sum = 0.f;
    for (int j = tid; j < CH; j += blockDim.x) sum += p[g * CH + j];
    sum = al::block_sum(sum, red);
    if (tid == 0) lsh[g] = sum;
  }
  if constexpr (F != kCacheT) {  // p times the row's V scale, rounded to q's dtype
    __syncthreads();
    for (int i = tid; i < G * CH; i += blockDim.x) {
      const int pos = c0 + i % CH;
      const float vsc = pos == a.off ? static_cast<const float*>(a.vs_new)[bh] : vs[pos];
      p[i] = al::round_to<T>(p[i] * vsc);
    }
  }
  __syncthreads();

  // P.V: the same row groups; lanes that share a column fold by shuffles
  float acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < N; ++e) acc[g][e] = 0.f;
  for (int j = r0; j < CH; j += rpp) {
    const int pos = c0 + j;
    if (vrow[pos] <= 0) continue;  // p is 0 there
    const Vec16<E> vv = reinterpret_cast<const Vec16<E>*>(
        pos == a.off ? vfresh : vslab + (size_t)pos * hd)[sub];
    float vf[N];
#pragma unroll
    for (int e = 0; e < N; ++e) vf[e] = al::value_of<F>(vv.v[e]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pv = p[g * CH + j];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[g][e] += pv * vf[e];
    }
  }
  for (int o = 16; o >= nvec; o >>= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < N; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  }
  if (lane < nvec) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < N; ++e) part[(warp * G + g) * hd + sub * N + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += part[(w * G + g) * hd + d];
    a.wacc[((bh * G + g) * NC + c) * hd + d] = v;
  }
  if (tid < G) a.wl[(bh * G + tid) * NC + c] = lsh[tid];

  // the owner chunk appends the fresh rows (K: launch 1 has read every row)
  if (a.off >= c0 && a.off < c0 + CH) {
    for (int i = tid; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(kslab + (size_t)a.off * hd)[i] =
          reinterpret_cast<const uint4*>(kfresh)[i];
      reinterpret_cast<uint4*>(vslab + (size_t)a.off * hd)[i] =
          reinterpret_cast<const uint4*>(vfresh)[i];
    }
  }

  int* counter = a.counters + bh;
  if (!al::last_to_arrive(counter, NC, &flag)) return;
  // the TPU kernel's chain over the chunks in order
  T* out = static_cast<T*>(a.out) + bh * G * hd;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    const size_t hg = bh * G + g;
    float m_old = kDead, l = 0.f, v = 0.f;
    for (int cc = 0; cc < NC; ++cc) {
      const float m_new = fmaxf(m_old, a.cmax[hg * NC + cc]);
      const float alpha = expf(m_old - m_new);
      l = alpha * l + __ldcg(a.wl + hg * NC + cc);
      v = alpha * v + __ldcg(a.wacc + (hg * NC + cc) * hd + d);
      m_old = m_new;
    }
    out[i] = al::from_f32<T>(v / l);
  }
  if (tid == 0) *counter = 0;
}

template <typename T, int F, int G>
cudaError_t launch_g(const Args& a) {
  const int NC = a.S / a.CH;
  dim3 grid(NC, a.Hkv, a.B);
  const size_t smem1 = sizeof(float) * ((size_t)G * a.hd + (size_t)G * a.CH);
  const size_t smem2 = sizeof(float) * ((size_t)G * a.CH + (size_t)kWarps * G * a.hd);
  cudaError_t err = al::allow_smem(packed_logits_kernel<T, F, G>, smem1);
  if (err == cudaSuccess) err = al::allow_smem(packed_pv_kernel<T, F, G>, smem2);
  if (err != cudaSuccess) return err;
  packed_logits_kernel<T, F, G><<<grid, kThreads, smem1, a.stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  packed_pv_kernel<T, F, G><<<grid, kThreads, smem2, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int F>
cudaError_t launch(int G, const Args& a) {
  switch (G) {
    case 1: return launch_g<T, F, 1>(a);
    case 2: return launch_g<T, F, 2>(a);
    case 3: return launch_g<T, F, 3>(a);
    case 4: return launch_g<T, F, 4>(a);
    case 6: return launch_g<T, F, 6>(a);
    case 8: return launch_g<T, F, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_fmt(int fmt, int G, const Args& a) {
  if (fmt == kCacheT) return launch<T, kCacheT>(G, a);
  if (fmt == kInt8) return launch<T, kInt8>(G, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// fmt: 0 (K/V caches in q's dtype) or 1 (int8 K/V + f32 row scales); dtype
// code of q (f32 or bf16). q [B, Hq, hd]; k_new, v_new [B, Hkv, hd] in the
// cache's element type; ks_new, vs_new [B, Hkv] f32 (fmt 1); ck, cv [L, B,
// Hkv, S, hd], contiguous and 16-byte aligned, written at `offset` of layer
// `layer` when 0 <= offset < S; ks, vs [Ls, B, Hkv, S] f32 read at layer
// `scale_layer` (fmt 1); valid int32 [B, S]; CH divides S and is a multiple
// of 32. Workspace f32: s [B, Hq, S], cmax and wl [B, Hq, S / CH], wacc [B,
// Hq, S / CH, hd]; counters: B * Hkv int32 zeros (left zero). Output out [B,
// Hq, hd] in q's dtype. Two launches. Requires G = Hq / Hkv in {1, 2, 3, 4,
// 6, 8} and a row of 16-byte vectors whose count divides 32 (checked by the
// Python wrapper).
AL_EXPORT int al_decode_packed(int fmt, int dtype, const void* q, const void* k_new,
                               const void* v_new, const void* ks_new, const void* vs_new,
                               void* ck, void* cv, const void* ks, const void* vs,
                               const void* valid, int layer, int scale_layer, int offset, int B,
                               int Hq, int Hkv, int S, int hd, int CH, float scale, void* s,
                               void* cmax, void* wl, void* wacc, void* counters, void* out,
                               void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || CH <= 0 || CH % 32 != 0 || S % CH != 0)
    return cudaErrorInvalidValue;
  const Args a{q, k_new, v_new, ks_new, vs_new, ck, cv, ks, vs, valid, layer, scale_layer,
               offset, B, Hkv, S, hd, CH, scale, static_cast<float*>(s),
               static_cast<float*>(cmax), static_cast<float*>(wl), static_cast<float*>(wacc),
               static_cast<int*>(counters), out, static_cast<cudaStream_t>(stream)};
  const int G = Hq / Hkv;
  if (dtype == al::kBF16) return launch_fmt<__nv_bfloat16>(fmt, G, a);
  if (dtype == al::kF32) return launch_fmt<float>(fmt, G, a);
  return cudaErrorInvalidValue;
}
