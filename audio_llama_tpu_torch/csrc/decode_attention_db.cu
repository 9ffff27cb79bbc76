// Timeline-sharded single-token decode attention: the unnormalized flash
// statistics of one rank's slab of the KV-cache timeline, appending the
// fresh row in place on the rank that owns its slot.
//
// Replaces audio_llama_tpu/ops/decode_attention_db.py::_kernel (stats=True,
// decode_attention_db_stats), ::_kernel_quantized (stats=True,
// decode_attention_quantized_db_stats) and ::_kernel_quantized4 (stats=True,
// decode_attention_quantized4_db_stats), one template over the cache format:
//   kCacheT  K and V caches [L, B, Hkv, S, hd] in q's dtype (bf16 or f32);
//   kInt8    signed int8 K and V caches plus per-row f32 scales [Ls, B, Hkv, S];
//   kInt4    ONE K/V-combined int8 cache (byte d: K's dim d offset-binary in
//            the low nibble, V's signed in the high nibble; models/llama.py
//            quantize_kv_rows4) plus both scale slabs.
// S is this rank's local slot count; `local_off` the append slot in local
// coordinates (global offset - rank * S), outside [0, S) on the ranks that do
// not own it. As in the TPU kernels, over the slab with the fresh row standing
// at local_off (read from the fresh-row arguments, never from the cache):
//   logits = (q . k) * scale, or * (k_scale * scale) with the fresh row's
//   scale at local_off; lanes whose valid <= 0 are -1e30;
//   m = max(rowmax, -5e29); p = valid ? exp(logit - m) : 0; l = sum p;
//   acc = sum (p, or p * v_scale, rounded to q's dtype) * v; all f32, nothing
//   normalized. An all-invalid slab gives (-5e29, 0, 0), a no-op in the
//   cross-rank merge (ops/attention.py::merge_partial_stats).
// The owner writes the fresh K/V row (or the combined row) into the cache at
// local_off after every read of the slab; the other ranks write nothing. The
// caller writes the append slot's scales (owner-gated), as in the JAX package.
//
// Bound on the H100: bytes. The valid rows of the local slab are read once
// (2 hd bytes a row for K and V in bf16 twice, 2 hd int8, hd int4) plus 8
// bytes of scales: at S = 3072, 8 KV heads, B = 1, bf16: 12.6 MB per layer
// (3.8 us at 3.35 TB/s). Design: decode_attention.cu's, one block of 1024
// threads per (batch row, KV head) with its G query heads, so each row is
// read once for all G heads: one thread per key row with 16-byte loads for
// the logits, then a branch-free PV pass in which each thread owns 16 bytes
// of a strided subset of rows. At B = 1 this fills 8 of 132 SMs; splitting
// the timeline over blocks is the next step for speed.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kDead = -1e30f;   // an invalid lane's logit
constexpr float kFloor = -5e29f;  // the clamp of the row max

enum Fmt { kCacheT = 0, kInt8 = 1, kInt4 = 2 };

template <typename T, int F>
struct Elem {
  using type = int8_t;
};
template <typename T>
struct Elem<T, kCacheT> {
  using type = T;
};

template <typename E>
struct __align__(16) Vec16 {
  static constexpr int N = 16 / sizeof(E);
  E v[N];
};

template <int F, typename E>
__device__ __forceinline__ float key_of(E e) {
  if constexpr (F == kCacheT) return al::to_f32(e);
  else if constexpr (F == kInt8) return (float)(int)e;
  else return (float)(((int)(uint8_t)e & 0xF) - 8);
}

template <int F, typename E>
__device__ __forceinline__ float value_of(E e) {
  if constexpr (F == kCacheT) return al::to_f32(e);
  else if constexpr (F == kInt8) return (float)(int)e;
  else return (float)((int)e >> 4);  // e is signed: the high nibble, sign-extended
}

template <typename T, int F, int G>
__global__ void __launch_bounds__(kThreads)
db_stats_kernel(const T* __restrict__ q, const void* k_new_, const void* v_new_,
                const float* __restrict__ ks_new, const float* __restrict__ vs_new, void* ck_,
                void* cv_, const float* __restrict__ ks, const float* __restrict__ vs,
                const int* __restrict__ valid, int layer, int scale_layer, int local_off, int B,
                int Hkv, int S, int hd, float scale, float* __restrict__ m_out,
                float* __restrict__ l_out, float* __restrict__ acc_out) {
  using E = typename Elem<T, F>::type;
  constexpr int N = Vec16<E>::N;
  constexpr bool kQuant = F != kCacheT;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                    // [G, hd]
  float* p = qs + G * hd;            // [G, S]: logits, then probabilities
  float* part = p + (size_t)G * S;   // [kWarps, G, hd] PV partial sums
  __shared__ float red[32];
  __shared__ float msh[G], lsh[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const int nvec = hd / N;
  const size_t bh = (size_t)b * Hkv + kvh;
  const size_t row0 = ((size_t)layer * B * Hkv + bh) * (size_t)S;
  E* kslab = static_cast<E*>(ck_) + row0 * hd;
  E* vslab = static_cast<E*>(cv_) + row0 * hd;
  const E* kfresh = static_cast<const E*>(k_new_) + bh * hd;
  const E* vfresh = static_cast<const E*>(v_new_) + bh * hd;
  const size_t srow = ((size_t)scale_layer * B * Hkv + bh) * (size_t)S;
  const bool owner = local_off >= 0 && local_off < S;
  const int* vrow = valid + (size_t)b * S;

  for (int i = tid; i < G * hd; i += blockDim.x)
    qs[i] = al::to_f32(q[((size_t)b * Hq + kvh * G) * hd + i]);
  __syncthreads();

  // logits: one thread per key row; the fresh row stands at local_off
  for (int pos = tid; pos < S; pos += blockDim.x) {
    if (vrow[pos] <= 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) p[(size_t)g * S + pos] = kDead;
      continue;
    }
    const bool fresh = pos == local_off;
    const Vec16<E>* krow =
        reinterpret_cast<const Vec16<E>*>(fresh ? kfresh : kslab + (size_t)pos * hd);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 2
    for (int c = 0; c < nvec; ++c) {
      const Vec16<E> kv = krow[c];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float kf = key_of<F>(kv.v[j]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += qs[g * hd + c * N + j] * kf;
      }
    }
    float f = scale;
    if constexpr (kQuant) f = (fresh ? ks_new[bh] : ks[srow + pos]) * scale;
#pragma unroll
    for (int g = 0; g < G; ++g) p[(size_t)g * S + pos] = acc[g] * f;
  }
  __syncthreads();

  // per head: m = max(rowmax, -5e29); p = valid ? exp(logit - m) : 0; l = sum p
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* pg = p + (size_t)g * S;
    float mx = -INFINITY;
    for (int i = tid; i < S; i += blockDim.x) mx = fmaxf(mx, pg[i]);
    mx = fmaxf(al::block_max(mx, red), kFloor);
    float sum = 0.f;
    for (int i = tid; i < S; i += blockDim.x) {
      const float e = vrow[i] > 0 ? expf(pg[i] - mx) : 0.f;
      pg[i] = e;
      sum += e;
    }
    sum = al::block_sum(sum, red);
    if (tid == 0) msh[g] = mx, lsh[g] = sum;
  }
  __syncthreads();

  // PV: thread (row group r, 16-byte column c) sums rows r, r + rows, ...;
  // P (times the row's V scale) meets V rounded to q's dtype
  const int rows = blockDim.x / nvec;
  const int c = tid % nvec, r = tid / nvec;
  float acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[g][j] = 0.f;
  for (int pos = r; pos < S; pos += rows) {
    const bool fresh = pos == local_off;
    const Vec16<E> vv =
        reinterpret_cast<const Vec16<E>*>(fresh ? vfresh : vslab + (size_t)pos * hd)[c];
    float vsc = 1.f;
    if constexpr (kQuant) vsc = fresh ? vs_new[bh] : vs[srow + pos];
    float vf[N];
#pragma unroll
    for (int j = 0; j < N; ++j) vf[j] = value_of<F>(vv.v[j]);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pv = al::to_f32(al::from_f32<T>(p[(size_t)g * S + pos] * vsc));
#pragma unroll
      for (int j = 0; j < N; ++j) acc[g][j] += pv * vf[j];
    }
  }
  // lanes that share a column within a warp (nvec divides 32, checked by the
  // wrapper) fold by shuffles, then one partial per (warp, column)
  for (int o = 16; o >= nvec; o >>= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  }
  if (lane < nvec) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < N; ++j) part[((size_t)warp * G + g) * hd + c * N + j] = acc[g][j];
  }
  __syncthreads();
  const size_t head0 = (size_t)b * Hq + kvh * G;
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[((size_t)w * G + g) * hd + d];
    acc_out[(head0 + g) * hd + d] = s;
  }
  if (tid < G) {
    m_out[head0 + tid] = msh[tid];
    l_out[head0 + tid] = lsh[tid];
  }

  // the owner appends the fresh row(s), after every read of the slab
  if (owner) {
    for (int i = tid; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(kslab + (size_t)local_off * hd)[i] =
          reinterpret_cast<const uint4*>(kfresh)[i];
      if (F != kInt4)
        reinterpret_cast<uint4*>(vslab + (size_t)local_off * hd)[i] =
            reinterpret_cast<const uint4*>(vfresh)[i];
    }
  }
}

struct Args {
  const void *q, *k_new, *v_new, *ks_new, *vs_new;
  void *ck, *cv;
  const void *ks, *vs, *valid;
  int layer, scale_layer, local_off, B, Hkv, S, hd;
  float scale;
  void *m, *l, *acc;
  cudaStream_t stream;
};

template <typename T, int F, int G>
cudaError_t launch_g(const Args& a) {
  const size_t smem =
      sizeof(float) * ((size_t)G * a.hd + (size_t)G * a.S + (size_t)kWarps * G * a.hd);
  cudaError_t err = al::allow_smem(db_stats_kernel<T, F, G>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv, a.B);
  db_stats_kernel<T, F, G><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), a.k_new, a.v_new, static_cast<const float*>(a.ks_new),
      static_cast<const float*>(a.vs_new), a.ck, a.cv, static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.valid), a.layer,
      a.scale_layer, a.local_off, a.B, a.Hkv, a.S, a.hd, a.scale, static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<float*>(a.acc));
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
  if (fmt == kInt4) return launch<T, kInt4>(G, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// fmt: 0 (K/V caches in q's dtype), 1 (int8 K/V + scales), 2 (K/V-combined
// int4 + scales); dtype code of q (f32 or bf16). q [B, Hq, hd]; k_new, v_new
// [B, Hkv, hd] in the cache's element type (fmt 2: both the combined rows);
// ks_new, vs_new [B, Hkv] f32 (fmt 1, 2); ck, cv [L, B, Hkv, S, hd] (fmt 2:
// both the combined cache), contiguous and 16-byte aligned, written at
// local_off of layer `layer` when 0 <= local_off < S; ks, vs [Ls, B, Hkv, S]
// f32 read at layer `scale_layer` (fmt 1, 2); valid int32 [B, S]. Outputs m,
// l [B, Hq] and acc [B, Hq, hd], f32. Requires G = Hq / Hkv in {1, 2, 3, 4,
// 6, 8}, a row of 16-byte vectors whose count divides 32, and the shared
// memory of the launcher (checked by the Python wrapper).
AL_EXPORT int al_decode_db_stats(int fmt, int dtype, const void* q, const void* k_new,
                                 const void* v_new, const void* ks_new, const void* vs_new,
                                 void* ck, void* cv, const void* ks, const void* vs,
                                 const void* valid, int layer, int scale_layer, int local_off,
                                 int B, int Hq, int Hkv, int S, int hd, float scale, void* m,
                                 void* l, void* acc, void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const Args a{q, k_new, v_new, ks_new, vs_new, ck, cv, ks, vs, valid, layer, scale_layer,
               local_off, B, Hkv, S, hd, scale, m, l, acc, static_cast<cudaStream_t>(stream)};
  const int G = Hq / Hkv;
  if (dtype == al::kBF16) return launch_fmt<__nv_bfloat16>(fmt, G, a);
  if (dtype == al::kF32) return launch_fmt<float>(fmt, G, a);
  return cudaErrorInvalidValue;
}
