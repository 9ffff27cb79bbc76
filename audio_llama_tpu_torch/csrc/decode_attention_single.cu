// Single-buffered decode attention: append one K/V row, attend one token.
//
// Replaces audio_llama_tpu/ops/decode_attention.py::_kernel (decode_attention,
// bf16/f32 cache) and ::_kernel_quantized (decode_attention_quantized, int8
// cache with per-slot f32 scales). Grid (Hkv, B): one block per (batch row,
// KV head) with its G = Hq / Hkv query heads, as the TPU kernel's grid
// (B, Hkv). The block writes the fresh row into the layer's slab at the
// scalar `offset` IN PLACE (an offset outside [0, max_len) writes nothing,
// as the TPU kernel's clamped write-back window of the unpatched slab), then
// attends every slot whose `valid` entry is set.
//
// Softmax order of the TPU kernel, which normalizes BEFORE PV (the db
// kernels normalize at the end): logits = (q . k) * scale in f32 (int8:
// * (k_s * scale), k_s patched at the offset from the fresh row's scale);
// masked slots get -1e30; m = max over the whole slab; p = exp(l - m);
// p = p / sum(p); p is rounded to V's dtype (int8: (p * v_s) to the compute
// dtype, v_s patched at the offset); out = p @ V in f32, rounded to q's
// dtype. The scale slabs are never written: the caller owns them.
//
// Bound on the H100: bytes. The K and V slabs are read once (28 layers x 8
// heads x 3040 slots x 128 x 2 B x 2 = 2.5 MB a layer at B = 1, ~0.75 us at
// 3.35 TB/s). Design (correct first): the [G, max_len] f32 logits live in
// dynamic shared memory (G 3, 3040 slots: 36 KB; the wrapper refuses a
// timeline past 227 KB); one thread per key row with 16-byte loads builds
// them (512 threads), block reductions give m and the sum, and PV is the mono kernel's
// (csrc/decode_attention.cu) strided 16-byte rows folded by warp shuffles.
// It fills Hkv * B blocks: 8 of 132 SMs at B = 1.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;  // 128 registers a thread: int8's 16-wide PV rows x G
constexpr int kWarps = kThreads / 32;
constexpr float kDead = -1e30f;  // the TPU kernel's masked logit

template <typename T>
struct __align__(16) Vec16 {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ float elem_f32(float x) { return x; }
__device__ __forceinline__ float elem_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float elem_f32(int8_t x) { return static_cast<float>(x); }

// Tq: q / out / compute dtype; Tc: cache dtype (Tq itself, or int8 with QUANT)
template <typename Tq, typename Tc, bool QUANT, int G>
__global__ void __launch_bounds__(kThreads)
single_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k_new,
              const Tc* __restrict__ v_new, Tc* __restrict__ ck, Tc* __restrict__ cv,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const float* __restrict__ ks_new, const float* __restrict__ vs_new,
              const int* __restrict__ offset, const int* __restrict__ valid, int layer, int B,
              int Hkv, int S, int hd, float scale, Tq* __restrict__ out) {
  constexpr int N = Vec16<Tc>::N;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                       // [G, hd]
  float* prob = qs + G * hd;            // [G, S] logits, then p rounded as PV takes it
  float* part = prob + (size_t)G * S;   // [kWarps, G, hd] PV partial sums
  __shared__ float red[32];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const size_t slab = (((size_t)layer * B + b) * Hkv + kvh) * (size_t)S * hd;
  Tc* sk = ck + slab;
  Tc* sv = cv + slab;
  const int off = offset[0];
  const int* vrow = valid + (size_t)b * S;
  const size_t head = (size_t)b * Hkv + kvh;
  const float* ksr = QUANT ? ks + head * S : nullptr;
  const float* vsr = QUANT ? vs + head * S : nullptr;
  const float ksn = QUANT ? ks_new[head] : 0.f;
  const float vsn = QUANT ? vs_new[head] : 0.f;

  if (off >= 0 && off < S) {
    for (int d = tid; d < hd; d += blockDim.x) {
      sk[(size_t)off * hd + d] = k_new[head * hd + d];
      sv[(size_t)off * hd + d] = v_new[head * hd + d];
    }
  }
  for (int i = tid; i < G * hd; i += blockDim.x)
    qs[i] = al::to_f32(q[((size_t)b * Hq + kvh * G) * hd + i]);
  __syncthreads();

  // logits of the patched slab: one thread per key row
  const int nvec = hd / N;
  for (int pos = tid; pos < S; pos += blockDim.x) {
    const Vec16<Tc>* krow = reinterpret_cast<const Vec16<Tc>*>(sk + (size_t)pos * hd);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int c = 0; c < nvec; ++c) {
      const Vec16<Tc> kv = krow[c];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float kf = elem_f32(kv.v[j]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += qs[g * hd + c * N + j] * kf;
      }
    }
    float mul = scale;
    if (QUANT) mul = (pos == off ? ksn : ksr[pos]) * scale;
    const bool ok = vrow[pos] > 0;
#pragma unroll
    for (int g = 0; g < G; ++g) prob[(size_t)g * S + pos] = ok ? acc[g] * mul : kDead;
  }
  __syncthreads();

  // softmax per head, normalized before PV; p rounded as PV takes it
  for (int g = 0; g < G; ++g) {
    float* lg = prob + (size_t)g * S;
    float mx = -INFINITY;
    for (int i = tid; i < S; i += blockDim.x) mx = fmaxf(mx, lg[i]);
    mx = al::block_max(mx, red);
    float sum = 0.f;
    for (int i = tid; i < S; i += blockDim.x) {
      const float e = expf(lg[i] - mx);
      lg[i] = e;
      sum += e;
    }
    const float den = al::block_sum(sum, red);
    for (int i = tid; i < S; i += blockDim.x) {
      float p = lg[i] / den;
      if (QUANT) p *= (i == off ? vsn : vsr[i]);
      lg[i] = al::to_f32(al::from_f32<Tq>(p));
    }
  }
  __syncthreads();

  // PV: thread (row group r, vector column c) sums rows r, r + rows, ...
  const int rows = blockDim.x / nvec;
  const int c = tid % nvec, r = tid / nvec;
  float acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[g][j] = 0.f;
#pragma unroll 2
  for (int pos = r; pos < S; pos += rows) {
    const Vec16<Tc> vv = reinterpret_cast<const Vec16<Tc>*>(sv + (size_t)pos * hd)[c];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = prob[(size_t)g * S + pos];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[g][j] += p * elem_f32(vv.v[j]);
    }
  }
  // lanes sharing a vector column within a warp (nvec divides 32, checked by
  // the wrapper) fold by shuffles; one partial per (warp, column) in shared
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
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[((size_t)w * G + g) * hd + d];
    out[((size_t)b * Hq + kvh * G) * hd + i] = al::from_f32<Tq>(s);
  }
}

template <typename Tq, typename Tc, bool QUANT, int G>
cudaError_t launch_g(const void* q, const void* k_new, const void* v_new, void* ck, void* cv,
                     const void* ks, const void* vs, const void* ks_new, const void* vs_new,
                     const int* offset, const int* valid, int layer, int B, int Hkv, int S,
                     int hd, float scale, void* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)G * S + (size_t)kWarps * G * hd);
  cudaError_t err = al::allow_smem(single_kernel<Tq, Tc, QUANT, G>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  single_kernel<Tq, Tc, QUANT, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const Tq*>(q), static_cast<const Tc*>(k_new), static_cast<const Tc*>(v_new),
      static_cast<Tc*>(ck), static_cast<Tc*>(cv), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const float*>(ks_new),
      static_cast<const float*>(vs_new), offset, valid, layer, B, Hkv, S, hd, scale,
      static_cast<Tq*>(out));
  return cudaGetLastError();
}

template <typename Tq, typename Tc, bool QUANT>
cudaError_t launch(int G, const void* q, const void* k_new, const void* v_new, void* ck,
                   void* cv, const void* ks, const void* vs, const void* ks_new,
                   const void* vs_new, const int* offset, const int* valid, int layer, int B,
                   int Hkv, int S, int hd, float scale, void* out, cudaStream_t stream) {
#define AL_G(n)                                                                             \
  case n:                                                                                   \
    return launch_g<Tq, Tc, QUANT, n>(q, k_new, v_new, ck, cv, ks, vs, ks_new, vs_new,      \
                                      offset, valid, layer, B, Hkv, S, hd, scale, out, stream);
  switch (G) {
    AL_G(1) AL_G(2) AL_G(3) AL_G(4) AL_G(6) AL_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef AL_G
}

}  // namespace

// q, out: [B, Hq, hd] in `dtype` (the compute dtype); k_new, v_new: [B, Hkv,
// hd] in the cache dtype; ck, cv: [L, B, Hkv, S, hd] contiguous and 16-byte
// aligned, written in place at slot offset[0] of layer `layer`; offset: one
// int32 on the device; valid: int32 [B, S]. quant = 1: int8 caches, ks / vs
// this layer's [B, Hkv, S] f32 scales (read only), ks_new / vs_new [B, Hkv]
// f32; quant = 0: caches in `dtype`, the scale pointers unused. Requires
// G = Hq / Hkv in {1, 2, 3, 4, 6, 8}, hd / (16 B / element) dividing 32 and the
// shared memory of the launcher (checked by the Python wrapper).
AL_EXPORT int al_decode_attention_single(int dtype, int quant, const void* q,
                                         const void* k_new, const void* v_new, void* ck,
                                         void* cv, const void* ks, const void* vs,
                                         const void* ks_new, const void* vs_new,
                                         const void* offset, const void* valid, int layer,
                                         int B, int Hq, int Hkv, int S, int hd, float scale,
                                         void* out, void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offset);
  const int* val = static_cast<const int*>(valid);
  if (quant) {
    if (dtype == al::kBF16)
      return launch<__nv_bfloat16, int8_t, true>(G, q, k_new, v_new, ck, cv, ks, vs, ks_new,
                                                 vs_new, off, val, layer, B, Hkv, S, hd,
                                                 scale, out, st);
    if (dtype == al::kF32)
      return launch<float, int8_t, true>(G, q, k_new, v_new, ck, cv, ks, vs, ks_new, vs_new,
                                         off, val, layer, B, Hkv, S, hd, scale, out, st);
    return cudaErrorInvalidValue;
  }
  if (dtype == al::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(G, q, k_new, v_new, ck, cv, ks, vs,
                                                       ks_new, vs_new, off, val, layer, B, Hkv,
                                                       S, hd, scale, out, st);
  if (dtype == al::kF32)
    return launch<float, float, false>(G, q, k_new, v_new, ck, cv, ks, vs, ks_new, vs_new,
                                       off, val, layer, B, Hkv, S, hd, scale, out, st);
  return cudaErrorInvalidValue;
}
