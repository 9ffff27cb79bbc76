// Single-token decode attention on a bf16/f32 KV cache, appending in place.
//
// Replaces audio_llama_tpu/ops/decode_attention_mono.py::_kernel_mono_full
// (decode_attention_mono): cache [28, B, 8, max_len, 128] bf16, q [B, 24,
// 128], 28 calls per token. The kernel writes the fresh K/V row into the
// layer's cache slab at offset[b] IN PLACE (the cache tensors are updated,
// not copied), then attends the G = Hq / Hkv query heads of one KV head over
// the slab's rows whose `valid` entry is set. The offset is an int32 [B]
// tensor on the device, so a decode loop needs no host sync per token.
//
// Bound on the H100: bytes. The attended K and V rows are read once:
// 2 * 8 * n_valid * 128 * 2 B = 6.4 MB per layer at n_valid = 1568, B = 1
// (~1.9 us at 3.35 TB/s). Design: one block of 1024 threads per (batch, KV
// head) with its G query heads, so each K/V row is read once for all G
// heads. Logits: one thread per key row, 16-byte loads, q broadcast from
// shared memory, the scale applied AFTER the f32 dot as the TPU kernel does.
// A block-wide max and sum give the softmax. PV: each thread owns 16 bytes
// of the row for a strided subset of rows, with no branch in the loop (a
// masked row has p = 0, as in the TPU kernel's full-slab product), so its
// loads pipeline; warp shuffles and shared memory combine the partial sums.
// At B = 1 this fills only 8 of 132 SMs; splitting the timeline across
// blocks is the next step for speed.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct __align__(16) Vec16 {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
              T* __restrict__ ck, T* __restrict__ cv, const int* __restrict__ offset,
              const int* __restrict__ valid, int layer, int B, int Hkv, int S, int hd,
              float scale, T* __restrict__ out) {
  constexpr int N = Vec16<T>::N;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                          // [G, hd]
  float* logit = qs + G * hd;              // [G, S], then the probabilities
  float* part = logit + (size_t)G * S;     // [kWarps, G, hd] PV partial sums
  __shared__ float red[32];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const size_t slab = (((size_t)layer * B + b) * Hkv + kvh) * (size_t)S * hd;
  T* sk = ck + slab;
  T* sv = cv + slab;
  const int off = offset[b];
  const int* vrow = valid + (size_t)b * S;

  // append the fresh row in place (an offset outside the slab writes nothing)
  if (off >= 0 && off < S) {
    const size_t src = ((size_t)b * Hkv + kvh) * hd;
    for (int d = tid; d < hd; d += blockDim.x) {
      sk[(size_t)off * hd + d] = k_new[src + d];
      sv[(size_t)off * hd + d] = v_new[src + d];
    }
  }
  for (int i = tid; i < G * hd; i += blockDim.x)
    qs[i] = al::to_f32(q[((size_t)b * Hq + kvh * G) * hd + i]);
  __syncthreads();

  // logits: one thread per key row
  const int nvec = hd / N;
  for (int pos = tid; pos < S; pos += blockDim.x) {
    const Vec16<T>* krow = reinterpret_cast<const Vec16<T>*>(sk + (size_t)pos * hd);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int c = 0; c < nvec; ++c) {
      const Vec16<T> kv = krow[c];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float kf = al::to_f32(kv.v[j]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += qs[g * hd + c * N + j] * kf;
      }
    }
    const bool ok = vrow[pos] > 0;
#pragma unroll
    for (int g = 0; g < G; ++g) logit[g * S + pos] = ok ? acc[g] * scale : -INFINITY;
  }
  __syncthreads();

  // softmax per head: p = exp(l - max) in place, f32 denominator
  float denom[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* lg = logit + (size_t)g * S;
    float mx = -INFINITY;
    for (int i = tid; i < S; i += blockDim.x) mx = fmaxf(mx, lg[i]);
    mx = al::block_max(mx, red);
    float sum = 0.f;
    for (int i = tid; i < S; i += blockDim.x) {
      const float e = lg[i] == -INFINITY ? 0.f : __expf(lg[i] - mx);
      lg[i] = e;
      sum += e;
    }
    denom[g] = al::block_sum(sum, red);
  }
  __syncthreads();

  // PV: thread (row group r, vector column c) sums rows r, r + rows, ...;
  // P meets V in the cache dtype, as the TPU kernel's p.astype(cdt) does
  const int rows = blockDim.x / nvec;
  const int c = tid % nvec, r = tid / nvec;
  float acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[g][j] = 0.f;
#pragma unroll 4
  for (int pos = r; pos < S; pos += rows) {
    const Vec16<T> vv = reinterpret_cast<const Vec16<T>*>(sv + (size_t)pos * hd)[c];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = al::to_f32(al::from_f32<T>(logit[(size_t)g * S + pos]));
#pragma unroll
      for (int j = 0; j < N; ++j) acc[g][j] += p * al::to_f32(vv.v[j]);
    }
  }
  // lanes that share a vector column within a warp (nvec divides 32, checked
  // by the wrapper): fold by shuffles, then one partial per (warp, column)
  // through shared memory
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
    const float den = denom[g];
    out[((size_t)b * Hq + kvh * G) * hd + i] = al::from_f32<T>(den > 0.f ? s / den : 0.f);
  }
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* k_new, const void* v_new, void* ck, void* cv,
                     const int* offset, const int* valid, int layer, int B, int Hkv, int S,
                     int hd, float scale, void* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)G * S + (size_t)kWarps * G * hd);
  cudaError_t err = al::allow_smem(decode_kernel<T, G>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  decode_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<T*>(ck), static_cast<T*>(cv), offset, valid, layer, B, Hkv, S, hd, scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int G, const void* q, const void* k_new, const void* v_new, void* ck,
                   void* cv, const int* offset, const int* valid, int layer, int B, int Hkv,
                   int S, int hd, float scale, void* out, cudaStream_t stream) {
#define AL_G(n) \
  case n:       \
    return launch_g<T, n>(q, k_new, v_new, ck, cv, offset, valid, layer, B, Hkv, S, hd, scale, out, stream);
  switch (G) {
    AL_G(1) AL_G(2) AL_G(3) AL_G(4) AL_G(6) AL_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef AL_G
}

}  // namespace

// q, out: [B, Hq, hd]; k_new, v_new: [B, Hkv, hd] in the cache dtype;
// ck, cv: [L, B, Hkv, S, hd] contiguous and 16-byte aligned, updated in place
// at slot offset[b] of layer `layer`; offset: int32 [B]; valid: int32 [B, S].
// Requires G = Hq / Hkv in {1, 2, 3, 4, 6, 8}, hd a multiple of 16 bytes'
// worth of elements with hd / (16 B / element) dividing 32, and the shared
// memory of the launcher (checked by the Python wrapper).
AL_EXPORT int al_decode_attention(int dtype, const void* q, const void* k_new, const void* v_new,
                                  void* ck, void* cv, const void* offset, const void* valid,
                                  int layer, int B, int Hq, int Hkv, int S, int hd, float scale,
                                  void* out, void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offset);
  const int* val = static_cast<const int*>(valid);
  if (dtype == al::kBF16)
    return launch<__nv_bfloat16>(G, q, k_new, v_new, ck, cv, off, val, layer, B, Hkv, S, hd,
                                 scale, out, st);
  if (dtype == al::kF32)
    return launch<float>(G, q, k_new, v_new, ck, cv, off, val, layer, B, Hkv, S, hd, scale,
                         out, st);
  return cudaErrorInvalidValue;
}
