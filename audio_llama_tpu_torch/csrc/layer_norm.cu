// Row LayerNorm with affine, one-pass f32 moments.
//
// Replaces audio_llama_tpu/ops/ln_pallas.py::_kernel (layer_norm_pallas), the
// two per-layer LayerNorms of the Whisper encoder: [B*1536, 1280] bf16 rows.
//
// Bound on the H100: bytes. Each row is read once and written once
// (2 * 1536 * 1280 * 2 B = 7.9 MB at B=1, ~2.4 us at 3.35 TB/s); the
// arithmetic is a few f32 operations per element. Design: one block per row
// (any row count; no ragged-tile fallback is needed), 16-byte vector loads,
// the sum and the sum of squares reduced in one pass as the TPU kernel does
// (var = E[x^2] - E[x]^2 in f32), and the second pass re-reads the row from
// L1/L2 instead of device memory.
#include "common.cuh"

namespace {

template <typename T>
struct __align__(16) Vec16 {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

template <typename T>
__global__ void __launch_bounds__(256)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, T* __restrict__ y, int d, float eps) {
  __shared__ float red[32];
  constexpr int N = Vec16<T>::N;
  const size_t row = blockIdx.x;
  const Vec16<T>* xr = reinterpret_cast<const Vec16<T>*>(x + row * d);
  Vec16<T>* yr = reinterpret_cast<Vec16<T>*>(y + row * d);
  const Vec16<T>* sv = reinterpret_cast<const Vec16<T>*>(scale);
  const Vec16<T>* bv = reinterpret_cast<const Vec16<T>*>(bias);
  const int nvec = d / N;

  float s = 0.f, s2 = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec16<T> p = xr[i];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float f = al::to_f32(p.v[j]);
      s += f;
      s2 += f * f;
    }
  }
  s = al::block_sum(s, red);
  s2 = al::block_sum(s2, red);
  const float inv_d = 1.f / (float)d;
  const float mu = s * inv_d;
  const float var = s2 * inv_d - mu * mu;
  const float rs = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Vec16<T> p = xr[i], sc = sv[i], bi = bv[i], out;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float f = (al::to_f32(p.v[j]) - mu) * rs;
      out.v[j] = al::from_f32<T>(f * al::to_f32(sc.v[j]) + al::to_f32(bi.v[j]));
    }
    yr[i] = out;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* s, const void* b, void* y, int n_rows,
                   int d, float eps, cudaStream_t stream) {
  const int nvec = d / Vec16<T>::N;
  int threads = 32;
  while (threads < nvec && threads < 256) threads *= 2;
  layer_norm_kernel<T><<<n_rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s), static_cast<const T*>(b),
      static_cast<T*>(y), d, eps);
  return cudaGetLastError();
}

}  // namespace

// x, y: [n_rows, d] contiguous; scale, bias: [d]; d a multiple of 16 bytes'
// worth of elements (checked by the Python wrapper).
AL_EXPORT int al_layer_norm(int dtype, const void* x, const void* scale, const void* bias,
                            void* y, int n_rows, int d, float eps, void* stream) {
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == al::kBF16) return launch<__nv_bfloat16>(x, scale, bias, y, n_rows, d, eps, st);
  if (dtype == al::kF32) return launch<float>(x, scale, bias, y, n_rows, d, eps, st);
  return cudaErrorInvalidValue;
}
