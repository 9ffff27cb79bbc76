// Single-token decode attention on the K/V-combined int4 cache, appending
// the fresh row in place.
//
// Replaces audio_llama_tpu/ops/decode_attention_mono.py::_kernel_mono4
// (decode_attention_quantized4_mono): cache [L, B, Hkv, S, hd] int8 where
// byte d of a row holds K's dim d offset-binary in the low nibble and V's
// dim d signed in the high nibble (models/llama.py quantize_kv_rows4), per-row
// f32 scales [L|1, B, Hkv, S], q [B, Hq, hd]. As in the TPU kernel:
//  - logits = (q . k_int) * (k_scale[slot] * scale) in f32; a slot is dead
//    (-1e30) where valid <= 0 or slot == offset, so the append slot's scale,
//    written by the caller before the launch, is never read;
//  - p = exp(logit - max), the denominator the f32 sum of p; P meets V as
//    (p * v_scale[slot]) rounded to q's dtype;
//  - the fresh row (kv_new, ks_new, vs_new) enters analytically, with weight
//    exp(lf - m) where lf is its logit, when its slot is inside the cache and
//    valid;
//  - the fresh packed row is written into the cache at offset[b] in place
//    (nothing is written for an offset outside the cache), after the slab
//    has been read.
// Offsets are an int32 [B] device tensor, so a decode loop needs no host sync.
//
// Bound on the H100: bytes. The valid rows of one layer's slab are read
// once, hd bytes a row, plus 8 bytes of scales: ~1.7 MB at B = 1, 8 KV heads,
// S = 1568 (0.5 us at 3.35 TB/s). Design: decode_attention.cu's, one block
// of 1024 threads per (batch row, KV head) with its G query heads, so each
// row is read once for all G heads: one thread per key row with 16-byte
// loads for the logits, then a branch-free PV pass in which each thread owns
// 16 bytes (16 dims) of a strided subset of rows. At B = 1 this fills 8 of
// 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kDead = -1e30f;

template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode4_kernel(const T* __restrict__ q, const int8_t* __restrict__ kv_new,
               const float* __restrict__ ks_new, const float* __restrict__ vs_new,
               int8_t* __restrict__ ckv, const float* __restrict__ ks,
               const float* __restrict__ vs, const int* __restrict__ offset,
               const int* __restrict__ valid, int layer, int scale_layer, int B, int Hkv, int S,
               int hd, float scale, T* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                       // [G, hd]
  float* logit = qs + G * hd;           // [G, S], then p
  float* part = logit + (size_t)G * S;  // [kWarps, G, hd]
  __shared__ float red[32];
  __shared__ float lfs[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Hq = Hkv * G;
  const int nvec = hd / 16;
  const size_t row0 = (((size_t)layer * B + b) * Hkv + kvh) * (size_t)S;
  const int8_t* slab = ckv + row0 * hd;
  const size_t srow = (((size_t)scale_layer * B + b) * Hkv + kvh) * (size_t)S;
  const float* ksr = ks + srow;
  const float* vsr = vs + srow;
  const int off = offset[b];
  const int* vrow = valid + (size_t)b * S;
  const int8_t* fresh = kv_new + ((size_t)b * Hkv + kvh) * hd;
  const float ksn = ks_new[(size_t)b * Hkv + kvh], vsn = vs_new[(size_t)b * Hkv + kvh];

  for (int i = tid; i < G * hd; i += blockDim.x)
    qs[i] = al::to_f32(q[((size_t)b * Hq + kvh * G) * hd + i]);
  __syncthreads();

  // the fresh row's logit, one warp per query head
  const bool fresh_on = off >= 0 && off < S && vrow[off] > 0;
  if (warp < G) {
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32)
      acc += qs[warp * hd + d] * (float)(((int)fresh[d] & 0xF) - 8);
    acc = al::warp_sum(acc);
    if (lane == 0) lfs[warp] = fresh_on ? acc * (ksn * scale) : kDead;
  }

  // logits: one thread per key row
  for (int pos = tid; pos < S; pos += blockDim.x) {
    if (vrow[pos] <= 0 || pos == off) {
#pragma unroll
      for (int g = 0; g < G; ++g) logit[g * S + pos] = kDead;
      continue;
    }
    const uint4* krow = reinterpret_cast<const uint4*>(slab + (size_t)pos * hd);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int c = 0; c < nvec; ++c) {
      const uint4 v = krow[c];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float kf = (float)((int)((w[j / 4] >> (8 * (j % 4))) & 0xF) - 8);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += qs[g * hd + c * 16 + j] * kf;
      }
    }
    const float f = ksr[pos] * scale;
#pragma unroll
    for (int g = 0; g < G; ++g) logit[g * S + pos] = acc[g] * f;
  }
  __syncthreads();

  // softmax over the slab per head: p = exp(l - m1) in place, l1 = sum p
  float m1[G], l1[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* lg = logit + (size_t)g * S;
    float mx = -INFINITY;
    for (int i = tid; i < S; i += blockDim.x) mx = fmaxf(mx, lg[i]);
    mx = al::block_max(mx, red);
    float sum = 0.f;
    for (int i = tid; i < S; i += blockDim.x) {
      const float e = expf(lg[i] - mx);
      lg[i] = e;
      sum += e;
    }
    m1[g] = mx;
    l1[g] = al::block_sum(sum, red);
  }
  __syncthreads();

  // PV over the slab: thread (row group r, 16-byte column c); V is the high
  // nibble of each byte, (p * v_scale) meets it rounded to T
  const int rows = blockDim.x / nvec;
  const int c = tid % nvec, r = tid / nvec;
  float acc[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[g][j] = 0.f;
  for (int pos = r; pos < S; pos += rows) {
    const uint4 v = reinterpret_cast<const uint4*>(slab + (size_t)pos * hd)[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float vsc = vsr[pos];
    float vf[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      vf[j] = (float)((int)(signed char)((w[j / 4] >> (8 * (j % 4))) & 0xFF) >> 4);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float pv = al::to_f32(al::from_f32<T>(logit[(size_t)g * S + pos] * vsc));
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[g][j] += pv * vf[j];
    }
  }
  for (int o = 16; o >= nvec; o >>= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[g][j] += __shfl_xor_sync(0xffffffffu, acc[g][j], o);
  }
  if (lane < nvec) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < 16; ++j) part[((size_t)warp * G + g) * hd + c * 16 + j] = acc[g][j];
  }
  __syncthreads();

  // merge the fresh row: m = max(m1, lf), out = (a1 acc1 + pf vs_new v_new) / (a1 l1 + pf)
  for (int i = tid; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[((size_t)w * G + g) * hd + d];
    float mg = 0.f, lg = 0.f;
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      if (gg == g) mg = m1[gg], lg = l1[gg];
    const float lf = lfs[g];
    const float m = fmaxf(mg, lf);
    const float a1 = expf(mg - m), pf = expf(lf - m);
    const float vn = (float)((int)fresh[d] >> 4);
    const float o = (a1 * s + (pf * vsn) * vn) / (a1 * lg + pf);
    out[((size_t)b * Hq + kvh * G) * hd + i] = al::from_f32<T>(o);
  }
  __syncthreads();

  // append the fresh packed row (after every read of the slab)
  if (off >= 0 && off < S) {
    for (int i = tid; i < nvec; i += blockDim.x)
      reinterpret_cast<uint4*>(ckv + (row0 + off) * hd)[i] = reinterpret_cast<const uint4*>(fresh)[i];
  }
}

template <typename T, int G>
cudaError_t launch_g(const void* q, const void* kv_new, const void* ks_new, const void* vs_new,
                     void* ckv, const void* ks, const void* vs, const int* offset,
                     const int* valid, int layer, int scale_layer, int B, int Hkv, int S, int hd,
                     float scale, void* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)G * hd + (size_t)G * S + (size_t)kWarps * G * hd);
  cudaError_t err = al::allow_smem(decode4_kernel<T, G>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B);
  decode4_kernel<T, G><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kv_new),
      static_cast<const float*>(ks_new), static_cast<const float*>(vs_new),
      static_cast<int8_t*>(ckv), static_cast<const float*>(ks), static_cast<const float*>(vs),
      offset, valid, layer, scale_layer, B, Hkv, S, hd, scale, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int G, const void* q, const void* kv_new, const void* ks_new,
                   const void* vs_new, void* ckv, const void* ks, const void* vs,
                   const int* offset, const int* valid, int layer, int scale_layer, int B,
                   int Hkv, int S, int hd, float scale, void* out, cudaStream_t stream) {
#define AL_G(n)                                                                             \
  case n:                                                                                   \
    return launch_g<T, n>(q, kv_new, ks_new, vs_new, ckv, ks, vs, offset, valid, layer,     \
                          scale_layer, B, Hkv, S, hd, scale, out, stream);
  switch (G) {
    AL_G(1) AL_G(2) AL_G(3) AL_G(4) AL_G(6) AL_G(8)
    default: return cudaErrorInvalidValue;
  }
#undef AL_G
}

}  // namespace

// q, out: [B, Hq, hd] (dtype code: f32 or bf16); kv_new [B, Hkv, hd] int8;
// ks_new, vs_new [B, Hkv] f32; ckv [L, B, Hkv, S, hd] int8, contiguous and
// 16-byte aligned, written at slot offset[b] of layer `layer`; ks, vs
// [Ls, B, Hkv, S] f32 read at layer `scale_layer`; offset int32 [B]; valid
// int32 [B, S]. Requires G = Hq / Hkv in {1, 2, 3, 4, 6, 8}, hd % 16 == 0
// with hd / 16 dividing 32, and the shared memory of the launcher (checked
// by the Python wrapper).
AL_EXPORT int al_decode_attention_q4(int dtype, const void* q, const void* kv_new,
                                     const void* ks_new, const void* vs_new, void* ckv,
                                     const void* ks, const void* vs, const void* offset,
                                     const void* valid, int layer, int scale_layer, int B,
                                     int Hq, int Hkv, int S, int hd, float scale, void* out,
                                     void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || hd % 16 || 32 % (hd / 16)) return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offset);
  const int* val = static_cast<const int*>(valid);
  if (dtype == al::kBF16)
    return launch<__nv_bfloat16>(G, q, kv_new, ks_new, vs_new, ckv, ks, vs, off, val, layer,
                                 scale_layer, B, Hkv, S, hd, scale, out, st);
  if (dtype == al::kF32)
    return launch<float>(G, q, kv_new, ks_new, vs_new, ckv, ks, vs, off, val, layer, scale_layer,
                         B, Hkv, S, hd, scale, out, st);
  return cudaErrorInvalidValue;
}
