// Single-token decode attention on a quantized KV cache, appending the
// fresh row in place: the K/V-combined int4 cache and the int8 cache.
//
// Replaces audio_llama_tpu/ops/decode_attention_mono.py::_kernel_mono4
// (decode_attention_quantized4_mono) and ::_kernel_mono_q8
// (decode_attention_quantized_mono). int4 (KV8 = false): one cache [L, B,
// Hkv, S, hd] int8 where byte d of a row holds K's dim d offset-binary in the
// low nibble and V's dim d signed in the high nibble (models/llama.py
// quantize_kv_rows4). int8 (KV8 = true): separate signed K and V caches of
// that shape (quantize_kv_rows). Both: per-row f32 scales [L|1, B, Hkv, S],
// q [B, Hq, hd]. As in the TPU kernels:
//  - logits = (q . k_int) * (k_scale[slot] * scale) in f32; a slot is dead
//    (-1e30) where valid <= 0 or slot == offset, so the append slot's scale,
//    written by the caller before the launch, is never read;
//  - the fresh row (its int rows and scales) enters analytically with its
//    logit lf, when its slot is inside the cache and valid. int4: the slab's
//    softmax runs at its own max m1, then merges with the fresh row at
//    m = max(m1, lf); int8: m = max(m1, lf) from the start, so the merge's
//    a1 = exp(m1 - m) is exactly 1;
//  - p = exp(logit - max), the denominator the f32 sum of p; P meets V as
//    (p * v_scale) rounded to q's dtype;
//  - the fresh rows are written into the cache at offset[b] in place
//    (nothing is written for an offset outside the cache), after the slab
//    has been read.
// Offsets are an int32 [B] device tensor, so a decode loop needs no host sync.
//
// Bound on the H100: bytes. The valid rows of one layer's slab are read
// once, hd bytes a row (int4) or 2 hd (int8), plus 8 bytes of scales: ~1.7
// MB (int4) or ~3.3 MB (int8) per batch row at 8 KV heads, S = 1568 (0.5 /
// 1.0 us at 3.35 TB/s). Design: decode_attention.cu's, one block of 1024
// threads per (batch row, KV head) with its G query heads, so each row is
// read once for all G heads: one thread per key row with 16-byte loads for
// the logits, then a branch-free PV pass in which each thread owns 16 bytes
// (16 dims) of a strided subset of rows. At B = 1 this fills 8 of 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kDead = -1e30f;

// K and V of one cache byte: int8 signed bytes, or the int4 combined byte
template <bool KV8>
__device__ __forceinline__ int key_of(uint32_t byte) {
  return KV8 ? (int)(signed char)byte : (int)(byte & 0xF) - 8;
}
template <bool KV8>
__device__ __forceinline__ int value_of(uint32_t byte) {
  return KV8 ? (int)(signed char)byte : (int)(signed char)byte >> 4;
}

// int4: ck == cv and k_new == v_new (the combined rows); int8: separate.
template <typename T, int G, bool KV8>
__global__ void __launch_bounds__(kThreads)
decode_quant_kernel(const T* __restrict__ q, const int8_t* k_new, const int8_t* v_new,
                    const float* __restrict__ ks_new, const float* __restrict__ vs_new,
                    int8_t* ck, int8_t* cv, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ offset,
                    const int* __restrict__ valid, int layer, int scale_layer, int B, int Hkv,
                    int S, int hd, float scale, T* __restrict__ out) {
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
  const int8_t* kslab = ck + row0 * hd;
  const int8_t* vslab = cv + row0 * hd;
  const size_t srow = (((size_t)scale_layer * B + b) * Hkv + kvh) * (size_t)S;
  const float* ksr = ks + srow;
  const float* vsr = vs + srow;
  const int off = offset[b];
  const int* vrow = valid + (size_t)b * S;
  const int8_t* kfresh = k_new + ((size_t)b * Hkv + kvh) * hd;
  const int8_t* vfresh = v_new + ((size_t)b * Hkv + kvh) * hd;
  const float ksn = ks_new[(size_t)b * Hkv + kvh], vsn = vs_new[(size_t)b * Hkv + kvh];

  for (int i = tid; i < G * hd; i += blockDim.x)
    qs[i] = al::to_f32(q[((size_t)b * Hq + kvh * G) * hd + i]);
  __syncthreads();

  // the fresh row's logit, one warp per query head
  const bool fresh_on = off >= 0 && off < S && vrow[off] > 0;
  if (warp < G) {
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32)
      acc += qs[warp * hd + d] * (float)key_of<KV8>((uint8_t)kfresh[d]);
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
    const uint4* krow = reinterpret_cast<const uint4*>(kslab + (size_t)pos * hd);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int c = 0; c < nvec; ++c) {
      const uint4 v = krow[c];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float kf = (float)key_of<KV8>((w[j / 4] >> (8 * (j % 4))) & 0xFF);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += qs[g * hd + c * 16 + j] * kf;
      }
    }
    const float f = ksr[pos] * scale;
#pragma unroll
    for (int g = 0; g < G; ++g) logit[g * S + pos] = acc[g] * f;
  }
  __syncthreads();

  // softmax over the slab per head: p = exp(l - m1) in place, l1 = sum p;
  // int8 folds the fresh row's logit into m1
  float m1[G], l1[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* lg = logit + (size_t)g * S;
    float mx = -INFINITY;
    for (int i = tid; i < S; i += blockDim.x) mx = fmaxf(mx, lg[i]);
    mx = al::block_max(mx, red);
    if (KV8) mx = fmaxf(mx, lfs[g]);
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

  // PV over the slab: thread (row group r, 16-byte column c); (p * v_scale)
  // meets V rounded to T
  const int rows = blockDim.x / nvec;
  const int c = tid % nvec, r = tid / nvec;
  float acc[G][16];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[g][j] = 0.f;
  for (int pos = r; pos < S; pos += rows) {
    const uint4 v = reinterpret_cast<const uint4*>(vslab + (size_t)pos * hd)[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    const float vsc = vsr[pos];
    float vf[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      vf[j] = (float)value_of<KV8>((w[j / 4] >> (8 * (j % 4))) & 0xFF);
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
  // (int8: m == m1, a1 == 1)
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
    const float vn = (float)value_of<KV8>((uint8_t)vfresh[d]);
    const float o = (a1 * s + (pf * vsn) * vn) / (a1 * lg + pf);
    out[((size_t)b * Hq + kvh * G) * hd + i] = al::from_f32<T>(o);
  }
  __syncthreads();

  // append the fresh rows (after every read of the slab)
  if (off >= 0 && off < S) {
    for (int i = tid; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(ck + (row0 + off) * hd)[i] =
          reinterpret_cast<const uint4*>(kfresh)[i];
      if (KV8)
        reinterpret_cast<uint4*>(cv + (row0 + off) * hd)[i] =
            reinterpret_cast<const uint4*>(vfresh)[i];
    }
  }
}

struct Args {
  const void *q, *k_new, *v_new, *ks_new, *vs_new;
  void *ck, *cv;
  const void *ks, *vs;
  const int *offset, *valid;
  int layer, scale_layer, B, Hkv, S, hd;
  float scale;
  void* out;
  cudaStream_t stream;
};

template <typename T, int G, bool KV8>
cudaError_t launch_g(const Args& a) {
  const size_t smem =
      sizeof(float) * ((size_t)G * a.hd + (size_t)G * a.S + (size_t)kWarps * G * a.hd);
  cudaError_t err = al::allow_smem(decode_quant_kernel<T, G, KV8>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.Hkv, a.B);
  decode_quant_kernel<T, G, KV8><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.k_new),
      static_cast<const int8_t*>(a.v_new), static_cast<const float*>(a.ks_new),
      static_cast<const float*>(a.vs_new), static_cast<int8_t*>(a.ck),
      static_cast<int8_t*>(a.cv), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), a.offset, a.valid, a.layer, a.scale_layer, a.B, a.Hkv,
      a.S, a.hd, a.scale, static_cast<T*>(a.out));
  return cudaGetLastError();
}

template <typename T, bool KV8>
cudaError_t launch(int G, const Args& a) {
  switch (G) {
    case 1: return launch_g<T, 1, KV8>(a);
    case 2: return launch_g<T, 2, KV8>(a);
    case 3: return launch_g<T, 3, KV8>(a);
    case 4: return launch_g<T, 4, KV8>(a);
    case 6: return launch_g<T, 6, KV8>(a);
    case 8: return launch_g<T, 8, KV8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool KV8>
int launch_dtype(int dtype, int Hq, const Args& a) {
  if (a.B == 0) return cudaSuccess;
  if (a.Hkv <= 0 || Hq % a.Hkv != 0 || a.hd % 16 || 32 % (a.hd / 16))
    return cudaErrorInvalidValue;
  const int G = Hq / a.Hkv;
  if (dtype == al::kBF16) return launch<__nv_bfloat16, KV8>(G, a);
  if (dtype == al::kF32) return launch<float, KV8>(G, a);
  return cudaErrorInvalidValue;
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
  const Args a{q, kv_new, kv_new, ks_new, vs_new, ckv, ckv, ks, vs,
               static_cast<const int*>(offset), static_cast<const int*>(valid), layer,
               scale_layer, B, Hkv, S, hd, scale, out, static_cast<cudaStream_t>(stream)};
  return launch_dtype<false>(dtype, Hq, a);
}

// As al_decode_attention_q4 with separate int8 rows k_new, v_new [B, Hkv,
// hd] and caches ck, cv [L, B, Hkv, S, hd] (both written at the offset).
AL_EXPORT int al_decode_attention_q8(int dtype, const void* q, const void* k_new,
                                     const void* v_new, const void* ks_new, const void* vs_new,
                                     void* ck, void* cv, const void* ks, const void* vs,
                                     const void* offset, const void* valid, int layer,
                                     int scale_layer, int B, int Hq, int Hkv, int S, int hd,
                                     float scale, void* out, void* stream) {
  const Args a{q, k_new, v_new, ks_new, vs_new, ck, cv, ks, vs,
               static_cast<const int*>(offset), static_cast<const int*>(valid), layer,
               scale_layer, B, Hkv, S, hd, scale, out, static_cast<cudaStream_t>(stream)};
  return launch_dtype<true>(dtype, Hq, a);
}
