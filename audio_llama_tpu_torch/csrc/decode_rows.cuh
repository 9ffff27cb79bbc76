// Cache-row access shared by the timeline decode kernels
// (decode_attention_db.cu, decode_attention_packed.cu): the element type of
// a cache format, 16-byte row vectors, and the K or V value of one element.
//   kCacheT  K and V caches in q's dtype (bf16 or f32);
//   kInt8    signed int8 K and V caches (per-row f32 scales beside them);
//   kInt4    ONE K/V-combined int8 cache: byte d holds K's dim d
//            offset-binary in the low nibble and V's signed in the high
//            nibble (models/llama.py quantize_kv_rows4).
#pragma once

#include "common.cuh"

namespace al {

enum CacheFmt { kCacheT = 0, kInt8 = 1, kInt4 = 2 };

template <typename T, int F>
struct CacheElem {
  using type = int8_t;
};
template <typename T>
struct CacheElem<T, kCacheT> {
  using type = T;
};

template <typename E>
struct __align__(16) Vec16 {
  static constexpr int N = 16 / sizeof(E);
  E v[N];
};

template <int F, typename E>
__device__ __forceinline__ float key_of(E e) {
  if constexpr (F == kCacheT) return to_f32(e);
  else if constexpr (F == kInt8) return (float)(int)e;
  else return (float)(((int)(uint8_t)e & 0xF) - 8);
}

template <int F, typename E>
__device__ __forceinline__ float value_of(E e) {
  if constexpr (F == kCacheT) return to_f32(e);
  else if constexpr (F == kInt8) return (float)(int)e;
  else return (float)((int)e >> 4);  // e is signed: the high nibble, sign-extended
}

// x rounded to T and back (the TPU kernels' casts to the compute dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

}  // namespace al
