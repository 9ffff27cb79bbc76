// The normalized mode of the timeline decode core's kernel (db_kernel in
// decode_timeline.cuh, M = kNorm): single-token decode attention over
// one (batch row, KV head) slab, appending the fresh row in place, the
// output normalized. Two entries share its instances:
//
//   al_decode_db: the db kernels' normalized mode (rows 16-18, the
//     attention of `attn_impl='decode_kernel'`). Replaces
//     audio_llama_tpu/ops/decode_attention_db.py::_kernel,
//     ::_kernel_quantized and ::_kernel_quantized4 with stats=False
//     (decode_attention_db, decode_attention_quantized_db,
//     decode_attention_quantized4_db); its note is decode_attention_db.cu's,
//     whose stats mode takes the same arguments.
//   al_decode_attention_single: the single-buffered decode attention (rows
//     29, 30). Replaces audio_llama_tpu/ops/decode_attention.py::_kernel
//     (decode_attention, bf16/f32 cache) and ::_kernel_quantized
//     (decode_attention_quantized, int8 cache with per-slot f32 scales).
//     The TPU kernel's grid (B, Hkv) becomes one thread-block cluster per
//     (batch row, KV head) along the timeline (decode_timeline.cuh: its
//     note gives the bound, the design and the softmax's order across the
//     cluster). The fresh row is written into the layer's slab at the
//     offset on the device IN PLACE (an offset outside [0, max_len) writes
//     nothing, as the TPU kernel's clamped write-back window of the
//     unpatched slab); every read of the offset's slot takes the fresh row.
//
// Softmax order of the TPU kernels, which normalize BEFORE PV: logits =
// (q . k) * scale in f32 (int8 / int4: * (k_s * scale), k_s patched at the
// offset from the fresh row's scale); masked slots get -1e30; m = max over
// the whole slab; p = exp(l - m); p = p / sum(p); p is rounded to V's dtype
// (quantized: (p * v_s) to the compute dtype, v_s patched at the offset);
// out = p @ V in f32, rounded to q's dtype. The scale slabs are never
// written: the caller owns them.
#include "decode_timeline.cuh"

namespace al {
namespace tl {

cudaError_t dispatch_normalized(int fmt, int dtype, int G, const Params& p, int C,
                                bool info_only, int* out, cudaStream_t stream) {
  return dispatch<kNorm>(fmt, dtype, G, p, C, info_only, out, stream);
}

}  // namespace tl
}  // namespace al

// The arguments of al_decode_db_stats (decode_attention_db.cu) with the
// global `offset`, and one output, out [B, Hq, hd] in q's dtype.
AL_EXPORT int al_decode_db(int fmt, int dtype, const void* q, const void* k_new,
                           const void* v_new, const void* ks_new, const void* vs_new, void* ck,
                           void* cv, const void* ks, const void* vs, const void* valid,
                           int layer, int scale_layer, int offset, int B, int Hq, int Hkv,
                           int S, int hd, float scale, void* out, int C, int stages,
                           void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const al::tl::Params p = al::tl::db_params(q, k_new, v_new, ks_new, vs_new, ck, cv, ks, vs,
                                             valid, layer, scale_layer, offset, B, Hkv, S, hd,
                                             scale, stages, nullptr, nullptr, out);
  return al::tl::dispatch_normalized(fmt, dtype, Hq / Hkv, p, C, false, nullptr,
                                     static_cast<cudaStream_t>(stream));
}

// q, out: [B, Hq, hd] in `dtype` (the compute dtype); k_new, v_new: [B, Hkv,
// hd] in the cache dtype, 16-byte aligned; ck, cv: [L, B, Hkv, S, hd]
// contiguous and 16-byte aligned, written in place at slot offset[0] of
// layer `layer`; offset: one int32 on the device; valid: int32 [B, S],
// 16-byte aligned. quant = 1: int8 caches, ks / vs this layer's [B, Hkv, S]
// f32 scales (read only, 16-byte aligned), ks_new / vs_new [B, Hkv] f32;
// quant = 0: caches in `dtype`, the scale pointers unused. The plan
// (ops/decode_timeline.py::timeline_plan): C blocks a cluster along the
// timeline, `stages` ring stages. Requires G = Hq / Hkv in {1, 2, 3, 4, 6,
// 8}, hd / (16 B / element) dividing 32 and S % 32 == 0 (checked by the
// Python wrapper).
AL_EXPORT int al_decode_attention_single(int dtype, int quant, const void* q,
                                         const void* k_new, const void* v_new, void* ck,
                                         void* cv, const void* ks, const void* vs,
                                         const void* ks_new, const void* vs_new,
                                         const void* offset, const void* valid, int layer,
                                         int B, int Hq, int Hkv, int S, int hd, float scale,
                                         void* out, int C, int stages, void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  al::tl::Params p = al::tl::db_params(q, k_new, v_new, ks_new, vs_new, ck, cv, ks, vs, valid,
                                       layer, 0, 0, B, Hkv, S, hd, scale, stages, nullptr,
                                       nullptr, out);
  p.off_dev = static_cast<const int*>(offset);
  return al::tl::dispatch_normalized(quant ? al::kInt8 : al::kCacheT, dtype, Hq / Hkv, p, C,
                                     false, nullptr, static_cast<cudaStream_t>(stream));
}
