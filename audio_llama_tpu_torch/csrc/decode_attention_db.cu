// Single-token decode attention over one (batch row, KV head) slab of the
// KV-cache timeline, appending the fresh row in place, in two modes of one
// template (the core's Mode):
//   stats (kStats): the unnormalized flash statistics of one rank's
//     slab, for timeline-sharded decode. Replaces
//     audio_llama_tpu/ops/decode_attention_db.py::_kernel (stats=True,
//     decode_attention_db_stats), ::_kernel_quantized (stats=True,
//     decode_attention_quantized_db_stats) and ::_kernel_quantized4
//     (stats=True, decode_attention_quantized4_db_stats);
//   normalized (kNorm): the attention output of single-device decode
//     (`attn_impl='decode_kernel'`). Replaces the same three functions with
//     stats=False (decode_attention_db, decode_attention_quantized_db,
//     decode_attention_quantized4_db).
// The cache format is a template argument too (decode_rows.cuh): K and V
// caches [L, B, Hkv, S, hd] in q's dtype, int8 K and V caches with per-row
// f32 scales [Ls, B, Hkv, S], or one K/V-combined int4 cache with both scale
// slabs.
//
// S is the slab's slot count; `off` the append slot in the slab's own
// coordinates: the global offset in normalized mode, the local one (global
// offset - rank * S) in stats mode, outside [0, S) on the ranks that do not
// own it. As in the TPU kernels, over the slab with the fresh row standing at
// off (read from the fresh-row arguments, never from the cache):
//   logits = (q . k) * scale, or * (k_scale * scale) with the fresh row's
//   scale at off; lanes whose valid <= 0 are -1e30;
//   stats:      m = max(rowmax, -5e29); p = valid ? exp(logit - m) : 0;
//               l = sum p; acc = sum (p, or p * v_scale, rounded to q's
//               dtype) * v; all f32, nothing normalized. An all-invalid slab
//               gives (-5e29, 0, 0), a no-op in the cross-rank merge
//               (ops/attention.py::merge_partial_stats).
//   normalized: m = rowmax (no clamp); p = exp(logit - m) (no mask: an
//               invalid lane's -1e30 gives 0 unless every lane is invalid);
//               p = p / sum p in f32; out = sum (p, or p * v_scale, rounded
//               to q's dtype) * v, written in q's dtype.
// The owner writes the fresh K/V row (or the combined row) into the cache at
// off after every read of the slab; the other ranks write nothing. The
// caller writes the append slot's scales, as in the JAX package.
//
// The TPU kernels' double-buffered slab DMAs become the timeline decode
// core (decode_timeline.cuh): one thread-block cluster per (batch row, KV
// head) along the timeline, a ring of bulk copies in each block, the
// softmax's max and sum and the P V partials exchanged in rank order
// through distributed shared memory. Its note gives the bound (bytes: the
// valid rows read once, 2 hd bytes a row for K and V in bf16 twice, 2 hd
// int8, hd int4, plus 8 bytes of scales) and the design. The kernel,
// db_kernel, is the core's; this file compiles the stats mode's instances
// and its entry, decode_attention_norm.cu the normalized mode's (and the
// single-buffered kernel's entry, which shares them), so the two build in
// parallel.
#include "decode_timeline.cuh"

namespace al {
namespace tl {

cudaError_t dispatch_stats(int fmt, int dtype, int G, const Params& p, int C, bool info_only,
                           int* out, cudaStream_t stream) {
  return dispatch<kStats>(fmt, dtype, G, p, C, info_only, out, stream);
}

}  // namespace tl
}  // namespace al

// fmt: 0 (K/V caches in q's dtype), 1 (int8 K/V + scales), 2 (K/V-combined
// int4 + scales); dtype code of q (f32 or bf16). q [B, Hq, hd]; k_new, v_new
// [B, Hkv, hd] in the cache's element type (fmt 2: both the combined rows),
// 16-byte aligned; ks_new, vs_new [B, Hkv] f32 (fmt 1, 2); ck, cv [L, B, Hkv,
// S, hd] (fmt 2: both the combined cache), contiguous and 16-byte aligned,
// written at local_off of layer `layer` when 0 <= local_off < S; ks, vs [Ls,
// B, Hkv, S] f32 read at layer `scale_layer` (fmt 1, 2), 16-byte aligned;
// valid int32 [B, S], 16-byte aligned. Outputs m, l [B, Hq] and acc [B, Hq,
// hd], f32. The plan (ops/decode_timeline.py::timeline_plan): C blocks a
// cluster along the timeline, `stages` ring stages. Requires G = Hq / Hkv in
// {1, 2, 3, 4, 6, 8}, a row of 16-byte vectors whose count divides 32 and S
// % 32 == 0 (checked by the Python wrapper). al_decode_db
// (decode_attention_norm.cu) takes the same arguments in the normalized mode.
AL_EXPORT int al_decode_db_stats(int fmt, int dtype, const void* q, const void* k_new,
                                 const void* v_new, const void* ks_new, const void* vs_new,
                                 void* ck, void* cv, const void* ks, const void* vs,
                                 const void* valid, int layer, int scale_layer, int local_off,
                                 int B, int Hq, int Hkv, int S, int hd, float scale, void* m,
                                 void* l, void* acc, int C, int stages, void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  const al::tl::Params p = al::tl::db_params(q, k_new, v_new, ks_new, vs_new, ck, cv, ks, vs,
                                             valid, layer, scale_layer, local_off, B, Hkv, S,
                                             hd, scale, stages, m, l, acc);
  return al::tl::dispatch_stats(fmt, dtype, Hq / Hkv, p, C, false, nullptr,
                                static_cast<cudaStream_t>(stream));
}

// Registers, local bytes, shared memory and resident clusters of an
// instance at its plan (out[4]): kind 0 the stats mode, 1 the normalized
// mode (the single-buffered kernel's calls are its fmt 0 and 1), 2 the mono
// mode (fmt 0), 3 the chunk mode (fmt 0 and 1; `unit` the chunk, else 32).
// fmt, dtype as above.
AL_EXPORT int al_decode_timeline_info(int kind, int fmt, int dtype, int G, int S, int hd, int C,
                                      int stages, int unit, void* out) {
  al::tl::Params p{};
  p.S = S;
  p.hd = hd;
  p.stages = stages;
  p.unit = unit;
  int* o = static_cast<int*>(out);
  if (kind == 0) return al::tl::dispatch_stats(fmt, dtype, G, p, C, true, o, nullptr);
  if (kind == 1) return al::tl::dispatch_normalized(fmt, dtype, G, p, C, true, o, nullptr);
  if (kind == 2) return al::tl::dispatch_mono(fmt, dtype, G, p, C, true, o, nullptr);
  if (kind == 3) return al::tl::dispatch_chunk(fmt, dtype, G, p, C, true, o, nullptr);
  return cudaErrorInvalidValue;
}
