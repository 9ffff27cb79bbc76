// Timeline-chunked single-token decode attention with an online softmax
// across chunks, appending the fresh row in place: the chunk mode of the
// timeline decode core's kernel (db_kernel in decode_timeline.cuh, M =
// kChunk), one launch a call.
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
// The first version ran a block per (chunk, KV head, batch row) in two
// launches, the logits and chunk maxima through a device-memory workspace
// and the last block to finish (an atomic ticket) chaining the chunks. Here
// each (batch row, KV head) is a cluster of C blocks along the timeline,
// each block a whole number of chunks (ops/decode_timeline.py::
// timeline_plan with the chunk as the range unit; fewer chunks than C
// shrink C), and the running max that the TPU kernel rounds p against is
// rebuilt exactly inside the cluster: the K pass gives each block its
// chunks' maxima, the max exchange the max over the ranks before it, from
// which it walks its chunks in order; the sum exchange carries each block's
// l and product of alphas, and the P V partials are chained in rank order
// (decode_timeline.cuh's note). No workspace, no atomics, one launch. The
// result differs from the plain version only in the order of f32 sums and
// products. The owner of the offset's slot appends the fresh rows after its
// last load.
#include "decode_timeline.cuh"

namespace al {
namespace tl {

cudaError_t dispatch_chunk(int fmt, int dtype, int G, const Params& p, int C, bool info_only,
                           int* out, cudaStream_t stream) {
  return dispatch<kChunk>(fmt, dtype, G, p, C, info_only, out, stream);
}

}  // namespace tl
}  // namespace al

// fmt: 0 (K/V caches in q's dtype) or 1 (int8 K/V + f32 row scales); dtype
// code of q (f32 or bf16). q [B, Hq, hd]; k_new, v_new [B, Hkv, hd] in the
// cache's element type, 16-byte aligned; ks_new, vs_new [B, Hkv] f32 (fmt
// 1); ck, cv [L, B, Hkv, S, hd], contiguous and 16-byte aligned, written at
// `offset` of layer `layer` when 0 <= offset < S; ks, vs [Ls, B, Hkv, S] f32
// read at layer `scale_layer` (fmt 1), 16-byte aligned; valid int32 [B, S],
// 16-byte aligned; CH the chunk, a multiple of 32 dividing S. Output out [B,
// Hq, hd] in q's dtype. The plan (ops/decode_timeline.py::timeline_plan with
// chunk=CH): C blocks a cluster, each a whole number of chunks, `stages`
// ring stages. skip_rank: -1, or a planted fault for the checks (the later
// blocks' running max leaves that rank's chunks out). Requires G = Hq / Hkv
// in {1, 2, 3, 4, 6, 8} and a row of 16-byte vectors whose count divides 32
// (checked by the Python wrapper).
AL_EXPORT int al_decode_packed(int fmt, int dtype, const void* q, const void* k_new,
                               const void* v_new, const void* ks_new, const void* vs_new,
                               void* ck, void* cv, const void* ks, const void* vs,
                               const void* valid, int layer, int scale_layer, int offset, int B,
                               int Hq, int Hkv, int S, int hd, int CH, float scale, void* out,
                               int C, int stages, int skip_rank, void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  al::tl::Params p = al::tl::db_params(q, k_new, v_new, ks_new, vs_new, ck, cv, ks, vs, valid,
                                       layer, scale_layer, offset, B, Hkv, S, hd, scale, stages,
                                       nullptr, nullptr, out);
  p.unit = CH;
  p.skip_rank = skip_rank;
  return al::tl::dispatch_chunk(fmt, dtype, Hq / Hkv, p, C, false, nullptr,
                                static_cast<cudaStream_t>(stream));
}
