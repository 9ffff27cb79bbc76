// Single-token decode attention on a bf16/f32 KV cache, appending in place:
// the mono mode of the timeline decode core's kernel (db_kernel in
// decode_timeline.cuh, M = kMono).
//
// Replaces audio_llama_tpu/ops/decode_attention_mono.py::_kernel_mono_full
// (decode_attention_mono): cache [28, B, 8, max_len, 128] bf16, q [B, 24,
// 128], 28 calls per token on the bf16 main path. The fresh K/V row is
// written into the layer's cache slab at offset[b] IN PLACE (the cache
// tensors are updated, not copied; an offset outside [0, max_len) writes
// nothing), and every read of that slot takes the fresh row. The offset is
// an int32 [B] tensor on the device, one slot a batch row (the serving pool
// appends each row at its own), so a decode loop needs no host sync per
// token: each cluster reads its own row's.
//
// Arithmetic (ops/decode_attention_mono.py::decode_attention_plain): logits
// = (q . k) * scale, the scale applied after the f32 dot; a masked slot is
// out; m = the max over the valid slots; p = exp(logit - m) in f32, 0 on a
// masked slot; l = sum p in f32; p rounded to the cache dtype meets V, the
// f32 P V sums divided by l after, 0 where l = 0; out in q's dtype. The
// core's mono mode is its stats mode (the max clamped to -5e29 over a -1e30
// sentinel, p masked, rounded, not divided) with the division after P V:
// the same values as -inf masking (decode_timeline.cuh's note).
//
// Bound on the H100: bytes. The attended K and V rows are read once:
// 2 * 8 * n_valid * 128 * 2 B = 6.4 MB per layer at n_valid = 1568, B = 1
// (~1.9 us at 3.35 TB/s). The first version ran one block of 1024 threads
// per (batch row, KV head), 8 blocks on 132 SMs at B = 1, with the [G, S]
// logits of the whole slab in one block's shared memory (max_len capped by
// 227 KB). Here each (batch row, KV head) is a cluster of C blocks along
// the timeline (ops/decode_timeline.py::timeline_plan picks C and the ring;
// its ValueError caps max_len), each block streaming its range through a
// ring of bulk copies, the logits of a bf16 q on mma.sync, the softmax's
// max and sum and the P V partials exchanged through distributed shared
// memory (the core's note).
#include "decode_timeline.cuh"

namespace al {
namespace tl {

cudaError_t dispatch_mono(int fmt, int dtype, int G, const Params& p, int C, bool info_only,
                          int* out, cudaStream_t stream) {
  return dispatch<kMono>(fmt, dtype, G, p, C, info_only, out, stream);
}

}  // namespace tl
}  // namespace al

// q, out: [B, Hq, hd]; k_new, v_new: [B, Hkv, hd] in the cache dtype, 16-byte
// aligned; ck, cv: [L, B, Hkv, S, hd] contiguous and 16-byte aligned, updated
// in place at slot offset[b] of layer `layer`; offset: int32 [B] on the
// device; valid: int32 [B, S], 16-byte aligned. The plan
// (ops/decode_timeline.py::timeline_plan): C blocks a cluster along the
// timeline, `stages` ring stages. Requires q and both caches in one dtype
// (`dtype`), G = Hq / Hkv in {1, 2, 3, 4, 6, 8}, a row of 16-byte vectors
// whose count divides 32 and S % 32 == 0 (checked by the Python wrapper).
AL_EXPORT int al_decode_attention(int dtype, const void* q, const void* k_new, const void* v_new,
                                  void* ck, void* cv, const void* offset, const void* valid,
                                  int layer, int B, int Hq, int Hkv, int S, int hd, float scale,
                                  void* out, int C, int stages, void* stream) {
  if (B == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  al::tl::Params p = al::tl::db_params(q, k_new, v_new, nullptr, nullptr, ck, cv, nullptr,
                                       nullptr, valid, layer, 0, 0, B, Hkv, S, hd, scale, stages,
                                       nullptr, nullptr, out);
  p.off_dev = static_cast<const int*>(offset);
  p.off_stride = 1;
  return al::tl::dispatch_mono(al::kCacheT, dtype, Hq / Hkv, p, C, false, nullptr,
                               static_cast<cudaStream_t>(stream));
}
