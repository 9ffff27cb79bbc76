// Causal GQA attention forward (prefill), with row statistics.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_fwd_kernel (causal_mha,
// softmax_mode='online', tri='always'): q [1, 1536, 24, 128] pre-scaled bf16,
// k/v [1, 1536, 8, 128], a [B, T] key-padding bias of 0 / -1e9, 28 calls per
// prefill. Writes o and the row statistics l (denominator) and m (row max) as
// [B*Hq, T] f32, the residuals a backward kernel reuses.
//
// Bound on the H100: operations. The causal half of QK^T and PV is
// 4 * hd * Hq * T (T + 1) / 2 = 14.5 GFLOP per layer at T = 1536, ~15 us at
// 989 TFLOP/s. Design (attention_fwd.cuh): tensor-core tiles of 64 queries
// by 64 keys, key tiles wholly in the future skipped, the query head mapped
// to its KV head by index (kv = h / G; K/V are never repeated), the padding
// bias added before the running max and the causal mask applied as the
// finite -1e9 of the TPU kernel, so a row whose every key is masked stays
// finite. exp runs in f32 (the TPU kernel runs it in bf16); P is rounded to
// bf16 before PV and the denominator is summed from that rounded P.
//
// causal = 0 is the kernel's tri='never' mode (causal_attention.py:114-132),
// which the ring of sequence-parallel training (ring_kernel.py:87) runs for
// every hop whose keys come from an earlier shard: the same tile loop with no
// causal mask and no skipped tile, so every key tile of the hop contributes;
// the source shard's key-padding bias still applies. Bound: all of QK^T and
// PV, 4 * hd * Hq * T^2 FLOP per batch row (25.8 GFLOP at the sp = 2 hop of
// training, B 2, T 1024: 26 us at 989 TFLOP/s).
//
// tri = 2 is the kernel's tri='cond' mode (causal_attention.py:125-131,
// `causal_mha(fwd_impl='blocks_cond')`, the JAX package's measured A/B arm):
// the causal mask only on the key tiles that reach past a block's first
// query. It computes exactly what 'always' computes (attention_fwd.cuh), so
// its result is the same bits; the bound is tri='always''s.
#include "attention_fwd.cuh"

// q (pre-scaled) and o: [B, T, Hq, hd]-strided bf16; k, v: [B, T, Hkv, hd]-
// strided; key_bias: [B, T] f32; l_out, m_out: [B*Hq, T] f32. tri: 1 for
// 'always', 0 for 'never', 2 for 'cond'.
AL_EXPORT int al_causal_attention(const void* q, const void* k, const void* v, void* o,
                                  void* l_out, void* m_out, const void* key_bias, int B,
                                  int T, int Hq, int Hkv, int hd, long long q_sb,
                                  long long q_st, long long q_sh, long long k_sb,
                                  long long k_st, long long k_sh, long long v_sb,
                                  long long v_st, long long v_sh, long long o_sb,
                                  long long o_st, long long o_sh, int tri,
                                  void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0) return cudaErrorInvalidValue;
  al::AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.l_out = static_cast<float*>(l_out);
  p.m_out = static_cast<float*>(m_out);
  p.key_bias = static_cast<const float*>(key_bias);
  p.T = T;
  p.n_keys = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tri) {
    case 0: return al::dispatch_attn_fwd<false>(p, B, hd, s);
    case 1: return al::dispatch_attn_fwd<true>(p, B, hd, s);
    case 2: return al::dispatch_attn_fwd<true, al::kSoftmaxOnline, true>(p, B, hd, s);
    default: return cudaErrorInvalidValue;
  }
}
