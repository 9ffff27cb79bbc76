// Whisper encoder self-attention with the bounded (Cauchy-Schwarz) shift.
//
// Replaces audio_llama_tpu/ops/enc_attention.py::_kernel_v2 (enc_attention,
// algo='bounded': head-major [B*H, 1536, 64] bf16 blocks, kn [B*H, 1, 1]
// f32) and _kernel_v3's softmax='bounded' mode, the same function in the
// [B, T, H*hd] layout: both are this one kernel, which reads either layout
// through (batch, time, head) element strides. 1500 valid keys, 32 calls
// per clip on the `--enc_algo bounded` path.
//
// softmax(s) equals softmax(s - c) for any per-row c >= the row max; the
// TPU kernel takes c = ||q_i|| * max_j ||k_j|| (q pre-scaled, kn over every
// row of the padded timeline, computed by the wrapper), so it needs no max
// pass and never rescales its accumulator. The shift is loose: a row whose
// every exp underflows (bound - max > ~87 nats, reached by outlier keys)
// returns 0. That failure is the TPU kernel's and is kept, not repaired
// (CLAUDE.md softmax policy; tests/test_enc_attention.py pins it).
//
// Bound on the H100: operations, as enc_attention.cu (4 * T * valid * hd * H
// = 11.8 GFLOP per layer at B = 1, ~12 us at 989 TFLOP/s). Design: the tile
// loop of attention_fwd.cuh in its kSoftmaxBounded mode: each row's bound
// from its bf16 q row in shared memory (f32 squares), one streaming pass over
// the key tiles with p = bf16(expf(S - bound)), 0 past the valid keys, the
// denominator summed from that rounded p; no running max, no O rescale, out =
// l > 0 ? O / l : 0.
#include "attention_fwd.cuh"

// q (pre-scaled), k, v, o: bf16 with element strides (batch, time, head) and
// a unit stride along hd; kn: [B*H] f32 max key norms. Keys at index >=
// valid_len are masked.
AL_EXPORT int al_enc_attention_bounded(const void* q, const void* k, const void* v,
                                       const void* kn, void* o, int B, int T, int H, int hd,
                                       int valid_len, long long q_sb, long long q_st,
                                       long long q_sh, long long k_sb, long long k_st,
                                       long long k_sh, long long v_sb, long long v_st,
                                       long long v_sh, long long o_sb, long long o_st,
                                       long long o_sh, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  al::AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.kn = static_cast<const float*>(kn);
  p.T = T;
  p.n_keys = valid_len;
  p.Hq = H;
  p.Hkv = H;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  return al::dispatch_attn_fwd<al::kSoftmaxBounded>(p, B, hd,
                                                    static_cast<cudaStream_t>(stream));
}
