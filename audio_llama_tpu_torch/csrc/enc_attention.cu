// Whisper encoder self-attention: non-causal MHA over [B, T, H*hd] with a
// static valid-key length.
//
// Replaces audio_llama_tpu/ops/enc_attention.py::_kernel_v3 (enc_attention,
// algo='v3', softmax='safe'): q/k/v [1, 1536, 1280] bf16, H = 20, hd = 64,
// 1500 valid keys, 32 calls per clip.
//
// Bound on the H100: operations. QK^T and PV are 4 * T * valid * hd * H
// = 11.8 GFLOP per layer at B = 1, ~12 us at 989 TFLOP/s, against 15.7 MB
// of q/k/v/o (~4.7 us). The TPU kernel keeps the whole 1536-key timeline in
// VMEM for an exact two-pass softmax; a Hopper block cannot hold it in shared
// memory, so this kernel (attention_fwd.cuh) tiles the keys with a running
// true max, which is exact to rounding, and runs both products on the tensor
// cores. It reads the projections' [B, T, H*hd] layout through a head stride
// (no transposes), skips key tiles wholly past the valid length, rounds P to
// bf16 before PV and sums the denominator from that same rounded P, as the
// TPU kernel's ones column does. Padded query rows are computed but
// unspecified, as in the TPU kernel.
#include "attention_fwd.cuh"

// q (pre-scaled), k, v, o: bf16 with element strides (batch, time, head) and
// a unit stride along hd. Keys at index >= valid_len are masked.
AL_EXPORT int al_enc_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int T, int H, int hd, int valid_len, long long q_sb,
                               long long q_st, long long q_sh, long long k_sb, long long k_st,
                               long long k_sh, long long v_sb, long long v_st, long long v_sh,
                               long long o_sb, long long o_st, long long o_sh, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  al::AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.T = T;
  p.n_keys = valid_len;
  p.Hq = H;
  p.Hkv = H;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  return al::dispatch_attn_fwd<false>(p, B, hd, static_cast<cudaStream_t>(stream));
}
