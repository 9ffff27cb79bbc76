// Whisper encoder self-attention, exact two-pass softmax.
//
// Replaces audio_llama_tpu/ops/enc_attention.py::_kernel (enc_attention,
// algo='twopass'): head-major [B*H, 1536, 64] bf16 blocks, a [1, T] f32 bias
// row of 0 / -1e9 for the padded keys, exp in f32 or (exp_dtype=bfloat16)
// on a bf16 argument; 1500 valid keys, 32 calls per clip on the
// `--enc_algo twopass` path.
//
// What sets the TPU kernel apart from v3 is that P is rounded against the
// TRUE row max: it holds the whole [bq, 1536] f32 score row in VMEM, takes
// its max, then p = exp(s + bias - m) rounded to bf16, P @ [V | 1] and
// o / l with no guard. A Hopper block cannot hold a 64 x 1536 f32 score
// tile in shared memory (384 KB). Of the two ways around it (two passes over
// the key tiles, or the whole row of a 16-row query tile, 96 KB a block) this
// kernel takes the two passes, because they are the tile loop the encoder's
// forward kernels run (attention_fwd.cuh, kSoftmaxTwoPass mode) at its
// 64-row tiles and 70 KB of shared memory, which keeps three blocks on an
// SM: pass 1 computes S tile by tile for
// the row max only (K read, V not), pass 2 computes S again and runs exp,
// the bf16 rounding and PV with the max fixed, so O is never rescaled. The
// second QK^T costs half as much tensor-core work again.
//
// Bound on the H100: operations, 4 * T * valid * hd * H = 11.8 GFLOP per
// layer at B = 1 (~12 us at 989 TFLOP/s; the recomputed QK^T is not part of
// the function's work).
#include "attention_fwd.cuh"

// q (pre-scaled), k, v, o: bf16 with element strides (batch, time, head) and
// a unit stride along hd. Keys at index >= valid_len (>= 1) get the -1e9
// bias. exp_bf16: round exp's argument to bf16 (exp_dtype=bfloat16).
AL_EXPORT int al_enc_attention_twopass(const void* q, const void* k, const void* v, void* o,
                                       int B, int T, int H, int hd, int valid_len,
                                       int exp_bf16, long long q_sb, long long q_st,
                                       long long q_sh, long long k_sb, long long k_st,
                                       long long k_sh, long long v_sb, long long v_st,
                                       long long v_sh, long long o_sb, long long o_st,
                                       long long o_sh, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (valid_len < 1) return cudaErrorInvalidValue;
  al::AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.exp_bf16 = exp_bf16;
  p.T = T;
  p.n_keys = valid_len;
  p.Hq = H;
  p.Hkv = H;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  return al::dispatch_attn_fwd<al::kSoftmaxTwoPass>(p, B, hd,
                                                    static_cast<cudaStream_t>(stream));
}
