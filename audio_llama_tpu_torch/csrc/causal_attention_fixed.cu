// Causal GQA attention forward with a fixed per-row shift: the bounded and
// the two-pass softmax modes of the training attention's A/B arms.
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_fwd_kernel with
// softmax='bounded' (:109-143, :175-178; `causal_mha(softmax_mode='bounded')`,
// fwd_impl 'blocks' or 'blocks_cond') and ::_fwd_kernel_twopass (:188-247;
// softmax_mode='twopass'), both called at :593. Shapes at the JAX package's
// A/B geometry (experiments/causal_dma_bench.py): qs [B, 2560, 24, 128]
// pre-scaled bf16, k/v [B, 2560, 8, 128], a [B, T] key bias of 0 / -1e9, kn
// [B, 8] f32 (the max key norm of each KV head over all T keys). Writes o and
// the row statistics l and c as [B*Hq, T] f32, the residuals the backward
// kernels (causal_attention_bwd.cu) take as (l, m).
//
//   bounded: c_i = ||qs_i|| * kn[b, kv head]; p = exp(s + bias - c) in f32,
//       the causal mask -1e9 before the exp; l summed from that f32 p (the
//       TPU kernel's explicit row sum); P rounded to bf16 for PV; o = l > 0 ?
//       O / l : 0, so a row whose exp all underflow (c far above the true
//       max: outlier keys) is 0, as the TPU kernel's is.
//   twopass: pass 1 takes the TRUE row max c of s + bias + causal mask over
//       the key tiles at or before the diagonal (K read, V not); pass 2 forms
//       p = exp(bf16(s + bias - c)) (the TPU kernel's bf16 exp argument for
//       bf16 V), rounds it to bf16, sums l from the rounded p (its ones
//       column) and accumulates PV with no rescale. tri does not apply.
//
// Bound on the H100: operations, 4 * hd * Hq * B * T (T + 1) / 2 FLOP (QK^T
// and PV over the causal half; the two-pass mode's repeated QK^T is not part
// of the function's work): 0.0815 ms at B 2, T 2560 at 989 TFLOP/s. Design:
// bounded runs the tile loop of attention_fwd.cuh (64 queries by 64 keys,
// WMMA, future tiles skipped) in its kSoftmaxBounded mode with l_f32 and the
// bias and mask of fixed_logit; no running max and no rescale of O. tri = 2
// ('cond') masks only the tiles that reach past the block's first query: the
// same bits as 'always'. twopass goes to its wgmma / TMA kernel
// (causal_attention_twopass.cu, whose note gives its design).
#include "attention_fwd.cuh"

namespace al {
cudaError_t twopass_fwd_sm90(const AttnParams& p, int B, int hd, cudaStream_t stream);
}  // namespace al

// q (pre-scaled) and o: [B, T, Hq, hd]-strided bf16; k, v: [B, T, Hkv, hd]-
// strided; key_bias: [B, T] f32; kn: [B*Hkv] f32 (bounded; ignored by
// twopass); l_out, m_out: [B*Hq, T] f32 (m_out receives c). softmax: 1
// bounded, 2 twopass; tri: 1 'always', 2 'cond' (bounded only); exp_bf16:
// round the two-pass mode's exp argument to bf16.
AL_EXPORT int al_causal_attention_fixed(const void* q, const void* k, const void* v, void* o,
                                        void* l_out, void* m_out, const void* key_bias,
                                        const void* kn, int B, int T, int Hq, int Hkv, int hd,
                                        long long q_sb, long long q_st, long long q_sh,
                                        long long k_sb, long long k_st, long long k_sh,
                                        long long v_sb, long long v_st, long long v_sh,
                                        long long o_sb, long long o_st, long long o_sh,
                                        int softmax, int tri, int exp_bf16, void* stream) {
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
  p.kn = static_cast<const float*>(kn);
  p.exp_bf16 = exp_bf16;
  p.l_f32 = softmax == al::kSoftmaxBounded;
  p.T = T;
  p.n_keys = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (softmax == al::kSoftmaxBounded && kn != nullptr) {
    if (tri == 1) return al::dispatch_attn_fwd<true, al::kSoftmaxBounded>(p, B, hd, s);
    if (tri == 2) return al::dispatch_attn_fwd<true, al::kSoftmaxBounded, true>(p, B, hd, s);
  }
  if (softmax == al::kSoftmaxTwoPass && tri == 1) return al::twopass_fwd_sm90(p, B, hd, s);
  return cudaErrorInvalidValue;
}
