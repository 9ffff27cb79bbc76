// What the port's attention kernels share: the forwards' parameter block
// (AttnParams) and the softmax-mode codes. It holds no kernel: the forwards
// and the causal backward are on wgmma and TMA (sm90.cuh and the kernels on
// it: causal_attention.cu, causal_attention_fixed.cu,
// causal_attention_dma2.cu, enc_attention.cu, causal_attention_bwd.cu).
#pragma once

#include "common.cuh"

namespace al {

constexpr int kSoftmaxOnline = 0;   // running true max (encoder v3, causal)
constexpr int kSoftmaxBounded = 1;  // fixed shift ||q_i|| kn (the bounded family)
constexpr int kSoftmaxTwoPass = 2;  // max pass, then exp and PV (twopass)

struct AttnParams {
  const __nv_bfloat16* q;  // pre-scaled
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* l_out;            // [B*Hq, T] row denominators (the causal forwards)
  float* m_out;            // [B*Hq, T] row shifts (the causal forwards)
  const float* key_bias;   // [B, T] additive key bias (the causal forwards)
  const float* kn;         // [B*Hkv] max key norm per (batch, KV head) (bounded)
  int exp_bf16;            // two-pass: round exp's argument to bf16
  int T;                   // rows of q/k/v/o along time
  int n_keys;              // keys at index >= n_keys are masked (the encoder)
  int Hq, Hkv;
  long long q_sb, q_st, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_st, o_sh;
};

}  // namespace al
