// Causal GQA attention forward, bounded shift, K/V fetched asynchronously
// and only for the key tiles at or before the diagonal: the `dma` arm. The C
// entry also takes the `dma2` arm, which runs its wgmma / TMA kernel
// (causal_attention_dma2.cu).
//
// Replaces audio_llama_tpu/ops/causal_attention.py::_fwd_kernel_dma (:250,
// called at :436; `causal_mha(fwd_impl='dma')`). The TPU kernel exists
// because a BlockSpec grid fetches K/V even for the future chunks that
// @pl.when skips; it copies K/V chunk by chunk by hand (make_async_copy),
// double-buffered. It is bounded-softmax only (causal_attention.py:871-872).
// Shapes: qs [B, 2560, 24, 128] pre-scaled bf16, k/v [B, 2560, 8, 128], a
// [B, T] key bias, kn [B, 8] f32.
//
// Bound on the H100: operations, 4 * hd * Hq * B * T (T + 1) / 2 FLOP (QK^T
// and PV over the causal half): 0.0815 ms at B 2, T 2560 at 989 TFLOP/s.
//
// Design. A block owns 64 queries of one (batch, query head) and walks only
// the nv = q0 / 64 + 1 key tiles at or before its diagonal. Each K and V tile
// is copied global -> shared with 16-byte `cp.async.cg` copies, one commit
// group a tile; the copy of tile j+1 is in flight while tile j computes, and
// `cp.async.wait_group` plus a barrier releases a tile only when its group
// has landed: two K/V stages in shared memory. The per-tile arithmetic is the
// bounded mode's of attention_fwd.cuh (scores_tile, row_bound,
// fixed_softmax_lane with the f32 denominator, pv_tile) in the same order,
// so the kernel gives the bounded blocks kernel's bits. Shared memory at hd
// 128: 144 KB, one block an SM. A first version: WMMA, no TMA, no wgmma.
#include "attention_fwd.cuh"

namespace al {

cudaError_t dma2_fwd_sm90(const AttnParams& p, int B, int hd, cudaStream_t stream);

namespace dma {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int STAGES = 2;

template <int HD>
struct Smem {
  using A = AttnSmem<HD>;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = A::q_bytes;
  static constexpr size_t v_off = k_off + STAGES * A::kv_bytes;
  static constexpr size_t s_off = v_off + STAGES * A::kv_bytes;
  static constexpr size_t p_off = s_off + A::s_bytes;
  static constexpr size_t o_off = p_off + A::p_bytes;
  static constexpr size_t total = o_off + A::o_bytes;
};

// K and V rows [k0, k0 + kBK) of one KV head into one stage: 16-byte copies
// spread over the block, one commit group. T is a multiple of kBK (checked
// by the caller), so every row exists.
template <int HD>
__device__ __forceinline__ void issue_tile(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                           const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                           long long k_st, long long v_st, int k0) {
  constexpr int vpr = HD / 8;
  constexpr int LD = AttnSmem<HD>::LDQ;
  for (int i = threadIdx.x; i < kBK * vpr; i += blockDim.x) {
    const int r = i / vpr, c = (i % vpr) * 8;
    cp_async16(sK + r * LD + c, kb + (long long)(k0 + r) * k_st + c);
    cp_async16(sV + r * LD + c, vb + (long long)(k0 + r) * v_st + c);
  }
  cp_async_commit();
}

template <int HD>
__global__ void __launch_bounds__(kThreads) attn_fwd_dma_kernel(AttnParams p) {
  using A = AttnSmem<HD>;
  using Sm = Smem<HD>;
  constexpr int KV_ELEMS = kBK * A::LDQ;
  constexpr int HC = kBK / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + Sm::q_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + Sm::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + Sm::v_off);
  float* sS = reinterpret_cast<float*>(smem + Sm::s_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + Sm::p_off);
  float* sO = reinterpret_cast<float*>(smem + Sm::o_off);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const float* bias = p.key_bias + (long long)b * p.T;
  const int nv = min(p.T / kBK, (q0 + kBQ - 1) / kBK + 1);  // the valid tiles only

  // tile 0's copy goes out before the q tile is staged
  issue_tile<HD>(sK, sV, kb, vb, p.k_st, p.v_st, 0);
  copy_rows_bf16(sQ, A::LDQ, qb, p.q_st, q0, kBQ, p.T, HD);
  for (int i = tid; i < kBQ * A::LDO; i += blockDim.x) sO[i] = 0.f;

  const int row = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int qrow = q0 + row;
  __syncthreads();  // sQ is written
  const float shift = row_bound<HD>(sQ, row, half, p.kn[b * p.Hkv + kvh]);
  float l_run = 0.f;
  const float* srow0 = sS + row * A::LDS + half * HC;
  __nv_bfloat16* prow = sP + row * A::LDP + half * HC;

  for (int j = 0; j < nv; ++j) {
    const int st = j & 1;
    if (j + 1 < nv) {  // tile j+1 into the stage tile j-1 left
      issue_tile<HD>(sK + (st ^ 1) * KV_ELEMS, sV + (st ^ 1) * KV_ELEMS, kb, vb, p.k_st,
                     p.v_st, (j + 1) * kBK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread
    scores_tile<HD>(sQ, sK + st * KV_ELEMS, sS, warp);
    __syncwarp();
    l_run += fixed_softmax_lane<kSoftmaxBounded>(srow0, prow, j * kBK + half * HC, p, bias,
                                                 true, qrow, shift);
    __syncwarp();
    pv_tile<HD>(sP, sV + st * KV_ELEMS, sO, warp);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  if (qrow < p.T) {
    const float inv = l_run > 0.f ? 1.f / l_run : 0.f;
    const float* orow = sO + row * A::LDO + half * (HD / 2);
    __nv_bfloat16* dst = p.o + b * p.o_sb + (long long)qrow * p.o_st + h * p.o_sh + half * (HD / 2);
#pragma unroll
    for (int c = 0; c < HD / 2; c += 2) {
      __nv_bfloat162 two = __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = two;
    }
    if (half == 0) {
      p.l_out[(long long)bh * p.T + qrow] = l_run;
      p.m_out[(long long)bh * p.T + qrow] = shift;
    }
  }
}

template <int HD>
cudaError_t launch(const AttnParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = Smem<HD>::total;
  cudaError_t err = allow_smem(attn_fwd_dma_kernel<HD>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.T / kBQ, B * p.Hq);
  attn_fwd_dma_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const AttnParams& p, int B, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(p, B, stream);
    case 32: return launch<32>(p, B, stream);
    case 64: return launch<64>(p, B, stream);
    case 128: return launch<128>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace dma
}  // namespace al

// q (pre-scaled) and o: [B, T, Hq, hd]-strided bf16; k, v: [B, T, Hkv, hd]-
// strided with 16-byte aligned rows; key_bias: [B, T] f32; kn: [B*Hkv] f32;
// l_out, m_out: [B*Hq, T] f32 (m_out receives the bound c). T % 64 == 0.
// pipelined: 0 for dma (this file's kernel), 1 for dma2 (its wgmma / TMA
// kernel; key_bias 16-byte aligned).
AL_EXPORT int al_causal_attention_dma(const void* q, const void* k, const void* v, void* o,
                                      void* l_out, void* m_out, const void* key_bias,
                                      const void* kn, int B, int T, int Hq, int Hkv, int hd,
                                      long long q_sb, long long q_st, long long q_sh,
                                      long long k_sb, long long k_st, long long k_sh,
                                      long long v_sb, long long v_st, long long v_sh,
                                      long long o_sb, long long o_st, long long o_sh,
                                      int pipelined, void* stream) {
  if (B == 0 || T == 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv != 0 || T % al::kBK != 0) return cudaErrorInvalidValue;
  if (key_bias == nullptr || kn == nullptr) return cudaErrorInvalidValue;
  al::AttnParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.l_out = static_cast<float*>(l_out);
  p.m_out = static_cast<float*>(m_out);
  p.key_bias = static_cast<const float*>(key_bias);
  p.kn = static_cast<const float*>(kn);
  p.l_f32 = 1;
  p.T = T;
  p.n_keys = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pipelined ? al::dma2_fwd_sm90(p, B, hd, s) : al::dma::dispatch(p, B, hd, s);
}
