// Hopper (sm_90a) building blocks in raw PTX, and the attention forward
// block built on them.
//
// Replaces no TPU kernel by itself: it holds what the port's wgmma/TMA
// kernels share: the W4A16 prefill (int4_matmul.cu, which uses the blocks
// below and not the attention block), the causal backward
// (causal_attention_bwd.cu: dq and dk/dv, on the tiles, products and
// AttnPlace below with a ring of its own) and the attention forwards. Those are
// causal_attention.cu (the redesign of
// audio_llama_tpu/ops/causal_attention.py::_fwd_kernel :101, online, tri
// 'always' / 'cond' / 'never'), causal_attention_fixed.cu (its bounded mode,
// with ::_fwd_kernel_dma :250, and ::_fwd_kernel_twopass :188) and
// causal_attention_dma2.cu (::_fwd_kernel_dma2 :321), and the encoder's
// non-causal forward in its three softmax modes, enc_attention.cu
// (audio_llama_tpu/ops/enc_attention.py::_kernel_v3 :102, ::_kernel_v2 :54,
// ::_kernel :232). They are bound by operations, 4 * hd * Hq * B * T (T +
// 1) / 2 FLOP causal at 989 TFLOP/s bf16 (0.0815 ms at B 2, T 2560, Hq 24,
// hd 128), so what matters here is keeping the tensor cores fed from shared
// memory and registers:
//   - mbarriers (init, arrive with expected transaction bytes, try-wait on a
//     phase parity) for a ring of tiles between one producer thread and the
//     consumer warpgroups;
//   - TMA tile loads (cp.async.bulk.tensor, 1-D, 2-D and 4-D) that land a tile in
//     shared memory, swizzled, with no thread spending registers or
//     instructions on the copy; rows past the tensor's end are zero-filled;
//   - wgmma descriptors for those swizzled tiles (K-major and MN-major) and
//     wgmma.mma_async m64nNk16 bf16 -> f32, A from shared memory (SS) or from
//     registers (RS), with fence / commit_group / wait_group;
//   - setmaxnreg, so a producer warpgroup hands its registers to the
//     consumers' accumulators.
// The first versions (a WMMA tile loop, since removed) ran WMMA 16x16x16
// from shared memory and stored S and O there between products; here both
// accumulators stay in registers and P feeds P V from registers.
//
// Tiles of attention rows. A [ROWS, hd] bf16 tile of q, k or v lands as TMA
// leaves it: column blocks of CB = min(hd, 64) values, each ROWS rows of
// CB * 2 bytes, swizzled over that row width (128, 64 or 32 bytes: the
// 128B, 64B or 32B swizzle). As the depth of a product (Q K^T: hd) the tile is
// K-major; as its width (P V: keys are the depth) it is MN-major, and wgmma
// reads it through the transpose bit, so V is never copied transposed.
//
// The accumulator of an m64nN product: thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 and that + 8, at columns 8 j + 2 (t % 4) + {0, 1}
// for j < N / 8, as d[4 j + {0, 1}] (the first row) and d[4 j + {2, 3}] (the
// second). For 16-bit types that is also the A fragment of an RS product over
// those columns, so P goes from the scores' registers into P V.
//
// The attention forward block (AttnPlace, AttnRing, launch_attn): 128
// queries of one (b, q head), two consumer warpgroups and a producer, a ring
// of K / V / key-bias stages behind full and empty mbarriers (the encoder's
// kernel loads no bias and writes no row statistics), the tensor maps built
// on the host and the launch. A kernel on it supplies its ring depth, its
// tile width and its loop.
#pragma once

#include <cuda.h>

#include <type_traits>

#include "attention_fwd.cuh"

namespace al {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory's first 1024-byte boundary (a 128B-swizzled
// tile repeats every 1024 bytes and must start on one); callers ask for
// 1024 bytes more than they use.
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// --- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// After the inits and before any thread uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// counts its phase before the first as complete: parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -----------------------------------------------------------------------

// The tile at coordinates (innermost first) into shared memory at dst; its
// bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------------

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout 1 / 2 / 3 for the 128B / 64B / 32B swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// Before the first wgmma that reads registers or shared memory written since.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Until at most N committed groups of this warpgroup are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers an asynchronous wgmma reads or writes: the compiler may not
// move their uses across this point (put after the wait that retires it).
template <int N>
__device__ __forceinline__ void keep(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void keep(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define AL_ACC8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32 into d[N / 2] of each thread:
// d = A B + (scale_d ? d : 0). ss: A and B by descriptor (A K-major); rs: A
// from registers (the accumulator layout above, packed bf16 pairs). TB: the
// transpose bit of B (0: K-major, 1: MN-major).
template <int N>
struct Mma;

template <>
struct Mma<16> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, %11;\n}\n"
        : AL_ACC8(d, 0)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : AL_ACC8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<32> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, %19;\n}\n"
        : AL_ACC8(d, 0), AL_ACC8(d, 8)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : AL_ACC8(d, 0), AL_ACC8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<64> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, %35;\n}\n"
        : AL_ACC8(d, 0), AL_ACC8(d, 8), AL_ACC8(d, 16), AL_ACC8(d, 24)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : AL_ACC8(d, 0), AL_ACC8(d, 8), AL_ACC8(d, 16), AL_ACC8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<128> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, %67;\n}\n"
        : AL_ACC8(d, 0), AL_ACC8(d, 8), AL_ACC8(d, 16), AL_ACC8(d, 24),
          AL_ACC8(d, 32), AL_ACC8(d, 40), AL_ACC8(d, 48), AL_ACC8(d, 56)
        : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : AL_ACC8(d, 0), AL_ACC8(d, 8), AL_ACC8(d, 16), AL_ACC8(d, 24),
          AL_ACC8(d, 32), AL_ACC8(d, 40), AL_ACC8(d, 48), AL_ACC8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
  }
};

#undef AL_ACC8

// --- setmaxnreg ------------------------------------------------------------------

// Every warp of the warpgroup runs these together; the kernel's register
// count at launch (its __launch_bounds__ maximum) must cover what the
// warpgroups hold after.
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// --- tiles of attention rows and their products ------------------------------------

template <int HD, int ROWS>
struct RowTile {
  static_assert(HD == 16 || HD == 32 || HD == 64 || HD == 128, "head_dim 16, 32, 64 or 128");
  static constexpr int CB = HD < 64 ? HD : 64;  // values a column block holds
  static constexpr int NCB = HD / CB;
  static constexpr int ROW_BYTES = CB * 2;  // the swizzle's span
  static constexpr int CB_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = NCB * CB_BYTES;
  static constexpr uint32_t LAYOUT = ROW_BYTES == 128 ? 1 : ROW_BYTES == 64 ? 2 : 3;
  static constexpr uint32_t SBO = 8 * ROW_BYTES;  // 8 rows: one swizzle atom
  static_assert(BYTES % 1024 == 0, "tiles stay on 1024-byte boundaries");

  // As the K-major operand of a product of depth hd: k-step kk's 16 values
  // (32 bytes into the swizzled row, as the swizzle is taken on the address).
  static __device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
    constexpr int per = CB / 16;
    return smem_desc(base + (kk / per) * CB_BYTES + (kk % per) * 32, 16, SBO, LAYOUT);
  }
  // As the MN-major B of a product whose depth is the rows: k-step kk's 16
  // rows; the column blocks are LBO apart along the width.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t base, int kk) {
    return smem_desc(base + kk * 16 * ROW_BYTES, CB_BYTES, SBO, LAYOUT);
  }
};

// S = Q K^T for a warpgroup's 64 query rows (q: their first row in a tile of
// BQ rows) against a tile of BK keys; issued, not committed.
template <int HD, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    Mma<BK>::template ss<0>(s, RowTile<HD, BQ>::kmajor(q, kk), RowTile<HD, BK>::kmajor(k, kk),
                            kk > 0);
}

// O += P V: P the bf16 pairs of the scores' layout, V a tile of BK keys;
// issued, not committed.
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[BK / 4],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    Mma<HD>::template rs<1>(o, a, RowTile<HD, BK>::mnmajor(v, kk), 1);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ||qs_row|| over the quad (f32 squares of the bf16 values; each thread a
// quarter of the row); 0 for a row at or past T. The bounded family's
// shift is this times kn[b, kv head].
template <int HD>
__device__ __forceinline__ float row_norm(const __nv_bfloat16* qrow, bool valid) {
  float ss = 0.f;
  if (valid) {
    const int q4 = threadIdx.x & 3;
#pragma unroll
    for (int c = q4 * (HD / 4); c < (q4 + 1) * (HD / 4); c += 2) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qrow + c));
      ss += x.x * x.x;
      ss += x.y * x.y;
    }
  }
  return sqrtf(quad_sum(ss));
}

// The epilogue of an attention warpgroup: row `row` (rr 0 / 1: the thread's
// first or second) of o = l > 0 ? O / l : 0 in bf16, and its l and shift c
// from the quad's first thread unless l_out is null; rows at or past T are
// not written.
template <int HD>
__device__ __forceinline__ void store_row(const float (&o)[HD / 2], int rr, int row, float l,
                                          float c, __nv_bfloat16* orow, float* l_out,
                                          float* m_out, int T) {
  if (row >= T) return;
  const float inv = l > 0.f ? 1.f / l : 0.f;
  const int lane = threadIdx.x & 31, cq = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
        __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
  if (l_out && (lane & 3) == 0) {
    l_out[row] = l;
    m_out[row] = c;
  }
}

// --- an attention forward block -----------------------------------------------------

// The port's wgmma / TMA attention forwards (causal_attention.cu,
// causal_attention_fixed.cu, causal_attention_dma2.cu, enc_attention.cu)
// share one block: 128 queries of one (b, q head),
// consumer warpgroups 0 and 1 of 64 rows each, and producer warpgroup 2
// whose first thread issues TMA.
constexpr int kAttnBQ = 128;
constexpr int kAttnThreads = 384;

// Where a block and a consumer thread sit. Blocks run longest first (the
// highest query tile first); q0 is the block's first query, wrow its
// warpgroup's, row0 / row1 the thread's two rows of the accumulator layout
// and cq its first column in each group of 8.
struct AttnPlace {
  int q0, bh, b, h, kvh, wg, wrow, row0, row1, cq;

  __device__ AttnPlace(const AttnParams& p, int B) : AttnPlace(p.T, p.Hq, p.Hkv, B) {}
  __device__ AttnPlace(int T, int Hq, int Hkv, int B) {
    const int BH = B * Hq, n_qt = (T + kAttnBQ - 1) / kAttnBQ;
    q0 = (n_qt - 1 - (int)blockIdx.x / BH) * kAttnBQ;
    bh = blockIdx.x % BH;
    b = bh / Hq;
    h = bh % Hq;
    kvh = h / (Hq / Hkv);
    wg = threadIdx.x / 128;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    wrow = q0 + 64 * wg;
    row0 = wrow + 16 * warp + (lane >> 2);
    row1 = row0 + 8;
    cq = (lane & 3) * 2;
  }
};

// The block's shared memory (from a 1024-byte boundary): the Q tile, then
// STAGES stages of a K tile, a V tile and the tile's BK f32 of key bias (in a
// 1024-byte slot), then the mbarriers: q_full, full[STAGES] (the producer's
// arrival and the TMA bytes) and empty[STAGES] (every consumer thread's).
// Ring step `it` uses stage it % STAGES.
template <int HD, int BK, int STAGES>
struct AttnRing {
  using QT = RowTile<HD, kAttnBQ>;
  using KT = RowTile<HD, BK>;
  static constexpr size_t kStage = 2 * KT::BYTES + 1024;
  static constexpr size_t kBars = QT::BYTES + STAGES * kStage;
  static constexpr size_t kSmem = kBars + 8 * (1 + 2 * STAGES) + 1024;  // + base alignment

  unsigned char* smem;
  uint64_t* q_full;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit AttnRing(unsigned char* raw)
      : smem(align1024(raw)),
        q_full(reinterpret_cast<uint64_t*>(smem + kBars)),
        full(q_full + 1),
        empty(q_full + 1 + STAGES) {}

  __device__ unsigned char* k(int s) const { return smem + QT::BYTES + s * kStage; }
  __device__ unsigned char* v(int s) const { return k(s) + KT::BYTES; }
  __device__ float* bias(int s) const { return reinterpret_cast<float*>(v(s) + KT::BYTES); }
  // warpgroup wg's 64 rows of the Q tile
  __device__ uint32_t q_rows(int wg) const { return smem_u32(smem) + 64 * wg * QT::ROW_BYTES; }

  // Thread 0 initializes the barriers, then the block syncs.
  __device__ void init() const {
    if (threadIdx.x == 0) {
      mbar_init(q_full, 1);
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 2 * 128);
      }
      mbar_fence_init();
    }
    __syncthreads();
  }
  // Producer: the Q tile of queries q0.. of (b, h).
  __device__ void load_q(const CUtensorMap* tq, int h, int q0, int b) const {
    mbar_arrive_tx(q_full, QT::BYTES);
    for (int cb = 0; cb < QT::NCB; ++cb)
      tma_load_4d(smem + cb * QT::CB_BYTES, tq, q_full, cb * QT::CB, h, q0, b);
  }
  // Producer: ring step `it` <- key tile j of (b, KV head kvh): its K rows,
  // its V rows unless tv is null, and its keys' bias (a [B, T] row-major f32)
  // unless tb is null.
  __device__ void load(int it, const CUtensorMap* tk, const CUtensorMap* tv,
                       const CUtensorMap* tb, int kvh, int j, int b, int T) const {
    const int s = it % STAGES;
    mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    mbar_arrive_tx(&full[s], KT::BYTES * (tv ? 2 : 1) + (tb ? BK * 4 : 0));
    for (int cb = 0; cb < KT::NCB; ++cb) {
      tma_load_4d(k(s) + cb * KT::CB_BYTES, tk, &full[s], cb * KT::CB, kvh, j * BK, b);
      if (tv) tma_load_4d(v(s) + cb * KT::CB_BYTES, tv, &full[s], cb * KT::CB, kvh, j * BK, b);
    }
    if (tb) tma_load_1d(bias(s), tb, &full[s], b * T + j * BK);
  }
  // Consumer: wait for ring step it's tiles; its stage.
  __device__ int acquire(int it) const {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    return s;
  }
  // Consumer: ring step it's stage may be refilled.
  __device__ void release(int it) const { mbar_arrive(&empty[it % STAGES]); }
};

// s + bias of the accumulator's element pair (i, i + 1) in key tile j of BK
// keys; -1e9 where `mask` is on and the key lies past the row (at.row0 /
// row1: a kernel may pass the last key a row sees in their place).
template <int BK>
__device__ __forceinline__ float2 logits(const float (&s)[BK / 2], int i, int j, bool mask,
                                         const float* bias, const AttnPlace& at) {
  const int col = (i / 4) * 8 + at.cq, key = j * BK + col;
  const int row = (i & 2) ? at.row1 : at.row0;
  const float2 bb = *reinterpret_cast<const float2*>(bias + col);
  return make_float2((mask && key > row) ? kNeg : s[i] + bb.x,
                     (mask && key + 1 > row) ? kNeg : s[i + 1] + bb.y);
}

// The epilogue: the quads' l, then both rows of o = l > 0 ? O / l : 0, and
// l and the shift c where p.l_out is set (the causal forwards; the encoder
// writes o only).
template <int HD>
__device__ __forceinline__ void store_rows(const float (&o)[HD / 2], float l0, float l1,
                                           float c0, float c1, const AttnParams& p,
                                           const AttnPlace& at) {
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  __nv_bfloat16* ob = p.o + at.b * p.o_sb + at.h * p.o_sh;
  float* lb = p.l_out ? p.l_out + (long long)at.bh * p.T : nullptr;
  float* mb = p.m_out ? p.m_out + (long long)at.bh * p.T : nullptr;
  store_row<HD>(o, 0, at.row0, l0, c0, ob + (long long)at.row0 * p.o_st, lb, mb, p.T);
  store_row<HD>(o, 1, at.row1, l1, c1, ob + (long long)at.row1 * p.o_st, lb, mb, p.T);
}

// --- host: tensor maps ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// links without -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &got) !=
            cudaSuccess ||
        got != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A [B, T, H, hd]-strided bf16 tensor (element strides sb, st, sh; the last
// dim contiguous) as dims (hd, H, T, B), a box of `rows` rows of one column
// block of one (b, h), swizzled as RowTile lays it out. TMA needs 16-byte
// strides and a 16-byte aligned base (the wrappers check both).
inline bool rows_map(CUtensorMap* map, const void* base, int hd, int H, int T, int B,
                     long long sh, long long st, long long sb, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const int cb = hd < 64 ? hd : 64;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cb, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = cb == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : cb == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A row-major [rows, cols] matrix of `type` (row pitch `pitch` bytes, a
// multiple of 16; a 16-byte aligned base) as dims (cols, rows), a box of
// box_rows rows of box_cols values; swizzled 128B (a box row of 128 bytes)
// or not at all. Rows past the end land as zeros.
inline bool tile_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                        long long cols, long long rows, long long pitch, int box_cols,
                        int box_rows, bool swizzle128) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// n f32 values as one dim, a box of `box` values from any element on
// (the key bias of all B rows flat: a box starting at b T + k0).
inline bool f32_map_1d(CUtensorMap* map, const float* base, long long n, int box) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 4};  // not read for one dim
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(base), dims, strides,
             boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four maps of an attention forward (q in boxes of kAttnBQ rows, k and v
// of BK rows, the key bias of BK values; no bias map, and tb all zeros, when
// p.key_bias is null: the encoder) and a launch of `kernel` on
// ceil(T / kAttnBQ) * B * Hq blocks of kAttnThreads with `smem` bytes.
template <int HD, int BK, typename K>
cudaError_t launch_attn(K kernel, size_t smem, const AttnParams& p, int B,
                        cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(p.key_bias) % 16) return cudaErrorInvalidValue;  // TMA
  CUtensorMap tq, tk, tv, tb{};
  if (!rows_map(&tq, p.q, HD, p.Hq, p.T, B, p.q_sh, p.q_st, p.q_sb, kAttnBQ) ||
      !rows_map(&tk, p.k, HD, p.Hkv, p.T, B, p.k_sh, p.k_st, p.k_sb, BK) ||
      !rows_map(&tv, p.v, HD, p.Hkv, p.T, B, p.v_sh, p.v_st, p.v_sb, BK) ||
      (p.key_bias && !f32_map_1d(&tb, p.key_bias, (long long)B * p.T, BK)))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.T + kAttnBQ - 1) / kAttnBQ;
  kernel<<<n_qt * B * p.Hq, kAttnThreads, smem, stream>>>(tq, tk, tv, tb, p, B);
  return cudaGetLastError();
}

// f(std::integral_constant<int, hd>) for hd 16, 32, 64 or 128.
template <typename F>
cudaError_t with_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

// A kernel's registers, local (spilled) bytes, the shared memory it asks for
// and its resident blocks per SM (al_sm90_kernel_info's out[4]).
template <typename K>
inline cudaError_t kernel_info(K kernel, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return err;
}

}  // namespace sm90

// The kernels on these blocks at head_dim hd (defined by causal_attention.cu,
// causal_attention_fixed.cu, causal_attention_dma2.cu, enc_attention.cu,
// int4_matmul.cu and causal_attention_bwd.cu):
// their launches and their kernel_info (exported by al_sm90_kernel_info).
cudaError_t online_fwd_sm90_info(int hd, bool causal, int* out);
cudaError_t fixed_fwd_sm90(const AttnParams& p, int B, int hd, bool bounded,
                           cudaStream_t stream);
cudaError_t fixed_fwd_sm90_info(int hd, bool bounded, int* out);
cudaError_t dma2_fwd_sm90(const AttnParams& p, int B, int hd, cudaStream_t stream);
cudaError_t dma2_fwd_sm90_info(int hd, int* out);
// The encoder's forward in softmax mode `mode` (kSoftmaxOnline, Bounded or
// TwoPass; exp_bf16: twopass's bf16 exp argument).
cudaError_t enc_fwd_sm90_info(int hd, int mode, bool exp_bf16, int* out);
// The W4A16 prefill kernel (int4_matmul.cu) at a scale group, whole K or
// K-split.
cudaError_t w4_prefill_sm90_info(int group, bool ksplit, int* out);
// The causal backward's dq or dk/dv kernel (causal_attention_bwd.cu), causal
// (tri='always') or not (tri='never').
cudaError_t bwd_sm90_info(int hd, bool dq, bool causal, int* out);

}  // namespace al
