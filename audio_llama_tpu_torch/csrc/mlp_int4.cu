// Fused int4 decode MLP: silu(x @ Wgate) * (x @ Wup) @ Wdown in one launch.
//
// Replaces audio_llama_tpu/ops/mlp_int4.py::_kernel (mlp_int4_stacked) for
// M <= 64 rows, in both its modes (with the smoothed trees' down equalizer
// dn_r or without): x [M, K] bf16; the layer's gate|up slab [K, F] int8 (low
// nibble gate column j, high nibble up column j) with scales [K/G, 2F]; the
// layer's down slab [F, D/2] int8 with scales [F/G, D]; pack formats and
// group numerics as int4_matmul.cu, the scale group G a run-time argument
// (32, 64, 128 or 256; int4_common.cuh).
//
// Bound on the H100: the weight bytes, 3 * K * F / 2 per layer (40.1 MB at
// 3B dims with group 128's scales, 12.0 us at 3.35 TB/s; 47.2 MB and 14.1 us
// at group 32; dn_r adds F * 4 bytes). Operations do not bind: at M 4 a
// weight byte carries 16 FLOP.
//
// Design: two W4A16 products on the weight-streaming core of
// int4_common.cuh (a cluster of C blocks along K streams a tile of 64
// packed columns through a cp.async ring; mma.sync on nibbles turned bf16
// in registers; every weight byte read once a call for any M <= 64; the
// blocks' partials added in rank order through distributed shared memory),
// in one launch of (F + n_kc D/2) / 64 clusters (64 columns a tile),
// each taking the next unit from an atomic ticket:
//  - the first F / tw tickets are gate|up units: the [K, F] slab as a W4A16
//    with nh = F, one tile over all K rows. The cluster that completes a
//    tile forms a = g * sigmoid(g) * u in f32, times dn_r[j] in f32 where
//    dn_r is given (the TPU kernel's has_dnr mode), rounds it to bf16 (the
//    TPU kernel's a.astype(cdt)) and writes it once to the [M, F] bf16
//    activations (64 KB at M 4, against 40 MB of weights); each of its
//    blocks then adds one to the tile's ready count (after a fence).
//  - the rest are down units: a tile of the [F, D/2] slab over one of n_kc
//    K chunks of F rows, taken chunk by chunk. Its first ring stage is in
//    flight before a block waits for the ready counts of the gate|up tiles
//    its rows need; those tiles were claimed earlier from the same ticket
//    (every gate|up unit before any down unit), so the clusters that hold
//    them are running and no wait can deadlock, whatever the grid size (a
//    wait past ~seconds traps rather than hang the card). The activations
//    are read past L1 (cp.async.cg). A unit writes its f32 partial of the
//    tile to a workspace [n_kc, M, D]; the last of the tile's blocks to
//    arrive (atomic count) adds the n_kc partials in chunk order and writes
//    the bf16 output, so the down sum over F is deterministic and is reduced
//    by the D/2 / tw tiles' blocks in parallel.
// The counts are zero at entry; the last block to leave resets them. The
// activations do not depend on `chunk` (the TPU kernel's F step, kept in the
// wrapper's signature): only the f32 order of the down sum does, here by
// blocks, K chunks and tiles (ops/mlp_int4.py::mlp_plan picks C and
// n_kc).
#include "int4_common.cuh"
#include "sm90.cuh"

namespace {

namespace w4 = al::w4;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Polls of a ready count before the kernel traps (seconds at 64 ns a poll; a
// unit's wait lasts microseconds).
constexpr long long kSpinLimit = 1LL << 26;

struct MlpArgs {
  const __nv_bfloat16* x;
  int M, K, F, dh, fmt, group;
  const int8_t* gup;
  const float* gus;
  const int8_t* dn;
  const float* dns;
  const float* dnr;       // [F] or nullptr
  int n_kc;               // K chunks of the down product
  __nv_bfloat16* act;     // [M, F]
  float* ws;              // [n_kc, M, 2 dh]
  __nv_bfloat16* out;     // [M, 2 dh]
  int* cnt;               // ticket, leavers, ready[F / 64], arrived[dh / 64]
};

template <int NT>
__global__ void __launch_bounds__(w4::kThreads) mlp4_kernel(const MlpArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int unit_s, flag;
  w4::cg::cluster_group cluster = w4::cg::this_cluster();
  const int tid = threadIdx.x, C = (int)cluster.num_blocks();
  constexpr int tw = w4::kTW;  // a unit's packed columns
  const int tiles_g = a.F / tw, tiles_d = a.dh / tw;
  int* ready = a.cnt + 2;
  int* arrived = ready + tiles_g;
  if (cluster.block_rank() == 0 && tid == 0) unit_s = atomicAdd(a.cnt, 1);
  cluster.sync();
  const int unit = *cluster.map_shared_rank(&unit_s, 0);

  if (unit < tiles_g) {  // gate|up tile `unit`
    const w4::Product P{a.x, a.K, a.gup, a.gus, a.F, a.group, a.fmt};
    w4::run_unit<NT>(
        P, a.M, unit, w4::Unit{0, a.K, a.K}, smem, [](int, int) {},
        [&](int tok, int c, float g, float up) {
          const int j = unit * tw + c;
          float v = g * (1.f / (1.f + expf(-g))) * up;
          if (a.dnr != nullptr) v *= a.dnr[j];  // in f32, before the rounding
          a.act[(long long)tok * a.F + j] = __float2bfloat16(v);
        });
    __threadfence();
    __syncthreads();
    if (tid == 0) atomicAdd(&ready[unit], 1);
  } else {  // down tile `tile` over K chunk kc
    const int d = unit - tiles_g, kc = d / tiles_d, tile = d % tiles_d;
    const int kcr = a.F / a.n_kc;  // rows of a K chunk
    const w4::Product P{a.act, a.F, a.dn, a.dns, a.dh, a.group, a.fmt};
    float* part = a.ws + (long long)kc * a.M * 2 * a.dh;
    w4::run_unit<NT>(
        P, a.M, tile, w4::Unit{kc * kcr, kcr, kcr}, smem,
        [&](int kb, int kn) {
          if (tid == 0)
            for (int t = kb / tw; t <= (kb + kn - 1) / tw; ++t)
              for (long long spin = 0; ld_acquire(&ready[t]) < C; ++spin) {
                if (spin > kSpinLimit) __trap();  // a fault, not a hang of the card
                __nanosleep(64);
              }
          __syncthreads();
        },
        [&](int tok, int c, float lo, float hi) {
          const long long at = (long long)tok * 2 * a.dh + tile * tw + c;
          part[at] = lo;
          part[at + a.dh] = hi;
        });
    if (al::last_to_arrive(&arrived[tile], a.n_kc * C, &flag)) {
      for (int it = tid; it < a.M * tw; it += w4::kThreads) {
        const long long at = (long long)(it / tw) * 2 * a.dh + tile * tw + it % tw;
        float lo = 0.f, hi = 0.f;
        for (int k = 0; k < a.n_kc; ++k) {
          const float* pk = a.ws + (long long)k * a.M * 2 * a.dh;
          lo += __ldcg(pk + at);
          hi += __ldcg(pk + at + a.dh);
        }
        a.out[at] = __float2bfloat16(lo);
        a.out[at + a.dh] = __float2bfloat16(hi);
      }
      if (tid == 0) arrived[tile] = 0;
    }
  }

  // the last block to leave resets the ticket and the ready counts
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    if (atomicAdd(a.cnt + 1, 1) == (int)gridDim.x - 1) {
      for (int t = 0; t < tiles_g; ++t) ready[t] = 0;
      a.cnt[0] = 0;
      a.cnt[1] = 0;
      __threadfence();
    }
  }
}

// A block's dynamic shared memory: the larger of a gate|up block's (K / C
// rows) and a down block's (F / n_kc / C rows).
template <int NT>
size_t mlp_smem(int K, int F, int C, int n_kc, int group) {
  const size_t g = w4::unit_smem<NT>(K / C, group);
  const size_t d = w4::unit_smem<NT>(F / n_kc / C, group);
  return g > d ? g : d;
}

template <int NT>
struct MlpRun {
  static cudaError_t run(const MlpArgs& a, int C, cudaStream_t stream) {
    constexpr int tw = w4::kTW;
    if (a.n_kc <= 0 || a.F % a.n_kc || a.F % tw || a.dh % tw ||
        !w4::unit_ok(w4::Unit{0, a.K, a.K}, C, a.group) ||
        !w4::unit_ok(w4::Unit{0, a.F / a.n_kc, a.F / a.n_kc}, C, a.group))
      return cudaErrorInvalidValue;
    const int units = a.F / tw + a.n_kc * (a.dh / tw);
    return w4::launch_clustered(mlp4_kernel<NT>, units * C, C,
                                mlp_smem<NT>(a.K, a.F, C, a.n_kc, a.group), stream, a);
  }
};

template <int NT>
struct MlpInfo {
  static cudaError_t run(int K, int F, int C, int n_kc, int group, int* out) {
    return al::sm90::kernel_info(mlp4_kernel<NT>, w4::kThreads,
                                 mlp_smem<NT>(K, F, C, n_kc, group), out);
  }
};

}  // namespace

// x [M, K] bf16; gup: the layer's [K, F] int8; gus: [K/group, 2F] f32; dn:
// the layer's [F, dh] int8; dns: [F/group, 2*dh] f32; dnr: the layer's [F]
// f32 down equalizer of a smoothed tree, or nullptr (the mode without one);
// out [M, 2*dh] bf16; act [M, F] bf16 and ws [n_kc, M, 2*dh] f32 scratch;
// counters: 2 + F / 64 + dh / 64 ints, zero at entry and left zero.
// Clusters of C blocks over tiles of 64 packed columns; a gate|up unit's
// blocks take K / C rows each, a down unit's F / n_kc / C (whole 64-row
// stages and groups; ops/mlp_int4.py::mlp_plan picks C and n_kc). Requires 1 <= M <= 64, al::group_ok(group), 16-byte aligned x,
// slabs and scales (checked by the wrapper).
AL_EXPORT int al_mlp_int4(const void* x, int M, int K, const void* gup, const void* gus,
                          const void* dn, const void* dns, const void* dnr, int F, int dh,
                          int fmt, int group, int C, int n_kc, void* act, void* ws,
                          void* out, void* counters, void* stream) {
  if (M == 0) return cudaSuccess;
  if (M < 0 || M > 64 || !al::group_ok(group) || K % group || F % group)
    return cudaErrorInvalidValue;
  const MlpArgs a{static_cast<const __nv_bfloat16*>(x), M, K, F, dh, fmt, group,
                  static_cast<const int8_t*>(gup), static_cast<const float*>(gus),
                  static_cast<const int8_t*>(dn), static_cast<const float*>(dns),
                  static_cast<const float*>(dnr), n_kc, static_cast<__nv_bfloat16*>(act),
                  static_cast<float*>(ws), static_cast<__nv_bfloat16*>(out),
                  static_cast<int*>(counters)};
  return w4::with_instance<MlpRun>(M, a, C, static_cast<cudaStream_t>(stream));
}

// The MLP kernel's instance for M rows at its launch's shape (K, F, C,
// n_kc, group): registers, local bytes, the dynamic shared memory the launch
// asks for and resident blocks per SM.
AL_EXPORT int al_mlp_int4_info(int M, int K, int F, int C, int n_kc, int group, void* out) {
  return w4::with_instance<MlpInfo>(M, K, F, C, n_kc, group, static_cast<int*>(out));
}
