// Mel power spectrogram of a reflect-padded waveform, f32 throughout.
//
// Replaces audio_llama_tpu/ops/mel_pallas.py::_kernel (mel_power): for each
// frame f the windowed DFT of samples [f * hop, f * hop + n_fft) against the
// hann*cos and hann*sin bases (`_basis`: rows n of the n_fft window, bins
// padded to nb = 256 columns), power = re^2 + im^2, then power @ fb^T into
// [B, F, n_mels]. The log, clamp and affine of the Whisper featurizer stay
// outside, as in the JAX package (the clamp needs the clip's global max).
//
// Bound on the H100: operations. A 30 s clip is 3000 frames x (2 x 2 x 400
// x 201 + 2 x 201 x 128) = 1.12 GFLOP in f32 over the 201 live bins (~17 us
// at 67 TFLOP/s); the bytes (1.9 MB of waveform in, 1.5 MB out, 0.9 MB of
// tables) take ~1.3 us. Design: frames are read straight from the
// padded waveform, the frame index times hop being the offset; there is no
// framed copy. A block owns 32 frames of one clip: it stages their span of
// samples (31 * hop + n_fft floats) in shared memory once, gives each thread
// one bin (coalesced basis reads, streamed from L2 where the 0.8 MB of bases
// stay), keeps the 32 frames' re and im in registers, forms the power into
// shared memory, then each thread produces (frame, mel) outputs from it.
// Any frame count is taken: frames past F are not written, and samples past
// the padded length read as zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFT = 32;  // frames per block

__global__ void __launch_bounds__(kThreads)
mel_power_kernel(const float* __restrict__ wave, long long P, int F, int hop, int n_fft,
                 const float* __restrict__ C, const float* __restrict__ Sn, int nb, int n_bins,
                 const float* __restrict__ fbT, int n_mels, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int span = (kFT - 1) * hop + n_fft;
  float* wav = sm;                           // [span]
  float* pw = sm + ((span + 3) & ~3);        // [kFT, n_bins]
  const int tid = threadIdx.x;
  const int b = blockIdx.y, f0 = blockIdx.x * kFT;
  const float* w = wave + (long long)b * P;
  const long long s0 = (long long)f0 * hop;
  for (int i = tid; i < span; i += kThreads) {
    const long long at = s0 + i;
    wav[i] = at < P ? w[at] : 0.f;
  }
  __syncthreads();

  for (int k = tid; k < n_bins; k += kThreads) {
    float re[kFT], im[kFT];
#pragma unroll
    for (int f = 0; f < kFT; ++f) re[f] = im[f] = 0.f;
    for (int n = 0; n < n_fft; ++n) {
      const float c = __ldg(C + (long long)n * nb + k), s = __ldg(Sn + (long long)n * nb + k);
#pragma unroll
      for (int f = 0; f < kFT; ++f) {
        const float x = wav[f * hop + n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFT; ++f) pw[f * n_bins + k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = tid; idx < kFT * n_mels; idx += kThreads) {
    const int f = idx / n_mels, m = idx % n_mels;
    if (f0 + f >= F) break;
    float v = 0.f;
    for (int k = 0; k < n_bins; ++k) v = fmaf(pw[f * n_bins + k], __ldg(fbT + k * n_mels + m), v);
    out[((long long)b * F + f0 + f) * n_mels + m] = v;
  }
}

}  // namespace

// wave [B, P] f32 (reflect-padded, row stride P); C, Sn: [rows >= n_fft, nb]
// f32 windowed cos / sin bases; fbT [nb, n_mels] f32 (rows >= n_bins zero);
// out [B, F, n_mels] f32. Requires n_bins <= nb and the shared memory
// 4 * (span + 32 * n_bins) <= 227 KB (checked by the wrapper).
AL_EXPORT int al_mel_power(const void* wave, int B, long long P, int F, int hop, int n_fft,
                           const void* C, const void* Sn, int nb, int n_bins, const void* fbT,
                           int n_mels, void* out, void* stream) {
  if (B == 0 || F == 0) return cudaSuccess;
  if (n_bins > nb || hop <= 0 || n_fft <= 0) return cudaErrorInvalidValue;
  const int span = (kFT - 1) * hop + n_fft;
  const size_t smem = sizeof(float) * ((size_t)((span + 3) & ~3) + (size_t)kFT * n_bins);
  cudaError_t err = al::allow_smem(mel_power_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((F + kFT - 1) / kFT, B);
  mel_power_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wave), P, F, hop, n_fft, static_cast<const float*>(C),
      static_cast<const float*>(Sn), nb, n_bins, static_cast<const float*>(fbT), n_mels,
      static_cast<float*>(out));
  return cudaGetLastError();
}
