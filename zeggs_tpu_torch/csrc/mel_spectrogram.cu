// Fused STFT magnitude + mel filterbank + dB, for Hopper (sm_90a).
//
// Replaces zeggs_tpu/ops/pallas/mel_kernel.py::fused_mel_spectrogram. The
// plain PyTorch version of the same function is mel_frames_plain in
// zeggs_tpu_torch/ops/kernels/mel.py, which also builds the constants.
//
// From a signal that is already padded (and pre-emphasised), frame t is
// x[t*hop : t*hop + n_fft] * window, and each output row is
//
//   amp[k] = |sum_n frame[n] e^{-2 pi i n k / n_fft}| * amp_scale   (k < n_fft/2 + 1)
//   m      = max(|sum_k mel[j, k] amp[k]|, min_amp)
//   out[j] = 20 log10(m), then (out + dyn) / dyn when normalize is set
//
// What bounds it on an H100: at n_fft 800 a frame's direct DFT is 401 x 800
// complex-by-real products (0.64 MFMA); a 10 s clip (801 frames) is 1.03
// GFLOP, about 15 us at the card's float32 FMA rate, and reads only 0.6 MB.
// It is bound by float32 FMAs and by shared-memory loads, not by bytes.
//
// What this first design does about that:
//   * one block owns a tile of kTile frames; their windowed samples are
//     staged in shared memory transposed, [n][frame], so one broadcast
//     16-byte load gives four frames' sample n;
//   * the twiddles come from one table of n_fft (cos, sin) pairs built in
//     float64 on the host (6.4 KB) instead of two (n_fft, n_bins) bases
//     (2.5 MB): bin k at sample n reads entry (n k) mod n_fft, kept as a
//     running index;
//   * a thread owns one bin at a time and accumulates re and im of all the
//     tile's frames in float32 FMAs (no TF32); the amplitudes go to shared
//     memory and the mel product of a (frame, mel) pair runs over the
//     filter's nonzero bins only, then clip, dB and normalisation;
//   * the ragged last tile computes zero frames and writes only real rows.
// Tensor-core products and twiddle layouts free of bank conflicts are later
// work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;  // frames per block; a multiple of 4 (16-byte loads)

__global__ void __launch_bounds__(kThreads)
mel_kernel(const float* __restrict__ x, int T, const float* __restrict__ window,
           const float2* __restrict__ twiddle, const float* __restrict__ basis,
           const int2* __restrict__ support, float* __restrict__ out, int n_fft, int hop,
           int n_mels, float amp_scale, float min_amp, float dyn_range, int normalize) {
  extern __shared__ __align__(16) float smem[];
  const int n_bins = n_fft / 2 + 1;
  float* s_frames = smem;                                          // [n_fft][kTile]
  float2* s_tw = reinterpret_cast<float2*>(s_frames + n_fft * kTile);  // [n_fft]
  float* s_amp = reinterpret_cast<float*>(s_tw + n_fft);           // [kTile][n_bins]
  const int t0 = blockIdx.x * kTile;
  const int nf = min(kTile, T - t0);

  // stage the tile's windowed frames and the twiddle table
  for (int i = threadIdx.x; i < kTile * n_fft; i += kThreads) {
    const int f = i / n_fft, n = i - f * n_fft;
    s_frames[n * kTile + f] = f < nf ? x[(size_t)(t0 + f) * hop + n] * window[n] : 0.f;
  }
  for (int i = threadIdx.x; i < n_fft; i += kThreads) s_tw[i] = twiddle[i];
  __syncthreads();

  // real DFT magnitude of every frame of the tile, one bin per thread
  for (int k = threadIdx.x; k < n_bins; k += kThreads) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) re[f] = im[f] = 0.f;
    int j = 0;  // (n * k) mod n_fft
    for (int n = 0; n < n_fft; ++n) {
      const float2 w = s_tw[j];
      const float4* v = reinterpret_cast<const float4*>(s_frames + n * kTile);
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        const float4 a = v[q];
        re[4 * q + 0] = fmaf(a.x, w.x, re[4 * q + 0]); im[4 * q + 0] = fmaf(a.x, w.y, im[4 * q + 0]);
        re[4 * q + 1] = fmaf(a.y, w.x, re[4 * q + 1]); im[4 * q + 1] = fmaf(a.y, w.y, im[4 * q + 1]);
        re[4 * q + 2] = fmaf(a.z, w.x, re[4 * q + 2]); im[4 * q + 2] = fmaf(a.z, w.y, im[4 * q + 2]);
        re[4 * q + 3] = fmaf(a.w, w.x, re[4 * q + 3]); im[4 * q + 3] = fmaf(a.w, w.y, im[4 * q + 3]);
      }
      j += k;
      if (j >= n_fft) j -= n_fft;
    }
#pragma unroll
    for (int f = 0; f < kTile; ++f)
      s_amp[f * n_bins + k] = sqrtf(re[f] * re[f] + im[f] * im[f]) * amp_scale;
  }
  __syncthreads();

  // mel product over each filter's nonzero bins, clip, dB, normalise
  for (int o = threadIdx.x; o < nf * n_mels; o += kThreads) {
    const int f = o / n_mels, m = o - f * n_mels;
    const int2 s = support[m];
    const float* a = s_amp + f * n_bins;
    const float* b = basis + (size_t)m * n_bins;
    float acc = 0.f;
    for (int k = s.x; k < s.y; ++k) acc = fmaf(a[k], __ldg(b + k), acc);
    float db = 20.f * log10f(fmaxf(fabsf(acc), min_amp));
    if (normalize) db = (db + dyn_range) / dyn_range;
    out[(size_t)(t0 + f) * n_mels + m] = db;
  }
}

size_t smem_bytes(int n_fft) {
  return (size_t)n_fft * kTile * sizeof(float) + (size_t)n_fft * sizeof(float2) +
         (size_t)kTile * (n_fft / 2 + 1) * sizeof(float);
}

}  // namespace

extern "C" {

// Launch on `stream` for T >= 1 frames of a padded signal x of at least
// (T - 1) * hop + n_fft samples; returns a cudaError_t (0 on success).
int zeggs_mel_spectrogram(const void* x, int T, const void* window, const void* twiddle,
                          const void* basis, const void* support, void* out, int n_fft, int hop,
                          int n_mels, float amp_scale, float min_amp, float dyn_range,
                          int normalize, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  static size_t smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  const size_t smem = smem_bytes(n_fft);
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int blocks = (T + kTile - 1) / kTile;
  mel_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), T, static_cast<const float*>(window),
      static_cast<const float2*>(twiddle), static_cast<const float*>(basis),
      static_cast<const int2*>(support), static_cast<float*>(out), n_fft, hop, n_mels, amp_scale,
      min_amp, dyn_range, normalize);
  return (int)cudaGetLastError();
}

const char* zeggs_mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
