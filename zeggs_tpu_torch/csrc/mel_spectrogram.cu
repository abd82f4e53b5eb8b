// Fused STFT magnitude + mel filterbank + dB as a mixed-radix FFT, for
// Hopper (sm_90a).
//
// Replaces zeggs_tpu/ops/pallas/mel_kernel.py::fused_mel_spectrogram. The
// plain PyTorch version of the same function is mel_frames_plain in
// zeggs_tpu_torch/ops/kernels/mel.py, which also builds the FFT plan
// (fft_plan) and the constants, and picks the frame pairs a block
// (launch_shape).
//
// From a signal that is already padded (and pre-emphasised), frame t is
// x[t*hop : t*hop + n_fft] * window, and each output row is
//
//   amp[k] = |sum_n frame[n] e^{-2 pi i n k / n_fft}| * amp_scale   (k < n_fft/2 + 1)
//   m      = max(|sum_k mel[j, k] amp[k]|, min_amp)
//   out[j] = 20 log10(m), then (out + dyn) / dyn when normalize is set
//
// What bounds it on an H100: at n_fft 800 an FFT of each frame and the mel
// product over the filters' nonzero bins are 15.4 MFLOP for the 800 frames
// of a 10 s clip (0.23 us at the float32 FMA rate), and the samples and
// rows are 0.9 MB (0.27 us at 3.35 TB/s). Neither is close: a frame's FFT is
// a chain of dependent stages, so latency and parallelism bound it.
//
// What this design does about that:
//   * two real frames a and b make one complex FFT of z = a + i b; the two
//     spectra come apart as A[k] = (Z[k] + conj Z[N-k]) / 2 and
//     B[k] = (Z[k] - conj Z[N-k]) / 2i; an odd frame count gives the last
//     pair b = 0;
//   * a group of kGroupWarps = 8 warps owns a frame pair, so that each
//     stage is one or two butterflies a thread (at n_fft 800) rather than
//     a warp's serial walk over all of them: the chain of a pair, not the
//     count of pairs, sets the time of a short window;
//   * the tables and both frames are staged with asynchronous copies, all
//     in flight at once; the group windows the frames, runs the plan's
//     Stockham stages (natural order in and out, no bit reversal) between
//     two buffers in shared memory with a named barrier between stages,
//     then the mel product over each filter's nonzero bins, clip, dB and
//     normalisation, and writes the rows;
//   * the stages are radix-4, 2, 5 and 3 butterflies and one generic stage
//     for each other prime factor (a prime n_fft is one such stage), so any
//     n_fft runs; twiddles come from the plan, computed in float64 and
//     rounded to float32 once, and are shared by the block's groups;
//   * a buffer slot i lives at i + i / 16, so the stride-2 and stride-4
//     writes of a first stage fall on distinct banks;
//   * a block holds 1 or 2 groups, chosen from the frame count
//     (launch_shape): one pair a block while the pairs do not fill the card
//     twice over, two to share the staged tables on long clips; the launch
//     takes fewer where they would not fit the card's shared memory.
// float32 FMAs, no tensor cores: the work is small and the error budget
// (2e-4 on the normalised dB rows) is met with room to spare.

#include <cuda_runtime.h>

#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int kGroupWarps = 8;  // warps of one frame pair's group
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kMaxGroups = 2;   // groups a block (mel.py's MAX_GROUPS)

__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// Asynchronous copies to shared memory of 4 or 8 bytes; `valid` false
// writes zeros. All of a thread's copies are in flight at once, so staging
// costs one trip to L2 rather than one a loop iteration.
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid = true) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(B),
               "r"(valid ? B : 0));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Barrier of one group's threads: named barrier 1 + group.
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kGroupThreads) : "memory");
}

__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 scale(float2 a, float s) { return make_float2(a.x * s, a.y * s); }
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
// t - i u and t + i u
__device__ __forceinline__ float2 sub_i(float2 t, float2 u) { return make_float2(t.x + u.y, t.y - u.x); }
__device__ __forceinline__ float2 add_i(float2 t, float2 u) { return make_float2(t.x - u.y, t.y + u.x); }

// In-place R-point DFT, V[q] = sum_r v[r] e^{-2 pi i r q / R}.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0], b = v[1];
  v[0] = add(a, b);
  v[1] = sub(a, b);
}

template <>
__device__ __forceinline__ void dft<3>(float2 (&v)[3]) {
  const float s3 = 0.866025403784438647f;  // sin(2 pi / 3)
  const float2 s = add(v[1], v[2]), u = scale(sub(v[1], v[2]), s3);
  const float2 t = sub(v[0], scale(s, 0.5f));
  v[0] = add(v[0], s);
  v[1] = sub_i(t, u);
  v[2] = add_i(t, u);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 t0 = add(v[0], v[2]), t1 = sub(v[0], v[2]);
  const float2 t2 = add(v[1], v[3]), t3 = sub(v[1], v[3]);
  v[0] = add(t0, t2);
  v[2] = sub(t0, t2);
  v[1] = sub_i(t1, t3);
  v[3] = add_i(t1, t3);
}

template <>
__device__ __forceinline__ void dft<5>(float2 (&v)[5]) {
  const float c1 = 0.309016994374947424f, c2 = -0.809016994374947424f;  // cos(2 pi k / 5)
  const float s1 = 0.951056516295153572f, s2 = 0.587785252292473129f;   // sin(2 pi k / 5)
  const float2 b1 = add(v[1], v[4]), b2 = add(v[2], v[3]);
  const float2 d1 = sub(v[1], v[4]), d2 = sub(v[2], v[3]);
  const float2 t1 = make_float2(v[0].x + c1 * b1.x + c2 * b2.x, v[0].y + c1 * b1.y + c2 * b2.y);
  const float2 t2 = make_float2(v[0].x + c2 * b1.x + c1 * b2.x, v[0].y + c2 * b1.y + c1 * b2.y);
  const float2 u1 = make_float2(s1 * d1.x + s2 * d2.x, s1 * d1.y + s2 * d2.y);
  const float2 u2 = make_float2(s2 * d1.x - s1 * d2.x, s2 * d1.y - s1 * d2.y);
  v[0] = add(v[0], add(b1, b2));
  v[1] = sub_i(t1, u1);
  v[4] = add_i(t1, u1);
  v[2] = sub_i(t2, u2);
  v[3] = add_i(t2, u2);
}

// One Stockham stage of radix R after stages of total size Ns: butterfly j
// (k = j mod Ns) reads in[j + r N/R], twiddles input r by tw[(r-1) Ns + k],
// and writes output q to out[(j - k) R + k + q Ns].
template <int R>
__device__ __forceinline__ void stage(const float2* __restrict__ in, float2* __restrict__ out,
                                      const float2* __restrict__ tw, int N, int Ns, int tid) {
  const int M = N / R;
  for (int j = tid; j < M; j += kGroupThreads) {
    const int k = j % Ns;
    float2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = in[slot(j + r * M)];
#pragma unroll
    for (int r = 1; r < R; ++r) v[r] = mul(v[r], tw[(r - 1) * Ns + k]);
    dft<R>(v);
    const int d = (j - k) * R + k;
#pragma unroll
    for (int r = 0; r < R; ++r) out[slot(d + r * Ns)] = v[r];
  }
}

// The same stage for any odd prime radix: the inputs are twiddled in
// place, then a thread sums outputs q and R - q together with the R roots
// that follow the twiddles: with w = e^{-2 pi i r q / R} = (c, s) and
// P, Q, U, V the sums of a.x c, a.y s, a.x s, a.y c over r,
// X[q] = (P - Q, U + V) and X[R - q] = (P + Q, V - U).
__device__ void stage_generic(float2* in, float2* __restrict__ out, const float2* __restrict__ tw,
                              int N, int Ns, int R, int tid, int group) {
  const int M = N / R;
  for (int e = M + tid; e < N; e += kGroupThreads) {
    const int r = e / M, k = (e - r * M) % Ns;
    in[slot(e)] = mul(in[slot(e)], tw[(r - 1) * Ns + k]);
  }
  group_sync(group);
  const float2* roots = tw + (R - 1) * Ns;
  for (int o = tid; o < M * (R / 2 + 1); o += kGroupThreads) {
    const int q = o / M, j = o - q * M, k = j % Ns;
    float P = 0.f, Q = 0.f, U = 0.f, V = 0.f;
#pragma unroll 4
    for (int r = 0, t = 0; r < R; ++r) {  // t = r q mod R
      const float2 a = in[slot(j + r * M)], w = roots[t];
      P = fmaf(a.x, w.x, P);
      Q = fmaf(a.y, w.y, Q);
      U = fmaf(a.x, w.y, U);
      V = fmaf(a.y, w.x, V);
      t += q;
      if (t >= R) t -= R;
    }
    const int d = (j - k) * R + k;
    out[slot(d + q * Ns)] = make_float2(P - Q, U + V);
    if (q > 0) out[slot(d + (R - q) * Ns)] = make_float2(P + Q, V - U);
  }
}

struct Args {
  const float* x;
  const float* window;
  const int2* stages;    // [n_stages] radix, offset of its twiddles
  const float2* twiddles;  // [n_twiddles]
  const float* filters;  // [n_mels][width]
  const int2* support;   // [n_mels] [first, last + 1) nonzero bin
  float* out;            // [T][n_mels]
  int T, n_fft, hop, n_mels, n_stages, n_twiddles, width;
  float amp_scale, min_amp, dyn_range;
  int normalize;
};

// Shared memory: [n_twiddles] float2 | [n_mels * width + n_fft, even] float
// (filters, window) | [groups][2][slot(n_fft - 1) + 1] float2.
__host__ __device__ int table_floats(const Args& a) {
  const int n = a.n_mels * a.width + a.n_fft;
  return n + n % 2;
}
__host__ __device__ int buffer_slots(int n_fft) { return n_fft + (n_fft - 1) / 16; }
size_t smem_bytes(const Args& a, int groups) {
  return 8 * (size_t)a.n_twiddles + 4 * (size_t)table_floats(a) +
         (size_t)groups * 2 * 8 * buffer_slots(a.n_fft);
}

__global__ void __launch_bounds__(kMaxGroups * kGroupThreads) mel_kernel(const Args a) {
  extern __shared__ __align__(16) float2 smem[];
  const int N = a.n_fft, n_bins = N / 2 + 1, slots = buffer_slots(N);
  const int group = threadIdx.x / kGroupThreads, tid = threadIdx.x % kGroupThreads;
  float2* s_tw = smem;
  float* s_filt = reinterpret_cast<float*>(s_tw + a.n_twiddles);
  float* s_win = s_filt + a.n_mels * a.width;
  float2* buf0 = reinterpret_cast<float2*>(s_filt + table_floats(a)) + 2 * group * slots;
  float2* buf1 = buf0 + slots;

  // stage the tables and the group's two frames (re: frame t0, im: t0 + 1)
  for (int i = threadIdx.x; i < a.n_twiddles; i += blockDim.x) cp_async<8>(s_tw + i, a.twiddles + i);
  for (int i = threadIdx.x; i < a.n_mels * a.width; i += blockDim.x)
    cp_async<4>(s_filt + i, a.filters + i);
  for (int i = threadIdx.x; i < N; i += blockDim.x) cp_async<4>(s_win + i, a.window + i);
  const int t0 = 2 * (blockIdx.x * (blockDim.x / kGroupThreads) + group);
  if (t0 < a.T) {
    const float* xa = a.x + (size_t)t0 * a.hop;
    const bool has_b = t0 + 1 < a.T;
    for (int n = tid; n < N; n += kGroupThreads) {
      float* d = reinterpret_cast<float*>(buf0 + slot(n));
      cp_async<4>(d, xa + n);
      cp_async<4>(d + 1, has_b ? xa + a.hop + n : xa + n, has_b);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if (t0 >= a.T) return;  // the whole group: its named barrier is not used
  for (int n = tid; n < N; n += kGroupThreads) {
    const float w = s_win[n];
    const float2 v = buf0[slot(n)];
    buf0[slot(n)] = make_float2(v.x * w, v.y * w);
  }
  group_sync(group);

  // the planned stages, ping-ponging between the group's two buffers
  float2* src = buf0;
  float2* dst = buf1;
  for (int s = 0, Ns = 1; s < a.n_stages; ++s) {
    const int2 st = __ldg(a.stages + s);
    const float2* tw = s_tw + st.y;
    switch (st.x) {
      case 2: stage<2>(src, dst, tw, N, Ns, tid); break;
      case 3: stage<3>(src, dst, tw, N, Ns, tid); break;
      case 4: stage<4>(src, dst, tw, N, Ns, tid); break;
      case 5: stage<5>(src, dst, tw, N, Ns, tid); break;
      default: stage_generic(src, dst, tw, N, Ns, st.x, tid, group); break;
    }
    group_sync(group);
    Ns *= st.x;
    float2* t = src;
    src = dst;
    dst = t;
  }

  // the two frames' amplitudes, [2][n_bins], into the free buffer
  float* amp = reinterpret_cast<float*>(dst);
  const float half = 0.5f * a.amp_scale;
  for (int k = tid; k < n_bins; k += kGroupThreads) {
    const float2 z = src[slot(k)], c = src[slot(k == 0 ? 0 : N - k)];
    const float ar = z.x + c.x, ai = z.y - c.y;  // 2 A[k]
    const float br = z.y + c.y, bi = c.x - z.x;  // 2 B[k]
    amp[k] = sqrtf(ar * ar + ai * ai) * half;
    amp[n_bins + k] = sqrtf(br * br + bi * bi) * half;
  }
  group_sync(group);

  // mel product over each filter's nonzero bins, clip, dB, normalise
  const int rows = min(2, a.T - t0) * a.n_mels;
  for (int o = tid; o < rows; o += kGroupThreads) {
    const int f = o >= a.n_mels, m = o - f * a.n_mels;
    const int2 sp = __ldg(a.support + m);
    const float* ap = amp + f * n_bins + sp.x;
    const float* wp = s_filt + m * a.width;
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < sp.y - sp.x; ++i) acc = fmaf(ap[i], wp[i], acc);
    float db = 20.f * log10f(fmaxf(fabsf(acc), a.min_amp));
    if (a.normalize) db = (db + a.dyn_range) / a.dyn_range;
    a.out[(size_t)(t0 + f) * a.n_mels + m] = db;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` for T >= 1 frames of a padded signal x of at least
// (T - 1) * hop + n_fft samples, a frame pair a group of kGroupWarps warps,
// at most `groups` groups a block (launch_shape): as many as fit the
// current card's shared memory. Returns a cudaError_t (0 on success;
// cudaErrorInvalidValue where one group does not fit).
int zeggs_mel_spectrogram(const void* x, int T, const void* window, const void* stages,
                          const void* twiddles, int n_twiddles, const void* filters, int width,
                          const void* support, void* out, int n_fft, int hop, int n_mels,
                          float amp_scale, float min_amp, float dyn_range, int normalize,
                          int n_stages, int groups, void* stream) {
  if (T <= 0) return (int)cudaSuccess;
  if (groups < 1 || groups > kMaxGroups || n_fft < 1 || n_mels < 1 || width < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(x), static_cast<const float*>(window),
               static_cast<const int2*>(stages), static_cast<const float2*>(twiddles),
               static_cast<const float*>(filters), static_cast<const int2*>(support),
               static_cast<float*>(out), T, n_fft, hop, n_mels, n_stages, n_twiddles, width,
               amp_scale, min_amp, dyn_range, normalize};
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  while (groups > 1 && smem_bytes(a, groups) > (size_t)limit) --groups;
  const size_t smem = smem_bytes(a, groups);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  static SmemOptIn opt_in;
  err = opt_in.ensure(reinterpret_cast<const void*>(mel_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  const int pairs = (T + 1) / 2, blocks = (pairs + groups - 1) / groups;
  mel_kernel<<<blocks, groups * kGroupThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* zeggs_mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
