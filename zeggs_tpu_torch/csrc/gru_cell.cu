// One GRU step with PyTorch's equations, for Hopper (sm_90a).
//
// Replaces zeggs_tpu/ops/pallas/gru_kernel.py::fused_gru_cell. The plain
// PyTorch version of the same function is gru_cell_plain in
// zeggs_tpu_torch/ops/kernels/gru_cell.py, which also packs the weights and
// plans the launch (gru_plan).
//
//   r  = sigmoid(W_ir x + W_hr h + b_r)        b_r = b_ir + b_hr (folded)
//   z  = sigmoid(W_iz x + W_hz h + b_z)        b_z = b_iz + b_hz (folded)
//   n  = tanh(W_in x + b_in + r * (W_hn h + b_hn))
//   h' = (1 - z) n + z h                       all in float32
//
// What bounds it on an H100: a step reads 6H x (in + H) / 2 float32 weights
// (25.2 MB at in = H = 1024) and does 2 B x 3H x (in + H) FLOPs. Up to
// B = 40 the bytes bound it (7.5 us at 3.35 TB/s); at B = 64 the float32
// FMA rate does (805 MFLOP, 12.0 us at 67 TFLOP/s).
//
// What this design does about that:
//   * a block owns a slab of kUnits = 8 hidden units (24 rows of W_ih and 24
//     of W_hh, PyTorch's layout) for all rows of a batch tile of up to 64;
//     the grid is H / 8 blocks (128 at H = 1024, one wave), so the weights
//     leave L2 once a step for B <= 64 (the daemon's max_batch and
//     generate_batch's chunk), and once per 64 rows beyond;
//   * the slab's weights and the matching columns of [x | h] for the whole
//     batch tile stream through a ring of 5 or 6 stages in shared memory, 64
//     to 256 columns a stage (the smaller the tile, the wider), with cp.async
//     (16-byte copies, zero-filled past the batch and past K), so that up to
//     120 KB are in flight per SM;
//   * the products are register micro-tiles in float32 FMAs: a thread owns
//     RB batch rows x 4 units x (r, z, n_x, n_h) and the 8 warps split each
//     stage's columns, so a float4 of weights read from shared memory feeds
//     4 RB FMAs and a float4 of activations 4 x 12;
//   * the 8 warps' partial sums are added through shared memory in a fixed
//     order, and the r/z/n gates and the blend run in the same kernel: only
//     h' is written.

#include <cuda_runtime.h>

#include <stdint.h>

#include "smem_opt_in.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 8;                 // hidden units of a block's slab
constexpr int kGateRows = 3 * kUnits;     // slab rows of one matrix (r, z, n)
constexpr int kRU = 4;                    // units a thread owns
constexpr int kUG = kUnits / kRU;         // unit groups in a warp

// A batch tile of NB rows: BG batch lanes x kUG unit lanes x KL column lanes
// make a warp; a thread owns RB = NB / BG rows. A ring stage holds kChunk
// columns; small tiles take wider and more stages, so that more bytes are in
// flight where the weights' bytes bound the step (gru_plan mirrors this).
template <int NB>
struct Tile {
  static constexpr int BG = NB < 16 ? NB : 16;
  static constexpr int KL = 16 / BG;
  static constexpr int RB = NB / BG;
  static constexpr int kChunk = NB == 64 ? 64 : (NB == 32 ? 128 : 256);
  static constexpr int kStages = NB == 8 ? 6 : 5;
  static constexpr int kStride = kChunk + 4;  // shared row stride: float4 reads conflict-free
  static constexpr int kIters = kChunk / (4 * KL * kWarps);  // column groups a lane takes
  static constexpr size_t kStageFloats = (size_t)(kGateRows + NB) * kStride;
  static_assert(BG * kUG * KL == 32, "a warp is 32 lanes");
  static_assert(kIters >= 1 && kChunk % (4 * KL * kWarps) == 0, "columns split evenly");
  static_assert(kStages * kStageFloats * 4 <= 232448, "the ring fits in shared memory");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: nothing is read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Multiply-accumulate one ring stage: kHid selects the hidden half of K,
// whose n-gate products go to slot 3 instead of 2.
template <int NB, bool kHid>
__device__ __forceinline__ void mac(const float* st, float (&acc)[Tile<NB>::RB][kRU][4],
                                    int bgi, int ugi, int kl, int warp) {
  using T = Tile<NB>;
  constexpr int kStride = T::kStride;
  const float* sw = st;
  const float* sa = st + kGateRows * kStride;
#pragma unroll
  for (int it = 0; it < T::kIters; ++it) {
    const int col = 4 * (kl + T::KL * (warp + kWarps * it));
    float4 a[T::RB];
#pragma unroll
    for (int i = 0; i < T::RB; ++i)
      a[i] = *reinterpret_cast<const float4*>(sa + (bgi + T::BG * i) * kStride + col);
#pragma unroll
    for (int q = 0; q < kRU; ++q) {
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(sw + (g * kUnits + ugi * kRU + q) * kStride + col);
        constexpr int kN = kHid ? 3 : 2;
        const int s = g < 2 ? g : kN;
#pragma unroll
        for (int i = 0; i < T::RB; ++i) {
          float v = acc[i][q][s];
          v = fmaf(w.x, a[i].x, v);
          v = fmaf(w.y, a[i].y, v);
          v = fmaf(w.z, a[i].z, v);
          v = fmaf(w.w, a[i].w, v);
          acc[i][q][s] = v;
        }
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(kThreads, 1)
gru_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ w_ih, const float* __restrict__ w_hh,
                const float* __restrict__ b_rz, const float* __restrict__ b_in,
                const float* __restrict__ b_hn, float* __restrict__ out, int B, int IN, int H) {
  using T = Tile<NB>;
  constexpr int kChunk = T::kChunk, kStride = T::kStride, kStages = T::kStages;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bgi = lane % T::BG, ugi = (lane / T::BG) % kUG, kl = lane / (T::BG * kUG);
  const int j0 = blockIdx.x * kUnits;
  const int nx = (IN + kChunk - 1) / kChunk;
  const int nc = nx + (H + kChunk - 1) / kChunk;

  for (int b0 = 0; b0 < B; b0 += NB) {
    // stage c: the slab's kChunk columns of W_ih (c < nx) or W_hh, and the
    // same columns of x or h for rows b0 .. b0 + NB - 1
    auto load = [&](int c) {
      float* sw = smem + (c % kStages) * T::kStageFloats;
      float* sa = sw + kGateRows * kStride;
      const bool xpart = c < nx;
      const float* w = xpart ? w_ih : w_hh;
      const float* act = xpart ? x : h;
      const int K = xpart ? IN : H;
      const int col0 = (xpart ? c : c - nx) * kChunk;
      auto weight = [&](int i) {
        const int r = i / (kChunk / 4), col = col0 + 4 * (i % (kChunk / 4));
        const int g = r / kUnits, u = r % kUnits;
        const bool ok = col < K;
        cp_async16(sw + r * kStride + col - col0,
                   ok ? w + (size_t)(g * H + j0 + u) * K + col : w, ok);
      };
      auto activation = [&](int i) {
        const int b = i / (kChunk / 4), col = col0 + 4 * (i % (kChunk / 4));
        const bool ok = col < K && b0 + b < B;
        cp_async16(sa + b * kStride + col - col0, ok ? act + (size_t)(b0 + b) * K + col : act, ok);
      };
      if constexpr (NB == 8) {  // the widest stage: unrolled, its addresses would spill
#pragma unroll 1
        for (int i = tid; i < kGateRows * (kChunk / 4); i += kThreads) weight(i);
#pragma unroll 1
        for (int i = tid; i < NB * (kChunk / 4); i += kThreads) activation(i);
      } else {
        for (int i = tid; i < kGateRows * (kChunk / 4); i += kThreads) weight(i);
        for (int i = tid; i < NB * (kChunk / 4); i += kThreads) activation(i);
      }
    };

    float acc[T::RB][kRU][4];
#pragma unroll
    for (int i = 0; i < T::RB; ++i)
#pragma unroll
      for (int q = 0; q < kRU; ++q)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[i][q][s] = 0.f;

    __syncthreads();  // the previous tile's epilogue is done with the shared memory
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nc) load(s);
      cp_async_commit();
    }
    for (int c = 0; c < nc; ++c) {
      cp_async_wait<kStages - 2>();  // stage c has landed (this thread's copies)
      __syncthreads();               // ... and every thread's; stage c - 1 is free
      if (c + kStages - 1 < nc) load(c + kStages - 1);
      cp_async_commit();
      const float* st = smem + (c % kStages) * T::kStageFloats;
      if (c < nx) mac<NB, false>(st, acc, bgi, ugi, kl, warp);
      else mac<NB, true>(st, acc, bgi, ugi, kl, warp);
    }
    cp_async_wait<0>();

    // the KL column lanes of a (row, unit) pair hold parts of one sum
#pragma unroll
    for (int o = T::BG * kUG; o < 32; o <<= 1)
#pragma unroll
      for (int i = 0; i < T::RB; ++i)
#pragma unroll
        for (int q = 0; q < kRU; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[i][q][s] += __shfl_xor_sync(0xffffffffu, acc[i][q][s], o);
    __syncthreads();  // every warp is done with the ring: it holds the partial sums now
    float* red = smem;  // [kWarps][NB][kUnits][4]
    if (kl == 0) {
#pragma unroll
      for (int i = 0; i < T::RB; ++i)
#pragma unroll
        for (int q = 0; q < kRU; ++q)
#pragma unroll
          for (int s = 0; s < 4; ++s)
            red[((warp * NB + bgi + T::BG * i) * kUnits + ugi * kRU + q) * 4 + s] = acc[i][q][s];
    }
    __syncthreads();
    for (int p = tid; p < NB * kUnits; p += kThreads) {
      const int b = p / kUnits, u = p % kUnits, row = b0 + b, j = j0 + u;
      if (row >= B) continue;
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < kWarps; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(red + ((w * NB + b) * kUnits + u) * 4);
        s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
      }
      const float r = sigmoid(s[0] + b_rz[j]);
      const float z = sigmoid(s[1] + b_rz[H + j]);
      const float n = tanhf(s[2] + b_in[j] + r * (s[3] + b_hn[j]));
      out[(size_t)row * H + j] = (1.f - z) * n + z * h[(size_t)row * H + j];
    }
  }
}

template <int NB>
size_t smem_bytes() {
  return (size_t)Tile<NB>::kStages * Tile<NB>::kStageFloats * sizeof(float);
}

// a: x, h, w_ih, w_hh, b_rz, b_in, b_hn
template <int NB>
int launch(const float* const* a, float* out, int B, int IN, int H, cudaStream_t stream) {
  static SmemOptIn opt_in;  // one per instantiation, opted in once per device
  const size_t smem = smem_bytes<NB>();
  cudaError_t err = opt_in.ensure(reinterpret_cast<const void*>(gru_cell_kernel<NB>), smem);
  if (err != cudaSuccess) return (int)err;
  gru_cell_kernel<NB><<<H / kUnits, kThreads, smem, stream>>>(a[0], a[1], a[2], a[3], a[4], a[5],
                                                             a[6], out, B, IN, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one step on `stream` with batch tiles of `tile` rows (8, 16, 32 or
// 64, from gru_plan); returns a cudaError_t (0 on success).
int zeggs_gru_cell(const void* x, const void* h, const void* w_ih, const void* w_hh,
                   const void* b_rz, const void* b_in, const void* b_hn, void* out, int B,
                   int in_dim, int H, int tile, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (H % kUnits || in_dim % 4) return (int)cudaErrorInvalidValue;
  const float* args[] = {static_cast<const float*>(x), static_cast<const float*>(h),
                         static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
                         static_cast<const float*>(b_rz), static_cast<const float*>(b_in),
                         static_cast<const float*>(b_hn)};
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 8: return launch<8>(args, o, B, in_dim, H, s);
    case 16: return launch<16>(args, o, B, in_dim, H, s);
    case 32: return launch<32>(args, o, B, in_dim, H, s);
    case 64: return launch<64>(args, o, B, in_dim, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* zeggs_gru_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
