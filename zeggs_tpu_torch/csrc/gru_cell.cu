// One GRU step with PyTorch's equations, for Hopper (sm_90a).
//
// Replaces zeggs_tpu/ops/pallas/gru_kernel.py::fused_gru_cell. The plain
// PyTorch version of the same function is gru_cell_plain in
// zeggs_tpu_torch/ops/kernels/gru_cell.py, which also packs the weights.
//
//   r  = sigmoid(W_ir x + W_hr h + b_r)        b_r = b_ir + b_hr (folded)
//   z  = sigmoid(W_iz x + W_hz h + b_z)        b_z = b_iz + b_hz (folded)
//   n  = tanh(W_in x + b_in + r * (W_hn h + b_hn))
//   h' = (1 - z) n + z h                       all in float32
//
// What bounds it on an H100: at the batched rollout's B = 2..64 and
// in = H = 1024, a step reads 6H x 1024 float32 weights (25 MB, held in the
// 50 MB L2 across steps) for 2 B x 6.3M FLOP, so it is bound by weight
// bytes and, at small B, by latency.
//
// What this first design does about that:
//   * one warp owns hidden unit j: its six gate rows (r, z, n of W_ih and of
//     W_hh, K contiguous in PyTorch's layout) are read with 16-byte loads and
//     applied to every batch row of a tile, so r, z, n and the blend stay in
//     registers and nothing but h' is written;
//   * x and h of a tile of kTile batch rows are staged in shared memory and
//     shared by the block's warps; the weights are read once per tile, so
//     once per step for B <= kTile (from L2 when B > kTile);
//   * sums are float32, reduced across the warp with shuffles.
// Keeping the weights resident across steps and tensor-core products are
// later work.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 8;  // batch rows per shared-memory tile

__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Three gate rows (j, H + j, 2H + j of a (3H, K) matrix) against the kTile
// staged activation rows `act` (kTile, K), accumulated into acc[..][g0..g0+2]
// of this lane; K is a multiple of 8.
__device__ __forceinline__ void gate_dots(const float* __restrict__ w, int j, int H, int K,
                                          const float* act, float (&acc)[kTile][6], int g0) {
  const int lane = threadIdx.x & 31;
  const size_t rstep = (size_t)H * K;
#pragma unroll 2
  for (int k = lane * 8; k < K; k += 256) {
    float wr[3][8];
#pragma unroll
    for (int r = 0; r < 3; ++r) load8(w + (size_t)j * K + r * rstep + k, wr[r]);
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const float4 a0 = *reinterpret_cast<const float4*>(act + b * K + k);
      const float4 a1 = *reinterpret_cast<const float4*>(act + b * K + k + 4);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        float s = acc[b][g0 + r];
        s = fmaf(wr[r][0], a0.x, s); s = fmaf(wr[r][1], a0.y, s);
        s = fmaf(wr[r][2], a0.z, s); s = fmaf(wr[r][3], a0.w, s);
        s = fmaf(wr[r][4], a1.x, s); s = fmaf(wr[r][5], a1.y, s);
        s = fmaf(wr[r][6], a1.z, s); s = fmaf(wr[r][7], a1.w, s);
        acc[b][g0 + r] = s;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gru_cell_kernel(const float* __restrict__ x, const float* __restrict__ h,
                const float* __restrict__ w_ih, const float* __restrict__ w_hh,
                const float* __restrict__ b_rz, const float* __restrict__ b_in,
                const float* __restrict__ b_hn, float* __restrict__ out, int B, int IN, int H) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;               // [kTile][IN]
  float* s_h = smem + kTile * IN;  // [kTile][H]
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarps + (threadIdx.x >> 5);

  for (int b0 = 0; b0 < B; b0 += kTile) {
    const int nb = min(kTile, B - b0);
    __syncthreads();  // the previous tile has been read
    // rows past the batch are zeros: computed, never written
    for (int i = threadIdx.x; i < kTile * IN; i += kThreads)
      s_x[i] = i < nb * IN ? x[(size_t)b0 * IN + i] : 0.f;
    for (int i = threadIdx.x; i < kTile * H; i += kThreads)
      s_h[i] = i < nb * H ? h[(size_t)b0 * H + i] : 0.f;
    __syncthreads();
    if (j >= H) continue;  // warp-uniform; the barriers above stay matched

    float acc[kTile][6];
#pragma unroll
    for (int b = 0; b < kTile; ++b)
#pragma unroll
      for (int g = 0; g < 6; ++g) acc[b][g] = 0.f;
    gate_dots(w_ih, j, H, IN, s_x, acc, 0);
    gate_dots(w_hh, j, H, H, s_h, acc, 3);
#pragma unroll
    for (int b = 0; b < kTile; ++b)
#pragma unroll
      for (int g = 0; g < 6; ++g) acc[b][g] = warp_sum(acc[b][g]);

    // lane b finishes batch row b0 + b
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      if (lane == b && b < nb) {
        const float r = sigmoid(acc[b][0] + acc[b][3] + b_rz[j]);
        const float z = sigmoid(acc[b][1] + acc[b][4] + b_rz[H + j]);
        const float n = tanhf(acc[b][2] + b_in[j] + r * (acc[b][5] + b_hn[j]));
        out[(size_t)(b0 + b) * H + j] = (1.f - z) * n + z * s_h[b * H + j];
      }
    }
  }
}

size_t smem_bytes(int IN, int H) { return (size_t)kTile * (IN + H) * sizeof(float); }

}  // namespace

extern "C" {

// Launch one step on `stream`; returns a cudaError_t (0 on success).
int zeggs_gru_cell(const void* x, const void* h, const void* w_ih, const void* w_hh,
                   const void* b_rz, const void* b_in, const void* b_hn, void* out, int B,
                   int in_dim, int H, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  static size_t smem_set = 48 * 1024;  // dynamic shared memory allowed so far
  const size_t smem = smem_bytes(in_dim, H);
  if (smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(gru_cell_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int blocks = (H + kWarps - 1) / kWarps;
  gru_cell_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(h),
      static_cast<const float*>(w_ih), static_cast<const float*>(w_hh),
      static_cast<const float*>(b_rz), static_cast<const float*>(b_in),
      static_cast<const float*>(b_hn), static_cast<float*>(out), B, in_dim, H);
  return (int)cudaGetLastError();
}

// Largest in_dim + H whose batch tile fits in a block's shared memory.
int zeggs_gru_cell_max_width(void) { return 232448 / (kTile * (int)sizeof(float)); }

const char* zeggs_gru_cell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
