// Whole B=1 autoregressive decoder rollout in one launch, for Hopper (sm_90a).
//
// Replaces zeggs_tpu/ops/pallas/decoder_kernel.py::rollout_fused_b1 (the
// Pallas kernel built in _build_kernel). The plain PyTorch version of the same
// function is rollout_b1_plain in zeggs_tpu_torch/ops/kernels/decoder_rollout.py,
// and that module packs the weights and documents the shared numerics.
//
// What bounds it on an H100: every step reads the whole packed cell, about
// 18.4M weights (37 MB in bf16, below the 50 MB L2; 74 MB in fp32, above it),
// for about 37 MFLOP. At one row (B=1) that is one multiply-add per weight
// read, so bytes and the latency of the grid-wide barriers between dependent
// phases bound it, never FLOPs.
//
// What this first design does about that:
//   * one persistent cooperative launch runs all T-1 steps; the grid is sized
//     so that every block is resident, and cg::this_grid().sync() separates
//     the four dependent phases of a step;
//   * a warp owns one packed row (an output column, K contiguous) at a time,
//     reads it with 16-byte loads and reduces with warp shuffles; the
//     activation vector it multiplies lives in shared memory;
//   * every product that depends only on the step's input and the carried
//     state (layer0, GRU0's pose part, both w_hh products: 10H of the 13H+PO
//     rows) runs in phase 1, before the first barrier;
//   * for a GRU, one warp owns hidden unit j and computes its columns j, H+j
//     and 2H+j, so the r/z/n gates and the blend stay in registers;
//   * the root is integrated redundantly by every block from the same inputs
//     (bit-identical), so it needs no barrier of its own.
// The weights are streamed from L2/HBM every step; keeping them in shared
// memory and registers of the persistent grid, TMA, wgmma and clusters are
// later work.
//
// Step t (rows are written for frames 1..T-1; frame 0 is the input state):
//   phase 1  x = round((pose_prev | gaze in root frame) - mean) * rstd)
//            s1 = [W_l0 x | W_g0x x | W_g0hh round(h0) | W_g1hh round(h1)]
//   barrier 1
//   phase 2  hidden = elu(cond_l0[t] + s1_l0); h0' = GRU0 gates      -> h0[next]
//   barrier 2
//   phase 3  h1' = GRU1 gates on W_g1ih round(h0')                     -> h1[next]
//   barrier 3
//   phase 4  pose = (W_out round(h1') + b) * out_std + out_mean        -> pose[next], out[t]
//   barrier 4
//   root     every block: root_pos += R v dt; root_rot = exp(R w dt / 2) * root_rot
//
// The carried state lives in device scratch, double-buffered by step parity,
// so no block reads a value another block is overwriting. Values written by
// other blocks are read with __ldcg (L2, never a stale L1 line).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2;

struct Args {
  const void* wx;        // (4H, KX) weight dtype
  const void* wh;        // (12H + PO, H) weight dtype
  const float* gbias;    // (3, 3H): GRU0 b_hh, GRU1 b_ih, GRU1 b_hh
  const float* bout;     // (PO)
  const float* stats;    // (4, PI): in_mean, in_rstd, out_std, out_mean
  const float* cond_l0;  // (T1, H)
  const float* cond_g0;  // (T1, 3H)
  const float* gaze;     // (T1, 3)
  const float* p0;       // (PO) frame-0 pose
  const float* h_init;   // (2, H)
  const float* root0;    // (7) root_pos | root_rot
  float* out;            // (T1, PO + 7)
  float* scratch;        // 2PO + 14H floats
  int T1, H, PI, PO, KX;
  float dt;
};

__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  // eight bf16 in one 16-byte load; element 2i is the low half of word i
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = __uint_as_float(u.x << 16); w[1] = __uint_as_float(u.x & 0xffff0000u);
  w[2] = __uint_as_float(u.y << 16); w[3] = __uint_as_float(u.y & 0xffff0000u);
  w[4] = __uint_as_float(u.z << 16); w[5] = __uint_as_float(u.z & 0xffff0000u);
  w[6] = __uint_as_float(u.w << 16); w[7] = __uint_as_float(u.w & 0xffff0000u);
}

// An activation rounded to the weight dtype (round to nearest even).
template <typename T> __device__ __forceinline__ float round_act(float x);
template <> __device__ __forceinline__ float round_act<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_act<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// R dot products of length K (a multiple of 8) against the shared-memory
// activation `act`: rows row0, row0 + step, ... Every lane of the warp gets
// the sums.
template <typename T, int R>
__device__ __forceinline__ void warp_dots(const T* __restrict__ row0, size_t step,
                                          const float* act, int K, float (&acc)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int k = lane * 8; k < K; k += 256) {
    const float4 a0 = *reinterpret_cast<const float4*>(act + k);
    const float4 a1 = *reinterpret_cast<const float4*>(act + k + 4);
    float w[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r) load8(row0 + r * step + k, w[r]);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float s = acc[r];
      s = fmaf(w[r][0], a0.x, s); s = fmaf(w[r][1], a0.y, s);
      s = fmaf(w[r][2], a0.z, s); s = fmaf(w[r][3], a0.w, s);
      s = fmaf(w[r][4], a1.x, s); s = fmaf(w[r][5], a1.y, s);
      s = fmaf(w[r][6], a1.z, s); s = fmaf(w[r][7], a1.w, s);
      acc[r] = s;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = warp_sum(acc[r]);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float gru_blend(float gi_r, float gi_z, float gi_n, float gh_r,
                                           float gh_z, float gh_n, float h) {
  const float r = sigmoid(gi_r + gh_r);
  const float z = sigmoid(gi_z + gh_z);
  const float n = tanhf(gi_n + r * gh_n);
  return (1.f - z) * n + z * h;
}

// Rotate v by the unit quaternion q = (w, x, y, z).
__device__ __forceinline__ void quat_mul_vec(const float* q, const float* v, float* out) {
  float t0 = 2.f * (q[2] * v[2] - q[3] * v[1]);
  float t1 = 2.f * (q[3] * v[0] - q[1] * v[2]);
  float t2 = 2.f * (q[1] * v[1] - q[2] * v[0]);
  out[0] = v[0] + q[0] * t0 + (q[2] * t2 - q[3] * t1);
  out[1] = v[1] + q[0] * t1 + (q[3] * t0 - q[1] * t2);
  out[2] = v[2] + q[0] * t2 + (q[1] * t1 - q[2] * t0);
}

// Hamilton product x * y.
__device__ __forceinline__ void quat_mul(const float* x, const float* y, float* out) {
  out[0] = y[0] * x[0] - y[1] * x[1] - y[2] * x[2] - y[3] * x[3];
  out[1] = y[0] * x[1] + y[1] * x[0] - y[2] * x[3] + y[3] * x[2];
  out[2] = y[0] * x[2] + y[1] * x[3] + y[2] * x[0] - y[3] * x[1];
  out[3] = y[0] * x[3] - y[1] * x[2] + y[2] * x[1] + y[3] * x[0];
}

// exp(v / 2) with the small-angle branch normalize([1, h]) below 1e-5.
__device__ __forceinline__ void quat_from_helical(const float* v, float* q) {
  const float hx = v[0] * 0.5f, hy = v[1] * 0.5f, hz = v[2] * 0.5f;
  const float sq = hx * hx + hy * hy + hz * hz;
  const float ha = sqrtf(sq);
  if (ha < 1e-5f) {
    const float tn = 1.f / sqrtf(1.f + sq);
    q[0] = tn; q[1] = hx * tn; q[2] = hy * tn; q[3] = hz * tn;
  } else {
    const float s = sinf(ha) / ha;
    q[0] = cosf(ha); q[1] = hx * s; q[2] = hy * s; q[3] = hz * s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
decoder_rollout_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];

  const int H = a.H, G = 3 * H, PI = a.PI, PO = a.PO, KX = a.KX;
  float* s_x = smem;           // [KX] phase-1 input
  float* s_h0 = s_x + KX;      // [H]  round(h0)
  float* s_h1 = s_h0 + H;      // [H]  round(h1)
  float* s_act = s_h1 + H;     // [H]  phases 2-4 activation
  float* s_root = s_act + H;   // [8]  root_pos | root_rot
  float* s_gd = s_root + 8;    // [4]  gaze in the root frame

  const T* wx = static_cast<const T*>(a.wx);
  const T* wh = static_cast<const T*>(a.wh);
  const T* w_g0h = wh;
  const T* w_g0hh = wh + (size_t)G * H;
  const T* w_g1ih = wh + (size_t)2 * G * H;
  const T* w_g1hh = wh + (size_t)3 * G * H;
  const T* w_out = wh + (size_t)4 * G * H;

  const float* in_mean = a.stats;
  const float* in_rstd = a.stats + PI;
  const float* out_std = a.stats + 2 * PI;
  const float* out_mean = a.stats + 3 * PI;

  float* pose_buf = a.scratch;      // [2][PO]
  float* h0_buf = pose_buf + 2 * PO;  // [2][H]
  float* h1_buf = h0_buf + 2 * H;     // [2][H]
  float* s1 = h1_buf + 2 * H;         // [10H] phase-1 products

  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;

  if (threadIdx.x < 7) s_root[threadIdx.x] = a.root0[threadIdx.x];
  __syncthreads();

  for (int t = 0; t < a.T1; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const float* pose_c = t == 0 ? a.p0 : pose_buf + cur * PO;
    const float* h0_c = t == 0 ? a.h_init : h0_buf + cur * H;
    const float* h1_c = t == 0 ? a.h_init + H : h1_buf + cur * H;
    float* pose_n = pose_buf + nxt * PO;
    float* h0_n = h0_buf + nxt * H;
    float* h1_n = h1_buf + nxt * H;

    // ---- phase 1: the step's input and every product on carried state ----
    if (threadIdx.x == 0) {
      const float gz[3] = {a.gaze[3 * t] - s_root[0], a.gaze[3 * t + 1] - s_root[1],
                           a.gaze[3 * t + 2] - s_root[2]};
      const float q_inv[4] = {s_root[3], -s_root[4], -s_root[5], -s_root[6]};
      quat_mul_vec(q_inv, gz, s_gd);
    }
    __syncthreads();
    for (int k = threadIdx.x; k < KX; k += kThreads) {
      float v = 0.f;
      if (k < PO) v = (__ldcg(pose_c + k) - in_mean[k]) * in_rstd[k];
      else if (k < PI) v = (s_gd[k - PO] - in_mean[k]) * in_rstd[k];
      s_x[k] = round_act<T>(v);
    }
    for (int k = threadIdx.x; k < H; k += kThreads) {
      s_h0[k] = round_act<T>(__ldcg(h0_c + k));
      s_h1[k] = round_act<T>(__ldcg(h1_c + k));
    }
    __syncthreads();
    for (int task = gwarp; task < 10 * H; task += nwarps) {
      float d[1];
      if (task < 4 * H) warp_dots<T, 1>(wx + (size_t)task * KX, 0, s_x, KX, d);
      else if (task < 7 * H) warp_dots<T, 1>(w_g0hh + (size_t)(task - 4 * H) * H, 0, s_h0, H, d);
      else warp_dots<T, 1>(w_g1hh + (size_t)(task - 7 * H) * H, 0, s_h1, H, d);
      if (lane == 0) __stcg(s1 + task, d[0]);
    }
    grid.sync();  // 1: layer0 and the phase-1 products are complete

    // ---- phase 2: layer0 + ELU, GRU0 -------------------------------------
    for (int k = threadIdx.x; k < H; k += kThreads) {
      const float pre = a.cond_l0[(size_t)t * H + k] + __ldcg(s1 + k);
      s_act[k] = round_act<T>(pre > 0.f ? pre : expf(pre) - 1.f);
    }
    __syncthreads();
    for (int j = gwarp; j < H; j += nwarps) {
      float d[3];
      warp_dots<T, 3>(w_g0h + (size_t)j * H, (size_t)H * H, s_act, H, d);
      if (lane == 0) {
        const float* cg0 = a.cond_g0 + (size_t)t * G;
        const float gi_r = (cg0[j] + __ldcg(s1 + H + j)) + d[0];
        const float gi_z = (cg0[H + j] + __ldcg(s1 + 2 * H + j)) + d[1];
        const float gi_n = (cg0[2 * H + j] + __ldcg(s1 + 3 * H + j)) + d[2];
        const float gh_r = __ldcg(s1 + 4 * H + j) + a.gbias[j];
        const float gh_z = __ldcg(s1 + 5 * H + j) + a.gbias[H + j];
        const float gh_n = __ldcg(s1 + 6 * H + j) + a.gbias[2 * H + j];
        __stcg(h0_n + j, gru_blend(gi_r, gi_z, gi_n, gh_r, gh_z, gh_n, __ldcg(h0_c + j)));
      }
    }
    grid.sync();  // 2: the new GRU0 state is complete

    // ---- phase 3: GRU1 ---------------------------------------------------
    for (int k = threadIdx.x; k < H; k += kThreads) s_act[k] = round_act<T>(__ldcg(h0_n + k));
    __syncthreads();
    for (int j = gwarp; j < H; j += nwarps) {
      float d[3];
      warp_dots<T, 3>(w_g1ih + (size_t)j * H, (size_t)H * H, s_act, H, d);
      if (lane == 0) {
        const float* b_ih = a.gbias + G;
        const float* b_hh = a.gbias + 2 * G;
        const float gh_r = __ldcg(s1 + 7 * H + j) + b_hh[j];
        const float gh_z = __ldcg(s1 + 8 * H + j) + b_hh[H + j];
        const float gh_n = __ldcg(s1 + 9 * H + j) + b_hh[2 * H + j];
        __stcg(h1_n + j, gru_blend(d[0] + b_ih[j], d[1] + b_ih[H + j], d[2] + b_ih[2 * H + j],
                                   gh_r, gh_z, gh_n, __ldcg(h1_c + j)));
      }
    }
    grid.sync();  // 3: the new GRU1 state is complete

    // ---- phase 4: output projection, denormalise -------------------------
    for (int k = threadIdx.x; k < H; k += kThreads) s_act[k] = round_act<T>(__ldcg(h1_n + k));
    __syncthreads();
    float* out_row = a.out + (size_t)t * (PO + 7);
    for (int c = gwarp; c < PO; c += nwarps) {
      float d[1];
      warp_dots<T, 1>(w_out + (size_t)c * H, 0, s_act, H, d);
      if (lane == 0) {
        const float p = (d[0] + a.bout[c]) * out_std[c] + out_mean[c];
        __stcg(pose_n + c, p);
        out_row[c] = p;
      }
    }
    grid.sync();  // 4: the output row, with its root velocities, is complete

    // ---- root integration, in every block --------------------------------
    if (threadIdx.x == 0) {
      float v[3], w[3], wv[3], ww[3], dq[4], rq[4];
      for (int i = 0; i < 3; ++i) {
        v[i] = __ldcg(pose_n + i) * a.dt;
        w[i] = __ldcg(pose_n + 3 + i) * a.dt;
      }
      for (int i = 0; i < 4; ++i) rq[i] = s_root[3 + i];
      quat_mul_vec(rq, v, wv);
      quat_mul_vec(rq, w, ww);
      quat_from_helical(ww, dq);
      for (int i = 0; i < 3; ++i) s_root[i] += wv[i];
      quat_mul(dq, rq, s_root + 3);
      if (blockIdx.x == 0)
        for (int i = 0; i < 7; ++i) out_row[PO + i] = s_root[i];
    }
    __syncthreads();
  }
}

size_t smem_bytes(int H, int KX) { return (size_t)(KX + 3 * H + 12) * sizeof(float); }

// Blocks of one cooperative launch (all resident at once), or a negative
// cudaError_t.
template <typename T>
int grid_blocks(int H, int KX) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = smem_bytes(H, KX);
  err = cudaFuncSetAttribute(decoder_rollout_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decoder_rollout_kernel<T>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return sms * (per_sm < kMaxBlocksPerSm ? per_sm : kMaxBlocksPerSm);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  if (a.T1 <= 0) return (int)cudaSuccess;
  const int blocks = grid_blocks<T>(a.H, a.KX);
  if (blocks < 0) return -blocks;
  void* params[] = {const_cast<Args*>(&a)};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(decoder_rollout_kernel<T>), dim3(blocks), dim3(kThreads),
      params, smem_bytes(a.H, a.KX), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the rollout on `stream`; returns a cudaError_t (0 on success).
int zeggs_decoder_rollout(int weights_bf16, const void* wx, const void* wh, const void* gbias,
                          const void* bout, const void* stats, const void* cond_l0,
                          const void* cond_g0, const void* gaze, const void* p0,
                          const void* h_init, const void* root0, void* out, void* scratch,
                          int T1, int H, int pose_in, int pose_out, int kx, float dt,
                          void* stream) {
  const Args a{wx, wh,
               static_cast<const float*>(gbias), static_cast<const float*>(bout),
               static_cast<const float*>(stats), static_cast<const float*>(cond_l0),
               static_cast<const float*>(cond_g0), static_cast<const float*>(gaze),
               static_cast<const float*>(p0), static_cast<const float*>(h_init),
               static_cast<const float*>(root0), static_cast<float*>(out),
               static_cast<float*>(scratch), T1, H, pose_in, pose_out, kx, dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return weights_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

// Blocks per launch on the current device, or a negative cudaError_t.
int zeggs_decoder_rollout_grid(int weights_bf16, int H, int kx) {
  return weights_bf16 ? grid_blocks<__nv_bfloat16>(H, kx) : grid_blocks<float>(H, kx);
}

const char* zeggs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
