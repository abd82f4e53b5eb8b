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
// Three instantiations: float32, bf16 and int8 weights. With int8 weights
// (the quantized branch of the Pallas kernel) a step streams 18.4 MB, half
// of bf16. Each packed row carries one float32 scale; each of the six
// activation vectors of a step (the normalised input, hidden, h0 before and
// after the step, h1 before and after) is quantized once with one symmetric
// scale s = max(max|x|, 1e-8) / 127, q = clip(rint(x / s), -127, 127); a
// row's product is an int32 sum of __dp4a over 16-byte loads, dequantized
// as acc * (s_act * s_row). Every activation a phase quantizes is complete
// after the barrier before that phase and a max is exact in any order, so
// every block computes the same scale itself and no barrier is added.
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

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocksPerSm = 2;
// floats of the block-reduction scratch; a multiple of 4, so that the int8
// arrays after it stay 16-byte aligned (KX and H are multiples of 16 there)
constexpr int kRedFloats = kWarps;
static_assert(kRedFloats % 4 == 0, "int8 activations must stay 16-byte aligned");

struct Args {
  const void* wx;        // (4H, KX) weight dtype
  const void* wh;        // (12H + PO, H) weight dtype
  const float* sx;       // (4H) row scales of wx (int8 weights only)
  const float* sh;       // (12H + PO) row scales of wh (int8 weights only)
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
// int8 weights quantize the float value instead (see quantize)
template <> __device__ __forceinline__ float round_act<int8_t>(float x) { return x; }

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

// R int8 dot products of length K (a multiple of 16) against the int8
// activation `act`, in int32: 16 bytes a lane and four __dp4a per load.
template <int R>
__device__ __forceinline__ void warp_dots_i8(const int8_t* __restrict__ row0, size_t step,
                                             const int8_t* act, int K, int (&acc)[R]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0;
#pragma unroll 2
  for (int k = lane * 16; k < K; k += 512) {
    const int4 a = *reinterpret_cast<const int4*>(act + k);
    int4 w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = __ldg(reinterpret_cast<const int4*>(row0 + r * step + k));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int s = acc[r];
      s = __dp4a(w[r].x, a.x, s); s = __dp4a(w[r].y, a.y, s);
      s = __dp4a(w[r].z, a.z, s); s = __dp4a(w[r].w, a.w, s);
      acc[r] = s;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
}

// An activation vector as a product phase reads it: float values (rounded
// to the weight dtype) or int8 values with their scale.
struct Act {
  const float* v;
  const int8_t* q;
  float s;
};

// R rows row, row + rstep, ... of the (N, K) matrix `w` against `act`;
// `scales` are the matrix's row scales (int8 weights only).
template <typename T, int R>
__device__ __forceinline__ void dots(const T* w, int row, int rstep, const Act& act, int K,
                                     const float* scales, float (&d)[R]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    // the row scales are loaded before the weights, so that their latency
    // overlaps the dot product's instead of following it
    float sr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sr[r] = __ldg(scales + row + r * rstep);
    int acc[R];
    warp_dots_i8<R>(w + (size_t)row * K, (size_t)rstep * K, act.q, K, acc);
#pragma unroll
    for (int r = 0; r < R; ++r) d[r] = (float)acc[r] * (act.s * sr[r]);
  } else {
    warp_dots<T, R>(w + (size_t)row * K, (size_t)rstep * K, act.v, K, d);
  }
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red[i]);
  __syncthreads();  // red is free again
  return m;
}

// Quantize the n float values `v` (complete in shared memory, max|v| = m)
// into `q`; returns the scale. The caller synchronises before `q` is read.
__device__ __forceinline__ float quantize(const float* v, int8_t* q, int n, float m) {
  const float s = fmaxf(m, 1e-8f) / 127.f;
  for (int k = threadIdx.x; k < n; k += kThreads)
    q[k] = (int8_t)fminf(fmaxf(rintf(v[k] / s), -127.f), 127.f);
  return s;
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
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];

  const int H = a.H, G = 3 * H, PI = a.PI, PO = a.PO, KX = a.KX;
  float* s_x = smem;           // [KX] phase-1 input
  float* s_h0 = s_x + KX;      // [H]  round(h0)
  float* s_h1 = s_h0 + H;      // [H]  round(h1)
  float* s_act = s_h1 + H;     // [H]  phases 2-4 activation
  float* s_root = s_act + H;   // [8]  root_pos | root_rot
  float* s_gd = s_root + 8;    // [4]  gaze in the root frame
  float* s_red = s_gd + 4;     // [kWarps] block reductions
  // int8 weights: the same four activations quantized (16-byte aligned)
  int8_t* q_x = reinterpret_cast<int8_t*>(s_red + kRedFloats);  // [KX]
  int8_t* q_h0 = q_x + KX;     // [H]
  int8_t* q_h1 = q_h0 + H;     // [H]
  int8_t* q_act = q_h1 + H;    // [H]

  const T* wx = static_cast<const T*>(a.wx);
  const T* wh = static_cast<const T*>(a.wh);
  // row offsets in wh: GRU0 hidden part | GRU0 w_hh | GRU1 w_ih | GRU1 w_hh | out
  const int r_g0hh = G, r_g1ih = 2 * G, r_g1hh = 3 * G, r_out = 4 * G;
  Act act_x{s_x, q_x, 1.f}, act_h0{s_h0, q_h0, 1.f}, act_h1{s_h1, q_h1, 1.f};
  Act act{s_act, q_act, 1.f};

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
    float m_x = 0.f, m_h0 = 0.f, m_h1 = 0.f;
    for (int k = threadIdx.x; k < KX; k += kThreads) {
      float v = 0.f;
      if (k < PO) v = (__ldcg(pose_c + k) - in_mean[k]) * in_rstd[k];
      else if (k < PI) v = (s_gd[k - PO] - in_mean[k]) * in_rstd[k];
      s_x[k] = round_act<T>(v);
      m_x = fmaxf(m_x, fabsf(v));
    }
    for (int k = threadIdx.x; k < H; k += kThreads) {
      const float v0 = __ldcg(h0_c + k), v1 = __ldcg(h1_c + k);
      s_h0[k] = round_act<T>(v0);
      s_h1[k] = round_act<T>(v1);
      m_h0 = fmaxf(m_h0, fabsf(v0));
      m_h1 = fmaxf(m_h1, fabsf(v1));
    }
    if constexpr (kInt8) {
      m_x = block_max(m_x, s_red);
      m_h0 = block_max(m_h0, s_red);
      m_h1 = block_max(m_h1, s_red);
      act_x.s = quantize(s_x, q_x, KX, m_x);
      act_h0.s = quantize(s_h0, q_h0, H, m_h0);
      act_h1.s = quantize(s_h1, q_h1, H, m_h1);
    }
    __syncthreads();
    for (int task = gwarp; task < 10 * H; task += nwarps) {
      float d[1];
      if (task < 4 * H) dots<T, 1>(wx, task, 0, act_x, KX, a.sx, d);
      else if (task < 7 * H) dots<T, 1>(wh, r_g0hh + task - 4 * H, 0, act_h0, H, a.sh, d);
      else dots<T, 1>(wh, r_g1hh + task - 7 * H, 0, act_h1, H, a.sh, d);
      if (lane == 0) __stcg(s1 + task, d[0]);
    }
    grid.sync();  // 1: layer0 and the phase-1 products are complete

    // ---- phase 2: layer0 + ELU, GRU0 -------------------------------------
    float m = 0.f;
    for (int k = threadIdx.x; k < H; k += kThreads) {
      const float pre = a.cond_l0[(size_t)t * H + k] + __ldcg(s1 + k);
      const float hid = pre > 0.f ? pre : expf(pre) - 1.f;
      s_act[k] = round_act<T>(hid);
      m = fmaxf(m, fabsf(hid));
    }
    if constexpr (kInt8) act.s = quantize(s_act, q_act, H, block_max(m, s_red));
    __syncthreads();
    for (int j = gwarp; j < H; j += nwarps) {
      float d[3];
      dots<T, 3>(wh, j, H, act, H, a.sh, d);
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
    m = 0.f;
    for (int k = threadIdx.x; k < H; k += kThreads) {
      const float v = __ldcg(h0_n + k);
      s_act[k] = round_act<T>(v);
      m = fmaxf(m, fabsf(v));
    }
    if constexpr (kInt8) act.s = quantize(s_act, q_act, H, block_max(m, s_red));
    __syncthreads();
    for (int j = gwarp; j < H; j += nwarps) {
      float d[3];
      dots<T, 3>(wh, r_g1ih + j, H, act, H, a.sh, d);
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
    m = 0.f;
    for (int k = threadIdx.x; k < H; k += kThreads) {
      const float v = __ldcg(h1_n + k);
      s_act[k] = round_act<T>(v);
      m = fmaxf(m, fabsf(v));
    }
    if constexpr (kInt8) act.s = quantize(s_act, q_act, H, block_max(m, s_red));
    __syncthreads();
    float* out_row = a.out + (size_t)t * (PO + 7);
    for (int c = gwarp; c < PO; c += nwarps) {
      float d[1];
      dots<T, 1>(wh, r_out + c, 0, act, H, a.sh, d);
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

template <typename T>
size_t smem_bytes(int H, int KX) {
  const size_t floats = (size_t)(KX + 3 * H + 12 + kRedFloats) * sizeof(float);
  return floats + (std::is_same<T, int8_t>::value ? (size_t)(KX + 3 * H) : 0);
}

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
  const size_t smem = smem_bytes<T>(H, KX);
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
      params, smem_bytes<T>(a.H, a.KX), stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Weight dtypes: 0 float32, 1 bfloat16, 2 int8 (with row scales sx, sh).
// Launch the rollout on `stream`; returns a cudaError_t (0 on success).
int zeggs_decoder_rollout(int weights, const void* wx, const void* wh, const void* sx,
                          const void* sh, const void* gbias,
                          const void* bout, const void* stats, const void* cond_l0,
                          const void* cond_g0, const void* gaze, const void* p0,
                          const void* h_init, const void* root0, void* out, void* scratch,
                          int T1, int H, int pose_in, int pose_out, int kx, float dt,
                          void* stream) {
  const Args a{wx, wh, static_cast<const float*>(sx), static_cast<const float*>(sh),
               static_cast<const float*>(gbias), static_cast<const float*>(bout),
               static_cast<const float*>(stats), static_cast<const float*>(cond_l0),
               static_cast<const float*>(cond_g0), static_cast<const float*>(gaze),
               static_cast<const float*>(p0), static_cast<const float*>(h_init),
               static_cast<const float*>(root0), static_cast<float*>(out),
               static_cast<float*>(scratch), T1, H, pose_in, pose_out, kx, dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (weights) {
    case 0: return launch<float>(a, s);
    case 1: return launch<__nv_bfloat16>(a, s);
    case 2: return launch<int8_t>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks per launch on the current device, or a negative cudaError_t.
int zeggs_decoder_rollout_grid(int weights, int H, int kx) {
  switch (weights) {
    case 0: return grid_blocks<float>(H, kx);
    case 1: return grid_blocks<__nv_bfloat16>(H, kx);
    case 2: return grid_blocks<int8_t>(H, kx);
    default: return -(int)cudaErrorInvalidValue;
  }
}

const char* zeggs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
