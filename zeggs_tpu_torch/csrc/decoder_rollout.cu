// Whole B=1 autoregressive decoder rollout in one launch, for Hopper (sm_90a).
//
// Replaces zeggs_tpu/ops/pallas/decoder_kernel.py::rollout_fused_b1 (the
// Pallas kernel built in _build_kernel). The plain PyTorch version of the same
// function is rollout_b1_plain in zeggs_tpu_torch/ops/kernels/decoder_rollout.py,
// and that module packs the weights, plans the grid (plan_rollout) and
// documents the shared numerics.
//
// What bounds it on an H100: a step multiplies the whole packed cell, about
// 18.4M weights (18.4 MB in int8, 37 MB in bf16, 74 MB in fp32), by one
// activation row, and its four phases depend on each other: each needs a
// vector that every block of the grid wrote in the phase before. Counted
// once against the data-sheet peaks, the weights' bytes and FLOPs bound a
// 599-step rollout below 0.4 ms; what bounds it in fact is the chain of
// 4 x 599 grid-wide barriers and, for rows that are not resident, L2.
//
// What this design does about that:
//   * one persistent cooperative launch of one 512-thread block per SM runs
//     all T-1 steps; the cooperative launch guarantees that all blocks are
//     resident, which the hand-written grid barrier below relies on;
//   * each block owns a fixed set of packed rows for the whole rollout
//     (plan_rollout: evenly per phase, the r, z, n rows of a GRU unit in
//     one block) and copies as many as fit into its shared memory once, at
//     t = 0 (int8: all; bf16: about 72%; fp32: about 17%). The rest are
//     staged from L2 into a staging area, a phase at a time; the copy for
//     the next phase is issued before the block waits at the barrier, since
//     weights do not depend on it (the Pallas kernel's resident tail and
//     cross-step prefetch, on this card);
//   * the hidden-state products move to the earliest phase whose inputs are
//     complete: W_g0hh round(h0') runs in phase 3 and W_g1hh round(h1') in
//     phase 4, for the next step, so the phases carry 4H, 3H, 6H and
//     PO + 3H rows instead of 10H, 3H, 3H and PO. The block that owns a GRU
//     unit computes all of its products, so they stay in its shared memory;
//     only layer0, h0', h1' and the pose cross blocks;
//   * a warp computes two row products at a time from shared memory (16-byte
//     loads, shuffle reductions); the GRU gates and the denormalisation run
//     in the block's epilogue of the phase, from constants and hidden states
//     the block keeps in shared memory with its copy of its plan's table;
//     what a phase needs that does not depend on the barrier before it (the
//     step's conditioning, the next phase's staged rows) is in flight while
//     the block waits there;
//   * the grid barrier is one arrival counter and a generation word in
//     device memory: a release on arrival, an acquire spin; barrier_floor
//     times it, and cg::this_grid().sync(), with no products;
//   * the root is integrated redundantly by every block from the same inputs
//     (bit-identical), so it needs no barrier of its own.
//
// Three instantiations: float32, bf16 and int8 weights. With int8 weights
// (the quantized branch of the Pallas kernel) each packed row carries one
// float32 scale; each phase's activation vector is quantized with one
// symmetric scale s = max(max|x|, 1e-8) / 127, q = clip(rint(x / s), -127,
// 127); a row's product is an int32 sum of __dp4a over 16-byte loads,
// dequantized as acc * (s_act * s_row). Every block computes the scale
// itself after the barrier it already waits on (a max is exact in any
// order). h0 and h1 are quantized once per step each, as before: the
// products that move to phases 3 and 4 read the same values.
//
// Step t (rows are written for frames 1..T-1; frame 0 is the input state):
//   phase 1  x = round((pose_prev | gaze in root frame) - mean) * rstd)
//            layer0 rows W_l0 x -> device; GRU0 pose rows W_g0x x -> block
//   barrier 1
//   phase 2  hidden = elu(cond_l0[t] + W_l0 x); W_g0h round(hidden);
//            h0' = GRU0 gates (gh from the previous phase 3)      -> h0[next]
//   barrier 2
//   phase 3  W_g1ih round(h0'); h1' = GRU1 gates (gh from the previous
//            phase 4) -> h1[next]; W_g0hh round(h0') for step t + 1
//   barrier 3
//   phase 4  W_g1hh round(h1') for step t + 1;
//            pose = (W_out round(h1') + b) * out_std + out_mean     -> pose[next], out[t]
//   barrier 4
//   root     every block: root_pos += R v dt; root_rot = exp(R w dt / 2) * root_rot
// Before step 0 every block computes W_g0hh and W_g1hh on the initial state.
//
// The carried state lives in device scratch, double-buffered by step parity.
// Values written by other blocks are read after the barrier's acquire with
// __ldcg (L2, never a stale L1 line).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHdr = 12;   // ints of a block's table header (plan_rollout)
constexpr int kMisc = 32;  // floats: root[8], gaze[4], block reductions[kWarps]
static_assert(8 + 4 + kWarps <= kMisc, "misc floats");
constexpr int kEp = 9;     // epilogue arrays of MR floats (see the kernel)
constexpr int kMaxPerThread = 3;  // KX and H up to 3 kThreads

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
  float* scratch;        // 2PO + 5H floats, then the barrier's word (zeroed)
  const int* table;      // (blocks, kHdr + 12 MR) from plan_rollout
  int T1, H, PI, PO, KX, MR, base;
  float dt;
};

// Byte offsets of the shared memory before the weights; plan_rollout's
// fixed_smem_bytes mirrors this.
struct Layout {
  int act, q, dot, scale, ep, tab, misc, end;
};

__host__ __device__ inline Layout layout(int KX, int H, int MR) {
  const int n = ((KX > H ? KX : H) + 15) / 16 * 16;
  Layout L;
  L.act = 0;                  // float[n]  the phase's activation, rounded
  L.q = 4 * n;                // int8[n]   ... quantized (int8 weights)
  L.dot = L.q + n;            // float[4][MR] row products
  L.scale = L.dot + 16 * MR;  // float[4][MR] row scales (int8 weights)
  L.ep = L.scale + 16 * MR;   // float[kEp][MR] the epilogues' constants and state
  L.tab = L.ep + 4 * kEp * MR;        // int[kHdr + 12 MR] the block's table
  L.misc = L.tab + 4 * (kHdr + 12 * MR);
  L.end = L.misc + 4 * kMisc;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned atom_add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// Grid-wide barrier for a grid whose blocks are all resident (cooperative
// launch), on one zeroed word: thread 0 of each block adds 1 with release
// semantics, block 0 adds 2^31 - (blocks - 1) instead, so the word's top bit
// flips once all have arrived; each block spins with acquire loads until it
// sees the flip. The block's writes are ordered before the arrival by
// __syncthreads, and the other blocks' writes before its later reads by the
// acquire and the __syncthreads after it.
__device__ __forceinline__ void grid_barrier(unsigned* word) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    const unsigned old = atom_add_release(word, add);
    // a block that waits seconds means a block is missing: fail the launch
    // with an error instead of holding the card
    unsigned polls = 0;
    while (((ld_acquire(word) ^ old) & 0x80000000u) == 0)
      if (++polls == (1u << 24)) __trap();
  }
  __syncthreads();
}

__device__ __forceinline__ void load8(const float* p, float (&w)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&w)[8]) {
  // eight bf16 in one 16-byte load; element 2i is the low half of word i
  const uint4 u = *reinterpret_cast<const uint4*>(p);
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

// Two rows of length K (a multiple of 8) in shared memory against the
// shared-memory activation, in one pass so that their loads overlap; every
// lane of the warp gets both sums.
template <typename T>
__device__ __forceinline__ void row_dot2(const T* w0, const T* w1, const float* act, int K,
                                         float& d0, float& d1) {
  const int lane = threadIdx.x & 31;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll 2
  for (int k = lane * 8; k < K; k += 256) {
    float u[8], v[8];
    load8(w0 + k, u);
    load8(w1 + k, v);
    const float4 a0 = *reinterpret_cast<const float4*>(act + k);
    const float4 a1 = *reinterpret_cast<const float4*>(act + k + 4);
    s0 = fmaf(u[0], a0.x, s0); s0 = fmaf(u[1], a0.y, s0);
    s0 = fmaf(u[2], a0.z, s0); s0 = fmaf(u[3], a0.w, s0);
    s0 = fmaf(u[4], a1.x, s0); s0 = fmaf(u[5], a1.y, s0);
    s0 = fmaf(u[6], a1.z, s0); s0 = fmaf(u[7], a1.w, s0);
    s1 = fmaf(v[0], a0.x, s1); s1 = fmaf(v[1], a0.y, s1);
    s1 = fmaf(v[2], a0.z, s1); s1 = fmaf(v[3], a0.w, s1);
    s1 = fmaf(v[4], a1.x, s1); s1 = fmaf(v[5], a1.y, s1);
    s1 = fmaf(v[6], a1.z, s1); s1 = fmaf(v[7], a1.w, s1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  d0 = s0;
  d1 = s1;
}

// Two int8 rows of length K (a multiple of 16) against the int8 activation,
// in int32: 16 bytes a lane and four __dp4a per load.
__device__ __forceinline__ void row_dot2_i8(const int8_t* w0, const int8_t* w1, const int8_t* q,
                                            int K, int& d0, int& d1) {
  const int lane = threadIdx.x & 31;
  int s0 = 0, s1 = 0;
#pragma unroll 2
  for (int k = lane * 16; k < K; k += 512) {
    const int4 u = *reinterpret_cast<const int4*>(w0 + k);
    const int4 v = *reinterpret_cast<const int4*>(w1 + k);
    const int4 a = *reinterpret_cast<const int4*>(q + k);
    s0 = __dp4a(u.x, a.x, s0); s0 = __dp4a(u.y, a.y, s0);
    s0 = __dp4a(u.z, a.z, s0); s0 = __dp4a(u.w, a.w, s0);
    s1 = __dp4a(v.x, a.x, s1); s1 = __dp4a(v.y, a.y, s1);
    s1 = __dp4a(v.z, a.z, s1); s1 = __dp4a(v.w, a.w, s1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  d0 = s0;
  d1 = s1;
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

// Quantize the n float values `v` (this thread's own entries, max|v| = m
// over the block) into `q`; returns the scale. The caller synchronises
// before `q` is read.
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

// A block's rows of one phase, as plan_rollout lays them out, from the
// block's table in shared memory.
struct PhaseRows {
  const int* glob;    // packed row index
  const int* off;     // byte offset in shared memory
  const int* stream;  // indices of the rows staged every step
  int n, ns, K;
};

__device__ __forceinline__ PhaseRows phase_rows(const int* tab, int p, int MR, int KX, int H) {
  const int* g = tab + kHdr + 3 * MR * p;
  return {g, g + MR, g + 2 * MR, tab[p], tab[4 + p], p == 0 ? KX : H};
}

// Copy rows of a phase into shared memory with cp.async and commit: the
// staged rows (every step), or the resident ones (once).
template <typename T, bool kStaged>
__device__ __forceinline__ void copy_rows(const PhaseRows& pr, const void* w, unsigned char* smem,
                                          int res_end) {
  const int cpr = pr.K * (int)sizeof(T) / 16;  // 16-byte chunks of a row
  const unsigned char* src = static_cast<const unsigned char*>(w);
  const int rows = kStaged ? pr.ns : pr.n;
  for (int c = threadIdx.x; c < rows * cpr; c += kThreads) {
    const int r = c / cpr, ch = c - r * cpr;
    const int i = kStaged ? pr.stream[r] : r;
    const int off = pr.off[i];
    if (!kStaged && off >= res_end) continue;
    cp_async16(smem + off + 16 * ch, src + ((size_t)pr.glob[i] * cpr + ch) * 16);
  }
  cp_async_commit();
}

// Every row product of a phase into dot[], two rows a warp at a time.
template <typename T>
__device__ __forceinline__ void phase_dots(const PhaseRows& pr, const unsigned char* smem,
                                           const float* act, const int8_t* q, float act_s,
                                           const float* scale, float* dot) {
  const int warp = threadIdx.x >> 5;
  for (int i = warp; i < pr.n; i += 2 * kWarps) {
    const int i1 = i + kWarps < pr.n ? i + kWarps : i;  // an odd last row is done twice
    const T* w0 = reinterpret_cast<const T*>(smem + pr.off[i]);
    const T* w1 = reinterpret_cast<const T*>(smem + pr.off[i1]);
    float d0, d1;
    if constexpr (std::is_same<T, int8_t>::value) {
      int a0, a1;
      row_dot2_i8(w0, w1, q, pr.K, a0, a1);
      d0 = (float)a0 * (act_s * scale[i]);
      d1 = (float)a1 * (act_s * scale[i1]);
    } else {
      row_dot2<T>(w0, w1, act, pr.K, d0, d1);
    }
    if ((threadIdx.x & 31) == 0) {
      dot[i] = d0;
      dot[i1] = d1;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) decoder_rollout_kernel(const Args a) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];

  const int H = a.H, G = 3 * H, PI = a.PI, PO = a.PO, KX = a.KX, MR = a.MR;
  const int tid = threadIdx.x;
  const Layout L = layout(KX, H, MR);
  float* s_act = reinterpret_cast<float*>(smem + L.act);
  int8_t* q_act = reinterpret_cast<int8_t*>(smem + L.q);
  float* s_dot = reinterpret_cast<float*>(smem + L.dot);      // [4][MR]
  float* s_scale = reinterpret_cast<float*>(smem + L.scale);  // [4][MR]
  float* s_ep = reinterpret_cast<float*>(smem + L.ep);        // [kEp][MR]:
  float* s_bhh0 = s_ep;            // GRU0 unit i: b_hh r, z, n at 3i + g
  float* s_cg0 = s_ep + MR;        //   the step's cond_g0, 3i + g
  float* s_h0 = s_ep + 2 * MR;     //   its hidden state, i
  float* s_bih1 = s_ep + 3 * MR;   // GRU1 unit i: b_ih, 3i + g
  float* s_bhh1 = s_ep + 4 * MR;   //   b_hh, 3i + g
  float* s_h1 = s_ep + 5 * MR;     //   its hidden state, i
  float* s_bout = s_ep + 6 * MR;   // output row i: bias, out_std, out_mean
  float* s_ostd = s_ep + 7 * MR;
  float* s_omean = s_ep + 8 * MR;
  int* tab = reinterpret_cast<int*>(smem + L.tab);
  float* s_root = reinterpret_cast<float*>(smem + L.misc);  // [8] root_pos | root_rot
  float* s_gd = s_root + 8;                                   // [4] gaze in the root frame
  float* s_red = s_gd + 4;                                    // [kWarps] block reductions

  const int* gtab = a.table + (size_t)blockIdx.x * (kHdr + 12 * MR);
  for (int i = tid; i < kHdr + 12 * MR; i += kThreads) tab[i] = __ldg(gtab + i);
  __syncthreads();
  const int n0 = tab[8], n1 = tab[9], res_end = tab[10];
  const int nout = tab[3] - 3 * n1;
  // a phase's rows, read from the table where they are used (after a
  // __syncthreads the compiler reloads them instead of holding registers)
  auto rows = [&](int p) { return phase_rows(tab, p, MR, KX, H); };

  const float* in_mean = a.stats;
  const float* in_rstd = a.stats + PI;
  const float* out_std = a.stats + 2 * PI;
  const float* out_mean = a.stats + 3 * PI;

  float* pose_buf = a.scratch;        // [2][PO]
  float* h0_buf = pose_buf + 2 * PO;  // [2][H]
  float* h1_buf = h0_buf + 2 * H;     // [2][H]
  float* l0_buf = h1_buf + 2 * H;     // [H] layer0 products
  unsigned* sync = reinterpret_cast<unsigned*>(l0_buf + H);

  // quantize the block's activation s_act[0, n) (int8 weights; m is this
  // thread's max |value|); returns the scale, 1 for float weights
  auto finish_act = [&](int n, float m) -> float {
    if constexpr (kInt8) return quantize(s_act, q_act, n, block_max(m, s_red));
    return 1.f;
  };
  // round (or quantize) the n values v(k) into the block's activation
  auto set_act = [&](int n, auto v) -> float {
    float m = 0.f;
    for (int k = tid; k < n; k += kThreads) {
      const float x = v(k);
      s_act[k] = round_act<T>(x);
      m = fmaxf(m, fabsf(x));
    }
    return finish_act(n, m);
  };
  // a phase's products, once its staged rows and its activation are complete
  auto run_phase = [&](const PhaseRows& pr, int p, float act_s) {
    cp_async_wait_all();
    __syncthreads();
    phase_dots<T>(pr, smem, s_act, q_act, act_s, s_scale + p * MR, s_dot + p * MR);
    __syncthreads();  // the products are complete; the staging area is free
  };
  // the root after a step's output row `pose` (every block, thread 0); block
  // 0 writes it into that row
  auto integrate_root = [&](const float* pose, float* out_row) {
    float v[3], w[3], wv[3], ww[3], dq[4], rq[4];
    for (int i = 0; i < 3; ++i) {
      v[i] = __ldcg(pose + i) * a.dt;
      w[i] = __ldcg(pose + 3 + i) * a.dt;
    }
    for (int i = 0; i < 4; ++i) rq[i] = s_root[3 + i];
    quat_mul_vec(rq, v, wv);
    quat_mul_vec(rq, w, ww);
    quat_from_helical(ww, dq);
    for (int i = 0; i < 3; ++i) s_root[i] += wv[i];
    quat_mul(dq, rq, s_root + 3);
    if (blockIdx.x == 0)
      for (int i = 0; i < 7; ++i) out_row[PO + i] = s_root[i];
  };

  // ---- once: resident rows, constants, the products on the initial state
  copy_rows<T, false>(rows(0), a.wx, smem, res_end);
  copy_rows<T, false>(rows(1), a.wh, smem, res_end);
  copy_rows<T, false>(rows(2), a.wh, smem, res_end);
  copy_rows<T, false>(rows(3), a.wh, smem, res_end);
  if constexpr (kInt8) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const PhaseRows pr = rows(p);
      for (int i = tid; i < pr.n; i += kThreads)
        s_scale[p * MR + i] = __ldg((p == 0 ? a.sx : a.sh) + pr.glob[i]);
    }
  }
  for (int e = tid; e < 3 * n0; e += kThreads) {
    const int j = rows(1).glob[e - e % 3], g = e % 3;  // the unit's r row is 0 H + j
    s_bhh0[e] = __ldg(a.gbias + g * H + j);
    if (g == 0) s_h0[e / 3] = __ldg(a.h_init + j);
  }
  for (int e = tid; e < 3 * n1; e += kThreads) {
    const int j = rows(2).glob[e - e % 3] - 2 * G, g = e % 3;  // the unit's r row is 2G + j
    s_bih1[e] = __ldg(a.gbias + G + g * H + j);
    s_bhh1[e] = __ldg(a.gbias + 2 * G + g * H + j);
    if (g == 0) s_h1[e / 3] = __ldg(a.h_init + H + j);
  }
  for (int i = tid; i < nout; i += kThreads) {
    const int c = rows(3).glob[3 * n1 + i] - 4 * G;
    s_bout[i] = __ldg(a.bout + c);
    s_ostd[i] = __ldg(out_std + c);
    s_omean[i] = __ldg(out_mean + c);
  }
  if (tid < 7) s_root[tid] = a.root0[tid];
  copy_rows<T, true>(rows(2), a.wh, smem, res_end);
  run_phase(rows(2), 2, set_act(H, [&](int k) { return __ldg(a.h_init + k); }));
  copy_rows<T, true>(rows(3), a.wh, smem, res_end);
  run_phase(rows(3), 3, set_act(H, [&](int k) { return __ldg(a.h_init + H + k); }));
  copy_rows<T, true>(rows(0), a.wx, smem, res_end);

  for (int t = 0; t < a.T1; ++t) {
    const int cur = t & 1, nxt = cur ^ 1;
    const float* pose_c = t == 0 ? a.p0 : pose_buf + cur * PO;
    float* pose_n = pose_buf + nxt * PO;
    float* h0_n = h0_buf + nxt * H;
    float* h1_n = h1_buf + nxt * H;
    float* out_row = a.out + (size_t)t * (PO + 7);

    // ---- phase 1: the step's input; layer0 and GRU0's pose products -----
    // this thread's pose values load while thread 0 integrates the root of
    // the previous row and rotates the gaze into the root frame
    float xv[kMaxPerThread];
#pragma unroll
    for (int r = 0; r < kMaxPerThread; ++r) {
      const int k = tid + r * kThreads;
      xv[r] = k < PO ? __ldcg(pose_c + k) : 0.f;
    }
    if (tid == 0) {
      if (t > 0) integrate_root(pose_c, out_row - (PO + 7));
      const float gz[3] = {a.gaze[3 * t] - s_root[0], a.gaze[3 * t + 1] - s_root[1],
                           a.gaze[3 * t + 2] - s_root[2]};
      const float q_inv[4] = {s_root[3], -s_root[4], -s_root[5], -s_root[6]};
      quat_mul_vec(q_inv, gz, s_gd);
    }
    __syncthreads();
    float m = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxPerThread; ++r) {
      const int k = tid + r * kThreads;
      if (k < KX) {
        float v = 0.f;
        if (k < PO) v = (xv[r] - in_mean[k]) * in_rstd[k];
        else if (k < PI) v = (s_gd[k - PO] - in_mean[k]) * in_rstd[k];
        s_act[k] = round_act<T>(v);
        m = fmaxf(m, fabsf(v));
      }
    }
    run_phase(rows(0), 0, finish_act(KX, m));
    copy_rows<T, true>(rows(1), a.wh, smem, res_end);
    for (int i = 3 * n0 + tid; i < rows(0).n; i += kThreads)
      __stcg(l0_buf + rows(0).glob[i], s_dot[i]);
    // what phase 2 needs that does not depend on the barrier: the loads are
    // in flight while the block waits at it
    float cl[kMaxPerThread];
#pragma unroll
    for (int r = 0; r < kMaxPerThread; ++r) {
      const int k = tid + r * kThreads;
      cl[r] = k < H ? __ldg(a.cond_l0 + (size_t)t * H + k) : 0.f;
    }
    const float cg = tid < 3 * n0 ? __ldg(a.cond_g0 + (size_t)t * G + (tid % 3) * H +
                                          rows(1).glob[tid - tid % 3])
                                  : 0.f;
    grid_barrier(sync);  // 1: layer0 is complete

    // ---- phase 2: ELU, GRU0 ----------------------------------------------
    if (tid < 3 * n0) s_cg0[tid] = cg;
    m = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxPerThread; ++r) {
      const int k = tid + r * kThreads;
      if (k < H) {
        const float pre = cl[r] + __ldcg(l0_buf + k);
        const float hid = pre > 0.f ? pre : expf(pre) - 1.f;
        s_act[k] = round_act<T>(hid);
        m = fmaxf(m, fabsf(hid));
      }
    }
    run_phase(rows(1), 1, finish_act(H, m));
    copy_rows<T, true>(rows(2), a.wh, smem, res_end);
    for (int i = tid; i < n0; i += kThreads) {
      const float* dx = s_dot + 3 * i;                    // W_g0x x
      const float* dh = s_dot + MR + 3 * i;               // W_g0h round(hidden)
      const float* dg = s_dot + 2 * MR + 3 * n1 + 3 * i;  // W_g0hh round(h0)
      const float* cg0 = s_cg0 + 3 * i;
      const float* bh = s_bhh0 + 3 * i;
      const float h = gru_blend((cg0[0] + dx[0]) + dh[0], (cg0[1] + dx[1]) + dh[1],
                                (cg0[2] + dx[2]) + dh[2], dg[0] + bh[0], dg[1] + bh[1],
                                dg[2] + bh[2], s_h0[i]);
      s_h0[i] = h;
      __stcg(h0_n + rows(1).glob[3 * i], h);
    }
    grid_barrier(sync);  // 2: the new GRU0 state is complete

    // ---- phase 3: GRU1; W_g0hh round(h0') for the next step ---------------
    run_phase(rows(2), 2, set_act(H, [&](int k) { return __ldcg(h0_n + k); }));
    copy_rows<T, true>(rows(3), a.wh, smem, res_end);
    for (int i = tid; i < n1; i += kThreads) {
      const float* di = s_dot + 2 * MR + 3 * i;  // W_g1ih round(h0')
      const float* dg = s_dot + 3 * MR + 3 * i;  // W_g1hh round(h1)
      const float* bi = s_bih1 + 3 * i;
      const float* bh = s_bhh1 + 3 * i;
      const float h = gru_blend(di[0] + bi[0], di[1] + bi[1], di[2] + bi[2], dg[0] + bh[0],
                                dg[1] + bh[1], dg[2] + bh[2], s_h1[i]);
      s_h1[i] = h;
      __stcg(h1_n + rows(2).glob[3 * i] - 2 * G, h);
    }
    grid_barrier(sync);  // 3: the new GRU1 state is complete

    // ---- phase 4: W_g1hh round(h1') for the next step; output, denormalise
    run_phase(rows(3), 3, set_act(H, [&](int k) { return __ldcg(h1_n + k); }));
    if (t + 1 < a.T1) copy_rows<T, true>(rows(0), a.wx, smem, res_end);
    for (int i = tid; i < nout; i += kThreads) {
      const int r = 3 * n1 + i;
      const float p = (s_dot[3 * MR + r] + s_bout[i]) * s_ostd[i] + s_omean[i];
      const int c = rows(3).glob[r] - 4 * G;
      __stcg(pose_n + c, p);
      out_row[c] = p;
    }
    grid_barrier(sync);  // 4: the output row, with its root velocities, is complete
  }
  // the last row's root
  if (tid == 0 && a.T1 > 0)
    integrate_root(pose_buf + (a.T1 & 1) * PO, a.out + (size_t)(a.T1 - 1) * (PO + 7));
}

// kBarrier 0: grid_barrier; 1: cg::this_grid().sync(). `n` barriers, no work.
template <int kBarrier>
__global__ void __launch_bounds__(kThreads, 1) barrier_floor_kernel(unsigned* sync, int n) {
  for (int i = 0; i < n; ++i) {
    if constexpr (kBarrier == 0) grid_barrier(sync);
    else cg::this_grid().sync();
  }
}

// Blocks of a cooperative launch of `kernel` with `smem` bytes, one per SM
// (all resident at once), or a negative cudaError_t.
int grid_blocks(const void* kernel, int smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return -(int)cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -(int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm != 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return sms;
}

template <typename T>
const void* rollout_kernel() {
  return reinterpret_cast<const void*>(decoder_rollout_kernel<T>);
}

template <typename T>
int launch(const Args& a, int blocks, int smem, cudaStream_t stream) {
  if (a.T1 <= 0) return (int)cudaSuccess;
  if (layout(a.KX, a.H, a.MR).end > a.base || a.base > smem || a.KX > kMaxPerThread * kThreads ||
      a.H > kMaxPerThread * kThreads || a.MR > kThreads)
    return (int)cudaErrorInvalidValue;
  const int n = grid_blocks(rollout_kernel<T>(), smem);
  if (n < 0) return -n;
  if (n != blocks) return (int)cudaErrorInvalidConfiguration;  // the plan is for another grid
  void* params[] = {const_cast<Args*>(&a)};
  cudaError_t err = cudaLaunchCooperativeKernel(rollout_kernel<T>(), dim3(blocks),
                                                dim3(kThreads), params, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const void* kernel_of(int weights) {
  switch (weights) {
    case 0: return rollout_kernel<float>();
    case 1: return rollout_kernel<__nv_bfloat16>();
    case 2: return rollout_kernel<int8_t>();
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Weight dtypes: 0 float32, 1 bfloat16, 2 int8 (with row scales sx, sh).
// Launch the rollout on `stream` with the plan's table on `blocks` blocks of
// `smem` bytes; returns a cudaError_t (0 on success). `scratch` holds
// 2PO + 5H floats and the barrier's zeroed word.
int zeggs_decoder_rollout(int weights, const void* wx, const void* wh, const void* sx,
                          const void* sh, const void* gbias, const void* bout, const void* stats,
                          const void* cond_l0, const void* cond_g0, const void* gaze,
                          const void* p0, const void* h_init, const void* root0, void* out,
                          void* scratch, const void* table, int T1, int H, int pose_in,
                          int pose_out, int kx, int mr, int base, int blocks, int smem, float dt,
                          void* stream) {
  const Args a{wx, wh, static_cast<const float*>(sx), static_cast<const float*>(sh),
               static_cast<const float*>(gbias), static_cast<const float*>(bout),
               static_cast<const float*>(stats), static_cast<const float*>(cond_l0),
               static_cast<const float*>(cond_g0), static_cast<const float*>(gaze),
               static_cast<const float*>(p0), static_cast<const float*>(h_init),
               static_cast<const float*>(root0), static_cast<float*>(out),
               static_cast<float*>(scratch), static_cast<const int*>(table),
               T1, H, pose_in, pose_out, kx, mr, base, dt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (weights) {
    case 0: return launch<float>(a, blocks, smem, s);
    case 1: return launch<__nv_bfloat16>(a, blocks, smem, s);
    case 2: return launch<int8_t>(a, blocks, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the rollout's launch with `smem` bytes a block on the current
// device (one per SM), or a negative cudaError_t.
int zeggs_decoder_rollout_grid(int weights, int smem) {
  const void* k = kernel_of(weights);
  return k ? grid_blocks(k, smem) : -(int)cudaErrorInvalidValue;
}

// Shared memory a block may opt into on the current device, or a negative
// cudaError_t.
int zeggs_decoder_smem_optin(void) {
  int dev = 0, v = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? v : -(int)err;
}

// `steps` x 4 grid barriers and nothing else, on the rollout's grid:
// barrier 0 is the kernel's own, 1 cg::this_grid().sync(). `sync` is a
// zeroed word.
int zeggs_decoder_barrier_floor(int barrier, void* sync, int steps, int smem, void* stream) {
  const void* k = barrier == 0 ? reinterpret_cast<const void*>(barrier_floor_kernel<0>)
                               : reinterpret_cast<const void*>(barrier_floor_kernel<1>);
  const int blocks = grid_blocks(k, smem);
  if (blocks < 0) return -blocks;
  unsigned* s = static_cast<unsigned*>(sync);
  int n = 4 * steps;
  void* params[] = {&s, &n};
  cudaError_t err = cudaLaunchCooperativeKernel(k, dim3(blocks), dim3(kThreads), params, smem,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* zeggs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
