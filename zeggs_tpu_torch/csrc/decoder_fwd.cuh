// The decoder step's forward math, one row or one element at a time, shared
// by the training rollout's kernels (decoder_train.cu) and the inference
// step's (decoder_step.cu): the quaternion helpers, the pose's
// denormalisation and normalisation, the root integration, the gaze in root
// space, the ELU and PyTorch's GRU gates.
//
// Everything rounds as the plain step's PyTorch operators do, so that a
// kernel built from these gives the plain step's results bit for bit: each
// product is `mul` (__fmul_rn, which the compiler never contracts into a
// fused multiply-add), so each product and sum rounds on its own; the cross
// product follows PyTorch's CUDA kernel (det2); a division by a constant is
// a product with its float32 reciprocal (PyTorch's division by a scalar);
// sinc is torch.sinc's; sums of three or four run left to right.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;  // quat.from_helical's
constexpr float kPi = 3.14159265358979323846f;
constexpr float kInvPi = 1.f / kPi;  // `halfangle / math.pi`: PyTorch multiplies

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// a * b rounded before any sum it feeds (never fused into an FMA)
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};

// a1 b2 - a2 b1 as PyTorch's CUDA cross-product kernel rounds it: the
// second product rounded, the first fused (it matched torch.linalg.cross
// on 1M random products on an H100, and neither other rounding did)
__device__ __forceinline__ float det2(float a1, float b2, float a2, float b1) {
  return fmaf(a1, b2, -mul(a2, b1));
}

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {det2(a.y, b.z, a.z, b.y), det2(a.z, b.x, a.x, b.z), det2(a.x, b.y, a.y, b.x)};
}
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(float s, V3 a) {
  return {mul(s, a.x), mul(s, a.y), mul(s, a.z)};
}
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 vec(Q4 q) { return {q.x, q.y, q.z}; }
__device__ __forceinline__ Q4 inv(Q4 q) { return {q.w, -q.x, -q.y, -q.z}; }
__device__ __forceinline__ V3 load3(const float* p) { return {p[0], p[1], p[2]}; }
__device__ __forceinline__ Q4 load4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ void store3(float* p, V3 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; }
__device__ __forceinline__ void store4(float* p, Q4 q) {
  p[0] = q.w; p[1] = q.x; p[2] = q.y; p[3] = q.z;
}

// quat.mul(x, y)
__device__ __forceinline__ Q4 qmul(Q4 x, Q4 y) {
  return {mul(y.w, x.w) - mul(y.x, x.x) - mul(y.y, x.y) - mul(y.z, x.z),
          mul(y.w, x.x) + mul(y.x, x.w) - mul(y.y, x.z) + mul(y.z, x.y),
          mul(y.w, x.y) + mul(y.x, x.z) + mul(y.y, x.w) - mul(y.z, x.x),
          mul(y.w, x.z) - mul(y.x, x.y) + mul(y.y, x.x) + mul(y.z, x.w)};
}

// quat.mul_vec(q, v): v + w t + u x t, t = 2 u x v
__device__ __forceinline__ V3 mul_vec(Q4 q, V3 v) {
  const V3 u = vec(q);
  const V3 t = scale(2.f, cross(u, v));
  return add(add(v, scale(q.w, t)), cross(u, t));
}

// torch.sinc(a): sin(pi a) / (pi a), 1 at 0
__device__ __forceinline__ float sinc(float a) {
  if (a == 0.f) return 1.f;
  const float p = kPi * a;
  return sinf(p) / p;
}

// quat.exp(x): [cos |x|, x sinc(|x| / pi)], or normalize([1, x], eps) below eps
__device__ __forceinline__ Q4 qexp(V3 x) {
  const float ha = sqrtf(mul(x.x, x.x) + mul(x.y, x.y) + mul(x.z, x.z));
  if (ha < kEps) {
    const float n = sqrtf(1.f + mul(x.x, x.x) + mul(x.y, x.y) + mul(x.z, x.z)) + kEps;
    return {1.f / n, x.x / n, x.y / n, x.z / n};
  }
  const float s = sinc(ha * kInvPi);
  return {cosf(ha), mul(x.x, s), mul(x.y, s), mul(x.z, s)};
}

// ---------------------------------------------------------------------------
// the step's forward, as `models.pose` and `models.layers` compute it

// an output value denormalised: out std_out + mean_out
__device__ __forceinline__ float denormalize(float o, float sd, float mean) {
  return mul(o, sd) + mean;
}

// an input value normalised: (x - mean_in) / std_in
__device__ __forceinline__ float normalize(float x, float mean, float sd) {
  return (x - mean) / sd;
}

// the root over one frame from the denormalised output's first six values
// (velocity, angular velocity): rp' = R(rr) v dt + rp,
// rr' = exp(R(rr) w dt / 2) rr
__device__ __forceinline__ void integrate_root(const float p6[6], V3 rp, Q4 rr, float dt,
                                               V3* rp1, Q4* rr1) {
  const V3 v = {mul(p6[0], dt), mul(p6[1], dt), mul(p6[2], dt)};
  const V3 w = {mul(p6[3], dt), mul(p6[4], dt), mul(p6[5], dt)};
  *rp1 = add(mul_vec(rr, v), rp);
  const V3 e = mul_vec(rr, w);
  *rr1 = qmul(qexp({e.x / 2.f, e.y / 2.f, e.z / 2.f}), rr);
}

// the input's last three values: the gaze rotated into root space,
// R(rr)^-1 (gaze - rp), normalised
__device__ __forceinline__ void gaze_input(V3 gaze, V3 rp, Q4 rr, const float* mean3,
                                           const float* std3, float* dst3) {
  const V3 gd = mul_vec(inv(rr), sub(gaze, rp));
  const float g[3] = {gd.x, gd.y, gd.z};
  for (int k = 0; k < 3; ++k) dst3[k] = normalize(g[k], mean3[k], std3[k]);
}

// F.elu
__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

// Element (b, j) of a GRU layer: gi = (s0 (+ s1)) (+ s2) (rows of 3H),
// PyTorch's gates from gi and gh (the products with their biases, gh
// contiguous) -> h'; r, z, n and gh_n through the pointers
__device__ __forceinline__ float gru_gates(const float* __restrict__ s0, int ld0,
                                           const float* __restrict__ s1, int ld1,
                                           const float* __restrict__ s2, int ld2,
                                           const float* __restrict__ gh, float h, int b, int j,
                                           int H, float* r, float* z, float* n, float* ghn) {
  float gi[3], gg[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int c = k * H + j;
    float v = s0[(size_t)b * ld0 + c];
    if (s1 != nullptr) v += s1[(size_t)b * ld1 + c];
    if (s2 != nullptr) v += s2[(size_t)b * ld2 + c];
    gi[k] = v;
    gg[k] = gh[(size_t)b * 3 * H + c];
  }
  *r = sigmoid(gi[0] + gg[0]);
  *z = sigmoid(gi[1] + gg[1]);
  *n = tanhf(gi[2] + mul(*r, gg[2]));
  *ghn = gg[2];
  return mul(1.f - *z, *n) + mul(*z, h);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

int last_error() { return (int)cudaGetLastError(); }

}  // namespace
