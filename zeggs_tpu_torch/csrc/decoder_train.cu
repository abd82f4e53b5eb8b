// The step kernels of the decoder's training rollout, forward and backward,
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the training rollout as a
// lax.scan and leaves its backward to XLA, which fuses each frame's
// element-wise work. Added because on the H100 autograd through the plain
// step ran ~440 launches a frame (slices, fills, copies and one add per
// weight per frame), ~113k of the fp32 train step's ~120k kernels. The
// Python side is zeggs_tpu_torch/ops/kernels/decoder_train.py: the autograd
// Function that runs these kernels between cuBLAS products, and the plain
// PyTorch version of each kernel (PlainOps), which the CPU takes.
//
//   pose_fwd  p = out std_out + mean_out; root integration
//             rp' = R(rr) v dt + rp, rr' = exp(R(rr) w dt / 2) rr (eps 1e-5);
//             the next input ([p | R(rr')^-1 (gaze - rp')] - mean_in) / std_in
//   elu_fwd   hid = elu(pre_l0 + pose W0^T), keeping the pre-activation
//   gru_fwd   PyTorch's GRU gates from the products (biases inside them,
//             b_in and b_hn apart); keeps r, z, n and W_hn h + b_hn
//   gru_bwd, elu_bwd, pose_bwd   their backward, one frame at a time
//
// What bounds the rollout on an H100 (v1 widths: H = 1024, pose 1134 in and
// 1131 out, B = 32, 255 frames): every frame reads the step's seven weights,
// 18.4 M floats (73.6 MB, more than the 50 MB L2), once for the forward
// products and once for the input-gradient products: 44 us a frame at 3.35
// TB/s, 11.2 ms a window. The weight gradients are 2 x 8,160 x 18.4 M = 300
// GFLOP, 4.5 ms at the 67 TFLOP/s float32 peak. These kernels move only the
// B rows of a frame (under 1 MB): each is a launch, and the launches are
// what they cost.
//
// What the design does about that: the products stay cuBLAS products of
// the whole batch (memory-bound at B = 32, each weight read once a frame);
// everything between two products is one kernel, so a frame runs 4 kernels
// and 7 products forward (the plain step's own products) and 4 kernels and
// 6 products backward; the weight gradients leave the loop as one product
// each over all B x T rows, from the (T, B, ...) buffers these kernels
// write, so no weight gradient is read or written a frame.
// Everything is float32, with the plain step's operations in its order.
// The forward's math is decoder_fwd.cuh's, which the inference step's
// kernels (decoder_step.cu) share: it rounds as the plain step does, so the
// forward gives the same trajectories bit for bit. The backward's own
// arithmetic may contract: it differs from autograd's in the order of its
// sums all the same.

#include "decoder_fwd.cuh"

namespace {

// (dx, dy) of qmul under g
__device__ __forceinline__ void qmul_bwd(Q4 x, Q4 y, Q4 g, Q4* dx, Q4* dy) {
  *dx = {g.w * y.w + g.x * y.x + g.y * y.y + g.z * y.z,
         -g.w * y.x + g.x * y.w - g.y * y.z + g.z * y.y,
         -g.w * y.y + g.x * y.z + g.y * y.w - g.z * y.x,
         -g.w * y.z - g.x * y.y + g.y * y.x + g.z * y.w};
  *dy = {g.w * x.w + g.x * x.x + g.y * x.y + g.z * x.z,
         -g.w * x.x + g.x * x.w + g.y * x.z - g.z * x.y,
         -g.w * x.y - g.x * x.z + g.y * x.w + g.z * x.x,
         -g.w * x.z + g.x * x.y - g.y * x.x + g.z * x.w};
}

// (dq, dv) of mul_vec under g
__device__ __forceinline__ void mul_vec_bwd(Q4 q, V3 v, V3 g, Q4* dq, V3* dv) {
  const V3 u = vec(q);
  const V3 t = scale(2.f, cross(u, v));
  const V3 dt = add(scale(q.w, g), cross(g, u));
  const V3 du = add(cross(t, g), scale(2.f, cross(v, dt)));
  *dq = {dot(g, t), du.x, du.y, du.z};
  *dv = add(g, scale(2.f, cross(dt, u)));
}

// dx of qexp under g
__device__ __forceinline__ V3 qexp_bwd(V3 x, Q4 g) {
  const float ha = sqrtf(x.x * x.x + x.y * x.y + x.z * x.z);
  const V3 gv = vec(g);
  if (ha < kEps) {
    const float norm = sqrtf(1.f + x.x * x.x + x.y * x.y + x.z * x.z);
    const float n = norm + kEps;
    const float gc = g.w + dot(gv, x);
    const float k = gc / (n * n * norm);
    return {g.x / n - x.x * k, g.y / n - x.y * k, g.z / n - x.z * k};
  }
  const float s = sinf(ha), c = cosf(ha);
  const float dha = -s * g.w + dot(gv, x) * (ha * c - s) / (ha * ha);
  return add(scale(sinc(ha * kInvPi), gv), scale(dha / ha, x));
}

// ---------------------------------------------------------------------------
// forward

// One block a row. With `out`: p from the last frame's product into p_dst
// and the root integrated from (rp_prev, rr_prev) into (rp_dst, rr_dst);
// without: the state is (x0, rp_prev, rr_prev). With `pose`: the next input.
__global__ void __launch_bounds__(kThreads)
pose_fwd_kernel(const float* __restrict__ out,
                const float* __restrict__ mean_out, const float* __restrict__ std_out,
                const float* __restrict__ x0, const float* __restrict__ rp_prev, int rp_prev_ld,
                const float* __restrict__ rr_prev, int rr_prev_ld, float* __restrict__ p_dst,
                int p_ld, float* __restrict__ rp_dst, int rp_ld, float* __restrict__ rr_dst,
                int rr_ld, const float* __restrict__ gaze, int gaze_ld,
                const float* __restrict__ mean_in, const float* __restrict__ std_in,
                float* __restrict__ pose, int D, float dt) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Din = D + 3;
  __shared__ float root[7];  // this frame's rp, rr
  if (out != nullptr) {
    const float* o = out + (size_t)b * D;
    for (int j = tid; j < D; j += kThreads) {
      const float p = denormalize(o[j], std_out[j], mean_out[j]);
      p_dst[(size_t)b * p_ld + j] = p;
      if (pose != nullptr) pose[(size_t)b * Din + j] = normalize(p, mean_in[j], std_in[j]);
    }
    if (tid == 0) {
      float p6[6];
      for (int j = 0; j < 6; ++j) p6[j] = denormalize(o[j], std_out[j], mean_out[j]);
      V3 rp1;
      Q4 rr1;
      integrate_root(p6, load3(rp_prev + (size_t)b * rp_prev_ld),
                     load4(rr_prev + (size_t)b * rr_prev_ld), dt, &rp1, &rr1);
      store3(rp_dst + (size_t)b * rp_ld, rp1);
      store4(rr_dst + (size_t)b * rr_ld, rr1);
      store3(root, rp1);
      store4(root + 3, rr1);
    }
  } else {
    if (pose != nullptr)
      for (int j = tid; j < D; j += kThreads)
        pose[(size_t)b * Din + j] = normalize(x0[(size_t)b * D + j], mean_in[j], std_in[j]);
    if (tid == 0) {
      store3(root, load3(rp_prev + (size_t)b * rp_prev_ld));
      store4(root + 3, load4(rr_prev + (size_t)b * rr_prev_ld));
    }
  }
  if (pose == nullptr) return;
  __syncthreads();
  if (tid == 0)
    gaze_input(load3(gaze + (size_t)b * gaze_ld), load3(root), load4(root + 3), mean_in + D,
               std_in + D, pose + (size_t)b * Din + D);
}

// act = pre + a, hid = elu(act), one thread an element
__global__ void elu_fwd_kernel(const float* __restrict__ pre, int pre_ld,
                               const float* __restrict__ a, int a_ld, float* __restrict__ act,
                               float* __restrict__ hid, int B, int H) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  const float x = pre[(size_t)b * pre_ld + j] + a[(size_t)b * a_ld + j];
  act[i] = x;
  hid[i] = elu(x);
}

// gi = (s0 (+ s1)) (+ s2); h' and [r | z | n | gh_n] from gi and gh
__global__ void gru_fwd_kernel(const float* __restrict__ s0, int ld0,
                               const float* __restrict__ s1, int ld1,
                               const float* __restrict__ s2, int ld2,
                               const float* __restrict__ gh, const float* __restrict__ h,
                               int h_ld, float* __restrict__ h_new, float* __restrict__ gates,
                               int B, int H) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  float r, z, n, ghn;
  h_new[i] = gru_gates(s0, ld0, s1, ld1, s2, ld2, gh, h[(size_t)b * h_ld + j], b, j, H, &r, &z,
                       &n, &ghn);
  float* gt = gates + (size_t)b * 4 * H + j;
  gt[0] = r;
  gt[H] = z;
  gt[2 * H] = n;
  gt[3 * H] = ghn;
}

// ---------------------------------------------------------------------------
// backward

// From dh' (dh, replaced by z dh'): dgi = [dr, dz, dn], dgh = [dr, dz, dn r]
__global__ void gru_bwd_kernel(float* __restrict__ dh, const float* __restrict__ gates,
                               const float* __restrict__ h, float* __restrict__ dgi, int dgi_ld,
                               float* __restrict__ dgh, int dgh_ld, int B, int H) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  const float* gt = gates + (size_t)b * 4 * H + j;
  const float r = gt[0], z = gt[H], n = gt[2 * H], ghn = gt[3 * H];
  const float d = dh[i];
  const float dnp = d * (1.f - z) * (1.f - n * n);
  const float dzp = d * (h[i] - n) * (1.f - z) * z;
  const float drp = dnp * ghn * (1.f - r) * r;
  float* gi = dgi + (size_t)b * dgi_ld + j;
  float* gg = dgh + (size_t)b * dgh_ld + j;
  gi[0] = drp;
  gi[H] = dzp;
  gi[2 * H] = dnp;
  gg[0] = drp;
  gg[H] = dzp;
  gg[2 * H] = dnp * r;
  dh[i] = d * z;
}

// da = dhid elu'(act): 1 above 0, else exp(act)
__global__ void elu_bwd_kernel(const float* __restrict__ dhid, const float* __restrict__ act,
                               float* __restrict__ da, int da_ld, int B, int H) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  const float x = act[i];
  da[(size_t)b * da_ld + j] = x > 0.f ? dhid[i] : dhid[i] * expf(x);
}

// The backward of pose_fwd at one frame boundary, one block a row (see
// PlainOps.pose_bwd). g_rp, g_rr: this frame's root state's gradient from
// the later frames, in; the last frame's (or the carry's), out.
__global__ void __launch_bounds__(kThreads)
pose_bwd_kernel(const float* __restrict__ dpose, const float* __restrict__ std_in,
                const float* __restrict__ gaze, int gaze_ld, const float* __restrict__ rp,
                int rp_ld, const float* __restrict__ rr, int rr_ld, float* __restrict__ dgaze,
                int dgaze_ld, const float* __restrict__ dp_up, int dp_ld,
                const float* __restrict__ drp_up, int drp_ld, const float* __restrict__ drr_up,
                int drr_ld, const float* __restrict__ p_prev, int p_ld,
                const float* __restrict__ rr_prev, int rr_prev_ld,
                const float* __restrict__ std_out, float* __restrict__ dout,
                float* __restrict__ g_rp, float* __restrict__ g_rr, float* __restrict__ dx0,
                int D, float dt) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int Din = D + 3;
  __shared__ float dp6[6];  // the integration's gradient of p[0:6]
  if (tid == 0) {
    V3 grp = load3(g_rp + (size_t)b * 3);
    Q4 grr = load4(g_rr + (size_t)b * 4);
    if (dpose != nullptr) {
      const float* dq = dpose + (size_t)b * Din + D;
      const V3 dgd = {dq[0] / std_in[D], dq[1] / std_in[D + 1], dq[2] / std_in[D + 2]};
      const Q4 q = load4(rr + (size_t)b * rr_ld);
      const V3 a = sub(load3(gaze + (size_t)b * gaze_ld), load3(rp + (size_t)b * rp_ld));
      Q4 dqi;
      V3 da;
      mul_vec_bwd(inv(q), a, dgd, &dqi, &da);
      grr = {grr.w + dqi.w, grr.x - dqi.x, grr.y - dqi.y, grr.z - dqi.z};
      grp = sub(grp, da);
      store3(dgaze + (size_t)b * dgaze_ld, da);
    }
    if (p_prev == nullptr) {
      store3(g_rp + (size_t)b * 3, grp);
      store4(g_rr + (size_t)b * 4, grr);
    } else {
      grp = add(grp, load3(drp_up + (size_t)b * drp_ld));
      const Q4 u = load4(drr_up + (size_t)b * drr_ld);
      grr = {grr.w + u.w, grr.x + u.x, grr.y + u.y, grr.z + u.z};
      const float* p = p_prev + (size_t)b * p_ld;
      const V3 v = {p[0] * dt, p[1] * dt, p[2] * dt};
      const V3 w = {p[3] * dt, p[4] * dt, p[5] * dt};
      const Q4 q0 = load4(rr_prev + (size_t)b * rr_prev_ld);
      const V3 e = mul_vec(q0, w);
      const V3 eh = {e.x / 2.f, e.y / 2.f, e.z / 2.f};
      Q4 dq, drr_a, drr_b, drr_c;
      qmul_bwd(qexp(eh), q0, grr, &dq, &drr_a);
      const V3 de = scale(0.5f, qexp_bwd(eh, dq));
      V3 dw, dv;
      mul_vec_bwd(q0, w, de, &drr_b, &dw);
      mul_vec_bwd(q0, v, grp, &drr_c, &dv);
      dp6[0] = dv.x * dt;
      dp6[1] = dv.y * dt;
      dp6[2] = dv.z * dt;
      dp6[3] = dw.x * dt;
      dp6[4] = dw.y * dt;
      dp6[5] = dw.z * dt;
      store3(g_rp + (size_t)b * 3, grp);
      store4(g_rr + (size_t)b * 4,
             {drr_a.w + drr_b.w + drr_c.w, drr_a.x + drr_b.x + drr_c.x,
              drr_a.y + drr_b.y + drr_c.y, drr_a.z + drr_b.z + drr_c.z});
    }
  }
  __syncthreads();
  for (int j = tid; j < D; j += kThreads) {
    const float dx = dpose != nullptr ? dpose[(size_t)b * Din + j] / std_in[j] : 0.f;
    if (p_prev == nullptr) {
      dx0[(size_t)b * D + j] = dx;
    } else {
      float dp = dp_up[(size_t)b * dp_ld + j] + dx;
      if (j < 6) dp += dp6[j];
      dout[(size_t)b * D + j] = dp * std_out[j];
    }
  }
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns a cudaError_t (0 on
// success). Pointers may be null where the Python side passes None; "ld" is
// a row stride in floats.

int zeggs_dt_pose_fwd(const void* out, const void* mean_out, const void* std_out, const void* x0,
                      const void* rp_prev, int rp_prev_ld, const void* rr_prev, int rr_prev_ld,
                      void* p_dst, int p_ld, void* rp_dst, int rp_ld, void* rr_dst, int rr_ld,
                      const void* gaze, int gaze_ld, const void* mean_in, const void* std_in,
                      void* pose, int B, int D, float dt, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  pose_fwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), static_cast<const float*>(mean_out),
      static_cast<const float*>(std_out),
      static_cast<const float*>(x0), static_cast<const float*>(rp_prev), rp_prev_ld,
      static_cast<const float*>(rr_prev), rr_prev_ld, static_cast<float*>(p_dst), p_ld,
      static_cast<float*>(rp_dst), rp_ld, static_cast<float*>(rr_dst), rr_ld,
      static_cast<const float*>(gaze), gaze_ld, static_cast<const float*>(mean_in),
      static_cast<const float*>(std_in), static_cast<float*>(pose), D, dt);
  return last_error();
}

int zeggs_dt_elu_fwd(const void* pre, int pre_ld, const void* a, int a_ld, void* act, void* hid,
                     int B, int H, void* stream) {
  if (B * H <= 0) return (int)cudaSuccess;
  elu_fwd_kernel<<<blocks(B * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), pre_ld, static_cast<const float*>(a), a_ld,
      static_cast<float*>(act), static_cast<float*>(hid), B, H);
  return last_error();
}

int zeggs_dt_gru_fwd(const void* s0, int ld0, const void* s1, int ld1, const void* s2, int ld2,
                     const void* gh, const void* h, int h_ld, void* h_new, void* gates, int B,
                     int H, void* stream) {
  if (B * H <= 0) return (int)cudaSuccess;
  gru_fwd_kernel<<<blocks(B * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), ld0, static_cast<const float*>(s1), ld1,
      static_cast<const float*>(s2), ld2, static_cast<const float*>(gh),
      static_cast<const float*>(h), h_ld, static_cast<float*>(h_new),
      static_cast<float*>(gates), B, H);
  return last_error();
}

int zeggs_dt_gru_bwd(void* dh, const void* gates, const void* h, void* dgi, int dgi_ld, void* dgh,
                     int dgh_ld, int B, int H, void* stream) {
  if (B * H <= 0) return (int)cudaSuccess;
  gru_bwd_kernel<<<blocks(B * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dh), static_cast<const float*>(gates), static_cast<const float*>(h),
      static_cast<float*>(dgi), dgi_ld, static_cast<float*>(dgh), dgh_ld, B, H);
  return last_error();
}

int zeggs_dt_elu_bwd(const void* dhid, const void* act, void* da, int da_ld, int B, int H,
                     void* stream) {
  if (B * H <= 0) return (int)cudaSuccess;
  elu_bwd_kernel<<<blocks(B * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dhid), static_cast<const float*>(act), static_cast<float*>(da),
      da_ld, B, H);
  return last_error();
}

int zeggs_dt_pose_bwd(const void* dpose, const void* std_in, const void* gaze, int gaze_ld,
                      const void* rp, int rp_ld, const void* rr, int rr_ld, void* dgaze,
                      int dgaze_ld, const void* dp_up, int dp_ld, const void* drp_up, int drp_ld,
                      const void* drr_up, int drr_ld, const void* p_prev, int p_ld,
                      const void* rr_prev, int rr_prev_ld, const void* std_out, void* dout,
                      void* g_rp, void* g_rr, void* dx0, int B, int D, float dt, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  pose_bwd_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dpose), static_cast<const float*>(std_in),
      static_cast<const float*>(gaze), gaze_ld, static_cast<const float*>(rp), rp_ld,
      static_cast<const float*>(rr), rr_ld, static_cast<float*>(dgaze), dgaze_ld,
      static_cast<const float*>(dp_up), dp_ld, static_cast<const float*>(drp_up), drp_ld,
      static_cast<const float*>(drr_up), drr_ld, static_cast<const float*>(p_prev), p_ld,
      static_cast<const float*>(rr_prev), rr_prev_ld, static_cast<const float*>(std_out),
      static_cast<float*>(dout), static_cast<float*>(g_rp), static_cast<float*>(g_rr),
      static_cast<float*>(dx0), D, dt);
  return last_error();
}

const char* zeggs_dt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
