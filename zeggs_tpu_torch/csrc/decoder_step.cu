// The inference decoder step's element-wise work, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the step inside a jitted
// scan, where XLA fuses its element-wise work. Added because on the H100
// the step (`models.decoder.chunk_step`'s `step`, which the rollout programs
// replay from CUDA graphs at B 16) ran ~90 PyTorch operators on slices of 3
// and 4 between its products: ~110 kernels a step, the element-wise ones
// outweighing the products. The Python side is
// zeggs_tpu_torch/ops/kernels/decoder_step.py: the wrappers, and the plain
// PyTorch version of each kernel (the step's own expressions), which the
// CPU and the differentiable step take.
//
//   pose_in   the next input ([rv | rw | lpos | ltxy | lvel | lvrt |
//             R(rr)^-1 (gaze - rp)] - mean_in) / std_in from the six local
//             state tensors (each a pointer and a row stride: separate
//             buffers at a graph's first step, views of the last p after)
//   elu       hid = elu(pre (+ a)) (* gamma + beta): layer0's activation,
//             and for FiLM each layer's scale and shift
//   gates     a GRU layer's h' from gi = (s0 + s1) + s2 and gh (biases
//             inside the products)
//   pose_out  p = out std_out + mean_out; the root integrated into new
//             (B, 3) and (B, 4) rows: rp' = R(rr) v dt + rp,
//             rr' = exp(R(rr) w dt / 2) rr (eps 1e-5)
//
// Their math is decoder_fwd.cuh's, the training rollout's forward
// (decoder_train.cu), so a step of these kernels and the step's cuBLAS
// products gives the plain step's results bit for bit. No kernel is named
// after the GRU-cell kernel (gru_cell.cu), which the trace reads by name.
//
// What bounds them on an H100: bytes. A step at B 16 and H 1024 moves ~1.4 MB
// through these four kernels (a row reads and writes 2 x 1,134 pose values
// in each pose kernel, 3 x H in the ELU and 14 x H in the gates): ~0.4 us
// at 3.35 TB/s, against ~1.5 us a launch. The design keeps each kernel one
// launch over the whole batch with nothing staged: the pose kernels run one
// block a row (the row's values strided over the block's threads, the root
// integration and the gaze in one thread, as the training kernel does), the
// ELU and the gates one thread an element of B x H.

#include "decoder_fwd.cuh"

namespace {

// n values of a state row into the input at `off`, normalised, strided
// over the block's threads
__device__ __forceinline__ void normalize_row(const float* __restrict__ row, int n, int off,
                                              const float* __restrict__ mean_in,
                                              const float* __restrict__ std_in,
                                              float* __restrict__ dst) {
  for (int k = threadIdx.x; k < n; k += kThreads)
    dst[off + k] = normalize(row[k], mean_in[off + k], std_in[off + k]);
}

// One block a row: the six local state tensors (rv, rw, lpos, ltxy, lvel,
// lvrt, in the input's order), each a row `ld` floats apart, then the gaze
__global__ void __launch_bounds__(kThreads)
step_pose_in_kernel(const float* __restrict__ rv, int rv_ld, const float* __restrict__ rw,
                    int rw_ld, const float* __restrict__ lpos, int lpos_ld,
                    const float* __restrict__ ltxy, int ltxy_ld, const float* __restrict__ lvel,
                    int lvel_ld, const float* __restrict__ lvrt, int lvrt_ld,
                    const float* __restrict__ rp, int rp_ld, const float* __restrict__ rr,
                    int rr_ld, const float* __restrict__ gaze, int gaze_ld,
                    const float* __restrict__ mean_in, const float* __restrict__ std_in,
                    float* __restrict__ pose, int J) {
  const size_t b = blockIdx.x;
  const int D = 6 + 15 * J;
  float* dst = pose + b * (D + 3);
  normalize_row(rv + b * rv_ld, 3, 0, mean_in, std_in, dst);
  normalize_row(rw + b * rw_ld, 3, 3, mean_in, std_in, dst);
  normalize_row(lpos + b * lpos_ld, 3 * J, 6, mean_in, std_in, dst);
  normalize_row(ltxy + b * ltxy_ld, 6 * J, 6 + 3 * J, mean_in, std_in, dst);
  normalize_row(lvel + b * lvel_ld, 3 * J, 6 + 9 * J, mean_in, std_in, dst);
  normalize_row(lvrt + b * lvrt_ld, 3 * J, 6 + 12 * J, mean_in, std_in, dst);
  if (threadIdx.x == 0)
    gaze_input(load3(gaze + b * gaze_ld), load3(rp + b * rp_ld), load4(rr + b * rr_ld),
               mean_in + D, std_in + D, dst + D);
}

// hid = elu(pre (+ a)) (* gamma + beta: two roundings), one thread an element
__global__ void step_elu_kernel(const float* __restrict__ pre, int pre_ld,
                                const float* __restrict__ a, int a_ld,
                                const float* __restrict__ gamma, int gamma_ld,
                                const float* __restrict__ beta, int beta_ld,
                                float* __restrict__ hid, int B, int H) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  float x = pre[(size_t)b * pre_ld + j];
  if (a != nullptr) x += a[(size_t)b * a_ld + j];
  float y = elu(x);
  if (gamma != nullptr)
    y = mul(y, gamma[(size_t)b * gamma_ld + j]) + beta[(size_t)b * beta_ld + j];
  hid[i] = y;
}

// h' from gi = (s0 (+ s1)) (+ s2) and gh, one thread an element; the gates
// are not kept (inference)
__global__ void step_gru_gates_kernel(const float* __restrict__ s0, int ld0,
                                      const float* __restrict__ s1, int ld1,
                                      const float* __restrict__ s2, int ld2,
                                      const float* __restrict__ gh, const float* __restrict__ h,
                                      int h_ld, float* __restrict__ h_new, int B, int H) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, j = i % H;
  float r, z, n, ghn;
  h_new[i] = gru_gates(s0, ld0, s1, ld1, s2, ld2, gh, h[(size_t)b * h_ld + j], b, j, H, &r, &z,
                       &n, &ghn);
}

// p into a (B, D) row, the root integrated from (rp, rr) into new rows
__global__ void __launch_bounds__(kThreads)
step_pose_out_kernel(const float* __restrict__ out, const float* __restrict__ mean_out,
                     const float* __restrict__ std_out, const float* __restrict__ rp, int rp_ld,
                     const float* __restrict__ rr, int rr_ld, float* __restrict__ p,
                     float* __restrict__ rp_new, float* __restrict__ rr_new, int D, float dt) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* o = out + (size_t)b * D;
  for (int j = tid; j < D; j += kThreads)
    p[(size_t)b * D + j] = denormalize(o[j], std_out[j], mean_out[j]);
  if (tid == 0) {
    float p6[6];
    for (int j = 0; j < 6; ++j) p6[j] = denormalize(o[j], std_out[j], mean_out[j]);
    V3 rp1;
    Q4 rr1;
    integrate_root(p6, load3(rp + (size_t)b * rp_ld), load4(rr + (size_t)b * rr_ld), dt, &rp1,
                   &rr1);
    store3(rp_new + (size_t)b * 3, rp1);
    store4(rr_new + (size_t)b * 4, rr1);
  }
}

}  // namespace

extern "C" {

// Each launches one kernel on `stream` and returns a cudaError_t (0 on
// success). Pointers may be null where the Python side passes None; "ld" is
// a row stride in floats. Outputs are contiguous rows.

int zeggs_ds_pose_in(const void* rv, int rv_ld, const void* rw, int rw_ld, const void* lpos,
                     int lpos_ld, const void* ltxy, int ltxy_ld, const void* lvel, int lvel_ld,
                     const void* lvrt, int lvrt_ld, const void* rp, int rp_ld, const void* rr,
                     int rr_ld, const void* gaze, int gaze_ld, const void* mean_in,
                     const void* std_in, void* pose, int B, int J, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  step_pose_in_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rv), rv_ld, static_cast<const float*>(rw), rw_ld,
      static_cast<const float*>(lpos), lpos_ld, static_cast<const float*>(ltxy), ltxy_ld,
      static_cast<const float*>(lvel), lvel_ld, static_cast<const float*>(lvrt), lvrt_ld,
      static_cast<const float*>(rp), rp_ld, static_cast<const float*>(rr), rr_ld,
      static_cast<const float*>(gaze), gaze_ld, static_cast<const float*>(mean_in),
      static_cast<const float*>(std_in), static_cast<float*>(pose), J);
  return last_error();
}

int zeggs_ds_elu(const void* pre, int pre_ld, const void* a, int a_ld, const void* gamma,
                 int gamma_ld, const void* beta, int beta_ld, void* hid, int B, int H,
                 void* stream) {
  if (B * H <= 0) return (int)cudaSuccess;
  step_elu_kernel<<<blocks(B * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pre), pre_ld, static_cast<const float*>(a), a_ld,
      static_cast<const float*>(gamma), gamma_ld, static_cast<const float*>(beta), beta_ld,
      static_cast<float*>(hid), B, H);
  return last_error();
}

int zeggs_ds_gru_gates(const void* s0, int ld0, const void* s1, int ld1, const void* s2, int ld2,
                       const void* gh, const void* h, int h_ld, void* h_new, int B, int H,
                       void* stream) {
  if (B * H <= 0) return (int)cudaSuccess;
  step_gru_gates_kernel<<<blocks(B * H), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(s0), ld0, static_cast<const float*>(s1), ld1,
      static_cast<const float*>(s2), ld2, static_cast<const float*>(gh),
      static_cast<const float*>(h), h_ld, static_cast<float*>(h_new), B, H);
  return last_error();
}

int zeggs_ds_pose_out(const void* out, const void* mean_out, const void* std_out, const void* rp,
                      int rp_ld, const void* rr, int rr_ld, void* p, void* rp_new, void* rr_new,
                      int B, int D, float dt, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  step_pose_out_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(out), static_cast<const float*>(mean_out),
      static_cast<const float*>(std_out), static_cast<const float*>(rp), rp_ld,
      static_cast<const float*>(rr), rr_ld, static_cast<float*>(p), static_cast<float*>(rp_new),
      static_cast<float*>(rr_new), D, dt);
  return last_error();
}

const char* zeggs_ds_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
