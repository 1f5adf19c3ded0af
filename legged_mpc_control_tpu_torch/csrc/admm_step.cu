// The ADMM iteration's update, after each Cholesky solve (K5), in one
// launch: the relaxation, the constraint product, the projection, the dual
// step and the next iteration's right-hand side.
//
// Replaces: no Pallas kernel. The JAX package's ADMM iteration is jnp ops
//           (legged_mpc_control_tpu/mpc/admm.py); here the same update as
//           some thirty torch operations an iteration (two of them batched
//           matrix-vector products) cost more device time than K5 itself.
// Plain version: legged_mpc_control_tpu_torch/ops/admm_kernel.py,
//           admm_step_plain (those torch operations).
//
// The caller is mpc/admm.py's solve_qp_admm_batched: B scenarios, horizon
// H, n = 12H, per (scenario, step, leg) its 3 scaled forces x, its 6
// constraint rows z, y, h~ and its scaled block G~ (6 x 3). With x_t the
// solve's output, one launch computes
//
//   x   <- alpha x_t + (1 - alpha) x
//   Gx   = G~ x
//   z   <- min(max(Gx + y / rho, neg), h~)
//   y   <- y + rho (Gx - z)
//   rhs  = sigma x - q~ + G~^T (rho z - y)      (the next solve's)
//
// A launch with no x_t computes only rhs from the given x, z, y (the first
// iteration's, from a warm or zero start). Layouts are batch-first, row-major: x, x_t, q~,
// rhs (B, n); z, y, h~ (B, H, 4, 6); G~ (B, H, 4, 6, 3). The outputs are
// new arrays, never the inputs.
//
// Arithmetic. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn: nvcc contracts none of them into an FMA), in the order of the
// torch operations: the relaxation as two products and a sum, the division
// by rho an IEEE one, the 3- and 6-term products as sums from the first
// term on, the clip as comparisons (a NaN stays NaN, as torch.clamp and
// torch.minimum keep it). So the CPU emulation of this source gives the
// plain version's numbers (tests/test_torch_emulated.py).
//
// What bounds it on an H100: bytes. A leg reads x_t, x, q~ (3 each), y, h~
// (6 each), G~ (18) and writes x, z, y (3 + 6 + 6) and rhs (3): 228 bytes,
// so at B = 4096, H = 30 a launch moves 112 MB, 0.034 ms at 3.35 TB/s; its
// 123 floating-point operations a leg are nothing beside that. Design: one
// thread a (scenario, step, leg), its 3 + 6 + 6 + 18 values in registers,
// so a warp's loads of each array cover one contiguous span (the L1 line
// serves the thread's neighbours' words); no shared memory, no barrier.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int NC = 6;                  // constraint rows a leg

__global__ void __launch_bounds__(THREADS)
admm_step_kernel(const float* __restrict__ xt,
                 const float* __restrict__ x, const float* __restrict__ z,
                 const float* __restrict__ y, const float* __restrict__ G,
                 const float* __restrict__ h, const float* __restrict__ q,
                 float* __restrict__ x_out, float* __restrict__ z_out,
                 float* __restrict__ y_out, float* __restrict__ rhs,
                 long legs, float rho, float sigma, float alpha, float beta,
                 float neg) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= legs) return;
  const float* g = G + 18 * t;
  float xs[3], zs[NC], ys[NC];
  if (xt != nullptr) {
    for (int i = 0; i < 3; ++i)
      xs[i] = __fadd_rn(__fmul_rn(alpha, xt[3 * t + i]),
                        __fmul_rn(beta, x[3 * t + i]));
    for (int r = 0; r < NC; ++r) {
      float gx = __fmul_rn(g[3 * r], xs[0]);
      gx = __fadd_rn(gx, __fmul_rn(g[3 * r + 1], xs[1]));
      gx = __fadd_rn(gx, __fmul_rn(g[3 * r + 2], xs[2]));
      const float yr = y[NC * t + r];
      float v = __fadd_rn(gx, __fdiv_rn(yr, rho));
      v = v < neg ? neg : v;
      const float hr = h[NC * t + r];
      v = v > hr ? hr : v;
      zs[r] = v;
      ys[r] = __fadd_rn(yr, __fmul_rn(rho, __fsub_rn(gx, v)));
    }
    for (int i = 0; i < 3; ++i) x_out[3 * t + i] = xs[i];
    for (int r = 0; r < NC; ++r) {
      z_out[NC * t + r] = zs[r];
      y_out[NC * t + r] = ys[r];
    }
  } else {
    for (int i = 0; i < 3; ++i) xs[i] = x[3 * t + i];
    for (int r = 0; r < NC; ++r) {
      zs[r] = z[NC * t + r];
      ys[r] = y[NC * t + r];
    }
  }
  float w[NC];
  for (int r = 0; r < NC; ++r)
    w[r] = __fsub_rn(__fmul_rn(rho, zs[r]), ys[r]);
  for (int i = 0; i < 3; ++i) {
    float gt = __fmul_rn(g[i], w[0]);
    for (int r = 1; r < NC; ++r)
      gt = __fadd_rn(gt, __fmul_rn(g[3 * r + i], w[r]));
    rhs[3 * t + i] = __fadd_rn(
        __fsub_rn(__fmul_rn(sigma, xs[i]), q[3 * t + i]), gt);
  }
}

}  // namespace

// One ADMM update over B scenarios of horizon H on `stream` (see the top of
// the file): xt may be null (rhs only, from x, z, y; the outputs x_out,
// z_out, y_out are then not written).
// beta is 1 - alpha as the caller rounds it. Returns cudaGetLastError()
// after the launch.
extern "C" int admm_step_launch(const float* xt, const float* x,
                                const float* z, const float* y,
                                const float* G, const float* h,
                                const float* q, float* x_out, float* z_out,
                                float* y_out, float* rhs, int B, int H,
                                float rho, float sigma, float alpha,
                                float beta, float neg, void* stream) {
  const long legs = (long)B * H * 4;
  if (legs == 0) return 0;
  const long blocks = (legs + THREADS - 1) / THREADS;
  admm_step_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      xt, x, z, y, G, h, q, x_out, z_out, y_out, rhs, legs, rho, sigma,
      alpha, beta, neg);
  return (int)cudaGetLastError();
}
