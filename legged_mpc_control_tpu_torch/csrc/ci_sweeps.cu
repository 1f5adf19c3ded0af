// Kernel K7: every Gauss-Newton iLQR sweep of the contact-implicit MPC in
// one launch (flat-zero terrain, no wall).
//
// Replaces: legged_mpc_control_tpu/ops/ci_pallas.py, ci_sweeps_fused.
// Plain version: legged_mpc_control_tpu_torch/ops/ci_kernel.py,
//                ci_sweeps_plain (mpc/ci_mpc.py:_sweeps with this kernel's
//                line-search rule).
//
// What it computes, per scenario: the initial rollout of the warm-start
// inputs, then `iters` sweeps of
//   * the flat-terrain Gauss-Newton quadratization of every stage (gap =
//     foot_z; exact gradient, per-foot closed-form Hessian entries with the
//     Fischer-Burmeister curvature restored on its violation side),
//   * the backward Riccati pass over the H stages: Q terms through the
//     dynamics Jacobians Fz = I + dt S and Fu = dt T, the gains from the
//     Levenberg-regularized Quu + reg I + state_reg Fu'Fu by a 24x24
//     Cholesky and a 24x25 triangular solve, a per-scenario guard that
//     zeroes a stage whose gains are not finite and keeps (Vx, Vxx) when the
//     update is not,
//   * a line search over alpha in (1, 0.5, 0.25, 0.05, 0): five forward
//     passes with feedback, each costed on its own trajectory; the first
//     strictly smallest finite cost wins, and a scenario whose candidates
//     are all non-finite keeps its nominal (alpha 0), as the TPU kernel
//     does. The winner's trajectory becomes the nominal.
// The relaxation anneals rho = max(exp(log rho0 + frac (log rho_min -
// log rho0)), rho_min), frac = it / (iters - 1).
//
// Layout: batch-first, scenario-major. Inputs z0 (B,24), uh0 (B,H,24)
// scaled inputs, ref_zu (B,H,48), refT (B,24), f_mask (B,H,4), rho0 (B),
// iw_inv (B,3,3), misc (54) = [c_fb, c_slip, c_cone, c_mask, track_h(48),
// mu, mass]. Outputs U (B,H,24) scaled, Z (B,H+1,24), cost (B). Device
// memory is read once at the start and written once at the end.
//
// What bounds it on an H100: ~27k float32 operations a stage and sweep in
// the TPU kernel's block-sparse form (chip_smoke.py counts them), 0.15 ms
// for B=256, H=10, 24 sweeps at 67 TFLOP/s; it moves 1.4 MB. Neither roof
// is near: a sweep is a chain of H dependent stages, each a chain of small
// dependent steps (a 24x24 Cholesky of 24 column steps among them), so the
// latency of that chain bounds it, at B=1 as at B=256 (two blocks an SM).
// The old design (a warp a scenario, dense products in shared memory, six
// serial forward passes, K and the trajectory in device memory) spent 128k
// cycles a stage-sweep, 40 % of it in the Cholesky and the solve
// (PERF.md). This design puts more of the SM on each scenario, not more
// scenarios on an SM.
//
// Design: a block of 6 warps (192 threads) a scenario.
// - Shared memory holds, for the whole launch, the nominal Z and U, the
//   references, the gain cache K (H x 24 x 25) and kff, the stage matrices
//   and five candidate trajectories (as the TPU kernel keeps them in VMEM):
//   73 KB at H=10, 80 KB at H=12. The largest horizon that fits the 227 KB
//   of a block is ci_sweeps_max_h(), 50; the wrapper refuses a larger one
//   (the dispatch sends K7 H <= 12). At 150 registers a thread, two blocks
//   share an SM.
// - The Q terms are the dense products F'(Vxx F) of the plain version, but
//   summed over the nonzeros of Fz = I + dt S and Fu = dt T only: a column
//   of either has at most 4 (the identity, pos <- v and eul <- om, the
//   three om rows Iw_inv skew(.)), so an element costs at most 4 FMAs and
//   rounds as the dense product with its zero terms left out, term for
//   term, as the plain version's sums do. (The TPU kernel's expanded form,
//   Qxx = Vxx + dt (Y + Y') + dt^2 S'Y with Y = Vxx S, costs as little
//   but rounds otherwise. Under either, about one scenario in a few
//   hundred sits near a line-search tie and takes another path than the
//   plain version in float32, as any change of rounding makes it do;
//   PERF.md, tools/k7_accuracy.py.) The warps that wait on the Cholesky build the next
//   stage's Fz, Fu (dense, and their columns' nonzero values) and its feet's
//   quadratization, double-buffered. Thread t owns row t / 8 and columns
//   t % 8 + 8 m (m < 3) of every 24x24 result. The three dense products of
//   the value update, K'Quu, (K'Quu) K and K'Qux, are split the same way,
//   24 FMAs an element.
// - The 24x24 Cholesky runs on warp 0 in registers, lane i holding row i,
//   right-looking with shuffles (K4's n <= 32 variant, csrc/chol_factor.cu),
//   sqrtf and a true reciprocal, so a non-positive pivot gives NaN and the
//   stage guard trips. The 25-column triangular solve follows on the same
//   warp, a lane a column, the column in registers, a __syncwarp a step
//   (without it the compiler hoists every load of L and spills).
// - The five line-search candidates run at once, one warp each, each
//   writing its trajectory into its own slot: one pass a sweep instead of
//   the old kernel's six. The feet's costs are summed after the rollout, a
//   (stage, foot) a lane. After one block barrier every thread picks the
//   winner by the rule above and the block copies its slot into the
//   nominal, so the committed trajectory is bit for bit the one that was
//   costed.
// - Barriers are __syncthreads (7 a backward stage) and __syncwarp; every
//   thread of a block runs every barrier (a block is one scenario, so
//   there is no ragged tail and no early exit).
// - Register arrays are indexed by unrolled constants only (no stack
//   frame, no spills: chip_smoke.py gates on it).
// All arithmetic is float32 on the CUDA cores: the dense products left are
// three 24x24x24 ones a stage, too small for a 64-row wgmma tile, and the
// Cholesky of Quu + reg I + state_reg Fu'Fu is what float32 already strains
// (ROADMAP), so no TF32 tensor cores.
//
// Numerics as the TPU kernel: sign(0) = 0 (the cone rows of every swing foot
// of the template), softplus = max(x, 0) + log1p(exp(-|x|)), sigmoid =
// 1 / (1 + exp(-x)); the Cholesky pivot uses sqrtf and a true reciprocal.

#include <cuda_runtime.h>
#include <math.h>

// Phase marks, empty in the package's build: tools/k7_spans.py defines
// them (K7_SPANS) to read clock64() around each phase on thread 0 (warp 0,
// so the candidates' span is the alpha = 1 warp's pass and its wait).
//   K7_SPAN(0): loads + initial rollout
//   K7_SPAN(1): bwd: terminal value + stage H-1's Fz, Fu, quad_foot
//   K7_SPAN(2): bwd: Vxx Fz, Vxx Fu, Qx, Qu
//   K7_SPAN(3): bwd: Qxx, Quu, Qux + regularized
//   K7_SPAN(4): bwd: Cholesky (beside it the next stage's Fz, Fu, feet)
//   K7_SPAN(5): bwd: 25-column solve + guard + gain store
//   K7_SPAN(6): bwd: K'Quu, K'Qux
//   K7_SPAN(7): bwd: (K'Quu) K, Vx
//   K7_SPAN(8): bwd: symmetrize + keep
//   K7_SPAN(9): five candidates at once
//   K7_SPAN(10): argmin + copy of the winner
//   K7_SPAN(11): store
#ifndef K7_SPANS
#define K7_SPANS_BEGIN
#define K7_SPAN(n)
#define K7_SPANS_END
#endif

namespace {

constexpr int N = 24;            // NZ = NU
constexpr int LD = 24;           // row stride of the 24x24 stage matrices
constexpr int LDR = 25;          // of the gain system, its right-hand side
                                 // and the K cache (lane r reads row r of K
                                 // without bank conflicts)
constexpr int NALPHA = 5;
constexpr int WARP = 32;
constexpr int NT = 192;          // threads a block: 6 warps
constexpr int CW = 8;            // thread t owns row t / CW, cols t % CW + CW m
constexpr int NM = N / CW;       // 3 columns a thread
constexpr float F0 = 50.0f;
constexpr float G0 = 0.02f;
constexpr float GRAV = 9.81f;
constexpr int NMISC = 54;
constexpr int NHF = 10;          // per-foot Hessian entries
constexpr int NGF = 6;           // per-foot gradient adds
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;   // an H100 block's shared memory
constexpr int MAX_DEVICES = 64;

__device__ __constant__ float ALPHAS[NALPHA] = {1.0f, 0.5f, 0.25f, 0.05f,
                                                0.0f};

// a stage's dynamics Jacobians and its feet's quadratization
struct StageT {
  float Fz[N * LD], Fu[N * LD];      // Fz = I + dt S, Fu = dt T
  // column c's values at its rows fz_rows(c), fu_rows(c)
  float zv[N][4], uv[N][4];
  float hf[4][NHF], gf[4][NGF];
};

// the horizon-independent part of a block's shared memory
struct Fixed {
  float V[2][N * LD];        // Vxx, double-buffered (kept only if finite)
  float Y[N * LD];           // T1 = Vxx Fz, then Qxx + K'Quu K + P + P'
  float W[N * LD];           // T2 = Vxx Fu, then K'Quu
  float P[N * LD];           // K'Qux
  float Qxx[N * LD], Quu[N * LD], Qux[N * LD];
  float L[N * LDR];          // Quu + reg I + state_reg Fu'Fu, then its factor
  float R[N * LDR];          // [Qu | Qux + state_reg Fu'Fz]
  float Vx[2][N];
  float q[2 * N];            // Qx, Qu
  float linv[N];             // 1 / L[i][i]
  StageT st[2];              // stage k's in st[k % 2]
  float refT[N], iw[9], misc[NMISC];
  float ccost[NALPHA];
};

// floats of the horizon-dependent part: K cache, kff, nominal Z and U,
// references, foot masks, five candidate (Z, U)
__host__ __device__ constexpr size_t per_h_floats(int H) {
  return (size_t)H * N * LDR + (size_t)H * N + (size_t)(H + 1) * N
         + (size_t)H * N + (size_t)H * 2 * N + (size_t)H * 4
         + (size_t)NALPHA * ((H + 1) * N + H * N);
}

__host__ __device__ constexpr size_t smem_bytes(int H) {
  return sizeof(Fixed) + per_h_floats(H) * sizeof(float);
}

// per-foot Hessian entries in StageT::hf
enum { H_PZ, H_FX, H_FY, H_FZ, H_W, E_PZFZ, E_FXFZ, E_FYFZ, E_FZWX, E_FZWY };

struct Args {
  const float* z0;
  const float* uh0;
  const float* ref_zu;
  const float* refT;
  const float* f_mask;
  const float* rho0;
  const float* iw_inv;
  const float* misc;
  float* U;
  float* Z;
  float* cost;
  int H, iters;
  float dt, s_f, rho_min, reg, state_reg;
};

// a block's shared memory, by part
struct Ctx {
  Fixed* s;
  float* Kc;     // (H, 24, LDR)
  float* kff;    // (H, 24)
  float* Zn;     // (H+1, 24) nominal
  float* Un;     // (H, 24)
  float* Ref;    // (H, 48)
  float* Fm;     // (H, 4)
  float* Zc;     // (NALPHA, H+1, 24) candidates
  float* Uc;     // (NALPHA, H, 24)
};

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float sgn(float x) {
  return (float)((x > 0.0f) - (x < 0.0f));
}

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// column c of iw skew(v) for a row iw of Iw_inv, skew(v) = [[0,-vz,vy],
// [vz,0,-vx],[-vy,vx,0]]
__device__ __forceinline__ float skew_col(const float* iw, float vx, float vy,
                                          float vz, int c) {
  if (c == 0) return iw[1] * vz - iw[2] * vy;
  if (c == 1) return -iw[0] * vz + iw[2] * vx;
  return iw[0] * vy - iw[1] * vx;
}

// one SRB+feet step, row r of z' from the stage's z and u (==
// ci_mpc._dyn_b)
__device__ float dyn_row(const float* z, const float* u, const float* iwm,
                         int r, float dt, float s_f, float mass) {
  if (r < 3) return z[r] + dt * z[6 + r];
  if (r < 6) return z[r] + dt * z[9 + r - 3];
  if (r < 9) {
    const int i = r - 6;
    float fs = 0.0f;
    for (int f = 0; f < 4; ++f) fs += s_f * u[3 * f + i];
    const float acc = fs / mass + (i == 2 ? -GRAV : 0.0f);
    return z[r] + dt * acc;
  }
  if (r < 12) {
    float tau0 = 0.0f, tau1 = 0.0f, tau2 = 0.0f;
    for (int f = 0; f < 4; ++f) {
      const float rx = z[12 + 3 * f] - z[0], ry = z[13 + 3 * f] - z[1],
                  rz = z[14 + 3 * f] - z[2];
      const float fx = s_f * u[3 * f], fy = s_f * u[3 * f + 1],
                  fz = s_f * u[3 * f + 2];
      tau0 += ry * fz - rz * fy;
      tau1 += rz * fx - rx * fz;
      tau2 += rx * fy - ry * fx;
    }
    const int i = r - 9;
    const float w = iwm[3 * i] * tau0 + iwm[3 * i + 1] * tau1
                    + iwm[3 * i + 2] * tau2;
    return z[r] + dt * w;
  }
  return z[r] + dt * u[r];
}

// the per-foot complementarity cost of foot f at the stage (z, u)
__device__ float foot_cost(const Fixed& s, const float* z, const float* u,
                           float fm, int f, float rho, float s_f) {
  const float c_fb = s.misc[0], c_slip = s.misc[1], c_cone = s.misc[2],
              c_mask = s.misc[3], mu = s.misc[52];
  const float fx = s_f * u[3 * f], fy = s_f * u[3 * f + 1],
              fz = s_f * u[3 * f + 2];
  const float w0 = u[12 + 3 * f], w1 = u[13 + 3 * f];
  const float a = fz / F0;
  const float b = z[14 + 3 * f] / G0;
  const float r1 = a + b - sqrtf(a * a + b * b + rho * rho);
  const float spa = rho * softplus(a / rho);
  const float t4 = (fabsf(fx) - mu * fz) / F0;
  const float t5 = (fabsf(fy) - mu * fz) / F0;
  const float sp4 = rho * softplus(t4 / rho), sp5 = rho * softplus(t5 / rho);
  const float r6 = (1.0f - fm) * a;
  return c_fb * r1 * r1 + c_slip * spa * (w0 * w0 + w1 * w1)
         + c_cone * (sp4 * sp4 + sp5 * sp5) + c_mask * r6 * r6;
}

// the flat-terrain quadratization of foot f: gradient adds into g.gf[f]
// (z row 14 + 3f; u rows 3f, 3f + 1, 3f + 2, 12 + 3f, 13 + 3f), Hessian
// entries into g.hf[f]
__device__ void quad_foot(const Fixed& s, StageT& st, const float* z,
                          const float* u, float fm, int f, float rho,
                          float s_f) {
  const float c_fb = s.misc[0], c_slip = s.misc[1], c_cone = s.misc[2],
              c_mask = s.misc[3], mu = s.misc[52];
  const float sfF0 = s_f / F0;
  const float pz = z[14 + 3 * f];
  const float fx = s_f * u[3 * f], fy = s_f * u[3 * f + 1],
              fz = s_f * u[3 * f + 2];
  const float w0 = u[12 + 3 * f], w1 = u[13 + 3 * f];
  const float a = fz / F0;
  const float b = pz / G0;
  const float sr = sqrtf(a * a + b * b + rho * rho);
  const float r1 = a + b - sr;
  const float ca = 1.0f - a / sr, cb = 1.0f - b / sr;
  const float spa = rho * softplus(a / rho);
  const float sig = sigmoid(a / rho);
  const float sq = sqrtf(spa + 1e-12f);
  const float dsq = sig / (2.0f * sq);
  const float r2 = sq * w0, r3 = sq * w1;
  const float t4 = (fabsf(fx) - mu * fz) / F0;
  const float t5 = (fabsf(fy) - mu * fz) / F0;
  const float r4 = rho * softplus(t4 / rho), r5 = rho * softplus(t5 / rho);
  const float sig4 = sigmoid(t4 / rho), sig5 = sigmoid(t5 / rho);
  const float sgn0 = sgn(fx), sgn1 = sgn(fy);
  const float r6c = 1.0f - fm;

  float* g = st.gf[f];
  g[0] = 2.0f * c_fb * r1 * cb / G0;
  g[1] = 2.0f * c_cone * r4 * sig4 * sgn0 * sfF0;
  g[2] = 2.0f * c_cone * r5 * sig5 * sgn1 * sfF0;
  g[3] = 2.0f * (c_fb * r1 * ca + c_slip * (r2 * w0 + r3 * w1) * dsq
                 - c_cone * mu * (r4 * sig4 + r5 * sig5)
                 + c_mask * (r6c * a) * r6c) * sfF0;
  g[4] = 2.0f * c_slip * r2 * sq;
  g[5] = 2.0f * c_slip * r3 * sq;

  // Gauss-Newton entries plus the FB violation-side curvature
  const float mcv = 2.0f * c_fb * fminf(r1, 0.0f) / (sr * sr * sr);
  const float c_aa = mcv * (a * a - sr * sr);
  const float c_bb = mcv * (b * b - sr * sr);
  const float c_ab = mcv * (a * b);
  float* h = st.hf[f];
  h[H_PZ] = 2.0f * c_fb * cb * cb / (G0 * G0) + c_bb / (G0 * G0);
  h[H_FX] = 2.0f * c_cone * sig4 * sig4 * sgn0 * sgn0 * sfF0 * sfF0;
  h[H_FY] = 2.0f * c_cone * sig5 * sig5 * sgn1 * sgn1 * sfF0 * sfF0;
  h[H_FZ] = (2.0f * (c_fb * ca * ca + c_slip * dsq * dsq * (w0 * w0 + w1 * w1)
                     + c_cone * mu * mu * (sig4 * sig4 + sig5 * sig5)
                     + c_mask * r6c * r6c) + c_aa) * sfF0 * sfF0;
  h[H_W] = 2.0f * c_slip * (spa + 1e-12f);
  h[E_PZFZ] = 2.0f * c_fb * ca * cb * sfF0 / G0 + c_ab * sfF0 / G0;
  h[E_FXFZ] = -2.0f * c_cone * sig4 * sig4 * sgn0 * mu * sfF0 * sfF0;
  h[E_FYFZ] = -2.0f * c_cone * sig5 * sig5 * sgn1 * mu * sfF0 * sfF0;
  h[E_FZWX] = c_slip * sig * w0 * sfF0;
  h[E_FZWY] = c_slip * sig * w1 * sfF0;
}

// the stage Hessian's entries: Hxx (diagonal), Huu and Hux (u row i)
__device__ __forceinline__ float hxx(const Fixed& s, const StageT& g, int i,
                                     int j) {
  if (i != j) return 0.0f;
  const float v = s.misc[4 + i];
  return (i >= 14 && (i - 14) % 3 == 0) ? v + g.hf[(i - 14) / 3][H_PZ] : v;
}

__device__ float huu(const Fixed& s, const StageT& g, int i, int j) {
  if (i == j) {
    const float v = s.misc[4 + N + i];
    if (i < 12) {
      const int c = i % 3;
      return v + g.hf[i / 3][c == 0 ? H_FX : (c == 1 ? H_FY : H_FZ)];
    }
    return (i - 12) % 3 < 2 ? v + g.hf[(i - 12) / 3][H_W] : v;
  }
  const int a = i < j ? i : j, b = i < j ? j : i;
  if (a >= 12) return 0.0f;
  const int f = a / 3;
  if (b < 12) {           // fx-fz or fy-fz of one foot
    if (b != 3 * f + 2) return 0.0f;
    return g.hf[f][a % 3 == 0 ? E_FXFZ : E_FYFZ];
  }
  if (a != 3 * f + 2) return 0.0f;     // fz with that foot's w0, w1
  if (b == 12 + 3 * f) return g.hf[f][E_FZWX];
  if (b == 13 + 3 * f) return g.hf[f][E_FZWY];
  return 0.0f;
}

__device__ __forceinline__ float hux(const StageT& g, int i, int j) {
  return (i < 12 && i % 3 == 2 && j == 12 + i) ? g.hf[i / 3][E_PZFZ]
                                                : 0.0f;
}

// the gradient's foot adds of z row i and u row i
__device__ __forceinline__ float gx_add(const StageT& g, int i) {
  return (i >= 14 && (i - 14) % 3 == 0) ? g.gf[(i - 14) / 3][0] : 0.0f;
}

__device__ __forceinline__ float gu_add(const StageT& g, int i) {
  if (i < 12) return g.gf[i / 3][1 + i % 3];
  const int c = (i - 12) % 3;
  return c < 2 ? g.gf[(i - 12) / 3][4 + c] : 0.0f;
}

// warp 0: the Cholesky of s.L in registers (lane i holds row i), then
// L L' X = s.R a lane per column, the stage guard, and the gains into K
// (24 x LDR) and kff
__device__ void gain_solve(Fixed& s, float* K, float* kff) {
  const int i = threadIdx.x;
  float a[N];
#pragma unroll
  for (int q = 0; q < N; ++q)
    a[q] = (i < N && q <= i) ? s.L[i * LDR + q] : 0.0f;
  float own_inv = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float pv = __shfl_sync(FULL, a[j], j);
    const float sq = sqrtf(pv);
    const float inv = 1.0f / sq;
    const float lij = a[j] * inv;
#pragma unroll
    for (int q = j + 1; q < N; ++q) {
      const float lqj = __shfl_sync(FULL, lij, q);
      if (q <= i) a[q] -= lij * lqj;
    }
    if (i > j) a[j] = lij;
    else if (i == j) {
      a[j] = sq;
      own_inv = inv;
    }
  }
  if (i < N) {
#pragma unroll
    for (int q = 0; q < N; ++q)
      if (q <= i) s.L[i * LDR + q] = a[q];
    s.linv[i] = own_inv;
  }
  __syncwarp();
  K7_SPAN(4);
  // a lane a column of R (lanes 25..31 repeat column 24); a __syncwarp a
  // step keeps the compiler from hoisting every load of L into registers
  const int col = i < N + 1 ? i : N;
  float x[N];
  bool ok = true;
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = s.R[r * LDR + col];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    __syncwarp();
    x[j] *= s.linv[j];
#pragma unroll
    for (int r = j + 1; r < N; ++r) x[r] -= s.L[r * LDR + j] * x[j];
  }
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    __syncwarp();
    x[j] *= s.linv[j];
#pragma unroll
    for (int r = 0; r < j; ++r) x[r] -= s.L[j * LDR + r] * x[j];
    ok = ok && finite(x[j]);
  }
  const bool okk = __all_sync(FULL, ok);
  if (i == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) kff[r] = okk ? -x[r] : 0.0f;
  } else if (i < N + 1) {
#pragma unroll
    for (int r = 0; r < N; ++r) K[r * LDR + i - 1] = okk ? -x[r] : 0.0f;
  }
}

// entry (q, c) of the dynamics Jacobians at the stage (z, u) (==
// ci_mpc._dyn_jac_b): Fz = I + dt S, Fu = dt T; S's nonzeros are pos <- v,
// eul <- om (1) and om <- pos, feet (Pm = Iw_inv skew(sum_f f_f), G_f =
// -Iw_inv skew(f_f)); T's are v <- f_f (s_f / mass), om <- f_f (R_f = s_f
// Iw_inv skew(feet_f - pos)) and feet <- foot velocities (1)
__device__ float fz_entry(const Fixed& s, const float* z, const float* u,
                          int q, int c, float dt, float s_f) {
  float sv = 0.0f;
  if (q < 6) {
    sv = c == q + 6 ? 1.0f : 0.0f;
  } else if (q >= 9 && q < 12) {
    const float* iw = s.iw + 3 * (q - 9);
    if (c < 3) {
      float sx = 0.0f, sy = 0.0f, sz = 0.0f;
      for (int f = 0; f < 4; ++f) {
        sx += s_f * u[3 * f];
        sy += s_f * u[3 * f + 1];
        sz += s_f * u[3 * f + 2];
      }
      sv = skew_col(iw, sx, sy, sz, c);
    } else if (c >= 12) {
      const int f = (c - 12) / 3;
      sv = -skew_col(iw, s_f * u[3 * f], s_f * u[3 * f + 1],
                     s_f * u[3 * f + 2], (c - 12) % 3);
    }
  }
  return (q == c ? 1.0f : 0.0f) + dt * sv;
}

__device__ float fu_entry(const Fixed& s, const float* z, int q, int c,
                          float dt, float s_f) {
  float tv = 0.0f;
  if (q >= 6 && q < 9) {
    tv = (c < 12 && c % 3 == q - 6) ? s_f / s.misc[53] : 0.0f;
  } else if (q >= 9 && q < 12) {
    if (c < 12) {
      const int f = c / 3;
      tv = s_f * skew_col(s.iw + 3 * (q - 9), z[12 + 3 * f] - z[0],
                          z[13 + 3 * f] - z[1], z[14 + 3 * f] - z[2], c % 3);
    }
  } else if (q >= 12) {
    tv = q == c ? 1.0f : 0.0f;
  }
  return dt * tv;
}

// the rows of column c of Fz, and of Fu, that can be nonzero, ascending:
// the diagonal, pos <- v and eul <- om, om <- pos and feet; v and om <- a
// force, feet <- a foot velocity. Returns their number (at most 4).
__device__ __forceinline__ int fz_rows(int c, int (&q)[4]) {
  if (c < 3) {
    q[0] = c;
    q[1] = 9;
    q[2] = 10;
    q[3] = 11;
    return 4;
  }
  if (c < 6) {
    q[0] = c;
    return 1;
  }
  if (c < 12) {
    q[0] = c - 6;
    q[1] = c;
    return 2;
  }
  q[0] = 9;
  q[1] = 10;
  q[2] = 11;
  q[3] = c;
  return 4;
}

__device__ __forceinline__ int fu_rows(int c, int (&q)[4]) {
  if (c >= 12) {
    q[0] = c;
    return 1;
  }
  q[0] = 6 + c % 3;
  q[1] = 9;
  q[2] = 10;
  q[3] = 11;
  return 4;
}

// warps 1..5: stage k's Jacobians, dense and by column (the rows that can
// be nonzero, ascending), and its feet's quadratization, into st
__device__ void stage_prep(const Ctx& c, const Args& p, StageT& st, int k,
                           float rho) {
  const Fixed& s = *c.s;
  const int t = threadIdx.x - WARP;
  const float dt = p.dt, s_f = p.s_f;
  const float* z = c.Zn + k * N;
  const float* u = c.Un + k * N;
  for (int e = t; e < N * LD; e += NT - WARP) {
    const int q = e / LD, col = e % LD;
    st.Fz[e] = fz_entry(s, z, u, q, col, dt, s_f);
    st.Fu[e] = fu_entry(s, z, q, col, dt, s_f);
  }
  if (t < 2 * N) {             // the values of column t of Fz, or of Fu
    const bool x = t < N;
    const int col = x ? t : t - N;
    int q[4] = {0, 0, 0, 0};
    const int n = x ? fz_rows(col, q) : fu_rows(col, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.0f;
      if (e < n) v = x ? fz_entry(s, z, u, q[e], col, dt, s_f)
                       : fu_entry(s, z, q[e], col, dt, s_f);
      (x ? st.zv : st.uv)[col][e] = v;
    }
  } else if (t >= 4 * WARP && t < 4 * WARP + 4) {
    const int f = t - 4 * WARP;
    quad_foot(s, st, z, u, c.Fm[k * 4 + f], f, rho, s_f);
  }
}

// one backward Riccati pass over the H stages at relaxation rho: the gains
// into c.Kc, c.kff
__device__ void backward(const Ctx& c, const Args& p, float rho) {
  Fixed& s = *c.s;
  const int t = threadIdx.x;
  const int pi = t / CW, pg = t % CW;       // this thread's row, columns
  const int H = p.H;
  const float* th = s.misc + 4;
  int cur = 0;

  // terminal value: hT = track_h on pos, eul, v; 0 elsewhere
  for (int e = t; e < N * LD; e += NT) {
    const int i = e / LD, j = e % LD;
    s.V[0][e] = (i == j && i < 9) ? th[i] : 0.0f;
  }
  if (t < N) s.Vx[0][t] = (t < 9 ? th[t] : 0.0f) * (c.Zn[H * N + t]
                                                    - s.refT[t]);
  if (t >= WARP) stage_prep(c, p, s.st[(H - 1) % 2], H - 1, rho);
  __syncthreads();
  K7_SPAN(1);
  for (int k = H - 1; k >= 0; --k) {
    const float* z = c.Zn + k * N;
    const float* u = c.Un + k * N;
    const float* ref = c.Ref + k * 2 * N;
    const StageT& sg = s.st[k % 2];
    // 2. T1 = Vxx Fz (into Y), T2 = Vxx Fu (into W); Qx = g_x + Fz'Vx,
    // Qu = g_u + Fu'Vx. Every product is the dense one with its zero terms
    // left out (the nonzeros of a column of Fz or Fu, ascending), so it
    // rounds as the plain version's dense product does.
    const float* V = s.V[cur];
    const float* Vx = s.Vx[cur];
#pragma unroll 1
    for (int m = 0; m < NM; ++m) {
      const int j = pg + CW * m;
      int qz[4], qu[4];
      const int nz = fz_rows(j, qz), nu = fu_rows(j, qu);
      float t1 = 0.0f, t2 = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < nz) t1 = fmaf(V[qz[e] * LD + pi], sg.zv[j][e], t1);
        if (e < nu) t2 = fmaf(V[qu[e] * LD + pi], sg.uv[j][e], t2);
      }
      s.Y[pi * LD + j] = t1;
      s.W[pi * LD + j] = t2;
    }
    if (t >= NT - 2 * N) {
      const int i = t - (NT - 2 * N);
      const bool x = i < N;
      const int a = x ? i : i - N;
      int q[4];
      const int n = x ? fz_rows(a, q) : fu_rows(a, q);
      const float* v = x ? sg.zv[a] : sg.uv[a];
      float qv = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) qv = fmaf(v[e], Vx[q[e]], qv);
      const float g = x ? th[a] * (z[a] - ref[a]) + gx_add(sg, a)
                        : th[N + a] * (u[a] - ref[N + a]) + gu_add(sg, a);
      s.q[i] = g + qv;
    }
    __syncthreads();
    K7_SPAN(2);

    // 3. Qxx = Fz'T1 + Hxx, Quu = Fu'T2 + Huu, Qux = Fu'T1 + Hux;
    // L = Quu + reg I + state_reg Fu'Fu, R = [Qu | Qux + state_reg Fu'Fz]
    int rz[4], ru[4];
    const int nz = fz_rows(pi, rz), nu = fu_rows(pi, ru);
#pragma unroll 1
    for (int m = 0; m < NM; ++m) {
      const int j = pg + CW * m, ij = pi * LD + j;
      float qxx = 0.0f, quu = 0.0f, qux = 0.0f, ff = 0.0f, fz = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < nz) qxx = fmaf(sg.zv[pi][e], s.Y[rz[e] * LD + j], qxx);
        if (e < nu) {
          const int q = ru[e] * LD + j;
          const float v = sg.uv[pi][e];
          quu = fmaf(v, s.W[q], quu);
          qux = fmaf(v, s.Y[q], qux);
          ff = fmaf(v, sg.Fu[q], ff);
          fz = fmaf(v, sg.Fz[q], fz);
        }
      }
      qxx += hxx(s, sg, pi, j);
      quu += huu(s, sg, pi, j);
      qux += hux(sg, pi, j);
      s.Qxx[ij] = qxx;
      s.Quu[ij] = quu;
      s.Qux[ij] = qux;
      s.L[pi * LDR + j] = quu + ((pi == j ? p.reg : 0.0f)
                                 + p.state_reg * ff);
      s.R[pi * LDR + 1 + j] = qux + p.state_reg * fz;
    }
    if (pg == 0) s.R[pi * LDR] = s.q[N + pi];
    __syncthreads();
    K7_SPAN(3);

    // 4. warp 0: the gains; beside it, the next stage's S, T rows and
    // quadratization
    float* K = c.Kc + k * N * LDR;
    if (t < WARP) gain_solve(s, K, c.kff + k * N);
    else if (k > 0) stage_prep(c, p, s.st[(k - 1) % 2], k - 1, rho);
    __syncthreads();
    K7_SPAN(5);

    // 5. the value update (unregularized Quu, Qux): W = K'Quu, P = K'Qux
    {
      float kq[NM], kp[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) kq[m] = kp[m] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < N; ++q) {
        const float kv = K[q * LDR + pi];
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          kq[m] = fmaf(kv, s.Quu[q * LD + pg + CW * m], kq[m]);
          kp[m] = fmaf(kv, s.Qux[q * LD + pg + CW * m], kp[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        s.W[pi * LD + pg + CW * m] = kq[m];
        s.P[pi * LD + pg + CW * m] = kp[m];
      }
    }
    __syncthreads();
    K7_SPAN(6);

    // 6. Y = Qxx + (K'Quu) K + P + P' (unsymmetrized); Vx2 = Qx + K'Quu kff
    // + K'Qu + Qux' kff
    bool ok = true;
    {
      float xs[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) xs[m] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < N; ++q) {
        const float w = s.W[pi * LD + q];
#pragma unroll
        for (int m = 0; m < NM; ++m)
          xs[m] = fmaf(w, K[q * LDR + pg + CW * m], xs[m]);
      }
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = pg + CW * m, ij = pi * LD + j;
        s.Y[ij] = ((s.Qxx[ij] + xs[m]) + s.P[ij]) + s.P[j * LD + pi];
      }
    }
    const int vi = t - (NT - WARP);           // warp 5's lanes 0..23
    if (vi >= 0 && vi < N) {
      const float* kf = c.kff + k * N;
      float v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
      for (int q = 0; q < N; ++q) {
        v1 = fmaf(s.W[vi * LD + q], kf[q], v1);
        v2 = fmaf(K[q * LDR + vi], s.q[N + q], v2);
        v3 = fmaf(s.Qux[q * LD + vi], kf[q], v3);
      }
      const float vx2 = ((s.q[vi] + v1) + v2) + v3;
      s.Vx[cur ^ 1][vi] = vx2;
      ok = finite(vx2);
    }
    __syncthreads();
    K7_SPAN(7);

    // 7. Vxx2 = (Y + Y') / 2, kept with Vx2 only if both are finite
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int j = pg + CW * m;
      const float v = 0.5f * (s.Y[pi * LD + j] + s.Y[j * LD + pi]);
      s.V[cur ^ 1][pi * LD + j] = v;
      ok = ok && finite(v);
    }
    if (__syncthreads_and(ok)) cur ^= 1;
    K7_SPAN(8);
  }
}

// the forward pass of candidate `a` (one warp, lane r < 24 owns row r) under
// step alpha: its trajectory into its slot; returns its total cost (every
// lane)
__device__ float candidate(const Ctx& c, const Args& p, int a, float alpha,
                           float rho) {
  const Fixed& s = *c.s;
  const int r = threadIdx.x % WARP;
  const int rr = r < N ? r : 0;             // lanes 24..31 shadow lane 0
  const int H = p.H;
  const float* th = s.misc + 4;
  float* Z = c.Zc + (size_t)a * (H + 1) * N;
  float* U = c.Uc + (size_t)a * H * N;
  float z = c.Zn[rr];
  float cost = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float* K = c.Kc + k * N * LDR + rr * LDR;
    const float dz = r < N ? z - c.Zn[k * N + r] : 0.0f;
    float fb = 0.0f;
#pragma unroll 8
    for (int j = 0; j < N; ++j) fb = fmaf(K[j], __shfl_sync(FULL, dz, j), fb);
    if (r < N) {
      const float ur = (c.Un[k * N + r] + alpha * c.kff[k * N + r]) + fb;
      Z[k * N + r] = z;
      U[k * N + r] = ur;
      const float dzr = z - c.Ref[k * 2 * N + r];
      const float dur = ur - c.Ref[k * 2 * N + N + r];
      cost += 0.5f * (th[r] * dzr * dzr + th[N + r] * dur * dur);
    }
    __syncwarp();
    if (r < N) z = dyn_row(Z + k * N, U + k * N, s.iw, r, p.dt, p.s_f,
                           s.misc[53]);
  }
  if (r < N) Z[H * N + r] = z;
  // the feet's costs, off the rollout's chain: a (stage, foot) a lane
  for (int e = r; e < 4 * H; e += WARP) {
    const int k = e / 4, f = e % 4;
    cost += foot_cost(s, Z + k * N, U + k * N, c.Fm[e], f, rho, p.s_f);
  }
  if (r < 9) {
    const float d = z - s.refT[r];
    cost += 0.5f * th[r] * d * d;
  }
  return warp_sum(cost);
}

__global__ void __launch_bounds__(NT)
ci_sweeps(Args p) {
  extern __shared__ float4 smem4[];
  const int H = p.H;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  Ctx c;
  c.s = reinterpret_cast<Fixed*>(smem4);
  c.Kc = reinterpret_cast<float*>(smem4) + sizeof(Fixed) / sizeof(float);
  c.kff = c.Kc + H * N * LDR;
  c.Zn = c.kff + H * N;
  c.Un = c.Zn + (H + 1) * N;
  c.Ref = c.Un + H * N;
  c.Fm = c.Ref + H * 2 * N;
  c.Zc = c.Fm + H * 4;
  c.Uc = c.Zc + NALPHA * (H + 1) * N;
  Fixed& s = *c.s;
  K7_SPANS_BEGIN
  for (int e = t; e < NMISC; e += NT) s.misc[e] = p.misc[e];
  if (t < 9) s.iw[t] = p.iw_inv[(size_t)b * 9 + t];
  if (t < N) s.refT[t] = p.refT[(size_t)b * N + t];
  for (int e = t; e < H * N; e += NT) c.Un[e] = p.uh0[(size_t)b * H * N + e];
  for (int e = t; e < H * 2 * N; e += NT)
    c.Ref[e] = p.ref_zu[(size_t)b * H * 2 * N + e];
  for (int e = t; e < H * 4; e += NT)
    c.Fm[e] = p.f_mask[(size_t)b * H * 4 + e];
  __syncthreads();
  // initial rollout on warp 0
  if (t < WARP) {
    float z = t < N ? p.z0[(size_t)b * N + t] : 0.0f;
    for (int k = 0; k < H; ++k) {
      if (t < N) c.Zn[k * N + t] = z;
      __syncwarp();
      if (t < N) z = dyn_row(c.Zn + k * N, c.Un + k * N, s.iw, t, p.dt,
                             p.s_f, s.misc[53]);
    }
    if (t < N) c.Zn[H * N + t] = z;
  }
  __syncthreads();
  K7_SPAN(0);

  const float lr0 = logf(p.rho0[b]);
  const float lrm = logf(p.rho_min);
  float c_best = INFINITY;
  const int w = t / WARP;
  for (int it = 0; it < p.iters; ++it) {
    const float frac = p.iters > 1 ? (float)it / ((float)p.iters - 1.0f)
                                   : 1.0f;
    const float rho = fmaxf(expf(lr0 + frac * (lrm - lr0)), p.rho_min);
    backward(c, p, rho);
    if (w < NALPHA) {
      const float cw = candidate(c, p, w, ALPHAS[w], rho);
      if (t % WARP == 0) s.ccost[w] = cw;
    }
    __syncthreads();
    K7_SPAN(9);
    // the first strictly smallest finite cost; none: alpha 0, the nominal
    int best = NALPHA - 1;
    c_best = INFINITY;
    for (int a = 0; a < NALPHA; ++a) {
      const float ca = finite(s.ccost[a]) ? s.ccost[a] : INFINITY;
      if (ca < c_best) {
        c_best = ca;
        best = a;
      }
    }
    const float* Zw = c.Zc + (size_t)best * (H + 1) * N;
    const float* Uw = c.Uc + (size_t)best * H * N;
    for (int e = t; e < (H + 1) * N; e += NT) c.Zn[e] = Zw[e];
    for (int e = t; e < H * N; e += NT) c.Un[e] = Uw[e];
    __syncthreads();
    K7_SPAN(10);
  }
  for (int e = t; e < H * N; e += NT) p.U[(size_t)b * H * N + e] = c.Un[e];
  for (int e = t; e < (H + 1) * N; e += NT)
    p.Z[(size_t)b * (H + 1) * N + e] = c.Zn[e];
  if (t == 0) p.cost[b] = c_best;
  K7_SPAN(11);
  K7_SPANS_END
}

}  // namespace

// The largest horizon whose launch fits a block's shared memory.
extern "C" int ci_sweeps_max_h() {
  int H = 0;
  while (smem_bytes(H + 1) <= SMEM_MAX) ++H;
  return H;
}

// The whole sweep loop for B scenarios with horizon H on `stream`; see the
// header for the layouts. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for H outside 1..ci_sweeps_max_h()).
extern "C" int ci_sweeps_launch(const float* z0, const float* uh0,
                                const float* ref_zu, const float* refT,
                                const float* f_mask, const float* rho0,
                                const float* iw_inv, const float* misc,
                                float* U, float* Z, float* cost, int B, int H,
                                int iters, float dt, float s_f, float rho_min,
                                float reg, float state_reg, void* stream) {
  if (B == 0) return 0;
  // raise the dynamic shared-memory limit to the block's share less the
  // kernel's static shared memory once per device, not at every launch (a
  // host call on a host-bound path)
  static size_t limit[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (limit[device] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, ci_sweeps);
    if (err != cudaSuccess) return (int)err;
    const size_t dyn = SMEM_MAX - attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(ci_sweeps,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
    if (err != cudaSuccess) return (int)err;
    limit[device] = dyn;
  }
  if (H < 1 || smem_bytes(H) > limit[device])
    return (int)cudaErrorInvalidValue;
  Args p{z0, uh0, ref_zu, refT, f_mask, rho0, iw_inv, misc, U, Z, cost, H,
         iters, dt, s_f, rho_min, reg, state_reg};
  ci_sweeps<<<B, NT, smem_bytes(H), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
