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
// latency of that chain bounds one scenario, and what an SM holds of them
// bounds a batch. The old design (a warp a scenario, dense products in
// shared memory, six serial forward passes, K and the trajectory in device
// memory) spent 128k cycles a stage-sweep, 40 % of it in the Cholesky and
// the solve (PERF.md).
//
// Two variants, one body (`sweeps<Variant>`) and one shared-memory
// layout: every element of every product, the Cholesky, the solve, each
// candidate and the argmin are the same device functions with the same
// operations in the same order, so the two agree bit for bit; they differ
// only in how many threads a scenario takes and how those split the work.
// The wrapper (ops/ci_kernel.py) launches the batch variant when the batch
// is past the latency variant's one wave and the batch variant holds more
// scenarios an SM at that H (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// ci_sweeps_blocks_per_sm).
// - `ci_sweeps`, the latency variant (B = 1 to a wave): a block of 6 warps
//   (192 threads) a scenario, more of the SM on each scenario. At 149
//   registers a thread, two blocks share an SM: 264 scenarios a wave on
//   132 SMs.
// - `ci_sweeps_batch`, the batch variant (past a wave): a block of 3 warps
//   (96 threads) a scenario and at most 168 registers a thread, so that
//   four blocks share an SM.
// The layout (Fixed below): a block's shared memory holds, for the whole
// launch, the nominal Z and U, the references, the gain cache K (H x 24 x
// 25) and kff (as the TPU kernel keeps them in VMEM), and the stage
// scratch: the 24x24 stage matrices, aliased by lifetime, and one stage's
// Fz, Fu by column (the nonzeros) and feet. The five candidate
// trajectories lie over the stage matrices (dead by then) where they fit
// (H <= 19), else after the rest. 49 KB at H=10, 54 KB at H=12; the
// largest horizon that fits the 227 KB of a block is ci_sweeps_max_h(),
// 54; the wrapper refuses a larger one (the dispatch sends K7 H <= 12).
// Design, both variants:
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
//   PERF.md, tools/k7_accuracy.py.) The warps after warp 0, which wait on
//   its Cholesky, build the next stage's Fz, Fu by column and its feet's
//   quadratization, and then, after a barrier of their own, its Fu'Fu and
//   Fu'Fz (the dense products' terms, read from the columns) into that
//   stage's L and R, to which its step 3 adds the rest in place. Thread t
//   owns row t / CW and columns t % CW + CW m (m < N / CW) of every 24x24
//   result (CW = 8 latency, 4 batch). The three dense products of the
//   value update, K'Quu, (K'Quu) K and K'Qux, are split the same way, 24
//   FMAs an element (K'Quu and K'Qux where N / CW is even: columns
//   (t % CW) N / CW + m, in pairs).
// - The 24x24 Cholesky runs on warp 0 in registers, lane i holding row i,
//   right-looking with shuffles (K4's n <= 32 variant, csrc/chol_factor.cu),
//   sqrtf and a true reciprocal, so a non-positive pivot gives NaN and the
//   stage guard trips. The 25-column triangular solve follows on the same
//   warp, a lane a column, the column in registers, a __syncwarp a step
//   (without it the compiler hoists every load of L and spills).
// - The five line-search candidates run a warp each (batch: warps 0 and 1
//   two each, interleaved; warp 2 runs candidate 2 twice, cheaper than a
//   branch), each writing its trajectory into its own slot: one pass a
//   sweep instead of the old kernel's six. The feet's costs are summed
//   after the rollout, a (stage, foot) a lane. After one block barrier
//   every thread picks the winner by the rule above and the block copies
//   its slot into the nominal, so the committed trajectory is bit for bit
//   the one that was costed.
// - Barriers are __syncthreads (7 a backward stage), one named barrier of
//   the warps after warp 0 (prep_sync, once a stage) and __syncwarp; every
//   thread of a block runs every barrier it is counted in (a block is one
//   scenario, so there is no ragged tail and no early exit).
// - Register arrays are indexed by unrolled constants only (no stack
//   frame, no spills: chip_smoke.py gates on it for both variants).
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
// so the candidates' span is the alpha = 1 warp's pass and its wait; in
// the batch variant warp 0's two rounds).
//   K7_SPAN(0): loads + initial rollout
//   K7_SPAN(1): bwd: terminal value + stage H-1's columns, feet, Fu'Fu
//   K7_SPAN(2): bwd: Vxx Fz, Vxx Fu, Qx, Qu
//   K7_SPAN(3): bwd: Qxx, Quu, Qux + regularized
//   K7_SPAN(4): bwd: Cholesky (beside it the next stage's columns, feet)
//   K7_SPAN(5): bwd: 25-column solve + guard + gain store
//   K7_SPAN(6): bwd: K'Quu, K'Qux
//   K7_SPAN(7): bwd: (K'Quu) K, Vx
//   K7_SPAN(8): bwd: symmetrize + keep
//   K7_SPAN(9): five candidates (batch: two at once on warp 0)
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

// the per-scenario constants and weights every phase reads
struct Consts {
  float refT[N], iw[9], misc[NMISC];
};

// a stage's dynamics Jacobians by column (column c's values at its rows
// fz_rows(c), fu_rows(c)) and its feet's quadratization
struct StageCols {
  float zv[N][4], uv[N][4];
  float hf[4][NHF], gf[4][NGF];
};

// A block's horizon-independent shared memory: the stage matrices by role,
// then what the candidates leave alone. Lifetimes within stage k (steps of
// `backward`): Vxx is read in 2 and must outlive 7 (a rejected update
// keeps it); T1 = Vxx Fz and T2 = Vxx Fu live 2-3; Qxx 3-6; Quu 3-5; Qux
// 3-6; L = Quu + reg I + state_reg Fu'Fu (then its factor) and R = [Qu |
// Qux + state_reg Fu'Fz] 3-4; W = K'Quu and P = K'Qux 5-6; Y = Qxx + K'Quu
// K + P + P' 6-7; the update is written in 7. The warps after warp 0 build
// Fu'Fu and Fu'Fz of stage k - 1 in step 4 of stage k, where stage k - 1's
// L and R go; step 3 of stage k - 1 adds the rest to them in place. So Qxx
// is built in the buffer the update goes to, Y over Quu; the gain systems
// of stages k and k - 1 take the two pairs LR[k % 2] and LR[(k - 1) % 2],
// stage k's W and P lie over its L and R, its T1 and T2 over the other
// pair.
struct Fixed {
  float A[2][N * LD];        // Vxx and Qxx, by turns
  float LR[2][2][N * LDR];   // two pairs of gain systems (L, R), by stage
  float G[N * LD];           // Quu, then Y
  float Hq[N * LD];          // Qux
  float Vx[2][N];
  float q[2 * N];            // Qx, Qu
  float linv[N];             // 1 / L[i][i]
  StageCols st;              // one stage: built after the last read of
                             // the one before
  Consts k;
  float ccost[NALPHA];
  // the stage's columns and feet. Read through this call, not as `st`: a
  // direct read folds st's offset into step 3's loads and compiles the
  // batch variant to other code (with a branch in place of cand_slots'
  // select, 0.6 % slower at B=4096 on an H100)
  __device__ __forceinline__ StageCols& stage() { return st; }
};

// How a variant maps a scenario onto its block: NT threads; thread t owns
// row t / CW and columns t % CW + CW m (m < N / CW) of every 24x24 result;
// threads 0..CT-1 of the warps that build a stage run its columns,
// threads QF..QF+3 its feet; steps 2 and 3 unroll MU columns.
struct Latency {
  static constexpr int NT = 192;        // 6 warps
  static constexpr int CW = 8;
  static constexpr int CT = 2 * N;
  static constexpr int QF = 4 * WARP;
  static constexpr int MU = 1;
};

struct Batch {
  static constexpr int NT = 96;         // 3 warps
  static constexpr int CW = 4;
  static constexpr int CT = WARP;
  static constexpr int QF = WARP;
  static constexpr int MU = N / CW;
  static constexpr int MIN_BLOCKS = 4;  // an SM: registers <= 168
};

// floats of the stage matrices the candidates lie over
constexpr size_t SCRATCH = 4 * N * LD + 4 * N * LDR;

// floats of five candidate (Z, U)
__host__ __device__ constexpr size_t cand_floats(int H) {
  return (size_t)NALPHA * ((H + 1) * N + H * N);
}

// floats of the horizon-dependent part kept for the launch: K cache, kff,
// nominal Z and U, references, foot masks
__host__ __device__ constexpr size_t kept_floats(int H) {
  return (size_t)H * N * LDR + (size_t)H * N + (size_t)(H + 1) * N
         + (size_t)H * N + (size_t)H * 2 * N + (size_t)H * 4;
}

// the candidates lie over the stage scratch where they fit
__host__ __device__ constexpr bool cand_over_scratch(int H) {
  return cand_floats(H) <= SCRATCH;
}

// the candidates' slots: over the stage scratch where they fit, else
// `after` (computed by the caller, so that the choice is a select)
__device__ __forceinline__ float* cand_slots(Fixed& s, float* after, int H) {
  return cand_over_scratch(H) ? s.A[0] : after;
}

// a launch's dynamic shared memory a block
__host__ __device__ constexpr size_t smem_bytes(int H) {
  return sizeof(Fixed) + (kept_floats(H) + (cand_over_scratch(H)
                                            ? 0 : cand_floats(H)))
                         * sizeof(float);
}

// per-foot Hessian entries in StageCols::hf
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
__device__ float foot_cost(const Consts& s, const float* z, const float* u,
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
__device__ void quad_foot(const Consts& s, StageCols& st, const float* z,
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
__device__ __forceinline__ float hxx(const Consts& s, const StageCols& g,
                                     int i, int j) {
  if (i != j) return 0.0f;
  const float v = s.misc[4 + i];
  return (i >= 14 && (i - 14) % 3 == 0) ? v + g.hf[(i - 14) / 3][H_PZ] : v;
}

__device__ float huu(const Consts& s, const StageCols& g, int i, int j) {
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

__device__ __forceinline__ float hux(const StageCols& g, int i, int j) {
  return (i < 12 && i % 3 == 2 && j == 12 + i) ? g.hf[i / 3][E_PZFZ]
                                                : 0.0f;
}

// the gradient's foot adds of z row i and u row i
__device__ __forceinline__ float gx_add(const StageCols& g, int i) {
  return (i >= 14 && (i - 14) % 3 == 0) ? g.gf[(i - 14) / 3][0] : 0.0f;
}

__device__ __forceinline__ float gu_add(const StageCols& g, int i) {
  if (i < 12) return g.gf[i / 3][1 + i % 3];
  const int c = (i - 12) % 3;
  return c < 2 ? g.gf[(i - 12) / 3][4 + c] : 0.0f;
}

// warp 0: the Cholesky of L in registers (lane i holds row i), then
// L L' X = R a lane per column, the stage guard, and the gains into K
// (24 x LDR) and kff
__device__ void gain_solve(float* L, const float* R, float* linv, float* K,
                           float* kff) {
  const int i = threadIdx.x;
  float a[N];
#pragma unroll
  for (int q = 0; q < N; ++q)
    a[q] = (i < N && q <= i) ? L[i * LDR + q] : 0.0f;
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
      if (q <= i) L[i * LDR + q] = a[q];
    linv[i] = own_inv;
  }
  __syncwarp();
  K7_SPAN(4);
  // a lane a column of R (lanes 25..31 repeat column 24); a __syncwarp a
  // step keeps the compiler from hoisting every load of L into registers
  const int col = i < N + 1 ? i : N;
  float x[N];
  bool ok = true;
#pragma unroll
  for (int r = 0; r < N; ++r) x[r] = R[r * LDR + col];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    __syncwarp();
    x[j] *= linv[j];
#pragma unroll
    for (int r = j + 1; r < N; ++r) x[r] -= L[r * LDR + j] * x[j];
  }
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    __syncwarp();
    x[j] *= linv[j];
#pragma unroll
    for (int r = 0; r < j; ++r) x[r] -= L[j * LDR + r] * x[j];
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
__device__ float fz_entry(const Consts& s, const float* z, const float* u,
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

__device__ float fu_entry(const Consts& s, const float* z, int q, int c,
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

// a barrier of the NT - WARP threads after warp 0 of a block of NT
// (named barrier 1; __syncthreads is 0)
template <int NT>
__device__ __forceinline__ void prep_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(NT - WARP) : "memory");
}

// (Fu'Fu)(pi, j) and (Fu'Fz)(pi, j) from stage st's columns: the sums over
// the rows of Fu's column pi, ascending (fu_rows), of uv[pi][i] times the
// entry of Fu, Fz at (that row, j), term for term as the dense products
// sum them; an entry off column j's rows
// (fu_rows(j), fz_rows(j)) is the dense matrices' exact 0
__device__ __forceinline__ void fu_products(const StageCols& st, int pi,
                                            int j, float& ff, float& fz) {
  ff = 0.0f;
  fz = 0.0f;
  if (pi >= 12) {              // row pi alone: Fu, Fz nonzero at (pi, pi)
    const float v = st.uv[pi][0];
    ff = fmaf(v, j == pi ? st.uv[j][0] : 0.0f, ff);
    fz = fmaf(v, j == pi ? st.zv[j][3] : 0.0f, fz);
    return;
  }
  // row 6 + pi % 3: Fu's at the forces of the same axis, Fz's at column
  // 6 + pi % 3 (pos <- v)
  const float v0 = st.uv[pi][0];
  ff = fmaf(v0, (j < 12 && j % 3 == pi % 3) ? st.uv[j][0] : 0.0f, ff);
  fz = fmaf(v0, j == 6 + pi % 3 ? st.zv[j][1] : 0.0f, fz);
  // rows 9, 10, 11: Fu's at every force; Fz's at pos (j < 3), at the feet
  // (j >= 12) and on the diagonal
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float v = st.uv[pi][i];
    ff = fmaf(v, j < 12 ? st.uv[j][i] : 0.0f, ff);
    const float zr = j < 3 ? st.zv[j][i]
                   : j >= 12 ? st.zv[j][i - 1]
                   : j == 8 + i ? st.zv[j][1] : 0.0f;
    fz = fmaf(v, zr, fz);
  }
}

// the values of column i of Fz (i < N) or of Fu (i - N) of the stage
// (z, u) at the rows that can be nonzero, into st
__device__ __forceinline__ void column_values(const Consts& s, StageCols& st,
                                              const float* z, const float* u,
                                              int i, float dt, float s_f) {
  const bool x = i < N;
  const int col = x ? i : i - N;
  int q[4] = {0, 0, 0, 0};
  const int n = x ? fz_rows(col, q) : fu_rows(col, q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v = 0.0f;
    if (e < n) v = x ? fz_entry(s, z, u, q[e], col, dt, s_f)
                     : fu_entry(s, z, q[e], col, dt, s_f);
    (x ? st.zv : st.uv)[col][e] = v;
  }
}

// the warps after warp 0: stage k's Jacobians by column (the rows that can
// be nonzero, ascending) and its feet's quadratization into st, then,
// after a barrier of their own, Fu'Fu and Fu'Fz (the dense products, term
// for term) into stage k's L and R
template <class Var>
__device__ void stage_prep(const Ctx& c, const Args& p, int k, float rho) {
  Fixed& f = *c.s;
  const Consts& s = f.k;
  StageCols& st = f.stage();
  const int t = threadIdx.x - WARP;
  const float dt = p.dt, s_f = p.s_f;
  const float* z = c.Zn + k * N;
  const float* u = c.Un + k * N;
  if (t < Var::CT) {
    for (int i = t; i < 2 * N; i += Var::CT)
      column_values(s, st, z, u, i, dt, s_f);
  } else if (t >= Var::QF && t < Var::QF + 4) {
    const int ft = t - Var::QF;
    quad_foot(s, st, z, u, c.Fm[k * 4 + ft], ft, rho, s_f);
  }
  prep_sync<Var::NT>();
  float* FF = f.LR[k & 1][0];
  float* FZ = f.LR[k & 1][1];
  for (int e = t; e < N * N; e += Var::NT - WARP) {
    const int pi = e / N, j = e % N;
    float ff, fz;
    fu_products(st, pi, j, ff, fz);
    FF[pi * LDR + j] = ff;
    FZ[pi * LDR + 1 + j] = fz;
  }
}

// one backward Riccati pass over the H stages at relaxation rho: the gains
// into c.Kc, c.kff
template <class Var>
__device__ void backward(const Ctx& c, const Args& p, float rho) {
  constexpr int NT = Var::NT, CW = Var::CW, NM = N / CW;
  Fixed& f = *c.s;
  const Consts& s = f.k;
  float* const Y = f.G;
  float* const Quu = f.G;
  float* const Qux = f.Hq;
  const int t = threadIdx.x;
  const int pi = t / CW, pg = t % CW;       // this thread's row, columns
  const int H = p.H;
  const float* th = s.misc + 4;
  int cur = 0;

  // terminal value: hT = track_h on pos, eul, v; 0 elsewhere
  for (int e = t; e < N * LD; e += NT) {
    const int i = e / LD, j = e % LD;
    f.A[0][e] = (i == j && i < 9) ? th[i] : 0.0f;
  }
  if (t < N) f.Vx[0][t] = (t < 9 ? th[t] : 0.0f) * (c.Zn[H * N + t]
                                                    - s.refT[t]);
  if (t >= WARP) stage_prep<Var>(c, p, H - 1, rho);
  __syncthreads();
  K7_SPAN(1);
  for (int k = H - 1; k >= 0; --k) {
    const float* z = c.Zn + k * N;
    const float* u = c.Un + k * N;
    const float* ref = c.Ref + k * 2 * N;
    const StageCols& sg = f.stage();
    float* const T1 = f.LR[(k & 1) ^ 1][0];
    float* const T2 = f.LR[(k & 1) ^ 1][1];
    float* const L = f.LR[k & 1][0];
    float* const R = f.LR[k & 1][1];
    float* const W = L;
    float* const P = R;
    // 2. T1 = Vxx Fz, T2 = Vxx Fu; Qx = g_x + Fz'Vx, Qu = g_u + Fu'Vx.
    // Every product is the dense one with its zero terms left out (the
    // nonzeros of a column of Fz or Fu, ascending), so it rounds as the
    // plain version's dense product does.
    const float* V = f.A[cur];
    const float* Vx = f.Vx[cur];
#pragma unroll (Var::MU)
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
      T1[pi * LD + j] = t1;
      T2[pi * LD + j] = t2;
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
      f.q[i] = g + qv;
    }
    __syncthreads();
    K7_SPAN(2);

    // 3. Qxx = Fz'T1 + Hxx, Quu = Fu'T2 + Huu, Qux = Fu'T1 + Hux;
    // L = Quu + reg I + state_reg Fu'Fu, R = [Qu | Qux + state_reg Fu'Fz]
    // (Fu'Fu, Fu'Fz already in L, R)
    float* Qxx = f.A[cur ^ 1];
    int rz[4], ru[4];
    const int nz = fz_rows(pi, rz), nu = fu_rows(pi, ru);
#pragma unroll (Var::MU)
    for (int m = 0; m < NM; ++m) {
      const int j = pg + CW * m, ij = pi * LD + j;
      float qxx = 0.0f, quu = 0.0f, qux = 0.0f;
      const float ff = L[pi * LDR + j], fz = R[pi * LDR + 1 + j];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e < nz) qxx = fmaf(sg.zv[pi][e], T1[rz[e] * LD + j], qxx);
        if (e < nu) {
          const int q = ru[e] * LD + j;
          const float v = sg.uv[pi][e];
          quu = fmaf(v, T2[q], quu);
          qux = fmaf(v, T1[q], qux);
        }
      }
      qxx += hxx(s, sg, pi, j);
      quu += huu(s, sg, pi, j);
      qux += hux(sg, pi, j);
      Qxx[ij] = qxx;
      Quu[ij] = quu;
      Qux[ij] = qux;
      L[pi * LDR + j] = quu + ((pi == j ? p.reg : 0.0f)
                               + p.state_reg * ff);
      R[pi * LDR + 1 + j] = qux + p.state_reg * fz;
    }
    if (pg == 0) R[pi * LDR] = f.q[N + pi];
    __syncthreads();
    K7_SPAN(3);

    // 4. warp 0: the gains; beside it, the next stage's columns, feet,
    // Fu'Fu and Fu'Fz
    float* K = c.Kc + k * N * LDR;
    if (t < WARP) gain_solve(L, R, f.linv, K, c.kff + k * N);
    else if (k > 0) stage_prep<Var>(c, p, k - 1, rho);
    __syncthreads();
    K7_SPAN(5);

    // 5. the value update (unregularized Quu, Qux): W = K'Quu, P = K'Qux
    if constexpr (NM % 2 == 0) {
      // a thread's columns side by side, read and written in pairs
      const int c0 = pg * NM;
      float kq[NM], kp[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) kq[m] = kp[m] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < N; ++q) {
        const float kv = K[q * LDR + pi];
        const float2* qa = reinterpret_cast<const float2*>(Quu + q * LD + c0);
        const float2* qb = reinterpret_cast<const float2*>(Qux + q * LD + c0);
#pragma unroll
        for (int h = 0; h < NM / 2; ++h) {
          const float2 a = qa[h], b2 = qb[h];
          kq[2 * h] = fmaf(kv, a.x, kq[2 * h]);
          kq[2 * h + 1] = fmaf(kv, a.y, kq[2 * h + 1]);
          kp[2 * h] = fmaf(kv, b2.x, kp[2 * h]);
          kp[2 * h + 1] = fmaf(kv, b2.y, kp[2 * h + 1]);
        }
      }
      float2* wa = reinterpret_cast<float2*>(W + pi * LD + c0);
      float2* pa = reinterpret_cast<float2*>(P + pi * LD + c0);
#pragma unroll
      for (int h = 0; h < NM / 2; ++h) {
        wa[h] = make_float2(kq[2 * h], kq[2 * h + 1]);
        pa[h] = make_float2(kp[2 * h], kp[2 * h + 1]);
      }
    } else {
      float kq[NM], kp[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) kq[m] = kp[m] = 0.0f;
#pragma unroll 4
      for (int q = 0; q < N; ++q) {
        const float kv = K[q * LDR + pi];
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          kq[m] = fmaf(kv, Quu[q * LD + pg + CW * m], kq[m]);
          kp[m] = fmaf(kv, Qux[q * LD + pg + CW * m], kp[m]);
        }
      }
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        W[pi * LD + pg + CW * m] = kq[m];
        P[pi * LD + pg + CW * m] = kp[m];
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
        const float w = W[pi * LD + q];
#pragma unroll
        for (int m = 0; m < NM; ++m)
          xs[m] = fmaf(w, K[q * LDR + pg + CW * m], xs[m]);
      }
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int j = pg + CW * m, ij = pi * LD + j;
        Y[ij] = ((Qxx[ij] + xs[m]) + P[ij]) + P[j * LD + pi];
      }
    }
    const int vi = t - (NT - WARP);           // the last warp's lanes 0..23
    if (vi >= 0 && vi < N) {
      const float* kf = c.kff + k * N;
      float v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
      for (int q = 0; q < N; ++q) {
        v1 = fmaf(W[vi * LD + q], kf[q], v1);
        v2 = fmaf(K[q * LDR + vi], f.q[N + q], v2);
        v3 = fmaf(Qux[q * LD + vi], kf[q], v3);
      }
      const float vx2 = ((f.q[vi] + v1) + v2) + v3;
      f.Vx[cur ^ 1][vi] = vx2;
      ok = finite(vx2);
    }
    __syncthreads();
    K7_SPAN(7);

    // 7. Vxx2 = (Y + Y') / 2, kept with Vx2 only if both are finite
    float* Vn = f.A[cur ^ 1];
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const int j = pg + CW * m;
      const float v = 0.5f * (Y[pi * LD + j] + Y[j * LD + pi]);
      Vn[pi * LD + j] = v;
      ok = ok && finite(v);
    }
    if (__syncthreads_and(ok)) cur ^= 1;
    K7_SPAN(8);
  }
}

// the forward passes of the NC candidates a[i] on one warp, interleaved
// (lane r < 24 owns row r of each) under step ALPHAS[a[i]]: each trajectory
// into its slot, each total cost into ccost[a[i]]
template <int NC>
__device__ void candidates(const Ctx& c, const Args& p,
                           const int (&a)[NC], float rho) {
  const Consts& s = c.s->k;
  const int r = threadIdx.x % WARP;
  const int rr = r < N ? r : 0;             // lanes 24..31 shadow lane 0
  const int H = p.H;
  const float* th = s.misc + 4;
  float* Z[NC];
  float* U[NC];
  float alpha[NC], z[NC], cost[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    Z[i] = c.Zc + (size_t)a[i] * (H + 1) * N;
    U[i] = c.Uc + (size_t)a[i] * H * N;
    alpha[i] = ALPHAS[a[i]];
    z[i] = c.Zn[rr];
    cost[i] = 0.0f;
  }
  for (int k = 0; k < H; ++k) {
    const float* K = c.Kc + k * N * LDR + rr * LDR;
    float dz[NC], fb[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      dz[i] = r < N ? z[i] - c.Zn[k * N + r] : 0.0f;
      fb[i] = 0.0f;
    }
#pragma unroll 8
    for (int j = 0; j < N; ++j) {
      const float kj = K[j];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        fb[i] = fmaf(kj, __shfl_sync(FULL, dz[i], j), fb[i]);
    }
    if (r < N) {
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float ur = (c.Un[k * N + r] + alpha[i] * c.kff[k * N + r])
                         + fb[i];
        Z[i][k * N + r] = z[i];
        U[i][k * N + r] = ur;
        const float dzr = z[i] - c.Ref[k * 2 * N + r];
        const float dur = ur - c.Ref[k * 2 * N + N + r];
        cost[i] += 0.5f * (th[r] * dzr * dzr + th[N + r] * dur * dur);
      }
    }
    __syncwarp();
    if (r < N) {
#pragma unroll
      for (int i = 0; i < NC; ++i)
        z[i] = dyn_row(Z[i] + k * N, U[i] + k * N, s.iw, r, p.dt, p.s_f,
                       s.misc[53]);
    }
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (r < N) Z[i][H * N + r] = z[i];
    // the feet's costs, off the rollout's chain: a (stage, foot) a lane
    for (int e = r; e < 4 * H; e += WARP) {
      const int k = e / 4, f = e % 4;
      cost[i] += foot_cost(s, Z[i] + k * N, U[i] + k * N, c.Fm[e], f, rho,
                           p.s_f);
    }
    if (r < 9) {
      const float d = z[i] - s.refT[r];
      cost[i] += 0.5f * th[r] * d * d;
    }
    const float total = warp_sum(cost[i]);
    if (r == 0) c.s->ccost[a[i]] = total;
  }
}

// the whole launch for scenario blockIdx.x, its shared memory at `base`
template <class Var>
__device__ __forceinline__ void sweeps(const Args& p, float* base) {
  constexpr int NT = Var::NT, NW = NT / WARP;
  constexpr int NC = (NALPHA + NW - 1) / NW;   // candidates a warp
  const int H = p.H;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  Ctx c;
  c.s = reinterpret_cast<Fixed*>(base);
  c.Kc = base + sizeof(Fixed) / sizeof(float);
  c.kff = c.Kc + H * N * LDR;
  c.Zn = c.kff + H * N;
  c.Un = c.Zn + (H + 1) * N;
  c.Ref = c.Un + H * N;
  c.Fm = c.Ref + H * 2 * N;
  c.Zc = cand_slots(*c.s, c.Fm + H * 4, H);
  c.Uc = c.Zc + NALPHA * (H + 1) * N;
  Consts& s = c.s->k;
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
    backward<Var>(c, p, rho);
    // candidates w, w + NW, ... on warp w, interleaved (where the last
    // round leaves warp w none, it runs a copy of its first: the same
    // values into the same slot; skipping that round, by a one-candidate
    // call or by predication, made the batch variant 3-7 % slower on an
    // H100)
    if (w < NALPHA) {
      int a[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        a[i] = w + i * NW < NALPHA ? w + i * NW : w;
      candidates<NC>(c, p, a, rho);
    }
    __syncthreads();
    K7_SPAN(9);
    // the first strictly smallest finite cost; none: alpha 0, the nominal
    int best = NALPHA - 1;
    c_best = INFINITY;
    for (int a = 0; a < NALPHA; ++a) {
      const float ca = finite(c.s->ccost[a]) ? c.s->ccost[a] : INFINITY;
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

__global__ void __launch_bounds__(Latency::NT)
ci_sweeps(Args p) {
  extern __shared__ float4 smem4[];
  sweeps<Latency>(p, reinterpret_cast<float*>(smem4));
}

__global__ void __launch_bounds__(Batch::NT, Batch::MIN_BLOCKS)
ci_sweeps_batch(Args p) {
  extern __shared__ float4 smem4[];
  sweeps<Batch>(p, reinterpret_cast<float*>(smem4));
}

}  // namespace

// The largest horizon whose launch fits a block's shared memory (either
// variant's: they share the layout).
extern "C" int ci_sweeps_max_h() {
  int H = 0;
  while (smem_bytes(H + 1) <= SMEM_MAX) ++H;
  return H;
}

namespace {

// variant 0: ci_sweeps (latency), 1: ci_sweeps_batch
const void* kernel_of(int batch) {
  return batch ? reinterpret_cast<const void*>(ci_sweeps_batch)
               : reinterpret_cast<const void*>(ci_sweeps);
}

// Raise a variant's dynamic shared-memory limit to the block's share less
// the kernel's static shared memory, once per device, not at every launch
// (a host call on a host-bound path); the limit into *limit.
int smem_limit(int batch, size_t* limit) {
  static size_t cache[2][MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (cache[batch][device] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel_of(batch));
    if (err != cudaSuccess) return (int)err;
    const size_t dyn = SMEM_MAX - attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel_of(batch),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dyn);
    if (err != cudaSuccess) return (int)err;
    cache[batch][device] = dyn;
  }
  *limit = cache[batch][device];
  return 0;
}

int launch(int batch, const float* z0, const float* uh0, const float* ref_zu,
           const float* refT, const float* f_mask, const float* rho0,
           const float* iw_inv, const float* misc, float* U, float* Z,
           float* cost, int B, int H, int iters, float dt, float s_f,
           float rho_min, float reg, float state_reg, void* stream) {
  if (B == 0) return 0;
  size_t limit = 0;
  const int err = smem_limit(batch, &limit);
  if (err != 0) return err;
  if (H < 1 || smem_bytes(H) > limit) return (int)cudaErrorInvalidValue;
  Args p{z0, uh0, ref_zu, refT, f_mask, rho0, iw_inv, misc, U, Z, cost, H,
         iters, dt, s_f, rho_min, reg, state_reg};
  if (batch)
    ci_sweeps_batch<<<B, Batch::NT, smem_bytes(H), (cudaStream_t)stream>>>(
        p);
  else
    ci_sweeps<<<B, Latency::NT, smem_bytes(H), (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// The whole sweep loop for B scenarios with horizon H on `stream`, by the
// latency variant (ci_sweeps_launch) or the batch variant
// (ci_sweeps_batch_launch); see the header for the layout. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for H outside
// 1..ci_sweeps_max_h()).
extern "C" int ci_sweeps_launch(const float* z0, const float* uh0,
                                const float* ref_zu, const float* refT,
                                const float* f_mask, const float* rho0,
                                const float* iw_inv, const float* misc,
                                float* U, float* Z, float* cost, int B, int H,
                                int iters, float dt, float s_f, float rho_min,
                                float reg, float state_reg, void* stream) {
  return launch(0, z0, uh0, ref_zu, refT, f_mask, rho0, iw_inv, misc, U, Z,
                cost, B, H, iters, dt, s_f, rho_min, reg, state_reg, stream);
}

extern "C" int ci_sweeps_batch_launch(const float* z0, const float* uh0,
                                      const float* ref_zu, const float* refT,
                                      const float* f_mask, const float* rho0,
                                      const float* iw_inv, const float* misc,
                                      float* U, float* Z, float* cost, int B,
                                      int H, int iters, float dt, float s_f,
                                      float rho_min, float reg,
                                      float state_reg, void* stream) {
  return launch(1, z0, uh0, ref_zu, refT, f_mask, rho0, iw_inv, misc, U, Z,
                cost, B, H, iters, dt, s_f, rho_min, reg, state_reg, stream);
}

// The blocks (scenarios) of a variant (batch 0 or 1) resident on one SM of
// the current device at horizon H, into *blocks (0 where H does not fit).
extern "C" int ci_sweeps_blocks_per_sm(int H, int batch, int* blocks) {
  size_t limit = 0;
  const int err = smem_limit(batch, &limit);
  if (err != 0) return err;
  *blocks = 0;
  if (H < 1 || smem_bytes(H) > limit) return 0;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of(batch), batch ? Batch::NT : Latency::NT,
      smem_bytes(H));
}
