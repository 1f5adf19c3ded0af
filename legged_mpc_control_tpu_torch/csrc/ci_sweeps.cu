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
//     analytic dynamics Jacobians Fz, Fu, the gains from the Levenberg-
//     regularized Quu + reg I + state_reg Fu'Fu by a 24x24 Cholesky and a
//     24x25 triangular solve, a per-scenario guard that zeroes a stage whose
//     gains are not finite and keeps (Vx, Vxx) when the update is not,
//   * a line search over alpha in (1, 0.5, 0.25, 0.05, 0): five forward
//     passes with feedback, each costed on its own trajectory; the first
//     strictly smallest finite cost wins, and a scenario whose candidates
//     are all non-finite keeps its nominal (alpha 0), as the TPU kernel does;
//     then a sixth, committing forward pass.
// The relaxation anneals rho = max(exp(log rho0 + frac (log rho_min -
// log rho0)), rho_min), frac = it / (iters - 1).
//
// Layout: batch-first, scenario-major. Inputs z0 (B,24), uh0 (B,H,24)
// scaled inputs, ref_zu (B,H,48), refT (B,24), f_mask (B,H,4), rho0 (B),
// iw_inv (B,3,3), misc (54) = [c_fb, c_slip, c_cone, c_mask, track_h(48),
// mu, mass]. Outputs U (B,H,24) scaled, Z (B,H+1,24), cost (B). Scratch kff
// (B,H,24) and the gain cache K (B,H,24,24), about 26 KB a scenario (6.7 MB
// at B=256: it stays in L2).
//
// Design. The TPU kernel put 128 scenarios on the vector lanes and unrolled
// every contraction; one thread per scenario on the card would leave 8 warps
// for 132 SMs at B=256 and one thread for the whole solve at B=1. Here one
// warp (a 32-thread block) owns a scenario: lane r owns row r of the stage
// matrices (r < 24), which live in shared memory (about 25 KB a block), and
// synchronizes with __syncwarp only. A matrix product C = A B has lane r
// hold row r of A (a column of A^T) in registers and read B's rows as
// broadcast float4 loads: 576 FMAs a lane. The Jacobians Fz, Fu are built
// densely (the plain version's formulation), so a stage costs ten 24^3
// products, a 24^3/3 Cholesky (24 column steps, two __syncwarp each) and the
// 25-column solve (a lane per column, no barrier).
//
// What bounds it on an H100: about 3.2 MFLOP a scenario a sweep, 20 GFLOP
// for B=256 and 24 sweeps, 0.3 ms at 67 TFLOP/s; it moves 1.4 MB. One warp
// per scenario at B=256 is two warps an SM, so latency (dependent shared-
// memory loads and barriers), not either roof, is what this simple kernel
// meets. Several scenarios a block and wgmma on the stage products are the
// levers of a later change.
//
// Numerics as the TPU kernel: sign(0) = 0 (the cone rows of every swing foot
// of the template), softplus = max(x, 0) + log1p(exp(-|x|)), sigmoid =
// 1 / (1 + exp(-x)); the Cholesky pivot uses sqrtf and a true reciprocal.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N = 24;            // NZ = NU
constexpr int LD = 24;           // leading dimension of the 24x24 buffers
constexpr int LDS = 25;          // of the 24x25 right-hand side / solution
constexpr int NALPHA = 5;
constexpr float F0 = 50.0f;
constexpr float G0 = 0.02f;
constexpr float GRAV = 9.81f;
constexpr int NMISC = 54;

__device__ __constant__ float ALPHAS[NALPHA] = {1.0f, 0.5f, 0.25f, 0.05f,
                                                0.0f};

struct __align__(16) Smem {
  float Vxx[N * LD], Fz[N * LD], Fu[N * LD], T1[N * LD], T2[N * LD];
  float Qxx[N * LD], Quu[N * LD], Qux[N * LD], Kb[N * LD];
  float S[N * LDS];
  float Vx[N], Vx2[N], q[2 * N], z[N], u[N], dz[N], rz[2 * N], kf[N];
  float hf[4][12];
  float fm[4];
  float iw[9];
  float misc[NMISC];
};

// per-foot Hessian entries in Smem::hf
enum { H_PZ, H_FX, H_FY, H_FZ, H_W, E_PZFZ, E_FXFZ, E_FYFZ, E_FZWX, E_FZWY };

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

// out = a^T B for a (24) in registers and B (24 x 24, ld LD) in shared
// memory: lane r passes row r of the left factor
__device__ __forceinline__ void row_mul(const float (&a)[N], const float* B,
                                        float (&out)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float ak = a[k];
    const float4* Bk = reinterpret_cast<const float4*>(B + k * LD);
#pragma unroll
    for (int j4 = 0; j4 < N / 4; ++j4) {
      const float4 b = Bk[j4];
      out[4 * j4 + 0] = fmaf(ak, b.x, out[4 * j4 + 0]);
      out[4 * j4 + 1] = fmaf(ak, b.y, out[4 * j4 + 1]);
      out[4 * j4 + 2] = fmaf(ak, b.z, out[4 * j4 + 2]);
      out[4 * j4 + 3] = fmaf(ak, b.w, out[4 * j4 + 3]);
    }
  }
}

__device__ __forceinline__ void load_col(const float* A, int c,
                                         float (&a)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = A[k * LD + c];
}

__device__ __forceinline__ void load_row(const float* A, int r,
                                         float (&a)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = A[r * LD + k];
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// one SRB+feet step, row r of z' from sm.z and sm.u (== ci_mpc._dyn_b)
__device__ float dyn_row(const Smem& sm, int r, float dt, float s_f,
                         float mass) {
  const float* z = sm.z;
  const float* u = sm.u;
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
    float tau[3] = {0.0f, 0.0f, 0.0f};
    for (int f = 0; f < 4; ++f) {
      const float rx = z[12 + 3 * f] - z[0], ry = z[13 + 3 * f] - z[1],
                  rz = z[14 + 3 * f] - z[2];
      const float fx = s_f * u[3 * f], fy = s_f * u[3 * f + 1],
                  fz = s_f * u[3 * f + 2];
      tau[0] += ry * fz - rz * fy;
      tau[1] += rz * fx - rx * fz;
      tau[2] += rx * fy - ry * fx;
    }
    const int i = r - 9;
    const float w = sm.iw[3 * i] * tau[0] + sm.iw[3 * i + 1] * tau[1]
                    + sm.iw[3 * i + 2] * tau[2];
    return z[r] + dt * w;
  }
  return z[r] + dt * u[r];
}

// the per-foot complementarity cost of foot f at the stage in sm.z, sm.u
__device__ float foot_cost(const Smem& sm, int f, float rho, float s_f) {
  const float c_fb = sm.misc[0], c_slip = sm.misc[1], c_cone = sm.misc[2],
              c_mask = sm.misc[3], mu = sm.misc[52];
  const float fx = s_f * sm.u[3 * f], fy = s_f * sm.u[3 * f + 1],
              fz = s_f * sm.u[3 * f + 2];
  const float w0 = sm.u[12 + 3 * f], w1 = sm.u[13 + 3 * f];
  const float a = fz / F0;
  const float b = sm.z[14 + 3 * f] / G0;
  const float r1 = a + b - sqrtf(a * a + b * b + rho * rho);
  const float spa = rho * softplus(a / rho);
  const float t4 = (fabsf(fx) - mu * fz) / F0;
  const float t5 = (fabsf(fy) - mu * fz) / F0;
  const float sp4 = rho * softplus(t4 / rho), sp5 = rho * softplus(t5 / rho);
  const float r6 = (1.0f - sm.fm[f]) * a;
  return c_fb * r1 * r1 + c_slip * spa * (w0 * w0 + w1 * w1)
         + c_cone * (sp4 * sp4 + sp5 * sp5) + c_mask * r6 * r6;
}

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
  float* kff;
  float* K;
  int H, iters;
  float dt, s_f, rho_min, reg, state_reg;
};

// forward pass with feedback under step `alpha`; returns the total cost
// (every lane); commit writes the trajectory into Z, U
__device__ float forward(Smem& sm, const Args& p, int b, float alpha,
                         float rho, bool commit) {
  const int r = threadIdx.x;
  const int H = p.H;
  const float* z0 = p.z0 + (size_t)b * N;
  float* Z = p.Z + (size_t)b * (H + 1) * N;
  float* U = p.U + (size_t)b * H * N;
  const float* kff = p.kff + (size_t)b * H * N;
  const float* K = p.K + (size_t)b * H * N * N;
  const float* ref = p.ref_zu + (size_t)b * H * 2 * N;
  const float* fm = p.f_mask + (size_t)b * H * 4;
  const float* th = sm.misc + 4;
  if (r < N) sm.z[r] = z0[r];
  float cost = 0.0f;
  for (int k = 0; k < H; ++k) {
    __syncwarp();
    float zr = 0.0f;
    if (r < N) {
      zr = sm.z[r];
      sm.dz[r] = zr - Z[k * N + r];
    }
    if (r < 4) sm.fm[r] = fm[k * 4 + r];
    __syncwarp();
    if (r < N) {
      const float* Kr = K + ((size_t)k * N + r) * N;
      float fb = 0.0f;
      for (int j = 0; j < N; ++j) fb = fmaf(Kr[j], sm.dz[j], fb);
      const float ur = (U[k * N + r] + alpha * kff[k * N + r]) + fb;
      sm.u[r] = ur;
      if (commit) {
        Z[k * N + r] = zr;
        U[k * N + r] = ur;
      }
      const float dzr = zr - ref[k * 2 * N + r];
      const float dur = ur - ref[k * 2 * N + N + r];
      cost += 0.5f * (th[r] * dzr * dzr + th[N + r] * dur * dur);
    }
    __syncwarp();
    if (r < 4) cost += foot_cost(sm, r, rho, p.s_f);
    float zn = 0.0f;
    if (r < N) zn = dyn_row(sm, r, p.dt, p.s_f, sm.misc[53]);
    __syncwarp();
    if (r < N) sm.z[r] = zn;
  }
  __syncwarp();
  if (r < 9) {
    const float d = sm.z[r] - p.refT[(size_t)b * N + r];
    cost += 0.5f * th[r] * d * d;
  }
  if (commit && r < N) Z[H * N + r] = sm.z[r];
  return warp_sum(cost);
}

// the flat-terrain quadratization of foot f (lane f < 4): gradient adds into
// sm.q, Hessian entries into sm.hf[f]
__device__ void quad_foot(Smem& sm, int f, float rho, float s_f) {
  const float c_fb = sm.misc[0], c_slip = sm.misc[1], c_cone = sm.misc[2],
              c_mask = sm.misc[3], mu = sm.misc[52];
  const float sfF0 = s_f / F0;
  const float pz = sm.z[14 + 3 * f];
  const float fx = s_f * sm.u[3 * f], fy = s_f * sm.u[3 * f + 1],
              fz = s_f * sm.u[3 * f + 2];
  const float w0 = sm.u[12 + 3 * f], w1 = sm.u[13 + 3 * f];
  const float a = fz / F0;
  const float b = pz / G0;
  const float s = sqrtf(a * a + b * b + rho * rho);
  const float r1 = a + b - s;
  const float ca = 1.0f - a / s, cb = 1.0f - b / s;
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
  const float r6c = 1.0f - sm.fm[f];

  float* g = sm.q;
  g[14 + 3 * f] += 2.0f * c_fb * r1 * cb / G0;
  g[N + 3 * f] += 2.0f * c_cone * r4 * sig4 * sgn0 * sfF0;
  g[N + 3 * f + 1] += 2.0f * c_cone * r5 * sig5 * sgn1 * sfF0;
  g[N + 3 * f + 2] += 2.0f * (c_fb * r1 * ca + c_slip * (r2 * w0 + r3 * w1)
                              * dsq - c_cone * mu * (r4 * sig4 + r5 * sig5)
                              + c_mask * (r6c * a) * r6c) * sfF0;
  g[N + 12 + 3 * f] += 2.0f * c_slip * r2 * sq;
  g[N + 13 + 3 * f] += 2.0f * c_slip * r3 * sq;

  // Gauss-Newton entries plus the FB violation-side curvature
  const float mcv = 2.0f * c_fb * fminf(r1, 0.0f) / (s * s * s);
  const float c_aa = mcv * (a * a - s * s);
  const float c_bb = mcv * (b * b - s * s);
  const float c_ab = mcv * (a * b);
  float* h = sm.hf[f];
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

// row r of the analytic Jacobians Fz, Fu (== ci_mpc._dyn_jac_b)
__device__ void jac_rows(Smem& sm, int r, float dt, float s_f, float mass) {
  float* fz = sm.Fz + r * LD;
  float* fu = sm.Fu + r * LD;
  for (int j = 0; j < N; ++j) {
    fz[j] = j == r ? 1.0f : 0.0f;
    fu[j] = 0.0f;
  }
  if (r < 3) fz[6 + r] = dt;
  else if (r < 6) fz[9 + r - 3] = dt;
  else if (r < 9) {
    const float vf = (dt * s_f) / mass;
    for (int f = 0; f < 4; ++f) fu[3 * f + r - 6] = vf;
  } else if (r < 12) {
    const int i = r - 9;
    const float* iw = sm.iw + 3 * i;           // row i of Iw_inv
    // om <- pos: dt Iw_inv sum_f skew(f_f); om <- feet_f: -dt Iw_inv
    // skew(f_f); om <- f_f: dt s_f Iw_inv skew(feet_f - pos)
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    for (int f = 0; f < 4; ++f) {
      const float ffx = s_f * sm.u[3 * f], ffy = s_f * sm.u[3 * f + 1],
                  ffz = s_f * sm.u[3 * f + 2];
      sx += ffx;
      sy += ffy;
      sz += ffz;
      // row i of Iw_inv skew(v) = (iw x v)... written out per column:
      // skew(v) = [[0,-vz,vy],[vz,0,-vx],[-vy,vx,0]]
      fz[12 + 3 * f + 0] = -dt * (iw[1] * ffz - iw[2] * ffy);
      fz[12 + 3 * f + 1] = -dt * (-iw[0] * ffz + iw[2] * ffx);
      fz[12 + 3 * f + 2] = -dt * (iw[0] * ffy - iw[1] * ffx);
      const float rx = sm.z[12 + 3 * f] - sm.z[0],
                  ry = sm.z[13 + 3 * f] - sm.z[1],
                  rz = sm.z[14 + 3 * f] - sm.z[2];
      fu[3 * f + 0] = (dt * s_f) * (iw[1] * rz - iw[2] * ry);
      fu[3 * f + 1] = (dt * s_f) * (-iw[0] * rz + iw[2] * rx);
      fu[3 * f + 2] = (dt * s_f) * (iw[0] * ry - iw[1] * rx);
    }
    fz[0] = dt * (iw[1] * sz - iw[2] * sy);
    fz[1] = dt * (-iw[0] * sz + iw[2] * sx);
    fz[2] = dt * (iw[0] * sy - iw[1] * sx);
  } else {
    fu[r] = dt;
  }
}

// one backward Riccati pass over the H stages at relaxation rho
__device__ void backward(Smem& sm, const Args& p, int b, float rho) {
  const int r = threadIdx.x;
  const int H = p.H;
  const float* Z = p.Z + (size_t)b * (H + 1) * N;
  const float* U = p.U + (size_t)b * H * N;
  const float* ref = p.ref_zu + (size_t)b * H * 2 * N;
  const float* fmk = p.f_mask + (size_t)b * H * 4;
  float* kff = p.kff + (size_t)b * H * N;
  float* Kc = p.K + (size_t)b * H * N * N;
  const float* th = sm.misc + 4;
  float a[N], out[N], out2[N];

  // terminal value: hT = track_h on pos, eul, v; 0 elsewhere
  if (r < N) {
    const float hT = r < 9 ? th[r] : 0.0f;
    sm.Vx[r] = hT * (Z[H * N + r] - p.refT[(size_t)b * N + r]);
    for (int j = 0; j < N; ++j) sm.Vxx[r * LD + j] = j == r ? hT : 0.0f;
  }
  for (int k = H - 1; k >= 0; --k) {
    __syncwarp();
    if (r < N) {
      sm.z[r] = Z[k * N + r];
      sm.u[r] = U[k * N + r];
      sm.rz[r] = ref[k * 2 * N + r];
      sm.rz[N + r] = ref[k * 2 * N + N + r];
    }
    if (r < 4) sm.fm[r] = fmk[k * 4 + r];
    __syncwarp();
    if (r < N) {
      sm.q[r] = th[r] * (sm.z[r] - sm.rz[r]);
      sm.q[N + r] = th[N + r] * (sm.u[r] - sm.rz[N + r]);
      jac_rows(sm, r, p.dt, p.s_f, sm.misc[53]);
    }
    __syncwarp();
    if (r < 4) quad_foot(sm, r, rho, p.s_f);
    __syncwarp();

    // Q terms: T1 = Vxx Fz, T2 = Vxx Fu (Vxx is symmetric: its column r
    // is its row r); Qx = g_x + Fz' Vx, Qu = g_u + Fu' Vx
    if (r < N) {
      load_col(sm.Vxx, r, a);
      row_mul(a, sm.Fz, out);
      for (int j = 0; j < N; ++j) sm.T1[r * LD + j] = out[j];
      row_mul(a, sm.Fu, out);
      for (int j = 0; j < N; ++j) sm.T2[r * LD + j] = out[j];
      float qx = 0.0f, qu = 0.0f;
      for (int k2 = 0; k2 < N; ++k2) {
        qx = fmaf(sm.Fz[k2 * LD + r], sm.Vx[k2], qx);
        qu = fmaf(sm.Fu[k2 * LD + r], sm.Vx[k2], qu);
      }
      // g is complete (quad_foot ran); Q's vector part overwrites it after
      // the barrier below
      out2[0] = sm.q[r] + qx;
      out2[1] = sm.q[N + r] + qu;
    }
    __syncwarp();
    if (r < N) {
      sm.q[r] = out2[0];
      sm.q[N + r] = out2[1];
      // Qxx = Fz' T1 + Hxx, Quu = Fu' T2 + Huu, Qux = Fu' T1 + Hux; the
      // products' rows are stored first and the Hessian entries added in
      // shared memory (a register array indexed by r would go to local
      // memory)
      load_col(sm.Fz, r, a);
      row_mul(a, sm.T1, out);
      float* qxx = sm.Qxx + r * LD;
      for (int j = 0; j < N; ++j) qxx[j] = out[j];
      qxx[r] += th[r];
      if (r >= 14 && (r - 14) % 3 == 0) qxx[r] += sm.hf[(r - 14) / 3][H_PZ];
      load_col(sm.Fu, r, a);
      row_mul(a, sm.T2, out);
      row_mul(a, sm.T1, out2);
      float* quu = sm.Quu + r * LD;
      float* qux = sm.Qux + r * LD;
      for (int j = 0; j < N; ++j) {
        quu[j] = out[j];
        qux[j] = out2[j];
      }
      quu[r] += th[N + r];
      if (r < 12) {
        const int f = r / 3, c = r % 3;
        const float* h = sm.hf[f];
        if (c == 0) {
          quu[r] += h[H_FX];
          quu[3 * f + 2] += h[E_FXFZ];
        } else if (c == 1) {
          quu[r] += h[H_FY];
          quu[3 * f + 2] += h[E_FYFZ];
        } else {
          quu[r] += h[H_FZ];
          quu[3 * f] += h[E_FXFZ];
          quu[3 * f + 1] += h[E_FYFZ];
          quu[12 + 3 * f] += h[E_FZWX];
          quu[13 + 3 * f] += h[E_FZWY];
          qux[14 + 3 * f] += h[E_PZFZ];
        }
      } else {
        const int f = (r - 12) / 3, c = (r - 12) % 3;
        const float* h = sm.hf[f];
        if (c == 0) {
          quu[r] += h[H_W];
          quu[3 * f + 2] += h[E_FZWX];
        } else if (c == 1) {
          quu[r] += h[H_W];
          quu[3 * f + 2] += h[E_FZWY];
        }
      }
    }
    __syncwarp();
    // Levenberg state regularization: L <- Quu + (reg I + state_reg Fu'Fu)
    // (into T1), S = [Qu | Qux + state_reg Fu'Fz]
    if (r < N) {
      load_col(sm.Fu, r, a);
      row_mul(a, sm.Fu, out);
      row_mul(a, sm.Fz, out2);
      for (int j = 0; j < N; ++j) {
        sm.T1[r * LD + j] = sm.Quu[r * LD + j]
                            + ((j == r ? p.reg : 0.0f) + p.state_reg * out[j]);
        sm.S[r * LDS + 1 + j] = sm.Qux[r * LD + j] + p.state_reg * out2[j];
      }
      sm.S[r * LDS] = sm.q[N + r];
    }
    // Cholesky of L in place, lower triangle, lane r owns row r
    for (int j = 0; j < N; ++j) {
      __syncwarp();
      const float sq = sqrtf(sm.T1[j * LD + j]);
      const float inv = 1.0f / sq;
      if (r > j && r < N) sm.T1[r * LD + j] *= inv;
      __syncwarp();
      if (r == j) sm.T1[j * LD + j] = sq;
      if (r > j && r < N) {
        const float lrj = sm.T1[r * LD + j];
        for (int c = j + 1; c <= r; ++c)
          sm.T1[r * LD + c] -= lrj * sm.T1[c * LD + j];
      }
    }
    __syncwarp();
    // L L^T X = S, a lane per column of S
    bool ok = true;
    if (r < N + 1) {
      for (int i = 0; i < N; ++i) {
        float acc = sm.S[i * LDS + r];
        for (int c = 0; c < i; ++c)
          acc -= sm.T1[i * LD + c] * sm.S[c * LDS + r];
        sm.S[i * LDS + r] = acc / sm.T1[i * LD + i];
      }
      for (int i = N - 1; i >= 0; --i) {
        float acc = sm.S[i * LDS + r];
        for (int c = i + 1; c < N; ++c)
          acc -= sm.T1[c * LD + i] * sm.S[c * LDS + r];
        const float x = acc / sm.T1[i * LD + i];
        sm.S[i * LDS + r] = x;
        ok = ok && finite(x);
      }
    }
    // the stage guard: all or nothing per scenario
    const bool okk = __all_sync(0xffffffffu, ok);
    __syncwarp();
    if (r < N) {
      const float kr = okk ? -sm.S[r * LDS] : 0.0f;
      sm.kf[r] = kr;
      kff[k * N + r] = kr;
      for (int j = 0; j < N; ++j) {
        const float v = okk ? -sm.S[r * LDS + 1 + j] : 0.0f;
        sm.Kb[r * LD + j] = v;
        Kc[((size_t)k * N + r) * N + j] = v;
      }
    }
    __syncwarp();
    // value update (unregularized Quu, Qux): T2 = K' Quu
    if (r < N) {
      load_col(sm.Kb, r, a);
      row_mul(a, sm.Quu, out);
      for (int j = 0; j < N; ++j) sm.T2[r * LD + j] = out[j];
    }
    __syncwarp();
    if (r < N) {
      // Vx2 = Qx + K'Quu kff + K' Qu + Qux' kff
      float v1 = 0.0f, v2 = 0.0f, v3 = 0.0f;
      for (int j = 0; j < N; ++j) {
        v1 = fmaf(sm.T2[r * LD + j], sm.kf[j], v1);
        v2 = fmaf(sm.Kb[j * LD + r], sm.q[N + j], v2);
        v3 = fmaf(sm.Qux[j * LD + r], sm.kf[j], v3);
      }
      sm.Vx2[r] = ((sm.q[r] + v1) + v2) + v3;
      // X = Qxx + K'Quu K (into Fz), P = K' Qux (into Fu)
      load_row(sm.T2, r, a);
      row_mul(a, sm.Kb, out);
      for (int j = 0; j < N; ++j) sm.Fz[r * LD + j] = sm.Qxx[r * LD + j] + out[j];
      load_col(sm.Kb, r, a);
      row_mul(a, sm.Qux, out);
      for (int j = 0; j < N; ++j) sm.Fu[r * LD + j] = out[j];
    }
    __syncwarp();
    // Vxx2 = X + P + P', symmetrized, into T1; kept only if finite
    ok = true;
    if (r < N) {
      ok = finite(sm.Vx2[r]);
      for (int j = 0; j < N; ++j) {
        const float vij = (sm.Fz[r * LD + j] + sm.Fu[r * LD + j])
                          + sm.Fu[j * LD + r];
        const float vji = (sm.Fz[j * LD + r] + sm.Fu[j * LD + r])
                          + sm.Fu[r * LD + j];
        const float v = 0.5f * (vij + vji);
        sm.T1[r * LD + j] = v;
        ok = ok && finite(v);
      }
    }
    const bool okv = __all_sync(0xffffffffu, ok);
    __syncwarp();
    if (okv && r < N) {
      sm.Vx[r] = sm.Vx2[r];
      for (int j = 0; j < N; ++j) sm.Vxx[r * LD + j] = sm.T1[r * LD + j];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32)
ci_sweeps(Args p) {
  __shared__ Smem sm;
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  const int H = p.H;
  for (int e = r; e < NMISC; e += 32) sm.misc[e] = p.misc[e];
  if (r < 9) sm.iw[r] = p.iw_inv[(size_t)b * 9 + r];
  float* U = p.U + (size_t)b * H * N;
  float* Z = p.Z + (size_t)b * (H + 1) * N;
  const float* uh0 = p.uh0 + (size_t)b * H * N;
  for (int e = r; e < H * N; e += 32) U[e] = uh0[e];
  // initial rollout
  __syncwarp();
  if (r < N) sm.z[r] = p.z0[(size_t)b * N + r];
  for (int k = 0; k < H; ++k) {
    __syncwarp();
    if (r < N) {
      Z[k * N + r] = sm.z[r];
      sm.u[r] = U[k * N + r];
    }
    __syncwarp();
    float zn = 0.0f;
    if (r < N) zn = dyn_row(sm, r, p.dt, p.s_f, sm.misc[53]);
    __syncwarp();
    if (r < N) sm.z[r] = zn;
  }
  __syncwarp();
  if (r < N) Z[H * N + r] = sm.z[r];

  const float lr0 = logf(p.rho0[b]);
  const float lrm = logf(p.rho_min);
  float c_best = INFINITY;
  for (int it = 0; it < p.iters; ++it) {
    const float frac = p.iters > 1 ? (float)it / ((float)p.iters - 1.0f)
                                   : 1.0f;
    const float rho = fmaxf(expf(lr0 + frac * (lrm - lr0)), p.rho_min);
    backward(sm, p, b, rho);
    c_best = INFINITY;
    float a_best = 0.0f;
    for (int ia = 0; ia < NALPHA; ++ia) {
      float c = forward(sm, p, b, ALPHAS[ia], rho, false);
      if (!finite(c)) c = INFINITY;
      if (c < c_best) {
        c_best = c;
        a_best = ALPHAS[ia];
      }
    }
    forward(sm, p, b, a_best, rho, true);
  }
  if (r == 0) p.cost[b] = c_best;
}

}  // namespace

// The whole sweep loop for B scenarios with horizon H on `stream`; see the
// header for the layouts. Returns cudaGetLastError() after the launch.
extern "C" int ci_sweeps_launch(const float* z0, const float* uh0,
                                const float* ref_zu, const float* refT,
                                const float* f_mask, const float* rho0,
                                const float* iw_inv, const float* misc,
                                float* U, float* Z, float* cost, float* kff,
                                float* K, int B, int H, int iters, float dt,
                                float s_f, float rho_min, float reg,
                                float state_reg, void* stream) {
  if (B == 0) return 0;
  Args p{z0, uh0, ref_zu, refT, f_mask, rho0, iw_inv, misc, U, Z, cost, kff,
         K, H, iters, dt, s_f, rho_min, reg, state_reg};
  ci_sweeps<<<B, 32, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
