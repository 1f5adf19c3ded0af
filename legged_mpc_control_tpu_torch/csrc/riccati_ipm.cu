// Kernel K1: the whole Mehrotra predictor-corrector interior-point solve of
// the stagewise SRB MPC QP, every iteration inside one launch.
//
// Replaces: legged_mpc_control_tpu/ops/riccati_pallas.py,
//           solve_qp_riccati_fused (kernel body _make_kernel).
// Plain version: legged_mpc_control_tpu_torch/mpc/riccati.py,
//           solve_qp_riccati_batched (same algorithm, batch-first torch).
//
// What bounds it on an H100: per-scenario latency, not FLOPs. One solve is a
// long chain of dependent 12x12 steps (per iteration a backward Riccati
// factor sweep over H stages, two backward/forward LQR sweeps, a rollout and
// an adjoint), about 1.5 MFLOP per scenario at H=10, 15 iterations. Its
// working set is ~516 floats per stage (Cholesky factor L, gain K and Hux
// per stage, plus the state/adjoint, feed-forward, two directions, dual
// residual and slack vectors): ~21 KB per scenario at H=10, ~62 KB at H=30.
// That does not fit in registers or shared memory at one thread per
// scenario.
//
// Design: one thread per scenario. The per-stage caches live in a global
// scratch tensor laid out batch-innermost ([element][B]), so the 32 threads
// of a warp read 32 consecutive floats for every element (coalesced), and
// the working set streams through L1/L2. The 12x12 temporaries of one stage
// are thread-local arrays. Blocks are one warp wide, so B=4096 spreads over
// 128 blocks and reaches nearly every SM. Any horizon H runs: the scratch is
// sized by the caller. A scenario whose iterate converged (or whose
// direction went non-finite) is frozen: it leaves the iteration loop, which
// is exactly the masked no-op update of the TPU kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NX = 12;
constexpr int NCON = 24;                  // 4 legs x 6 rows per stage
// scratch floats per stage: L, K, Hux (3 x 144) + vec, kff, du_a, du,
// rdual (5 x 12) + s (24)
constexpr int SCR_L = 0;
constexpr int SCR_K = 144;
constexpr int SCR_HUX = 288;
constexpr int SCR_VEC = 432;
constexpr int SCR_KFF = 444;
constexpr int SCR_DUA = 456;
constexpr int SCR_DU = 468;
constexpr int SCR_RD = 480;
constexpr int SCR_S = 492;
constexpr int SCR_PER_STAGE = 516;

constexpr float TOL = 1e-6f;
constexpr float D_MAX = 1e6f;
constexpr float REG = 1e-6f;
constexpr float EPS = 1e-20f;
constexpr float GRAVITY = 9.8f;

struct Prob {
  const float* x0;       // (12, B)
  const float* xref;     // (H, 12, B)
  const float* A;        // (H, 12, 12, B)
  const float* Bm;       // (12, 12, B)
  const float* contact;  // (H, 4, B)
  const float* qw;       // (12, B)
  const float* rw;       // (12, B)
  float* u;              // (H, 12, B): the iterate, then the result
  float* lam;            // (H, 4, 6, B): the duals, then the result
  float* scr;            // (H * SCR_PER_STAGE, B)
  int B, H, b;
  float mu, fz, dt;

  __device__ float A_(int k, int i, int j) const {
    return A[((size_t)(k * NX + i) * NX + j) * B + b];
  }
  // B_k = Bm with the swing legs' columns masked by the contact schedule
  __device__ float Bk(int k, int i, int j) const {
    return Bm[(size_t)(i * NX + j) * B + b] *
           contact[(size_t)(k * 4 + j / 3) * B + b];
  }
  __device__ float& S(int k, int off) const {
    return scr[(size_t)(k * SCR_PER_STAGE + off) * B + b];
  }
  __device__ float& U(int k, int i) const {
    return u[(size_t)(k * NX + i) * B + b];
  }
  __device__ float& LAM(int k, int c) const {
    return lam[(size_t)(k * NCON + c) * B + b];
  }
};

// G(mu) u for one leg's force (fx, fy, fz): the 4 pyramid faces, the fz cap
// and fz >= 0 (reference: ConvexQPSolver.cpp:130-177)
__device__ void g_apply(const float f[3], float mu, float g[6]) {
  g[0] = -f[0] - mu * f[2];
  g[1] = f[0] - mu * f[2];
  g[2] = -f[1] - mu * f[2];
  g[3] = f[1] - mu * f[2];
  g[4] = f[2];
  g[5] = -f[2];
}

// G(mu)^T w for one leg
__device__ void gt_apply(const float w[6], float mu, float f[3]) {
  f[0] = -w[0] + w[1];
  f[1] = -w[2] + w[3];
  f[2] = -mu * (w[0] + w[1] + w[2] + w[3]) + w[4] - w[5];
}

// per-constraint quantities of stage k, leg l at the current iterate:
// slack, dual and primal residual G u + s - h
__device__ void load_con(const Prob& p, int k, int l, float s[6],
                         float lm[6], float rp[6]) {
  float f[3] = {p.U(k, 3 * l), p.U(k, 3 * l + 1), p.U(k, 3 * l + 2)};
  float g[6];
  g_apply(f, p.mu, g);
  for (int r = 0; r < 6; ++r) {
    s[r] = p.S(k, SCR_S + 6 * l + r);
    lm[r] = p.LAM(k, 6 * l + r);
    rp[r] = g[r] + s[r] - (r == 4 ? p.fz : 0.0f);
  }
}

// slack and dual directions of one leg from its force direction du
// (ds = -(r_prim + G du), dlam = -(rc + lam ds) / s)
__device__ void con_dirs(const float du[3], float mu, const float s[6],
                         const float lm[6], const float rp[6],
                         const float rc[6], float ds[6], float dl[6]) {
  float g[6];
  g_apply(du, mu, g);
  for (int r = 0; r < 6; ++r) {
    ds[r] = -(rp[r] + g[r]);
    dl[r] = -(rc[r] + lm[r] * ds[r]) / fmaxf(s[r], EPS);
  }
}

// complementarity target rc of one leg: lam s (affine predictor) or
// lam s + clip(ds_a dl_a) - sigma mu_gap (corrector, from the stored du_a)
__device__ void leg_rc(const Prob& p, int k, int l, const float s[6],
                       const float lm[6], const float rp[6], bool corr,
                       float sigma, float mu_gap, float rc[6]) {
  for (int r = 0; r < 6; ++r) rc[r] = lm[r] * s[r];
  if (!corr) return;
  float dua[3] = {p.S(k, SCR_DUA + 3 * l), p.S(k, SCR_DUA + 3 * l + 1),
                  p.S(k, SCR_DUA + 3 * l + 2)};
  float ds[6], dl[6], rca[6];
  for (int r = 0; r < 6; ++r) rca[r] = lm[r] * s[r];
  con_dirs(dua, p.mu, s, lm, rp, rca, ds, dl);
  for (int r = 0; r < 6; ++r) {
    float c = fminf(fmaxf(ds[r] * dl[r], -10.0f * mu_gap), 10.0f * mu_gap);
    rc[r] = lm[r] * s[r] + c - sigma * mu_gap;
  }
}

// X rollout from x0 under the current u, then the backward adjoint
// psi_k = Q (x_{k+1} - xref_k) + A_{k+1}^T psi_{k+1}, left in vec.
__device__ void rollout_psi(const Prob& p, const float qw[NX]) {
  float x[NX], xn[NX];
  for (int i = 0; i < NX; ++i) x[i] = p.x0[(size_t)i * p.B + p.b];
  for (int k = 0; k < p.H; ++k) {
    for (int i = 0; i < NX; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < NX; ++j)
        acc += p.A_(k, i, j) * x[j] + p.Bk(k, i, j) * p.U(k, j);
      xn[i] = acc + (i == NX - 1 ? -GRAVITY * p.dt : 0.0f);
    }
    for (int i = 0; i < NX; ++i) {
      x[i] = xn[i];
      p.S(k, SCR_VEC + i) = xn[i];
    }
  }
  float ps[NX];
  for (int i = 0; i < NX; ++i) ps[i] = 0.0f;
  for (int k = p.H - 1; k >= 0; --k) {
    float pk[NX];
    for (int i = 0; i < NX; ++i) {
      float acc = qw[i] * (p.S(k, SCR_VEC + i) -
                           p.xref[(size_t)(k * NX + i) * p.B + p.b]);
      if (k + 1 < p.H)
        for (int j = 0; j < NX; ++j) acc += p.A_(k + 1, j, i) * ps[j];
      pk[i] = acc;
    }
    for (int i = 0; i < NX; ++i) {
      ps[i] = pk[i];
      p.S(k, SCR_VEC + i) = pk[i];
    }
  }
}

// in-place lower Cholesky of a 12x12 (row-major); a non-positive pivot
// gives NaN, which the direction guard catches
__device__ void chol12(float M[NX * NX]) {
  for (int j = 0; j < NX; ++j) {
    float d = M[j * NX + j];
    for (int k = 0; k < j; ++k) d -= M[j * NX + k] * M[j * NX + k];
    float dj = sqrtf(d);
    M[j * NX + j] = dj;
    float inv = 1.0f / dj;
    for (int i = j + 1; i < NX; ++i) {
      float v = M[i * NX + j];
      for (int k = 0; k < j; ++k) v -= M[i * NX + k] * M[j * NX + k];
      M[i * NX + j] = v * inv;
    }
  }
}

// solve (L L^T) z = y in place, L read from scratch stage k
__device__ void cho_solve_vec(const Prob& p, int k, float y[NX]) {
  for (int i = 0; i < NX; ++i) {
    float acc = y[i];
    for (int j = 0; j < i; ++j) acc -= p.S(k, SCR_L + i * NX + j) * y[j];
    y[i] = acc / p.S(k, SCR_L + i * NX + i);
  }
  for (int i = NX - 1; i >= 0; --i) {
    float acc = y[i];
    for (int j = i + 1; j < NX; ++j) acc -= p.S(k, SCR_L + j * NX + i) * y[j];
    y[i] = acc / p.S(k, SCR_L + i * NX + i);
  }
}

// backward Riccati factor sweep: caches L, K, Hux per stage in scratch.
// Hu_k = blockdiag(G^T D G) + diag(r + reg), with D = clip(lam / s).
__device__ void factor(const Prob& p, const float qw[NX], const float rw[NX]) {
  float P[NX * NX], T[NX * NX], C[NX * NX], D[NX * NX];
  for (int i = 0; i < NX * NX; ++i) P[i] = 0.0f;
  for (int k = p.H - 1; k >= 0; --k) {
    for (int i = 0; i < NX; ++i) P[i * NX + i] += qw[i];     // W = P + Q
    for (int i = 0; i < NX; ++i)                             // T = B^T W
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
        for (int r = 0; r < NX; ++r) acc += p.Bk(k, r, i) * P[r * NX + j];
        T[i * NX + j] = acc;
      }
    for (int i = 0; i < NX; ++i)                             // C = Hu + T B
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
        for (int r = 0; r < NX; ++r) acc += T[i * NX + r] * p.Bk(k, r, j);
        C[i * NX + j] = acc;
      }
    for (int i = 0; i < NX; ++i) C[i * NX + i] += rw[i] + REG;
    for (int l = 0; l < 4; ++l) {
      float d[6];
      for (int r = 0; r < 6; ++r) {
        float s = p.S(k, SCR_S + 6 * l + r);
        d[r] = fminf(fmaxf(p.LAM(k, 6 * l + r) / fmaxf(s, EPS), 0.0f), D_MAX);
      }
      const float mu = p.mu;
      const int o = 3 * l;
      C[o * NX + o] += d[0] + d[1];
      C[o * NX + o + 2] += mu * (d[0] - d[1]);
      C[(o + 2) * NX + o] += mu * (d[0] - d[1]);
      C[(o + 1) * NX + o + 1] += d[2] + d[3];
      C[(o + 1) * NX + o + 2] += mu * (d[2] - d[3]);
      C[(o + 2) * NX + o + 1] += mu * (d[2] - d[3]);
      C[(o + 2) * NX + o + 2] += mu * mu * (d[0] + d[1] + d[2] + d[3]) +
                                 d[4] + d[5];
    }
    for (int i = 0; i < NX; ++i)                             // D = Hux = T A
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
        for (int r = 0; r < NX; ++r) acc += T[i * NX + r] * p.A_(k, r, j);
        D[i * NX + j] = acc;
        p.S(k, SCR_HUX + i * NX + j) = acc;
      }
    for (int i = 0; i < NX; ++i)                             // T = A^T W
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
        for (int r = 0; r < NX; ++r) acc += p.A_(k, r, i) * P[r * NX + j];
        T[i * NX + j] = acc;
      }
    chol12(C);
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j)
        p.S(k, SCR_L + i * NX + j) = j <= i ? C[i * NX + j] : 0.0f;
    for (int j = 0; j < NX; ++j) {                           // K = -Huu^-1 Hux
      float y[NX];
      for (int i = 0; i < NX; ++i) y[i] = D[i * NX + j];
      cho_solve_vec(p, k, y);
      for (int i = 0; i < NX; ++i) {
        D[i * NX + j] = -y[i];
        p.S(k, SCR_K + i * NX + j) = -y[i];
      }
    }
    for (int i = 0; i < NX; ++i)         // P = A^T W A + Hux^T K, symmetric
      for (int j = 0; j < NX; ++j) {
        float acc = 0.0f;
        for (int r = 0; r < NX; ++r)
          acc += T[i * NX + r] * p.A_(k, r, j) +
                 p.S(k, SCR_HUX + r * NX + i) * D[r * NX + j];
        C[i * NX + j] = acc;
      }
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j)
        P[i * NX + j] = 0.5f * (C[i * NX + j] + C[j * NX + i]);
  }
}

// one Newton direction: du = -(Riccati)^-1 g with
// g_k = r_dual_k + G^T ((lam r_prim - rc) / s), into scratch `dst`
__device__ void lqr_solve(const Prob& p, bool corr, float sigma,
                          float mu_gap, int dst) {
  float ps[NX];
  for (int i = 0; i < NX; ++i) ps[i] = 0.0f;
  for (int k = p.H - 1; k >= 0; --k) {
    float g[NX];
    for (int l = 0; l < 4; ++l) {
      float s[6], lm[6], rp[6], rc[6], w[6], f[3];
      load_con(p, k, l, s, lm, rp);
      leg_rc(p, k, l, s, lm, rp, corr, sigma, mu_gap, rc);
      for (int r = 0; r < 6; ++r) w[r] = (lm[r] * rp[r] - rc[r]) / fmaxf(s[r], EPS);
      gt_apply(w, p.mu, f);
      for (int i = 0; i < 3; ++i) g[3 * l + i] = p.S(k, SCR_RD + 3 * l + i) + f[i];
    }
    float kff[NX];
    for (int i = 0; i < NX; ++i) {
      float acc = g[i];
      for (int j = 0; j < NX; ++j) acc += p.Bk(k, j, i) * ps[j];
      kff[i] = acc;
    }
    cho_solve_vec(p, k, kff);
    for (int i = 0; i < NX; ++i) kff[i] = -kff[i];
    float pn[NX];
    for (int i = 0; i < NX; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < NX; ++j)
        acc += p.A_(k, j, i) * ps[j] + p.S(k, SCR_HUX + j * NX + i) * kff[j];
      pn[i] = acc;
    }
    for (int i = 0; i < NX; ++i) {
      ps[i] = pn[i];
      p.S(k, SCR_KFF + i) = kff[i];
    }
  }
  float dx[NX];
  for (int i = 0; i < NX; ++i) dx[i] = 0.0f;
  for (int k = 0; k < p.H; ++k) {
    float du[NX], dxn[NX];
    for (int i = 0; i < NX; ++i) {
      float acc = p.S(k, SCR_KFF + i);
      for (int j = 0; j < NX; ++j) acc += p.S(k, SCR_K + i * NX + j) * dx[j];
      du[i] = acc;
      p.S(k, dst + i) = acc;
    }
    for (int i = 0; i < NX; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < NX; ++j) acc += p.A_(k, i, j) * dx[j] + p.Bk(k, i, j) * du[j];
      dxn[i] = acc;
    }
    for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
  }
}

// largest step in (0, 1] keeping v + a dv >= 0
__device__ float ratio_min(float a, float v, float dv) {
  return dv < 0.0f ? fminf(a, -v / dv) : a;
}

__global__ void __launch_bounds__(32)
riccati_ipm_kernel(const float* __restrict__ x0, const float* __restrict__ xref,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ contact,
                   const float* __restrict__ qw_g, const float* __restrict__ rw_g,
                   const float* __restrict__ mu_g, const float* __restrict__ fz_g,
                   const float* __restrict__ u0, float* u, float* gap_out,
                   float* lam, float* scr, int B, int H, int iters, float dt,
                   int warm) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Prob p{x0, xref, A, Bm, contact, qw_g, rw_g, u, lam, scr, B, H, b,
         mu_g[b], fz_g[b], dt};
  float qw[NX], rw[NX];
  for (int i = 0; i < NX; ++i) {
    qw[i] = qw_g[(size_t)i * B + b];
    rw[i] = rw_g[(size_t)i * B + b];
  }
  const float m = (float)(H * NCON);

  // initial iterate: primal warm start (swing legs masked) with the slacks
  // clipped interior and the duals recentred, or the cold start
  for (int k = 0; k < H; ++k) {
    for (int i = 0; i < NX; ++i)
      p.U(k, i) = warm ? u0[(size_t)(k * NX + i) * B + b] *
                             contact[(size_t)(k * 4 + i / 3) * B + b]
                       : 0.0f;
    for (int l = 0; l < 4; ++l) {
      float f[3] = {p.U(k, 3 * l), p.U(k, 3 * l + 1), p.U(k, 3 * l + 2)};
      float g[6];
      g_apply(f, p.mu, g);
      for (int r = 0; r < 6; ++r) {
        float h = r == 4 ? p.fz : 0.0f;
        float s = fmaxf(h - g[r], warm ? 0.1f : 1.0f);
        p.S(k, SCR_S + 6 * l + r) = s;
        p.LAM(k, 6 * l + r) = warm ? fminf(fmaxf(1.0f / s, 1e-3f), 1e2f) : 1.0f;
      }
    }
  }

  for (int it = 0; it < iters; ++it) {
    rollout_psi(p, qw);
    // dual residual r = R u + B^T psi + G^T lam; gap; primal residual
    float rd_max = 0.0f, rp_max = 0.0f, sl = 0.0f;
    for (int k = 0; k < H; ++k) {
      for (int l = 0; l < 4; ++l) {
        float s[6], lm[6], rp[6], f[3];
        load_con(p, k, l, s, lm, rp);
        gt_apply(lm, p.mu, f);
        for (int r = 0; r < 6; ++r) {
          sl += s[r] * lm[r];
          rp_max = fmaxf(rp_max, fabsf(rp[r]));
        }
        for (int i = 0; i < 3; ++i) {
          const int c = 3 * l + i;
          float acc = rw[c] * p.U(k, c) + f[i];
          for (int j = 0; j < NX; ++j) acc += p.Bk(k, j, c) * p.S(k, SCR_VEC + j);
          p.S(k, SCR_RD + c) = acc;
          rd_max = fmaxf(rd_max, fabsf(acc));
        }
      }
    }
    const float mu_gap = sl / m;

    factor(p, qw, rw);
    lqr_solve(p, false, 0.0f, mu_gap, SCR_DUA);

    // affine step lengths, then the centring parameter from mu_aff
    float ap = 1.0f, ad = 1.0f;
    for (int k = 0; k < H; ++k)
      for (int l = 0; l < 4; ++l) {
        float s[6], lm[6], rp[6], rc[6], ds[6], dl[6];
        float du[3] = {p.S(k, SCR_DUA + 3 * l), p.S(k, SCR_DUA + 3 * l + 1),
                       p.S(k, SCR_DUA + 3 * l + 2)};
        load_con(p, k, l, s, lm, rp);
        for (int r = 0; r < 6; ++r) rc[r] = lm[r] * s[r];
        con_dirs(du, p.mu, s, lm, rp, rc, ds, dl);
        for (int r = 0; r < 6; ++r) {
          ap = ratio_min(ap, s[r], ds[r]);
          ad = ratio_min(ad, lm[r], dl[r]);
        }
      }
    float saff = 0.0f;
    for (int k = 0; k < H; ++k)
      for (int l = 0; l < 4; ++l) {
        float s[6], lm[6], rp[6], rc[6], ds[6], dl[6];
        float du[3] = {p.S(k, SCR_DUA + 3 * l), p.S(k, SCR_DUA + 3 * l + 1),
                       p.S(k, SCR_DUA + 3 * l + 2)};
        load_con(p, k, l, s, lm, rp);
        for (int r = 0; r < 6; ++r) rc[r] = lm[r] * s[r];
        con_dirs(du, p.mu, s, lm, rp, rc, ds, dl);
        for (int r = 0; r < 6; ++r) saff += (s[r] + ap * ds[r]) * (lm[r] + ad * dl[r]);
      }
    const float mu_aff = saff / m;
    float ratio = mu_aff / fmaxf(mu_gap, EPS);
    const float sigma = fminf(fmaxf(ratio * ratio * ratio, 1e-4f), 0.9f);

    lqr_solve(p, true, sigma, mu_gap, SCR_DU);

    // corrector step lengths and the non-finite guard
    ap = 1.0f;
    ad = 1.0f;
    bool finite = true;
    for (int k = 0; k < H; ++k)
      for (int l = 0; l < 4; ++l) {
        float s[6], lm[6], rp[6], rc[6], ds[6], dl[6];
        float du[3] = {p.S(k, SCR_DU + 3 * l), p.S(k, SCR_DU + 3 * l + 1),
                       p.S(k, SCR_DU + 3 * l + 2)};
        load_con(p, k, l, s, lm, rp);
        leg_rc(p, k, l, s, lm, rp, true, sigma, mu_gap, rc);
        con_dirs(du, p.mu, s, lm, rp, rc, ds, dl);
        for (int i = 0; i < 3; ++i) finite = finite && isfinite(du[i]);
        for (int r = 0; r < 6; ++r) {
          finite = finite && isfinite(ds[r]) && isfinite(dl[r]);
          ap = ratio_min(ap, s[r], ds[r]);
          ad = ratio_min(ad, lm[r], dl[r]);
        }
      }
    ap *= 0.99f;
    ad *= 0.99f;

    // freeze on convergence (gap, primal and dual residual) or on a
    // non-finite direction: the iterate stays as it is from here on
    const bool conv = mu_gap < TOL && rp_max < 1e3f * TOL && rd_max < 1e3f * TOL;
    if (conv || !finite) break;

    for (int k = 0; k < H; ++k) {
      for (int l = 0; l < 4; ++l) {
        float s[6], lm[6], rp[6], rc[6], ds[6], dl[6];
        float du[3] = {p.S(k, SCR_DU + 3 * l), p.S(k, SCR_DU + 3 * l + 1),
                       p.S(k, SCR_DU + 3 * l + 2)};
        load_con(p, k, l, s, lm, rp);
        leg_rc(p, k, l, s, lm, rp, true, sigma, mu_gap, rc);
        con_dirs(du, p.mu, s, lm, rp, rc, ds, dl);
        for (int r = 0; r < 6; ++r) {
          p.S(k, SCR_S + 6 * l + r) = s[r] + ap * ds[r];
          p.LAM(k, 6 * l + r) = lm[r] + ad * dl[r];
        }
      }
      // u last: load_con above reads the old u of this stage
      for (int i = 0; i < NX; ++i) p.U(k, i) += ap * p.S(k, SCR_DU + i);
    }
  }

  float sl = 0.0f;
  for (int k = 0; k < H; ++k) {
    for (int i = 0; i < NX; ++i)
      p.U(k, i) *= contact[(size_t)(k * 4 + i / 3) * B + b];
    for (int c = 0; c < NCON; ++c) sl += p.S(k, SCR_S + c) * p.LAM(k, c);
  }
  gap_out[b] = sl / m;
}

}  // namespace

extern "C" int riccati_ipm_scratch_per_stage() { return SCR_PER_STAGE; }

// Launch on `stream`. All arrays f32, batch innermost (see Prob). u0 is
// read only when warm != 0. Returns cudaGetLastError() after the launch.
extern "C" int riccati_ipm_launch(const float* x0, const float* xref,
                                  const float* A, const float* Bm,
                                  const float* contact, const float* qw,
                                  const float* rw, const float* mu,
                                  const float* fz, const float* u0, float* u,
                                  float* gap, float* lam, float* scratch,
                                  int B, int H, int iters, float dt, int warm,
                                  void* stream) {
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  riccati_ipm_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x0, xref, A, Bm, contact, qw, rw, mu, fz, u0, u, gap, lam, scratch, B,
      H, iters, dt, warm);
  return (int)cudaGetLastError();
}
