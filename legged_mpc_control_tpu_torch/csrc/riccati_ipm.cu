// Kernel K1: the whole Mehrotra predictor-corrector interior-point solve of
// the stagewise SRB MPC QP, every iteration inside one launch.
//
// Replaces: legged_mpc_control_tpu/ops/riccati_pallas.py,
//           solve_qp_riccati_fused (kernel body _make_kernel).
// Plain version: legged_mpc_control_tpu_torch/mpc/riccati.py,
//           solve_qp_riccati_batched (same algorithm, batch-first torch).
//
// What bounds it on an H100: latency and the shared-memory pipe, not FLOPs
// or bytes. One solve is a long chain of dependent 12x12 steps (per
// iteration a backward Riccati factor sweep over H stages, two
// backward/forward LQR sweeps, a rollout and an adjoint), ~31k float32
// operations a stage and iteration, and its per-stage caches (Cholesky
// factor, gain, Hux and the stage's vectors: 564 floats) are re-read many
// times an iteration. The TPU kernel hides the latency behind a 128-lane
// tile held in VMEM. The thread-a-scenario design of the port's first
// slices left one warp on each SM at B=4096, every operand a device-memory
// access and its 12x12 temporaries spilled (39 ms at B=4096, H=10, 15
// iterations; PERF.md).
//
// Design: a warp a scenario. The warp runs its whole solve with no block
// barrier (warps of a ragged last block just return); lanes split every
// stage step:
// - 12x12 products: lane (i, h), lane = 2 i + h < 24, owns row i, columns
//   4h..4h+3 and 8+2h..9+2h of the result, so that it reads each row of
//   the right operand as one float4 and one float2 and the left operand's
//   row as three float4s (rows are 12 floats: 48 bytes, 16-byte aligned);
// - vectors: lane i < 12 owns element i, and reads element j of another
//   lane with a shuffle; matrix rows it needs whole are float4 reads;
// - constraints: lane c < 24 owns row c % 6 of leg c / 6 (slack, dual,
//   residual, directions); mu_gap, the residual maxima, the step-length
//   minima and sums are warp reductions (xor butterflies, so every lane
//   holds the same value and the freeze is uniform across the warp);
// - the 12x12 Cholesky runs on 12 lanes with shuffles, right-looking, in the
//   old kernel's update order, with sqrtf and a true reciprocal (NaN on a
//   non-positive pivot, which the direction guard catches), while the
//   product lanes form A^T W beside it. K's twelve columns are solved one a
//   lane, and a vector solve runs on every lane at once, both in
//   registers. Sums accumulate in the old kernel's order.
// Precision: the Newton systems are near-singular in float32 (r = 1e-4 on
// the forces, D up to 1e6), and along the horizon the factor sweep's P
// recursion carries its rounding from stage to stage. At H=30 the float32
// sweep left the kernel up to 0.15 N from the same iterations in exact
// arithmetic (the plain version 0.13 N), where a float64 sweep leaves 0.03
// N (the CPU emulation, PERF.md). So for H >= F64_MIN_H (14) the factor
// sweep (W, B^T W, Huu, Hux, the Cholesky, K, P) runs in float64 in the work
// area, its results stored as float32; the pivots come from rsqrt, and the
// float32 LQR solves divide by the stored pivots, as LAPACK's triangular
// solves do. Below, the sweep keeps float32 and multiplies by stored
// reciprocals: at H=10 the float64 sweep costs 1.8x at the loop's call, and
// over 16 seeds of the card tests' fixture on two batch sets the float32
// sweep meets the float64 criteria at H=13 in every case, the float64 one
// in all but one (PERF.md; tools/k1_seed_sweep.py).
// A_k is loaded into registers a stage ahead of its use in every sweep.
// The factor sweep's temporaries (B, A_k, P, B^T W / A^T W, Huu, Hux) live
// in a work area of shared memory per warp (3.6 KB; 6.0 KB with the
// float64 sweep). The per-stage store
// lives in shared memory too while H <= SMEM_MAX_H (22.6 KB a scenario at
// H=10, 8 scenarios an SM), else in a scenario-major device scratch (one
// warp reads one scenario's consecutive floats; at H=10 it is 18-26 %
// slower than shared memory on an H100, PERF.md). One templated body serves
// the four combinations; the launcher dispatches on H (the TPU kernel's
// cutoff is also H <= 12). Register arrays are indexed by unrolled
// constants only.
// Inputs are the batch-first tensors of the plain version, read in place.
// A scenario whose iterate converged (or whose direction went non-finite)
// leaves the iteration loop: the masked no-op update of the TPU kernel.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

// Phase marks, empty in the package's build: tools/k1_spans.py defines
// them (K1_SPANS) to read clock64() around each phase of an iteration.
#ifndef K1_SPANS
#define K1_SPANS_BEGIN
#define K1_SPAN(n)
#define K1_SPANS_END
#endif
// Horizons whose per-stage store lives in shared memory (tools/k1_spans.py
// also builds with 0: the store in device scratch at every horizon).
#ifndef K1_SMEM_MAX_H
#define K1_SMEM_MAX_H 12
#endif
// Horizons whose factor sweep runs in float64 (tools/k1_times.py and
// tools/k1_spans.py also build with 0 and 1000: every horizon, none)
#ifndef K1_F64_MIN_H
#define K1_F64_MIN_H 14
#endif

namespace {

constexpr int NX = 12;
constexpr int NCON = 24;                  // 4 legs x 6 rows per stage
constexpr int MAT = NX * NX;              // a 12x12, row-major
constexpr unsigned FULL = 0xffffffffu;

// the per-stage store (floats; every block starts on 16 bytes)
constexpr int ST_L = 0;                   // Cholesky factor of Huu
constexpr int ST_PIV = ST_L + MAT;        // 1 / L[i][i]; L[i][i] if F64
constexpr int ST_K = ST_PIV + NX;
constexpr int ST_HUX = ST_K + MAT;
constexpr int ST_VEC = ST_HUX + MAT;      // x_{k+1} of the rollout
constexpr int ST_KFF = ST_VEC + NX;
constexpr int ST_DUA = ST_KFF + NX;       // affine direction
constexpr int ST_DU = ST_DUA + NX;        // corrector direction
constexpr int ST_RD = ST_DU + NX;         // dual residual
constexpr int ST_U = ST_RD + NX;
constexpr int ST_S = ST_U + NX;
constexpr int ST_LAM = ST_S + NCON;
constexpr int ST_PER_STAGE = ST_LAM + NCON;   // 564

// the per-warp work area (shared memory): floats, then the factor sweep's
// blocks in its type FT (float or double; FT_OFF bytes in)
constexpr int W_BM = 0;                   // B (unmasked), all stages
constexpr int W_A = W_BM + MAT;           // A_k of the current pass
constexpr int W_D = W_A + MAT;            // D = clip(lam / s), 24
constexpr int W_FLOATS = W_D + NCON;      // 312
constexpr int FT_OFF = W_FLOATS * (int)sizeof(float);
constexpr int D_P = 0;                    // P, then W = P + Q, then K
constexpr int D_T = D_P + MAT;            // B_k^T W, then A_k^T W
constexpr int D_C = D_T + MAT;            // Huu, then its factor, then P'
constexpr int D_H = D_C + MAT;            // Hux
constexpr int D_PIV = D_H + MAT;          // 1 / L[i][i]
constexpr int D_N = D_PIV + NX;           // 588
// bytes of a warp's work area (a multiple of 16: 3600 or 5952)
__host__ __device__ constexpr int work_bytes(bool f64) {
  return FT_OFF + D_N * (f64 ? 8 : 4);
}

constexpr int SMEM_MAX_H = K1_SMEM_MAX_H;
constexpr int F64_MIN_H = K1_F64_MIN_H;
constexpr int WARPS_SMEM = 2;             // scenarios a block, either store
constexpr int WARPS_GLOBAL = 4;

constexpr float TOL = 1e-6f;
constexpr float D_MAX = 1e6f;
constexpr float REG = 1e-6f;
constexpr float EPS = 1e-20f;
constexpr float GRAVITY = 9.8f;

struct Args {
  const float* x0;       // (B, 12)
  const float* xref;     // (B, H, 12)
  const float* A;        // (B, H, 12, 12)
  const float* Bm;       // (B, 12, 12)
  const float* contact;  // (B, H, 4)
  const float* qw;       // (B, 12), or (12) with qw_stride 0
  const float* rw;
  const float* mu;       // (B), or (1) with mu_stride 0
  const float* fz;
  const float* u0;       // (B, 12 H) warm start, or null
  float* u;              // (B, 12 H)
  float* gap;            // (B)
  float* lam;            // (B, H, 24)
  float* scr;            // (B, H, ST_PER_STAGE) when the store is global
  int qw_stride, rw_stride, mu_stride, fz_stride;
  int B, H, iters;
  float dt;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ double2 ld2d(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}

// the first 4 n elements of a 16-byte aligned row, by 16-byte loads (n is a
// constant wherever the callers are unrolled)
__device__ __forceinline__ void ld_row(const float* p, float r[NX],
                                       int n = 3) {
#pragma unroll
  for (int v = 0; v < n; ++v) {
    const float4 t = ld4(p + 4 * v);
    r[4 * v] = t.x;
    r[4 * v + 1] = t.y;
    r[4 * v + 2] = t.z;
    r[4 * v + 3] = t.w;
  }
}

__device__ __forceinline__ void ld_row(const double* p, double r[NX],
                                       int n = 3) {
#pragma unroll
  for (int v = 0; v < 2 * n; ++v) {
    const double2 t = ld2d(p + 2 * v);
    r[2 * v] = t.x;
    r[2 * v + 1] = t.y;
  }
}

// a contiguous 12x12 of device memory in flight, five floats a lane: the
// sweeps load A_k a stage ahead of its use, so that the load's latency
// hides behind a stage, and store it into the work area when the stage
// starts (the caller syncs the warp around the store)
struct TileRegs {
  float v[5];
  __device__ __forceinline__ void load(const float* src, int lane) {
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int e = 32 * t + lane;
      if (e < MAT) v[t] = src[e];
    }
  }
  __device__ __forceinline__ void store(float* dst, int lane) const {
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const int e = 32 * t + lane;
      if (e < MAT) dst[e] = v[t];
    }
  }
};

// The product lane (i, h) owns row i, columns 4h..4h+3 and 8+2h, 9+2h of a
// 12x12 result: one float4 and one float2 of a row.
__device__ __forceinline__ int pcol(int h, int q) {
  return q < 4 ? 4 * h + q : 8 + 2 * h + (q - 4);
}

// the six columns pcol(h, 0..5) of a row
__device__ __forceinline__ void ld_cols(const float* row, int h, float y[6]) {
  const float4 y4 = ld4(row + 4 * h);
  const float2 y2 = ld2(row + 8 + 2 * h);
  y[0] = y4.x;
  y[1] = y4.y;
  y[2] = y4.z;
  y[3] = y4.w;
  y[4] = y2.x;
  y[5] = y2.y;
}

__device__ __forceinline__ void ld_cols(const double* row, int h,
                                        double y[6]) {
  const double2 a = ld2d(row + 4 * h), b = ld2d(row + 4 * h + 2),
                c = ld2d(row + 8 + 2 * h);
  y[0] = a.x;
  y[1] = a.y;
  y[2] = b.x;
  y[3] = b.y;
  y[4] = c.x;
  y[5] = c.y;
}

// c[q] = sum_r X(i, r) Y(r, pcol(h, q)), with X(i, r) = X[i][r] or, for
// XT, X[r][i], accumulated in c's type
template <bool XT, typename TX, typename TY, typename TC>
__device__ __forceinline__ void mm6(const TX* X, const TY* Y, int i, int h,
                                    TC c[6]) {
  // X's row in registers when it is float32; a float64 one element by
  // element, which keeps fewer registers live
  constexpr bool ROW = !XT && sizeof(TX) == 4;
  TX xr[NX];
  if (ROW) ld_row(X + i * NX, xr);
#pragma unroll
  for (int q = 0; q < 6; ++q) c[q] = 0;
#pragma unroll
  for (int r = 0; r < NX; ++r) {
    const TC x = XT ? X[r * NX + i] : ROW ? xr[r] : X[i * NX + r];
    TY y[6];
    ld_cols(Y + r * NX, h, y);
#pragma unroll
    for (int q = 0; q < 6; ++q) c[q] += x * (TC)y[q];
  }
}

__device__ __forceinline__ void st6(float* row, int h, const float c[6]) {
  *reinterpret_cast<float4*>(row + 4 * h) = float4{c[0], c[1], c[2], c[3]};
  *reinterpret_cast<float2*>(row + 8 + 2 * h) = float2{c[4], c[5]};
}

__device__ __forceinline__ void st6(double* row, int h, const double c[6]) {
  *reinterpret_cast<double2*>(row + 4 * h) = double2{c[0], c[1]};
  *reinterpret_cast<double2*>(row + 4 * h + 2) = double2{c[2], c[3]};
  *reinterpret_cast<double2*>(row + 8 + 2 * h) = double2{c[4], c[5]};
}

// a float copy of the six values into a row of the per-stage store
template <typename T>
__device__ __forceinline__ void st6f(float* row, int h, const T c[6]) {
  float f[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) f[q] = (float)c[q];
  st6(row, h, f);
}

// the mask of leg l from the stage's four contact flags
__device__ __forceinline__ float leg_mask(const float4& cm, int l) {
  return l == 0 ? cm.x : l == 1 ? cm.y : l == 2 ? cm.z : cm.w;
}

// the lane's constants: row c % 6 of G(mu) for one leg's force, and h
struct Con {
  float gx, gy, gz, h;
};

__device__ __forceinline__ float g_row(const Con& g, float f0, float f1,
                                       float f2) {
  return g.gx * f0 + g.gy * f1 + g.gz * f2;
}

// solve (L L^T) y = v in place, y in registers, in the old kernel's order
// of accumulation (forward by 16-byte rows of L, backward by its columns).
// piv holds the pivots L[i][i], by which the solve divides (DIV, as
// LAPACK's triangular solves do), or their reciprocals, by which it
// multiplies.
template <bool DIV, typename T>
__device__ __forceinline__ void cho_solve_regs(const T* L, const T* piv,
                                               T y[NX]) {
  if constexpr (sizeof(T) == 8) {
    // float64 (the factor sweep's K solve): the same sums, with element
    // loads, which keep fewer registers live
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T acc = y[i];
#pragma unroll
      for (int j = 0; j < i; ++j) acc -= L[i * NX + j] * y[j];
      y[i] = DIV ? acc / piv[i] : acc * piv[i];
    }
#pragma unroll
    for (int i = NX - 1; i >= 0; --i) {
      T acc = y[i];
#pragma unroll
      for (int j = i + 1; j < NX; ++j) acc -= L[j * NX + i] * y[j];
      y[i] = DIV ? acc / piv[i] : acc * piv[i];
    }
    return;
  }
  T inv[NX];
  ld_row(piv, inv);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T lr[NX];
    ld_row(L + i * NX, lr, (i + 3) / 4);
    T acc = y[i];
#pragma unroll
    for (int j = 0; j < i; ++j) acc -= lr[j] * y[j];
    y[i] = DIV ? acc / inv[i] : acc * inv[i];
  }
#pragma unroll
  for (int i = NX - 1; i >= 0; --i) {
    T acc = y[i];
#pragma unroll
    for (int j = i + 1; j < NX; ++j) acc -= L[j * NX + i] * y[j];
    y[i] = DIV ? acc / inv[i] : acc * inv[i];
  }
}

// the same for a vector held one element a lane (lane i < 12 holds v_i):
// every lane solves the whole vector and keeps its own element
template <bool DIV>
__device__ __forceinline__ float cho_solve_vec(const float* L,
                                               const float* piv, float v,
                                               int ri) {
  float y[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) y[j] = __shfl_sync(FULL, v, j);
  cho_solve_regs<DIV>(L, piv, y);
  float out = y[0];
#pragma unroll
  for (int j = 1; j < NX; ++j) out = ri == j ? y[j] : out;
  return out;
}

// G^T w for the row lane's force component: w is held one constraint a lane
// (lane c < 24); lane i < 12 gathers the six rows of its leg
__device__ __forceinline__ float gt_row(float w, float mu, int ri) {
  const int base = 6 * (ri / 3);
  float v[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) v[r] = __shfl_sync(FULL, w, base + r);
  const int a = ri % 3;
  return a == 0 ? -v[0] + v[1]
       : a == 1 ? -v[2] + v[3]
                : -mu * (v[0] + v[1] + v[2] + v[3]) + v[4] - v[5];
}

// SMEM: the per-stage store in shared memory (else device scratch); F64:
// the factor sweep in float64 (else float32)
template <bool SMEM, bool F64>
__global__ void __launch_bounds__(32 * (SMEM ? WARPS_SMEM : WARPS_GLOBAL))
riccati_ipm_kernel(Args a) {
  using FT = typename std::conditional<F64, double, float>::type;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpb = blockDim.x >> 5;
  const int b = blockIdx.x * wpb + warp;
  if (b >= a.B) return;
  const int H = a.H;
  float* w = reinterpret_cast<float*>(smem + warp * work_bytes(F64));
  FT* wd = reinterpret_cast<FT*>(smem + warp * work_bytes(F64) + FT_OFF);
  float* st = SMEM ? reinterpret_cast<float*>(smem + wpb * work_bytes(F64)) +
                         (size_t)warp * H * ST_PER_STAGE
                   : a.scr + (size_t)b * H * ST_PER_STAGE;

  // lane roles: row lane ri (lanes >= 12 shadow lane 11), constraint lane
  // ci (lanes >= 24 shadow lane 23), product lane (pi, ph) (lanes >= 24
  // shadow row 11)
  const bool rv = lane < NX, cv = lane < NCON, pv = lane < 2 * NX;
  const int ri = rv ? lane : NX - 1;
  const int ci = cv ? lane : NCON - 1;
  const int leg = ci / 6, row = ci % 6;
  const int pi = pv ? lane >> 1 : NX - 1, ph = lane & 1;
  const float mu = a.mu[(size_t)b * a.mu_stride];
  const float fz = a.fz[(size_t)b * a.fz_stride];
  const float qw = a.qw[(size_t)b * a.qw_stride + ri];
  const float rw = a.rw[(size_t)b * a.rw_stride + ri];
  Con g;
  g.gx = row == 0 ? -1.0f : row == 1 ? 1.0f : 0.0f;
  g.gy = row == 2 ? -1.0f : row == 3 ? 1.0f : 0.0f;
  g.gz = row < 4 ? -mu : row == 4 ? 1.0f : -1.0f;
  g.h = row == 4 ? fz : 0.0f;
  const float m = (float)(H * NCON);
  K1_SPANS_BEGIN
  const float* A = a.A + (size_t)b * H * MAT;
  const float* cont = a.contact + (size_t)b * H * 4;
  const float* xref = a.xref + (size_t)b * H * NX;
  auto stage = [&](int k) { return st + (size_t)k * ST_PER_STAGE; };
  auto Ak = [&](int k) { return A + (size_t)k * MAT; };
  TileRegs pa;                                   // A_k in flight

  pa.load(a.Bm + (size_t)b * MAT, lane);
  pa.store(w + W_BM, lane);
  const float* Bs = w + W_BM;

  // initial iterate: primal warm start (swing legs masked) with the slacks
  // clipped interior and the duals recentred, or the cold start
  const bool warm = a.u0 != nullptr;
  for (int k = 0; k < H; ++k) {
    if (rv)
      stage(k)[ST_U + ri] =
          warm ? a.u0[(size_t)b * H * NX + k * NX + ri] * cont[k * 4 + ri / 3]
               : 0.0f;
  }
  __syncwarp();
  for (int k = 0; k < H; ++k) {
    const float* U = stage(k) + ST_U + 3 * leg;
    const float s = fmaxf(g.h - g_row(g, U[0], U[1], U[2]),
                          warm ? 0.1f : 1.0f);
    if (cv) {
      stage(k)[ST_S + ci] = s;
      stage(k)[ST_LAM + ci] = warm ? fminf(fmaxf(1.0f / s, 1e-3f), 1e2f)
                                   : 1.0f;
    }
  }
  __syncwarp();

  // the constraint lane's slack, dual and primal residual G u + s - h at
  // stage k
  auto load_con = [&](int k, float& s, float& lm, float& rp) {
    const float* st_k = stage(k);
    const float* U = st_k + ST_U + 3 * leg;
    s = st_k[ST_S + ci];
    lm = st_k[ST_LAM + ci];
    rp = g_row(g, U[0], U[1], U[2]) + s - g.h;
  };
  // slack and dual directions from the leg's force direction du at `off`
  // (ds = -(r_prim + G du), dlam = -(rc + lam ds) / s)
  auto con_dirs = [&](int k, int off, float s, float lm, float rp, float rc,
                      float& ds, float& dl) {
    const float* D = stage(k) + off + 3 * leg;
    ds = -(rp + g_row(g, D[0], D[1], D[2]));
    dl = -(rc + lm * ds) / fmaxf(s, EPS);
  };
  // complementarity target: lam s (affine predictor) or lam s + clip(ds_a
  // dl_a) - sigma mu_gap (corrector, from the stored affine direction)
  auto con_rc = [&](int k, float s, float lm, float rp, bool corr,
                    float sigma, float mu_gap) {
    if (!corr) return lm * s;
    float ds, dl;
    con_dirs(k, ST_DUA, s, lm, rp, lm * s, ds, dl);
    const float c = fminf(fmaxf(ds * dl, -10.0f * mu_gap), 10.0f * mu_gap);
    return lm * s + c - sigma * mu_gap;
  };

  // one Newton direction: du = -(Riccati)^-1 g with
  // g_k = r_dual_k + G^T ((lam r_prim - rc) / s), into the store at `dst`
  auto lqr_solve = [&](bool corr, float sigma, float mu_gap, int dst) {
    float ps = 0.0f;
    pa.load(Ak(H - 1), lane);
    for (int k = H - 1; k >= 0; --k) {
      float* st_k = stage(k);
      __syncwarp();
      pa.store(w + W_A, lane);
      if (k > 0) pa.load(Ak(k - 1), lane);
      float s, lm, rp;
      load_con(k, s, lm, rp);
      const float rc = con_rc(k, s, lm, rp, corr, sigma, mu_gap);
      const float wc = (lm * rp - rc) / fmaxf(s, EPS);
      const float mk = cont[k * 4 + ri / 3];
      float psj[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) psj[j] = __shfl_sync(FULL, ps, j);
      float kff = st_k[ST_RD + ri] + gt_row(wc, mu, ri);
#pragma unroll
      for (int j = 0; j < NX; ++j) kff += (Bs[j * NX + ri] * mk) * psj[j];
      __syncwarp();
      float pn = 0.0f;
      K1_SPAN(14);
      kff = -cho_solve_vec<F64>(st_k + ST_L, st_k + ST_PIV, kff, ri);
      K1_SPAN(15);
#pragma unroll
      for (int j = 0; j < NX; ++j)
        pn += w[W_A + j * NX + ri] * psj[j] +
              st_k[ST_HUX + j * NX + ri] * __shfl_sync(FULL, kff, j);
      ps = pn;
      if (rv) st_k[ST_KFF + ri] = kff;
      K1_SPAN(13);
    }
    float dx = 0.0f;
    pa.load(Ak(0), lane);
    for (int k = 0; k < H; ++k) {
      float* st_k = stage(k);
      __syncwarp();
      pa.store(w + W_A, lane);
      if (k + 1 < H) pa.load(Ak(k + 1), lane);
      const float4 cm = ld4(cont + 4 * k);
      __syncwarp();
      float dxj[NX], kr[NX], ar[NX], br[NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) dxj[j] = __shfl_sync(FULL, dx, j);
      ld_row(st_k + ST_K + ri * NX, kr);
      ld_row(w + W_A + ri * NX, ar);
      ld_row(Bs + ri * NX, br);
      float du = st_k[ST_KFF + ri];
#pragma unroll
      for (int j = 0; j < NX; ++j) du += kr[j] * dxj[j];
      if (rv) st_k[dst + ri] = du;
      float dxn = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j)
        dxn += ar[j] * dxj[j] +
               (br[j] * leg_mask(cm, j / 3)) * __shfl_sync(FULL, du, j);
      dx = dxn;
    }
    __syncwarp();
  };

  // largest step in (0, 1] keeping v + a dv >= 0
  auto ratio_min = [](float al, float v, float dv) {
    return dv < 0.0f ? fminf(al, -v / dv) : al;
  };

  K1_SPAN(0);
  for (int it = 0; it < a.iters; ++it) {
    // rollout x_{k+1} = A_k x_k + B_k u_k + d from x0 under the current u
    float x = a.x0[(size_t)b * NX + ri];
    pa.load(Ak(0), lane);
    for (int k = 0; k < H; ++k) {
      float* st_k = stage(k);
      __syncwarp();
      pa.store(w + W_A, lane);
      if (k + 1 < H) pa.load(Ak(k + 1), lane);
      const float4 cm = ld4(cont + 4 * k);
      __syncwarp();
      float ar[NX], br[NX], uk[NX];
      ld_row(w + W_A + ri * NX, ar);
      ld_row(Bs + ri * NX, br);
      ld_row(st_k + ST_U, uk);
      float xn = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j)
        xn += ar[j] * __shfl_sync(FULL, x, j) +
              (br[j] * leg_mask(cm, j / 3)) * uk[j];
      x = xn + (ri == NX - 1 ? -GRAVITY * a.dt : 0.0f);
      if (rv) st_k[ST_VEC + ri] = x;
    }
    __syncwarp();
    K1_SPAN(1);
    // the adjoint psi_k = Q (x_{k+1} - xref_k) + A_{k+1}^T psi_{k+1}, and
    // with it the dual residual r = R u + B^T psi + G^T lam; the gap; the
    // primal residual
    float psi = 0.0f, rd_max = 0.0f, rp_max = 0.0f, sl = 0.0f;
    pa.load(Ak(H - 1), lane);
    float xr = xref[(H - 1) * NX + ri];
    for (int k = H - 1; k >= 0; --k) {
      float* st_k = stage(k);
      float pk = qw * (st_k[ST_VEC + ri] - xr);
      if (k > 0) xr = xref[(k - 1) * NX + ri];
      if (k + 1 < H) {
#pragma unroll
        for (int j = 0; j < NX; ++j)
          pk += w[W_A + j * NX + ri] * __shfl_sync(FULL, psi, j);
      }
      psi = pk;
      __syncwarp();
      pa.store(w + W_A, lane);                     // A_k, read at k - 1
      if (k > 0) pa.load(Ak(k - 1), lane);
      float s, lm, rp;
      load_con(k, s, lm, rp);
      if (cv) {
        sl += s * lm;
        rp_max = fmaxf(rp_max, fabsf(rp));
      }
      const float mk = cont[k * 4 + ri / 3];
      float rd = rw * st_k[ST_U + ri] + gt_row(lm, mu, ri);
#pragma unroll
      for (int j = 0; j < NX; ++j)
        rd += (Bs[j * NX + ri] * mk) * __shfl_sync(FULL, psi, j);
      if (rv) st_k[ST_RD + ri] = rd;
      rd_max = fmaxf(rd_max, fabsf(rd));
      __syncwarp();
    }
    const float mu_gap = warp_sum(sl) / m;
    K1_SPAN(2);
    rp_max = warp_max(rp_max);
    rd_max = warp_max(rd_max);

    // backward Riccati factor sweep: L, K, Hux per stage into the store
    // (float copies; the sweep's own blocks are FT).
    // Hu_k = blockdiag(G^T D G) + diag(r + reg), with D = clip(lam / s).
    for (int e = lane; e < MAT; e += 32) wd[D_P + e] = 0;
    pa.load(Ak(H - 1), lane);
    for (int k = H - 1; k >= 0; --k) {
      float* st_k = stage(k);
      __syncwarp();
      pa.store(w + W_A, lane);
      if (k > 0) pa.load(Ak(k - 1), lane);
      {
        const float s = st_k[ST_S + ci], lm = st_k[ST_LAM + ci];
        if (cv) w[W_D + ci] = fminf(fmaxf(lm / fmaxf(s, EPS), 0.0f), D_MAX);
      }
      if (rv) wd[D_P + ri * NX + ri] += qw;                // W = P + Q
      const float4 cm = ld4(cont + 4 * k);
      __syncwarp();
      FT c[6], d[6];
      mm6<true>(Bs, wd + D_P, pi, ph, c);                  // T = B_k^T W
      const float mi = leg_mask(cm, pi / 3);
#pragma unroll
      for (int q = 0; q < 6; ++q) c[q] *= mi;
      if (pv) st6(wd + D_T + pi * NX, ph, c);
      __syncwarp();
      mm6<false>(wd + D_T, Bs, pi, ph, c);         // C = T B_k, Hux = T A_k
      mm6<false>(wd + D_T, w + W_A, pi, ph, d);
#pragma unroll
      for (int q = 0; q < 6; ++q) c[q] *= leg_mask(cm, pcol(ph, q) / 3);
      if (pv) {
        st6(wd + D_C + pi * NX, ph, c);
        st6(wd + D_H + pi * NX, ph, d);
        st6f(st_k + ST_HUX + pi * NX, ph, d);
      }
      __syncwarp();
      if (rv) {                                            // C += Hu
        FT* C = wd + D_C + ri * NX;
        const float* D = w + W_D + 6 * (ri / 3);
        const int o = 3 * (ri / 3), r3 = ri % 3;
        C[ri] += rw + REG;
        if (r3 == 0) {
          C[o] += D[0] + D[1];
          C[o + 2] += mu * (D[0] - D[1]);
        } else if (r3 == 1) {
          C[o + 1] += D[2] + D[3];
          C[o + 2] += mu * (D[2] - D[3]);
        } else {
          C[o] += mu * (D[0] - D[1]);
          C[o + 1] += mu * (D[2] - D[3]);
          C[o + 2] += mu * mu * (D[0] + D[1] + D[2] + D[3]) + D[4] + D[5];
        }
      }
      __syncwarp();
      K1_SPAN(3);
      // chol12(C) on the row lanes, right-looking; A_k^T W beside it, on
      // the product lanes, with no barrier between the two
      FT r12[NX];
      ld_row(wd + D_C + ri * NX, r12);
      FT inv_d = 0, piv_d = 0;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        const FT x = __shfl_sync(FULL, r12[j], j);
        FT dj, inv;
        if constexpr (F64) {             // 1 / sqrt(x) within an ulp
          inv = rsqrt(x);
          dj = x * inv;
        } else {
          dj = sqrtf(x);
          inv = 1.0f / dj;
        }
        r12[j] = lane == j ? dj : r12[j] * inv;
        inv_d = lane == j ? inv : inv_d;
        piv_d = lane == j ? dj : piv_d;
#pragma unroll
        for (int cc = j + 1; cc < NX; ++cc)
          r12[cc] -= r12[j] * __shfl_sync(FULL, r12[j], cc);
      }
      mm6<true>(w + W_A, wd + D_P, pi, ph, c);             // A_k^T W
      __syncwarp();
      if (rv) {
        float f12[NX];
#pragma unroll
        for (int v = 0; v < NX; ++v) {
          wd[D_C + ri * NX + v] = r12[v];
          f12[v] = (float)r12[v];
        }
#pragma unroll
        for (int v = 0; v < 3; ++v)
          *reinterpret_cast<float4*>(st_k + ST_L + ri * NX + 4 * v) =
              float4{f12[4 * v], f12[4 * v + 1], f12[4 * v + 2],
                     f12[4 * v + 3]};
        wd[D_PIV + ri] = inv_d;
        st_k[ST_PIV + ri] = (float)(F64 ? piv_d : inv_d);
      }
      if (pv) st6(wd + D_T + pi * NX, ph, c);
      __syncwarp();
      K1_SPAN(4);
      if (rv) {                               // K = -Huu^-1 Hux, column ri
        FT y[NX];
#pragma unroll
        for (int i = 0; i < NX; ++i) y[i] = wd[D_H + i * NX + ri];
        cho_solve_regs<false>(wd + D_C, wd + D_PIV, y);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          wd[D_P + i * NX + ri] = -y[i];
          st_k[ST_K + i * NX + ri] = (float)-y[i];
        }
      }
      __syncwarp();
      K1_SPAN(5);
      mm6<false>(wd + D_T, w + W_A, pi, ph, c);    // P' = A^T W A + Hux^T K
      mm6<true>(wd + D_H, wd + D_P, pi, ph, d);
#pragma unroll
      for (int q = 0; q < 6; ++q) c[q] += d[q];
      if (pv) st6(wd + D_C + pi * NX, ph, c);              // (L is stored)
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 6; ++q)                          // P symmetric
        c[q] = (FT)0.5 * (c[q] + wd[D_C + pcol(ph, q) * NX + pi]);
      if (pv) st6(wd + D_P + pi * NX, ph, c);
    }
    __syncwarp();

    K1_SPAN(6);
    lqr_solve(false, 0.0f, mu_gap, ST_DUA);
    K1_SPAN(7);

    // affine step lengths, then the centring parameter from mu_aff
    float ap = 1.0f, ad = 1.0f;
    for (int k = 0; k < H; ++k) {
      float s, lm, rp, ds, dl;
      load_con(k, s, lm, rp);
      con_dirs(k, ST_DUA, s, lm, rp, lm * s, ds, dl);
      ap = ratio_min(ap, s, ds);
      ad = ratio_min(ad, lm, dl);
    }
    ap = warp_min(ap);
    ad = warp_min(ad);
    float saff = 0.0f;
    for (int k = 0; k < H; ++k) {
      float s, lm, rp, ds, dl;
      load_con(k, s, lm, rp);
      con_dirs(k, ST_DUA, s, lm, rp, lm * s, ds, dl);
      if (cv) saff += (s + ap * ds) * (lm + ad * dl);
    }
    K1_SPAN(8);
    const float mu_aff = warp_sum(saff) / m;
    const float ratio = mu_aff / fmaxf(mu_gap, EPS);
    const float sigma = fminf(fmaxf(ratio * ratio * ratio, 1e-4f), 0.9f);

    lqr_solve(true, sigma, mu_gap, ST_DU);
    K1_SPAN(9);

    // corrector step lengths and the non-finite guard
    ap = 1.0f;
    ad = 1.0f;
    bool finite = true;
    for (int k = 0; k < H; ++k) {
      float s, lm, rp, ds, dl;
      load_con(k, s, lm, rp);
      const float rc = con_rc(k, s, lm, rp, true, sigma, mu_gap);
      con_dirs(k, ST_DU, s, lm, rp, rc, ds, dl);
      const float* du = stage(k) + ST_DU + 3 * leg;
      finite = finite && isfinite(du[0]) && isfinite(du[1]) &&
               isfinite(du[2]) && isfinite(ds) && isfinite(dl);
      ap = ratio_min(ap, s, ds);
      ad = ratio_min(ad, lm, dl);
    }
    K1_SPAN(10);
    ap = 0.99f * warp_min(ap);
    ad = 0.99f * warp_min(ad);
    finite = __all_sync(FULL, finite);

    // freeze on convergence (gap, primal and dual residual) or on a
    // non-finite direction: the iterate stays as it is from here on
    const bool conv = mu_gap < TOL && rp_max < 1e3f * TOL && rd_max < 1e3f * TOL;
    if (conv || !finite) break;

    // each constraint lane reads and writes its own slack and dual only
    for (int k = 0; k < H; ++k) {
      float s, lm, rp, ds, dl;
      load_con(k, s, lm, rp);
      const float rc = con_rc(k, s, lm, rp, true, sigma, mu_gap);
      con_dirs(k, ST_DU, s, lm, rp, rc, ds, dl);
      if (cv) {
        stage(k)[ST_S + ci] = s + ap * ds;
        stage(k)[ST_LAM + ci] = lm + ad * dl;
      }
    }
    __syncwarp();
    // u last: the slack and dual updates above read the old u
    for (int k = 0; k < H; ++k)
      if (rv) stage(k)[ST_U + ri] += ap * stage(k)[ST_DU + ri];
    __syncwarp();
    K1_SPAN(11);
  }

  float sl = 0.0f;
  for (int k = 0; k < H; ++k) {
    const float* st_k = stage(k);
    if (rv)
      a.u[(size_t)b * H * NX + k * NX + ri] =
          st_k[ST_U + ri] * cont[k * 4 + ri / 3];
    if (cv) {
      sl += st_k[ST_S + ci] * st_k[ST_LAM + ci];
      a.lam[(size_t)b * H * NCON + k * NCON + ci] = st_k[ST_LAM + ci];
    }
  }
  sl = warp_sum(sl);
  if (lane == 0) a.gap[b] = sl / m;
  K1_SPAN(12);
  K1_SPANS_END
}

}  // namespace

// Device scratch floats per scenario at horizon H: the per-stage store when
// it does not fit in shared memory, else none.
extern "C" int riccati_ipm_scratch_floats(int H) {
  return H <= SMEM_MAX_H ? 0 : H * ST_PER_STAGE;
}

// Launch on `stream`. Arrays f32, batch-first and contiguous (see Args); a
// stride of 0 shares qw, rw, mu or fz across the batch. u0 (B, 12 H) is the
// warm start or null. Returns cudaGetLastError() after the launch.
extern "C" int riccati_ipm_launch(const float* x0, const float* xref,
                                  const float* A, const float* Bm,
                                  const float* contact, const float* qw,
                                  const float* rw, const float* mu,
                                  const float* fz, int qw_stride,
                                  int rw_stride, int mu_stride,
                                  int fz_stride, const float* u0, float* u,
                                  float* gap, float* lam, float* scratch,
                                  int B, int H, int iters, float dt,
                                  void* stream) {
  const Args a{x0,  xref, A,   Bm,        contact,   qw,        rw,
               mu,  fz,   u0,  u,         gap,       lam,       scratch,
               qw_stride, rw_stride, mu_stride, fz_stride, B, H, iters, dt};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool smem = H <= SMEM_MAX_H, f64 = H >= F64_MIN_H;
  const int wpb = smem ? WARPS_SMEM : WARPS_GLOBAL;
  const int bytes = wpb * (work_bytes(f64) +
                           (smem ? H * ST_PER_STAGE * (int)sizeof(float) : 0));
  void (*kernel)(Args) = smem ? (f64 ? riccati_ipm_kernel<true, true>
                                     : riccati_ipm_kernel<true, false>)
                              : (f64 ? riccati_ipm_kernel<false, true>
                                     : riccati_ipm_kernel<false, false>);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + wpb - 1) / wpb, 32 * wpb, bytes, s>>>(a);
  return (int)cudaGetLastError();
}
