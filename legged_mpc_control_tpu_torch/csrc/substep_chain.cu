// Kernels K2 and K3: every low-level/sim substep of one closed-loop MPC tick
// in one launch. K2 (kf_type 0): the controller reads the true state. K3
// (kf_type 1): the 18-state contact-gated KF runs inside every substep and
// the controller reads its estimate.
//
// Replaces: legged_mpc_control_tpu/ops/substep_pallas.py,
//           substep_chain_fused with kf_type=0 (K2) and kf_type=1 (K3, the
//           kf1 body of _make_kernel).
// Plain version: legged_mpc_control_tpu_torch/ops/substep_kernel.py,
//           substep_chain_plain (the per-substep loop of the ported modules).
//
// Per substep: J^T tau + analytic IK + PD (control/low_level.py), the safety
// gate (control/safety.py), and the SRB world step (sim/srb_sim.py): realized
// GRFs in the friction pyramid, contact make/break, trunk dynamics, anchored
// stance closure, swing joint dynamics. After the last substep the final
// state's Feedback products and Raibert footholds are written as the 150-row
// fb block (ops/substep_kernel.py:FB_ROWS).
//
// What bounds it on an H100: per-scenario latency, not FLOPs or bytes. A
// scenario is a chain of a few thousand dependent scalar operations (trig,
// 3x3 solves, four-branch IK per leg, twice per substep), on ~150 input and
// ~240 output floats. The port's first design ran a scenario on one thread:
// at B=4096 that left 64 SMs with two warps each (K2) or 128 SMs with one
// (K3), a chain of every leg's work one after another, and spills (K3's
// covariance in local memory).
//
// Design: a scenario over a group of lanes, a warp a block: K2 16 lanes,
// four a leg (two scenarios a warp); K3 8 lanes, two a leg (four scenarios
// a warp). Leg l's lanes run its Jacobian, J^T tau, PD, the safety gate's
// GRF clamp, contact make and break, and its stance closure or swing, the
// same on each; the analytic IK's four branches are split over them (one
// a lane in K2, two in K3), and all of them then take the first branch of
// least distance, as the one-thread loop over the branches does. The trunk
// step is replicated on every lane of the group (the same operations on
// the same values, so the lanes agree bit for bit); the folds over legs
// (the GRF and torque sums, the joint-speed maximum) gather the four legs'
// values by shuffle and add them in leg order, as the one-thread kernel
// did. Each leg's and branch's expressions are the one-thread kernel's, so
// the rounding follows it (the CPU emulation gives its bits). A ragged last
// warp runs its missing scenarios on the batch's last one and stores
// nothing for them, so every lane takes part in every shuffle. K3 takes
// fewer lanes a scenario than K2 because its filter rows are replicated
// work: with 16 lanes it ran 2048 warps at B=4096 and issued, not waited
// (0.603 ms against 0.434 with 8; PERF.md).
//
// K3 adds the filter to every substep: the predict step and 28 sequential
// scalar measurement rows (estimation/basic_kf.py), in the reference's order.
// The 18x18 covariance P is spread over the group's 8 lanes in registers,
// row r on lane r % 8 (lanes 0 and 1 hold three rows, the others two), with
// the increment dx beside it the same way; the estimate x is replicated.
// Each row's h has at most two nonzeros, so P h is a column pick on every
// lane, gathered by 18 shuffles, and the row's update is a rank-1 update of
// each lane's own rows. The symmetrization reads the transpose through 1.3
// KB of shared memory a scenario.

#include <cuda_runtime.h>
#include <math.h>

// Phase marks, empty in the package's build: tools/k3_spans.py defines them
// (SC_SPANS) to read clock64() around each phase of a substep.
#ifndef SC_SPANS
#define SC_SPANS_BEGIN
#define SC_SPAN(n)
#define SC_SPANS_END
#endif

namespace {

// packed input rows (ops/substep_kernel.py:IN_ROWS)
constexpr int I_POS = 0, I_QUAT = 3, I_VEL = 7, I_OMEGA = 10, I_Q = 13,
              I_DQ = 25, I_CONTACT = 37, I_ANCHOR = 41, I_OSTATE = 53,
              I_OINPUT = 71, I_MASS = 95, I_MU = 96, I_KP = 97, I_KD = 100,
              I_INERTIA = 103, I_RHO = 112, I_DFP = 132, I_GSPEED = 144,
              I_THRESH = 145, I_VELD = 146, N_IN = 149;
// packed output rows (ops/substep_kernel.py:OUT_ROWS)
constexpr int O_POS = 0, O_QUAT = 3, O_VEL = 7, O_OMEGA = 10, O_Q = 13,
              O_DQ = 25, O_CONTACT = 37, O_ANCHOR = 41, O_LASTACC = 53,
              O_QT = 56, O_DQT = 68, O_TAUT = 80, O_FB = 92, N_OUT = 242;
// the fb block's rows (ops/substep_kernel.py:FB_ROWS), from O_FB
constexpr int F_EUL = 0, F_ROT = 3, F_FPR = 12, F_FPA = 24, F_FVR = 36,
              F_FVA = 48, F_FVW = 60, F_JAC = 72, F_FS = 108, F_SIG = 112,
              F_BOOL = 116, F_TAU = 120, F_RAI = 132, F_IMUA = 144,
              F_IMUG = 147;
// kf_type 1 appends the filter state x (18) and P (18x18, row-major) to
// both (ops/substep_kernel.py:KF_ROWS)
constexpr int NS = 18;
constexpr int I_KFX = N_IN, I_KFP = N_IN + NS, N_IN_KF = N_IN + NS + NS * NS;
constexpr int O_KFX = N_OUT, O_KFP = N_OUT + NS,
              N_OUT_KF = N_OUT + NS + NS * NS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 32;               // a warp a block
// lanes a scenario: K2 four a leg, one an IK branch; K3 two a leg
__host__ __device__ constexpr int lanes(bool kf1) { return kf1 ? 8 : 16; }
constexpr int KF_G = lanes(true);
constexpr int KF_SLOTS = 3;               // P rows a lane: r = g + 8 m

// sim/srb_sim.py, control/safety.py, constants.py
constexpr float LEG_INERTIA = 0.04f;
constexpr float LEG_DAMPING = 0.05f;
constexpr float CONTACT_RELEASE_FZ = 1.0f;
constexpr float ROLL_LIMIT = 1.0f;
constexpr float PITCH_LIMIT = 3.0f;
constexpr float JOINT_VEL_LIMIT = 30.0f;
constexpr float GRAVITY_EST = 9.81f;
constexpr float FOOT_DELTA_X_LIMIT = 0.8f;
constexpr float FOOT_DELTA_Y_LIMIT = 0.8f;
// estimation/basic_kf.py (reference: BasicKF.h:15-20)
constexpr float KF_Q_PIMU = 0.01f;
constexpr float KF_Q_VIMU = 0.01f;
constexpr float KF_Q_PFOOT = 0.01f;
constexpr float KF_R_PFOOT = 0.001f;
constexpr float KF_R_VFOOT = 0.1f;
constexpr float KF_R_ZFOOT = 0.001f;

struct V3 {
  float x[3];
  __device__ float& operator[](int i) { return x[i]; }
  __device__ float operator[](int i) const { return x[i]; }
};
struct M3 {
  float a[3][3];
};

__device__ V3 mv(const M3& R, const V3& v) {
  V3 o;
  for (int i = 0; i < 3; ++i)
    o[i] = R.a[i][0] * v[0] + R.a[i][1] * v[1] + R.a[i][2] * v[2];
  return o;
}
__device__ V3 mtv(const M3& R, const V3& v) {
  V3 o;
  for (int i = 0; i < 3; ++i)
    o[i] = R.a[0][i] * v[0] + R.a[1][i] * v[1] + R.a[2][i] * v[2];
  return o;
}
__device__ V3 cross(const V3& a, const V3& b) {
  V3 o;
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
  return o;
}

// quaternion [w,x,y,z] -> world-from-body rotation (ops/so3.py)
__device__ M3 rotmat(const float q[4]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  M3 R;
  R.a[0][0] = 1 - 2 * (yy + zz); R.a[0][1] = 2 * (xy - wz); R.a[0][2] = 2 * (xz + wy);
  R.a[1][0] = 2 * (xy + wz); R.a[1][1] = 1 - 2 * (xx + zz); R.a[1][2] = 2 * (yz - wx);
  R.a[2][0] = 2 * (xz - wy); R.a[2][1] = 2 * (yz + wx); R.a[2][2] = 1 - 2 * (xx + yy);
  return R;
}

// roll, pitch, yaw (ops/so3.py:quat_to_euler)
__device__ V3 euler(const float q[4]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  V3 e;
  e[0] = atan2f(2.0f * (w * x + y * z), 1.0f - 2.0f * (x * x + y * y));
  e[1] = asinf(fminf(fmaxf(2.0f * (w * y - z * x), -1.0f), 1.0f));
  e[2] = atan2f(2.0f * (w * z + x * y), 1.0f - 2.0f * (y * y + z * z));
  return e;
}

// adjugate and determinant of a 3x3 (ops/la3.py)
__device__ float adj_det(const M3& J, M3& adj) {
  adj.a[0][0] = J.a[1][1] * J.a[2][2] - J.a[1][2] * J.a[2][1];
  adj.a[0][1] = J.a[0][2] * J.a[2][1] - J.a[0][1] * J.a[2][2];
  adj.a[0][2] = J.a[0][1] * J.a[1][2] - J.a[0][2] * J.a[1][1];
  adj.a[1][0] = J.a[1][2] * J.a[2][0] - J.a[1][0] * J.a[2][2];
  adj.a[1][1] = J.a[0][0] * J.a[2][2] - J.a[0][2] * J.a[2][0];
  adj.a[1][2] = J.a[0][2] * J.a[1][0] - J.a[0][0] * J.a[1][2];
  adj.a[2][0] = J.a[1][0] * J.a[2][1] - J.a[1][1] * J.a[2][0];
  adj.a[2][1] = J.a[0][1] * J.a[2][0] - J.a[0][0] * J.a[2][1];
  adj.a[2][2] = J.a[0][0] * J.a[1][1] - J.a[0][1] * J.a[1][0];
  return J.a[0][0] * (J.a[1][1] * J.a[2][2] - J.a[1][2] * J.a[2][1]) -
         J.a[0][1] * (J.a[1][0] * J.a[2][2] - J.a[1][2] * J.a[2][0]) +
         J.a[0][2] * (J.a[1][0] * J.a[2][1] - J.a[1][1] * J.a[2][0]);
}
__device__ V3 solve3(const M3& J, const V3& b) {          // J x = b
  M3 adj;
  const float d = adj_det(J, adj);
  V3 o = mv(adj, b);
  for (int i = 0; i < 3; ++i) o[i] /= d;
  return o;
}
__device__ V3 solve3_t(const M3& J, const V3& b) {        // J^T x = b
  M3 adj;
  const float d = adj_det(J, adj);
  V3 o = mtv(adj, b);
  for (int i = 0; i < 3; ++i) o[i] /= d;
  return o;
}

// leg geometry rho = [ox, oy, d, lt, lc] (models/kinematics.py)
struct Leg {
  float ox, oy, d, lt, lc;
};

__device__ V3 fk(const V3& q, const Leg& g) {
  const float s1 = sinf(q[0]), c1 = cosf(q[0]);
  const float s2 = sinf(q[1]), c2 = cosf(q[1]);
  const float s23 = sinf(q[1] + q[2]), c23 = cosf(q[1] + q[2]);
  const float L = g.lt * c2 + g.lc * c23;
  V3 p;
  p[0] = g.ox - g.lt * s2 - g.lc * s23;
  p[1] = g.oy + g.d * c1 + s1 * L;
  p[2] = g.d * s1 - c1 * L;
  return p;
}

__device__ M3 jac(const V3& q, const Leg& g) {
  const float s1 = sinf(q[0]), c1 = cosf(q[0]);
  const float s2 = sinf(q[1]), c2 = cosf(q[1]);
  const float s23 = sinf(q[1] + q[2]), c23 = cosf(q[1] + q[2]);
  const float L = g.lt * c2 + g.lc * c23;
  const float M = -g.lt * s2 - g.lc * s23;
  M3 J;
  J.a[0][0] = 0.0f; J.a[0][1] = -g.lt * c2 - g.lc * c23; J.a[0][2] = -g.lc * c23;
  J.a[1][0] = -g.d * s1 + c1 * L; J.a[1][1] = s1 * M; J.a[1][2] = s1 * (-g.lc * s23);
  J.a[2][0] = g.d * c1 + s1 * L; J.a[2][1] = -c1 * M; J.a[2][2] = -c1 * (-g.lc * s23);
  return J;
}

__device__ float wrap(float a) { return atan2f(sinf(a), cosf(a)); }

// v of lane `base + l` of the group, for every lane
__device__ __forceinline__ float from(float v, int base, int l) {
  return __shfl_sync(FULL, v, base + l);
}

// analytic IK, the branch nearest q_ref (models/kinematics.py:ik). The leg's
// BR lanes (from lbase) compute 4 / BR of the four candidates each, lane kb
// those from kb 4 / BR on in the one-thread loop's order (a outer, c
// inner); every lane then takes the first candidate of least distance, as
// that loop does.
template <int BR>
__device__ V3 ik(const V3& p, const V3& q_ref, const Leg& g, int kb,
                 int lbase) {
  constexpr int CPL = 4 / BR;
  const float px = p[0] - g.ox, py = p[1] - g.oy, pz = p[2];
  const float L = sqrtf(fmaxf(py * py + pz * pz - g.d * g.d, 1e-12f));
  const float c3 = fminf(fmaxf((px * px + L * L - g.lt * g.lt - g.lc * g.lc) /
                                   (2.0f * g.lt * g.lc),
                               -1.0f),
                         1.0f);
  const float q3_mag = acosf(c3);
  V3 cand[CPL];
  float dist[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int j = kb * CPL + t;
    const float Ls = j < 2 ? L : -L;
    const float q3 = (j & 1) == 0 ? -q3_mag : q3_mag;
    cand[t][0] = wrap(atan2f(pz, py) - atan2f(-Ls, g.d));
    cand[t][1] = wrap(atan2f(-px, Ls) -
                      atan2f(g.lc * sinf(q3), g.lt + g.lc * cosf(q3)));
    cand[t][2] = q3;
    dist[t] = 0.0f;
    for (int i = 0; i < 3; ++i) {
      const float e = wrap(cand[t][i] - q_ref[i]);
      dist[t] += e * e;
    }
  }
  V3 best;
  float best_d = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float dj = from(dist[j % CPL], lbase, j / CPL);
    V3 cj;
    for (int i = 0; i < 3; ++i) cj[i] = from(cand[j % CPL][i], lbase, j / CPL);
    if (j == 0 || dj < best_d) {
      best = cj;
      best_d = dj;
    }
  }
  return best;
}

// sum over the four legs' lanes (leg l's first is BR l) in leg order,
// 0 + v0 + v1 + v2 + v3 (the one-thread kernel's order): the same value on
// every lane of the group
template <int BR>
__device__ __forceinline__ float leg_sum(float v, int base) {
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < 4; ++l) s += from(v, base, BR * l);
  return s;
}

// K3's filter state on lane g of its group: rows g + 8 m (m < KF_SLOTS;
// the third only on lanes 0 and 1) of P and of the increment dx; x
// replicated
struct Kf {
  float p[KF_SLOTS][NS];
  float dx[KF_SLOTS];
  float x[NS];
};

__device__ __forceinline__ bool kf_row_valid(int g, int m) {
  return g + KF_G * m < NS;
}

// element j of a vector held as the rows' slots (v[m] on lane j % 8 holds
// element 8 m + j % 8), on every lane
__device__ __forceinline__ float kf_pick(const float v[KF_SLOTS], int base,
                                         int j) {
  return from(v[j / KF_G], base, j % KF_G);
}

// One sequential scalar row (estimation/basic_kf.py:sequential_update) with
// h = e_j - e_a (a >= 0) or e_j (a < 0): Ph = P h gathered on every lane,
// s = h^T P h + r, K = P h / s, dx += K inn, P -= K (P h)^T on the lane's
// own rows. `meas` is the row's measurement minus h^T xb.
__device__ __forceinline__ void kf_row(Kf& f, int base, int j, int a,
                                       float r, float meas) {
  float own[KF_SLOTS];
#pragma unroll
  for (int m = 0; m < KF_SLOTS; ++m)
    own[m] = a >= 0 ? f.p[m][j] - f.p[m][a] : f.p[m][j];
  float Ph[NS];
#pragma unroll
  for (int c = 0; c < NS; ++c) Ph[c] = kf_pick(own, base, c);
  const float s = (a >= 0 ? Ph[j] - Ph[a] : Ph[j]) + r;
  const float dxj = kf_pick(f.dx, base, j);
  const float inn = a >= 0 ? meas - (dxj - kf_pick(f.dx, base, a))
                           : meas - dxj;
#pragma unroll
  for (int m = 0; m < KF_SLOTS; ++m) {
    const float k = own[m] / s;
    f.dx[m] += k * inn;
#pragma unroll
    for (int c = 0; c < NS; ++c) f.p[m][c] -= k * Ph[c];
  }
}

// One predict + update of the 18-state KF (estimation/basic_kf.py:kf_update,
// reference BasicKF.cpp:72-167) at the substep's new state. Leg l's lanes
// (from 2 l) hold its foot's measurements: Rf = R fpr (FK rows), yv (the leg-odometry
// velocity rows' measurement), yz (the foot height's); infl its noise
// inflation. acc is the control input (world trunk acceleration). `sym` is
// the scenario's 18x18 of shared memory.
__device__ void kf_step(Kf& f, int g, int base, const V3& acc, const V3& Rf,
                        const V3& yv, float yz, float infl, float dt,
                        float* sym) {
  float xb[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) xb[i] = f.x[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xb[i] = f.x[i] + dt * f.x[3 + i];
    xb[3 + i] = f.x[3 + i] + dt * acc[i];
  }
  float inf4[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) inf4[l] = from(infl, base, 2 * l);
#pragma unroll
  for (int m = 0; m < KF_SLOTS; ++m) f.dx[m] = 0.0f;
  // P <- A P A^T + Q with A = I + dt E_{0:3, 3:6}: rows 0-2 (lanes 0-2)
  // take dt times rows 3-5 (lanes 3-5), then every row's columns 0-2 take
  // dt times its columns 3-5
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    const float t = from(f.p[0][c], base, (g + 3) & (KF_G - 1));
    if (g < 3) f.p[0][c] += dt * t;
  }
#pragma unroll
  for (int m = 0; m < KF_SLOTS; ++m)
#pragma unroll
    for (int j = 0; j < 3; ++j) f.p[m][j] += dt * f.p[m][3 + j];
  // Q on the diagonal (registers take constant indices only: the lane's
  // row r is a run-time value, the column c is not)
#pragma unroll
  for (int m = 0; m < KF_SLOTS; ++m) {
    const int r = g + KF_G * m;
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      if (c != r) continue;
      if (c < 3) f.p[m][c] += KF_Q_PIMU * dt / 20.0f;
      else if (c < 6) f.p[m][c] += KF_Q_VIMU * dt * 9.8f / 20.0f;
      else f.p[m][c] += inf4[(c - 6) / 3] * dt * KF_Q_PFOOT;
    }
  }

  // rows 0..11: FK residuals, h = e_{6+3l+a} - e_a
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int j = 6 + 3 * l + a;
      const float e0 = from(Rf[a], base, 2 * l) - (xb[j] - xb[a]);
      kf_row(f, base, j, a, inf4[l] * KF_R_PFOOT, e0);
    }
  // rows 12..23: leg-odometry velocities, h = e_{3+a}
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int j = 3 + a;
      kf_row(f, base, j, -1, inf4[l] * KF_R_VFOOT,
             from(yv[a], base, 2 * l) - xb[j]);
    }
  // rows 24..27: foot heights, h = e_{8+3l}
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int j = 8 + 3 * l;
    kf_row(f, base, j, -1, inf4[l] * KF_R_ZFOOT,
           from(yz, base, 2 * l) - xb[j]);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) f.x[i] = xb[i] + kf_pick(f.dx, base, i);

  // symmetrize through shared memory: p(i, j) = p(j, i) = (p(i, j) +
  // p(j, i)) / 2 for i != j (addition commutes, so both lanes agree)
  __syncwarp();
#pragma unroll
  for (int m = 0; m < KF_SLOTS; ++m)
    if (kf_row_valid(g, m))
#pragma unroll
      for (int c = 0; c < NS; ++c) sym[NS * (g + KF_G * m) + c] = f.p[m][c];
  __syncwarp();
#pragma unroll
  for (int m = 0; m < KF_SLOTS; ++m) {
    const int r = g + KF_G * m;
    if (r < NS)
#pragma unroll
      for (int c = 0; c < NS; ++c)
        if (c != r) f.p[m][c] = 0.5f * (f.p[m][c] + sym[NS * c + r]);
  }
  // the xy-drift suppression (reference: BasicKF.cpp:146)
  const float p00 = from(f.p[0][0], base, 0), p01 = from(f.p[0][1], base, 0);
  const float p10 = from(f.p[0][0], base, 1), p11 = from(f.p[0][1], base, 1);
  if (p00 * p11 - p01 * p10 > 1e-6f) {
#pragma unroll
    for (int m = 0; m < KF_SLOTS; ++m) {
      const int r = g + KF_G * m;
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        if (r < 2 && c < 2) f.p[m][c] *= 0.1f;
        else if (r < 2 || c < 2) f.p[m][c] = 0.0f;
      }
    }
  }
}

template <bool KF1>
__global__ void __launch_bounds__(THREADS)
substep_chain_kernel(const float* __restrict__ in, const int* __restrict__ mode,
                     float* __restrict__ out, int B, int substeps, float dt) {
  constexpr int G = lanes(KF1);
  constexpr int BR = G / 4;                   // lanes a leg
  __shared__ float sym_all[KF1 ? THREADS / G * NS * NS : 1];
  const int lane = threadIdx.x & 31;
  const int g = lane % G;                     // lane in the group
  const int base = lane - g;                  // the group's first lane
  const int l = g / BR;                       // the lane's leg
  const int kb = g % BR;                      // its IK branches' index
  const int lbase = base + BR * l;            // the leg's first lane
  const int b_raw = (blockIdx.x * THREADS + threadIdx.x) / G;
  const bool live = b_raw < B;                // stores only for real ones
  const int b = live ? b_raw : B - 1;
  const bool leg_out = live && kb == 0;       // one copy of a leg's rows
  const bool trunk_out = live && g == 0;
  auto I = [&](int row) { return in[(size_t)row * B + b]; };
  auto O = [&](int row, float v) { out[(size_t)row * B + b] = v; };
  SC_SPANS_BEGIN

  // in-chain filter (K3): P's rows and dx on the group's lanes, x on all
  Kf kf;
  float* sym = sym_all + (KF1 ? (lane / G) * NS * NS : 0);
  if constexpr (KF1) {
#pragma unroll
    for (int i = 0; i < NS; ++i) kf.x[i] = I(I_KFX + i);
#pragma unroll
    for (int m = 0; m < KF_SLOTS; ++m) {
      const int r = kf_row_valid(g, m) ? g + KF_G * m : NS - 1;
#pragma unroll
      for (int c = 0; c < NS; ++c)
        kf.p[m][c] = kf_row_valid(g, m) ? I(I_KFP + NS * r + c) : 0.0f;
    }
  }

  // the trunk's state (every lane) and the lane's leg's
  V3 pos, vel, omega, anchor, q, dq;
  float quat[4];
  for (int i = 0; i < 3; ++i) {
    pos[i] = I(I_POS + i);
    vel[i] = I(I_VEL + i);
    omega[i] = I(I_OMEGA + i);
  }
  for (int i = 0; i < 4; ++i) quat[i] = I(I_QUAT + i);
  bool contact = I(I_CONTACT + l) > 0.5f;
  for (int i = 0; i < 3; ++i) {
    q[i] = I(I_Q + 3 * l + i);
    dq[i] = I(I_DQ + 3 * l + i);
    anchor[i] = I(I_ANCHOR + 3 * l + i);
  }
  // MPC targets and parameters
  const bool walking = mode[b] > 0;
  V3 grf_w, ft_w, ftv_w, dfp;
  for (int i = 0; i < 3; ++i) {
    grf_w[i] = I(I_OINPUT + 3 * l + i);
    ft_w[i] = I(I_OSTATE + 6 + 3 * l + i);
    ftv_w[i] = I(I_OINPUT + 12 + 3 * l + i);
    dfp[i] = I(I_DFP + 3 * l + i);
  }
  const Leg leg{I(I_RHO + 5 * l), I(I_RHO + 5 * l + 1), I(I_RHO + 5 * l + 2),
                I(I_RHO + 5 * l + 3), I(I_RHO + 5 * l + 4)};
  const float mass = I(I_MASS), mu = I(I_MU);
  V3 kp, kd;
  M3 Ib;
  for (int i = 0; i < 3; ++i) {
    kp[i] = I(I_KP + i);
    kd[i] = I(I_KD + i);
    for (int j = 0; j < 3; ++j) Ib.a[i][j] = I(I_INERTIA + 3 * i + j);
  }

  V3 acc, qt, dqt, tff;
  for (int i = 0; i < 3; ++i) qt[i] = dqt[i] = tff[i] = acc[i] = 0.0f;
  SC_SPAN(0);

  for (int step = 0; step < substeps; ++step) {
    const M3 R = rotmat(quat);
    // === low level of the lane's leg: tau = -J^T R^T F + PD(IK(target)) ===
    const M3 J = jac(q, leg);
    V3 tau;
    {
      const V3 f_rel = mtv(R, grf_w);
      V3 d_pos, d_vel;
      for (int i = 0; i < 3; ++i) {
        tff[i] = -(J.a[0][i] * f_rel[0] + J.a[1][i] * f_rel[1] +
                   J.a[2][i] * f_rel[2]);
        // the controller's root state: the truth (K2) or the estimate (K3)
        if constexpr (KF1) {
          d_pos[i] = ft_w[i] - kf.x[i];
          d_vel[i] = ftv_w[i] - kf.x[3 + i];
        } else {
          d_pos[i] = ft_w[i] - pos[i];
          d_vel[i] = ftv_w[i] - vel[i];
        }
      }
      const V3 q_ik = ik<BR>(mtv(R, d_pos), q, leg, kb, lbase);
      const V3 dq_ik = solve3(J, mtv(R, d_vel));
      for (int i = 0; i < 3; ++i) {
        // NaN guards of control/low_level.py (reference: :472-478)
        const float qi = isnan(q_ik[i]) ? q[i] : q_ik[i];
        const float dqi = isnan(dq_ik[i]) ? dq[i] : dq_ik[i];
        qt[i] = walking ? qi : q[i];
        dqt[i] = walking ? dqi : dq[i];
        tau[i] = kp[i] * (qt[i] - q[i]) + kd[i] * (dqt[i] - dq[i]) + tff[i];
      }
    }
    SC_SPAN(1);
    // safety gate on the current attitude and joint speeds (the maximum
    // over the legs' lanes: fmaxf's result does not depend on the order)
    const V3 eul = euler(quat);
    float dq_max = fmaxf(fmaxf(dq[0], dq[1]), dq[2]);
    for (int o = BR; o < G; o <<= 1)
      dq_max = fmaxf(dq_max, __shfl_xor_sync(FULL, dq_max, o));
    const bool safe = fabsf(eul[0]) <= ROLL_LIMIT &&
                      fabsf(eul[1]) <= PITCH_LIMIT && dq_max <= JOINT_VEL_LIMIT;
    if (!safe)
      for (int i = 0; i < 3; ++i) tau[i] = 0.0f;

    // === SRB world step on flat ground: the leg's GRF and contact ===
    bool new_contact;
    V3 grf, tq;
    {
      const V3 fw_rel = mv(R, fk(q, leg));
      V3 foot_w, neg_tau;
      for (int i = 0; i < 3; ++i) {
        foot_w[i] = fw_rel[i] + pos[i];
        neg_tau[i] = -tau[i];
      }
      const V3 f_w = mv(R, solve3_t(J, neg_tau));
      const float fz = fmaxf(f_w[2], 0.0f);
      const float cap = mu * fz;
      grf[0] = fmaxf(fminf(f_w[0], cap), -cap);
      grf[1] = fmaxf(fminf(f_w[1], cap), -cap);
      grf[2] = fz;
      const bool touching = foot_w[2] <= 0.0f && foot_w[2] >= -0.02f;
      new_contact = contact ? fz > CONTACT_RELEASE_FZ : touching;
      if (!contact && new_contact) {
        anchor[0] = foot_w[0];
        anchor[1] = foot_w[1];
        anchor[2] = 0.0f;
      }
      if (!new_contact) grf[0] = grf[1] = grf[2] = 0.0f;
      V3 r;
      for (int i = 0; i < 3; ++i) r[i] = anchor[i] - pos[i];
      tq = cross(r, grf);
    }
    // the folds over the legs, then the trunk step on every lane
    V3 grf_sum, torque;
    for (int i = 0; i < 3; ++i) {
      grf_sum[i] = leg_sum<BR>(grf[i], base);
      torque[i] = leg_sum<BR>(tq[i], base);
    }
    SC_SPAN(2);
    for (int i = 0; i < 3; ++i) acc[i] = grf_sum[i] / mass;
    acc[2] -= GRAVITY_EST;
    M3 RI, Iw;                                        // I_world = R Ib R^T
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        RI.a[i][j] = R.a[i][0] * Ib.a[0][j] + R.a[i][1] * Ib.a[1][j] +
                     R.a[i][2] * Ib.a[2][j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Iw.a[i][j] = RI.a[i][0] * R.a[j][0] + RI.a[i][1] * R.a[j][1] +
                     RI.a[i][2] * R.a[j][2];
    const V3 gyro = cross(omega, mv(Iw, omega));
    V3 rhs;
    for (int i = 0; i < 3; ++i) rhs[i] = torque[i] - gyro[i];
    const V3 omega_dot = solve3(Iw, rhs);
    for (int i = 0; i < 3; ++i) {
      vel[i] += acc[i] * dt;
      pos[i] += vel[i] * dt;
      omega[i] += omega_dot[i] * dt;
    }
    // exponential-map quaternion step (ops/so3.py:quat_integrate)
    {
      const float ang = sqrtf(omega[0] * omega[0] + omega[1] * omega[1] +
                              omega[2] * omega[2]);
      const float half = 0.5f * ang * dt;
      const float scale = ang < 1e-8f ? 0.5f * dt : sinf(half) / ang;
      const float dw = cosf(half), dx = omega[0] * scale,
                  dy = omega[1] * scale, dz = omega[2] * scale;
      const float w = quat[0], x = quat[1], y = quat[2], z = quat[3];
      float nq[4] = {dw * w - dx * x - dy * y - dz * z,
                     dw * x + dx * w + dy * z - dz * y,
                     dw * y - dx * z + dy * w + dz * x,
                     dw * z + dx * y - dy * x + dz * w};
      const float n = sqrtf(nq[0] * nq[0] + nq[1] * nq[1] + nq[2] * nq[2] +
                            nq[3] * nq[3]);
      for (int i = 0; i < 4; ++i) quat[i] = nq[i] / n;
    }
    const M3 R2 = rotmat(quat);
    SC_SPAN(3);
    // stance: kinematic closure on the world anchor (its IK runs on every
    // lane, since the IK's branches exchange by shuffle)
    V3 rr;
    for (int i = 0; i < 3; ++i) rr[i] = anchor[i] - pos[i];
    const V3 q_st = ik<BR>(mtv(R2, rr), q, leg, kb, lbase);
    if (new_contact) {
      V3 vclose;
      const V3 oxr = cross(omega, rr);
      for (int i = 0; i < 3; ++i) vclose[i] = -vel[i] - oxr[i];
      dq = solve3(jac(q_st, leg), mtv(R2, vclose));
      q = q_st;
    } else {
      // swing: second-order joint dynamics under the commanded torque
      for (int i = 0; i < 3; ++i) {
        const float ddq = (tau[i] - LEG_DAMPING * dq[i]) / LEG_INERTIA;
        dq[i] += ddq * dt;
        q[i] += dq[i] * dt;
      }
    }
    contact = new_contact;
    SC_SPAN(4);

    if constexpr (KF1) {
      // === the 18-state KF at the new state (sensors of control/step.py:
      // FK, leg velocities, the anchored foot-force contact belief) ===
      const float thresh = I(I_THRESH);
      const V3 gyro_body = mtv(R2, omega);
      const V3 fpr = fk(q, leg);
      const M3 Jn = jac(q, leg);
      const V3 fvr = mv(Jn, dq);
      V3 neg;
      for (int i = 0; i < 3; ++i) neg[i] = -tff[i];
      const float anf = fmaxf(mv(R2, solve3_t(Jn, neg))[2], 0.0f);
      const float fs = contact ? anf : 0.0f;
      const float cg = walking ? 1.0f / (1.0f + expf(-10.0f * (fs - thresh)))
                               : 1.0f;
      const float infl = 1.0f + (1.0f - cg) * 1e3f;
      const V3 Rf = mv(R2, fpr);
      const V3 cgp = cross(gyro_body, fpr);
      V3 lv;
      for (int i = 0; i < 3; ++i) lv[i] = -fvr[i] - cgp[i];
      const V3 Rlv = mv(R2, lv);
      V3 yv;
      for (int a = 0; a < 3; ++a)
        yv[a] = (1.0f - cg) * kf.x[3 + a] + cg * Rlv[a];
      const float yz = (1.0f - cg) * (kf.x[2] + fpr[2]);
      SC_SPAN(5);
      kf_step(kf, g, base, acc, Rf, yv, yz, infl, dt, sym);
      SC_SPAN(6);
    }
  }

  if (trunk_out) {
    for (int i = 0; i < 3; ++i) {
      O(O_POS + i, pos[i]);
      O(O_VEL + i, vel[i]);
      O(O_OMEGA + i, omega[i]);
      O(O_LASTACC + i, acc[i]);
    }
    for (int i = 0; i < 4; ++i) O(O_QUAT + i, quat[i]);
  }
  if (leg_out) {
    O(O_CONTACT + l, contact ? 1.0f : 0.0f);
    for (int i = 0; i < 3; ++i) {
      O(O_Q + 3 * l + i, q[i]);
      O(O_DQ + 3 * l + i, dq[i]);
      O(O_ANCHOR + 3 * l + i, anchor[i]);
      O(O_QT + 3 * l + i, qt[i]);
      O(O_DQT + 3 * l + i, dqt[i]);
      O(O_TAUT + 3 * l + i, tff[i]);
    }
  }

  // === Feedback products of the final state (control/sensors.py,
  // sim/srb_sim.py:read_sensors, the foot-sensor model of control/step.py,
  // control/raibert.py) in the FB_ROWS layout ===
  const M3 R = rotmat(quat);
  const V3 eul = euler(quat);
  const V3 gyro_b = mtv(R, omega);
  const float thresh = I(I_THRESH);
  const V3 fp_rel = fk(q, leg);
  const M3 Jf = jac(q, leg);
  const V3 fv_rel = mv(Jf, dq);
  float fs;
  {                                    // foot sensor: anchored normal force
    V3 neg;
    for (int i = 0; i < 3; ++i) neg[i] = -tff[i];
    const float fz = fmaxf(mv(R, solve3_t(Jf, neg))[2], 0.0f);
    fs = contact ? fz : 0.0f;
  }
  const float cy = cosf(eul[2]), sy = sinf(eul[2]);
  if (trunk_out) {
    for (int i = 0; i < 3; ++i) O(O_FB + F_EUL + i, eul[i]);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) O(O_FB + F_ROT + 3 * i + j, R.a[i][j]);
    V3 sf;
    for (int i = 0; i < 3; ++i) sf[i] = acc[i];
    sf[2] += GRAVITY_EST;
    const V3 imu_acc = mtv(R, sf);
    for (int i = 0; i < 3; ++i) O(O_FB + F_IMUA + i, imu_acc[i]);
    for (int i = 0; i < 3; ++i) O(O_FB + F_IMUG + i, gyro_b[i]);
  }
  if (leg_out) {
    const int o3 = 3 * l;
    const V3 fpa = mv(R, fp_rel), fva = mv(R, fv_rel);
    const V3 w = mv(R, cross(gyro_b, fp_rel));
    for (int i = 0; i < 3; ++i) {
      O(O_FB + F_FPR + o3 + i, fp_rel[i]);
      O(O_FB + F_FPA + o3 + i, fpa[i]);
      O(O_FB + F_FVR + o3 + i, fv_rel[i]);
      O(O_FB + F_FVA + o3 + i, fva[i]);
      O(O_FB + F_FVW + o3 + i, fva[i] + vel[i] + w[i]);
      for (int j = 0; j < 3; ++j) O(O_FB + F_JAC + 9 * l + 3 * i + j, Jf.a[i][j]);
    }
    O(O_FB + F_FS + l, fs);
    O(O_FB + F_SIG + l, 1.0f / (1.0f + expf(-10.0f * (fs - thresh))));
    O(O_FB + F_BOOL + l, fs > thresh ? 1.0f : 0.0f);
    {                                  // force_tau_est: PD command stripped
      V3 t;
      for (int i = 0; i < 3; ++i)
        t[i] = -kp[i] * (qt[i] - q[i]) - kd[i] * (dqt[i] - dq[i]);
      const V3 f = mv(R, solve3_t(Jf, t));
      for (int i = 0; i < 3; ++i) O(O_FB + F_TAU + o3 + i, f[i]);
    }
    {                                  // raibert_abs (flat ground)
      const float vdx0 = I(I_VELD), vdy0 = I(I_VELD + 1);
      const float vdx = cy * vdx0 - sy * vdy0, vdy = sy * vdx0 + cy * vdy0;
      // the controller's root state: the truth (K2) or the estimate (K3)
      const float rz = KF1 ? kf.x[2] : pos[2];
      const float rvx = KF1 ? kf.x[3] : vel[0], rvy = KF1 ? kf.x[4] : vel[1];
      const float k = sqrtf(fabsf(rz) / 9.8f);
      const float tf = (1.0f / I(I_GSPEED) / 2.0f) / 2.0f;
      const float dx = fminf(fmaxf(k * (rvx - vdx) + tf * vdx,
                                   -FOOT_DELTA_X_LIMIT), FOOT_DELTA_X_LIMIT);
      const float dy = fminf(fmaxf(k * (rvy - vdy) + tf * vdy,
                                   -FOOT_DELTA_Y_LIMIT), FOOT_DELTA_Y_LIMIT);
      O(O_FB + F_RAI + o3, cy * dfp[0] - sy * dfp[1] + dx);
      O(O_FB + F_RAI + o3 + 1, sy * dfp[0] + cy * dfp[1] + dy);
      O(O_FB + F_RAI + o3 + 2, dfp[2]);
    }
  }

  if constexpr (KF1) {
    if (trunk_out)
      for (int i = 0; i < NS; ++i) O(O_KFX + i, kf.x[i]);
    if (live)
#pragma unroll
      for (int m = 0; m < KF_SLOTS; ++m)
        if (kf_row_valid(g, m))
#pragma unroll
          for (int c = 0; c < NS; ++c)
            O(O_KFP + NS * (g + KF_G * m) + c, kf.p[m][c]);
  }
  SC_SPAN(7);
  SC_SPANS_END
}

}  // namespace

// rows of the packed input (which=0) and output (which=1), kf_type 0 or 1
extern "C" int substep_chain_rows(int which, int kf1) {
  if (kf1) return which == 0 ? N_IN_KF : N_OUT_KF;
  return which == 0 ? N_IN : N_OUT;
}

// Launch on `stream`: in (rows, B) f32, mode (B,) int32, out (rows, B)
// f32, batch innermost; kf_type 1 runs K3 (rows with the filter state),
// otherwise K2. Returns cudaGetLastError() after the launch.
extern "C" int substep_chain_launch(const float* in, const int* mode,
                                    float* out, int B, int substeps, float dt,
                                    int kf_type, void* stream) {
  if (B == 0) return 0;
  const int per_warp = THREADS / lanes(kf_type == 1);
  const int blocks = (B + per_warp - 1) / per_warp;
  if (kf_type == 1)
    substep_chain_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        in, mode, out, B, substeps, dt);
  else
    substep_chain_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        in, mode, out, B, substeps, dt);
  return (int)cudaGetLastError();
}
