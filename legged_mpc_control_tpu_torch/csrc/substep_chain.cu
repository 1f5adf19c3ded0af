// Kernel K2: every low-level/sim substep of one closed-loop MPC tick in one
// launch (kf_type 0: the controller reads the true state).
//
// Replaces: legged_mpc_control_tpu/ops/substep_pallas.py,
//           substep_chain_fused with kf_type=0 (kernel body _make_kernel).
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
// What bounds it on an H100: per-scenario latency and bytes, not FLOPs. A
// scenario is a chain of a few thousand dependent scalar operations (trig,
// 3x3 solves, four-branch IK per leg, twice per substep), on ~150 input and
// ~240 output floats. Run as separate tensor operations, every one of those
// steps would round-trip device memory and pay a launch.
//
// Design: one thread per scenario. The world state (~55 floats), the MPC
// targets and the parameters are loaded once into registers, all substeps
// run there, and only the final state and the fb block are stored. Inputs
// and outputs are packed (rows, B), batch innermost, so a warp's loads and
// stores coalesce. Register spills are accepted for now.

#include <cuda_runtime.h>
#include <math.h>

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

// analytic IK, the branch nearest q_ref (models/kinematics.py:ik)
__device__ V3 ik(const V3& p, const V3& q_ref, const Leg& g) {
  const float px = p[0] - g.ox, py = p[1] - g.oy, pz = p[2];
  const float L = sqrtf(fmaxf(py * py + pz * pz - g.d * g.d, 1e-12f));
  const float c3 = fminf(fmaxf((px * px + L * L - g.lt * g.lt - g.lc * g.lc) /
                                   (2.0f * g.lt * g.lc),
                               -1.0f),
                         1.0f);
  const float q3_mag = acosf(c3);
  V3 best;
  float best_d = 0.0f;
  bool first = true;
  for (int a = 0; a < 2; ++a) {
    const float Ls = a == 0 ? L : -L;
    for (int c = 0; c < 2; ++c) {
      const float q3 = c == 0 ? -q3_mag : q3_mag;
      V3 cand;
      cand[0] = wrap(atan2f(pz, py) - atan2f(-Ls, g.d));
      cand[1] = wrap(atan2f(-px, Ls) -
                     atan2f(g.lc * sinf(q3), g.lt + g.lc * cosf(q3)));
      cand[2] = q3;
      float dist = 0.0f;
      for (int i = 0; i < 3; ++i) {
        const float e = wrap(cand[i] - q_ref[i]);
        dist += e * e;
      }
      if (first || dist < best_d) {
        best = cand;
        best_d = dist;
        first = false;
      }
    }
  }
  return best;
}

__global__ void __launch_bounds__(64)
substep_chain_kernel(const float* __restrict__ in, const int* __restrict__ mode,
                     float* __restrict__ out, int B, int substeps, float dt) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  auto I = [&](int row) { return in[(size_t)row * B + b]; };
  auto O = [&](int row, float v) { out[(size_t)row * B + b] = v; };

  // world state
  V3 pos, vel, omega, anchor[4], q[4], dq[4];
  float quat[4];
  bool contact[4];
  for (int i = 0; i < 3; ++i) {
    pos[i] = I(I_POS + i);
    vel[i] = I(I_VEL + i);
    omega[i] = I(I_OMEGA + i);
  }
  for (int i = 0; i < 4; ++i) quat[i] = I(I_QUAT + i);
  for (int l = 0; l < 4; ++l) {
    contact[l] = I(I_CONTACT + l) > 0.5f;
    for (int i = 0; i < 3; ++i) {
      q[l][i] = I(I_Q + 3 * l + i);
      dq[l][i] = I(I_DQ + 3 * l + i);
      anchor[l][i] = I(I_ANCHOR + 3 * l + i);
    }
  }
  // MPC targets and parameters
  const bool walking = mode[b] > 0;
  V3 grf_w[4], ft_w[4], ftv_w[4], dfp[4];
  Leg leg[4];
  for (int l = 0; l < 4; ++l) {
    for (int i = 0; i < 3; ++i) {
      grf_w[l][i] = I(I_OINPUT + 3 * l + i);
      ft_w[l][i] = I(I_OSTATE + 6 + 3 * l + i);
      ftv_w[l][i] = I(I_OINPUT + 12 + 3 * l + i);
      dfp[l][i] = I(I_DFP + 3 * l + i);
    }
    leg[l] = Leg{I(I_RHO + 5 * l), I(I_RHO + 5 * l + 1), I(I_RHO + 5 * l + 2),
                 I(I_RHO + 5 * l + 3), I(I_RHO + 5 * l + 4)};
  }
  const float mass = I(I_MASS), mu = I(I_MU);
  V3 kp, kd;
  M3 Ib;
  for (int i = 0; i < 3; ++i) {
    kp[i] = I(I_KP + i);
    kd[i] = I(I_KD + i);
    for (int j = 0; j < 3; ++j) Ib.a[i][j] = I(I_INERTIA + 3 * i + j);
  }

  V3 acc, qt[4], dqt[4], tff[4];
  for (int l = 0; l < 4; ++l)
    for (int i = 0; i < 3; ++i) qt[l][i] = dqt[l][i] = tff[l][i] = 0.0f;
  for (int i = 0; i < 3; ++i) acc[i] = 0.0f;

  for (int step = 0; step < substeps; ++step) {
    const M3 R = rotmat(quat);
    // === low level: tau = -J^T R^T F + PD(IK(foot targets)) ===
    M3 J[4];
    V3 tau[4];
    for (int l = 0; l < 4; ++l) {
      J[l] = jac(q[l], leg[l]);
      const V3 f_rel = mtv(R, grf_w[l]);
      V3 d_pos, d_vel;
      for (int i = 0; i < 3; ++i) {
        tff[l][i] = -(J[l].a[0][i] * f_rel[0] + J[l].a[1][i] * f_rel[1] +
                      J[l].a[2][i] * f_rel[2]);
        d_pos[i] = ft_w[l][i] - pos[i];
        d_vel[i] = ftv_w[l][i] - vel[i];
      }
      const V3 q_ik = ik(mtv(R, d_pos), q[l], leg[l]);
      const V3 dq_ik = solve3(J[l], mtv(R, d_vel));
      for (int i = 0; i < 3; ++i) {
        // NaN guards of control/low_level.py (reference: :472-478)
        const float qi = isnan(q_ik[i]) ? q[l][i] : q_ik[i];
        const float dqi = isnan(dq_ik[i]) ? dq[l][i] : dq_ik[i];
        qt[l][i] = walking ? qi : q[l][i];
        dqt[l][i] = walking ? dqi : dq[l][i];
        tau[l][i] = kp[i] * (qt[l][i] - q[l][i]) +
                    kd[i] * (dqt[l][i] - dq[l][i]) + tff[l][i];
      }
    }
    // safety gate on the current attitude and joint speeds
    const V3 eul = euler(quat);
    float dq_max = dq[0][0];
    for (int l = 0; l < 4; ++l)
      for (int i = 0; i < 3; ++i) dq_max = fmaxf(dq_max, dq[l][i]);
    const bool safe = fabsf(eul[0]) <= ROLL_LIMIT &&
                      fabsf(eul[1]) <= PITCH_LIMIT && dq_max <= JOINT_VEL_LIMIT;
    if (!safe)
      for (int l = 0; l < 4; ++l)
        for (int i = 0; i < 3; ++i) tau[l][i] = 0.0f;

    // === SRB world step on flat ground ===
    V3 grf_sum, torque;
    for (int i = 0; i < 3; ++i) grf_sum[i] = torque[i] = 0.0f;
    bool new_contact[4];
    for (int l = 0; l < 4; ++l) {
      const V3 fw_rel = mv(R, fk(q[l], leg[l]));
      V3 foot_w, neg_tau;
      for (int i = 0; i < 3; ++i) {
        foot_w[i] = fw_rel[i] + pos[i];
        neg_tau[i] = -tau[l][i];
      }
      const V3 f_w = mv(R, solve3_t(J[l], neg_tau));
      const float fz = fmaxf(f_w[2], 0.0f);
      const float cap = mu * fz;
      V3 grf;
      grf[0] = fmaxf(fminf(f_w[0], cap), -cap);
      grf[1] = fmaxf(fminf(f_w[1], cap), -cap);
      grf[2] = fz;
      const bool touching = foot_w[2] <= 0.0f && foot_w[2] >= -0.02f;
      const bool nc = contact[l] ? fz > CONTACT_RELEASE_FZ : touching;
      if (!contact[l] && nc) {
        anchor[l][0] = foot_w[0];
        anchor[l][1] = foot_w[1];
        anchor[l][2] = 0.0f;
      }
      if (!nc) grf[0] = grf[1] = grf[2] = 0.0f;
      V3 r;
      for (int i = 0; i < 3; ++i) r[i] = anchor[l][i] - pos[i];
      const V3 tq = cross(r, grf);
      for (int i = 0; i < 3; ++i) {
        grf_sum[i] += grf[i];
        torque[i] += tq[i];
      }
      new_contact[l] = nc;
    }
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
    for (int l = 0; l < 4; ++l) {
      if (new_contact[l]) {
        // stance: kinematic closure on the world anchor
        V3 rr, vclose;
        for (int i = 0; i < 3; ++i) rr[i] = anchor[l][i] - pos[i];
        const V3 oxr = cross(omega, rr);
        for (int i = 0; i < 3; ++i) vclose[i] = -vel[i] - oxr[i];
        const V3 q_st = ik(mtv(R2, rr), q[l], leg[l]);
        dq[l] = solve3(jac(q_st, leg[l]), mtv(R2, vclose));
        q[l] = q_st;
      } else {
        // swing: second-order joint dynamics under the commanded torque
        for (int i = 0; i < 3; ++i) {
          const float ddq = (tau[l][i] - LEG_DAMPING * dq[l][i]) / LEG_INERTIA;
          dq[l][i] += ddq * dt;
          q[l][i] += dq[l][i] * dt;
        }
      }
      contact[l] = new_contact[l];
    }
  }

  for (int i = 0; i < 3; ++i) {
    O(O_POS + i, pos[i]);
    O(O_VEL + i, vel[i]);
    O(O_OMEGA + i, omega[i]);
    O(O_LASTACC + i, acc[i]);
  }
  for (int i = 0; i < 4; ++i) O(O_QUAT + i, quat[i]);
  for (int l = 0; l < 4; ++l) {
    O(O_CONTACT + l, contact[l] ? 1.0f : 0.0f);
    for (int i = 0; i < 3; ++i) {
      O(O_Q + 3 * l + i, q[l][i]);
      O(O_DQ + 3 * l + i, dq[l][i]);
      O(O_ANCHOR + 3 * l + i, anchor[l][i]);
      O(O_QT + 3 * l + i, qt[l][i]);
      O(O_DQT + 3 * l + i, dqt[l][i]);
      O(O_TAUT + 3 * l + i, tff[l][i]);
    }
  }

  // === Feedback products of the final state (control/sensors.py,
  // sim/srb_sim.py:read_sensors, the foot-sensor model of control/step.py,
  // control/raibert.py) in the FB_ROWS layout ===
  const M3 R = rotmat(quat);
  const V3 eul = euler(quat);
  const V3 gyro_b = mtv(R, omega);
  const float thresh = I(I_THRESH);
  int row = O_FB;
  for (int i = 0; i < 3; ++i) O(row++, eul[i]);                   // euler
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) O(row++, R.a[i][j]);              // rotmat
  V3 fp_rel[4], fv_rel[4];
  M3 Jf[4];
  for (int l = 0; l < 4; ++l) {
    fp_rel[l] = fk(q[l], leg[l]);
    Jf[l] = jac(q[l], leg[l]);
    fv_rel[l] = mv(Jf[l], dq[l]);
  }
  for (int l = 0; l < 4; ++l)
    for (int i = 0; i < 3; ++i) O(row++, fp_rel[l][i]);           // foot_pos_rel
  for (int l = 0; l < 4; ++l) {
    const V3 a = mv(R, fp_rel[l]);
    for (int i = 0; i < 3; ++i) O(row++, a[i]);                   // foot_pos_abs
  }
  for (int l = 0; l < 4; ++l)
    for (int i = 0; i < 3; ++i) O(row++, fv_rel[l][i]);           // foot_vel_rel
  for (int l = 0; l < 4; ++l) {
    const V3 a = mv(R, fv_rel[l]);
    for (int i = 0; i < 3; ++i) O(row++, a[i]);                   // foot_vel_abs
  }
  for (int l = 0; l < 4; ++l) {                                   // foot_vel_world
    const V3 a = mv(R, fv_rel[l]);
    const V3 w = mv(R, cross(gyro_b, fp_rel[l]));
    for (int i = 0; i < 3; ++i) O(row++, a[i] + vel[i] + w[i]);
  }
  for (int l = 0; l < 4; ++l)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) O(row++, Jf[l].a[i][j]);        // jac
  float fs[4];
  for (int l = 0; l < 4; ++l) {        // foot sensor: anchored normal force
    V3 neg;
    for (int i = 0; i < 3; ++i) neg[i] = -tff[l][i];
    const float fz = fmaxf(mv(R, solve3_t(Jf[l], neg))[2], 0.0f);
    fs[l] = contact[l] ? fz : 0.0f;
  }
  for (int l = 0; l < 4; ++l) O(row++, fs[l]);                    // foot_force_sensor
  for (int l = 0; l < 4; ++l)                                     // contact_sig
    O(row++, 1.0f / (1.0f + expf(-10.0f * (fs[l] - thresh))));
  for (int l = 0; l < 4; ++l) O(row++, fs[l] > thresh ? 1.0f : 0.0f);
  for (int l = 0; l < 4; ++l) {        // force_tau_est: PD command stripped
    V3 t;
    for (int i = 0; i < 3; ++i)
      t[i] = -kp[i] * (qt[l][i] - q[l][i]) - kd[i] * (dqt[l][i] - dq[l][i]);
    const V3 f = mv(R, solve3_t(Jf[l], t));
    for (int i = 0; i < 3; ++i) O(row++, f[i]);
  }
  {                                    // raibert_abs (flat ground)
    const float cy = cosf(eul[2]), sy = sinf(eul[2]);
    const float vdx0 = I(I_VELD), vdy0 = I(I_VELD + 1);
    const float vdx = cy * vdx0 - sy * vdy0, vdy = sy * vdx0 + cy * vdy0;
    const float k = sqrtf(fabsf(pos[2]) / 9.8f);
    const float tf = (1.0f / I(I_GSPEED) / 2.0f) / 2.0f;
    const float dx = fminf(fmaxf(k * (vel[0] - vdx) + tf * vdx,
                                 -FOOT_DELTA_X_LIMIT), FOOT_DELTA_X_LIMIT);
    const float dy = fminf(fmaxf(k * (vel[1] - vdy) + tf * vdy,
                                 -FOOT_DELTA_Y_LIMIT), FOOT_DELTA_Y_LIMIT);
    for (int l = 0; l < 4; ++l) {
      O(row++, cy * dfp[l][0] - sy * dfp[l][1] + dx);
      O(row++, sy * dfp[l][0] + cy * dfp[l][1] + dy);
      O(row++, dfp[l][2]);
    }
  }
  V3 sf;
  for (int i = 0; i < 3; ++i) sf[i] = acc[i];
  sf[2] += GRAVITY_EST;
  const V3 imu_acc = mtv(R, sf);
  for (int i = 0; i < 3; ++i) O(row++, imu_acc[i]);              // imu_acc
  for (int i = 0; i < 3; ++i) O(row++, gyro_b[i]);               // imu_gyro
}

}  // namespace

// rows of the packed input (which=0) and output (which=1)
extern "C" int substep_chain_rows(int which) { return which == 0 ? N_IN : N_OUT; }

// Launch on `stream`: in (N_IN, B) f32, mode (B,) int32, out (N_OUT, B)
// f32, batch innermost. Returns cudaGetLastError() after the launch.
extern "C" int substep_chain_launch(const float* in, const int* mode,
                                    float* out, int B, int substeps, float dt,
                                    void* stream) {
  const int threads = 64;
  const int blocks = (B + threads - 1) / threads;
  substep_chain_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      in, mode, out, B, substeps, dt);
  return (int)cudaGetLastError();
}
