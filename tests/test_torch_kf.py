"""The port's 18-state linear KF (`estimation/basic_kf.py`) vs the JAX
package's, in float64: `kf_init`, `kf_update` over a few steps with mixed
stance, swing and in-between contact beliefs, and `sequential_update`
against the joint Kalman update it replaces.

Inputs are drawn with numpy from a seed. Tolerance 1e-10: the same float64
arithmetic in another order (the covariance entries are O(1), the state
O(0.1-1))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.estimation import basic_kf as jkf
from legged_mpc_control_tpu_torch.estimation import basic_kf as tkf
from legged_mpc_control_tpu_torch.ops import so3 as tso3
from torch_parity import close, np_tree, t

B = 6
DT = 0.00125
STEPS = 5
ATOL = 1e-10
_rng = np.random.default_rng(7)


def _rotations(n):
    euler = _rng.uniform(-0.3, 0.3, size=(n, 3))
    return tso3.quat_to_rotmat(tso3.euler_to_quat(t(euler))).numpy()


def _contacts(n):
    """Per leg: stance (1), swing (0) or a sigmoid belief in between."""
    c = _rng.choice([0.0, 1.0, 0.5], size=(n, 4))
    return np.where(c == 0.5, _rng.uniform(size=(n, 4)), c)


R0 = _rotations(B)
FPR0 = _rng.normal(scale=0.2, size=(B, 4, 3))
MEAS = [dict(R=_rotations(B),
             acc=_rng.normal(size=(B, 3)) + np.array([0.0, 0.0, 9.81]),
             gyro=_rng.normal(scale=0.3, size=(B, 3)),
             fpr=_rng.normal(scale=0.2, size=(B, 4, 3)),
             fvr=_rng.normal(scale=0.3, size=(B, 4, 3)),
             c=_contacts(B)) for _ in range(STEPS)]


@pytest.fixture(scope="module")
def jax_trace():
    """kf_init, then STEPS kf_update calls, on the JAX side."""
    init = jax.jit(jax.vmap(lambda R, f: jkf.kf_init(R, f, jnp.float64)))
    update = jax.jit(jax.vmap(
        lambda kf, R, a, g, fp, fv, c: jkf.kf_update(kf, DT, R, a, g, fp,
                                                     fv, c)))
    kf = init(R0, FPR0)
    trace = [np_tree(kf)]
    for m in MEAS:
        kf, pos, vel = update(kf, m["R"], m["acc"], m["gyro"], m["fpr"],
                              m["fvr"], m["c"])
        trace.append((np_tree(kf), np.asarray(pos), np.asarray(vel)))
    return trace


def test_kf_init_matches_jax(jax_trace):
    want = jax_trace[0]
    got = tkf.kf_init(t(R0), t(FPR0))
    close(got.x, want.x, ATOL, what="x")
    close(got.P, want.P, ATOL, what="P")
    assert got.initialized.all() and got.initialized.shape == (B,)


def test_kf_update_matches_jax(jax_trace):
    kf = tkf.kf_init(t(R0), t(FPR0))
    suppressed = torch.zeros(B, dtype=torch.bool)
    for k, m in enumerate(MEAS):
        kf, pos, vel = tkf.kf_update(kf, DT, t(m["R"]), t(m["acc"]),
                                     t(m["gyro"]), t(m["fpr"]), t(m["fvr"]),
                                     t(m["c"]))
        want, wpos, wvel = jax_trace[k + 1]
        close(kf.x, want.x, ATOL, what=f"x step {k}")
        close(kf.P, want.P, ATOL, what=f"P step {k}")
        close(pos, wpos, ATOL, what=f"pos step {k}")
        close(vel, wvel, ATOL, what=f"vel step {k}")
        suppressed |= (kf.P[:, 0:2, 2:] == 0).all(dim=-1).all(dim=-1)
    # the xy-drift suppression branch was taken, so the check covered it
    assert bool(suppressed.any())


def test_sequential_update_matches_joint_solve():
    """Row-by-row updates == the joint update with diagonal noise:
    K = P H^T (H P H^T + R)^-1, x = xbar + K e, P = (I - K H) P."""
    n, m = tkf.STATE_SIZE, tkf.MEAS_SIZE
    A = _rng.normal(size=(B, n, n))
    P = A @ A.transpose(0, 2, 1) / n + np.eye(n)
    xbar = _rng.normal(size=(B, n))
    H = tkf._measurement_matrix(torch.float64, "cpu").numpy()
    err = _rng.normal(size=(B, m))
    r = _rng.uniform(1e-3, 1.0, size=(B, m))
    x_seq, P_seq = tkf.sequential_update(t(xbar), t(P), t(H), t(err), t(r))
    S = H @ P @ H.T + r[:, :, None] * np.eye(m)
    K = P @ H.T @ np.linalg.inv(S)
    x_joint = xbar + (K @ err[..., None])[..., 0]
    P_joint = (np.eye(n) - K @ H) @ P
    close(x_seq, x_joint, ATOL, what="x")
    close(P_seq, P_joint, ATOL, what="P")
