"""PyTorch port vs the JAX package: so3, la3, the moving-window filter,
the Bezier swing curve, leg kinematics and the robot parameters, in f64 on
the same numpy inputs (atol 1e-10: the same closed forms, differing only
in the order of a few float64 operations)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu import config as jcfg
from legged_mpc_control_tpu.models import kinematics as jkin
from legged_mpc_control_tpu.ops import bezier as jbez
from legged_mpc_control_tpu.ops import filters as jfil
from legged_mpc_control_tpu.ops import la3 as jla3
from legged_mpc_control_tpu.ops import so3 as jso3
from legged_mpc_control_tpu_torch import config as tcfg
from legged_mpc_control_tpu_torch.models import kinematics as tkin
from legged_mpc_control_tpu_torch.ops import bezier as tbez
from legged_mpc_control_tpu_torch.ops import filters as tfil
from legged_mpc_control_tpu_torch.ops import la3 as tla3
from legged_mpc_control_tpu_torch.ops import so3 as tso3
from torch_parity import close, params_mapping, t

ATOL = 1e-10
N = 16
_rng = np.random.default_rng(0)
QUAT = _rng.normal(size=(N, 4))
QUAT /= np.linalg.norm(QUAT, axis=-1, keepdims=True)
EULER = _rng.uniform(-1.0, 1.0, size=(N, 3))
YAW = _rng.uniform(-3.0, 3.0, size=(N,))
OMEGA = _rng.normal(size=(N, 3))
OMEGA[0] = 0.0                                # the small-angle branch
V3 = _rng.normal(size=(N, 3))
M33 = _rng.normal(size=(N, 3, 3)) + 3.0 * np.eye(3)
Q_LEGS = (np.array([0.0, 0.8, -1.6])
          + _rng.uniform(-0.3, 0.3, size=(N, 4, 3)))
RHO = np.broadcast_to(np.asarray(jcfg.go1_params(jnp.float64).rho_fix),
                      (N, 4, 5)).copy()
PHASE = _rng.uniform(0.0, 1.0, size=(N, 4))
P_START = _rng.normal(size=(N, 4, 3))
P_FINAL = _rng.normal(size=(N, 4, 3))
WINDOW_PUSHES = _rng.normal(size=(5, N))


@pytest.fixture(scope="module")
def jax_out():
    """Every JAX reference value of this file from one compiled call."""
    def ref(quat, euler, yaw, omega, v, M, q, rho, ph, ps, pf, pushes):
        out = dict(
            quat_to_euler=jso3.quat_to_euler(quat),
            euler_to_quat=jso3.euler_to_quat(euler),
            quat_to_rotmat=jso3.quat_to_rotmat(quat),
            skew=jso3.skew(v), rot_z=jso3.rot_z(yaw),
            angvel_to_rpy_rate=jso3.angvel_to_rpy_rate(yaw),
            quat_mul=jso3.quat_mul(quat, jso3.euler_to_quat(euler)),
            quat_integrate=jso3.quat_integrate(quat, omega, 0.00125),
            det3=jla3.det3(M), adj3=jla3.adj3(M), inv3=jla3.inv3(M),
            solve3=jla3.solve3(M, v), solve3_t=jla3.solve3_t(M, v),
            fk_legs=jax.vmap(jkin.fk_legs)(q, rho),
            jac_legs=jax.vmap(jkin.jac_legs)(q, rho),
            swing_foot_pos=jbez.swing_foot_pos(ph, ps, pf))
        # IK: recover the joints from their own FK (all four branches
        # compete, the nearest to a perturbed guess wins)
        p = jax.vmap(jkin.fk_legs)(q, rho)
        out["ik_legs"] = jax.vmap(jkin.ik_legs)(p, q + 0.05, rho)

        def push(state, x):
            state, avg = jax.vmap(jfil.moving_window_update)(state, x)
            return state, avg
        st0 = jax.vmap(lambda _: jfil.moving_window_init(3, dtype=quat.dtype))(
            jnp.arange(N))
        st, avgs = jax.lax.scan(push, st0, pushes)
        out["window_avgs"] = avgs
        out["window_buf"] = st.buf
        return out

    args = (QUAT, EULER, YAW, OMEGA, V3, M33, Q_LEGS, RHO, PHASE, P_START,
            P_FINAL, WINDOW_PUSHES)
    return jax.tree.map(np.asarray, jax.jit(ref)(*args))


@pytest.mark.parametrize("name,fn", [
    ("quat_to_euler", lambda: tso3.quat_to_euler(t(QUAT))),
    ("euler_to_quat", lambda: tso3.euler_to_quat(t(EULER))),
    ("quat_to_rotmat", lambda: tso3.quat_to_rotmat(t(QUAT))),
    ("skew", lambda: tso3.skew(t(V3))),
    ("rot_z", lambda: tso3.rot_z(t(YAW))),
    ("angvel_to_rpy_rate", lambda: tso3.angvel_to_rpy_rate(t(YAW))),
    ("quat_mul", lambda: tso3.quat_mul(t(QUAT),
                                       tso3.euler_to_quat(t(EULER)))),
    ("quat_integrate", lambda: tso3.quat_integrate(t(QUAT), t(OMEGA),
                                                   0.00125)),
    ("det3", lambda: tla3.det3(t(M33))),
    ("adj3", lambda: tla3.adj3(t(M33))),
    ("inv3", lambda: tla3.inv3(t(M33))),
    ("solve3", lambda: tla3.solve3(t(M33), t(V3))),
    ("solve3_t", lambda: tla3.solve3_t(t(M33), t(V3))),
    ("fk_legs", lambda: tkin.fk_legs(t(Q_LEGS), t(RHO))),
    ("jac_legs", lambda: tkin.jac_legs(t(Q_LEGS), t(RHO))),
    ("ik_legs", lambda: tkin.ik_legs(tkin.fk_legs(t(Q_LEGS), t(RHO)),
                                     t(Q_LEGS) + 0.05, t(RHO))),
    ("swing_foot_pos", lambda: tbez.swing_foot_pos(t(PHASE), t(P_START),
                                                   t(P_FINAL))),
])
def test_op_matches_jax(jax_out, name, fn):
    close(fn(), jax_out[name], ATOL, what=name)


def test_ik_inverts_fk(jax_out):
    close(jax_out["ik_legs"], Q_LEGS, 1e-8, what="JAX ik of fk")


def test_moving_window_matches_jax(jax_out):
    st = tfil.moving_window_init(3, N, torch.float64)
    for k in range(WINDOW_PUSHES.shape[0]):
        st, avg = tfil.moving_window_update(st, t(WINDOW_PUSHES[k]))
        close(avg, jax_out["window_avgs"][k], ATOL, what=f"push {k}")
    close(st.buf, jax_out["window_buf"], ATOL)


@pytest.mark.parametrize("robot", ["a1_params", "go1_params"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_params_from_numpy_matches_port_params(robot, dtype):
    jp = getattr(jcfg, robot)(getattr(jnp, dtype))
    got = tcfg.params_from_numpy(params_mapping(jp))
    want = getattr(tcfg, robot)(getattr(torch, dtype))
    for name in tcfg.param_base_ndims():
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
