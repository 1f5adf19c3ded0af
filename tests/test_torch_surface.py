"""The rest of the JAX package's public surface in the PyTorch port, against
the JAX functions on the same seeded numpy inputs, in float64 on the CPU:

- the causal Savitzky-Golay filter (`ops/filters.py`), on the cases of
  tests/test_utils.py::test_savgol_smoother, batched;
- the swing velocity `ops/bezier.swing_foot_pos_vel`, against JAX's and
  against a central difference of `swing_foot_pos`;
- the kinematic-calibration functions of `models/kinematics.py` (jacfwd
  in both packages), to 1e-12;
- `models/srb.gravity_affine` and `srb_continuous_dynamics`;
- `sim/srb_sim.sim_step(terrain_height=)`: a raised plane against JAX's,
  and the plane at 0 equal bit for bit to the default flat step;
- `mpc/qp_builder.reference_sparse_qp`: the port's arrays equal to JAX's,
  and its float64 oracle solution (tests/oracle.py) within 1e-4 N of the
  port's own float64 Riccati solve (the plain version of K1) of the same
  problem, the GRF bound of BASELINE.md.
"""

import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from legged_mpc_control_tpu.config import go1_params as jgo1
from legged_mpc_control_tpu.models import kinematics as jkin
from legged_mpc_control_tpu.models import srb as jsrb
from legged_mpc_control_tpu.mpc import lci_mpc as jlci
from legged_mpc_control_tpu.mpc import qp_builder as jqp
from legged_mpc_control_tpu.ops import bezier as jbez
from legged_mpc_control_tpu.ops import filters as jfil
from legged_mpc_control_tpu.parallel import runner as jrunner
from legged_mpc_control_tpu.sim import srb_sim as jsim
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import step as tstep
from legged_mpc_control_tpu_torch.models import kinematics as tkin
from legged_mpc_control_tpu_torch.models import srb as tsrb
from legged_mpc_control_tpu_torch.mpc import lci_mpc as tlci
from legged_mpc_control_tpu_torch.mpc import qp_builder as tqp
from legged_mpc_control_tpu_torch.mpc import riccati as tric
from legged_mpc_control_tpu_torch.ops import bezier as tbez
from legged_mpc_control_tpu_torch.ops import filters as tfil
from legged_mpc_control_tpu_torch.sim import srb_sim as tsim
from oracle import solve_qp_oracle
from torch_parity import close, np_tree, params_mapping, t

F64 = torch.float64
JP = jgo1(jnp.float64)
TP = params_from_numpy(params_mapping(JP))
W = 9


# --- the causal Savitzky-Golay filter -----------------------------------

def _savgol_run(samples, value_shape=(), **kw):
    """Both filters over `samples` (n, B) + value_shape; returns the two
    output sequences (n, B) + value_shape."""
    n, b = samples.shape[:2]
    js = jax.vmap(lambda _: jfil.savgol_init(W, value_shape, jnp.float64))(
        jnp.arange(b))
    jupd = jax.jit(jax.vmap(lambda s, v: jfil.savgol_update(s, v, **kw)))
    ts = tfil.savgol_init(W, b, F64, "cpu", value_shape)
    jo, to = [], []
    for s in samples:
        js, y = jupd(js, jnp.asarray(s))
        jo.append(np.asarray(y))
        ts, y = tfil.savgol_update(ts, t(s), **kw)
        to.append(y.numpy())
    return np.stack(to), np.stack(jo)


def test_savgol_coeffs_match_jax():
    for order, deriv, dt in ((2, 0, 1.0), (2, 1, 1.0), (3, 1, 0.01)):
        np.testing.assert_array_equal(tfil.savgol_coeffs(W, order, deriv, dt),
                                      jfil.savgol_coeffs(W, order, deriv, dt))


def test_savgol_reproduces_polynomials_and_matches_jax():
    """tests/test_utils.py's quadratic and ramp, three scenarios each with
    its own polynomial, and the scenarios' buffers filling together."""
    ts = np.arange(30, dtype=np.float64)
    a = np.array([0.5, -0.2, 1.5])
    sig = (a[None] * ts[:, None] ** 2 - 2.0 * ts[:, None] + 3.0)   # (30, 3)
    got, want = _savgol_run(sig, order=2)
    close(got, want, 1e-12)
    close(got[W:], sig[W:], 1e-9)
    close(got[:W - 1], sig[:W - 1], 0.0)       # raw until the window fills
    ramp = 3.0 * ts[:15, None] * np.array([1.0, 2.0, -1.0])[None]
    got, want = _savgol_run(ramp, order=2, deriv=1, dt=1.0)
    close(got, want, 1e-12)
    close(got[-1], [3.0, 6.0, -3.0], 1e-9)


def test_savgol_attenuates_noise_and_takes_vectors():
    rng = np.random.default_rng(0)
    noisy = 1.0 + 0.1 * rng.standard_normal((200, 2))
    got, want = _savgol_run(noisy, order=2)
    close(got, want, 1e-12)
    # causal endpoint evaluation: variance gain sum(c^2) ~ 0.65
    assert np.all(np.std(got[W:] - 1.0, axis=0)
                  < 0.9 * np.std(noisy - 1.0, axis=0))
    # (4,3) samples (the EKF's foot velocities), scenarios at their own
    # phase of the ring
    vec = rng.standard_normal((12, 2, 4, 3))
    got, want = _savgol_run(vec, value_shape=(4, 3), order=2, deriv=1,
                            dt=0.002)
    assert got.shape == (12, 2, 4, 3)
    close(got, want, 1e-9)


def test_moving_window_takes_vectors():
    """moving_window_* with JAX's value_shape: (B, window, 4, 3) rings."""
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((7, 2, 4, 3))
    js = jax.vmap(lambda _: jfil.moving_window_init(
        5, (4, 3), jnp.float64))(jnp.arange(2))
    ts = tfil.moving_window_init(5, 2, F64, "cpu", value_shape=(4, 3))
    for v in vals:
        js, jy = jax.vmap(jfil.moving_window_update)(js, jnp.asarray(v))
        ts, ty = tfil.moving_window_update(ts, t(v))
        close(ty, jy, 1e-14)


# --- the swing velocity ---------------------------------------------------

def test_swing_foot_pos_vel():
    rng = np.random.default_rng(2)
    n = 16
    tt = rng.uniform(0.02, 0.98, n)
    p0 = rng.uniform(-0.2, 0.2, (n, 3))
    p1 = p0 + rng.uniform(-0.1, 0.1, (n, 3))
    dur = 0.15
    for pitch in (0.0, 0.2):
        jp, jv = jax.vmap(lambda a, b, c: jbez.swing_foot_pos_vel(
            a, b, c, dur, pitch))(tt, p0, p1)
        pos, vel = tbez.swing_foot_pos_vel(t(tt), t(p0), t(p1), dur, pitch)
        close(pos, jp, 1e-13)
        close(vel, jv, 1e-12)
        close(pos, tbez.swing_foot_pos(t(tt), t(p0), t(p1), pitch), 1e-15)
        h = 1e-6
        fd = (tbez.swing_foot_pos(t(tt + h), t(p0), t(p1), pitch)
              - tbez.swing_foot_pos(t(tt - h), t(p0), t(p1), pitch)) / (2 * h)
        close(vel, fd / dur, 1e-6)


# --- kinematic calibration ------------------------------------------------

CAL = ("fk_cal", "jac_cal", "dfk_drho", "dJ_dq", "dJ_drho")


@pytest.mark.parametrize("name", CAL)
def test_calibration_functions_match_jax(name):
    """8 seeded (q, rho_opt) on the legs' own geometry, batched in the port
    (leading axes), one leg at a time in JAX."""
    rng = np.random.default_rng(3)
    q = rng.uniform([-0.4, 0.3, -2.2], [0.4, 1.2, -0.9], (8, 3))
    rho_opt = rng.uniform(-0.03, 0.03, (8, 3))
    rho_fix = np.asarray(JP.rho_fix)[np.arange(8) % 4]          # (8, 5)
    jf = jax.vmap(getattr(jkin, name))
    want = np.asarray(jf(q, rho_opt, rho_fix))
    got = getattr(tkin, name)(t(q), t(rho_opt), t(rho_fix))
    assert tuple(got.shape) == want.shape
    close(got, want, 1e-12, what=name)
    # the same function on (2, 4, 3) legs, the 4-leg forms' layout
    got4 = getattr(tkin, name)(t(q).reshape(2, 4, 3),
                               t(rho_opt).reshape(2, 4, 3),
                               t(rho_fix).reshape(2, 4, 5))
    close(got4.reshape(got.shape), got.numpy(), 0.0)


def test_calibration_closed_forms():
    """dfk_drho is the calf rotation `_calf_rot` (the reference's
    autoFunc_d_fk_dc), and a zero offset gives the plain FK and Jacobian."""
    rng = np.random.default_rng(4)
    q = t(rng.uniform(-1.0, 1.0, (5, 3)))
    rho_fix = t(np.asarray(JP.rho_fix)[[0, 1, 2, 3, 0]])
    rho_opt = t(rng.uniform(-0.03, 0.03, (5, 3)))
    close(tkin.dfk_drho(q, rho_opt, rho_fix), tkin._calf_rot(q).numpy(),
          1e-15)
    close(tkin._calf_rot(q), np.asarray(jax.vmap(jkin._calf_rot)(q.numpy())),
          1e-15)
    zero = torch.zeros_like(q)
    close(tkin.fk_cal(q, zero, rho_fix), tkin.fk(q, rho_fix).numpy(), 1e-15)
    close(tkin.jac_cal(q, zero, rho_fix), tkin.jac(q, rho_fix).numpy(),
          1e-14)


# --- the SRB model ----------------------------------------------------------

def test_gravity_affine():
    for dt in (0.01, 0.0025):
        close(tsrb.gravity_affine(dt, F64, "cpu"),
              jsrb.gravity_affine(dt, jnp.float64), 0.0)
    assert tsrb.gravity_affine(0.01, device="cpu").dtype == torch.float32


def test_srb_continuous_dynamics():
    rng = np.random.default_rng(5)
    b = 6
    pos = rng.uniform(-0.5, 0.5, (b, 3))
    eul = rng.uniform(-0.3, 0.3, (b, 3))
    from legged_mpc_control_tpu.ops import so3 as jso3
    R = np.asarray(jax.vmap(lambda e: jso3.quat_to_rotmat(
        jso3.euler_to_quat(e)))(eul))
    om, vel = rng.normal(size=(b, 3)), rng.normal(size=(b, 3))
    grf = rng.uniform(-20.0, 20.0, (b, 4, 3))
    grf[..., 2] = np.abs(grf[..., 2]) + 10.0
    feet = pos[:, None] + rng.uniform(-0.3, 0.3, (b, 4, 3))
    mass = rng.uniform(10.0, 14.0, b)
    inertia = np.asarray(JP.trunk_inertia) * rng.uniform(0.8, 1.2, (b, 1, 1))
    jv, jw = jax.vmap(jsrb.srb_continuous_dynamics)(pos, R, om, vel, grf,
                                                     feet, mass, inertia)
    tv, tw = tsrb.srb_continuous_dynamics(*(t(x) for x in (
        pos, R, om, vel, grf, feet, mass, inertia)))
    close(tv, jv, 1e-12)
    close(tw, jw, 1e-10)


# --- the simulator on a raised plane -----------------------------------------

@pytest.fixture(scope="module")
def sim_batch():
    """Six standing scenarios lifted 0-5 cm, legs 1 and 2 in swing, and
    seeded torques: on a plane at 5 cm some swing feet touch down."""
    b = 6
    loop = jrunner.init_loop_batch(JP, b, jax.random.PRNGKey(2),
                                   dtype=jnp.float64)
    sim = loop.sim
    sim = sim.replace(pos=sim.pos.at[:, 2].add(0.01 * jnp.arange(b)),
                      contact=sim.contact.at[:, 1:3].set(False))
    tau = np.random.default_rng(6).normal(scale=4.0, size=(b, 12))
    return sim, tau


@pytest.mark.parametrize("height", [0.05, 0.0])
def test_sim_step_terrain_height_matches_jax(sim_batch, height):
    sim, tau = sim_batch
    dt = 0.01 / 8
    want = np_tree(jax.vmap(lambda s, u: jsim.sim_step(
        s, u, JP, dt, terrain_height=height))(sim, jnp.asarray(tau)))
    ts = _sim_from_numpy(np_tree(sim))
    pb = tstep.broadcast_params(TP, 6)
    got = tsim.sim_step(ts, t(tau), pb, dt, terrain_height=height)
    for f in ("pos", "quat", "vel", "omega", "q", "dq", "anchor", "last_acc"):
        close(getattr(got, f), getattr(want, f), 1e-12, what=f)
    assert np.array_equal(got.contact.numpy(), want.contact)
    if height > 0:
        landed = got.contact.numpy() & ~np.asarray(sim.contact)
        assert landed.any()
        close(got.anchor[..., 2].numpy()[landed], height, 0.0)
    else:
        # the plane at 0 is today's flat ground, bit for bit
        flat = tsim.sim_step(ts, t(tau), pb, dt)
        for f in ("pos", "quat", "vel", "omega", "q", "dq", "anchor",
                  "last_acc", "contact"):
            assert torch.equal(getattr(got, f), getattr(flat, f)), f


def _sim_from_numpy(tree):
    return tsim.SimState(**{k: t(v) for k, v in vars(tree).items()})


# --- the reference's sparse QP ---------------------------------------------

@pytest.fixture(scope="module")
def sparse_problem():
    """Three trotting scenarios at H=10 (tests/test_torch_condensed.py's
    draw): states near a trot, a mixed contact schedule, own friction."""
    rng = np.random.default_rng(7)
    b, horizon = 3, 10
    x0 = np.zeros((b, 12))
    x0[:, 0:3] = rng.uniform(-0.05, 0.05, size=(b, 3))
    x0[:, 5] = 0.28 + rng.uniform(-0.02, 0.02, b)
    x0[:, 9] = rng.uniform(-0.3, 0.5, b)
    x_ref, A_seq, Bm = jax.jit(ge._lin_batch_fn(JP, horizon))(jnp.asarray(x0))
    contact = (rng.uniform(size=(b, horizon, 4)) < 0.6).astype(np.float64)
    contact[:, 0, [0, 3]] = 1.0
    return dict(x0=x0, x_ref=np.asarray(x_ref), A_seq=np.asarray(A_seq),
                Bm=np.asarray(Bm), contact=contact,
                qw=np.asarray(JP.q_weights), rw=np.asarray(JP.r_weights),
                mu=rng.uniform(0.4, 0.9, b), fz_max=float(JP.fz_max))


def _scenario(p, i):
    return (p["x0"][i], p["x_ref"][i], p["A_seq"][i], p["Bm"][i],
            p["contact"][i], p["qw"], p["rw"], p["mu"][i], p["fz_max"])


@pytest.mark.parametrize("i", [0, 1, 2])
def test_reference_sparse_qp(sparse_problem, i):
    dt = 0.01
    got = tqp.reference_sparse_qp(*_scenario(sparse_problem, i), dt)
    want = jqp.reference_sparse_qp(*_scenario(sparse_problem, i), dt)
    for g, w, name in zip(got, want, ("Hs", "g", "Ac", "lb", "ub")):
        assert g.dtype == np.float64 and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    # torch tensors in give the same arrays
    tin = tqp.reference_sparse_qp(*(t(a) if isinstance(a, np.ndarray) else a
                                    for a in _scenario(sparse_problem, i)), dt)
    for g, w in zip(tin, got):
        np.testing.assert_array_equal(g, w)
    z = solve_qp_oracle(*got)
    horizon = sparse_problem["x_ref"].shape[1]
    u_oracle = np.concatenate([z[k * 24:k * 24 + 12] for k in range(horizon)])
    p = sparse_problem
    u, _, _ = tric.solve_qp_riccati_batched(
        t(p["x0"][i:i + 1]), t(p["x_ref"][i:i + 1]), t(p["A_seq"][i:i + 1]),
        t(p["Bm"][i:i + 1]), t(p["contact"][i:i + 1]), t(p["qw"]),
        t(p["rw"]), t(p["mu"][i:i + 1]), p["fz_max"], dt)
    close(u[0], u_oracle, 1e-4, what="Riccati u vs oracle [N]")


# --- the LCI seam's names ---------------------------------------------------

def test_lci_names():
    assert (tlci.X_DIM, tlci.OUT_DIM) == (jlci.X_DIM, jlci.OUT_DIM)
    stand = tlci.make_stand_policy(
        params_from_numpy(params_mapping(jgo1(jnp.float64))))
    x = torch.zeros((2, tlci.X_DIM), dtype=F64)
    x[:, 2] = 0.3
    assert stand(x, torch.zeros(2, dtype=F64)).shape == (2, tlci.OUT_DIM)
    assert typing.get_args(tlci.PolicyFn) == ([torch.Tensor, torch.Tensor],
                                              torch.Tensor)
