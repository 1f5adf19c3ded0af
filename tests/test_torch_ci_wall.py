"""PyTorch port vs the JAX package: the contact-implicit MPC's wall branch
(`mpc/ci_mpc.py`) and the wall-lean template and policy, in float64 from
the same numpy inputs.

  * `env_gap_normal` at points seeded around the ground/wall corner (the
    sigmoid weight inside (0.05, 0.95) for some) and far from the wall, on
    a boxed height field: 1e-12;
  * the wall branch of `ci_stage_cost`: 1e-10 relative;
  * the closed-form per-foot residual Jacobians the quadratization uses,
    with and without the wall, against the port's own `torch.func.jacfwd`
    of `_foot_res` under one vmap and JAX's jacfwd under vmap: 1e-10;
    `_quad_ggn_b`'s g and Hm at B=2, H=4: 1e-9;
  * `ci_solve_batched(wall=...)`, "plain" against JAX "xla", B=2, H=10, six
    sweeps: U within 1e-8 (as the flat solve's parity, tests/test_torch_
    ci.py); `make_ci_lean_reference` at the lean pose of
    tests/test_ci_wall_lean.py:41-73: 1e-12; one `make_ci_lean_policy`
    call with a valid warm slot: 1e-8;
  * the assertions of `test_ci_lean_plan_is_equilibrium` on the port, in
    float32.
Every JAX reference comes from one compiled call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.mpc import ci_mpc as jci
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.mpc import ci_mpc as tci
from legged_mpc_control_tpu_torch.ops import cuda_build
from legged_mpc_control_tpu_torch.sim import terrain as tterr
from torch_parity import close, np_tree, params_mapping, t

F64 = jnp.float64
PITCH, WALL_X = -0.4, 0.35
JP = ja1(F64).replace(mu=jnp.asarray(0.6, F64))
TP = params_from_numpy(params_mapping(JP))
JWALL = jterr.wall_at_x(WALL_X, dtype=F64)
TWALL = tterr.wall_from_numpy(np_tree(JWALL))
JFLAT = jterr.flat(dtype=F64)
JBOX = jterr.add_box(jterr.flat(extent=3.0, cell=0.05, dtype=F64),
                     center_xy=(0.0, 0.0), size_xy=(0.2, 2.0), height=0.03)
TERR = {"flat": JFLAT, "boxed": JBOX}
POS = np.array([0.0, 0.0, 0.32])
EUL = np.array([0.0, PITCH, 0.0])
FEET = np.array([[WALL_X, 0.13, 0.42], [WALL_X, -0.13, 0.42],
                 [-0.17, 0.13, 0.0], [-0.17, -0.13, 0.0]])
B, H, ITERS, BQ, HQ = 2, 10, 6, 2, 4
_rng = np.random.default_rng(13)


def _tt(name):
    return tterr.terrain_from_numpy(np_tree(TERR[name]))


def _corner_points(n=64):
    """Points around the ground/wall corner (the blend's transition) and
    far from the wall, over the boxed field's edge at x = 0.1."""
    near = np.stack([_rng.uniform(0.05, 0.36, n), _rng.uniform(-0.3, 0.3, n),
                     _rng.uniform(-0.01, 0.15, n)], -1)
    far = np.stack([_rng.uniform(-1.5, -0.5, 8), _rng.uniform(-1, 1, 8),
                    _rng.uniform(-0.01, 0.3, 8)], -1)
    return np.concatenate([near, far])


def _stage_inputs(b, h):
    """Lean-like stage states and scaled inputs: front feet near the wall
    plane (both gap signs), rear feet near the ground, forces around the
    lean template's, some feet masked."""
    Zs = np.zeros((b, h, 24))
    Zs[..., 0:3] = POS + 0.01 * _rng.normal(size=(b, h, 3))
    Zs[..., 3:6] = EUL + 0.02 * _rng.normal(size=(b, h, 3))
    Zs[..., 6:12] = 0.05 * _rng.normal(size=(b, h, 6))
    feet = FEET + [0.004, 0.01, 0.004] * _rng.normal(size=(b, h, 4, 3))
    Zs[..., 12:24] = feet.reshape(b, h, 12)
    f = np.broadcast_to(np.array([[-0.4, 0.0, 0.2], [-0.4, 0.0, 0.2],
                                  [0.3, 0.0, 0.9], [0.3, 0.0, 0.9]]),
                        (b, h, 4, 3)) + 0.2 * _rng.normal(size=(b, h, 4, 3))
    Uh = np.concatenate([f.reshape(b, h, 12),
                         0.1 * _rng.normal(size=(b, h, 12))], -1)
    fm = (_rng.uniform(size=(b, h, 4)) < 0.8).astype(float)
    return Zs, Uh, fm


def _lean_state():
    """The lean pose of tests/test_ci_wall_lean.py:41-73 (the front feet
    1.5 mm short of the plane), as the seam's x (40,), slightly perturbed;
    the rear feet read their share of the weight."""
    feet_w = FEET.copy()
    feet_w[0:2, 0] -= 0.0015
    x = np.zeros(40)
    x[0:3] = POS + 0.002 * _rng.normal(size=3)
    x[3:6] = EUL + 0.01 * _rng.normal(size=3)
    x[6:18] = (feet_w - POS).reshape(-1) + 0.001 * _rng.normal(size=12)
    x[18:24] = 0.02 * _rng.normal(size=6)
    x[36:40] = [0.0, 0.0, 62.0, 61.0]
    return x


def _jsolve_inputs():
    z0 = np.concatenate([POS, EUL, np.zeros(6), FEET.reshape(-1)])
    z0 = z0 + 0.003 * _rng.normal(size=(B, 24))
    refs = [jci.make_ci_lean_reference(
        jnp.asarray(z), JWALL, jnp.asarray(FEET), jnp.asarray(POS),
        jnp.asarray(EUL), JP, JFLAT, horizon=H) for z in z0]
    rz = np.stack([np.asarray(r[0]) for r in refs])
    ru = np.stack([np.asarray(r[1]) for r in refs])
    fm = np.ones((B, H, 4))
    fm[1, 0, 1] = 0.0
    U0 = ru + 2.0 * _rng.normal(size=ru.shape)
    return z0, rz, ru, U0, fm


PTS = _corner_points()
STAGE = _stage_inputs(BQ, HQ)
REFS_Z = 0.05 * _rng.normal(size=(BQ, HQ + 1, 24))
REFS_U = 20.0 * _rng.normal(size=(BQ, HQ, 24))
RHO = np.array([0.3, 0.07])
SOLVE = _jsolve_inputs()
LEAN_X = _lean_state()


@pytest.fixture(scope="module")
def jax_out():
    out = {}
    for name, terr in TERR.items():
        out["gap", name] = [np.asarray(a) for a in jci.env_gap_normal(
            terr, JWALL, jnp.asarray(PTS))]
    Zs, Uh, fm = STAGE
    wts = jci.default_weights(F64)
    s_u = np.concatenate([np.full(12, 50.0), np.ones(12)])
    rho_bh = np.broadcast_to(RHO[:, None], (BQ, HQ))
    stage = jax.jit(jax.vmap(jax.vmap(
        lambda z, u, rz, ru, m, rh: jci.ci_stage_cost(
            z, u, rz, ru, JBOX, wts, JP.mu, rh, m, JWALL))))
    out["stage"] = np.asarray(stage(Zs, Uh * s_u, REFS_Z[:, :-1], REFS_U,
                                    fm, rho_bh))
    zeta = np.concatenate([Zs[..., 12:24].reshape(BQ, HQ, 4, 3),
                           Uh[..., 0:12].reshape(BQ, HQ, 4, 3),
                           Uh[..., 12:24].reshape(BQ, HQ, 4, 3)], -1)
    rho_f = np.broadcast_to(RHO[:, None, None], (BQ, HQ, 4))
    for wname, wall in (("wall", JWALL), ("flat", None)):
        res = (lambda ze, m, rh, _w=wall: jci._foot_res(
            ze, m, rh, JBOX, _w, JP.mu, 50.0))
        both = jax.jit(jax.vmap(lambda ze, m, rh, _r=res: (
            _r(ze, m, rh), jax.jacfwd(_r)(ze, m, rh))))
        r, J = both(zeta.reshape(-1, 9), fm.reshape(-1), rho_f.reshape(-1))
        out["res", wname] = (np.asarray(r), np.asarray(J))
    g, Hm = jax.jit(lambda *a: jci._quad_ggn_b(
        *a, JBOX, JWALL, wts, JP.mu, jnp.asarray(RHO), 50.0))(
        Zs, Uh, REFS_Z, REFS_U, fm)
    out["quad"] = (np.asarray(g), np.asarray(Hm))

    z0, rz, ru, U0, fm = SOLVE
    Iw = np.broadcast_to(np.asarray(JP.trunk_inertia), (B, 3, 3))
    U, Z, cost = jci.ci_solve_batched(
        z0, U0, rz, ru, JFLAT, JP.mass, Iw, JP.mu, None, fm, iters=ITERS,
        wall=JWALL, backend="xla")
    out["solve"] = (np.asarray(U), np.asarray(Z), np.asarray(cost))
    out["ref"] = [np.asarray(a) for a in jci.make_ci_lean_reference(
        jnp.asarray(z0[0]), JWALL, jnp.asarray(FEET), jnp.asarray(POS),
        jnp.asarray(EUL), JP, JFLAT, horizon=H,
        balance_pos=jnp.asarray(z0[0, 0:3] + 0.01),
        balance_feet=jnp.asarray(FEET + 0.002))]

    lean = jci.make_ci_lean_policy(JP, JWALL, jnp.asarray(FEET),
                                   jnp.asarray(POS), jnp.asarray(EUL),
                                   terrain=JFLAT, iters=ITERS)
    warm = {"u": jnp.asarray(ru[0] + 1.0), "valid": jnp.ones((), F64)}
    o, w = lean(jnp.asarray(LEAN_X), jnp.asarray(0.2, F64), warm)
    out["policy"] = (np.asarray(o), np.asarray(w["u"]), np.asarray(
        w["valid"]), np.asarray(warm["u"]))
    return out


@pytest.mark.parametrize("name", list(TERR))
def test_env_gap_normal(jax_out, name):
    gap, n = tci.env_gap_normal(_tt(name), TWALL, t(PTS))
    jgap, jn = jax_out["gap", name]
    close(gap, jgap, 1e-12)
    close(n, jn, 1e-12)
    # the blend's transition is exercised, and far from the wall the
    # ground owns the contact
    ground = PTS[:, 2] - np.asarray(jterr.height_at(TERR[name],
                                                    jnp.asarray(PTS[:, :2])))
    w = 1.0 / (1.0 + np.exp(-(ground - (WALL_X - PTS[:, 0])) / 0.03))
    assert ((w > 0.05) & (w < 0.95)).sum() >= 8
    np.testing.assert_allclose(jn[-8:], [[0.0, 0.0, 1.0]] * 8, atol=1e-12)
    g0, n0 = tci.env_gap_normal(_tt(name), None, t(PTS))
    close(g0, ground, 1e-12)
    assert torch.equal(n0, torch.tensor([0.0, 0.0, 1.0],
                                        dtype=torch.float64).expand(
                                            len(PTS), 3))


def test_stage_cost_wall(jax_out):
    Zs, Uh, fm = STAGE
    s_u = np.concatenate([np.full(12, 50.0), np.ones(12)])
    got = tci.ci_stage_cost(t(Zs), t(Uh * s_u), t(REFS_Z[:, :-1]),
                            t(REFS_U), _tt("boxed"),
                            tci.default_weights(torch.float64, "cpu"),
                            TP.mu, t(RHO)[:, None], t(fm), TWALL)
    close(got, jax_out["stage"], 0.0, rtol=1e-10)


def _jacfwd(zeta, fm, rho, terrain, wall):
    """The port's own `_foot_res` and its `torch.func.jacfwd` under one
    vmap over the feet, the height field's lookup taken outside the vmap
    (a grid lookup indexes by data, which vmap refuses)."""
    xy = zeta[:, 0:2]
    ground = (tci._height(terrain, xy), tci._height_grad(terrain, xy), xy)

    def res(ze, m, rh, h, hg, xy0):
        r = tci._foot_res(ze, m, rh, None, wall, TP.mu, 50.0, (h, hg, xy0))
        return r, r
    J, r = torch.func.vmap(torch.func.jacfwd(res, has_aux=True))(
        zeta, fm, rho, *ground)
    return r, J


@pytest.mark.parametrize("wname", ["wall", "flat"])
def test_foot_res_and_jacobian(jax_out, wname):
    """The closed-form residual Jacobians the quadratization uses against
    the port's jacfwd of `_foot_res` and against JAX's."""
    Zs, Uh, fm = STAGE
    wall = TWALL if wname == "wall" else None
    feet = t(Zs[..., 12:24]).reshape(BQ, HQ, 4, 3)
    fh = t(Uh[..., 0:12]).reshape(BQ, HQ, 4, 3)
    wh = t(Uh[..., 12:24]).reshape(BQ, HQ, 4, 3)
    closed = tci._wall_res_jac if wall is not None else (
        lambda *a: tci._flat_res_jac(*a[:6], *a[7:]))
    r, J = closed(feet, fh, wh, t(fm), t(RHO)[:, None, None], _tt("boxed"),
                  wall, TP.mu, 50.0)
    jr, jJ = jax_out["res", wname]
    close(r.reshape(-1, 8), jr, 1e-10)
    close(J.reshape(-1, 8, 9), jJ, 1e-10)
    zeta = torch.cat([feet, fh, wh], -1).reshape(-1, 9)
    rho_f = t(RHO)[:, None, None].expand(BQ, HQ, 4).reshape(-1)
    ra, Ja = _jacfwd(zeta, t(fm).reshape(-1), rho_f, _tt("boxed"), wall)
    assert Ja.dtype == torch.float64
    close(ra, r.reshape(-1, 8).numpy(), 1e-10)
    close(Ja, J.reshape(-1, 8, 9).numpy(), 1e-10)
    # float32 under the transforms stays float32
    _, J32 = _jacfwd(zeta[:8].float(), t(fm).reshape(-1)[:8].float(),
                     rho_f[:8].float(), None, None if wall is None else
                     tterr.wall_at_x(WALL_X, device="cpu"))
    assert J32.dtype == torch.float32
    tw = tci.default_weights(torch.float64, "cpu")
    w = tci._res_weights(tw.c_fb, tw.c_slip, tw.c_cone, tw.c_mask, wall)
    jw = jci._foot_res_weights(jci.default_weights(F64),
                               JWALL if wname == "wall" else None)
    close(w, np.asarray(jw), 0.0)


def test_quad_ggn_wall(jax_out):
    Zs, Uh, fm = STAGE
    g, Hm = tci._quad_ggn_b(t(Zs), t(Uh), t(REFS_Z), t(REFS_U), t(fm),
                            _tt("boxed"), TWALL,
                            tci.default_weights(torch.float64, "cpu"),
                            TP.mu, t(RHO), 50.0)
    jg, jH = jax_out["quad"]
    close(g, jg, 1e-9)
    close(Hm, jH, 1e-9)


def test_ci_solve_wall_plain_vs_xla(jax_out):
    z0, rz, ru, U0, fm = SOLVE
    Iw = t(np.broadcast_to(np.asarray(JP.trunk_inertia), (B, 3, 3)).copy())
    cuda_build.LAUNCHES.clear()
    U, Z, cost = tci.ci_solve_batched(
        t(z0), t(U0), t(rz), t(ru), _tt("flat"), TP.mass, Iw, TP.mu, None,
        t(fm), iters=ITERS, wall=TWALL)        # the CPU default: "plain"
    jU, jZ, jc = jax_out["solve"]
    close(U, jU, 1e-8)
    close(Z, jZ, 1e-8)
    close(cost, jc, 0.0, rtol=1e-8)
    # flat ground as None gives the same solve; nothing launched a kernel
    U2, _, _ = tci.ci_solve_batched(
        t(z0), t(U0), t(rz), t(ru), None, TP.mass, Iw, TP.mu, None, t(fm),
        iters=ITERS, wall=TWALL, backend="lanes")
    close(U2, jU, 1e-8)
    assert sum(cuda_build.LAUNCHES.values()) == 0


def test_lean_reference(jax_out):
    z0 = SOLVE[0]
    rz, ru, U0 = tci.make_ci_lean_reference(
        t(z0[0:1]), TWALL, t(FEET), t(POS), t(EUL), TP, None, horizon=H,
        balance_pos=t(z0[0:1, 0:3] + 0.01), balance_feet=t(FEET + 0.002)[
            None])
    jrz, jru, _ = jax_out["ref"]
    close(rz[0], jrz, 1e-12)
    close(ru[0], jru, 1e-12)
    assert U0 is ru
    # without the balance levers: the nominal pose's equilibrium, and the
    # same references from a batch of identical states
    rz2, ru2, _ = tci.make_ci_lean_reference(
        t(z0[0]).expand(3, 24), TWALL, t(FEET), t(POS), t(EUL), TP,
        _tt("flat"), horizon=H)
    jrz2, jru2, _ = jci.make_ci_lean_reference(
        jnp.asarray(z0[0]), JWALL, jnp.asarray(FEET), jnp.asarray(POS),
        jnp.asarray(EUL), JP, JFLAT, horizon=H)
    close(rz2, np.broadcast_to(np.asarray(jrz2), (3, H + 1, 24)), 1e-12)
    close(ru2, np.broadcast_to(np.asarray(jru2), (3, H, 24)), 1e-12)


def test_lean_policy_call(jax_out):
    lean = tci.make_ci_lean_policy(TP, TWALL, t(FEET), t(POS), t(EUL),
                                   iters=ITERS)
    jo, jwu, jvalid, warm_u = jax_out["policy"]
    warm = {"u": t(warm_u), "valid": torch.ones((), dtype=torch.float64)}
    out, w = lean(t(LEAN_X), torch.tensor(0.2, dtype=torch.float64), warm)
    assert out.shape == (78,) and w["u"].shape == (H, 24)
    close(out, jo, 1e-8)
    close(w["u"], jwu, 1e-8)
    assert float(w["valid"]) == float(jvalid) == 1.0
    cold = lean.warm_init(torch.float64, "cpu")
    assert cold["u"].shape == (H, 24) and cold["valid"].shape == ()
    assert lean.ci_stateful and not getattr(lean, "ci_batched", False)


def test_ci_lean_plan_is_equilibrium():
    """tests/test_ci_wall_lean.py's open-loop check on the port in float32:
    from the exact lean pose the CI solve returns a torque-balanced plan,
    the wall press near the preload, the rear feet carrying the weight,
    the planned pose flat across the horizon."""
    f32 = torch.float32
    p = params_from_numpy(params_mapping(ja1(jnp.float32))).replace(
        mu=torch.tensor(0.6))
    wall = tterr.wall_at_x(WALL_X, f32, "cpu")
    eul = torch.tensor(EUL, dtype=f32)
    z0 = torch.cat([torch.tensor(POS, dtype=f32), eul, torch.zeros(6),
                    torch.tensor(FEET, dtype=f32).reshape(-1)])
    refs_z, refs_u, U0 = tci.make_ci_lean_reference(
        z0[None], wall, torch.tensor(FEET, dtype=f32),
        torch.tensor(POS, dtype=f32), eul, p, None, horizon=10)
    U, Z, _ = tci.ci_solve(z0, U0[0], refs_z[0], refs_u[0], None, p.mass,
                           p.trunk_inertia, p.mu, iters=24, wall=wall)
    f = U[:, 0:12].reshape(10, 4, 3).numpy()
    assert np.all(-f[:, 0:2, 0] > 8.0), (-f[:, 0:2, 0]).min()
    mg = float(p.mass) * 9.81
    assert np.all(f[:, 2:4, 2].sum(axis=1) > 0.7 * mg)
    assert np.abs(Z[:, 4].numpy() - PITCH).max() < 0.02
    assert np.abs(Z[:, 2].numpy() - 0.32).max() < 0.01
