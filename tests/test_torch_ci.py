"""PyTorch port vs the JAX package: the contact-implicit MPC
(`mpc/ci_mpc.py`) and its kernels' plain versions, in f64 on numpy inputs.

  * the pieces (`_dyn_b`, `_dyn_jac_b`, `_flat_res_jac`, `_quad_ggn_b`) on
    flat and boxed terrain, and the policy's `make_ci_reference`,
    `_walk_prep`, `_walk_post`: 1e-10 times the array's largest magnitude
    when that exceeds 1 (the same closed forms, float64 operations in
    another order; the FB curvature near a = b = 0 reaches 1e6);
  * whole solves, `ci_solve_batched` "plain" against JAX "xla" at B=3,
    H=10, 6 sweeps, flat and boxed, and K7's plain version
    `ci_sweeps_plain` against JAX "xla" on the flat problem of
    tests/test_ci_fused.py: 1e-8 (six Gauss-Newton sweeps amplify the
    reordering of float64 sums);
  * the line-search rule where all five candidates cost NaN: K7's plain
    version keeps the nominal, as the TPU kernel does, "plain" commits
    alpha = 1, as JAX "xla" does;
  * K6's plain version against `chol_pallas.cho_solve_lanes_multi` in
    interpret mode: 1e-10;
  * the dispatch rules of `ci_solve_batched`, raises included.
Every JAX reference comes from one compiled call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.mpc import ci_mpc as jci
from legged_mpc_control_tpu.ops import chol_pallas
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.mpc import ci_mpc as tci
from legged_mpc_control_tpu_torch.ops import chol_kernel, ci_kernel, cuda_build
from legged_mpc_control_tpu_torch.sim import terrain as tterr
from torch_parity import close, np_tree, params_mapping, t

F64 = jnp.float64
F64T = torch.float64
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
B, H, ITERS = 3, 10, 6
DT, SF = 0.02, 50.0
_rng = np.random.default_rng(5)


def _terrains():
    flat = jterr.flat(extent=3.0, cell=0.05, dtype=F64)
    boxed = jterr.add_box(flat, center_xy=(0.45, 0.0), size_xy=(0.5, 2.0),
                          height=0.03)
    return {"flat": flat, "boxed": boxed}


TERR = _terrains()
MASS, MU = float(JP.mass), float(JP.mu)
IW = np.broadcast_to(np.asarray(JP.trunk_inertia), (B, 3, 3)).copy()
RHO = np.array([0.5, 0.15, 0.05])


def _stage_inputs():
    """Random stage states/inputs: feet around the ground (both gap signs),
    forces around mg/4 with some exactly-zero tangential components (the
    sign(0) case of the cone rows)."""
    Zs = np.zeros((B, H, 24))
    Zs[..., 0:3] = [0.0, 0.0, 0.3] + 0.02 * _rng.normal(size=(B, H, 3))
    Zs[..., 3:12] = 0.05 * _rng.normal(size=(B, H, 9))
    feet = (np.asarray(JP.default_foot_pos) + [0.0, 0.0, 0.3]
            + [0.05, 0.0, 0.0] * _rng.uniform(-1, 6, size=(B, H, 4, 1))
            + [0.0, 0.0, 0.01] * _rng.normal(size=(B, H, 4, 1)))
    Zs[..., 12:24] = feet.reshape(B, H, 12)
    Uh = np.zeros((B, H, 24))
    f = _rng.normal(scale=0.15, size=(B, H, 4, 3))
    f[..., 2] = _rng.uniform(-0.2, 1.2, size=(B, H, 4))
    f[:, 0::3, :, 0] = 0.0
    f[:, 1::4, :, 1] = 0.0
    Uh[..., 0:12] = f.reshape(B, H, 12)
    Uh[..., 12:24] = 0.2 * _rng.normal(size=(B, H, 12))
    fm = (_rng.uniform(size=(B, H, 4)) < 0.8).astype(float)
    return Zs, Uh, fm


ZS, UH, FM = _stage_inputs()


def _problem():
    """tests/test_ci_fused.py's `_problem` (B=3, H=10, velx 0.15) with numpy
    noise: z0, the policy clock t, f_mask with foot 1 barred at stage 0."""
    pos = np.array([0.0, 0.0, 0.3])
    feet = np.asarray(JP.default_foot_pos) + pos
    base = np.concatenate([pos, np.zeros(3), [0.15, 0.0, 0.0], np.zeros(3),
                           feet.reshape(-1)])
    z0 = base + 0.01 * _rng.normal(size=(B, 24))
    fm = np.ones((B, H, 4))
    fm[:, 0, 1] = 0.0
    return z0, 0.03 * np.arange(B), fm


Z0, T0, FMASK = _problem()


def _policy_inputs():
    x = np.zeros((B, 40))
    x[:, 0:3] = [0.05, -0.02, 0.29] + 0.01 * _rng.normal(size=(B, 3))
    x[:, 3:6] = 0.05 * _rng.normal(size=(B, 3))
    foot = (np.asarray(JP.default_foot_pos) + [0.0, 0.0, 0.01]
            + 0.01 * _rng.normal(size=(B, 4, 3)))
    x[:, 6:18] = foot.reshape(B, 12)
    x[:, 18:24] = 0.1 * _rng.normal(size=(B, 6))
    x[:, 24:36] = 0.1 * _rng.normal(size=(B, 12))
    x[:, 36:40] = _rng.choice([0.0, 1.0, 30.0], size=(B, 4))
    U = np.concatenate([
        _rng.uniform(-5.0, 40.0, size=(B, H, 12)),
        0.2 * _rng.normal(size=(B, H, 12))], -1)
    Z = np.concatenate([np.tile(Z0[:, None], (1, H + 1, 1))[..., :12],
                        np.tile(Z0[:, None, 12:24], (1, H + 1, 1))
                        + 0.02 * _rng.normal(size=(B, H + 1, 12))], -1)
    return x, 0.05 + 0.02 * np.arange(B), U, Z


X40, TX, UPOST, ZPOST = _policy_inputs()
NAN_AT = (1, 5, 0)     # refs_u entry made NaN in the all-non-finite case


def _chol_case():
    A = _rng.normal(size=(5, 24, 24))
    K = A @ np.swapaxes(A, -1, -2) + 24.0 * np.eye(24)
    L = np.linalg.cholesky(K)
    return L, _rng.normal(size=(5, 24, 25))


L6, R6 = _chol_case()


@pytest.fixture(scope="module")
def jax_out():
    def ref(terr, zs, uh, fm, rho, z0, t0, fmask, x40, tx, upost, zpost):
        wts = jci.default_weights(F64)
        Iw_inv = jnp.linalg.inv(IW)
        out = {"dyn": jci._dyn_b(zs, uh, MASS, Iw_inv[:, None], DT, SF),
               "jac": jci._dyn_jac_b(zs, uh, MASS, Iw_inv, DT, SF),
               "ci_dyn": jax.vmap(lambda z, u: jci.ci_dynamics(
                   z, u, MASS, Iw_inv[0], DT))(zs[:, 0], SF * uh[:, 0])}
        feet = zs[..., 12:24].reshape(B, H, 4, 3)
        fh = uh[..., 0:12].reshape(B, H, 4, 3)
        wh = uh[..., 12:24].reshape(B, H, 4, 3)
        for name, tr in terr.items():
            out[f"res_{name}"] = jci._flat_res_jac(
                feet, fh, wh, fm, rho[:, None, None], tr, MU, SF)
            refs = jax.vmap(lambda zz, tt: jci.make_ci_reference(
                zz, tt, tr, JP, velx=0.15, gait_freq=3.5, horizon=H))(z0, t0)
            out[f"ref_{name}"] = refs
            refs_z, refs_u, U0 = refs
            out[f"quad_{name}"] = jci._quad_ggn_b(
                zs, uh, refs_z, refs_u, fm, tr, None, wts, MU, rho, SF)
            U = jnp.concatenate([SF * uh[..., :12], uh[..., 12:]], -1)
            out[f"stage_{name}"] = jax.vmap(jax.vmap(
                lambda z, u, rz, ru, f, r: jci.ci_stage_cost(
                    z, u, rz, ru, tr, wts, MU, r, f),
                in_axes=(0, 0, 0, 0, 0, None)))(
                zs, U, refs_z[:, :-1], refs_u, fm, rho)
            out[f"total_{name}"] = jci._total_cost_b(
                z0, U, refs_z, refs_u, tr, wts, MU, rho, MASS, Iw_inv, DT,
                fm)
            out[f"solve_{name}"] = jci.ci_solve_batched(
                z0, U0, refs_z, refs_u, tr, MASS, IW, MU, f_mask=fmask,
                iters=ITERS, rho0=0.3, backend="xla")
            prep = jax.vmap(lambda xx, tt: jci._walk_prep(
                xx, tt, JP, tr, 0.1, 0.3, 2.5, H, 0.02, (0.0, 0.5, 0.5, 0.0),
                0.5))(x40, tx)
            out[f"prep_{name}"] = prep
            out[f"post_{name}"] = jax.vmap(
                lambda u, z, rz, g, fw: jci._walk_post(u, z, rz, g, fw, tr,
                                                       2.0))(
                upost, zpost, prep[1], prep[6], prep[4 + 3])
        # the all-non-finite sweep: one NaN in scenario 1's input reference
        refs_z, refs_u, U0 = out["ref_flat"]
        refs_u = refs_u.at[NAN_AT].set(jnp.nan)
        out["nan_solve"] = jci.ci_solve_batched(
            z0, U0, refs_z, refs_u, terr["flat"], MASS, IW, MU,
            f_mask=fmask, iters=1, rho0=0.3, backend="xla")
        return out

    out = jax.jit(ref)(TERR, ZS, UH, FM, RHO, Z0, T0, FMASK, X40, TX, UPOST,
                       ZPOST)
    Lt = jnp.transpose(jnp.asarray(L6), (1, 2, 0))
    out["k6"] = jnp.transpose(chol_pallas.cho_solve_lanes_multi(
        Lt, jnp.transpose(jnp.asarray(R6), (1, 2, 0)), interpret=True),
        (2, 0, 1))
    return np_tree(out)


def near(got, want, tol, what=""):
    """|got - want| <= tol * max(1, max |want|)."""
    scale = max(1.0, float(np.nanmax(np.abs(np.asarray(want)))))
    close(got, want, tol * scale, what=what)


def _terr(name):
    return tterr.terrain_from_numpy(np_tree(TERR[name]))


def _iw_inv():
    return torch.linalg.inv(t(IW))


@pytest.mark.parametrize("name", ["flat", "boxed"])
def test_costs(jax_out, refs, name):
    """The exact costs, and the solver's scaled-coordinate total cost
    `_traj_cost_k` equal to `_traj_cost_b` on the same trajectory."""
    tr = _terr(name)
    wts = tci.default_weights(F64T, "cpu")
    refs_z, refs_u, _ = (t(a) for a in refs[name])
    U = torch.cat([SF * t(UH)[..., :12], t(UH)[..., 12:]], -1)
    near(tci.ci_stage_cost(t(ZS), U, refs_z[:, :-1], refs_u, tr, wts, MU,
                           t(RHO)[:, None], t(FM)),
         jax_out[f"stage_{name}"], 1e-10, what="stage")
    mass = torch.tensor(MASS, dtype=F64T)
    cost, Z = tci._total_cost_b(t(Z0), U, refs_z, refs_u, tr, wts, MU,
                                t(RHO), mass, _iw_inv(), DT, t(FM))
    near(cost, jax_out[f"total_{name}"][0], 1e-10, what="total")
    near(Z, jax_out[f"total_{name}"][1], 1e-10, what="rollout")
    s_u, wvec, ref_zu = tci._kernel_form(wts, refs_z, refs_u, SF)
    near(tci._traj_cost_k(Z, U / s_u, ref_zu, refs_z[:, -1], t(FM), tr,
                          wvec, MU, t(RHO), SF), cost, 1e-10, what="scaled")


def test_dynamics_and_jacobians(jax_out):
    near(tci._dyn_b(t(ZS), t(UH), MASS, _iw_inv()[:, None], DT, SF),
         jax_out["dyn"], 1e-10)
    near(tci.ci_dynamics(t(ZS)[:, 0], SF * t(UH)[:, 0], MASS, _iw_inv(), DT),
         jax_out["ci_dyn"], 1e-10)
    Fz, Fu = tci._dyn_jac_b(t(ZS), t(UH), torch.tensor(MASS, dtype=F64T),
                            _iw_inv(), DT, SF)
    near(Fz, jax_out["jac"][0], 1e-10, what="Fz")
    near(Fu, jax_out["jac"][1], 1e-10, what="Fu")


@pytest.mark.parametrize("name", ["flat", "boxed"])
def test_residual_jacobian_and_quadratization(jax_out, name):
    tr = _terr(name)
    feet = t(ZS)[..., 12:24].reshape(B, H, 4, 3)
    fh = t(UH)[..., 0:12].reshape(B, H, 4, 3)
    wh = t(UH)[..., 12:24].reshape(B, H, 4, 3)
    r, J = tci._flat_res_jac(feet, fh, wh, t(FM), t(RHO)[:, None, None], tr,
                             MU, SF)
    near(r, jax_out[f"res_{name}"][0], 1e-10, what="r")
    near(J, jax_out[f"res_{name}"][1], 1e-10, what="J")
    refs_z, refs_u, _ = (t(a) for a in jax_out[f"ref_{name}"])
    wts = tci.default_weights(F64T, "cpu")
    g, Hm = tci._quad_ggn_b(t(ZS), t(UH), refs_z, refs_u, t(FM), tr, None,
                            wts, MU, t(RHO), SF)
    near(g, jax_out[f"quad_{name}"][0], 1e-10, what="g")
    near(Hm, jax_out[f"quad_{name}"][1], 1e-10, what="Hm")
    if name == "boxed":        # the box edge slopes some feet's gap
        assert float(J[..., 0, 0].abs().max()) > 0.0


@pytest.mark.parametrize("name", ["flat", "boxed"])
def test_reference_and_walk_prep_post(jax_out, name):
    tr = _terr(name)
    got = tci.make_ci_reference(t(Z0), t(T0), tr, TP, velx=0.15,
                                gait_freq=3.5, horizon=H)
    for g, w, what in zip(got, jax_out[f"ref_{name}"],
                          ("refs_z", "refs_u", "U0")):
        near(g, w, 1e-10, what=what)
    prep = tci._walk_prep(t(X40), t(TX), TP, tr, 0.1, 0.3, 2.5, H, 0.02,
                          (0.0, 0.5, 0.5, 0.0), 0.5)
    for i, (g, w) in enumerate(zip(prep, jax_out[f"prep_{name}"])):
        near(g, w, 1e-10, what=f"prep {i}")
    post = tci._walk_post(t(UPOST), t(ZPOST), prep[1], prep[6], prep[7], tr,
                          2.0)
    near(post, jax_out[f"post_{name}"], 1e-10)


def _solve(name, backend, refs=None, **kw):
    refs_z, refs_u, U0 = (t(a) for a in (refs or _REFS[name]))
    return tci.ci_solve_batched(
        t(Z0), U0, refs_z, refs_u, _terr(name), torch.tensor(MASS, dtype=F64T),
        t(IW), torch.tensor(MU, dtype=F64T), f_mask=t(FMASK),
        backend=backend, **kw)


_REFS = {}


@pytest.fixture(scope="module")
def refs(jax_out):
    for name in ("flat", "boxed"):
        _REFS[name] = jax_out[f"ref_{name}"]
    return _REFS


@pytest.mark.parametrize("name", ["flat", "boxed"])
def test_solve_plain_matches_xla(jax_out, refs, name):
    cuda_build.LAUNCHES.clear()
    U, Z, cost = _solve(name, "plain", iters=ITERS, rho0=0.3)
    Uw, Zw, cw = jax_out[f"solve_{name}"]
    close(U, Uw, 1e-8, what="U")
    close(Z, Zw, 1e-8, what="Z")
    close(cost, cw, 1e-8, rtol=1e-10, what="cost")
    # "lanes" is K4 + K6, whose plain versions run on CPU tensors
    Ul, Zl, cl = _solve(name, "lanes", iters=ITERS, rho0=0.3)
    assert torch.equal(Ul, U) and torch.equal(Zl, Z)
    assert sum(cuda_build.LAUNCHES.values()) == 0


def test_sweeps_plain_matches_xla(jax_out, refs):
    """K7's plain version on the kernel's own arguments."""
    refs_z, refs_u, U0 = (t(a) for a in refs["flat"])
    wts = tci.default_weights(F64T, "cpu")
    s_u, wvec, ref_zu = tci._kernel_form(wts, refs_z, refs_u, SF)
    Uh, Z, cost = ci_kernel.ci_sweeps_cuda(
        t(Z0), U0 / s_u, ref_zu, refs_z[:, -1], t(FMASK),
        torch.full((B,), 0.3, dtype=F64T), wvec, MU, MASS, _iw_inv(),
        iters=ITERS, dt=DT, s_f=SF, rho_min=0.05, reg=1e-2, state_reg=1e-1)
    Uw, Zw, cw = jax_out["solve_flat"]
    close(s_u * Uh, Uw, 1e-8, what="U")
    close(Z, Zw, 1e-8, what="Z")
    close(cost, cw, 1e-8, rtol=1e-10, what="cost")


def test_all_nonfinite_candidates(jax_out, refs):
    """A NaN in scenario 1's input reference makes every candidate's cost
    NaN; its stage guard zeroes only that stage, so the earlier stages
    still step. The "xla"/"plain" rule commits alpha = 1; K7 (and its plain
    version) keeps the nominal: the warm start and its rollout."""
    rz, ru, U0 = (np.array(a) for a in refs["flat"])
    ru[NAN_AT] = np.nan
    U, Z, cost = _solve("flat", "plain", refs=(rz, ru, U0), iters=1,
                        rho0=0.3)
    Uw, Zw, cw = jax_out["nan_solve"]
    close(U, Uw, 1e-8, what="U")
    close(Z, Zw, 1e-8, what="Z")
    assert np.isinf(cw[1]) and np.isinf(float(cost[1]))
    assert not np.allclose(Uw[1], U0[1], atol=1e-3)      # alpha = 1 moved
    Uk, Zk, ck = _solve("flat", "fused", refs=(rz, ru, U0), iters=1,
                        rho0=0.3)
    close(Uk[1], U0[1], 1e-12, what="nominal inputs")
    Z0r = tci._rollout_b(t(Z0), t(U0), torch.tensor(MASS, dtype=F64T),
                         _iw_inv(), DT)
    close(Zk[1], Z0r[1], 1e-12, what="nominal rollout")
    assert np.isinf(float(ck[1]))
    # the other scenarios agree between the two rules
    close(Uk[[0, 2]], U[[0, 2]], 1e-8)


def test_k6_plain_matches_pallas(jax_out):
    L = t(L6)
    F = L + L.tril(-1).transpose(-1, -2)
    X = chol_kernel.cho_solve_multi_plain(F, t(R6))
    close(X, jax_out["k6"], 1e-10)
    assert torch.equal(chol_kernel.cho_solve_multi_cuda(F, t(R6)), X)


def test_pallas_gate_matches_jax():
    """`ci_pallas_available` answers as the JAX package does."""
    jflat = jterr.flat(dtype=jnp.float32)
    jbox = jterr.add_box(jflat, center_xy=(1.0, 0.0), size_xy=(1.0, 1.0),
                         height=0.03)
    jwall = jterr.wall_at_x(0.4, dtype=jnp.float32)
    cases = [(jflat, None, 10, jnp.float32), (jflat, None, 12, jnp.float32),
             (jbox, None, 10, jnp.float32), (jflat, jwall, 10, jnp.float32),
             (jflat, None, 13, jnp.float32), (jflat, None, 10, jnp.float64)]
    for terr, wall, h, dt in cases:
        want = jci.ci_pallas_available(terr, wall, h, dt)
        tw = None if wall is None else tterr.wall_from_numpy(np_tree(wall))
        got = tci.ci_pallas_available(
            tterr.terrain_from_numpy(np_tree(terr)), tw, h,
            torch.float32 if dt == jnp.float32 else torch.float64)
        assert got == want, (h, dt)
    assert tci.ci_pallas_available(None, None, 10)


def test_dispatch(refs):
    """CPU: the default is "plain" in float64 and "fused" (K7's plain
    version) in float32 on flat ground; "fused" refuses a height field
    and a wall (ROADMAP fault 6), and nothing launches a kernel."""
    cuda_build.LAUNCHES.clear()
    kw = dict(iters=2, rho0=0.3)
    default = _solve("flat", None, **kw)
    plain = _solve("flat", "plain", **kw)
    for a, b in zip(default, plain):
        assert torch.equal(a, b)
    refs_z, refs_u, U0 = (t(a).float() for a in refs["flat"])
    args = (t(Z0).float(), U0, refs_z, refs_u, _terr("flat"),
            torch.tensor(MASS), t(IW).float(), torch.tensor(MU))
    f32 = tci.ci_solve_batched(*args, f_mask=t(FMASK).float(), **kw)
    fused = tci.ci_solve_batched(*args, f_mask=t(FMASK).float(),
                                 backend="fused", **kw)
    for a, b in zip(f32, fused):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="flat-zero"):
        _solve("boxed", "fused", **kw)
    with pytest.raises(ValueError, match="unknown backend"):
        _solve("flat", "xla", **kw)
    wall = tterr.wall_at_x(0.4, dtype=F64T, device="cpu")
    with pytest.raises(ValueError, match="serves no wall"):
        _solve("flat", "fused", wall=wall, **kw)
    wall32 = tterr.wall_at_x(0.4, device="cpu")
    with pytest.raises(ValueError, match="serves no wall"):
        tci.ci_solve_batched(*args, f_mask=t(FMASK).float(), wall=wall32,
                             backend="fused", **kw)
    assert sum(cuda_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("B,latency_per_sm,batch_per_sm,want", [
    (1, 2, 4, False),         # the B=1 policy
    (256, 2, 4, False),       # the flat loop at B=256: within one wave
    (264, 2, 4, False),       # exactly one wave of 2 x 132
    (265, 2, 4, True),        # past it
    (4096, 2, 4, True),       # the benchmark's CI cell
    (4096, 2, 3, True),       # any gain in residency
    (4096, 2, 2, False),      # no more scenarios an SM: the latency variant
    (4096, 1, 1, False),
])
def test_k7_variant_rule(B, latency_per_sm, batch_per_sm, want):
    """K7's wrapper takes its batch variant only past the latency
    variant's one wave (its resident blocks an SM x 132 SMs) and only
    where the batch variant holds more scenarios an SM."""
    assert ci_kernel.batch_variant_wins(B, latency_per_sm, batch_per_sm,
                                        132) is want
