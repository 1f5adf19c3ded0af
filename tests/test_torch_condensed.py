"""The port's condensed-QP solvers vs the JAX package, in float64 on the
CPU (plain versions of kernels K4/K5): `qp_builder.build_condensed_qp`,
PDIP cold and warm and ADMM cold and warm (with the warm tuple) against the
JAX "xla" backend, and one PDIP solve against the independent float64
oracle of tests/oracle.py on the reference's sparse QP. B=6 scenarios at
H=10, drawn with numpy from a seed: states around a trot, a mixed contact
schedule per scenario, per-scenario friction.

Then the plain versions of K4 and K5 (`ops/chol_kernel.py`) vs the TPU
kernels `cholesky_lanes` / `cho_solve_lanes` of
`legged_mpc_control_tpu/ops/chol_pallas.py` in Pallas interpret mode, at
the sizes of tests/test_chol_pallas.py. The TPU kernels take the batch
innermost, (n, n, B); the port batch-first, (B, n, n): the tests transpose.
Only the lower triangle of the TPU factor is valid; the port's factor
mirrors L^T into its strict upper triangle. float64 factors of these
well-conditioned matrices (5 I + a random Gram part) agree elementwise;
float32 ones are compared by the relative residual of L L^T - K and the
solves by that of K x - b."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from legged_mpc_control_tpu.config import go1_params as jgo1
from legged_mpc_control_tpu.mpc import admm as jadmm
from legged_mpc_control_tpu.mpc import pdip as jpdip
from legged_mpc_control_tpu.mpc import qp_builder as jqp
from legged_mpc_control_tpu.mpc import riccati as jric
from legged_mpc_control_tpu.ops import chol_pallas
from legged_mpc_control_tpu_torch.mpc import admm as tadmm
from legged_mpc_control_tpu_torch.mpc import pdip as tpdip
from legged_mpc_control_tpu_torch.mpc import qp_builder as tqp
from legged_mpc_control_tpu_torch.mpc import riccati as tric
from legged_mpc_control_tpu_torch.ops import chol_kernel
from oracle import solve_qp_oracle
from torch_parity import close, np_tree, t

B = 6
H = 10
DT = 0.01
PDIP_ITERS, PDIP_WARM_ITERS = 25, 8
ADMM_ITERS, ADMM_WARM_ITERS = 200, 30
_rng = np.random.default_rng(3)


@pytest.fixture(scope="module")
def problem():
    """Stagewise QP data (numpy) from the JAX linearization of random
    trotting states."""
    params = jgo1(jnp.float64)
    x0 = np.zeros((B, 12))
    x0[:, 0:3] = _rng.uniform(-0.05, 0.05, size=(B, 3))
    x0[:, 5] = 0.28 + _rng.uniform(-0.02, 0.02, B)
    x0[:, 9] = _rng.uniform(-0.3, 0.5, B)
    x_ref, A_seq, Bm = jax.jit(ge._lin_batch_fn(params, H))(
        jnp.asarray(x0))
    contact = (_rng.uniform(size=(B, H, 4)) < 0.6).astype(np.float64)
    contact[:, 0, [0, 3]] = 1.0                 # something carries weight
    return dict(x0=x0, x_ref=np.asarray(x_ref), A_seq=np.asarray(A_seq),
                Bm=np.asarray(Bm), contact=contact,
                qw=np.asarray(params.q_weights),
                rw=np.asarray(params.r_weights),
                mu=_rng.uniform(0.4, 0.9, B), fz_max=float(params.fz_max))


def _stage(p):
    return (p["x0"], p["x_ref"], p["A_seq"], p["Bm"], p["contact"], p["qw"],
            p["rw"], p["mu"], p["fz_max"])


@pytest.fixture(scope="module")
def jax_solves(problem):
    """The JAX package's condensed QP and its PDIP / ADMM solves (xla)."""
    build = jax.jit(jax.vmap(
        lambda x0, xr, A, Bm, c, qw, rw, mu, fz: jqp.build_condensed_qp(
            x0, xr, A, Bm, c, qw, rw, mu, fz, DT),
        in_axes=(0, 0, 0, 0, 0, None, None, 0, None)))
    qp = build(*_stage(problem))
    c, mu, fz = problem["contact"], problem["mu"], problem["fz_max"]

    def pdip(P, q, warm_u, iters):
        return jpdip.solve_qp_pdip_batched(P, q, mu, fz, c, iters=iters,
                                           backend="xla", warm_u=warm_u)

    def admm(P, q, warm, iters):
        return jadmm.solve_qp_admm_batched(P, q, mu, fz, c, iters=iters,
                                           warm=warm, backend="xla")

    pdip_cold = jax.jit(functools.partial(pdip, warm_u=None,
                                          iters=PDIP_ITERS))(qp.P, qp.q)
    warm_u = jric.warm_shift(pdip_cold.u, jnp.asarray(c))
    pdip_warm = jax.jit(functools.partial(pdip, iters=PDIP_WARM_ITERS))(
        qp.P, qp.q, warm_u)
    admm_cold = jax.jit(functools.partial(admm, warm=None,
                                          iters=ADMM_ITERS))(qp.P, qp.q)
    admm_warm = jax.jit(functools.partial(admm, iters=ADMM_WARM_ITERS))(
        qp.P, qp.q, admm_cold.warm)
    return np_tree(dict(qp=qp, pdip_cold=pdip_cold, pdip_warm=pdip_warm,
                        admm_cold=admm_cold, admm_warm=admm_warm))


@pytest.fixture(scope="module")
def torch_qp(problem):
    return tqp.build_condensed_qp(*(t(a) for a in _stage(problem)), DT)


def test_build_condensed_qp_matches_jax(jax_solves, torch_qp):
    want = jax_solves["qp"]
    # P's entries reach ~1e3 (q_z weight 3500): the same float64 products
    # in another order agree to ~1e-16 relative
    close(torch_qp.P, want.P, 1e-10, rtol=1e-12, what="P")
    close(torch_qp.q, want.q, 1e-10, rtol=1e-12, what="q")
    assert torch.equal(torch_qp.P, torch_qp.P.transpose(-1, -2))


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_pdip_matches_jax_xla(problem, jax_solves, torch_qp, start):
    want = jax_solves[f"pdip_{start}"]
    warm_u, iters = None, PDIP_ITERS
    if start == "warm":
        warm_u = tric.warm_shift(t(jax_solves["pdip_cold"].u),
                                 t(problem["contact"]))
        iters = PDIP_WARM_ITERS
    res = tpdip.solve_qp_pdip_batched(
        torch_qp.P, torch_qp.q, torch_qp.mu, torch_qp.fz_max,
        torch_qp.contact, iters=iters, warm_u=warm_u)
    # the same float64 iteration; the Newton systems are conditioned to
    # d_max = 1e14, so the GRFs [N] agree to ~1e-10 where both froze
    close(res.u, want.u, 1e-8, what="u [N]")
    close(res.gap, want.gap, 1e-12, what="gap")
    assert res.iters == iters


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_admm_matches_jax_xla(jax_solves, torch_qp, start):
    want = jax_solves[f"admm_{start}"]
    warm, iters = None, ADMM_ITERS
    if start == "warm":
        warm = tuple(t(w) for w in jax_solves["admm_cold"].warm)
        iters = ADMM_WARM_ITERS
    res = tadmm.solve_qp_admm_batched(
        torch_qp.P, torch_qp.q, torch_qp.mu, torch_qp.fz_max,
        torch_qp.contact, iters=iters, warm=warm)
    # a contraction in float64: rounding differences stay ~1e-12
    close(res.u, want.u, 1e-8, what="u [N]")
    for got, w, name in zip(res.warm, want.warm, ("x", "z", "y")):
        close(got, w, 1e-8, what=f"warm {name}")
    close(res.r_prim, want.r_prim, 1e-8, what="r_prim")
    close(res.r_dual, want.r_dual, 1e-8, what="r_dual")


def test_pdip_matches_the_oracle(problem, torch_qp):
    """Scenario 0 against the float64 oracle on the reference's sparse QP
    (states as variables, degenerate swing boxes): the GRF bound of
    BASELINE.md, 1e-4 N."""
    res = tpdip.solve_qp_pdip_batched(
        torch_qp.P, torch_qp.q, torch_qp.mu, torch_qp.fz_max,
        torch_qp.contact, iters=PDIP_ITERS)
    stage = [a[0] if isinstance(a, np.ndarray) and a.shape[:1] == (B,)
             else a for a in _stage(problem)]
    Hs, g, Ac, lb, ub = jqp.reference_sparse_qp(*stage, DT)
    z = solve_qp_oracle(Hs, g, Ac, lb, ub)
    u_oracle = np.concatenate([z[k * 24:k * 24 + 12] for k in range(H)])
    close(res.u[0], u_oracle, 1e-4, what="u vs oracle [N]")


# --- K4 / K5 plain versions vs the Pallas kernels ------------------------

def spd_batch(b, n, seed, dtype):
    """(b, n, n) SPD batch as tests/test_chol_pallas.py draws it."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(b, n, n))
    return (A @ A.transpose(0, 2, 1) * 0.05 + 5.0 * np.eye(n)).astype(dtype)


def lanes(x):
    return jnp.asarray(np.moveaxis(x, 0, -1))


def unlanes(x):
    return np.moveaxis(np.asarray(x), -1, 0)


@pytest.mark.parametrize("n,b,seed", [(24, 16, 0), (16, 5, 2)])
def test_cholesky_plain_matches_pallas_f64(n, b, seed):
    K = spd_batch(b, n, seed, np.float64)
    want = unlanes(chol_pallas.cholesky_lanes(lanes(K), interpret=True))
    F = chol_kernel.cholesky_plain(t(K))
    tril = np.tril(np.ones((n, n), dtype=bool))
    close(F.numpy()[:, tril], want[:, tril], 1e-10, what="L")
    # the strict upper triangle mirrors L
    assert torch.equal(F, F.transpose(-1, -2))


def test_cho_solve_plain_matches_pallas_f64():
    n, b = 24, 16
    K = spd_batch(b, n, 3, np.float64)
    rhs = np.random.default_rng(4).normal(size=(b, n))
    Lt = chol_pallas.cholesky_lanes(lanes(K), interpret=True)
    want = unlanes(chol_pallas.cho_solve_lanes(Lt, lanes(rhs),
                                               interpret=True))
    got = chol_kernel.cho_solve_plain(chol_kernel.cholesky_plain(t(K)),
                                      t(rhs))
    close(got, want, 1e-10, what="x")


def test_mpc_sized_f32_by_residuals():
    """n=120 (H=10), the Newton system's size: both float32 versions
    factor and solve to float32 residuals (~1e-6 relative; 1e-5 allowed)."""
    n, b = 120, 8
    K = spd_batch(b, n, 5, np.float32)
    rhs = np.random.default_rng(6).normal(size=(b, n)).astype(np.float32)
    Lt = chol_pallas.cholesky_lanes(lanes(K), interpret=True)
    x_tpu = unlanes(chol_pallas.cho_solve_lanes(Lt, lanes(rhs),
                                                interpret=True))
    F = chol_kernel.cholesky_plain(t(K))
    x = chol_kernel.cho_solve_plain(F, t(rhs))
    K64 = torch.as_tensor(K, dtype=torch.float64)

    def factor_resid(L):
        L = torch.tensor(np.array(L), dtype=torch.float64).tril()
        return float((L @ L.transpose(-1, -2) - K64).abs().amax()
                     / K64.abs().amax())

    def solve_resid(x):
        x = torch.tensor(np.array(x), dtype=torch.float64)
        r = (K64 @ x[..., None])[..., 0] - torch.as_tensor(rhs).double()
        return float(r.abs().amax() / abs(rhs).max())

    assert factor_resid(F) < 1e-5
    assert factor_resid(unlanes(Lt)) < 1e-5
    assert solve_resid(x) < 1e-5
    assert solve_resid(x_tpu) < 1e-5


def test_non_positive_pivot_gives_non_finite():
    """A matrix that is not positive definite factors to non-finite values
    in both versions (the TPU kernel's rsqrt is not clamped); the others in
    the batch are untouched."""
    K = spd_batch(3, 8, 7, np.float64)
    K[1, 4, 4] = -1.0
    want = unlanes(chol_pallas.cholesky_lanes(lanes(K), interpret=True))
    F = chol_kernel.cholesky_plain(t(K)).numpy()
    assert not np.isfinite(want[1]).all() and not np.isfinite(F[1]).all()
    tril = np.tril(np.ones((8, 8), dtype=bool))
    close(F[[0, 2]][:, tril], want[[0, 2]][:, tril], 1e-10)
