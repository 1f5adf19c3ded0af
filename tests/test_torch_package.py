"""Package hygiene of the PyTorch port: it imports no JAX, its kernel
wrappers run the plain versions on CPU tensors without launching anything,
its numpy converters round-trip exactly, and what is not ported yet raises."""

import pkgutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import legged_mpc_control_tpu_torch as pkg
from legged_mpc_control_tpu_torch.config import (
    a1_params,
    go1_params,
    params_from_numpy,
)
from legged_mpc_control_tpu_torch.control import step
from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait, riccati
from legged_mpc_control_tpu_torch.ops import riccati_kernel, substep_kernel
from legged_mpc_control_tpu_torch.parallel import runner
from legged_mpc_control_tpu_torch.types import (
    loop_state_from_numpy,
    loop_state_to_numpy,
)

MODULES = sorted(m.name for m in pkgutil.walk_packages(
    pkg.__path__, prefix=pkg.__name__ + "."))


def test_port_imports_no_jax():
    """Every module of the package, imported in a fresh interpreter,
    leaves jax and the JAX package out of sys.modules."""
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {MODULES!r}:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m.split('.')[0] in ('jax', 'jaxlib', 'flax',
                                      'legged_mpc_control_tpu')]
        assert not bad, bad
        print(len({MODULES!r}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def _small_loop(dtype=torch.float32, ticks=4):
    """A B=4 Go1 batch after a few trotting ticks of the port on the CPU."""
    params = go1_params(dtype)
    loop = runner.init_loop_batch(params, 4, torch.Generator().manual_seed(2),
                                  dtype=dtype, body_height=0.28)
    roll = runner.make_batched_rollout(
        gait.trot_pattern(dtype), n_ticks=ticks, pdip_iters=6,
        walk_velx=0.2, stand_ticks=1)
    loop, _ = roll(loop, params)
    return loop, step.broadcast_params(params, 4)


def test_riccati_wrapper_on_cpu_is_the_plain_version():
    loop, params = _small_loop()
    pattern = gait.trot_pattern(torch.float32)
    _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern, 0.01,
                                      horizon=10)
    args = (stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, 0.01)
    before = riccati_kernel.solve_qp_riccati_cuda.launches
    got = riccati_kernel.solve_qp_riccati_cuda(*args, iters=8)
    want = riccati.solve_qp_riccati_batched(*args, iters=8)
    assert riccati_kernel.solve_qp_riccati_cuda.launches == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_rollout_launches_no_kernel():
    riccati_kernel.solve_qp_riccati_cuda.launches = 0
    substep_kernel.substep_chain_cuda.launches = 0
    loop, _ = _small_loop(ticks=2)
    assert riccati_kernel.solve_qp_riccati_cuda.launches == 0
    assert substep_kernel.substep_chain_cuda.launches == 0
    assert bool(torch.isfinite(loop.sim.pos).all())


@pytest.mark.parametrize("make", [a1_params, go1_params])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_params_round_trip(make, dtype):
    p = make(dtype)
    mapping = {k: getattr(p, k).numpy() for k in p.__dataclass_fields__}
    q = params_from_numpy(mapping)
    for k in p.__dataclass_fields__:
        assert torch.equal(getattr(q, k), getattr(p, k)), k


def test_loop_state_round_trip():
    loop, _ = _small_loop(ticks=2)
    tree = loop_state_to_numpy(loop)
    assert isinstance(tree["sim"]["pos"], np.ndarray)
    back = loop_state_from_numpy(tree)

    def same(x, y):
        if isinstance(x, dict):
            assert x.keys() == y.keys()
            return sum(same(x[k], y[k]) for k in x)
        assert x.dtype == y.dtype and np.array_equal(x, y)
        return 1
    assert same(tree, loop_state_to_numpy(back)) > 50


def test_kf_type_1_raises():
    loop, params = _small_loop(ticks=1)
    pattern = gait.trot_pattern(torch.float32)
    with pytest.raises(NotImplementedError):
        step.closed_loop_tick_batched(loop, params, pattern, kf_type=1)
    with pytest.raises(NotImplementedError):
        runner.make_batched_rollout(pattern, kf_type=1)
    with pytest.raises(NotImplementedError):
        substep_kernel.substep_chain_cuda(*([None] * 21), substeps=8,
                                          dt=0.00125, kf_type=1)


def test_randomize_params_draws_from_the_generator():
    p = go1_params(torch.float64)
    a = runner.randomize_params(p, torch.Generator().manual_seed(7), 512)
    b = runner.randomize_params(p, torch.Generator().manual_seed(7), 512)
    for name, lo, hi in (("mass", 0.8, 1.2), ("mu", 0.5, 1.2),
                         ("gait_counter_speed", 0.9, 1.1)):
        x = getattr(a, name)
        assert x.shape == (512,) and torch.equal(x, getattr(b, name))
        ratio = x / getattr(p, name)
        assert float(ratio.min()) >= lo and float(ratio.max()) <= hi
        assert float(ratio.max() - ratio.min()) > 0.9 * (hi - lo)
    assert torch.equal(a.rho_fix, p.rho_fix)
    pb = step.broadcast_params(a, 512)
    assert pb.rho_fix.shape == (512, 4, 5) and pb.mass.shape == (512,)


@pytest.mark.parametrize("solver", ["pdip", "admm"])
def test_unported_solvers_raise(solver):
    loop, params = _small_loop(ticks=1)
    pattern = gait.trot_pattern(torch.float32)
    with pytest.raises(NotImplementedError):
        convex_mpc.mpc_tick_batched(loop.controller, params, pattern, 0.01,
                                    horizon=10, solver=solver)
    with pytest.raises(NotImplementedError):
        runner.make_batched_rollout(pattern, solver=solver)


def test_cuda_wrappers_refuse_f64_before_touching_a_device():
    """float64 off the CPU is refused by the dtype check, which runs before
    any library is built or loaded (meta tensors stand in for the card)."""
    def meta(*shape):
        return torch.empty(shape, dtype=torch.float64, device="meta")
    B, H = 3, 10
    with pytest.raises(TypeError, match="float32"):
        riccati_kernel.solve_qp_riccati_cuda(
            meta(B, 12), meta(B, H, 12), meta(B, H, 12, 12), meta(B, 12, 12),
            meta(B, H, 4), meta(12), meta(12), 0.3, 180.0, 0.01)
    with pytest.raises(TypeError, match="float32"):
        substep_kernel.substep_chain_cuda(
            *([meta(B, 3)] * 21), substeps=8, dt=0.00125)
