"""Package hygiene of the PyTorch port: it imports no JAX, its entry points
build on the card unless asked for the CPU, its kernel wrappers run the
plain versions on CPU tensors without launching anything, its numpy
converters round-trip exactly, and what is not ported yet raises."""

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
from legged_mpc_control_tpu_torch.mpc import (
    ci_mpc,
    convex_mpc,
    gait,
    lci_mpc,
    riccati,
)
from legged_mpc_control_tpu_torch.ops import (
    chol_kernel,
    ci_kernel,
    cuda_build,
    filters,
    riccati_kernel,
    substep_kernel,
)
from legged_mpc_control_tpu_torch.interfaces.sim_iface import SimInterface
from legged_mpc_control_tpu_torch.models import srb
from legged_mpc_control_tpu_torch.models import whole_body as wb
from legged_mpc_control_tpu_torch.parallel import distributed, runner
from legged_mpc_control_tpu_torch.sim import srb_sim, terrain, wb_sim
from legged_mpc_control_tpu_torch.tree import to_numpy, tree_map
from legged_mpc_control_tpu_torch.types import (
    init_ctrl,
    init_feedback,
    init_joy,
    loop_state_from_numpy,
    loop_state_to_numpy,
)

# a handful of scenarios: the intra-op thread pool costs more than it saves
torch.set_num_threads(1)

CPU = torch.device("cpu")

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
    assert int(out.stdout) >= 25
    for name in ("mpc.ci_mpc", "mpc.lci_mpc", "ops.ci_kernel", "sim.terrain",
                 "estimation.ekf", "models.whole_body", "models.whole_body_b",
                 "sim.wb_sim", "control.hoqp", "control.wbc",
                 "models.ik_dls", "parallel.mesh", "parallel.distributed",
                 "sweep", "utils.checkpoint", "utils.bag", "utils.tuning",
                 "main", "__main__", "native", "interfaces",
                 "interfaces.base", "interfaces.sim_iface",
                 "interfaces.hardware", "interfaces.highlevel",
                 "interfaces.joystick", "interfaces.mocap"):
        assert f"{pkg.__name__}.{name}" in MODULES, name


@pytest.fixture(scope="module")
def small_loop():
    """A B=4 Go1 batch after a few trotting ticks of the port on the CPU,
    with the kernels' launch counts over that rollout."""
    params = go1_params(torch.float32, CPU)
    loop = runner.init_loop_batch(params, 4, torch.Generator().manual_seed(2),
                                  dtype=torch.float32, body_height=0.28,
                                  device=CPU)
    roll = runner.make_batched_rollout(
        gait.trot_pattern(torch.float32, CPU), n_ticks=4, pdip_iters=6,
        walk_velx=0.2, stand_ticks=1)
    cuda_build.LAUNCHES.clear()
    loop, _ = roll(loop, params)
    return (loop, step.broadcast_params(params, 4),
            dict(cuda_build.LAUNCHES))


def test_riccati_wrapper_on_cpu_is_the_plain_version(small_loop):
    loop, params, _ = small_loop
    pattern = gait.trot_pattern(torch.float32, CPU)
    _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern, 0.01,
                                      horizon=10)
    args = (stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, 0.01)
    got = riccati_kernel.solve_qp_riccati_cuda(*args, iters=8)
    want = riccati.solve_qp_riccati_batched(*args, iters=8)
    assert sum(cuda_build.LAUNCHES.values()) == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_rollout_launches_no_kernel(small_loop):
    loop, _, launches = small_loop
    assert sum(launches.values()) == 0
    assert bool(torch.isfinite(loop.sim.pos).all())


@pytest.mark.parametrize("make", [a1_params, go1_params])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_params_round_trip(make, dtype):
    p = make(dtype, CPU)
    mapping = {k: getattr(p, k).numpy() for k in p.__dataclass_fields__}
    q = params_from_numpy(mapping)
    for k in p.__dataclass_fields__:
        assert torch.equal(getattr(q, k), getattr(p, k)), k


def test_loop_state_round_trip(small_loop):
    loop, _, _ = small_loop
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


def test_terrain_weights_and_lci_state_round_trip():
    """The converters of the contact-implicit slice: terrain, CI weights
    and LciState (with its warm slot) through numpy and back, exactly."""
    cpu = "cpu"
    t = terrain.add_box(terrain.flat(1.0, 0.1, torch.float64, cpu),
                        (0.2, 0.0), (0.4, 1.0), 0.03)
    back = terrain.terrain_from_numpy(to_numpy(t))
    w = ci_mpc.default_weights(torch.float32, cpu)
    wback = ci_mpc.weights_from_numpy(to_numpy(w))
    pairs = [(getattr(t, f), getattr(back, f)) for f in vars(t)]
    pairs += [(getattr(w, f), getattr(wback, f)) for f in vars(w)]
    walk = ci_mpc.make_ci_walk_policy_batched(go1_params(device=CPU))
    s = lci_mpc.lci_init_batched(3, torch.float64,
                                 walk.warm_init(3, torch.float64, cpu),
                                 device=cpu)
    s = s.replace(policy_time=torch.tensor([0.1, 0.2, 0.3],
                                           dtype=torch.float64))
    sback = lci_mpc.lci_state_from_numpy(lci_mpc.lci_state_to_numpy(s))
    pairs += [(getattr(s, f), getattr(sback, f)) for f in
              ("prev_foot_pos", "prev_foot_vel", "policy_time", "prev_mode")]
    pairs += [(s.policy_warm[k], sback.policy_warm[k]) for k in ("u",
                                                                "valid")]
    for a, b in pairs:
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert lci_mpc.lci_state_from_numpy(lci_mpc.lci_state_to_numpy(
        s.replace(policy_warm=None))).policy_warm is None


def _wb_loop():
    p = a1_params(torch.float32, CPU)
    return runner.init_wb_loop_batch(p, wb.a1_wb_model(device=CPU), 2,
                                     torch.Generator(), device=CPU), p


def test_kf_type_2_raises(small_loop):
    """The substep chain (K2, K3) has no EKF: it refuses kf_type 2, which
    takes the per-substep loop. kf_type 3 does not exist: every entry point
    refuses it."""
    loop, params, _ = small_loop
    pattern = gait.trot_pattern(torch.float32, CPU)
    wb_loop, p = _wb_loop()
    model = wb.a1_wb_model(device=CPU)
    calls = [
        lambda: step.closed_loop_tick_batched(loop, params, pattern,
                                              kf_type=3),
        lambda: runner.make_batched_rollout(pattern, kf_type=3),
        lambda: step.feedback_update(loop.controller, {}, params, 0.00125,
                                     kf_type=3),
        lambda: step.closed_loop_tick_wb(wb_loop, p, pattern, model,
                                         kf_type=3),
        lambda: step.closed_loop_tick_wb_batched(
            wb_loop, step.broadcast_params(p, 2), pattern, model,
            kf_type=3),
        lambda: runner.make_batched_rollout_wb(pattern, model, kf_type=3),
        lambda: step.closed_loop_tick_lci_batched(loop, None, params, None,
                                                  None, 0.0, kf_type=3),
        lambda: substep_kernel.substep_chain_cuda(
            *([None] * 21), substeps=8, dt=0.00125, kf_type=2)]
    for call in calls:
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError, match="kf_type 0 and 1"):
        step.unpack_fused_feedback(loop.controller, loop.sim, {}, params,
                                   kf_type=2)
    with pytest.raises(ValueError):
        substep_kernel.substep_chain_cuda(*([None] * 21), substeps=8,
                                          dt=0.00125, kf_type=1)


def test_randomize_params_draws_from_the_generator():
    p = go1_params(torch.float64, CPU)
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


def test_low_level_type_1_raises(small_loop):
    """low_level_type 2 does not exist (0 is J^T tau control, 1 the WBC):
    every entry point refuses it, and so do the ticks of the LCI seam. The
    contact-implicit MPC's fused kernel K7 serves no wall: the CI solve
    refuses backend "fused" with one (ROADMAP fault 6)."""
    loop, params, _ = small_loop
    pattern = gait.trot_pattern(torch.float32, CPU)
    wb_loop, p = _wb_loop()
    model = wb.a1_wb_model(device=CPU)
    calls = [
        lambda: step.closed_loop_tick_batched(loop, params, pattern,
                                              low_level_type=2),
        lambda: step.lowlevel_update(loop.controller, params,
                                     low_level_type=2),
        lambda: runner.make_batched_rollout(pattern, low_level_type=2),
        lambda: step.closed_loop_tick_wb(wb_loop, p, pattern, model,
                                         low_level_type=2),
        lambda: step.closed_loop_tick_wb_batched(
            wb_loop, step.broadcast_params(p, 2), pattern, model,
            low_level_type=2),
        lambda: runner.make_batched_rollout_wb(pattern, model,
                                               low_level_type=2)]
    for call in calls:
        with pytest.raises(NotImplementedError):
            call()
    lci_calls = [
        lambda: step.closed_loop_tick_lci(loop, None, params, None, None,
                                          0.0, low_level_type=2),
        lambda: step.closed_loop_tick_lci_wb(wb_loop, None, p, model, None,
                                             None, 0.0, low_level_type=2),
        lambda: step.closed_loop_tick_lci_batched(loop, None, params, None,
                                                  None, 0.0,
                                                  low_level_type=2)]
    for call in lci_calls:
        with pytest.raises(NotImplementedError):
            call()
    wall = terrain.wall_at_x(0.4, device=CPU)
    z0 = torch.zeros((1, ci_mpc.NZ))
    U0 = torch.zeros((1, 10, ci_mpc.NU))
    with pytest.raises(ValueError, match="serves no wall"):
        ci_mpc.ci_solve_batched(z0, U0, torch.zeros((1, 11, ci_mpc.NZ)), U0,
                                None, 12.0, torch.eye(3)[None], 0.6,
                                wall=wall, backend="fused")


def test_unknown_solver_raises(small_loop):
    loop, params, _ = small_loop
    pattern = gait.trot_pattern(torch.float32, CPU)
    with pytest.raises(ValueError, match="unknown solver"):
        convex_mpc.mpc_tick_batched(loop.controller, params, pattern, 0.01,
                                    horizon=10, solver="osqp")
    with pytest.raises(ValueError, match="unknown solver"):
        runner.make_batched_rollout(pattern, solver="osqp")


# every entry point that builds state from nothing, called without a device
ENTRY_POINTS = {
    "a1_params": lambda: a1_params(),
    "go1_params": lambda: go1_params(),
    "trot_pattern": lambda: gait.trot_pattern(),
    "init_loop_batch": lambda: runner.init_loop_batch(
        go1_params(device=CPU), 2, torch.Generator()),
    "controller_init": lambda: step.controller_init(go1_params(device=CPU),
                                                    2),
    "sim_init": lambda: srb_sim.sim_init(go1_params(device=CPU),
                                         [0.28, 0.3]),
    "admm_warm_init": lambda: step.admm_warm_init(2, 10),
    "init_feedback": lambda: init_feedback(2),
    "init_ctrl": lambda: init_ctrl(2),
    "init_joy": lambda: init_joy(2),
    "moving_window_init": lambda: filters.moving_window_init(3, 2),
    "savgol_init": lambda: filters.savgol_init(9, 2),
    "gravity_affine": lambda: srb.gravity_affine(0.01),
    "terrain.flat": lambda: terrain.flat(),
    "terrain.stairs": lambda: terrain.stairs(),
    "terrain.wall_at_x": lambda: terrain.wall_at_x(0.4),
    "lci_init_batched": lambda: lci_mpc.lci_init_batched(2),
    "ci_default_weights": lambda: ci_mpc.default_weights(),
    "ci_walk_policy_batched.warm_init": lambda:
        ci_mpc.make_ci_walk_policy_batched(
            go1_params(device=CPU)).warm_init(2),
    "ci_walk_policy.warm_init": lambda: ci_mpc.make_ci_walk_policy(
        go1_params(device=CPU)).warm_init(),
    "lci_init": lambda: lci_mpc.lci_init(),
    "ci_lean_policy.warm_init": lambda: ci_mpc.make_ci_lean_policy(
        go1_params(device=CPU), terrain.wall_at_x(0.35, device=CPU),
        torch.zeros(4, 3), torch.zeros(3), torch.zeros(3)).warm_init(),
    "a1_wb_model": lambda: wb.a1_wb_model(),
    "go1_wb_model": lambda: wb.go1_wb_model(),
    "wb_sim_init": lambda: wb_sim.wb_sim_init(
        wb.a1_wb_model(device=CPU), a1_params(device=CPU), [0.28]),
    "init_wb_loop_batch": lambda: runner.init_wb_loop_batch(
        a1_params(device=CPU), wb.a1_wb_model(device=CPU), 2,
        torch.Generator()),
    "device_sharded_loop": lambda: distributed.device_sharded_loop(
        a1_params(device=CPU), 2),
    "SimInterface": lambda: SimInterface(a1_params(device=CPU)).loop,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without a device argument an entry point builds on the card; with no
    card it raises and says how to ask for the CPU."""
    if torch.cuda.is_available():
        out = ENTRY_POINTS[name]()
        leaf = out[0] if isinstance(out, tuple) else out
        while not torch.is_tensor(leaf):
            leaf = next(iter((leaf if isinstance(leaf, dict)
                              else vars(leaf)).values()))
        assert leaf.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ENTRY_POINTS[name]()


def test_built_state_follows_the_requested_device():
    """device="cpu" builds every leaf on the CPU, and functions handed
    tensors follow them (the gait FSM state follows its pattern)."""
    loop = runner.init_loop_batch(go1_params(device=CPU), 3,
                                  torch.Generator(), device=CPU)
    devices = set()
    tree_map(lambda x: devices.add(x.device), loop)
    assert devices == {CPU}
    assert gait.gait_leg_init(gait.trot_pattern(device=CPU),
                              3).phase.device == CPU


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
    with pytest.raises(TypeError, match="float32"):
        chol_kernel.cholesky_cuda(meta(B, 12, 12))
    with pytest.raises(TypeError, match="float32"):
        chol_kernel.cho_solve_cuda(meta(B, 12, 12), meta(B, 12))
    with pytest.raises(TypeError, match="float32"):
        chol_kernel.cho_solve_multi_cuda(meta(B, 24, 24), meta(B, 24, 25))
    with pytest.raises(TypeError, match="float32"):
        ci_kernel.ci_sweeps_cuda(
            meta(B, 24), meta(B, H, 24), meta(B, H, 48), meta(B, 24),
            meta(B, H, 4), meta(B), meta(52), meta(), meta(),
            meta(B, 3, 3), iters=4, dt=0.02, s_f=50.0, rho_min=0.05,
            reg=1e-2, state_reg=1e-1)
