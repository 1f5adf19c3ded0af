"""The correctness check of the benchmark cell `go1_admm_h30.b4096`
(`benchmark/drivers/convex_admm.py`) at a size a CPU test run holds (B=8):
a sound run comes out correct under the committed limits; its control (the
plain reference in float32 with TF32 matrix products, in the program's
place) does not, nor does the timed path broken underneath: a tick that
returns its state unchanged, half of the batch left out, a third of the
ADMM iterations left out, and the ADMM matrix factored without its
constraint term rho G~^T G~ (the factor of P~ + sigma I alone).

Two smaller faults move the solution by less than float32 rounding does,
so no check that passes the float32 program can see them: one iteration
fewer (at rho 1e-3 thirty iterations have converged to within ~0.1 N)
and sigma I (1e-6) left out of the factored matrix; PERF.md §6 gives the
readings."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_bench_check import _half

WORKLOAD = "go1_admm_h30.b4096"
SMALL = {"batch": 8, "check_scenarios": 8, "stand_ticks": 2,
         "walk_in_ticks": 2}
SEED = 2 ** 31 + 977


def _run(control=False):
    """(correct, the numbers compared) of a run as `harness.measure` makes
    it: set-up, a window of one tick, the check. (This test process has
    JAX loaded by the suite's conftest, which `measure` would refuse.)"""
    spec = harness.cell_spec(WORKLOAD)
    driver = harness.load_driver(spec["root"], spec["config"]["driver"])
    cell = driver.Cell(spec["config"], dict(spec["traffic"], **SMALL), SEED,
                       torch.device("cpu"), control=control)
    cell.setup()
    cell.tick()
    checks = cell.check()
    return harness.judge(checks), checks


def test_a_sound_run_is_correct():
    correct, checks = _run()
    assert correct, checks


def test_the_control_is_not_correct():
    correct, checks = _run(control=True)
    assert not correct, checks


def _faults(monkeypatch, fault):
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import admm

    if fault == "unchanged":
        monkeypatch.setattr(step, "closed_loop_tick_batched",
                            lambda loop, *a, **kw: (loop, kw["warm"]))
    elif fault == "half_batch":
        monkeypatch.setattr(step, "closed_loop_tick_batched",
                            _half(step.closed_loop_tick_batched))
    elif fault == "a_third_of_the_iterations_fewer":
        solve = admm.solve_qp_admm_batched

        def fewer(*a, **kw):
            return solve(*a, **dict(kw, iters=kw["iters"] * 2 // 3))
        monkeypatch.setattr(admm, "solve_qp_admm_batched", fewer)
    else:
        add = admm._block_diag_add
        monkeypatch.setattr(admm, "_block_diag_add",
                            lambda M, blocks, diag: add(M, 0.0 * blocks,
                                                        diag))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "a_third_of_the_iterations_fewer",
                                   "factor_without_constraints"])
def test_a_broken_tick_is_not_correct(monkeypatch, fault):
    _faults(monkeypatch, fault)
    correct, checks = _run()
    assert not correct, checks
