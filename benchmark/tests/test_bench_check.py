"""The correctness check, at a size a CPU test run holds: its control (the
plain reference in float32 with TF32 matrix products, in the program's
place) comes out not correct under the committed limits; so does the
timed path broken underneath in each way a cell can break (a tick that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced); a sound run comes out correct. (The control at the
cells' own sizes is run on the card by `benchmark/control.py`.)"""

import pytest
import torch

from benchmark import compare, harness
from benchmark.tests.hostclock import HostClock

SMALL = {"go1_convex.sweep_b65536": {"batch": 8, "check_scenarios": 8,
                                     "stand_ticks": 2, "walk_in_ticks": 2},
         "a1_ci.b4096": {"batch": 8, "check_scenarios": 8,
                         "walk_in_ticks": 3}}
SEED = 2 ** 31 + 977


def _run(workload, control=False):
    spec = harness.cell_spec(workload)
    spec["traffic"] = dict(spec["traffic"], **SMALL[workload])
    result, _, checks, _ = harness.measure(
        spec, SEED, 0.0, False, torch.device("cpu"), HostClock(), 0.0,
        control=control)
    return result, checks


def _half(tick):
    """The tick with the second half of the batch left out: those
    scenarios come back as they went in."""
    def broken(state, *args, **kwargs):
        out = tick(state, *args, **kwargs)
        ins = compare.leaves(state)

        def keep_half(new):
            vals = {}
            for k, v in compare.leaves(new).items():
                old = ins.get(k)
                if old is not None and v.dim() and v.shape == old.shape:
                    v = v.clone()
                    v[v.shape[0] // 2:] = old[v.shape[0] // 2:]
                vals[k] = v
            return compare.fill(new, vals)
        if isinstance(out, tuple):
            return (keep_half(out[0]),) + tuple(out[1:])
        return keep_half(out)
    return broken


def _faults(monkeypatch, workload, fault):
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.ops import ci_kernel, riccati_kernel

    name = ("closed_loop_tick_batched" if workload.startswith("go1")
            else "closed_loop_tick_lci_batched")
    tick = getattr(step, name)
    if fault == "unchanged":
        if workload.startswith("go1"):
            monkeypatch.setattr(step, name,
                                lambda loop, *a, **kw: (loop, kw["warm"]))
        else:
            monkeypatch.setattr(step, name, lambda loop, lci, *a, **kw:
                                (loop, lci))
    elif fault == "half_batch":
        monkeypatch.setattr(step, name, _half(tick))
    elif workload.startswith("go1"):
        k1 = riccati_kernel.solve_qp_riccati_cuda

        def altered(*a, **kw):
            u, gap, lam = k1(*a, **kw)
            return u * 1.02, gap, lam
        monkeypatch.setattr(riccati_kernel, "solve_qp_riccati_cuda", altered)
    else:
        k7 = ci_kernel.ci_sweeps_cuda

        def altered(*a, **kw):
            Uh, Z, cost = k7(*a, **kw)
            return Uh * 1.02, Z, cost
        monkeypatch.setattr(ci_kernel, "ci_sweeps_cuda", altered)


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_sound_run_is_correct(workload):
    result, checks = _run(workload)
    assert result["correct"], checks


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_the_control_is_not_correct(workload):
    result, checks = _run(workload, control=True)
    assert not result["correct"], checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", sorted(SMALL))
def test_a_broken_tick_is_not_correct(monkeypatch, workload, fault):
    _faults(monkeypatch, workload, fault)
    result, checks = _run(workload)
    assert not result["correct"], checks
