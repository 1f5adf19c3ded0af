"""The port's CLI and its host edge against the JAX package, float64 on the
CPU: `python -m legged_mpc_control_tpu_torch` (main.py), the simulation
interface, the diagnostics bag and the live gain channel.

  * The CLI as a subprocess: the standing smoke run of
    tests/test_interfaces.py:227-234 (exit 0, upright, height > 0.25 m)
    and the hardware interlock (exit 1); in process: no card without
    `--cpu`, and `--f64` without `--cpu`, are refused (exit 2, the message
    names `--cpu`) before anything is built, by the CLI and by the sweep;
    `--bag` and `--profile` write a bag and a trace.
  * `SimInterface` against JAX's: the convex seam over 5 ticks (2 standing,
    3 trotting at 0.25 m/s) within tests/test_torch_single.py's 1e-6; the
    "lci" and "ci" seams over 2 walking ticks within
    tests/test_torch_lci_single.py's 1e-8; `fbk_update` and `send_cmd`.
  * `diag_from_loop` of the port equals JAX's on the same carried loop,
    bit for bit; a port bag loads through JAX's `load_bag`, and a JAX bag
    through the port's.
  * `GainTuner.apply` of the same update gives JAX's params, with the same
    rejections (tests/test_tuning.py:50-64).

Every JAX function is compiled once (XLA:CPU's compile count,
pytest.ini)."""

import functools
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.interfaces.sim_iface import (
    SimInterface as JSimInterface,
)
from legged_mpc_control_tpu.utils import bag as jbag
from legged_mpc_control_tpu.utils import tuning as jtuning
from legged_mpc_control_tpu_torch import main as tmain
from legged_mpc_control_tpu_torch import sweep as tsweep
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.interfaces.sim_iface import (
    SimInterface as TSimInterface,
)
from legged_mpc_control_tpu_torch.types import loop_state_from_numpy
from legged_mpc_control_tpu_torch.utils import bag as tbag
from legged_mpc_control_tpu_torch.utils import tuning as ttuning
from torch_parity import close, close_tree, np_tree, params_mapping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = jnp.float64
CPU = torch.device("cpu")
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
# seam -> (standing ticks, walking ticks, walk velx, tolerance)
SEAMS = {"convex": (2, 3, 0.25, 1e-6), "lci": (0, 2, 0.25, 1e-8),
         "ci": (0, 2, 0.1, 1e-8)}


def _cli(*args, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "legged_mpc_control_tpu_torch", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_cli_sim_standing_smoke():
    out = _cli("--robot", "a1", "--kf", "0", "--seconds", "0.3", "--cpu")
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["ticks"] == 30
    assert summary["upright"] and summary["final_height_m"] > 0.25


def test_cli_rejects_hardware_without_estimation():
    out = _cli("--backend", "hardware", "--kf", "0", "--yes", "--cpu",
               timeout=60)
    assert out.returncode == 1
    assert "sim-only" in out.stderr


@pytest.mark.parametrize("entry", [tmain.main, tsweep.main])
@pytest.mark.parametrize("argv", [["--f64"], []])
def test_refused_before_anything_is_built(entry, argv, monkeypatch, capsys):
    """`--f64` without `--cpu` (the card's kernels are float32), and no
    card without `--cpu`: exit 2 naming `--cpu`, with nothing built."""
    import legged_mpc_control_tpu_torch.config as config

    def built(*a, **k):
        raise AssertionError("state built before the refusal")
    monkeypatch.setattr(config, "a1_params", built)
    monkeypatch.setattr(config, "go1_params", built)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        entry(argv)
    assert exc.value.code == 2
    assert "--cpu" in capsys.readouterr().err


def test_cli_bag_and_profile(tmp_path):
    bag_path, prof = str(tmp_path / "run.npz"), str(tmp_path / "prof")
    code = tmain.main(["--cpu", "--seconds", "0.03", "--bag", bag_path,
                       "--profile", prof])
    assert code == 0
    data, meta = jbag.load_bag(bag_path)
    assert data["root_pos"].shape == (3, 3)
    assert data["tick_wall_ms"].shape == (3,)
    assert meta["args"]["cpu"] and meta["dt"] == 0.01
    with open(os.path.join(prof, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    assert sum(ev.get("name") == "lmpc.tick" for ev in events) == 3


def _walk(iface, velx, xp):
    """Walk mode and the forward command, on either package's interface."""
    cs = iface.loop.controller
    iface.loop = iface.loop.replace(controller=cs.replace(
        ctrl=cs.ctrl.replace(movement_mode=xp.ones_like(
            cs.ctrl.movement_mode)),
        joy=cs.joy.replace(velx=xp.full_like(cs.joy.velx, velx))))


def _record(loop):
    return [np.array(loop.sim.pos), np.array(loop.sim.vel),
            np.array(loop.controller.ctrl.optimized_input)]


@functools.lru_cache(maxsize=None)
def _jax_run(seam):
    """JAX's SimInterface over the seam's recipe: the initial loop and the
    record after every tick."""
    n_stand, n_walk, velx, _ = SEAMS[seam]
    jif = JSimInterface(JP, dtype=F64, mpc_type=seam, walk_velx=velx)
    init, rec = np_tree(jif.loop), []
    for k in range(n_stand + n_walk):
        if k == n_stand:
            _walk(jif, velx, jnp)
        rec.append(_record(jif.tick()))
    return init, rec, np_tree(jif.loop), jif.t


@pytest.mark.parametrize("seam", sorted(SEAMS))
def test_sim_interface_matches_jax(seam):
    init, rec, _, t_end = _jax_run(seam)
    n_stand, n_walk, velx, tol = SEAMS[seam]
    tif = TSimInterface(TP, dtype=torch.float64, mpc_type=seam,
                        walk_velx=velx, device=CPU)
    close_tree(tif.loop, loop_state_from_numpy(
        jax.tree.map(lambda x: x[None], init)), 0.0, "init")
    for k in range(n_stand + n_walk):
        if k == n_stand:
            _walk(tif, velx, torch)
        got = _record(tif.tick())
        for name, g, w in zip(("pos", "vel", "optimized_input"), got,
                              rec[k]):
            close(g[0], w, tol, what=f"{seam} tick {k} {name}")
    assert isinstance(tif.t, float) and tif.t == t_end
    assert bool((tif.loop.controller.ctrl.movement_mode == 1).all())


def test_sim_interface_edges_match_jax():
    """fbk_update's dict drops the batch axis; send_cmd's PD step on one
    robot's (12,) commands moves the world as JAX's does."""
    jif = JSimInterface(JP, dtype=F64)
    tif = TSimInterface(TP, dtype=torch.float64, device=CPU)
    jraw, traw = jif.fbk_update(), tif.fbk_update()
    shared = set(jraw) & set(traw)
    assert {"quat", "pos", "vel", "joint_pos", "joint_vel"} <= shared
    for k in shared:
        assert traw[k].shape == jraw[k].shape, k
        close(traw[k], jraw[k], 1e-12, what=k)
    rng = np.random.default_rng(0)
    q = jraw["joint_pos"] + 0.05 * rng.standard_normal(12)
    cmd = (q, np.zeros(12), rng.standard_normal(12),
           np.full(12, 40.0), np.full(12, 1.0))
    for _ in range(3):
        assert jif.send_cmd(*cmd) and tif.send_cmd(*cmd)
    close_tree(tif.loop.sim, jax.tree.map(lambda x: x[None], jif.loop.sim),
               1e-10, "sim")


def test_diag_from_loop_and_bags_match_jax(tmp_path):
    _, _, final, _ = _jax_run("convex")
    jloop = jax.tree.map(jnp.asarray, final)
    want = jax.device_get(jbag.diag_from_loop(jloop))
    got = tbag.diag_from_loop(loop_state_from_numpy(
        jax.tree.map(lambda x: x[None], final)))
    assert got.keys() == want.keys()
    for k, v in want.items():
        g = got[k].numpy()
        assert g.shape == v.shape and g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)
    series = {k: torch.stack([v, v + 1]) for k, v in got.items()}
    path = str(tmp_path / "port.npz")
    tbag.save_bag(path, series, meta={"dt": 0.01, "robot": "a1"})
    loaded, meta = jbag.load_bag(path)
    assert meta == {"dt": 0.01, "robot": "a1"}
    for k, v in series.items():
        np.testing.assert_array_equal(loaded[k], v.numpy(), err_msg=k)
    jpath = str(tmp_path / "jax.npz")
    jbag.save_bag(jpath, loaded, meta=meta)
    back, bmeta = tbag.load_bag(jpath)
    assert bmeta == meta and back.keys() == loaded.keys()
    df = tbag.bag_to_dataframe(back, dt=meta["dt"])
    assert "root_pos_2" in df.columns and len(df) == 2


def _wait(pred, timeout=3.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("msg", [
    {"kp_foot": [250.0, 250.0, 300.0], "kd_foot": [2.5, 2.5, 3.0],
     "mass": 13.0},
    {"not_a_field": 1.0, "kp_foot": [1.0, 2.0], "mu": 0.5}])
def test_gain_tuner_matches_jax(msg):
    """The same datagram through both tuners: the same params (dtype,
    device and shape kept) and the same counts of applied and rejected
    fields."""
    tuner = ttuning.GainTuner(bind=("127.0.0.1", 0)).start()
    jtuner = jtuning.GainTuner(bind=("127.0.0.1", 0))
    try:
        ttuning.send_gains(msg, addr=tuner.addr)
        assert _wait(lambda: tuner._pending is not None)
        jtuner._pending = dict(msg)
        got, want = tuner.apply(TP), jtuner.apply(JP)
        for name in TP.__dataclass_fields__:
            g, w = getattr(got, name), getattr(want, name)
            assert g.dtype == getattr(TP, name).dtype, name
            assert g.shape == getattr(TP, name).shape, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        assert (tuner.updates_applied, tuner.updates_rejected) == (
            jtuner.updates_applied, jtuner.updates_rejected)
        assert tuner.apply(got) is got           # the mailbox is empty
    finally:
        tuner.close()
        jtuner.close()
