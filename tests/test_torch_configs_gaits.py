"""The port's config files, named gaits and joystick against the JAX
package, f64 on the CPU.

- `config.load_yaml_params`: every leaf of every file in `configs/` equals
  the JAX loader's (which reads them with PyYAML); the cases of
  `tests/test_configs.py`; what the flat parser refuses.
- The gait registry: every table of the 17 names equals JAX's exactly; over
  two gait cycles at B=4, `gait_leg_update` and `predict_contact_state`
  give JAX's contact sequence exactly for every name (one compiled JAX
  scan, the pattern an argument); the cases of `tests/test_gait_info.py`
  and `tests/test_configs.py`.
- `control/joy.py`: a seeded sequence of 40 gamepad samples at B=4 against
  `jax.vmap(joy_update)`, leaf for leaf (the float leaves to one ulp):
  rising-edge toggles, held buttons, both height clamps, the latched exit,
  walking only once the estimation is initialized."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu import config as jconfig
from legged_mpc_control_tpu.control import joy as jjoy
from legged_mpc_control_tpu.control import step as jstep
from legged_mpc_control_tpu.mpc import gait as jgait
from legged_mpc_control_tpu_torch import config as tconfig
from legged_mpc_control_tpu_torch.control import joy as tjoy
from legged_mpc_control_tpu_torch.mpc import gait as tgait
from legged_mpc_control_tpu_torch.tree import from_numpy
from legged_mpc_control_tpu_torch.types import ControllerState
from test_gait_info import GAIT_INFO
from torch_parity import close, close_tree, np_tree, t

F64 = jnp.float64
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def _load(path):
    return tconfig.load_yaml_params(path, torch.float64, CPU)


# --- config files ---------------------------------------------------------

@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_config_file_matches_jax(path):
    close_tree(_load(path), jconfig.load_yaml_params(path, F64), 0.0)


def test_all_variant_files_load():
    assert len(FILES) == 8
    for f in FILES:
        p = _load(f)
        assert float(p.mass) > 5.0
        assert p.q_weights.shape == (12,)


def test_hardware_variant_overrides_gains():
    p = _load(os.path.join(REPO, "configs", "hardware_a1_convex.yaml"))
    base = tconfig.a1_params(torch.float64, CPU)
    assert float(p.kp_foot[0]) == 20.0 != float(base.kp_foot[0])
    assert float(p.gait_counter_speed) == 2.5


@pytest.mark.parametrize("text", [
    "robot_type: 1\nleg:\n  kp: 3\n",          # nested
    "robot_type: [0, 1]\n",                    # a list
    "robot_tpye: 1\n",                         # an unknown key
    "gait_counter_speed: 2.5\ngait_counter_speed: 3\n",
    "gait_counter_speed: fast\n",
    "gait_counter_speed:\n",
])
def test_flat_parser_refuses(tmp_path, text):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError):
        _load(str(path))


def test_flat_parser_comments_and_defaults(tmp_path):
    path = tmp_path / "go1.yaml"
    path.write_text("# a comment\n\nrobot_type: 1   # Go1\n"
                    "q_weights_5: 4000\nkd_foot_z: 2\n")
    p = _load(str(path))
    base = tconfig.go1_params(torch.float64, CPU)
    assert float(p.q_weights[5]) == 4000.0 and float(p.kd_foot[2]) == 2.0
    assert torch.equal(p.q_weights[:5], base.q_weights[:5])
    assert torch.equal(p.default_foot_pos, base.default_foot_pos)


# --- gait registry --------------------------------------------------------

NAMES = sorted(jgait.NAMED_PATTERNS)


def test_registry_names_match():
    assert sorted(tgait.NAMED_PATTERNS) == NAMES
    assert len(NAMES) == 17
    with pytest.raises(ValueError):
        tgait.named_pattern("moonwalk", torch.float64, CPU)


@pytest.mark.parametrize("name", NAMES)
def test_pattern_table_matches_jax(name):
    got = tgait.named_pattern(name, torch.float64, CPU)
    want = jgait.named_pattern(name, F64)
    for field in ("seg_state", "switch_time", "n_seg"):
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.dtype == w.dtype and np.array_equal(g, w), (name, field)
    assert got.seg_state.shape == (4, tgait.MAX_SEG)


B, TICKS, DT = 4, 80, 0.01
_rng = np.random.default_rng(7)
# four gait speeds (cycles/s): 80 ticks cover at least two cycles
SPEED = np.array([2.5, 3.0, 3.5, 4.0])
FOOT_CUR = _rng.normal(scale=0.1, size=(TICKS, B, 4, 3))
FOOT_TGT = _rng.normal(scale=0.1, size=(TICKS, B, 4, 3))
FORCE = _rng.uniform(size=(TICKS, B, 4)) < 0.3
AHEAD = (0.0, 0.03, 0.11)


@jax.jit
def _jax_fsm(pattern):
    legs = jnp.arange(4, dtype=jnp.int32)
    init = jax.vmap(jax.vmap(jgait.gait_leg_init, in_axes=(None, 0, None)),
                    in_axes=(None, None, None), axis_size=B)(
        pattern, legs, F64)
    per_leg = (0, None, 0, None, None, 0, 0, 0)
    update = jax.vmap(jax.vmap(jgait.gait_leg_update, in_axes=per_leg),
                      in_axes=(0, None, None, None, 0, 0, 0, 0))
    predict = jax.vmap(jax.vmap(jgait.predict_contact_state,
                                in_axes=(0, None, 0, None, None)),
                       in_axes=(0, None, None, None, 0))

    def tick(s, x):
        cur, tgt, force = x
        s = update(s, pattern, legs, DT, jnp.asarray(SPEED), cur, tgt, force)
        contact = jax.vmap(jax.vmap(jgait.get_contact_state))(s)
        ahead = jnp.stack([predict(s, pattern, legs, a, jnp.asarray(SPEED))
                           for a in AHEAD])
        return s, (contact, ahead, s.phase, s.target_pos)

    return jax.lax.scan(tick, init, (FOOT_CUR, FOOT_TGT, FORCE))


@pytest.mark.parametrize("name", NAMES)
def test_gait_fsm_matches_jax(name):
    _, (contact, ahead, phase, target) = np_tree(
        _jax_fsm(jgait.named_pattern(name, F64)))
    pattern = tgait.named_pattern(name, torch.float64, CPU)
    s = tgait.gait_leg_init(pattern, B, torch.float64)
    speed = t(SPEED)
    for k in range(TICKS):
        s = tgait.gait_leg_update(s, pattern, DT, speed, t(FOOT_CUR[k]),
                                  t(FOOT_TGT[k]), t(FORCE[k]))
        assert np.array_equal(tgait.get_contact_state(s).numpy(),
                              contact[k]), (name, k)
        for j, a in enumerate(AHEAD):
            got = tgait.predict_contact_state(s, pattern, a, speed)
            assert np.array_equal(got.numpy(), ahead[k, j]), (name, k, a)
        close(s.phase, phase[k], 1e-12, what=f"{name} phase {k}")
        close(s.target_pos, target[k], 1e-12, what=f"{name} target {k}")


def _contact_at(pattern, leg, phase):
    s = tgait.gait_leg_init(pattern, 1, torch.float64)
    s = s.replace(phase=torch.full((1, 4), phase, dtype=torch.float64))
    c = tgait.predict_contact_state(s, pattern, 0.0,
                                    torch.ones(1, dtype=torch.float64))
    return float(c[0, leg])


@pytest.mark.parametrize("name,phase,stance", [
    ("pace", 0.25, (1, 0, 1, 0)),           # left legs FL, RL in stance
    ("bound", 0.25, (1, 1, 0, 0)),          # the front pair in stance
    ("flying_trot", 0.5, (0, 0, 0, 0)),     # all four airborne
])
def test_pair_structure(name, phase, stance):
    pattern = tgait.named_pattern(name, torch.float64, CPU)
    assert tuple(_contact_at(pattern, leg, phase)
                 for leg in range(4)) == stance


def _stance_from_table(pat, leg, phase):
    sw, seg = pat.switch_time[leg].numpy(), pat.seg_state[leg].numpy()
    n = int(pat.n_seg[leg])
    return seg[min(int(np.sum(phase > sw[:n])), n - 1)] == tgait.STANCE


def test_gait_info_mode_sequences():
    """Inside every mode interval of every gait.info sequence, the table's
    stance set is the mode's."""
    for name, (modes, times) in GAIT_INFO.items():
        pat = tgait.named_pattern(name, torch.float64, CPU)
        for m in range(len(modes)):
            for frac in (0.25, 0.5, 0.75):
                phase = (times[m] + frac * (times[m + 1] - times[m])) \
                    / times[-1]
                for leg in range(4):
                    want = leg in tgait._MODE_STANCE[modes[m]]
                    assert _stance_from_table(pat, leg, phase) == want, (
                        name, modes[m], leg, phase)


def test_walks_are_not_crawl():
    crawl = tgait.crawl_pattern(torch.float64, CPU)
    for name in ("dynamic_walk", "static_walk"):
        pat = tgait.named_pattern(name, torch.float64, CPU)
        assert not (torch.equal(pat.seg_state, crawl.seg_state)
                    and torch.allclose(pat.switch_time, crawl.switch_time))


# --- joystick -------------------------------------------------------------

N_JOY, JOY_DT = 40, 0.1
SIM_A1 = os.path.join(REPO, "configs", "sim_a1_convex.yaml")


def _joy_inputs():
    """Sticks in [-1, 1] with the height stick held up (scenario 0: the
    0.30 m clamp) or down (scenario 1: the 0.10 m clamp), and buttons held
    over runs of samples, so that presses are held and released; scenario
    2 presses exit once, scenario 3 never has its estimation initialized."""
    rng = np.random.default_rng(11)
    axes = rng.uniform(-1.0, 1.0, size=(N_JOY, B, 6))
    axes[:, 0, 1] = 1.0
    axes[:, 1, 1] = -1.0
    runs = rng.integers(1, 5, size=(N_JOY, B, 6))
    buttons = np.zeros((N_JOY, B, 6))
    for b in range(B):
        for j in range(6):
            k, on = 0, rng.uniform() < 0.5
            while k < N_JOY:
                n = runs[k, b, j]
                buttons[k:k + n, b, j] = float(on)
                k, on = k + n, not on
    buttons[:, :, tjoy.BUTTON_EXIT] = 0.0
    buttons[17, 2, tjoy.BUTTON_EXIT] = 1.0
    return axes, buttons


def test_joy_update_matches_jax():
    axes, buttons = _joy_inputs()
    jp = jconfig.load_yaml_params(SIM_A1, F64)
    cs = jstep.controller_init(jp, dtype=F64, body_height=0.25)
    cs = jax.tree.map(lambda x: jnp.stack([x] * B), cs)
    cs = cs.replace(estimation_inited=jnp.array([True, True, True, False]))

    @jax.jit
    def run(cs):
        step = jax.vmap(jjoy.joy_update, in_axes=(0, 0, 0, None, None))

        def body(cs, x):
            cs = step(cs, x[0], x[1], JOY_DT, jp)
            return cs, (cs.joy, cs.ctrl.movement_mode)
        return jax.lax.scan(body, cs, (axes, buttons))[1]

    joys, modes = np_tree(run(cs))
    tcs = from_numpy(ControllerState, np_tree(cs))
    tp = _load(SIM_A1)
    for k in range(N_JOY):
        tcs = tjoy.joy_update(tcs, t(axes[k]), t(buttons[k]), JOY_DT, tp)
        # the integer and boolean leaves exactly, the floats to 1e-15 (XLA
        # contracts the height update into an FMA: one ulp)
        close_tree(tcs.joy, jax.tree.map(lambda x: x[k], joys), 1e-15,
                   what=f"joy {k}")
        assert np.array_equal(tcs.ctrl.movement_mode.numpy(), modes[k])
    # what the sequence exercised
    assert np.allclose(joys.body_height[-1, :2], [0.30, 0.10])
    assert joys.exit_flag[-1].tolist() == [False, False, True, False]
    toggled = np.abs(np.diff(joys.ctrl_state, axis=0)).sum(0)
    assert (toggled >= 2).all()
    assert (modes[:, 3] == 0).all() and (modes[:, :3] == 1).any()
