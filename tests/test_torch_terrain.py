"""PyTorch port vs the JAX package on height-field terrain: the bilinear
height and its gradient (flat, boxed and stairs grids, at random points,
on cell boundaries and out of the grid: 1e-12), the SRB simulator's
`sim_init` and three chained `sim_step`s on a boxed terrain (1e-10), and
the terrain-snapped Raibert footholds (1e-12). f64, numpy inputs from a
seed, every JAX reference from one compiled call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legged_mpc_control_tpu.config import a1_params as ja1
from legged_mpc_control_tpu.control import raibert as jraibert
from legged_mpc_control_tpu.ops import so3 as jso3
from legged_mpc_control_tpu.sim import srb_sim as jsim
from legged_mpc_control_tpu.sim import terrain as jterr
from legged_mpc_control_tpu_torch.config import params_from_numpy
from legged_mpc_control_tpu_torch.control import raibert as traibert
from legged_mpc_control_tpu_torch.ops import so3 as tso3
from legged_mpc_control_tpu_torch.sim import srb_sim as tsim
from legged_mpc_control_tpu_torch.sim import terrain as tterr
from legged_mpc_control_tpu_torch.tree import from_numpy
from torch_parity import close, np_tree, params_mapping, t

F64 = jnp.float64
CPU = torch.device("cpu")
JP = ja1(F64)
TP = params_from_numpy(params_mapping(JP))
_rng = np.random.default_rng(3)


def _grids():
    flat = jterr.flat(extent=1.0, cell=0.1, dtype=F64)
    boxed = jterr.add_box(jterr.flat(extent=1.0, cell=0.05, dtype=F64),
                          center_xy=(0.25, 0.0), size_xy=(0.3, 1.0),
                          height=0.03)
    stairs = jterr.stairs(n_steps=4, step_height=0.02, step_depth=0.2,
                          start_x=-0.2, extent=1.0, cell=0.05, dtype=F64)
    return {"flat": flat, "boxed": boxed, "stairs": stairs}


GRIDS = _grids()
# random points over and beyond the grid (extent 1 m), grid nodes and cell
# edges, and the clamped corners
PTS = np.concatenate([
    _rng.uniform(-1.3, 1.3, size=(64, 2)),
    np.stack(np.meshgrid(np.arange(-1.0, 1.01, 0.1),
                         [-1.0, -0.35, 0.0, 0.95]), -1).reshape(-1, 2),
    np.array([[1.0, 1.0], [-1.0, -1.0], [1.2, -0.4], [0.1, 1.5],
              [0.1, 0.3], [0.25, 0.0], [0.4, 0.5]])])

HEAD = _rng.normal(size=(len(PTS), 2))
HEAD[0] = 0.0                        # the norm's floor
B = 8


def _sim_inputs():
    heights = _rng.uniform(0.26, 0.32, size=B)
    dq = _rng.normal(scale=0.5, size=(B, 12))
    tau = _rng.normal(scale=4.0, size=(3, B, 12))
    tau[..., 2::3] -= 6.0                   # knees push: feet load
    dq_noise = _rng.normal(scale=0.05, size=(B, 12))
    contact = _rng.uniform(size=(B, 4)) < 0.7
    return heights, dq, tau, dq_noise, contact


SIM_IN = _sim_inputs()
ROOT = np.concatenate([_rng.uniform(-0.6, 0.6, size=(B, 2)),
                       _rng.uniform(0.26, 0.32, size=(B, 1))], -1)
VEL = _rng.normal(scale=0.3, size=(B, 3))
YAW = _rng.uniform(-1.0, 1.0, size=B)
VEL_D = np.concatenate([_rng.uniform(-0.4, 0.4, size=(B, 2)),
                        np.zeros((B, 1))], -1)


@pytest.fixture(scope="module")
def jax_out():
    heights, dq, tau, dq_noise, contact = SIM_IN
    boxed = GRIDS["boxed"]

    def ref(grids, pts, heights, dq, tau, dq_noise, contact, root, vel,
            yaw, vel_d):
        out = {}
        for name, g in grids.items():
            out[f"h_{name}"] = jterr.height_at(g, pts)
            out[f"dh_{name}"] = jterr.height_grad_at(g, pts)
            out[f"pitch_{name}"] = jax.vmap(
                lambda p, d: jterr.slope_pitch_at(g, p, d))(pts, HEAD)
        out["wall_gap"] = jterr.wall_gap(jterr.wall_at_x(0.4, dtype=F64),
                                         jnp.concatenate([pts, pts[:, :1]],
                                                         -1))
        s0 = jax.vmap(lambda h: jsim.sim_init(JP, height=h, dtype=F64,
                                              terrain=boxed))(heights)
        s = s0.replace(q=s0.q + dq_noise, dq=dq, contact=contact)
        steps = []
        for k in range(3):
            s = jax.vmap(lambda ss, tt: jsim.sim_step(
                ss, tt, JP, 0.00125, terrain=boxed))(s, tau[k])
            steps.append(s)
        out["init"], out["steps"] = s0, steps
        Rz = jax.vmap(jso3.rot_z)(yaw)
        for name in ("flat", "boxed"):
            out[f"raibert_{name}"] = jax.vmap(
                lambda p, v, r, vd: jraibert.raibert_footholds(
                    p, v, r, vd, JP, terrain=grids[name]))(root, vel, Rz,
                                                           vel_d)
        out["raibert_none"] = jax.vmap(
            lambda p, v, r, vd: jraibert.raibert_footholds(
                p, v, r, vd, JP))(root, vel, Rz, vel_d)
        return out

    return np_tree(jax.jit(ref)(GRIDS, PTS, heights, dq, tau, dq_noise,
                                contact, ROOT, VEL, YAW, VEL_D))


def _grid(name):
    return tterr.terrain_from_numpy(np_tree(GRIDS[name]))


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_height_and_gradient(jax_out, name):
    g = _grid(name)
    close(tterr.height_at(g, t(PTS)), jax_out[f"h_{name}"], 1e-12)
    close(tterr.height_grad_at(g, t(PTS)), jax_out[f"dh_{name}"], 1e-12)
    close(tterr.slope_pitch_at(g, t(PTS), t(HEAD)), jax_out[f"pitch_{name}"],
          1e-12)


def test_wall_gap(jax_out):
    w = tterr.wall_at_x(0.4, dtype=torch.float64, device=CPU)
    p = torch.cat([t(PTS), t(PTS)[:, :1]], -1)
    close(tterr.wall_gap(w, p), jax_out["wall_gap"], 1e-15)


def test_grid_constructors_match():
    """flat / add_box / stairs built by the port equal the JAX grids."""
    flat = tterr.flat(extent=1.0, cell=0.1, dtype=torch.float64, device=CPU)
    boxed = tterr.add_box(tterr.flat(extent=1.0, cell=0.05,
                                     dtype=torch.float64, device=CPU),
                          center_xy=(0.25, 0.0), size_xy=(0.3, 1.0),
                          height=0.03)
    stairs = tterr.stairs(n_steps=4, step_height=0.02, step_depth=0.2,
                          start_x=-0.2, extent=1.0, cell=0.05,
                          dtype=torch.float64, device=CPU)
    for name, got in (("flat", flat), ("boxed", boxed), ("stairs", stairs)):
        want = np_tree(GRIDS[name])
        for f in ("heights", "origin", "cell"):
            close(getattr(got, f), getattr(want, f), 1e-15, what=name + f)
    assert tterr.is_flat_zero(flat) and not tterr.is_flat_zero(boxed)
    rough = tterr.random_rough(torch.Generator().manual_seed(0),
                               amplitude=0.03, extent=1.0, cell=0.1,
                               dtype=torch.float64)
    assert rough.heights.shape == (21, 21)
    assert 0.0 <= float(rough.heights.min()) < float(rough.heights.max()) \
        <= 0.03


def test_sim_init_and_steps_on_boxed_terrain(jax_out):
    heights, dq, tau, dq_noise, contact = SIM_IN
    g = _grid("boxed")
    s0 = tsim.sim_init(TP, t(heights), dtype=torch.float64, device=CPU,
                       terrain=g)
    want0 = jax_out["init"]
    for f in ("pos", "quat", "q", "anchor"):
        close(getattr(s0, f), getattr(want0, f), 1e-10, what=f)
    # the front feet stand on the box
    assert float(s0.anchor[:, 0:2, 2].min()) == pytest.approx(0.03)
    s = s0.replace(q=s0.q + t(dq_noise), dq=t(dq), contact=t(contact))
    for k in range(3):
        s = tsim.sim_step(s, t(tau[k]), TP, 0.00125, terrain=g)
        want = jax_out["steps"][k]
        for f in ("pos", "quat", "vel", "omega", "q", "dq", "anchor",
                  "last_acc"):
            close(getattr(s, f), getattr(want, f), 1e-10, what=f"{f} {k}")
        assert np.array_equal(s.contact.numpy(), want.contact)
    # some contacts were made and some released over the three steps
    assert not np.array_equal(s.contact.numpy(), contact)


def test_sim_state_converts_from_jax(jax_out):
    s = from_numpy(tsim.SimState, jax_out["steps"][-1])
    assert s.pos.dtype == torch.float64 and s.contact.dtype == torch.bool


@pytest.mark.parametrize("name", ["flat", "boxed", "none"])
def test_raibert_on_terrain(jax_out, name):
    g = None if name == "none" else _grid(name)
    Rz = tso3.rot_z(t(YAW))
    got = traibert.raibert_footholds(t(ROOT), t(VEL), Rz, t(VEL_D), TP,
                                     terrain=g)
    want = jax_out[f"raibert_{name}"]
    close(got[0], want[0], 1e-12, what="abs")
    close(got[1], want[1], 1e-12, what="world")
