"""The `--mpc lci` walk of tests/test_lci.py:92-125 in float32 and float64,
in the JAX package or in the port (CPU).

    python3 tools/lci_walk_f32.py [--jax] [--port] [--f64] [--f32]

Drives the recipe of `test_lci_closed_loop_stand_and_walk` (A1: 20 stand
ticks of `make_stand_policy`, then 60 walk ticks of
`make_walk_policy(velx=0.25)` through the single-robot
`closed_loop_tick_lci`) and prints the test's readings, z after the stand,
the walk's x progress, the final z, roll and pitch, and whether each of
the test's assertions holds (0.27 < z_stand < 0.33, dx > 0.05, z > 0.2,
|roll|, |pitch| < 0.2). The JAX test runs in float64; the card runs the
port in float32, so this says what the JAX package's own float32 gives on
the same recipe. --jax needs JAX (CPU); --port runs the port on CPU
tensors. With neither flag both run; with neither dtype flag both dtypes.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAND, WALK, VELX = 20, 60, 0.25


def verdict(name, z_stand, dx, z, rp, seconds):
    checks = {"0.27 < z_stand < 0.33": 0.27 < z_stand < 0.33,
              "dx > 0.05": dx > 0.05, "z > 0.2": z > 0.2,
              "|roll|, |pitch| < 0.2": abs(rp[0]) < 0.2 and abs(rp[1]) < 0.2}
    print(f"{name}: z_stand {z_stand:.6f} m, dx {dx:.6f} m, z {z:.6f} m, "
          f"roll {rp[0]:.6f}, pitch {rp[1]:.6f} rad ({seconds:.1f} s); "
          + ", ".join(f"{k}: {'holds' if v else 'FAILS'}"
                      for k, v in checks.items()), flush=True)
    return all(checks.values())


def run_jax(f64):
    import jax

    jax.config.update("jax_platforms", "cpu")
    if f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from legged_mpc_control_tpu.config import a1_params
    from legged_mpc_control_tpu.control import step as step_mod
    from legged_mpc_control_tpu.mpc import lci_mpc
    from legged_mpc_control_tpu.sim import srb_sim

    dt = jnp.float64 if f64 else jnp.float32
    p = a1_params(dt)
    stand = lci_mpc.make_stand_policy(p, body_height=0.3)
    walk = lci_mpc.make_walk_policy(p, velx=VELX, body_height=0.3)
    loop = step_mod.LoopState(
        controller=step_mod.controller_init(p, dtype=dt),
        sim=srb_sim.sim_init(p, height=0.3, dtype=dt))
    lci = lci_mpc.lci_init(dtype=dt)
    t0 = time.perf_counter()
    t = 0.0
    for _ in range(STAND):
        loop, lci = step_mod.closed_loop_tick_lci(
            loop, lci, p, stand, walk, jnp.asarray(t, dt))
        t += 0.01
    z_stand = float(loop.sim.pos[2])
    cs = loop.controller
    loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=jnp.ones((), jnp.int32))))
    x0 = float(loop.sim.pos[0])
    for _ in range(WALK):
        loop, lci = step_mod.closed_loop_tick_lci(
            loop, lci, p, stand, walk, jnp.asarray(t, dt))
        t += 0.01
    eul = np.asarray(loop.controller.fbk.root_euler)
    return verdict(f"JAX {'float64' if f64 else 'float32'}", z_stand,
                   float(loop.sim.pos[0]) - x0, float(loop.sim.pos[2]),
                   eul, time.perf_counter() - t0)


def run_port(f64):
    import torch

    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import lci_mpc
    from legged_mpc_control_tpu_torch.sim import srb_sim

    torch.set_num_threads(2)
    dt, cpu = (torch.float64 if f64 else torch.float32), "cpu"
    p = a1_params(dt, cpu)
    stand = lci_mpc.make_stand_policy(p, body_height=0.3)
    walk = lci_mpc.make_walk_policy(p, velx=VELX, body_height=0.3)
    loop = step.LoopState(
        controller=step.controller_init(p, 1, dt, cpu),
        sim=srb_sim.sim_init(p, torch.full((1,), 0.3, dtype=dt), dt, cpu))
    lci = lci_mpc.lci_init(dt, device=cpu)
    t0 = time.perf_counter()
    t = 0.0
    for _ in range(STAND):
        loop, lci = step.closed_loop_tick_lci(loop, lci, p, stand, walk, t)
        t += 0.01
    z_stand = float(loop.sim.pos[0, 2])
    cs = loop.controller
    loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=torch.ones((1,), dtype=torch.int32))))
    x0 = float(loop.sim.pos[0, 0])
    for _ in range(WALK):
        loop, lci = step.closed_loop_tick_lci(loop, lci, p, stand, walk, t)
        t += 0.01
    eul = loop.controller.fbk.root_euler[0].numpy()
    return verdict(f"port {'float64' if f64 else 'float32'} (CPU)", z_stand,
                   float(loop.sim.pos[0, 0]) - x0, float(loop.sim.pos[0, 2]),
                   eul, time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--f32", action="store_true")
    a = ap.parse_args()
    which = [w for w, on in (("jax", a.jax), ("port", a.port)) if on] or [
        "jax", "port"]
    dtypes = [d for d, on in ((False, a.f32), (True, a.f64)) if on] or [
        False, True]
    ok = True
    for w in which:
        for f64 in dtypes:
            ok &= (run_jax if w == "jax" else run_port)(f64)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
