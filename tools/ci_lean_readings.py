"""The CI wall lean of tests/test_ci_wall_lean.py, tick by tick, in the JAX
package or in the port: the readings its assertions hold.

    python3 tools/ci_lean_readings.py [--jax] [--robot go1|a1]
                                      [--device cpu|cuda] [--ticks 250]

Drives the lean recipe (mu 0.6, the wall at x = 0.35, pitch -0.4, the
front feet 1.5 mm short of the plane, mode 1 with the 2-tap filter warmed,
`make_ci_lean_policy(iters=24)` through `closed_loop_tick_lci_wb(wall=)`)
in float32 and prints every 25th tick's z, pitch, roll and the front
feet's wall-normal forces, then the test's readings over the run: z's
range, pitch's range, the largest |roll|, and after tick 20 the least and
the mean wall force of each front foot, with whether each assertion
holds. --jax runs the JAX package (CPU; its test's own `_lean_setup`);
without it the port (`chip_smoke.lean_setup`) on --device.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

SETTLE = 20


def report(name, h, seconds):
    z, pitch, roll, f0, f1 = np.asarray(h, dtype=np.float64).T
    st = np.asarray(h, dtype=np.float64)[SETTLE:]
    checks = {"z > 0.2": bool(np.all(z > 0.2)),
              "-0.55 < pitch < -0.25": bool(np.all(pitch < -0.25)
                                            & np.all(pitch > -0.55)),
              "|roll| < 0.1": bool(np.abs(roll).max() < 0.1),
              "wall forces > 8 N": bool(st[:, 3:5].min() > 8.0),
              "mean wall forces > 15 N": bool(st[:, 3:5].mean(0).min()
                                              > 15.0),
              "0.30 < z < 0.45": bool(z.min() > 0.30 and z.max() < 0.45)}
    print(f"{name}: z in [{z.min():.4f}, {z.max():.4f}], pitch in "
          f"[{pitch.min():.4f}, {pitch.max():.4f}], max |roll| "
          f"{np.abs(roll).max():.4f}; after tick {SETTLE}: wall forces min "
          f"{st[:, 3].min():.2f} / {st[:, 4].min():.2f} N, mean "
          f"{st[:, 3].mean():.2f} / {st[:, 4].mean():.2f} N; "
          f"{seconds / len(h):.3f} s a tick; " + ", ".join(
              f"{k}: {'holds' if v else 'FAILS'}" for k, v in checks.items()),
          flush=True)
    return all(checks.values())


def run_jax(robot, ticks):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from legged_mpc_control_tpu.control import step as step_mod
    from legged_mpc_control_tpu.mpc import ci_mpc, lci_mpc
    from test_ci_wall_lean import DT, PITCH, _lean_setup

    params, model, terr, wall, pos, feet_tgt, feet_w, sim = _lean_setup(
        robot)
    lean = ci_mpc.make_ci_lean_policy(
        params, wall, feet_tgt, pos, jnp.array([0.0, PITCH, 0.0], DT),
        terrain=terr, iters=24)
    stand = lci_mpc.make_stand_policy(params, body_height=0.3)
    cs = step_mod.controller_init(params, dtype=DT)
    cs = cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=jnp.ones((), jnp.int32)))
    loop = step_mod.LoopState(controller=cs, sim=sim)
    lci = lci_mpc.lci_init(dtype=DT, policy_warm=lean.warm_init(DT))
    lci = lci.replace(prev_foot_pos=feet_w - pos[None, :],
                      prev_foot_vel=jnp.zeros((4, 3), DT))
    tick = jax.jit(lambda lp, lc, t: step_mod.closed_loop_tick_lci_wb(
        lp, lc, params, model, stand, lean, t, terrain=terr, wall=wall))
    hist = []
    t0 = time.perf_counter()
    for k in range(ticks):
        loop, lci = tick(loop, lci, jnp.asarray(0.01 * k, DT))
        q, fc = np.asarray(loop.sim.q), np.asarray(loop.sim.f_contact)
        hist.append([q[2], q[4], q[5], -fc[0, 0], -fc[1, 0]])
        if k % 25 == 0:
            print(k, np.round(hist[-1], 4), flush=True)
    return report(f"JAX float32, {robot}", hist, time.perf_counter() - t0)


def run_port(robot, ticks, device):
    import torch

    import chip_smoke
    from legged_mpc_control_tpu_torch.control import step

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    L = chip_smoke.lean_setup(dev, robot)
    loop, lci = L["loop"], L["lci"]
    hist = []
    t0 = time.perf_counter()
    for k in range(ticks):
        loop, lci = step.closed_loop_tick_lci_wb(
            loop, lci, L["params"], L["model"], L["stand"], L["lean"],
            0.01 * k, wall=L["wall"])
        q, fc = loop.sim.q[0], loop.sim.f_contact[0]
        hist.append(torch.stack([q[2], q[4], q[5], -fc[0, 0], -fc[1, 0]]))
        if k % 25 == 0:
            print(k, np.round(hist[-1].cpu().numpy(), 4), flush=True)
    h = torch.stack(hist).cpu().numpy()
    return report(f"port float32 ({device}), {robot}", h,
                  time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--robot", default="go1", choices=("go1", "a1"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--ticks", type=int, default=250)
    a = ap.parse_args()
    ok = (run_jax(a.robot, a.ticks) if a.jax
          else run_port(a.robot, a.ticks, a.device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
