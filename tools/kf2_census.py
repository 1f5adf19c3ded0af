"""How many scenarios of the kf_type-2 (EKF) trot loop fall, in the port and
in the JAX package.

    python3 tools/kf2_census.py [--device cuda|cpu] [--f64] [--batch 256]
                                [--seed 1] [--jax SEED]
    python3 tools/kf2_census.py --trace SEED INDEX [--ticks 112]

Runs chip_smoke.py's kf_type-2 recipe (Go1, trot at 0.15 m/s after 20
standing ticks, H=10, Riccati iters=4 warm, 120 ticks; the per-substep
loop) on a seeded batch of the port (`runner.init_loop_batch` from a
`torch.Generator` on the device) and prints, per scenario class, how many
end finite, upright (0.2 < z < 0.4 m) and moving (x > 0.075 m), and the
EKF's z and xy errors over those. --jax SEED runs the JAX package's
`make_batched_rollout(kf_type=2)` (XLA backend, its own PRNG batch; CPU,
needs JAX) on the same recipe. --trace SEED INDEX takes scenario INDEX of
the port's float64 CPU batch of SEED and steps it through both packages'
`closed_loop_tick_batched` tick by tick (float64, CPU), printing the true
and estimated heights and the largest position gap: whether a scenario
that falls in the port falls in the JAX package too.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

TICKS, STAND, VELX, ITERS = 120, 20, 0.15, 4


def census(name, pos, x_est):
    """Print the classes of (B,3) final positions and EKF estimates."""
    pos, x_est = np.asarray(pos), np.asarray(x_est)
    finite = np.isfinite(pos).all(-1) & np.isfinite(x_est).all(-1)
    z = np.where(finite, pos[:, 2], np.nan)
    ok = finite & (z > 0.2) & (z < 0.4) & (pos[:, 0] > 0.5 * VELX)
    err = np.abs(x_est[:, 0:3] - pos)
    print(f"{name}: {int(ok.sum())} of {len(pos)} finite, upright and "
          f"moving; non-finite {int((~finite).sum())}; fallen (z <= 0.2) "
          f"{int((finite & ~(z > 0.2)).sum())}; over the good ones: EKF z "
          f"error mean {err[ok, 2].mean():.4e} max {err[ok, 2].max():.4e} "
          f"m, xy mean {err[ok, 0:2].mean():.4e} m", flush=True)


def port(device, dtype, batch, seed):
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner

    dev = torch.device(device)
    p = go1_params(dtype, dev)
    loop = runner.init_loop_batch(
        p, batch, torch.Generator(device=dev).manual_seed(seed),
        height_range=(0.26, 0.30), dtype=dtype, body_height=0.28,
        device=dev)
    roll = runner.make_batched_rollout(
        gait.trot_pattern(dtype, dev), horizon=10, n_ticks=TICKS,
        pdip_iters=ITERS, walk_velx=VELX, stand_ticks=STAND, kf_type=2)
    t0 = time.perf_counter()
    final, _ = roll(loop, p)
    census(f"port, {device}, {dtype}, B={batch}, seed {seed}, "
           f"{time.perf_counter() - t0:.0f} s", final.sim.pos.cpu(),
           final.controller.ekf.x.cpu())


def jax_package(dtype_name, batch, seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from legged_mpc_control_tpu.config import go1_params
    from legged_mpc_control_tpu.mpc import gait
    from legged_mpc_control_tpu.parallel import runner

    dt = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    p = go1_params(dt)
    loop = runner.init_loop_batch(p, batch, jax.random.PRNGKey(seed),
                                  dtype=dt, body_height=0.28,
                                  height_range=(0.26, 0.30))
    roll = jax.jit(runner.make_batched_rollout(
        gait.trot_pattern(dt), horizon=10, n_ticks=TICKS, pdip_iters=ITERS,
        walk_velx=VELX, stand_ticks=STAND, kf_type=2, solver="riccati",
        backend="xla"))
    final, _ = roll(loop, p)
    census(f"JAX package, {dtype_name}, B={batch}, PRNGKey({seed})",
           final.sim.pos, final.controller.ekf.x)


def trace(seed, index, ticks):
    """One scenario of the port's float64 CPU batch through both packages'
    batched tick."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from legged_mpc_control_tpu.config import go1_params as jgo1
    from legged_mpc_control_tpu.control import step as jstep
    from legged_mpc_control_tpu.mpc import gait as jgait
    from legged_mpc_control_tpu.parallel import runner as jrunner
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner
    from legged_mpc_control_tpu_torch.tree import tree_map
    from legged_mpc_control_tpu_torch.types import loop_state_to_numpy
    from torch_parity import jax_tree_from

    f64, cpu = torch.float64, torch.device("cpu")
    p = go1_params(f64, cpu)
    loop = runner.init_loop_batch(
        p, 256, torch.Generator(device=cpu).manual_seed(seed),
        height_range=(0.26, 0.30), dtype=f64, body_height=0.28, device=cpu)
    loop = tree_map(lambda a: a[[index]], loop)
    jp = jgo1(jnp.float64)
    jl = jax_tree_from(jrunner.init_loop_batch(
        jp, 1, jax.random.PRNGKey(0), dtype=jnp.float64, body_height=0.28),
        loop_state_to_numpy(loop))
    jpb = jstep.broadcast_params(jp, 1)
    jtick = jax.jit(lambda lp, w: jstep.closed_loop_tick_batched(
        lp, jpb, jgait.trot_pattern(jnp.float64), horizon=10, iters=ITERS,
        kf_type=2, warm=w, backend="xla", fused_substeps=False))
    pb, pat = step.broadcast_params(p, 1), gait.trot_pattern(f64, cpu)
    w, jw = torch.zeros((1, 120), dtype=f64), jnp.zeros((1, 120))
    for k in range(ticks):
        mode = int(k >= STAND)
        cs, jc = loop.controller, jl.controller
        loop = loop.replace(controller=cs.replace(
            ctrl=cs.ctrl.replace(movement_mode=torch.full(
                (1,), mode, dtype=torch.int32)),
            joy=cs.joy.replace(velx=torch.full((1,), VELX, dtype=f64))))
        jl = jl.replace(controller=jc.replace(
            ctrl=jc.ctrl.replace(movement_mode=jnp.full((1,), mode,
                                                         jnp.int32)),
            joy=jc.joy.replace(velx=jnp.full((1,), VELX))))
        loop, w = step.closed_loop_tick_batched(
            loop, pb, pat, horizon=10, iters=ITERS, kf_type=2, warm=w)
        jl, jw = jtick(jl, jw)
        gap = np.abs(loop.sim.pos.numpy() - np.asarray(jl.sim.pos)).max()
        print(f"{k:4d} z port {float(loop.sim.pos[0, 2]):.4f} JAX "
              f"{float(jl.sim.pos[0, 2]):.4f}; estimated z port "
              f"{float(loop.controller.ekf.x[0, 2]):.4f} JAX "
              f"{float(jl.controller.ekf.x[0, 2]):.4f}; max |pos gap| "
              f"{gap:.2e} m", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--jax", type=int, metavar="SEED")
    ap.add_argument("--trace", type=int, nargs=2, metavar=("SEED", "INDEX"))
    ap.add_argument("--ticks", type=int, default=112)
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.trace:
        trace(*args.trace, args.ticks)
        return
    if args.jax is not None:
        jax_package("float64" if args.f64 else "float32", args.batch,
                    args.jax)
        return
    port(args.device, torch.float64 if args.f64 else torch.float32,
         args.batch, args.seed)


if __name__ == "__main__":
    main()
