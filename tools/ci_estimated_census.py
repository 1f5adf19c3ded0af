"""How the batched contact-implicit (CI) closed loop behaves on estimated
state and with the WBC, in the port and in the JAX package.

    python3 tools/ci_estimated_census.py [--package port|jax]
        [--device cpu|cuda] [--f64] [--batch 32] [--seed 0]
        [--variants kf1,kf2,wbc,unfused] [--stand 20] [--ticks 40]
        [--threads 2]

Runs chip_smoke.py's CI recipe on estimated state (A1, flat ground, the
batched CI walk policy at velx 0.1 with 24 warm sweeps, the policy clock
at 0.01 s a tick) through `control/step.closed_loop_tick_lci_batched`:
`--stand` ticks in movement mode 0 (the stand policy, while a filter
settles), then `--ticks` walking ticks in mode 1, once for each variant:

    kf1      kf_type 1 (the linear KF, the per-substep loop)
    kf2      kf_type 2 (the EKF, the per-substep loop)
    wbc      low_level_type 1 (the WBC, the per-substep loop)
    unfused  kf_type 0 with fused_substeps=False, beside the fused run
             (the substep chain) from the same start

and prints one JSON line a variant: the share of scenarios finite and
upright (0.15 m < z < 0.5 m), the mean progress in x over those from the start,
the filter's mean z error and mean xy drift over those (kf1, kf2;
bench.py:221-222's limits are 2.5 cm and 4 cm), and for `unfused` the
mean position deviation from the fused run and the shift of the mean
height (bench.py:128-132's limits are 2e-3 m and 1e-3 m).

--package port (default) runs the port on --device; --package jax runs the
JAX package on the CPU (its PRNG batch, `init_loop_batch` from
PRNGKey(seed)), whose fused run is its TPU substep kernel in Pallas
interpret mode (off the TPU its tick takes the per-substep loop for both
flags). `--stand 0` walks from the first tick, as bench.py's CI cell does
on ground truth.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

VELX, ITERS = 0.1, 24
UPRIGHT = (0.15, 0.5)        # m, the trunk height of an upright robot
VARIANTS = {"kf1": dict(kf_type=1), "kf2": dict(kf_type=2),
            "wbc": dict(low_level_type=1),
            "unfused": dict(fused_substeps=False)}


def summary(name, pos0, pos, est, fused_pos=None, seconds=None):
    """The JSON line of one variant from numpy (B,3) start and final
    positions, the filter's (B,>=3) estimate or None, and the fused run's
    final positions or None."""
    finite = np.isfinite(pos).all(-1)
    if est is not None:
        finite &= np.isfinite(est).all(-1)
    z = np.where(finite, pos[:, 2], 0.0)
    ok = finite & (z > UPRIGHT[0]) & (z < UPRIGHT[1])
    out = {"variant": name, "batch": len(pos), "finite": int(finite.sum()),
           "z0_mean_m": float(pos0[:, 2].mean()),
           "z_mean_m": float(pos[finite, 2].mean()) if finite.any() else None,
           "upright": int(ok.sum()),
           "upright_share": float(ok.mean()),
           "progress_m": float((pos[ok, 0] - pos0[ok, 0]).mean())
           if ok.any() else None,
           "z_min_upright": float(pos[ok, 2].min()) if ok.any() else None}
    if est is not None and ok.any():
        err = np.abs(est[ok, 0:3] - pos[ok])
        out["est_z_err_mean_m"] = float(err[:, 2].mean())
        out["est_xy_drift_mean_m"] = float(err[:, 0:2].mean())
    if fused_pos is not None:
        both = ok & np.isfinite(fused_pos).all(-1)
        fz = np.where(np.isfinite(fused_pos).all(-1), fused_pos[:, 2], 0.0)
        out["fused_upright"] = int(((fz > UPRIGHT[0])
                                    & (fz < UPRIGHT[1])).sum())
        out["dev_mean_m"] = float(np.abs(pos[both] - fused_pos[both]).mean())
        out["dz_mean_m"] = abs(float(pos[both, 2].mean()
                                     - fused_pos[both, 2].mean()))
    if seconds is not None:
        out["seconds"] = round(seconds, 1)
    return out


def port(args, dtype):
    import torch

    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc
    from legged_mpc_control_tpu_torch.parallel import runner

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    p = a1_params(dtype, dev)
    walk = ci_mpc.make_ci_walk_policy_batched(p, velx=VELX, iters=ITERS)
    stand = lci_mpc.make_stand_policy(p, body_height=0.3)

    def start():
        loop = runner.init_loop_batch(
            p, args.batch, torch.Generator(device=dev).manual_seed(args.seed),
            dtype=dtype, device=dev)
        return loop, lci_mpc.lci_init_batched(
            args.batch, dtype, walk.warm_init(args.batch, dtype, dev),
            device=dev)

    def roll(**kw):
        loop, lci = start()
        for k in range(args.stand + args.ticks):
            cs = loop.controller
            loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
                movement_mode=torch.full_like(cs.ctrl.movement_mode,
                                              int(k >= args.stand)))))
            loop, lci = step.closed_loop_tick_lci_batched(
                loop, lci, p, stand, walk, 0.01 * k, **kw)
        return loop

    def n(x):
        return x.detach().cpu().double().numpy()

    for name in args.variants:
        kw = VARIANTS[name]
        t0 = time.perf_counter()
        pos0 = n(start()[0].sim.pos)
        final = roll(**kw)
        fused = n(roll().sim.pos) if name == "unfused" else None
        cs = final.controller
        est = {1: cs.kf.x, 2: cs.ekf.x}.get(kw.get("kf_type"))
        line = summary(name, pos0, n(final.sim.pos),
                       None if est is None else n(est), fused,
                       time.perf_counter() - t0)
        line.update(package="port", device=args.device, dtype=str(dtype),
                    stand=args.stand, walk=args.ticks)
        print(json.dumps(line), flush=True)


def jax_package(args, f64):
    import functools

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from legged_mpc_control_tpu.config import a1_params
    from legged_mpc_control_tpu.control import step
    from legged_mpc_control_tpu.mpc import ci_mpc, lci_mpc
    from legged_mpc_control_tpu.ops import substep_pallas
    from legged_mpc_control_tpu.parallel import runner
    from legged_mpc_control_tpu.sim import terrain

    dt = jnp.float64 if f64 else jnp.float32
    p = a1_params(dt)
    walk = ci_mpc.make_ci_walk_policy_batched(
        p, terrain=terrain.flat(dtype=dt), velx=VELX, iters=ITERS)
    stand = lci_mpc.make_stand_policy(p, body_height=0.3)

    def start():
        loop = runner.init_loop_batch(p, args.batch,
                                      jax.random.PRNGKey(args.seed),
                                      dtype=dt)
        return loop, lci_mpc.lci_init_batched(
            args.batch, dtype=dt, policy_warm=walk.warm_init(args.batch, dt))

    def roll(**kw):
        tick = jax.jit(lambda lp, lc, tt: step.closed_loop_tick_lci_batched(
            lp, lc, p, stand, walk, tt, **kw))
        loop, lci = start()
        for k in range(args.stand + args.ticks):
            cs = loop.controller
            loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
                movement_mode=jnp.full((args.batch,), int(k >= args.stand),
                                       jnp.int32))))
            loop, lci = tick(loop, lci, jnp.asarray(0.01 * k, dt))
        return loop

    def fused_roll():
        """The JAX tick's fused branch, as it runs on the TPU: its substep
        kernel in Pallas interpret mode."""
        saved = step.default_backend, substep_pallas.substep_chain_fused
        step.default_backend = lambda: "pallas"
        substep_pallas.substep_chain_fused = functools.partial(
            saved[1], interpret=True)
        try:
            return roll()
        finally:
            step.default_backend, substep_pallas.substep_chain_fused = saved

    def n(x):
        return np.asarray(x, dtype=np.float64)

    for name in args.variants:
        kw = VARIANTS[name]
        t0 = time.perf_counter()
        pos0 = n(start()[0].sim.pos)
        final = roll(**kw)
        fused = n(fused_roll().sim.pos) if name == "unfused" else None
        cs = final.controller
        est = {1: cs.kf.x, 2: cs.ekf.x}.get(kw.get("kf_type"))
        line = summary(name, pos0, n(final.sim.pos),
                       None if est is None else n(est), fused,
                       time.perf_counter() - t0)
        line.update(package="jax", device="cpu",
                    dtype="float64" if f64 else "float32", stand=args.stand,
                    walk=args.ticks)
        print(json.dumps(line), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default="kf1,kf2,wbc,unfused")
    ap.add_argument("--stand", type=int, default=20)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    args.variants = args.variants.split(",")
    if args.package == "jax":
        jax_package(args, args.f64)
        return
    import torch

    port(args, torch.float64 if args.f64 else torch.float32)


if __name__ == "__main__":
    main()
