"""Multi-process scenario sweep CLI (BASELINE config 5: the
65,536-scenario sweep), the port of `legged_mpc_control_tpu/sweep.py`.

One process, on the card:

    python -m legged_mpc_control_tpu_torch.sweep --scenarios 65536 \\
        --ticks 25 --reps 2 --checkpoint /tmp/sweep

Several processes (one per device, or several on one card) under torchrun
or its variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK; the
collectives ride Gloo):

    torchrun --nproc-per-node 2 -m legged_mpc_control_tpu_torch.sweep \\
        --scenarios 65536 --ticks 25

Prints one JSON line of the sweep's metrics (the same on every rank) from
rank 0, plus an optional weak-scaling efficiency report
(--report-efficiency). Each process holds one shard of the global batch,
so the batch depends on the process count, as JAX's depends on the device
count. `--cpu` runs on the CPU; without it the run is on the card and
fails when there is none. `--f64` needs `--cpu`: the card's
kernels are float32 and refuse float64 (ROADMAP fault 14).
"""

import argparse
import json
import time


def build_parser():
    ap = argparse.ArgumentParser(
        prog="legged_mpc_control_tpu_torch.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", type=int, default=65536)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--iters", type=int, default=15)
    ap.add_argument("--velx", type=float, default=0.15)
    ap.add_argument("--stand-ticks", type=int, default=20)
    ap.add_argument("--reps", type=int, default=1,
                    help="run the sweep N times and report the LAST "
                         "timing (the first call pays the kernels' loads)")
    ap.add_argument("--robot", default="go1", choices=["a1", "go1"])
    ap.add_argument("--solver", default="riccati",
                    choices=["riccati", "pdip", "admm"])
    ap.add_argument("--f64", action="store_true",
                    help="float64 (with --cpu only: the card's kernels "
                         "are float32)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--report-efficiency", action="store_true")
    ap.add_argument("--per-device-batch", type=int, default=64,
                    help="weak-scaling load per process for the report")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="write a per-process shard checkpoint of the "
                         "final loop state to PATH.pN (resume with "
                         "--resume)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="restore the loop state from a --checkpoint "
                         "(same process/shard layout) and continue")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="also write every rank's unrounded metrics (and "
                         "report) as JSON to PATH.pN.json")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.f64 and not args.cpu:
        ap.error("--f64 needs --cpu: the card's kernels are float32 and "
                 "refuse float64")

    import torch

    if not args.cpu and not torch.cuda.is_available():
        ap.error("no CUDA device available: pass --cpu to run on the CPU")

    from legged_mpc_control_tpu_torch.parallel import distributed as dist

    owned = dist.initialize()
    try:
        return _run(args, dist.global_mesh(
            device="cpu" if args.cpu else "cuda"))
    finally:
        if owned:
            torch.distributed.destroy_process_group()


def _run(args, mesh):
    import torch

    from legged_mpc_control_tpu_torch.config import a1_params, go1_params
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import distributed as dist

    dtype = torch.float64 if args.f64 else torch.float32
    params = (a1_params if args.robot == "a1" else go1_params)(
        dtype, mesh.device)
    pattern = gait.trot_pattern(dtype, mesh.device)

    start_tick = 0
    if args.resume:
        loop, start_tick = dist.load_sharded(args.resume, mesh)
    else:
        loop = dist.device_sharded_loop(params, args.scenarios, 0, mesh,
                                        dtype=dtype)
    sweep = dist.make_sweep(pattern, mesh, horizon=args.horizon,
                            n_ticks=args.ticks, pdip_iters=args.iters,
                            solver=args.solver, walk_velx=args.velx,
                            stand_ticks=args.stand_ticks)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    final = metrics = None
    n_reps = max(1, args.reps)
    sync()
    for rep in range(n_reps):
        # the stand phase is consumed exactly once across resume legs AND
        # reps: leg 1 stands for (stand_ticks - start_tick), every later
        # rep continues walking
        st_now = max(0, args.stand_ticks - start_tick - rep * args.ticks)
        t0 = time.perf_counter()
        final, metrics = sweep(loop if rep == 0 else final, params,
                               stand_ticks_now=st_now)
        sync()
        wall = time.perf_counter() - t0
    if args.checkpoint:
        # step records ALL ticks actually advanced (reps included)
        dist.save_sharded(args.checkpoint, final,
                          step=start_tick + n_reps * args.ticks, mesh=mesh)

    out = {
        "scenarios": args.scenarios,
        "start_tick": start_tick,
        "hosts": mesh.world_size,
        "devices": mesh.n_shards,
        "ticks": args.ticks,
        "wall_s": round(wall, 3),
        "scenario_ticks_per_s": round(
            args.scenarios * args.ticks / wall, 1),
        **{k: round(v, 4) for k, v in metrics.items()},
    }
    if mesh.rank == 0:
        print(json.dumps(out), flush=True)
    record = {"rank": mesh.rank, "wall_s": wall, "metrics": metrics}

    if args.report_efficiency:
        rep = dist.weak_scaling_report(
            pattern, params, per_device_batch=args.per_device_batch,
            horizon=args.horizon, n_ticks=max(2, args.ticks // 2),
            pdip_iters=args.iters, solver=args.solver, dtype=dtype,
            mesh=mesh)
        record["report"] = rep
        if mesh.rank == 0:
            print(json.dumps({k: (round(v, 6) if isinstance(v, float)
                                  else v) for k, v in rep.items()}),
                  flush=True)
    if args.metrics:
        with open(f"{args.metrics}.p{mesh.rank}.json", "w") as fh:
            json.dump(record, fh)
    return out


if __name__ == "__main__":
    main()
