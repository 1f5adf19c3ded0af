"""Where a tick of the batched Go1 trot loop goes, on the card.

    python3 tools/k1_tick_profile.py [--kf-type 0|1] [--solver pdip|admm]

Walks chip_smoke.py's batch (B=4096) in as its timed main path does (30
ticks, the last 10 trotting at 0.15 m/s; H=10, Riccati with iters=4 warm),
then runs 10 more ticks under torch.profiler with a span around each layer
of the tick (MPC prepare, the K1 solve's wrapper, MPC finish, the substep
chain's wrapper, the feedback unpack). With --solver, the 10 ticks solve
with the condensed PDIP (8 warm iterations) or ADMM (30) instead, as
chip_smoke.py's timed condensed loops do, and the spans are MPC prepare,
the condensed build, the solver, inside it the K4 and K5 wrappers, MPC
finish, the substep chain and the feedback unpack. Prints the tick's
host-clock time, each span's host time a tick, the device time a tick of
each kernel (K1, K2 or K3; with --solver K4, K5 and K2 by name too; the
rest summed), and the device's idle share of the window. Needs a CUDA
device.
"""

import argparse
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import B, SOLVER_ITERS  # noqa: E402
from legged_mpc_control_tpu_torch.config import go1_params  # noqa: E402
from legged_mpc_control_tpu_torch.control import step  # noqa: E402
from legged_mpc_control_tpu_torch.mpc import (  # noqa: E402
    admm,
    convex_mpc,
    gait,
    pdip,
    riccati,
)
from legged_mpc_control_tpu_torch.ops import chol_kernel  # noqa: E402
from legged_mpc_control_tpu_torch.parallel import runner  # noqa: E402

# (module, attribute, span name): the layers of a tick, each called through
# its module's attribute
LAYERS = ((convex_mpc, "mpc_prepare", "MPC prepare"),
          (riccati, "solve_qp_riccati", "K1 solve (wrapper)"),
          (convex_mpc, "mpc_finish", "MPC finish"),
          (step, "_substep_chain", "substep chain (wrapper)"),
          (step, "unpack_fused_feedback", "feedback unpack"))
# the condensed solvers' layers (--solver)
SOLVER_LAYERS = {"pdip": (pdip, "solve_qp_pdip_batched", "PDIP solve"),
                 "admm": (admm, "solve_qp_admm_batched", "ADMM solve")}


def condensed_layers(solver):
    return ((convex_mpc, "mpc_prepare", "MPC prepare"),
            (convex_mpc, "build_condensed_from_stage", "condensed build"),
            SOLVER_LAYERS[solver],
            (chol_kernel, "cholesky_cuda", "  K4 wrapper (in solve)"),
            (chol_kernel, "cho_solve_cuda", "  K5 wrapper (in solve)"),
            (convex_mpc, "mpc_finish", "MPC finish"),
            (step, "_substep_chain", "substep chain (wrapper)"),
            (step, "unpack_fused_feedback", "feedback unpack"))


# device time by kernel name: the condensed path's kernels
CONDENSED_KERNELS = (("K4 chol_factor", "chol_factor"),
                     ("K5 chol_solve", "chol_solve"),
                     ("K2 substep_chain", "substep_chain"))
TICKS = 10


@contextlib.contextmanager
def spans(layers):
    """Each of `layers` ((module, attribute, span name)) wrapped in a
    torch.profiler.record_function span."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in layers]

    def wrap(fn, label):
        def inner(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return inner

    for (mod, name, fn), (_, _, label) in zip(saved, layers):
        setattr(mod, name, wrap(fn, label))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kf-type", type=int, default=0)
    ap.add_argument("--solver", choices=sorted(SOLVER_LAYERS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_tick_profile.py: no CUDA device available")
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    params = go1_params(f32, dev)
    pattern = gait.trot_pattern(f32, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    loop = runner.init_loop_batch(params, B, gen,
                                  height_range=(0.26, 0.30), dtype=f32,
                                  body_height=0.28, device=dev)

    def make(n, stand, solver="riccati", iters=4):
        return runner.make_batched_rollout(
            pattern, horizon=10, n_ticks=n, pdip_iters=iters,
            walk_velx=0.15, stand_ticks=stand, kf_type=args.kf_type,
            solver=solver)

    walked = make(30, 20)(loop, params)[0]
    if args.solver is None:
        roll = make(TICKS, 0)
        profile(lambda: roll(walked, params), LAYERS, TICKS,
                f"kf_type {args.kf_type}, B={B}, {TICKS} ticks", "tick",
                scenarios=B)
        return
    iters = SOLVER_ITERS[args.solver]
    roll = make(TICKS, 0, args.solver, iters)
    profile(lambda: roll(walked, params), condensed_layers(args.solver),
            TICKS, f"{args.solver} {iters} warm, kf_type {args.kf_type}, "
            f"B={B}, {TICKS} ticks", "tick", scenarios=B,
            groups=CONDENSED_KERNELS)


def profile(run, layers, n, what, unit, scenarios=None, groups=()):
    """Run `run` once to warm up, then once under torch.profiler with
    `layers` in spans; print the host-clock time a `unit` (run does n),
    each span's host time, the device time by kernel (and summed over the
    kernels whose names hold each `groups` pattern: (label, pattern)) and
    the device's idle share."""
    run()                                           # warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with spans(layers), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    unit_ms = wall * 1e3 / n

    host = {label: 0.0 for _, _, label in layers}
    kernels = {}
    busy_us = 0.0
    for e in prof.events():
        if e.name in host:
            # a span shows on the host and, as an annotation, on the device
            if e.device_type == torch.autograd.DeviceType.CPU:
                host[e.name] += e.time_range.elapsed_us()
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            kernels[e.name] = kernels.get(e.name, 0.0) + us
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rate = (f"; {scenarios * 1e3 / unit_ms:.1f} scenario-ticks/s"
            if scenarios else "")
    print(f"{what} ({card}): {unit_ms:.3f} ms a {unit} (host clock, "
          f"profiler on){rate}")
    print(f"host time a {unit}, by span:")
    for label, us in host.items():
        print(f"   {label:26s} {us / 1e3 / n:8.3f} ms")
    print(f"device time a {unit}: {busy_us / 1e3 / n:.3f} ms; device idle "
          f"share {1.0 - busy_us / (wall * 1e6):.3f}")
    for label, pattern in groups:
        us = sum(t for name, t in kernels.items() if pattern in name)
        print(f"   {label:26s} {us / 1e3 / n:8.3f} ms a {unit}")
    top = sorted(kernels.items(), key=lambda kv: -kv[1])
    for name, us in top[:6]:
        print(f"   {us / 1e3 / n:8.3f} ms  {name[:90]}")
    rest = sum(us for _, us in top[6:])
    print(f"   {rest / 1e3 / n:8.3f} ms  the other {len(top) - 6} "
          "device operations")


if __name__ == "__main__":
    main()
