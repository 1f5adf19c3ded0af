"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds both hand-written CUDA kernels of the port from
legged_mpc_control_tpu_torch/csrc with nvcc (sm_90a), holds each against its
plain PyTorch version at the main path's shapes, then drives the main path
(the batched Go1 trot closed loop, `parallel/runner.make_batched_rollout`)
through its quality gates and times it at B=4096. Exits non-zero on any
failure and when no CUDA device is present. Diagnostics go to the earlier
lines; the second-to-last line is a JSON object of the kernels, the last
line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# float32 matrix products in full precision on the card (the default; the
# plain versions are references)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DT = 0.01
B = 4096
REPO_K1 = "legged_mpc_control_tpu/ops/riccati_pallas.py:438"
REPO_K2 = "legged_mpc_control_tpu/ops/substep_pallas.py:777"


class GateError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise GateError(msg)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def qp_problem(batch, horizon, dev):
    """The synthetic Go1 trot QP batch of __graft_entry__._make_problem_batch
    and _lin_batch_fn, rebuilt in numpy/torch: standing height 0.3 +- 0.02,
    forward speed in [-0.3, 0.5], FL/RR stance then FR/RL stance."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import reference
    from legged_mpc_control_tpu_torch.ops import so3

    f32 = torch.float32
    params = go1_params(f32, dev)
    rng = np.random.default_rng(0)
    x0 = np.zeros((batch, 12))
    x0[:, 5] = 0.3 + rng.uniform(-0.02, 0.02, batch)
    x0[:, 9] = rng.uniform(-0.3, 0.5, batch)
    contact = np.zeros((batch, horizon, 4))
    contact[:, :, [0, 3]] = 1.0
    contact[:, horizon // 2:, [0, 3]] = 0.0
    contact[:, horizon // 2:, [1, 2]] = 1.0
    x0 = torch.tensor(x0, dtype=f32, device=dev)
    contact = torch.tensor(contact, dtype=f32, device=dev)

    def lin(x0):
        euler = x0[:, 0:3]
        R = so3.quat_to_rotmat(so3.euler_to_quat(euler))
        z = torch.zeros_like(euler)
        pos_d, vel_d, euler_d = z.clone(), z.clone(), z.clone()
        pos_d[:, 2] = 0.3
        vel_d[:, 0] = 0.3
        euler_d[:, 2] = euler[:, 2]
        cmd = reference.MpcCmd(pos_d, euler_d, vel_d, z)
        x_ref, yaw_ref, _ = reference.build_reference(
            euler, x0[:, 3:6], R, cmd, horizon, DT)
        feet = (R[:, None] @ params.default_foot_pos[..., None])[..., 0]
        n = x0.shape[0]
        A_seq, Bm = reference.build_linearization(
            yaw_ref, params.mass.expand(n), params.trunk_inertia.expand(
                n, 3, 3), R, feet, DT)
        return x_ref, A_seq, Bm

    return params, x0, contact, lin


def phase_build():
    from legged_mpc_control_tpu_torch.ops import cuda_build

    t0 = phase("build: nvcc sm_90a, both kernels")
    for name in ("riccati_ipm", "substep_chain"):
        so = cuda_build.build(name)
        log = so.with_suffix(".log").read_text().splitlines()
        keep = [ln.strip() for ln in log
                if "registers" in ln or "spill" in ln or "stack frame" in ln]
        print(f"   {so.name}: " + " | ".join(keep), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    done(t0)
    return smi


# K1 tolerance. Both float32 solvers (kernel and plain) stop where the
# interior point freezes at gap < 1e-6, and with r = 1e-4 on the forces the
# Newton systems are conditioned so that float32 fixes the GRFs only to
# ~0.1 N there (0.3 N at H=30 warm): the float64 solution of the same
# iterations is the exact reference. The 2e-2 N bracket of
# tests/test_riccati_fused.py (6 scenarios) holds for all but a few of 4096
# (PERF.md). So the gate is: 99 % of the scenarios agree with the plain
# float32 version within 2e-2 N, and the kernel is no farther from the
# float64 answer than the plain float32 version is (x1.5 + 2e-2 N).
K1_BRACKET = 2e-2


def phase_k1(dev, card):
    """Kernel K1 vs its plain version (float32, and float64 as the exact
    reference) at the solve metric's shapes."""
    from legged_mpc_control_tpu_torch.mpc import riccati
    from legged_mpc_control_tpu_torch.ops import riccati_kernel

    stats = {}
    for horizon in (10, 30):
        t0 = phase(f"K1 riccati_ipm vs plain, B={B}, H={horizon}, iters=15")
        params, x0, contact, lin = qp_problem(B, horizon, dev)
        x_ref, A_seq, Bm = lin(x0)
        args = (x0, x_ref, A_seq, Bm, contact, params.q_weights,
                params.r_weights, params.mu, params.fz_max)
        args64 = tuple(a.double() for a in args)
        mass = float(params.mass)
        warm_u = riccati.warm_shift(
            riccati.solve_qp_riccati_batched(*args, DT, iters=15)[0],
            contact)
        err = 0.0
        for start, wu in (("cold", None), ("warm", warm_u)):
            uk, gk, _ = riccati_kernel.solve_qp_riccati_cuda(
                *args, DT, iters=15, warm_u=wu)
            up, gp, _ = riccati.solve_qp_riccati_batched(
                *args, DT, iters=15, warm_u=wu)
            u64 = riccati.solve_qp_riccati_batched(
                *args64, DT, iters=15,
                warm_u=None if wu is None else wu.double())[0]
            check(bool(torch.isfinite(uk).all()), f"K1 {start}: non-finite")
            d = (uk - up).abs().amax(-1)
            e = float(d.max())
            e64 = float((uk.double() - u64).abs().max())
            p64 = float((up.double() - u64).abs().max())
            err = max(err, e)
            gap = float(gk.max())
            fz = float(uk[:, 2:12:3].sum(-1).mean())
            print(f"   {start}: max|u_kernel - u_plain| = {e:.3e} N "
                  f"({int((d > K1_BRACKET).sum())} of {B} scenarios over "
                  f"{K1_BRACKET}); "
                  f"vs float64: kernel {e64:.3e} N, plain {p64:.3e} N; "
                  f"max gap {gap:.3e}; mean stance load {fz:.2f} N",
                  flush=True)
            q99 = float(torch.quantile(d.double(), 0.99))
            check(q99 <= K1_BRACKET,
                  f"K1 {start} H={horizon}: p99 GRF difference {q99}")
            check(e64 <= 1.5 * p64 + K1_BRACKET,
                  f"K1 {start} H={horizon}: {e64} N from float64, plain "
                  f"{p64} N")
            check(gap < 1e-4, f"K1 {start} H={horizon}: gap {gap}")
            check(float(gp.max()) < 1e-4, f"plain {start}: gap")
            check(0.3 * 9.8 * mass < fz < 2.0 * 9.8 * mass,
                  f"K1 {start}: implausible stance load {fz}")
        ms = cuda_ms(lambda: riccati_kernel.solve_qp_riccati_cuda(
            *args, DT, iters=15), reps=5)
        plain_ms = cuda_ms(lambda: riccati.solve_qp_riccati_batched(
            *args, DT, iters=15), reps=2)
        print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              "ms per cold solve", flush=True)
        stats[horizon] = dict(err=err, ms=ms, plain_ms=plain_ms)
        done(t0)
    return stats


FB_TOL = {"euler": 1e-4, "rotmat": 1e-4, "foot_pos_rel": 2e-3,
          "foot_pos_abs": 2e-3, "foot_vel_rel": 6e-2, "foot_vel_abs": 6e-2,
          "foot_vel_world": 6e-2, "jac": 2e-3, "foot_force_sensor": 0.5,
          "contact_sig": 0.05, "contact_bool": 0.0, "force_tau_est": 0.5,
          "raibert_abs": 2e-3, "imu_acc": 5e-2, "imu_gyro": 5e-3}
STATE_TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 5e-3,
             "q": 2e-3, "dq": 5e-2, "anchor": 2e-4, "q_tgt": 2e-3,
             "dq_tgt": 5e-2, "tau_ff": 1e-2}


def phase_k2(dev, card):
    """Kernel K2 vs its plain version, all 8 substeps, from mid-trot."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.control import sensors, step
    from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait
    from legged_mpc_control_tpu_torch.ops import substep_kernel
    from legged_mpc_control_tpu_torch.parallel import runner

    t0 = phase(f"K2 substep_chain vs plain, B={B}, 8 substeps, mid-trot")
    f32 = torch.float32
    params = go1_params(f32, dev)
    pattern = gait.trot_pattern(f32, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    loop = runner.init_loop_batch(params, B, gen, height_range=(0.26, 0.30),
                                  dtype=f32, body_height=0.28, device=dev)
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15,
        stand_ticks=20)(loop, params)
    pb = step.broadcast_params(params, B)
    cs, _ = convex_mpc.mpc_tick_batched(loop.controller, pb, pattern, DT,
                                        horizon=10, iters=4)
    sim = loop.sim
    args = (sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq,
            sim.contact, sim.anchor, cs.ctrl.optimized_state,
            cs.ctrl.optimized_input, cs.ctrl.movement_mode, pb.mass, pb.mu,
            pb.kp_foot, pb.kd_foot, pb.trunk_inertia, pb.rho_fix,
            pb.default_foot_pos, pb.gait_counter_speed,
            sensors.contact_threshold(pb), cs.ctrl.root_lin_vel_d_rel)
    kw = dict(substeps=8, dt=DT / 8)
    got = substep_kernel.substep_chain_cuda(*args, **kw)
    want = substep_kernel.substep_chain_plain(*args, **kw)
    torch.cuda.synchronize()
    stance = float(sim.contact.float().mean())
    print(f"   start: stance share {stance:.3f}", flush=True)
    check(0.05 < stance < 0.95, "K2 start state is not mid-trot")
    err = 0.0
    flips = int((got["contact"] != want["contact"]).any(-1).sum())
    print(f"   scenarios whose contacts differ: {flips}", flush=True)
    check(flips == 0, f"K2: contacts differ in {flips} scenarios")
    for name, tol in STATE_TOL.items():
        e = float((got[name] - want[name]).abs().max())
        check(bool(torch.isfinite(got[name]).all()), f"K2 {name} non-finite")
        print(f"   {name}: max err {e:.3e} (tol {tol})", flush=True)
        check(e <= tol, f"K2 {name}: {e} > {tol}")
        err = max(err, e)
    for name, (off, n) in substep_kernel.FB_ROWS.items():
        e = float((got["fb"][:, off:off + n]
                   - want["fb"][:, off:off + n]).abs().max())
        check(e <= FB_TOL[name], f"K2 fb {name}: {e} > {FB_TOL[name]}")
    ms = cuda_ms(lambda: substep_kernel.substep_chain_cuda(*args, **kw),
                 reps=20)
    plain_ms = cuda_ms(lambda: substep_kernel.substep_chain_plain(*args, **kw),
                       reps=3)
    print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          "per 8-substep chain", flush=True)
    done(t0)
    return dict(err=err, ms=ms, plain_ms=plain_ms)


def phase_main(dev, card):
    """The main path: gates at B=64 x 120 ticks (bench.py:120-154 on the
    port), then 10 timed walking ticks at B=4096 and the solve rate."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait, riccati
    from legged_mpc_control_tpu_torch.ops import riccati_kernel, substep_kernel
    from legged_mpc_control_tpu_torch.parallel import runner

    f32 = torch.float32
    params = go1_params(f32, dev)
    pattern = gait.trot_pattern(f32, dev)
    velx = 0.15

    def make(n, iters, stand=20, fused=True):
        return runner.make_batched_rollout(
            pattern, horizon=10, n_ticks=n, pdip_iters=iters,
            walk_velx=velx, stand_ticks=stand, fused_substeps=fused)

    def init(b, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return runner.init_loop_batch(params, b, gen,
                                      height_range=(0.26, 0.30), dtype=f32,
                                      body_height=0.28, device=dev)

    t0 = phase("main path gates: B=64, 120 ticks, iters 4 vs 20, fused vs "
               "unfused")
    loop64 = init(64, 9)
    ref = make(120, 20)(loop64, params)[0].sim.pos
    probe = make(120, 4)(loop64, params)[0].sim.pos
    unfused = make(120, 4, fused=False)(loop64, params)[0].sim.pos
    check(bool(torch.isfinite(probe).all()), "non-finite states at iters=4")
    dev_mean = float((probe - ref).abs().mean())
    dz = abs(float(probe[:, 2].mean() - ref[:, 2].mean()))
    z, x = probe[:, 2], probe[:, 0]
    print(f"   iters 4 vs 20: mean |dpos| {dev_mean:.3e} m, mean height "
          f"shift {dz:.3e} m; z in [{float(z.min()):.4f}, "
          f"{float(z.max()):.4f}], min x {float(x.min()):.4f} m", flush=True)
    check(dev_mean < 2e-3, f"iters=4 diverges from converged: {dev_mean}")
    check(dz < 1e-3, f"height distribution shifted: {dz}")
    check(float(z.min()) > 0.2 and float(z.max()) < 0.4, "fallen scenarios")
    check(float(x.min()) > 0.5 * velx, "no forward progress")
    dh = abs(float(z.mean() - unfused[:, 2].mean()))
    dx = abs(float(x.mean() - unfused[:, 0].mean()))
    print(f"   fused vs unfused substeps: mean height {dh:.3e} m, mean "
          f"progress {dx:.3e} m", flush=True)
    check(dh < 0.01, f"fused vs unfused substeps differ in height: {dh}")
    check(dx < 0.02, f"fused vs unfused substeps differ in progress: {dx}")
    done(t0)

    t0 = phase(f"main path timed: B={B}, 10 walking ticks, iters=4, warm")
    walked = make(30, 4)(init(B, 0), params)[0]
    roll = make(10, 4, stand=0)
    torch.cuda.synchronize()
    riccati_kernel.solve_qp_riccati_cuda.launches = 0
    substep_kernel.substep_chain_cuda.launches = 0
    t1 = time.perf_counter()
    final, _ = roll(walked, params)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    launches = {"riccati_ipm": riccati_kernel.solve_qp_riccati_cuda.launches,
                "substep_chain": substep_kernel.substep_chain_cuda.launches}
    print(f"   kernel launches in the timed run: {launches}", flush=True)
    check(all(n > 0 for n in launches.values()),
          "a kernel of the main path was never launched")
    mean_h = float(final.sim.pos[:, 2].mean())
    check(0.2 < mean_h < 0.4, f"implausible closed-loop height {mean_h}")
    rate = B * 10 / elapsed
    print(f"   closed_loop_scenario_ticks_per_s_b4096_h10 = {rate:.1f} "
          f"({card}; real-time bar {B * 100})", flush=True)
    done(t0)

    t0 = phase(f"solve rate: linearize + K1, B={B}, H=10, iters=15")
    qparams, x0, contact, lin = qp_problem(B, 10, dev)
    variants = [x0 + 1e-3 * k for k in range(4)]

    def solve(x):
        x_ref, A_seq, Bm = lin(x)
        return riccati.solve_qp_riccati(
            x, x_ref, A_seq, Bm, contact, qparams.q_weights,
            qparams.r_weights, qparams.mu, qparams.fz_max, DT, iters=15,
            diagnostics=False).u[:, :12]

    out = solve(variants[0])
    check(bool(torch.isfinite(out).all()), "non-finite GRFs")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(8):
        out = solve(variants[i % 4])
    torch.cuda.synchronize()
    solves = B * 8 / (time.perf_counter() - t1)
    print(f"   convex_mpc_solves_per_s_per_chip_go1_trot_h10 = {solves:.1f} "
          f"({card})", flush=True)
    done(t0)
    return launches, rate, solves


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device available")
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = phase_build()
    print(card, flush=True)
    k1 = phase_k1(dev, card)
    k2 = phase_k2(dev, card)
    launches, rate, solves = phase_main(dev, card)
    print(f"== all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    kernels = {"kernels": [
        {"name": "riccati_ipm", "route": "cuda",
         "source": "legged_mpc_control_tpu_torch/csrc/riccati_ipm.cu",
         "replaces": REPO_K1, "launches": launches["riccati_ipm"],
         "max_abs_err": max(k1[10]["err"], k1[30]["err"]),
         "ms": k1[10]["ms"], "plain_ms": k1[10]["plain_ms"]},
        {"name": "substep_chain", "route": "cuda",
         "source": "legged_mpc_control_tpu_torch/csrc/substep_chain.cu",
         "replaces": REPO_K2, "launches": launches["substep_chain"],
         "max_abs_err": k2["err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"]}]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
