"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written CUDA kernel of the port from
legged_mpc_control_tpu_torch/csrc with nvcc (sm_90a, one nvcc per source,
all at once; K1's two, K4's three and K5/K6's five variants and K7 must
show no stack frame and no spills), holds each against its plain PyTorch
version at its path's shapes (K1 at H=10 and H=30, and at the loop's own
call, iters=4 warm; K4 and K5 at n=120 with B=4096 and B=1, n=360, n=24
(K4)), then drives the paths of the
batched Go1 trot closed loop (`parallel/runner.make_batched_rollout`)
through their quality gates and times them at B=4096: Riccati with kf_type
0 (kernels K1, K2) and 1 (K1, K3), and the condensed PDIP and ADMM solvers
(K4, K5, K2); then the
condensed solve rate and the B=1 solve latencies. Then the contact-implicit
MPC (`control/step.closed_loop_tick_lci_batched`, A1, B=256): the flat
closed loop (K7, K2) with its 24-vs-48-sweep gate, K7 against its plain
version at B=256 (24 sweeps) and B=1 (32 sweeps), the B=1 CI policy
latency (K7), and the box-step terrain loop (K4,
K6) with K4 + K6 against the plain path. Exits non-zero on any failure and
when no CUDA device is present. Diagnostics go to the earlier
lines; the second-to-last line is a JSON object of the kernels, the last
line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import concurrent.futures
import contextlib
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
REPO_K3 = "legged_mpc_control_tpu/ops/substep_pallas.py:777"
REPO_K4 = "legged_mpc_control_tpu/ops/chol_pallas.py:247"
REPO_K5 = "legged_mpc_control_tpu/ops/chol_pallas.py:271"
REPO_K6 = "legged_mpc_control_tpu/ops/chol_pallas.py:211"
REPO_K7 = "legged_mpc_control_tpu/ops/ci_pallas.py:641"
CSRC = "legged_mpc_control_tpu_torch/csrc/"

# the least time an H100 SXM could take (its datasheet peaks): bytes
# over 3.35 TB/s, float32 operations over 67 TFLOP/s (outside the tensor
# cores; these kernels do scalar float32 work)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound(nbytes, flops):
    """(bound_ms, bound_by) of work moving `nbytes` and doing `flops`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations"))


# Operation counts per scenario, counted from the kernels' sources (a
# transcendental counts as one operation).
# K1 (csrc/riccati_ipm.cu), per stage and IPM iteration: the backward
# factor sweep's eight 12x12x12 products (B^T W, T B, T A, A^T W, the two of
# P, and the twelve 12x12 triangular solve pairs of K), its 12x12 Cholesky,
# two LQR solve sweeps (four 12x12 matrix-vector products each) and the
# dual-residual rollout and adjoint (two more).
K1_FLOP_PER_STAGE_ITER = 2 * (8 * 12 ** 3 + 12 ** 3 // 6 + 2 * 4 * 12 ** 2
                              + 2 * 12 ** 2)
# K2 (csrc/substep_chain.cu): per substep and leg ~600 (Jacobian, three
# rotations, two four-branch IKs with ~30 transcendentals each, two 3x3
# solves, FK, the friction pyramid), per substep ~250 for the trunk; the
# Feedback tail ~1,500.
K2_FLOP_PER_SUBSTEP = 4 * 600 + 250
K2_FLOP_TAIL = 1500
# K3 adds per substep the filter: predict (~220), 28 rows of a column pick,
# the correction and the 18x18 rank-1 update (~720 each), the
# symmetrization (~300) and its sensor model (~460).
K3_FLOP_PER_SUBSTEP = K2_FLOP_PER_SUBSTEP + 220 + 28 * 720 + 300 + 460
# K7, per stage and sweep, counted from the function as the TPU kernel
# computes it (legged_mpc_control_tpu/ops/ci_pallas.py:241-543), where
# Fz = I + dt S and Fu = dt T are never formed: the three dense 24x24x24
# products K'Quu, (K'Quu) K and K'Qux; the 24x24 Cholesky; the 25-column
# triangular solve pair; the block-sparse S and T applications (Vxx S,
# S'Y, Vxx T, T' twice: 12,096 over 3x3 blocks) and the 36 3x3 block
# products of Fu'Fu and Fu'Fz and the 9 of the S and T blocks (2,430);
# ~21 elementwise 24x24 updates of Qxx, Quu, Qux, their regularized forms
# and Vxx; the Q and value vectors (~3,900) and the per-foot
# quadratization (~700). Then six forward passes, each K (z - zn) (1,152),
# the step (~150) and the stage cost (~600).
K7_FLOP_PER_STAGE_SWEEP = (3 * 2 * 24 ** 3 + 24 ** 3 // 3
                           + 2 * 24 ** 2 * 25 + 12_096 + 2_430
                           + 21 * 24 ** 2 + 3_900 + 700
                           + 6 * (2 * 24 ** 2 + 150 + 600))


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


@contextlib.contextmanager
def launch_counts():
    """The kernel launches made inside the block, by kernel name: every
    count is set to 0 just before the block and read just after."""
    from legged_mpc_control_tpu_torch.ops import cuda_build

    counts = {}
    cuda_build.LAUNCHES.clear()
    yield counts
    counts.update(cuda_build.LAUNCHES)


def check_launched(counts, names, path):
    print(f"   kernel launches in the timed run: {counts}", flush=True)
    check(all(counts.get(k, 0) > 0 for k in names),
          f"a kernel of the {path} path was never launched")


@contextlib.contextmanager
def patched(module, **fns):
    """Attributes of `module` replaced by `fns` inside the block. The launch
    counts live in cuda_build.LAUNCHES, beside each launch, so a replaced
    wrapper cannot redirect them."""
    saved = {k: getattr(module, k) for k in fns}
    for k, fn in fns.items():
        setattr(module, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(module, k, fn)


# ~30 ms of device spin ahead of a timed window (cuda_ms)
SPIN_CYCLES = 50_000_000


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps runs, after one warm-up. The card
    first spins for SPIN_CYCLES, so the host queues the runs of a short
    kernel ahead of it and the events time the device's work, not the
    host's launch gaps (which on a loaded host stretched K2's 0.46 ms to
    0.65 ms). A run that synchronizes, as the plain versions may, still
    waits for its host."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
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


# K4's variants, one per shape regime (csrc/chol_factor.cu)
K4_VARIANTS = ("chol_factor_small", "chol_factor_mid", "chol_factor_large")
# K1's instantiations by the place of its per-stage store (mangled
# riccati_ipm_kernel<true> / <false>, csrc/riccati_ipm.cu)
K1_VARIANTS = ("riccati_ipm_kernelILb1E", "riccati_ipm_kernelILb0E")
# K5's three variants (staged triangle, streamed rows, the ring for any n)
# and K6's two (X in registers at n=24, in shared memory otherwise),
# csrc/chol_lanes.cu
K56_VARIANTS = ("chol_solve_tri", "chol_solve_stream", "chol_solve_ring",
                "chol_solve_multi_regs", "chol_solve_multi_smem")
# sources whose every kernel must build with no stack frame and no spills
GATED = {"riccati_ipm": ("K1", K1_VARIANTS),
         "chol_factor": ("K4", K4_VARIANTS),
         "chol_lanes": ("K5/K6", K56_VARIANTS),
         "ci_sweeps": ("K7", ("ci_sweeps",))}


def ptxas_report(log):
    """{entry function: its ptxas -v lines (registers; stack frame and
    spills)} from an nvcc build log."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = []
        elif name is not None and ("registers" in ln or "stack frame" in ln):
            out[name].append(ln.split(":", 1)[-1].strip())
    return out


def phase_build():
    from legged_mpc_control_tpu_torch.ops import cuda_build

    sources = ("riccati_ipm", "substep_chain", "chol_factor", "chol_lanes",
               "ci_sweeps")
    t0 = phase(f"build: nvcc sm_90a, {len(sources)} sources in parallel")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(cuda_build.build, sources))
    for src, so in zip(sources, built):
        log = so.with_suffix(".log").read_text()
        if src not in GATED:
            keep = [ln.strip() for ln in log.splitlines() if "registers" in ln
                    or "spill" in ln or "stack frame" in ln]
            print(f"   {so.name}: " + " | ".join(keep), flush=True)
            continue
        label, variants = GATED[src]
        seen = set()
        for fn, lines in ptxas_report(log).items():
            variant = next((v for v in variants if v in fn), fn)
            seen.add(variant)
            print(f"   {label} {variant}: " + " | ".join(lines), flush=True)
            check(any("0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                      "spill loads" in ln for ln in lines),
                  f"{label} {variant}: a stack frame or spills")
        check(seen == set(variants),
              f"{label} variants built: {sorted(seen)}")
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


def NX_IN_K1(H):
    """Floats K1 reads per scenario: x0, x_ref, A_seq, B, contact, the two
    weight vectors, mu and fz_max."""
    return 12 + 12 * H + 144 * H + 144 + 4 * H + 24 + 2


def NX_OUT_K1(H):
    """Floats K1 writes per scenario: u, gap, the duals."""
    return 12 * H + 1 + 24 * H


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
        b_ms, b_by = bound(
            B * 4 * (NX_IN_K1(horizon) + NX_OUT_K1(horizon)),
            B * horizon * 15 * K1_FLOP_PER_STAGE_ITER)
        print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms per cold solve; bound {b_ms:.4f} ms ({b_by})", flush=True)
        stats[horizon] = dict(err=err, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by)
        if horizon == 10:
            # the launch the main path makes every tick: iters=4, warm
            # from a shifted solution
            uk = riccati_kernel.solve_qp_riccati_cuda(
                *args, DT, iters=4, warm_u=warm_u)[0]
            up = riccati.solve_qp_riccati_batched(
                *args, DT, iters=4, warm_u=warm_u)[0]
            u64 = riccati.solve_qp_riccati_batched(
                *args64, DT, iters=4, warm_u=warm_u.double())[0]
            check(bool(torch.isfinite(uk).all()), "K1 iters=4: non-finite")
            d = (uk - up).abs().amax(-1)
            q99 = float(torch.quantile(d.double(), 0.99))
            e64 = float((uk.double() - u64).abs().max())
            p64 = float((up.double() - u64).abs().max())
            check(q99 <= K1_BRACKET,
                  f"K1 iters=4 warm: p99 GRF difference {q99}")
            check(e64 <= 1.5 * p64 + K1_BRACKET,
                  f"K1 iters=4 warm: {e64} N from float64, plain {p64} N")
            ms4 = cuda_ms(lambda: riccati_kernel.solve_qp_riccati_cuda(
                *args, DT, iters=4, warm_u=warm_u), reps=20)
            b4 = bound(B * 4 * (NX_IN_K1(horizon) + NX_OUT_K1(horizon)
                                + 12 * horizon),
                       B * horizon * 4 * K1_FLOP_PER_STAGE_ITER)
            print(f"   the loop's call, iters=4 warm ({card}): kernel "
                  f"{ms4:.3f} ms; bound {b4[0]:.4f} ms ({b4[1]}); "
                  f"max|u_kernel - u_plain| {float(d.max()):.3e} N "
                  f"(p99 {q99:.3e}); vs float64: kernel {e64:.3e} N, plain "
                  f"{p64:.3e} N", flush=True)
            stats["loop"] = dict(ms=ms4, bound_ms=b4[0], bound_by=b4[1])
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
    b_ms, b_by = bound(
        B * 4 * (substep_kernel.N_IN + 1 + substep_kernel.N_OUT),
        B * (8 * K2_FLOP_PER_SUBSTEP + K2_FLOP_TAIL))
    print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"per 8-substep chain; bound {b_ms:.4f} ms ({b_by})", flush=True)
    done(t0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_main(dev, card):
    """The main path: gates at B=64 x 120 ticks (bench.py:120-154 on the
    port), then 10 timed walking ticks at B=4096 and the solve rate."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait, riccati
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
    with launch_counts() as launches:
        t1 = time.perf_counter()
        final, _ = roll(walked, params)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
    check_launched(launches, ("riccati_ipm", "substep_chain"), "main")
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
    return launches, rate, solves, walked


KF_TOL = {"kf_x": 2e-3}     # tests/test_substep_fused.py's kf1 bracket
KF_P_TOL = (2e-4, 2e-3)    # (atol, rtol), the same test's covariance bracket


def init_batch(params, b, seed, dev):
    from legged_mpc_control_tpu_torch.parallel import runner

    gen = torch.Generator(device=dev).manual_seed(seed)
    return runner.init_loop_batch(params, b, gen, height_range=(0.26, 0.30),
                                  dtype=torch.float32, body_height=0.28,
                                  device=dev)


def phase_k3(dev, card):
    """Kernel K3 (the substep chain with the in-chain KF) vs its plain
    version, all 8 substeps, from mid-trot with a settled filter."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.control import sensors, step
    from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait
    from legged_mpc_control_tpu_torch.ops import substep_kernel
    from legged_mpc_control_tpu_torch.parallel import runner

    t0 = phase(f"K3 substep_chain kf_type 1 vs plain, B={B}, 8 substeps, "
               "mid-trot")
    f32 = torch.float32
    params = go1_params(f32, dev)
    pattern = gait.trot_pattern(f32, dev)
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15, stand_ticks=20,
        kf_type=1)(init_batch(params, B, 5, dev), params)
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
    kw = dict(substeps=8, dt=DT / 8, kf_type=1, kf_x=cs.kf.x, kf_P=cs.kf.P)
    got = substep_kernel.substep_chain_cuda(*args, **kw)
    want = substep_kernel.substep_chain_plain(*args, **kw)
    torch.cuda.synchronize()
    stance = float(sim.contact.float().mean())
    est = float((cs.kf.x[:, 0:3] - sim.pos).abs().max())
    print(f"   start: stance share {stance:.3f}, max |estimate - truth| "
          f"{est:.3e} m", flush=True)
    check(0.05 < stance < 0.95, "K3 start state is not mid-trot")
    flips = int((got["contact"] != want["contact"]).any(-1).sum())
    print(f"   scenarios whose contacts differ: {flips}", flush=True)
    check(flips == 0, f"K3: contacts differ in {flips} scenarios")
    err = 0.0
    for name, tol in {**STATE_TOL, **KF_TOL}.items():
        e = float((got[name] - want[name]).abs().max())
        check(bool(torch.isfinite(got[name]).all()), f"K3 {name} non-finite")
        print(f"   {name}: max err {e:.3e} (tol {tol})", flush=True)
        check(e <= tol, f"K3 {name}: {e} > {tol}")
        err = max(err, e)
    atol, rtol = KF_P_TOL
    dP = (got["kf_P"] - want["kf_P"]).abs()
    over = float((dP - rtol * want["kf_P"].abs()).max())
    print(f"   kf_P: max err {float(dP.max()):.3e} (tol {atol} + {rtol} "
          "relative)", flush=True)
    check(over <= atol, f"K3 kf_P: {over} over the bracket")
    for name, (off, n) in substep_kernel.FB_ROWS.items():
        e = float((got["fb"][:, off:off + n]
                   - want["fb"][:, off:off + n]).abs().max())
        check(e <= FB_TOL[name], f"K3 fb {name}: {e} > {FB_TOL[name]}")
    ms = cuda_ms(lambda: substep_kernel.substep_chain_cuda(*args, **kw),
                 reps=20)
    plain_ms = cuda_ms(lambda: substep_kernel.substep_chain_plain(*args, **kw),
                       reps=3)
    n_kf = substep_kernel.N_KF
    b_ms, b_by = bound(
        B * 4 * (substep_kernel.N_IN + n_kf + 1 + substep_kernel.N_OUT + n_kf),
        B * (8 * K3_FLOP_PER_SUBSTEP + K2_FLOP_TAIL))
    print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"per 8-substep chain; bound {b_ms:.4f} ms ({b_by})", flush=True)
    done(t0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def newton_matrices(batch, horizon, dev, iteration, iters=15):
    """The Newton matrices K = P + G^T D G + reg I that the condensed PDIP
    solve of the solve-rate problem factors at `iteration` (0-based), and a
    right-hand side of that iteration: captured at the factor call."""
    from legged_mpc_control_tpu_torch.mpc import pdip, qp_builder
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    params, x0, contact, lin = qp_problem(batch, horizon, dev)
    x_ref, A_seq, Bm = lin(x0)
    qp = qp_builder.build_condensed_qp(
        x0, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, DT)
    calls, seen = [], []
    factor = chol_kernel.cholesky_cuda

    def capture(K):
        if len(calls) == iteration:
            seen.append(K.clone())
        calls.append(1)
        return factor(K)

    with patched(chol_kernel, cholesky_cuda=capture):
        pdip.solve_qp_pdip_batched(qp.P, qp.q, qp.mu, qp.fz_max, qp.contact,
                                   iters=iters)
    gen = torch.Generator(device=dev).manual_seed(iteration)
    rhs = torch.randn((batch, 12 * horizon), generator=gen, device=dev)
    return seen[0], rhs


# The whole-solve bracket of the condensed PDIP in float32: with d clipped
# at 1e6 and reg 1e-6 the float32 solve sits ~0.05 N from the float64 one
# (CPU rehearsal of this phase at B=64), so two float32 solves are held to
# 0.1 N for 99 % of the scenarios, and the kernels' to no farther from
# float64 than the plain version (x1.5 + 0.1 N), both at the 99th
# percentile. A float32 factorization that fails on a matrix within
# rounding of singular freezes that scenario's solve early (the solver's
# guard), and which few scenarios that hits differs between any two
# factorizations, so the tail is held by its size: the kernels may leave
# at most 3x as many scenarios beyond PDIP_BRACKET from float64 as the
# plain version, plus PDIP_TAIL_SLACK.
PDIP_BRACKET = 0.1
PDIP_TAIL_SLACK = 8

ROBUST_PIVOT = 1e-4


def tri(n):
    """Floats of one n x n triangle: what a Cholesky factor or solve must
    read of a symmetric matrix or of its factor, and write of a factor."""
    return n * (n + 1) // 2

# label -> (batch, horizon, 0-based PDIP iteration of the Newton matrix);
# K4 serves n=120 with its mid variant, n=360 with the blocked one, and
# "b=1" is the B=1 latency cells' shape
CHOL_CASES = {"early": (B, 10, 0), "late": (B, 10, 14), "n=360": (512, 30, 0),
              "b=1": (1, 10, 0)}
# the kernels line's max_abs_err for K4/K5 is the elementwise difference
# from the plain version where every matrix is far from singular (the late
# matrices are held by residuals instead)
WELL_CONDITIONED = ("early", "n=360", "b=1")


def phase_chol(dev, card):
    """Kernels K4 and K5 vs their plain versions on the Newton matrices of
    a real B=4096, H=10 PDIP solve at an early and a late iteration, and at
    n=360 (H=30, the device-memory path) with B=512. Factors are held by
    the relative residual of L L^T - K, solves by that of K x - b (two
    correct float32 factorizations of these matrices, whose scaling d is
    clipped at 1e6, differ elementwise far beyond float32 resolution);
    the kernel must stay within 4x of the plain version's residual plus
    1e-6. Late in a solve many of these matrices are within float32
    rounding of singular (frozen scenarios keep d at its clip): a float32
    factorization may then fail, and the solver's guard freezes that
    scenario. Which borderline matrices fail depends on the order of the
    roundings, so the gate is that the kernel factors every matrix whose
    float64 factorization keeps all pivots L_jj^2 >= ROBUST_PIVOT * K_jj
    (there float32's backward error, ~n eps K_jj = 7e-6 K_jj, cannot
    reach zero); the residuals are taken over the scenarios both factor.
    Then whole PDIP solves are held by their GRFs, as K1 is."""
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    def finite(M):
        return torch.isfinite(M.reshape(M.shape[0], -1)).all(-1)

    def factor_resid(F, K):
        L = F.double().tril()
        return float(((L @ L.transpose(-1, -2) - K.double()).abs()
                      .amax(dim=(-1, -2)) / K.double().abs()
                      .amax(dim=(-1, -2))).max())

    def solve_resid(x, K, b):
        r = (K.double() @ x.double()[..., None])[..., 0] - b.double()
        return float((r.abs().amax(-1) / b.double().abs().amax(-1)).max())

    stats = {}
    for label, (batch, horizon, it) in CHOL_CASES.items():
        n = 12 * horizon
        t0 = phase(f"K4 chol_factor, K5 chol_solve vs plain, B={batch}, "
                   f"n={n}, PDIP Newton matrix of iteration {it + 1} "
                   f"({label})")
        K, rhs = newton_matrices(batch, horizon, dev, it)
        F = chol_kernel.cholesky_cuda(K)
        Fp = chol_kernel.cholesky_plain(K)
        x = chol_kernel.cho_solve_cuda(F, rhs)
        xp = chol_kernel.cho_solve_plain(Fp, rhs)
        torch.cuda.synchronize()
        ok_k, ok_p = finite(F), finite(Fp)
        both = ok_k & ok_p
        L64, info = torch.linalg.cholesky_ex(K.double())
        pivot = torch.where(
            info == 0, (L64.diagonal(dim1=-2, dim2=-1) ** 2
                        / K.double().diagonal(dim1=-2, dim2=-1)).amin(-1),
            torch.zeros_like(L64[:, 0, 0]))
        del L64
        robust = pivot >= ROBUST_PIVOT
        n_k, n_p = int((~ok_k).sum()), int((~ok_p).sum())
        n_kr, n_pr = int((~ok_k & robust).sum()), int((~ok_p & robust).sum())
        print(f"   non-finite factors: kernel {n_k}, plain {n_p} of {batch};"
              f" {int((~robust).sum())} matrices have a float64 pivot below "
              f"{ROBUST_PIVOT} K_jj; failures among the others: kernel "
              f"{n_kr}, plain {n_pr}", flush=True)
        check(n_kr == 0, f"K4 {label}: {n_kr} robust matrices not factored")
        check(bool(finite(x[both]).all()), f"K5 {label}: non-finite")
        Fb = F[both]
        check(bool(torch.equal(Fb, Fb.transpose(-1, -2))),
              f"K4 {label}: the upper triangle does not mirror L")
        rf, rfp = factor_resid(Fb, K[both]), factor_resid(Fp[both], K[both])
        rs = solve_resid(x[both], K[both], rhs[both])
        rsp = solve_resid(xp[both], K[both], rhs[both])
        diag = K.diagonal(dim1=-2, dim2=-1)
        err4 = float((Fb - Fp[both]).abs().max())
        err5 = float((x[both] - xp[both]).abs().max())
        print(f"   K diagonal in [{float(diag.min()):.3e}, "
              f"{float(diag.max()):.3e}]; factor residual: kernel "
              f"{rf:.3e}, plain {rfp:.3e}; solve residual: kernel {rs:.3e},"
              f" plain {rsp:.3e}; max |F - F_plain| {err4:.3e}, max "
              f"|x - x_plain| {err5:.3e}", flush=True)
        check(rf <= 4 * rfp + 1e-6, f"K4 {label}: residual {rf} vs {rfp}")
        check(rs <= 4 * rsp + 1e-6, f"K5 {label}: residual {rs} vs {rsp}")
        entry = dict(
            factor_resid=rf, solve_resid=rs, err4=err4, err5=err5,
            ms4=cuda_ms(lambda: chol_kernel.cholesky_cuda(K), reps=10),
            plain4=cuda_ms(lambda: chol_kernel.cholesky_plain(K), reps=3),
            lib4=cuda_ms(lambda: torch.linalg.cholesky_ex(K), reps=3),
            ms5=cuda_ms(lambda: chol_kernel.cho_solve_cuda(F, rhs), reps=10),
            plain5=cuda_ms(lambda: chol_kernel.cho_solve_plain(Fp, rhs),
                           reps=3),
            lib5=cuda_ms(lambda: torch.cholesky_solve(rhs[..., None],
                                                      Fp.tril()), reps=3),
            bound4=bound(batch * tri(n) * 2 * 4, batch * n ** 3 / 3),
            bound5=bound(batch * (tri(n) + 2 * n) * 4, batch * 2 * n * n))
        print(f"   time ({card}): K4 kernel {entry['ms4']:.4f} ms, plain "
              f"{entry['plain4']:.4f} ms, torch.linalg.cholesky_ex "
              f"{entry['lib4']:.4f} ms (x{entry['lib4'] / entry['ms4']:.2f} "
              f"the kernel's time), bound {entry['bound4'][0]:.4f} ms "
              f"({entry['bound4'][1]}); K5 kernel {entry['ms5']:.3f} ms, "
              f"plain {entry['plain5']:.3f} ms, torch.cholesky_solve "
              f"{entry['lib5']:.3f} ms, bound {entry['bound5'][0]:.4f} ms "
              f"({entry['bound5'][1]})", flush=True)
        stats[label] = entry
        done(t0)
    print(f"   K5 chol_solve ({card}): " + "; ".join(
        f"{label} (B={CHOL_CASES[label][0]}, n={12 * CHOL_CASES[label][1]}) "
        f"{e['ms5']:.4f} ms, bound {e['bound5'][0]:.4f} ms, "
        f"torch.cholesky_solve {e['lib5']:.4f} ms"
        for label, e in stats.items()), flush=True)

    t0 = phase(f"PDIP solve with K4/K5 vs plain vs float64, B={B}, H=10, "
               "iters=15 cold")
    params, x0, contact, lin = qp_problem(B, 10, dev)

    def solve_marking(solve, frozen):
        """`solve`, marking in `frozen` each scenario whose Newton direction
        came out non-finite: the solver's guard freezes it there."""
        def fn(F, b):
            x = solve(F, b)
            frozen.logical_or_(~torch.isfinite(x).all(-1))
            return x
        return fn

    fro_k = torch.zeros((B,), dtype=torch.bool, device=dev)
    with patched(chol_kernel, cho_solve_cuda=solve_marking(
            chol_kernel.cho_solve_cuda, fro_k)):
        u_k = condensed_solve(params, contact, lin, x0, 15).u
    # the float32 plain and float64 solves run the same solver code with
    # the plain factor and solve put in the kernels' place
    fro_p, fro_64 = torch.zeros_like(fro_k), torch.zeros_like(fro_k)

    def with_plain(frozen):
        return patched(chol_kernel, cholesky_cuda=chol_kernel.cholesky_plain,
                       cho_solve_cuda=solve_marking(
                           chol_kernel.cho_solve_plain, frozen))

    with with_plain(fro_p):
        u_p = condensed_solve(params, contact, lin, x0, 15).u
    p64 = params.replace(**{f: getattr(params, f).double() for f in (
        "q_weights", "r_weights", "mu", "fz_max")})
    with with_plain(fro_64):
        u64 = condensed_solve(p64, contact.double(),
                              lambda x: tuple(
                                  a.double() for a in lin(x.float())),
                              x0.double(), 15).u
    check(bool(torch.isfinite(u_k).all()), "PDIP with K4/K5: non-finite")
    d = (u_k - u_p).abs().amax(-1).double()
    d_k64 = (u_k.double() - u64).abs().amax(-1)
    d_p64 = (u_p.double() - u64).abs().amax(-1)
    qs = [float(torch.quantile(d, q)) for q in (0.5, 0.9, 0.99)]
    k99, p99 = (float(torch.quantile(x, 0.99)) for x in (d_k64, d_p64))
    out_k, out_p = d_k64 > PDIP_BRACKET, d_p64 > PDIP_BRACKET
    n_ok, n_op = int(out_k.sum()), int(out_p.sum())
    print(f"   |u_kernels - u_plain| per scenario: p50 {qs[0]:.3e}, p90 "
          f"{qs[1]:.3e}, p99 {qs[2]:.3e}, max {float(d.max()):.3e} N "
          f"({int((d > PDIP_BRACKET).sum())} of {B} over {PDIP_BRACKET} N); "
          f"vs float64: p99 kernels {k99:.3e}, plain {p99:.3e} N; max "
          f"kernels {float(d_k64.max()):.3e}, plain "
          f"{float(d_p64.max()):.3e} N", flush=True)
    print(f"   scenarios over {PDIP_BRACKET} N from float64: kernels {n_ok} "
          f"({int((out_k & fro_k).sum())} of them frozen by the guard), "
          f"plain {n_op} ({int((out_p & fro_p).sum())} frozen); frozen in "
          f"all: kernels {int(fro_k.sum())}, plain {int(fro_p.sum())}, "
          f"float64 {int(fro_64.sum())} of {B}", flush=True)
    check(qs[2] <= PDIP_BRACKET, f"PDIP: p99 GRF difference {qs[2]}")
    check(k99 <= 1.5 * p99 + PDIP_BRACKET,
          f"PDIP: p99 {k99} N from float64, plain {p99} N")
    check(n_ok <= 3 * n_op + PDIP_TAIL_SLACK,
          f"PDIP: {n_ok} scenarios over {PDIP_BRACKET} N from float64, "
          f"plain {n_op}")
    done(t0)

    t0 = phase("K4, K5 contract: a non-positive pivot gives non-finite "
               "values")
    K, rhs = newton_matrices(8, 10, dev, 0, iters=1)
    K[3, 7, 7] = -1.0
    F = chol_kernel.cholesky_cuda(K)
    x = chol_kernel.cho_solve_cuda(F, rhs)
    ok = [bool(torch.isfinite(F[i]).all()) for i in range(8)]
    ok5 = [bool(torch.isfinite(x[i]).all()) for i in range(8)]
    print(f"   finite per scenario: factor {ok}, solution {ok5}", flush=True)
    check(ok == [True] * 3 + [False] + [True] * 4,
          "K4 must give non-finite values exactly where a pivot fails")
    check(ok5 == ok, "K5 must give a non-finite solution exactly where the "
          "factor is non-finite")
    done(t0)
    return stats


def phase_kf1(dev, card):
    """The kf_type-1 closed loop: the gates of bench.py:203-222 at B=64 x
    120 ticks (iters=4), fused vs unfused substeps, then 10 timed walking
    ticks at B=4096."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner

    f32 = torch.float32
    params = go1_params(f32, dev)
    pattern = gait.trot_pattern(f32, dev)
    velx = 0.15

    def make(n, stand=20, fused=True):
        return runner.make_batched_rollout(
            pattern, horizon=10, n_ticks=n, pdip_iters=4, walk_velx=velx,
            stand_ticks=stand, fused_substeps=fused, kf_type=1)

    t0 = phase("kf_type 1 gates: B=64, 120 ticks, iters=4, estimator, fused "
               "vs unfused")
    loop64 = init_batch(params, 64, 9, dev)
    final = make(120)(loop64, params)[0]
    unfused = make(120, fused=False)(loop64, params)[0]
    pos = final.sim.pos
    z, x = pos[:, 2], pos[:, 0]
    check(bool(torch.isfinite(pos).all()), "non-finite kf1 states")
    err = (final.controller.kf.x[:, 0:3] - pos).abs()
    ez, exy = float(err[:, 2].mean()), float(err[:, 0:2].mean())
    print(f"   z in [{float(z.min()):.4f}, {float(z.max()):.4f}], min x "
          f"{float(x.min()):.4f} m; KF error: z {ez:.4e} m, xy {exy:.4e} m",
          flush=True)
    check(float(z.min()) > 0.2 and float(z.max()) < 0.4, "fallen kf1")
    check(float(x.min()) > 0.5 * velx, "no kf1 forward progress")
    check(ez < 0.025, f"KF z estimate off truth by {ez} m")
    check(exy < 0.04, f"KF xy drift {exy} m over 1.2 s")
    dh = abs(float(z.mean() - unfused.sim.pos[:, 2].mean()))
    dx = abs(float(x.mean() - unfused.sim.pos[:, 0].mean()))
    print(f"   fused vs unfused substeps: mean height {dh:.3e} m, mean "
          f"progress {dx:.3e} m", flush=True)
    # the unfused loop's opening feedback pass steps the filter a ninth
    # time every tick (the fused chain steps it 8 times, as on the TPU):
    # its estimate, and so the height the controller holds, differs by
    # ~1 cm over 120 ticks (under 1 mm over the 6 ticks of
    # tests/test_torch_rollouts.py), so
    # the kf0 bounds of this gate are doubled here
    check(dh < 0.02, f"kf1 fused vs unfused differ in height: {dh}")
    check(dx < 0.04, f"kf1 fused vs unfused differ in progress: {dx}")
    done(t0)

    t0 = phase(f"kf_type 1 timed: B={B}, 10 walking ticks, iters=4, warm")
    walked = make(30)(init_batch(params, B, 0, dev), params)[0]
    roll = make(10, stand=0)
    torch.cuda.synchronize()
    with launch_counts() as launches:
        t1 = time.perf_counter()
        final, _ = roll(walked, params)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
    check_launched(launches, ("riccati_ipm", "substep_chain_kf1"), "kf1")
    mean_h = float(final.sim.pos[:, 2].mean())
    check(0.2 < mean_h < 0.4, f"implausible kf1 height {mean_h}")
    rate = B * 10 / elapsed
    print(f"   closed_loop_scenario_ticks_per_s_b4096_kf1 = {rate:.1f} "
          f"({card}; real-time bar {B * 100})", flush=True)
    done(t0)
    return launches["substep_chain_kf1"], rate


SOLVER_ITERS = {"pdip": 8, "admm": 30}


def phase_condensed(dev, card, walked):
    """The condensed-solver closed loops: gates at B=64 x 120 ticks, the
    mean |dpos| against the Riccati loop at iters=20, and 10 timed walking
    ticks at B=4096 from the walked-in Riccati state (PDIP warm, 8
    iterations; ADMM warm, 30)."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner

    f32 = torch.float32
    params = go1_params(f32, dev)
    pattern = gait.trot_pattern(f32, dev)
    velx = 0.15

    def make(solver, n, iters, stand=20):
        return runner.make_batched_rollout(
            pattern, horizon=10, n_ticks=n, pdip_iters=iters,
            walk_velx=velx, stand_ticks=stand, solver=solver)

    loop64 = init_batch(params, 64, 9, dev)
    ref = make("riccati", 120, 20)(loop64, params)[0].sim.pos
    out = {}
    for solver, iters in SOLVER_ITERS.items():
        t0 = phase(f"{solver} closed loop gates: B=64, 120 ticks, "
                   f"{iters} iterations warm")
        pos = make(solver, 120, iters)(loop64, params)[0].sim.pos
        z, x = pos[:, 2], pos[:, 0]
        check(bool(torch.isfinite(pos).all()), f"{solver}: non-finite")
        dev_mean = float((pos - ref).abs().mean())
        print(f"   z in [{float(z.min()):.4f}, {float(z.max()):.4f}], min x "
              f"{float(x.min()):.4f} m; mean |dpos| vs riccati iters=20: "
              f"{dev_mean:.3e} m", flush=True)
        check(float(z.min()) > 0.2 and float(z.max()) < 0.4,
              f"{solver}: fallen scenarios")
        check(float(x.min()) > 0.5 * velx, f"{solver}: no forward progress")
        done(t0)

        t0 = phase(f"{solver} timed: B={B}, 10 walking ticks, {iters} "
                   "iterations warm")
        roll = make(solver, 10, iters, stand=0)
        torch.cuda.synchronize()
        with launch_counts() as launches:
            t1 = time.perf_counter()
            final, _ = roll(walked, params)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t1
        check_launched(launches, ("chol_factor", "chol_solve",
                                  "substep_chain"), solver)
        mean_h = float(final.sim.pos[:, 2].mean())
        check(0.2 < mean_h < 0.4, f"{solver}: implausible height {mean_h}")
        rate = B * 10 / elapsed
        print(f"   closed_loop_scenario_ticks_per_s_b4096_{solver}{iters} = "
              f"{rate:.1f} ({card}; solver {solver}; real-time bar "
              f"{B * 100})", flush=True)
        out[solver] = dict(launches=launches, rate=rate)
        done(t0)
    return out


def condensed_solve(params, contact, lin, x, iters, warm_u=None):
    from legged_mpc_control_tpu_torch.mpc import pdip, qp_builder

    x_ref, A_seq, Bm = lin(x)
    qp = qp_builder.build_condensed_qp(
        x, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, DT)
    return pdip.solve_qp_pdip_batched(qp.P, qp.q, qp.mu, qp.fz_max,
                                      qp.contact, iters=iters, warm_u=warm_u)


def host_ms(fn, variants, reps):
    """Mean host-clock time of fn(*variant) over reps calls, ending in a
    synchronize, after one warm-up."""
    fn(*variants[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(reps):
        fn(*variants[i % len(variants)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t1) / reps * 1e3


def phase_condensed_rate(dev, card):
    """The condensed solve rate at B=4096, H=10, iters=15 (build + PDIP,
    __graft_entry__.py:118-127) with the stance-load gate of
    bench.py:68-74."""
    t0 = phase(f"condensed solve rate: build + PDIP, B={B}, H=10, iters=15")
    params, x0, contact, lin = qp_problem(B, 10, dev)
    variants = [(x0 + 1e-3 * k,) for k in range(4)]

    def solve(x):
        return condensed_solve(params, contact, lin, x, 15).u[:, :12]

    out = solve(x0)
    check(bool(torch.isfinite(out).all()), "condensed: non-finite GRFs")
    mass = float(params.mass)
    fz = float(out[:, 2:12:3].sum(-1).mean())
    check(0.3 * 9.8 * mass < fz < 2.0 * 9.8 * mass,
          f"condensed: implausible stance load {fz}")
    ms = host_ms(solve, variants, reps=8)
    print(f"   mean stance load {fz:.2f} N; convex_mpc_solves_per_s_per_chip_"
          f"go1_trot_h10_pdip = {B / ms * 1e3:.1f} ({card}; solver pdip)",
          flush=True)
    done(t0)
    return B / ms * 1e3


def phase_latency(dev, card):
    """B=1 solve latencies of the condensed solvers (bench.py:242-372):
    PDIP cold (15 iterations), ADMM warm (30, from a neighbouring tick's
    200-iteration tuple) and PDIP warm (8, from the previous tick's
    converged solution shifted to the next schedule); the warm runs are
    gated against a converged 40-iteration PDIP solve to 0.5 N."""
    from legged_mpc_control_tpu_torch.mpc import admm, qp_builder, riccati

    t0 = phase("B=1 latencies: PDIP cold 15, ADMM warm 30, PDIP warm 8")
    params, x0, contact, lin = qp_problem(1, 10, dev)
    variants = [(x0 + 1e-4 * k,) for k in range(8)]
    cold = host_ms(lambda x: condensed_solve(params, contact, lin, x, 15),
                   variants, reps=30)

    def build(x, c):
        x_ref, A_seq, Bm = lin(x)
        return qp_builder.build_condensed_qp(
            x, x_ref, A_seq, Bm, c, params.q_weights, params.r_weights,
            params.mu, params.fz_max, DT)

    qp0 = build(x0, contact)
    warm = admm.solve_qp_admm_batched(qp0.P, qp0.q, qp0.mu, qp0.fz_max,
                                      contact, iters=200).warm

    def admm_warm(x):
        qp = build(x, contact)
        return admm.solve_qp_admm_batched(qp.P, qp.q, qp.mu, qp.fz_max,
                                          contact, iters=30, warm=warm).u

    conv = condensed_solve(params, contact, lin, x0 + 1e-4, 40).u
    e_admm = float((admm_warm(x0 + 1e-4) - conv).abs().max())
    admm_ms = host_ms(admm_warm, variants, reps=30)

    u_prev = condensed_solve(params, contact, lin, x0, 40).u
    contact2 = torch.cat([contact[:, 1:], contact[:, -1:]], dim=1)
    wu = riccati.warm_shift(u_prev, contact2)
    got = condensed_solve(params, contact2, lin, x0 + 1e-4, 8, wu).u
    want = condensed_solve(params, contact2, lin, x0 + 1e-4, 40, wu).u
    e_pdip = float((got - want).abs().max())
    pdip_ms = host_ms(
        lambda x: condensed_solve(params, contact2, lin, x, 8, wu),
        variants, reps=30)
    print(f"   warm ADMM-30 off converged PDIP-40 by {e_admm:.3e} N; warm "
          f"PDIP-8 off PDIP-40 by {e_pdip:.3e} N", flush=True)
    check(e_admm < 0.5, f"warm ADMM-30 off converged by {e_admm} N")
    check(e_pdip < 0.5, f"warm PDIP-8 off converged by {e_pdip} N")
    lat = {"qp_solve_latency_ms_b1_h10_cold_pdip": cold,
           "qp_solve_latency_ms_b1_h10_warm_admm30": admm_ms,
           "qp_solve_latency_ms_b1_h10_warm_pdip8": pdip_ms}
    for name, v in lat.items():
        print(f"   {name} = {v:.3f} ({card})", flush=True)
    done(t0)
    return lat


# ---- the contact-implicit MPC (A1, B=256, H=10) --------------------------

CI_B = 256
CI_VELX = 0.1
# tests/test_ci_fused.py:49-56, the TPU kernel's bracket against XLA: cost
# rtol 2e-3, Z atol 2e-3 m, forces atol 0.5 N, foot velocities 2e-2 m/s.
# Gate: at least 99 % of the scenarios agree with the plain float32
# version within all four, and the kernel is no farther from the float64
# plain solve than the plain float32 version is (x1.5 + the tolerance, at
# the 99th percentile of the per-scenario errors).
K7_TOL = {"cost": 2e-3, "Z": 2e-3, "forces": 0.5, "foot_vel": 2e-2}
K7_SHARE = 0.99
# Where the float64 pivots are robust: K6's agreement with its plain
# version on the same factor, and that of the terrain path's K4 + K6 with
# the plain path, relative to the matrix's largest entry; and the backward
# errors max|L L' - A| / max|A| and max|A X - R| / (||A||_inf max|X|),
# which float32 keeps within a few n eps (n eps = 2.9e-6 at n=24)
K6_REL_TOL = 1e-3
BACKWARD_TOL = 1e-5
# the gain solve K6 is held on: sweep 21 of 48, the 4th stage solved (k=6)
K6_PICK = 10 * 20 + 3
BOX = dict(center_xy=(1.3, 0.0), size_xy=(2.2, 2.0), height=0.03)
# the box-step gate over the 50 walking ticks: mean forward progress (the
# command is 0.12 m/s from rest), and the share of scenarios that have
# stepped a foot onto the box
TERRAIN_PROGRESS_MIN = 0.02
TERRAIN_ON_BOX_SHARE = 0.9


def ci_setup(dev, batch, iters, velx=CI_VELX, terrain=None, seed=0,
             mode=1):
    """An A1 batch standing at the origin (`runner.init_loop_batch`; on a
    height field its feet stand on the surface, `srb_sim.sim_init`), the
    batched CI walk policy, the stand policy and the LCI state."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc
    from legged_mpc_control_tpu_torch.parallel import runner
    from legged_mpc_control_tpu_torch.sim import srb_sim

    f32 = torch.float32
    params = a1_params(f32, dev)
    walk = ci_mpc.make_ci_walk_policy_batched(params, terrain=terrain,
                                              velx=velx, iters=iters)
    stand = lci_mpc.make_stand_policy(params, body_height=0.3)
    gen = torch.Generator(device=dev).manual_seed(seed)
    loop = runner.init_loop_batch(params, batch, gen, dtype=f32, device=dev)
    if terrain is not None:
        loop = loop.replace(sim=srb_sim.sim_init(
            params, loop.sim.pos[:, 2], f32, dev, terrain=terrain))
    loop = set_mode(loop, mode)
    lci = lci_mpc.lci_init_batched(batch, f32, walk.warm_init(batch, f32,
                                                              dev),
                                   device=dev)
    return dict(params=params, walk=walk, stand=stand, loop=loop, lci=lci,
                terrain=terrain)


def set_mode(loop, mode):
    cs = loop.controller
    B = loop.sim.pos.shape[0]
    return loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=torch.full((B,), mode, dtype=torch.int32,
                                 device=loop.sim.pos.device))))


def ci_roll(st, n, t0=0.0):
    """n closed-loop CI ticks of the state dict `st`, in place."""
    from legged_mpc_control_tpu_torch.control import step

    loop, lci = st["loop"], st["lci"]
    for k in range(n):
        loop, lci = step.closed_loop_tick_lci_batched(
            loop, lci, st["params"], st["stand"], st["walk"],
            t0 + 0.01 * k, terrain=st["terrain"])
    st["loop"], st["lci"] = loop, lci
    return st


def phase_ci_loop(dev, card):
    """The flat CI closed loop of bench.py:412-512 on the port: the
    24-vs-48-sweep gate at B=32 x 60 ticks, then B=256 walked in for 20
    ticks and timed over 10 (24 warm sweeps a tick)."""
    t0 = phase("CI closed loop gate: A1, B=32, 60 ticks, 24 vs 48 sweeps")
    runs = {it: ci_roll(ci_setup(dev, 32, it, seed=7), 60)["loop"].sim.pos
            for it in (24, 48)}
    p24, p48 = runs[24], runs[48]
    check(bool(torch.isfinite(p24).all()), "CI gate run: non-finite")
    dh = abs(float(p24[:, 2].mean() - p48[:, 2].mean()))
    dx = abs(float(p24[:, 0].mean() - p48[:, 0].mean()))
    print(f"   24 vs 48 sweeps: mean height {dh:.3e} m, mean progress "
          f"{dx:.3e} m; z in [{float(p24[:, 2].min()):.4f}, "
          f"{float(p24[:, 2].max()):.4f}], mean x {float(p24[:, 0].mean()):.4f}"
          " m", flush=True)
    check(dh < 0.01, f"24 sweeps diverge from 48 in mean height: {dh}")
    check(dx < 0.02, f"24 sweeps diverge from 48 in mean progress: {dx}")
    check(float(p24[:, 2].min()) > 0.15, "CI gate run fell")
    done(t0)

    t0 = phase(f"CI closed loop timed: A1, B={CI_B}, 20 walk-in + 10 timed "
               "ticks, 24 warm sweeps")
    st = ci_roll(ci_setup(dev, CI_B, 24), 20)
    torch.cuda.synchronize()
    with launch_counts() as launches:
        t1 = time.perf_counter()
        ci_roll(st, 10, t0=0.2)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
    check_launched(launches, ("ci_sweeps", "substep_chain"), "CI flat")
    check(launches.get("chol_factor", 0) == 0
          and launches.get("chol_solve_multi", 0) == 0,
          "the flat CI path launched the terrain path's kernels")
    pos = st["loop"].sim.pos
    check(bool(torch.isfinite(pos).all()), "CI loop: non-finite")
    check(float(pos[:, 2].min()) > 0.15, "CI scenarios fell")
    rate = CI_B * 10 / elapsed
    print(f"   ci_closed_loop_scenario_ticks_per_s_b256 = {rate:.1f} "
          f"({card}; real-time bar {CI_B * 100}); {elapsed / 10 * 1e3:.2f} "
          "ms a tick", flush=True)
    done(t0)
    return launches, rate, st


def per_scenario(x, y):
    return (x.double() - y.double()).abs().reshape(x.shape[0], -1).amax(-1)


def k7_errors(a, b):
    """Per-scenario errors of one K7 result (Uh, Z, cost) against another,
    keyed as K7_TOL."""
    (Ua, Za, ca), (Ub, Zb, cb) = a, b
    return {"cost": ((ca.double() - cb.double()).abs()
                     / cb.double().abs()),
            "Z": per_scenario(Za, Zb),
            "forces": 50.0 * per_scenario(Ua[..., :12], Ub[..., :12]),
            "foot_vel": per_scenario(Ua[..., 12:], Ub[..., 12:])}


def k7_gate(got, a, kw, label):
    """K7's result `got` on the arguments (a, kw) against the plain version
    in float32 (K7_TOL for K7_SHARE of the scenarios) and float64 (the
    kernel's p99 error no more than 1.5x plain's + the tolerance). Returns
    the kernel's largest Z error against plain float32."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    n = a[0].shape[0]
    plain = ci_kernel.ci_sweeps_plain(*a, **kw)
    a64 = tuple(x.double() if torch.is_tensor(x) else x for x in a)
    ref64 = ci_kernel.ci_sweeps_plain(*a64, **kw)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(x).all()) for x in got),
          f"K7 {label}: non-finite result")
    e = k7_errors(got, plain)
    e64, p64 = k7_errors(got, ref64), k7_errors(plain, ref64)
    outside = torch.zeros(n, dtype=torch.bool, device=a[0].device)
    for name, tol in K7_TOL.items():
        outside |= e[name] > tol
        k99 = float(torch.quantile(e64[name], 0.99))
        q99 = float(torch.quantile(p64[name], 0.99))
        print(f"   {label} {name}: kernel vs plain max "
              f"{float(e[name].max()):.3e}, p99 "
              f"{float(torch.quantile(e[name], 0.99)):.3e} (tol {tol}); vs "
              f"float64 p99: kernel {k99:.3e}, plain {q99:.3e}", flush=True)
        check(k99 <= 1.5 * q99 + tol,
              f"K7 {label} {name}: p99 {k99} from float64, plain {q99}")
    n_out = int(outside.sum())
    print(f"   {label}: scenarios outside the bracket: {n_out} of {n}",
          flush=True)
    check(n_out <= (1.0 - K7_SHARE) * n,
          f"K7 {label}: {n_out} of {n} scenarios outside the bracket")
    return float(e["Z"].max())


def phase_k7(dev, card, st):
    """Kernel K7 vs its plain version (float32, and float64 as the
    reference) on the solve of one tick of the walked-in flat loop, B=256,
    H=10, 24 sweeps, and on its first scenario with 32 sweeps (the B=1
    policy's call); both timed."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    t0 = phase(f"K7 ci_sweeps vs plain, B={CI_B}, H=10, 24 sweeps, from the "
               "walked-in flat loop, and B=1, 32 sweeps")
    seen = {}
    kernel = ci_kernel.ci_sweeps_cuda

    def capture(*a, **kw):
        seen["args"] = (a, kw)
        return kernel(*a, **kw)
    with patched(ci_kernel, ci_sweeps_cuda=capture):
        ci_roll(dict(st), 1, t0=0.3)
    a, kw = seen["args"]
    err = k7_gate(ci_kernel.ci_sweeps_cuda(*a, **kw), a, kw, f"B={CI_B}")
    one = tuple(x[:1] if torch.is_tensor(x) and x.dim() and x.shape[0] ==
                CI_B else x for x in a)
    kw1 = dict(kw, iters=32)
    err1 = k7_gate(ci_kernel.ci_sweeps_cuda(*one, **kw1), one, kw1,
                   "B=1, 32 sweeps")
    ms = cuda_ms(lambda: ci_kernel.ci_sweeps_cuda(*a, **kw), reps=5)
    plain_ms = cuda_ms(lambda: ci_kernel.ci_sweeps_plain(*a, **kw), reps=1)
    H, iters = a[1].shape[1], kw["iters"]
    floats = (24 + 24 * H + 48 * H + 24 + 4 * H + 1 + 9 + 24 * H
              + 24 * (H + 1) + 1)
    b_ms, b_by = bound(CI_B * floats * 4 + 54 * 4,
                       CI_B * iters * H * K7_FLOP_PER_STAGE_SWEEP)
    ms1 = cuda_ms(lambda: ci_kernel.ci_sweeps_cuda(*one, **kw1), reps=5)
    print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"per 24-sweep solve; bound {b_ms:.4f} ms ({b_by}); kernel at "
          f"B=1, 32 sweeps {ms1:.3f} ms", flush=True)
    done(t0)
    return dict(err=max(err, err1), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def phase_ci_latency(dev, card):
    """B=1 latency of the CI walk policy (`make_ci_walk_policy`, A1, H=10,
    32 sweeps, warm slot carried): host clock over 20 calls cycling over 8
    perturbed states (bench.py:374-409), against the 10 ms MPC budget."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.mpc import ci_mpc

    t0 = phase("CI policy latency: A1, B=1, H=10, 32 sweeps, warm")
    f32 = torch.float32
    params = a1_params(f32, dev)
    policy = ci_mpc.make_ci_walk_policy(params, velx=CI_VELX, horizon=10,
                                        iters=32)
    x = torch.zeros(40, dtype=f32, device=dev)
    x[2] = 0.3
    x[6:18] = params.default_foot_pos.reshape(-1)
    x[18] = CI_VELX
    x[36:40] = 30.0
    out0, warm = policy(x, 0.0, policy.warm_init(f32, dev))
    check(bool(torch.isfinite(out0).all()), "CI policy: non-finite output")
    variants = [(x + 1e-4 * k, 0.01 * k, warm) for k in range(8)]
    with launch_counts() as launches:
        ms = host_ms(lambda xx, tt, w: policy(xx, tt, w)[0], variants,
                     reps=20)
    check_launched(launches, ("ci_sweeps",), "CI B=1 policy")
    print(f"   ci_tick_latency_ms_b1 = {ms:.3f} ({card}; MPC-thread budget "
          "10 ms)", flush=True)
    done(t0)
    return ms


def phase_ci_terrain(dev, card):
    """The box-step terrain of tests/test_ci_mpc.py:187-189 (3 cm box at
    x 0.2-2.4 m), A1, B=256, 48 sweeps, velx 0.12: 20 standing and 40
    walking ticks untimed, then 10 timed; every backward stage solves its
    gains on K4 + K6. The batch starts at the origin with its feet on the
    surface, the front feet 3 cm short of the box's top (on the edge's
    bilinear ramp). Gated on finite, upright, forward progress and the
    front feet stepping onto the box."""
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod

    t0 = phase(f"CI box-step terrain: A1, B={CI_B}, 48 sweeps, 20 standing "
               "+ 40 walking + 10 timed ticks")
    box = terrain_mod.add_box(terrain_mod.flat(extent=3.0, cell=0.05,
                                               dtype=torch.float32,
                                               device=dev), **BOX)
    st = ci_roll(ci_setup(dev, CI_B, 48, velx=0.12, terrain=box, mode=0),
                 20)
    x_stand = st["loop"].sim.pos[:, 0].clone()
    st["loop"] = set_mode(st["loop"], 1)
    ci_roll(st, 40, t0=0.2)
    torch.cuda.synchronize()
    with launch_counts() as launches:
        t1 = time.perf_counter()
        ci_roll(st, 10, t0=0.6)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t1
    check_launched(launches, ("chol_factor", "chol_solve_multi"),
                   "CI terrain")
    check(launches.get("ci_sweeps", 0) == 0,
          "the terrain path launched the flat-only kernel K7")
    sim = st["loop"].sim
    pos = sim.pos
    check(bool(torch.isfinite(pos).all()), "CI terrain: non-finite")
    dx = pos[:, 0] - x_stand
    z = pos[:, 2]
    # a foot on the box: anchored in contact where the sim's touchdown put
    # it on the box's top (a sim blind to the height field anchors at 0)
    top = 0.9 * BOX["height"]
    on_box = (sim.contact & (sim.anchor[..., 2] >= top)
              & (terrain_mod.height_at(box, sim.anchor[..., :2]) >= top))
    share = float(on_box.any(-1).float().mean())
    print(f"   z in [{float(z.min()):.4f}, {float(z.max()):.4f}]; x progress "
          f"over 50 walking ticks: mean {float(dx.mean()):.4f} m, min "
          f"{float(dx.min()):.4f} m; share of scenarios with a foot on the "
          f"box {share:.3f}; launches a tick: K4 "
          f"{launches.get('chol_factor', 0) / 10:.0f}, K6 "
          f"{launches.get('chol_solve_multi', 0) / 10:.0f}", flush=True)
    check(float(z.min()) > 0.15, "CI terrain: scenarios fell")
    check(float(dx.mean()) > TERRAIN_PROGRESS_MIN,
          f"CI terrain: mean progress {float(dx.mean())} m")
    check(float(dx.min()) > 0.0, "CI terrain: a scenario backed off")
    check(share >= TERRAIN_ON_BOX_SHARE,
          f"CI terrain: {share} of the scenarios have a foot on the box")
    rate = CI_B * 10 / elapsed
    print(f"   ci_closed_loop_terrain_b256 = {rate:.1f} ({card}; diagnostic, "
          f"real-time bar {CI_B * 100}); {elapsed / 10 * 1e3:.1f} ms a tick",
          flush=True)
    done(t0)
    return launches, rate, st


def phase_k6(dev, card, st):
    """Kernels K4 and K6 on the gain solve of one backward stage of the
    walked-in box-step solve at B=256, Quu_r and [Qu | Qux_r] as the terrain
    path hands them over: K6 against its plain version on K4's factor, and
    the path's K4 + K6 against the plain path (`cholesky_plain`, then
    `cho_solve_multi_plain`)."""
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    t0 = phase(f"K6 chol_solve_multi vs plain, B={CI_B}, n=24, m=25, a "
               "box-step backward stage")
    seen = {"n": 0}
    factor, solve = chol_kernel.cholesky_cuda, chol_kernel.cho_solve_multi_cuda
    pick = K6_PICK

    def cap_factor(A):
        if seen["n"] == pick:
            seen["A"] = A.clone()
        return factor(A)

    def cap_solve(F, R):
        if seen["n"] == pick:
            seen["R"] = R.clone()
        seen["n"] += 1
        return solve(F, R)
    with patched(chol_kernel, cholesky_cuda=cap_factor,
                 cho_solve_multi_cuda=cap_solve):
        ci_roll(dict(st), 1, t0=0.7)
    A, R = seen["A"], seen["R"]
    n, m = R.shape[1], R.shape[2]
    F = chol_kernel.cholesky_cuda(A)                # K4, as the path runs it
    Fp = chol_kernel.cholesky_plain(A)
    X = chol_kernel.cho_solve_multi_cuda(F, R)      # the path: K4 + K6
    X6p = chol_kernel.cho_solve_multi_plain(F, R)   # K6's plain version
    Xp = chol_kernel.cho_solve_multi_plain(Fp, R)   # the plain path
    torch.cuda.synchronize()
    L64, info = torch.linalg.cholesky_ex(A.double())
    pivot = torch.where(
        info == 0, (L64.diagonal(dim1=-2, dim2=-1) ** 2
                    / A.double().diagonal(dim1=-2, dim2=-1)).amin(-1),
        torch.zeros_like(L64[:, 0, 0]))
    robust = pivot >= ROBUST_PIVOT
    n_rob = int(robust.sum())
    check(n_rob > 0.9 * CI_B, f"K6: only {n_rob} robust matrices")
    check(bool(torch.isfinite(F[robust]).all()),
          "K4 at n=24: a robust matrix not factored")
    check(bool(torch.isfinite(X[robust]).all()), "K4 + K6: non-finite")
    Ad = A.double()

    def factor_backward(F):
        L = F.double().tril()
        r = (L @ L.mT - Ad).abs().amax((-1, -2))
        return float((r / Ad.abs().amax((-1, -2)))[robust].max())

    def solve_backward(x):
        r = (Ad @ x.double() - R.double()).abs().amax((-1, -2))
        scale = (Ad.abs().sum(-1).amax(-1)
                 * x.double().abs().amax((-1, -2)))
        return float((r / scale)[robust].max())

    def rel(x, y):
        return float(((x - y).abs().amax((-1, -2))
                      / y.abs().amax((-1, -2)))[robust].max())
    rf, rfp = factor_backward(F), factor_backward(Fp)
    rk, rp = solve_backward(X), solve_backward(Xp)
    rel6, rel_path, rel4 = rel(X, X6p), rel(X, Xp), rel(F.tril(), Fp.tril())
    err = float((X - X6p)[robust].abs().max())
    err4 = float((F - Fp).tril()[robust].abs().max())
    print(f"   {n_rob} of {CI_B} matrices with robust pivots. K4: backward "
          f"error {rf:.3e} (plain {rfp:.3e}), max |F - F_plain| {err4:.3e},"
          f" relative {rel4:.3e}. K6 on K4's factor: max |X - X_plain| "
          f"{err:.3e}, relative {rel6:.3e}. K4 + K6 against the plain path:"
          f" backward error {rk:.3e} (plain {rp:.3e}), relative "
          f"{rel_path:.3e} (tol {K6_REL_TOL}; backward tol {BACKWARD_TOL})",
          flush=True)
    check(rf <= BACKWARD_TOL and rf <= 4 * rfp + 1e-6,
          f"K4 at n=24: backward error {rf} vs {rfp}")
    check(rk <= BACKWARD_TOL and rk <= 4 * rp + 1e-6,
          f"K4 + K6: backward error {rk} vs {rp}")
    check(rel6 <= K6_REL_TOL, f"K6: differs by {rel6}")
    check(rel_path <= K6_REL_TOL,
          f"K4 + K6: differ from the plain path by {rel_path}")
    Lp = F.tril()
    ms = cuda_ms(lambda: chol_kernel.cho_solve_multi_cuda(F, R), reps=20)
    plain_ms = cuda_ms(lambda: chol_kernel.cho_solve_multi_plain(F, R),
                       reps=5)
    lib_ms = cuda_ms(lambda: torch.cholesky_solve(R, Lp), reps=5)
    b_ms, b_by = bound(CI_B * (tri(n) + 2 * n * m) * 4, CI_B * 2 * n * n * m)
    # K4 at this path's shape (its row in the kernels line is the PDIP one)
    ms4 = cuda_ms(lambda: chol_kernel.cholesky_cuda(A), reps=20)
    plain4 = cuda_ms(lambda: chol_kernel.cholesky_plain(A), reps=5)
    lib4 = cuda_ms(lambda: torch.linalg.cholesky_ex(A), reps=5)
    b4 = bound(CI_B * tri(n) * 2 * 4, CI_B * n ** 3 / 3)
    print(f"   time ({card}): K6 kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, torch.cholesky_solve {lib_ms:.4f} ms; bound {b_ms:.5f} ms "
          f"({b_by}); K4 at n={n}: kernel {ms4:.4f} ms (max |F - F_plain| "
          f"{err4:.3e}), plain {plain4:.4f} ms, torch.linalg.cholesky_ex "
          f"{lib4:.4f} ms (x{lib4 / ms4:.2f} the kernel's time), bound "
          f"{b4[0]:.5f} ms ({b4[1]})", flush=True)
    done(t0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device available")
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    card = phase_build()
    print(card, flush=True)
    k1 = phase_k1(dev, card)
    k2 = phase_k2(dev, card)
    k3 = phase_k3(dev, card)
    chol = phase_chol(dev, card)
    launches, rate, solves, walked = phase_main(dev, card)
    k3_launches, rate_kf1 = phase_kf1(dev, card)
    loops = phase_condensed(dev, card, walked)
    phase_condensed_rate(dev, card)
    phase_latency(dev, card)
    ci_launches, ci_rate, ci_state = phase_ci_loop(dev, card)
    k7 = phase_k7(dev, card, ci_state)
    phase_ci_latency(dev, card)
    terrain_launches, _, terrain_state = phase_ci_terrain(dev, card)
    k6 = phase_k6(dev, card, terrain_state)
    print(f"== all phases passed in {time.perf_counter() - t_all:.1f} s",
          flush=True)
    # the main path's shape, B=4096 and n=120, on the early matrices: the
    # late ones' non-finite factors send the library solve down a path
    # whose time varied 1.7-95 ms between runs
    timed = chol["early"]
    pdip_launches = loops["pdip"]["launches"]

    def row(name, source, replaces, n, err, ms, plain_ms, bnd, lib_ms):
        return {"name": name, "route": "cuda", "source": CSRC + source,
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": lib_ms}

    kernels = {"kernels": [
        row("riccati_ipm", "riccati_ipm.cu", REPO_K1,
            launches["riccati_ipm"], max(k1[10]["err"], k1[30]["err"]),
            k1[10]["ms"], k1[10]["plain_ms"],
            (k1[10]["bound_ms"], k1[10]["bound_by"]), None),
        row("substep_chain", "substep_chain.cu", REPO_K2,
            launches["substep_chain"], k2["err"], k2["ms"], k2["plain_ms"],
            (k2["bound_ms"], k2["bound_by"]), None),
        row("substep_chain_kf1", "substep_chain.cu", REPO_K3, k3_launches,
            k3["err"], k3["ms"], k3["plain_ms"],
            (k3["bound_ms"], k3["bound_by"]), None),
        row("chol_factor", "chol_factor.cu", REPO_K4,
            pdip_launches["chol_factor"],
            max(chol[c]["err4"] for c in WELL_CONDITIONED), timed["ms4"],
            timed["plain4"], timed["bound4"], timed["lib4"]),
        row("chol_solve", "chol_lanes.cu", REPO_K5,
            pdip_launches["chol_solve"],
            max(chol[c]["err5"] for c in WELL_CONDITIONED), timed["ms5"],
            timed["plain5"], timed["bound5"], timed["lib5"]),
        row("chol_solve_multi", "chol_lanes.cu", REPO_K6,
            terrain_launches["chol_solve_multi"], k6["err"], k6["ms"],
            k6["plain_ms"], (k6["bound_ms"], k6["bound_by"]), k6["lib_ms"]),
        row("ci_sweeps", "ci_sweeps.cu", REPO_K7, ci_launches["ci_sweeps"],
            k7["err"], k7["ms"], k7["plain_ms"],
            (k7["bound_ms"], k7["bound_by"]), None)]}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
