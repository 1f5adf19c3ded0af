"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every hand-written CUDA kernel of the port from
legged_mpc_control_tpu_torch/csrc with nvcc (sm_90a, one nvcc per source,
all at once; K1's two, K4's three, K5/K6's five and K7's two variants
and the ADMM step kernel must show no stack frame and no spills), holds
each against its plain PyTorch version at its path's shapes (K1 at H=10
and H=30, and at the loop's own call, iters=4 warm; K4 and K5 at n=120
with B=4096 and B=1, n=360, n=24 (K4); the ADMM step kernel at n=360,
B=4096 in both its launch modes), then drives the paths of the
batched Go1 trot closed loop (`parallel/runner.make_batched_rollout`)
through their quality gates and times them at B=4096: Riccati with kf_type
0 (kernels K1, K2) and 1 (K1, K3), and the condensed PDIP and ADMM solvers
(K4, K5, K2; the ADMM step kernel after each K5 solve); then the
condensed solve rate and the B=1 solve latencies. Then the contact-implicit
MPC (`control/step.closed_loop_tick_lci_batched`, A1, B=256): the flat
closed loop (K7, K2) with its 24-vs-48-sweep gate, K7 against its plain
version at B=256 (24 sweeps) and B=1 (32 sweeps), both K7 variants'
resident blocks an SM and, at B=4096, the batch variant bit for bit the
latency variant and both timed, the B=1 CI policy latency (K7), and the
box-step terrain loop (K4,
K6) with K4 + K6 against the plain path. Then BASELINE config 4: the H=30
solve rate (K1) and the convex closed loop on a height field (A1, B=64,
standing_trot, H=30; the platform and the stairs of
tests/test_terrain_walk.py; K1 every tick, the per-substep loop, no K2);
and the single-robot tick (`control/step.closed_loop_tick`, the condensed
PDIP on K4 and K5 at B=1) walking dynamic_walk and static_walk as
tests/test_walk_gaits.py does. Then the articulated twin, the EKF and the
WBC: the gate runs side by side in three processes (the twin's batched
loop `runner.make_batched_rollout_wb` at B=256 on tests/test_wb_batched.py's
recipe, K1 once and K4 + K5 32 times each a tick at n=18; the kf_type-2
loop at B=64 with the estimator limits of bench.py:221-222; the WBC stand
of one robot, `closed_loop_tick_wb` with low_level_type 1), then the
twin's loop timed at B=256, K4 + K5 against their plain versions on its
walked batch's mass matrices, the kf_type-2 loop timed at B=4096 and the
WBC stand's tick timed. Then the rest of the contact-implicit MPC, one
robot each, its gate runs in four more processes beside the seven: the
wall lean of tests/test_ci_wall_lean.py on the twin for Go1 and A1
(`step.closed_loop_tick_lci_wb(wall=...)`, `make_ci_lean_policy`, 250
ticks: K4 + K6 240 times a tick at n=24, K4 + K5 32 times at n=18), the
`--mpc lci` walk of tests/test_lci.py (`step.closed_loop_tick_lci`,
`make_walk_policy`: K4 12 and K5 24 times a tick at n=96) and the flat CI
walk of tests/test_ci_mpc.py (`make_ci_walk_policy`, K7 at B=1 once a
tick); then the two walks' ticks timed alone, K4 + K6 against their plain
versions on the lean's own gain systems and on a batched wall solve (and
that whole solve, "lanes" against "plain"), and K4 + K5 at n=96, B=1 on
the LCI walk's own QPs against plain and float64. The CLI
(`python -m legged_mpc_control_tpu_torch`, `main.main`) runs its three
`--mpc` paths in three more processes beside those gate runs (convex: K4 +
K5 at B=1, 15 and 30 a tick; lci: K4 12 and K5 24 a walking tick at
n=96; ci: K7 once a walking tick), with `--bag` read back, and a fourth
process runs it with `--profile` and once as a real subprocess. The batched
CI closed loop on estimated state and with the WBC runs in four more
(`closed_loop_tick_lci_batched`, A1, 20 standing ticks while a filter
settles, then walking): kf_type 1 and 2 at B=256 (the per-substep loop, K7
once a tick), low_level_type 1 at B=32 (the WBC), and kf_type 0 with
`fused_substeps=False` at B=32 beside the fused run (K7 + K2) from the
same start, held to the JAX package's upright share and bench.py's
estimator and fused-vs-unfused rules. Last,
BASELINE config 5, the 65,536-scenario Go1 sweep (`parallel/
distributed.make_sweep`, K1 + K2 once a tick): two reps and a sharded
checkpoint, a resumed run that must equal an uninterrupted rep bit for
bit, K1 and K2 against their plain versions at B=65,536 on the sweep's
first-tick inputs, then `python -m legged_mpc_control_tpu_torch.sweep` in
two processes on the one card (Gloo) against the one-process metrics, and
its weak-scaling report (efficiency >= 0.85). Exits non-zero on any
failure and when no CUDA device is present. Diagnostics go to the earlier
lines; the second-to-last line is a JSON object of the kernels, the last
line {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
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
# the ADMM step kernel replaces no Pallas kernel: the JAX package runs the
# iteration as jnp ops here
REPO_ADMM = "legged_mpc_control_tpu/mpc/admm.py (jnp ops, no Pallas kernel)"
# nor does the condensed QP's build: a dense product in the JAX package
REPO_CONDENSE = ("legged_mpc_control_tpu/mpc/qp_builder.py (jnp ops, no "
                 "Pallas kernel)")
CSRC = "legged_mpc_control_tpu_torch/csrc/"

# the least time an H100 SXM could take (its datasheet peaks): bytes
# over 3.35 TB/s, float32 operations over 67 TFLOP/s (outside the tensor
# cores; these kernels do scalar float32 work)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12          # H100 SXM, float64 outside the tensor cores


def bound(nbytes, flops, flops64=0):
    """(bound_ms, bound_by) of work moving `nbytes` and doing `flops`
    float32 and `flops64` float64 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + flops64 / F64_FLOP_PER_S) * 1e3
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
# of which the factor sweep's, float64 for H >= 14
K1_FACTOR_FLOP_PER_STAGE_ITER = 2 * (8 * 12 ** 3 + 12 ** 3 // 6)
K1_F64_MIN_H = 14
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


# The ADMM step kernel (csrc/admm_step.cu), per (scenario, step, leg): an
# update reads x_t, x, q~ (3 each), y, h~ (6 each), G~ (18) and writes x,
# z, y (3 + 6 + 6) and the next right-hand side (3), 57 floats; its
# operations are the relaxation (9), six constraint rows (10 each: the
# 3-term product, the division, the clip's sum, the dual step) and the
# right-hand side (54: w = rho z - y, the 6-term G~^T w, sigma x - q~).
# The first launch of a solve (rhs only) reads x, q~ (3 each), z, y (6
# each), G~ (18) and writes the right-hand side, 39 floats.
ADMM_FLOATS_PER_LEG = 57
ADMM_FLOP_PER_LEG = 9 + 6 * 10 + 54
ADMM_FIRST_FLOATS_PER_LEG = 39
ADMM_FIRST_FLOP_PER_LEG = 54
# one launch against the plain step's torch operations on the card: within
# this share of each output's largest entry (tests/test_torch_cuda.py's
# test_admm_step_kernel_matches_plain_step): one step of float32
# roundings, where cuBLAS's products sum with FMAs and the plain step
# divides by rho as a product with its reciprocal
ADMM_STEP_REL_TOL = 2e-6
# the ADMM cell's (go1_admm_h30.b4096): H=30, rho 1e-3, 30 iterations
ADMM_H, ADMM_RHO, ADMM_ITERS = 30, 1e-3, 30


def condense_work(batch, H):
    """(bytes, float64 operations) of the build kernel (csrc/condense.cu):
    it reads x0, x_ref, A_0 whole and A_k[0:3, 6:9] of the later steps, Bm's
    rows 6:12, contact and the two weight rows, and writes P and q once a
    scenario. Its operations a scenario: A_0 x0 (288), Mc's running sums
    (9 (k + 1) a step k); for each block pair j1 <= j2 W (99 a step k >= j2:
    three rows of three sums, a term each two differences, a product and an
    FMA), V (18 a column) and the upper triangle's entries (11 each: a
    product and five FMAs); q's residual sums (48 a step k >= j) and q (48
    an entry)."""
    n = 12 * H
    nbytes = batch * 4 * (12 + n + 144 + 9 * (H - 1) + 72 + 4 * H + 24
                          + n * n + n)
    ops = 288 + 9 * H * (H + 1) // 2 + 48 * n
    for j2 in range(H):
        ops += 48 * (H - j2)
        for j1 in range(j2 + 1):
            ops += 99 * (H - j2) + 18 * 12 + 11 * (144 if j1 < j2 else 78)
    return nbytes, batch * ops


# the build kernel against the plain build in float64 on the same float32
# inputs (tests/test_torch_cuda.py's test_condense_kernel_matches_plain):
# every P entry within CONDENSE_ULPS float32 ulps of itself plus
# CONDENSE_REL of the matrix's largest entry, q within CONDENSE_Q_REL
CONDENSE_ULPS, CONDENSE_REL, CONDENSE_Q_REL = 2, 1e-9, 1e-6


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
# K1's instantiations by the place of its per-stage store and the type of
# its factor sweep (mangled riccati_ipm_kernel<SMEM, F64>,
# csrc/riccati_ipm.cu)
K1_VARIANTS = ("riccati_ipm_kernelILb1ELb0E", "riccati_ipm_kernelILb1ELb1E",
               "riccati_ipm_kernelILb0ELb0E", "riccati_ipm_kernelILb0ELb1E")
# K2 and K3 (mangled substep_chain_kernel<KF1>, csrc/substep_chain.cu)
K23_VARIANTS = ("substep_chain_kernelILb0E", "substep_chain_kernelILb1E")
# K5's three variants (staged triangle, streamed rows, the ring for any n)
# and K6's two (X in registers at n=24, in shared memory otherwise),
# csrc/chol_lanes.cu
K56_VARIANTS = ("chol_solve_tri", "chol_solve_stream", "chol_solve_ring",
                "chol_solve_multi_regs", "chol_solve_multi_smem")
# K7's batch and latency variants (csrc/ci_sweeps.cu), the batch variant's
# name first: the latency variant's is a prefix of it
K7_VARIANTS = ("ci_sweeps_batch", "ci_sweeps")
# sources whose every kernel must build with no stack frame and no spills
# (K2/K3: no spills; sinf/cosf keep the words of their large-argument range
# reduction in a 32-byte stack frame)
NO_SPILLS = "0 bytes spill stores, 0 bytes spill loads"
GATED = {"riccati_ipm": ("K1", K1_VARIANTS),
         "substep_chain": ("K2/K3", K23_VARIANTS),
         "chol_factor": ("K4", K4_VARIANTS),
         "chol_lanes": ("K5/K6", K56_VARIANTS),
         "ci_sweeps": ("K7", K7_VARIANTS),
         "admm_step": ("ADMM step", ("admm_step_kernel",)),
         "condense": ("condense", ("condense_kernel",))}


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
               "ci_sweeps", "admm_step", "condense")
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
            want = (NO_SPILLS if src == "substep_chain"
                    else "0 bytes stack frame, " + NO_SPILLS)
            check(any(want in ln for ln in lines),
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
        f64 = K1_FACTOR_FLOP_PER_STAGE_ITER if horizon >= K1_F64_MIN_H else 0
        b_ms, b_by = bound(
            B * 4 * (NX_IN_K1(horizon) + NX_OUT_K1(horizon)),
            B * horizon * 15 * (K1_FLOP_PER_STAGE_ITER - f64),
            B * horizon * 15 * f64)
        print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} "
              f"ms per cold solve; bound {b_ms:.3g} ms ({b_by})", flush=True)
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
                  f"{ms4:.3f} ms; bound {b4[0]:.3g} ms ({b4[1]}); "
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


def chain_gate(label, got, want):
    """K2's or K3's outputs against the plain version's: the same contacts
    in every scenario, every row within its bracket. Returns the largest
    state error."""
    from legged_mpc_control_tpu_torch.ops import substep_kernel

    n = got["pos"].shape[0]
    flips = int((got["contact"] != want["contact"]).any(-1).sum())
    print(f"   B={n}: scenarios whose contacts differ: {flips}", flush=True)
    check(flips == 0, f"{label} B={n}: contacts differ in {flips} scenarios")
    err = 0.0
    kf = {**KF_TOL} if "kf_x" in got else {}
    for name, tol in {**STATE_TOL, **kf}.items():
        e = float((got[name] - want[name]).abs().max())
        check(bool(torch.isfinite(got[name]).all()),
              f"{label} B={n} {name} non-finite")
        print(f"   B={n} {name}: max err {e:.3e} (tol {tol})", flush=True)
        check(e <= tol, f"{label} B={n} {name}: {e} > {tol}")
        err = max(err, e)
    if kf:
        atol, rtol = KF_P_TOL
        dP = (got["kf_P"] - want["kf_P"]).abs()
        over = float((dP - rtol * want["kf_P"].abs()).max())
        print(f"   B={n} kf_P: max err {float(dP.max()):.3e} (tol {atol} + "
              f"{rtol} relative)", flush=True)
        check(over <= atol, f"{label} B={n} kf_P: {over} over the bracket")
    for name, (off, m) in substep_kernel.FB_ROWS.items():
        e = float((got["fb"][:, off:off + m]
                   - want["fb"][:, off:off + m]).abs().max())
        check(e <= FB_TOL[name], f"{label} B={n} fb {name}: {e} > "
              f"{FB_TOL[name]}")
    return err


def chain_b256(label, args, kw):
    """K2 or K3 on the first 256 scenarios of the batch (the CI loop's
    batch size) against the plain version; returns the kernel's ms."""
    from legged_mpc_control_tpu_torch.ops import substep_kernel

    a = tuple(x[:256] if torch.is_tensor(x) and x.dim() else x for x in args)
    k = {n: (v[:256] if torch.is_tensor(v) else v) for n, v in kw.items()}
    chain_gate(label, substep_kernel.substep_chain_cuda(*a, **k),
               substep_kernel.substep_chain_plain(*a, **k))
    return cuda_ms(lambda: substep_kernel.substep_chain_cuda(*a, **k),
                   reps=20)


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
    err = chain_gate("K2", got, want)
    ms = cuda_ms(lambda: substep_kernel.substep_chain_cuda(*args, **kw),
                 reps=20)
    plain_ms = cuda_ms(lambda: substep_kernel.substep_chain_plain(*args, **kw),
                       reps=3)
    ms256 = chain_b256("K2", args, kw)

    def k2_bound(b):
        return bound(b * 4 * (substep_kernel.N_IN + 1 + substep_kernel.N_OUT),
                     b * (8 * K2_FLOP_PER_SUBSTEP + K2_FLOP_TAIL))
    (b_ms, b_by), (b256, b256_by) = k2_bound(B), k2_bound(256)
    print(f"   time ({card}): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
          f"per 8-substep chain; bound {b_ms:.3g} ms ({b_by}); kernel "
          f"{ms256:.4f} ms at B=256, bound {b256:.3g} ms ({b256_by})",
          flush=True)
    done(t0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, ms_b256=ms256, bound_ms_b256=b256)


def phase_main(dev, card):
    """The main path: gates at B=64 x 120 ticks (bench.py:120-154 on the
    port), then 10 timed walking ticks at B=4096 and the solve rate."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait
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

    solves = solve_rate(dev, card, 10)
    return launches, rate, solves, walked


# the stance load of the synthetic trot batch: the mean over the batch of
# the stage-0 vertical forces' sum, as a share of the robot's weight
STANCE_LOAD = (0.7, 1.3)


def solve_rate(dev, card, horizon):
    """convex_mpc_solves_per_s_per_chip_go1_trot_h{horizon}: linearize + K1
    on the synthetic Go1 trot QP batch (bench.py:59-75), B=4096, iters=15,
    over 8 calls of 4 variants; gated on finite forces and a plausible
    stance load."""
    from legged_mpc_control_tpu_torch.mpc import riccati

    t0 = phase(f"solve rate: linearize + K1, B={B}, H={horizon}, iters=15")
    qparams, x0, contact, lin = qp_problem(B, horizon, dev)
    variants = [x0 + 1e-3 * k for k in range(4)]

    def solve(x):
        x_ref, A_seq, Bm = lin(x)
        return riccati.solve_qp_riccati(
            x, x_ref, A_seq, Bm, contact, qparams.q_weights,
            qparams.r_weights, qparams.mu, qparams.fz_max, DT, iters=15,
            diagnostics=False).u[:, :12]

    out = solve(variants[0])
    check(bool(torch.isfinite(out).all()), "non-finite GRFs")
    load = float(out[:, 2::3].sum(-1).mean() / (qparams.mass * 9.8))
    print(f"   stance load: mean sum of fz {load:.3f} x m g", flush=True)
    check(STANCE_LOAD[0] < load < STANCE_LOAD[1],
          f"implausible stance load {load} x m g")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(8):
        out = solve(variants[i % 4])
    torch.cuda.synchronize()
    solves = B * 8 / (time.perf_counter() - t1)
    print(f"   convex_mpc_solves_per_s_per_chip_go1_trot_h{horizon} = "
          f"{solves:.1f} ({card})", flush=True)
    done(t0)
    return solves


def phase_admm_step(dev, card):
    """The ADMM step kernel against its plain version at the ADMM cell's
    shape (B=4096, H=30, n=360, rho 1e-3): the inputs of the tenth update
    of a 30-iteration cold ADMM solve of the synthetic trot QP, captured at
    the call; both launch modes (an update with the next right-hand side,
    and the first right-hand side alone) held to ADMM_STEP_REL_TOL of each
    output's largest entry, then timed with CUDA events."""
    from legged_mpc_control_tpu_torch.mpc import admm, qp_builder
    from legged_mpc_control_tpu_torch.ops import admm_kernel

    t0 = phase(f"ADMM step kernel vs plain, B={B}, H={ADMM_H}, n="
               f"{12 * ADMM_H}, inputs of a cold solve's tenth update")
    params, x0, contact, lin = qp_problem(B, ADMM_H, dev)
    x_ref, A_seq, Bm = lin(x0)
    qp = qp_builder.build_condensed_qp(
        x0, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, DT)
    seen = []
    step = admm_kernel.admm_step

    def capture(*a, **kw):
        if a[0] is not None:
            seen.append((a, kw))
        return step(*a, **kw)

    with patched(admm_kernel, admm_step=capture):
        admm.solve_qp_admm_batched(qp.P, qp.q, qp.mu, qp.fz_max, qp.contact,
                                   iters=10, rho=ADMM_RHO)
    a, kw = seen[-1]
    modes = {"update + rhs": a, "rhs only": (None, *a[1:])}
    err = {}
    for mode, args in modes.items():
        got = admm_kernel.admm_step(*args, **kw)
        want = admm_kernel.admm_step_plain(*args, **kw)
        torch.cuda.synchronize()
        rel = []
        for name, g, w in zip(("x", "z", "y", "rhs"), got, want):
            check(bool(torch.isfinite(g).all()),
                  f"ADMM step ({mode}): non-finite {name}")
            d = float((g - w).abs().max())
            rel.append(d / float(w.abs().max()))
            err[mode] = max(err.get(mode, 0.0), d)
        print(f"   {mode}: max |kernel - plain| / max |plain| of x, z, y, "
              f"rhs: " + ", ".join(f"{r:.3e}" for r in rel), flush=True)
        check(max(rel) <= ADMM_STEP_REL_TOL,
              f"ADMM step ({mode}): {max(rel)} of the largest entry")
    legs = B * ADMM_H * 4
    out = dict(
        err=max(err.values()),
        ms=cuda_ms(lambda: admm_kernel.admm_step(*a, **kw), reps=50),
        plain_ms=cuda_ms(lambda: admm_kernel.admm_step_plain(*a, **kw),
                         reps=5),
        bound=bound(legs * ADMM_FLOATS_PER_LEG * 4,
                    legs * ADMM_FLOP_PER_LEG),
        ms_first=cuda_ms(lambda: admm_kernel.admm_step(None, *a[1:], **kw),
                         reps=50),
        plain_ms_first=cuda_ms(
            lambda: admm_kernel.admm_step_plain(None, *a[1:], **kw),
            reps=5),
        bound_first=bound(legs * ADMM_FIRST_FLOATS_PER_LEG * 4,
                          legs * ADMM_FIRST_FLOP_PER_LEG))
    print(f"   time ({card}): update + rhs: kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound'][0]:.4f} ms "
          f"({out['bound'][1]}; the kernel at "
          f"{100 * out['bound'][0] / out['ms']:.1f} % of it); rhs only: "
          f"kernel {out['ms_first']:.4f} ms, plain "
          f"{out['plain_ms_first']:.4f} ms, bound "
          f"{out['bound_first'][0]:.4f} ms ({out['bound_first'][1]})",
          flush=True)
    done(t0)
    return out


def phase_condense(dev, card):
    """The condensed QP's build kernel against the plain build in float64
    at the ADMM cell's shape (B=4096, H=30, n=360) on the synthetic trot
    QP: CONDENSE_ULPS / CONDENSE_REL on P, P exactly symmetric,
    CONDENSE_Q_REL on q; then the kernel and the plain float32 build timed
    with CUDA events."""
    from legged_mpc_control_tpu_torch.ops import condense_kernel

    t0 = phase(f"condense kernel vs plain float64, B={B}, H={ADMM_H}, n="
               f"{12 * ADMM_H}")
    params, x0, contact, lin = qp_problem(B, ADMM_H, dev)
    x_ref, A_seq, Bm = lin(x0)
    args = (x0, x_ref, A_seq, Bm, contact, params.q_weights,
            params.r_weights, DT)
    with launch_counts() as launches:
        P, q = condense_kernel.condense(*args)
    check(launches == {"condense": 1}, f"condense: launches {launches}")
    check(bool(torch.isfinite(P).all()) and bool(torch.isfinite(q).all()),
          "condense: non-finite P or q")
    check(torch.equal(P, P.transpose(-1, -2)), "condense: P not symmetric")
    ulps = err = qrel = 0.0
    for lo in range(0, B, 512):
        P64, q64 = condense_kernel.condense_plain(
            *(t[lo:lo + 512].double() for t in args[:5]),
            params.q_weights.double(),
            params.r_weights.double(), DT)
        d = (P[lo:lo + 512].double() - P64).abs()
        a = P64.abs().float()
        ulp = (torch.nextafter(a, torch.full_like(a, float("inf")))
               - a).double()
        top = P64.abs().amax((-1, -2), keepdim=True)
        check(bool((d <= CONDENSE_ULPS * ulp + CONDENSE_REL * top).all()),
              "condense: P off the float64 build")
        ulps = max(ulps, float((d / ulp).max()))
        err = max(err, float(d.max()))
        dq = (q[lo:lo + 512].double() - q64).abs()
        qrel = max(qrel, float((dq / (q64.abs()
                                      + 1e-30 * float(q64.abs().max())))
                               .max()))
        check(bool((dq <= CONDENSE_Q_REL * q64.abs()
                    + 1e-9 * float(q64.abs().max())).all()),
              "condense: q off the float64 build")
        del P64, q64, d, a, ulp
    print(f"   max |P - P64| {ulps:.3f} float32 ulps ({err:.3e}); max "
          f"|q - q64| / |q64| {qrel:.3e}", flush=True)
    del P, q
    nbytes, ops64 = condense_work(B, ADMM_H)
    out = dict(err=err,
               ms=cuda_ms(lambda: condense_kernel.condense(*args), reps=20),
               plain_ms=cuda_ms(
                   lambda: condense_kernel.condense_plain(*args), reps=3),
               bound=bound(nbytes, 0, ops64))
    print(f"   time ({card}): kernel {out['ms']:.4f} ms, plain float32 "
          f"{out['plain_ms']:.3f} ms, bound {out['bound'][0]:.4f} ms "
          f"({out['bound'][1]}; {nbytes / 1e9:.3f} GB, {ops64 / 1e9:.2f} "
          f"GFLOP float64; the kernel at "
          f"{100 * out['bound'][0] / out['ms']:.1f} % of it)", flush=True)
    done(t0)
    return out


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
    err = chain_gate("K3", got, want)
    ms = cuda_ms(lambda: substep_kernel.substep_chain_cuda(*args, **kw),
                 reps=20)
    plain_ms = cuda_ms(lambda: substep_kernel.substep_chain_plain(*args, **kw),
                       reps=3)
    ms256 = chain_b256("K3", args, kw)
    n_kf = substep_kernel.N_KF

    def k3_bound(b):
        return bound(b * 4 * (substep_kernel.N_IN + n_kf + 1
                              + substep_kernel.N_OUT + n_kf),
                     b * (8 * K3_FLOP_PER_SUBSTEP + K2_FLOP_TAIL))
    (b_ms, b_by), (b256, b256_by) = k3_bound(B), k3_bound(256)
    print(f"   time ({card}): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms "
          f"per 8-substep chain; bound {b_ms:.3g} ms ({b_by}); kernel "
          f"{ms256:.4f} ms at B=256, bound {b256:.3g} ms ({b256_by})",
          flush=True)
    done(t0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, ms_b256=ms256, bound_ms_b256=b256)


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
# K4 serves n=120 with its mid variant, n=360 with the blocked one, "b=1"
# is the B=1 latency cells' shape and "n=360, B=4096" the benchmark cell
# go1_admm_h30.b4096's (one K4 and 30 K5 a tick)
CHOL_CASES = {"early": (B, 10, 0), "late": (B, 10, 14), "n=360": (512, 30, 0),
              "b=1": (1, 10, 0), "n=360, B=4096": (B, 30, 0)}
# the kernels line's max_abs_err for K4/K5 is the elementwise difference
# from the plain version where every matrix is far from singular (the late
# matrices are held by residuals instead)
WELL_CONDITIONED = ("early", "n=360", "b=1", "n=360, B=4096")


def phase_chol(dev, card):
    """Kernels K4 and K5 vs their plain versions on the Newton matrices of
    a real B=4096, H=10 PDIP solve at an early and a late iteration, and at
    n=360 (H=30, the device-memory path) with B=512 and B=4096 (the
    benchmark's ADMM cell's shape: its factor reads 2.1 GB, its solve
    streams 2.1 GB of factors). Factors are held by
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
    from legged_mpc_control_tpu_torch.ops import chol_kernel, condense_kernel

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
              f"the kernel's time), bound {entry['bound4'][0]:.3g} ms "
              f"({entry['bound4'][1]}); K5 kernel {entry['ms5']:.3f} ms, "
              f"plain {entry['plain5']:.3f} ms, torch.cholesky_solve "
              f"{entry['lib5']:.3f} ms, bound {entry['bound5'][0]:.3g} ms "
              f"({entry['bound5'][1]})", flush=True)
        stats[label] = entry
        done(t0)
    print(f"   K5 chol_solve ({card}): " + "; ".join(
        f"{label} (B={CHOL_CASES[label][0]}, n={12 * CHOL_CASES[label][1]}) "
        f"{e['ms5']:.4f} ms, bound {e['bound5'][0]:.3g} ms, "
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
    # the float64 build is the plain one, by name (the kernel's is float32)
    with with_plain(fro_64), patched(
            condense_kernel, condense=condense_kernel.condense_plain):
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
        check_launched(launches, ("condense", "chol_factor", "chol_solve",
                                  "substep_chain")
                       + (("admm_step",) if solver == "admm" else ()),
                       solver)
        if solver == "admm":
            # a step launch after each K5 solve, one more a solve (K4 once)
            check(launches["admm_step"] == launches["chol_solve"]
                  + launches["chol_factor"],
                  f"admm: {launches['admm_step']} step launches for "
                  f"{launches['chol_solve']} K5 and "
                  f"{launches['chol_factor']} K4 launches")
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
# K7 at B=256 (24 sweeps) and B=1 (32 sweeps) before its batch variant,
# ms (PERF.md's kernel table), which the latency variant keeps; the batch
# the batch variant is timed at (the benchmark's CI cell)
K7_LATENCY_MS = (2.552, 3.001)
K7_BATCH_B = 4096
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


def ci_roll(st, n, t0=0.0, k0=0, **kw):
    """n closed-loop CI ticks of the state dict `st`, in place, the clock at
    t0 + 0.01 (k0 + k) on tick k; `kw` goes to the tick."""
    from legged_mpc_control_tpu_torch.control import step

    loop, lci = st["loop"], st["lci"]
    for k in range(n):
        loop, lci = step.closed_loop_tick_lci_batched(
            loop, lci, st["params"], st["stand"], st["walk"],
            t0 + 0.01 * (k0 + k), terrain=st["terrain"], **kw)
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


def k7_gate(got, a, kw, label, bracket=True):
    """K7's result `got` on the arguments (a, kw) against the plain version
    in float32 (K7_TOL for K7_SHARE of the scenarios) and float64 (the
    kernel's p99 error no more than 1.5x plain's + the tolerance). With
    bracket=False, for a solve whose optimum is flat (two line-search
    candidates may cost the same to a float32 rounding, and then rounding
    picks the trajectory), only the cost is held: every scenario's within
    K7_TOL["cost"] of the float64 solve's. Returns the kernel's largest Z
    error against plain float32."""
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
        check(not bracket or k99 <= 1.5 * q99 + tol,
              f"K7 {label} {name}: p99 {k99} from float64, plain {q99}")
    n_out = int(outside.sum())
    print(f"   {label}: scenarios outside the bracket: {n_out} of {n}",
          flush=True)
    if bracket:
        check(n_out <= (1.0 - K7_SHARE) * n,
              f"K7 {label}: {n_out} of {n} scenarios outside the bracket")
    else:
        worst = float(e64["cost"].max())
        check(worst <= K7_TOL["cost"],
              f"K7 {label}: cost {worst} from float64's")
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
    H = a[1].shape[1]
    floats = (24 + 24 * H + 48 * H + 24 + 4 * H + 1 + 9 + 24 * H
              + 24 * (H + 1) + 1)

    def k7_bound(b, iters):
        return bound(b * floats * 4 + 54 * 4,
                     b * iters * H * K7_FLOP_PER_STAGE_SWEEP)
    (b_ms, b_by), (b1, b1_by) = k7_bound(CI_B, kw["iters"]), k7_bound(1, 32)
    ms1 = cuda_ms(lambda: ci_kernel.ci_sweeps_cuda(*one, **kw1), reps=5)
    print(f"   time ({card}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"per 24-sweep solve; bound {b_ms:.3g} ms ({b_by}); kernel at "
          f"B=1, 32 sweeps {ms1:.3f} ms, bound {b1:.3g} ms ({b1_by}); "
          f"{ms / K7_LATENCY_MS[0]:.3f}x / {ms1 / K7_LATENCY_MS[1]:.3f}x "
          f"the {K7_LATENCY_MS[0]} / {K7_LATENCY_MS[1]} ms of the kernel "
          "before its batch variant", flush=True)
    done(t0)
    big = phase_k7_batch(dev, card, k7_bound,
                         {f"B={CI_B}": (a, kw, ms), "B=1": (one, kw1, ms1)})
    return dict(err=max(err, err1, big.pop("err_b4096")), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ms1=ms1,
                bound_ms_b1=b1, **big)


def phase_k7_batch(dev, card, k7_bound, small):
    """K7's two variants: their resident blocks an SM at H=10 and 12 (the
    occupancy API), and at B=4096 (the benchmark's CI batch, walked in 20
    ticks, 24 sweeps) the dispatch's launch (the batch variant) bit for bit
    the latency variant's and against the plain version (k7_gate), both
    timed beside the bound; the batch variant also timed on phase_k7's
    calls `small` ({label: (args, kw, the latency variant's ms)}), which
    the dispatch leaves to the latency variant."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    t0 = phase(f"K7 batch variant: residency; B={K7_BATCH_B}, H=10, 24 "
               "sweeps, bit for bit the latency variant and against plain, "
               "both timed")
    residency = {H: ci_kernel.residency(dev.index, H) for H in (10, 12)}
    for H, (lat, bat, sms) in residency.items():
        print(f"   H={H}: resident blocks an SM, latency {lat}, batch {bat} "
              f"({sms} SMs: a wave of {lat * sms} / {bat * sms} scenarios)",
              flush=True)
    seen = {}
    kernel = ci_kernel.ci_sweeps_cuda

    def capture(*a, **kw):
        seen["args"] = (a, kw)
        return kernel(*a, **kw)
    st = ci_roll(ci_setup(dev, K7_BATCH_B, 24), 20)
    with patched(ci_kernel, ci_sweeps_cuda=capture):
        ci_roll(st, 1, t0=0.2)
    a, kw = seen["args"]
    prepared = ci_kernel._prepare(*a, **kw)
    latency = ci_kernel._lib().ci_sweeps_launch
    want = ci_kernel._run(latency, prepared)
    with launch_counts() as n:
        got = ci_kernel.ci_sweeps_cuda(*a, **kw)
    check(n == {"ci_sweeps": 1, "ci_sweeps_batch": 1},
          f"K7 B={K7_BATCH_B}: launches {n}, want the batch variant once")
    check(all(torch.equal(x.view(torch.int32), y.view(torch.int32))
              for x, y in zip(got, want)),
          f"K7 B={K7_BATCH_B}: the batch variant differs from the latency "
          "variant")
    err = k7_gate(got, a, kw, f"B={K7_BATCH_B}")
    ms = cuda_ms(lambda: ci_kernel.ci_sweeps_cuda(*a, **kw), reps=5)
    ms_lat = cuda_ms(lambda: ci_kernel._run(latency, prepared), reps=5)
    bound_ms, bound_by = k7_bound(K7_BATCH_B, kw["iters"])
    print(f"   time ({card}): batch variant {ms:.3f} ms, latency variant "
          f"{ms_lat:.3f} ms per 24-sweep solve at B={K7_BATCH_B}; bound "
          f"{bound_ms:.3g} ms ({bound_by}): {100 * bound_ms / ms:.2f} % / "
          f"{100 * bound_ms / ms_lat:.2f} % of it; bit for bit equal",
          flush=True)
    batch = ci_kernel._lib().ci_sweeps_batch_launch
    for label, (sa, skw, lat_ms) in small.items():
        sp = ci_kernel._prepare(*sa, **skw)
        bms = cuda_ms(lambda: ci_kernel._run(batch, sp), reps=5)
        print(f"   {label}: batch variant {bms:.3f} ms, latency variant "
              f"{lat_ms:.3f} ms (the dispatch's)", flush=True)
    done(t0)
    return dict(err_b4096=err, ms_b4096=ms, ms_b4096_latency=ms_lat,
                bound_ms_b4096=bound_ms,
                blocks_per_sm={f"H{H}": r[:2] for H, r in residency.items()})


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


# BASELINE config 4 (tests/test_terrain_walk.py): A1 on a height field,
# standing_trot, H=30, iters=12 warm, 5 standing ticks and 300 walking at
# 0.15 m/s with the terrain-following height command; B=64 scenarios
C4_B, C4_H, C4_ITERS = 64, 30, 12
C4_STAND, C4_WALK, C4_TIMED = 5, 300, 10
C4_VELX = 0.15
C4_PASS_MIN = 61        # 95 % of the batch meets the JAX test's assertions


def c4_terrains(dev):
    """The 3 cm platform and the two stairs of tests/test_terrain_walk.py
    (:71-73, :92-93)."""
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod

    f32 = torch.float32
    return {"platform": terrain_mod.add_box(
                terrain_mod.flat(extent=3.0, cell=0.05, dtype=f32,
                                 device=dev), **BOX),
            "stairs": terrain_mod.stairs(n_steps=2, step_height=0.025,
                                         step_depth=0.8, start_x=0.25,
                                         dtype=f32, device=dev)}


def c4_setup(dev, terrain):
    """The config-4 batch: C4_B A1 scenarios from
    `runner.init_loop_batch` (seeded, heights 0.29-0.31 m, commanded
    0.30 m, float32) standing on the height field. Returns (loop, params
    batched, the standing_trot pattern)."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner
    from legged_mpc_control_tpu_torch.sim import srb_sim

    f32 = torch.float32
    params = a1_params(f32, dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    loop = runner.init_loop_batch(params, C4_B, gen,
                                  height_range=(0.29, 0.31), dtype=f32,
                                  body_height=0.30, device=dev)
    loop = loop.replace(sim=srb_sim.sim_init(
        params, loop.sim.pos[:, 2], f32, dev, terrain=terrain))
    return (loop, step.broadcast_params(params, C4_B),
            gait.named_pattern("standing_trot", f32, dev))


def c4_ticks(loop, warm, params, pattern, terrain, n, walk=True):
    """n config-4 ticks through `closed_loop_tick_batched(..., terrain=)`;
    walking ones at C4_VELX with the terrain-following height command
    (0.3 m over the ground under the trunk). Returns (loop, warm)."""
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod

    for _ in range(n):
        if walk:
            cs = loop.controller
            ground = terrain_mod.height_at(terrain, loop.sim.pos[:, :2])
            loop = loop.replace(controller=cs.replace(joy=cs.joy.replace(
                velx=torch.full_like(cs.joy.velx, C4_VELX),
                body_height=0.3 + ground)))
        loop, warm = step.closed_loop_tick_batched(
            loop, params, pattern, horizon=C4_H, iters=C4_ITERS,
            solver="riccati", terrain=terrain, warm=warm)
    return loop, warm


def c4_roll(dev, terrain):
    """The config-4 closed loop: C4_STAND standing ticks, then C4_WALK
    walking. Returns (final loop, the kernel launches of the run, ticks)."""
    loop, params, pattern = c4_setup(dev, terrain)
    with launch_counts() as launches:
        loop, warm = c4_ticks(loop, None, params, pattern, terrain,
                              C4_STAND, walk=False)
        loop = set_mode(loop, 1)
        loop, warm = c4_ticks(loop, warm, params, pattern, terrain, C4_WALK)
    return loop, launches, C4_STAND + C4_WALK


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def c4_assess(loop, terrain, name):
    """Per scenario, whether it is finite and upright, and whether it meets
    every assertion of the JAX test on that terrain (tests/
    test_terrain_walk.py:76-87, :95-100); and the numbers they read."""
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod

    pos, eul = loop.sim.pos, loop.controller.fbk.root_euler
    ground = terrain_mod.height_at(terrain, pos[:, :2])
    clear = pos[:, 2] - ground
    tilt = eul[:, :2].abs().amax(-1)
    upright = (torch.isfinite(pos).all(-1) & torch.isfinite(eul).all(-1)
               & (clear > 0.15) & (tilt < 0.5))
    nums = {"x": pos[:, 0], "ground": ground, "clearance": clear,
            "tilt": tilt}
    if name == "platform":
        anchors = loop.sim.anchor
        on_top = anchors[..., 0] > 0.25
        low = torch.where(on_top, anchors[..., 2],
                          torch.full_like(anchors[..., 2], 1.0))
        nums["anchor_z_on_top"] = low.amin(-1)
        ok = ((pos[:, 0] > 0.4) & (ground > 0.025) & (clear > 0.17)
              & (eul[:, 0].abs() < 0.25) & (eul[:, 1].abs() < 0.25)
              & (nums["anchor_z_on_top"] > 0.02))
    else:
        ok = (pos[:, 0] > 0.26) & (ground > 0.02) & (clear > 0.17)
    return upright, ok & upright, nums


def c4_gate(name):
    """Config 4's whole recipe on one terrain, in a process of its own (the
    per-substep loop is host-bound: the four gate runs of the config-4 and
    single-robot phases go side by side). Returns plain numbers: the
    launches, the scenarios that pass and stand, the batch's numbers and
    the worst scenario's."""
    dev = torch.device("cuda", 0)
    terrain = c4_terrains(dev)[name]
    loop, launches, ticks = c4_roll(dev, terrain)
    upright, ok, nums = c4_assess(loop, terrain, name)
    worst = int(torch.argmin(nums["x"] + ok.float()))
    return dict(launches=dict(launches), ticks=ticks, passed=int(ok.sum()),
                upright=int(upright.sum()),
                span={k: (float(v.min()), float(v.max()))
                      for k, v in nums.items()},
                worst=(worst, {k: float(v[worst]) for k, v in nums.items()}))


def c4_timed(dev, name):
    """Config 4's loop rate, alone on the card: a fresh batch, C4_STAND
    standing and 3 walking ticks, then C4_TIMED walking ticks timed.
    Returns (seconds, their launches)."""
    terrain = c4_terrains(dev)[name]
    loop, params, pattern = c4_setup(dev, terrain)
    loop, warm = c4_ticks(loop, None, params, pattern, terrain, C4_STAND,
                          walk=False)
    loop = set_mode(loop, 1)
    loop, warm = c4_ticks(loop, warm, params, pattern, terrain, 3)
    sync(dev)
    with launch_counts() as launches:
        t1 = time.perf_counter()
        c4_ticks(loop, warm, params, pattern, terrain, C4_TIMED)
        sync(dev)
        elapsed = time.perf_counter() - t1
    return elapsed, launches


def check_config4_launches(launches, ticks, what):
    check(launches.get("riccati_ipm", 0) == ticks,
          f"config 4 {what}: K1 launched {launches.get('riccati_ipm', 0)} "
          f"times in {ticks} ticks")
    check(launches.get("substep_chain", 0) == 0,
          f"config 4 {what}: the terrain path launched the flat-only K2")


# the single-robot tick on tests/test_walk_gaits.py's recipe: A1, H=10,
# 20 standing and 200 walking ticks at 0.1 m/s, held to that test's
# assertions (min x, final height band, min height, worst roll/pitch)
SINGLE_GAITS = {"dynamic_walk": (0.25, 0.45), "static_walk": (0.2, 0.5)}
SINGLE_STAND, SINGLE_WALK, SINGLE_TIMED = 20, 200, 20
SINGLE_TIMED_STAND = 3      # standing ticks ahead of the timed walk


def single_ticks(dev, name, n_stand, n_walk, timed=0):
    """One A1 robot (a batch of one, float32) through
    `step.closed_loop_tick` with the named gait: `n_stand` standing ticks,
    then `n_walk` walking at 0.1 m/s. Returns (final loop, the worst
    |roll|, |pitch| and the least height over the walk, the kernel launches
    of the walk, the last `timed` ticks' seconds each)."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.sim import srb_sim

    f32 = torch.float32
    params = a1_params(f32, dev)
    pattern = gait.named_pattern(name, f32, dev)
    loop = step.LoopState(
        controller=step.controller_init(params, 1, f32, dev,
                                        body_height=0.3),
        sim=srb_sim.sim_init(params, torch.full((1,), 0.3), f32, dev))
    for _ in range(n_stand):
        loop = step.closed_loop_tick(loop, params, pattern, horizon=10)
    loop = set_mode(loop, 1)
    cs = loop.controller
    loop = loop.replace(controller=cs.replace(joy=cs.joy.replace(
        velx=torch.full((1,), 0.1, dtype=f32, device=dev))))
    eul, z, times = [], [], []
    sync(dev)
    with launch_counts() as launches:
        for k in range(n_walk):
            t1 = time.perf_counter()
            loop = step.closed_loop_tick(loop, params, pattern, horizon=10)
            if k >= n_walk - timed:
                sync(dev)
                times.append(time.perf_counter() - t1)
            eul.append(loop.controller.fbk.root_euler[0, :2])
            z.append(loop.sim.pos[0, 2])
    worst_rp = float(torch.stack(eul).abs().max())
    return loop, worst_rp, float(torch.stack(z).min()), launches, times


def single_gate(name):
    """tests/test_walk_gaits.py's recipe for one gait, in a process of its
    own; returns plain numbers."""
    loop, worst_rp, z_min, launches, _ = single_ticks(
        torch.device("cuda", 0), name, SINGLE_STAND, SINGLE_WALK)
    p = loop.sim.pos[0]
    return dict(x=float(p[0]), z=float(p[2]), finite=bool(
        torch.isfinite(p).all()), z_min=z_min, worst_rp=worst_rp,
        launches=dict(launches))


POOL_WORKERS = 19


def submit_gates(pool):
    """The gate runs of the last five phases, submitted together, a
    process each (`pool` has POOL_WORKERS workers): the two wall leans
    first (the longest), config 4's four, the twin's, the kf_type-2 loop's
    and the WBC stand's three, the LCI walk's and the single-robot CI
    walk's, so that the long one-robot runs overlap config 4's, the four
    of the CI loop on estimated state, then the CLI's four; every timed
    run of the five phases waits until all nineteen have ended. Returns
    name -> future."""
    gates = {("lean", rb): pool.submit(lean_gate, rb) for rb in LEAN_ROBOTS}
    gates.update({("c4", n): pool.submit(c4_gate, n)
                  for n in ("platform", "stairs")})
    gates.update({("single", n): pool.submit(single_gate, n)
                  for n in SINGLE_GAITS})
    gates.update({(n, None): pool.submit(fn) for n, fn in (
        ("wb", wb_gate), ("kf2", kf2_gate), ("wbc", wbc_gate),
        ("lci", lci_gate), ("ci1", ci1_gate))})
    gates.update({("ci_est", name): pool.submit(ci_est_gate, name)
                  for name in CIE_VARIANTS})
    gates.update({("cli", mpc): pool.submit(cli_gate, mpc)
                  for mpc in CLI_VELX})
    gates["cli_profile", None] = pool.submit(cli_profile_gate)
    return gates


def phase_config4(dev, card, pool):
    """BASELINE config 4 on the card: the H=30 solve rate; then the gate
    runs (`submit_gates`), side by side in processes of their own, of the closed loop
    of tests/test_terrain_walk.py at B=64 on the platform and on the stairs
    (per-substep loop, K1 every tick, no K2) and of the single-robot tick
    (`step.closed_loop_tick`, the condensed PDIP on K4 and K5 at B=1) with
    tests/test_walk_gaits.py's recipe and assertions for dynamic_walk and
    static_walk. Each loop's time, alone on the card on a short run of its
    own, is `config4_timed`'s: config 4's scenario-ticks/s over 10 walking
    ticks, and the single-robot tick's median over 20 walking ticks against
    the 10 ms MPC thread (LeggedParams.h:7), ungated (host-bound).
    Returns (the H=30 solve rate, every gate's future)."""
    solves = solve_rate(dev, card, C4_H)
    gates = submit_gates(pool)
    t0 = phase(f"config 4 (A1, B={C4_B}, standing_trot, H={C4_H}, "
               f"iters={C4_ITERS} warm, {C4_STAND} standing + {C4_WALK} "
               f"walking ticks at {C4_VELX} m/s) on the platform and the "
               f"stairs, and the single-robot tick (A1, H=10, PDIP 15, "
               f"{SINGLE_STAND} standing + {SINGLE_WALK} walking ticks) "
               f"with {' and '.join(SINGLE_GAITS)}: four processes (beside "
               "the next two phases' seven)")
    c4 = {n: gates["c4", n].result() for n in ("platform", "stairs")}
    single = {n: gates["single", n].result() for n in SINGLE_GAITS}
    for name, r in c4.items():
        print(f"   config 4 on the {name}: kernel launches over "
              f"{r['ticks']} ticks {r['launches']}; {r['passed']} of {C4_B} "
              f"scenarios meet every assertion of the JAX test, upright "
              f"{r['upright']}; over the batch " + ", ".join(
                  f"{k} [{lo:.4f}, {hi:.4f}]"
                  for k, (lo, hi) in r["span"].items()), flush=True)
        idx, w = r["worst"]
        print(f"   worst scenario {idx}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in w.items()), flush=True)
    for name, r in single.items():
        print(f"   single-robot {name}: kernel launches over the walk "
              f"{r['launches']}; x {r['x']:.4f} m, z {r['z']:.4f} m, min z "
              f"{r['z_min']:.4f} m, worst |roll|,|pitch| "
              f"{r['worst_rp']:.4f} rad", flush=True)
    for name, r in c4.items():
        check_config4_launches(r["launches"], r["ticks"], f"on the {name}")
        check(r["upright"] == C4_B, f"config 4 on the {name}: a scenario "
              "is not finite or not upright")
        check(r["passed"] >= C4_PASS_MIN,
              f"config 4 on the {name}: {r['passed']} of {C4_B} meet the "
              "JAX test's assertions")
    for name, r in single.items():
        x_min, rp_max = SINGLE_GAITS[name]
        check_launched(r["launches"], ("chol_factor", "chol_solve"),
                       f"single-robot {name}")
        check(r["finite"], f"{name}: non-finite")
        check(r["x"] > x_min, f"{name}: x {r['x']} <= {x_min}")
        check(0.2 < r["z"] < 0.35, f"{name}: z {r['z']}")
        check(r["z_min"] > 0.18, f"{name}: min z {r['z_min']}")
        check(r["worst_rp"] < rp_max,
              f"{name}: worst roll/pitch {r['worst_rp']}")
    done(t0)
    return solves, gates


def config4_timed(dev, card):
    """Config 4's and the single-robot tick's timed runs (`phase_config4`'s
    docstring), once every gate process has ended."""
    t0 = phase("config 4 and the single-robot tick timed, alone on the "
               "card")
    rates = {}
    for name in ("platform", "stairs"):
        elapsed, launches = c4_timed(dev, name)
        check_config4_launches(launches, C4_TIMED, f"timed, on the {name}")
        rates[name] = C4_B * C4_TIMED / elapsed
        print(f"   closed_loop_scenario_ticks_per_s_b64_h30_terrain, "
              f"{name} = {rates[name]:.1f} ({card}; diagnostic; "
              f"{elapsed / C4_TIMED * 1e3:.2f} ms a tick over {C4_TIMED} "
              f"walking ticks; launches {dict(launches)})", flush=True)
    for name in SINGLE_GAITS:
        *_, launches, times = single_ticks(dev, name, SINGLE_TIMED_STAND,
                                           SINGLE_TIMED, SINGLE_TIMED)
        check_launched(launches, ("chol_factor", "chol_solve"),
                       f"single-robot {name}, timed")
        print(f"   single_robot_tick_ms_{name} = "
              f"{float(np.median(times)) * 1e3:.2f} (median of "
              f"{SINGLE_TIMED} walking ticks; {card}; the MPC thread's "
              "budget 10 ms)", flush=True)
    done(t0)
    return rates


def check_k4_k6(A, R, robust_share, label):
    """K4 + K6 on gain systems A (N, n, n), R (N, n, m) as the CI sweeps
    hand them over, against the plain versions, where the float64 pivots
    are robust (at least `robust_share` of the N must be): K6 on K4's
    factor elementwise and the path against the plain path
    (`cholesky_plain`, then `cho_solve_multi_plain`), relative to each
    system's largest entry, within K6_REL_TOL; K4's factor and the path's
    solve by their backward errors, within BACKWARD_TOL and 4x plain's.
    Returns (K4's factor, K6's largest elementwise error)."""
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    N = A.shape[0]
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
    check(n_rob >= robust_share * N,
          f"K6 {label}: only {n_rob} of {N} robust matrices")
    check(bool(torch.isfinite(F[robust]).all()),
          f"K4 {label}: a robust matrix not factored")
    check(bool(torch.isfinite(X[robust]).all()),
          f"K4 + K6 {label}: non-finite")
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
    print(f"   {label}: {n_rob} of {N} matrices with robust pivots. K4: "
          f"backward error {rf:.3e} (plain {rfp:.3e}), max |F - F_plain| "
          f"{err4:.3e}, relative {rel4:.3e}. K6 on K4's factor: max "
          f"|X - X_plain| {err:.3e}, relative {rel6:.3e}. K4 + K6 against "
          f"the plain path: backward error {rk:.3e} (plain {rp:.3e}), "
          f"relative {rel_path:.3e} (tol {K6_REL_TOL}; backward tol "
          f"{BACKWARD_TOL})", flush=True)
    check(rf <= BACKWARD_TOL and rf <= 4 * rfp + 1e-6,
          f"K4 {label}: backward error {rf} vs {rfp}")
    check(rk <= BACKWARD_TOL and rk <= 4 * rp + 1e-6,
          f"K4 + K6 {label}: backward error {rk} vs {rp}")
    check(rel6 <= K6_REL_TOL, f"K6 {label}: differs by {rel6}")
    check(rel_path <= K6_REL_TOL,
          f"K4 + K6 {label}: differ from the plain path by {rel_path}")
    return F, err


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
    F, err = check_k4_k6(A, R, 0.9, "box-step stage")
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
          f"ms, torch.cholesky_solve {lib_ms:.4f} ms; bound {b_ms:.3g} ms "
          f"({b_by}); K4 at n={n}: kernel {ms4:.4f} ms, plain "
          f"{plain4:.4f} ms, torch.linalg.cholesky_ex "
          f"{lib4:.4f} ms (x{lib4 / ms4:.2f} the kernel's time), bound "
          f"{b4[0]:.3g} ms ({b4[1]})", flush=True)
    done(t0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by)


# ---- the articulated twin, kf_type 2 and the WBC (A1 / Go1) ---------------

# the twin's batched loop, bench.py:514-545's width: A1 with the twin's swing
# gains (tests/test_wb_sim.py's kp_foot 40, kd_foot 1.2), trot, H=10, riccati
WB_B, WB_H, WB_ITERS, WB_VELX = 256, 10, 8, 0.2
WB_WALKIN_STAND, WB_WALKIN, WB_TIMED = 30, 40, 10
# the gate: tests/test_wb_batched.py:50-80 at B=256 (pdip_iters 10, 30
# standing + 60 walking ticks, mass 0.9-1.1, mu 0.7-1.2), >= 95 % of the
# scenarios meeting every one of its assertions
WB_GATE_ITERS, WB_GATE_STAND, WB_GATE_WALK = 10, 30, 60
WB_PASS_MIN = 244
# K4 + K5 on the walked batch's mass matrices against their plain
# versions, per matrix relative to its largest entry (these matrices'
# condition numbers are ~1e3: float32 solves agree to ~1e-7)
WB_CHOL_REL_TOL = 1e-5
# kf_type 2: phase_kf1's gate (B=64 x 120 ticks, Go1 trot at 0.15 m/s,
# iters 4) with the estimator limits of bench.py:221-222, held per
# scenario: this loop loses ~1 % of its scenarios within 120 ticks in the
# JAX package as in the port (tools/kf2_census.py), so >= 95 % must be
# finite, upright and moving, and the estimate's mean errors over those
# must hold the limits
KF2_GATE_B, KF2_TICKS = 64, 120
KF2_PASS_MIN = 61
# the WBC stand of tests/test_wb_sim.py:189-200, 150 ticks of one robot
WBC_TICKS, WBC_TIMED = 150, 10


def wb_setup(dev, batch, seed, randomize=False):
    """A1 twin batch (`runner.init_wb_loop_batch`, float32) with the twin's
    swing gains; params randomized as tests/test_wb_batched.py does when
    asked. Returns (loop, params, model, pattern)."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.models import whole_body as wb
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner

    f32 = torch.float32
    params = a1_params(f32, dev).replace(
        kp_foot=torch.full((3,), 40.0, device=dev),
        kd_foot=torch.full((3,), 1.2, device=dev))
    model = wb.a1_wb_model(f32, dev)
    loop = runner.init_wb_loop_batch(
        params, model, batch, torch.Generator(device=dev).manual_seed(seed),
        dtype=f32, device=dev)
    if randomize:
        params = runner.randomize_params(
            params, torch.Generator(device=dev).manual_seed(seed + 2), batch,
            mass_range=(0.9, 1.1), mu_range=(0.7, 1.2),
            speed_range=(1.0, 1.0))
    return loop, params, model, gait.trot_pattern(f32, dev)


def check_wb_launches(launches, ticks, what):
    """K1 once a tick, K4 and K5 32 times (8 substeps x n_inner 4), no
    substep chain."""
    want = {"riccati_ipm": ticks, "chol_factor": 32 * ticks,
            "chol_solve": 32 * ticks}
    check(dict(launches) == want,
          f"the twin's loop, {what}: launches {dict(launches)}, want {want}")


def wb_gate(dev_type="cuda"):
    """tests/test_wb_batched.py:50-80 at B=WB_B, in a process of its own:
    every scenario finite, and per scenario whether it meets every
    assertion of that test."""
    from legged_mpc_control_tpu_torch.parallel import runner

    dev = torch.device(dev_type, 0)
    loop, params, model, pattern = wb_setup(dev, WB_B, 1, randomize=True)
    roll = runner.make_batched_rollout_wb(
        pattern, model, horizon=WB_H, n_ticks=WB_GATE_STAND + WB_GATE_WALK,
        pdip_iters=WB_GATE_ITERS, walk_velx=WB_VELX, solver="riccati",
        stand_ticks=WB_GATE_STAND)
    with launch_counts() as launches:
        final, (pos, _) = roll(loop, params)
    q = final.sim.q
    finite = torch.isfinite(q).all(-1) & torch.isfinite(pos).all((0, 2))
    z, x, rp = q[:, 2], q[:, 0], q[:, 4:6].abs().amax(-1)
    zmin = pos[:, :, 2].amin(0)
    ok = (finite & (z > 0.2) & (z < 0.35) & (x > 0.035) & (rp < 0.3)
          & (zmin > 0.15))
    nums = {"z": z, "x": x, "max |roll|,|pitch|": rp, "min z over the run":
            zmin}
    return dict(launches=dict(launches), finite=int(finite.sum()),
                passed=int(ok.sum()), ticks=WB_GATE_STAND + WB_GATE_WALK,
                span={k: (float(v.min()), float(v.max()))
                      for k, v in nums.items()})


def kf2_gate(dev_type="cuda"):
    """phase_kf1's gate with the EKF (kf_type 2, the per-substep loop), in a
    process of its own."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import runner

    dev = torch.device(dev_type, 0)
    params = go1_params(torch.float32, dev)
    roll = runner.make_batched_rollout(
        gait.trot_pattern(torch.float32, dev), horizon=10, n_ticks=KF2_TICKS,
        pdip_iters=4, walk_velx=0.15, stand_ticks=20, kf_type=2)
    with launch_counts() as launches:
        final, _ = roll(init_batch(params, KF2_GATE_B, 9, dev), params)
    ok, err = kf2_assess(final, 0.15)
    pos = final.sim.pos[ok]
    return dict(launches=dict(launches), passed=int(ok.sum()),
                z=(float(pos[:, 2].min()), float(pos[:, 2].max())),
                x_min=float(pos[:, 0].min()), ez=float(err[ok, 2].mean()),
                exy=float(err[ok, 0:2].mean()), ticks=KF2_TICKS)


def kf2_assess(final, velx):
    """Per scenario, finite (the sim and the EKF), upright (0.2 < z < 0.4)
    and moving (x > half the command's 1.2 s); and the estimate's absolute
    error (B, 3)."""
    pos, x = final.sim.pos, final.controller.ekf.x
    finite = torch.isfinite(pos).all(-1) & torch.isfinite(x).all(-1)
    ok = (finite & (pos[:, 2] > 0.2) & (pos[:, 2] < 0.4)
          & (pos[:, 0] > 0.5 * velx))
    return ok, (x[:, 0:3] - pos).abs()


def wbc_ticks(dev, n, timed=False):
    """One A1 robot on the twin with the WBC (`closed_loop_tick_wb`,
    low_level_type 1), standing from 0.28 m as tests/test_wb_sim.py:
    189-200 does. Returns (final loop, the launches, each tick's seconds
    when timed)."""
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.sim import wb_sim

    _, params, model, pattern = wb_setup(dev, 1, 0)
    f32 = torch.float32
    loop = step.LoopState(
        controller=step.controller_init(params, 1, f32, dev,
                                        body_height=0.28),
        sim=wb_sim.wb_sim_init(model, params, [0.28], f32, dev))
    times = []
    sync(dev)
    with launch_counts() as launches:
        for _ in range(n):
            t1 = time.perf_counter()
            loop = step.closed_loop_tick_wb(loop, params, pattern, model,
                                            horizon=10, low_level_type=1)
            if timed:
                sync(dev)
                times.append(time.perf_counter() - t1)
    return loop, launches, times


def wbc_gate(dev_type="cuda"):
    """The WBC stand's recipe and numbers, in a process of its own."""
    loop, launches, _ = wbc_ticks(torch.device(dev_type, 0), WBC_TICKS)
    q, v = loop.sim.q[0], loop.sim.v[0]
    return dict(launches=dict(launches), finite=bool(
        torch.isfinite(q).all() & torch.isfinite(v).all()), z=float(q[2]),
        att=float(q[3:6].abs().max()), vnorm=float(v[:6].norm()))


def wb_capture_solve(loop, params, model, pattern):
    """The mass matrices and right-hand sides that one batched twin tick
    hands K4 and K5 first (the walked batch's, substep 1, inner step 1)."""
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    seen = {}
    factor, solve = chol_kernel.cholesky_cuda, chol_kernel.cho_solve_cuda

    def cap_factor(M):
        seen.setdefault("M", M.clone())
        return factor(M)

    def cap_solve(F, b):
        seen.setdefault("b", b.clone())
        return solve(F, b)
    with patched(chol_kernel, cholesky_cuda=cap_factor,
                 cho_solve_cuda=cap_solve):
        step.closed_loop_tick_wb_batched(loop, params, pattern, model,
                                         horizon=WB_H, iters=WB_ITERS)
    return seen["M"], seen["b"]


def phase_wb_k45(dev, card, M, b):
    """Kernels K4 and K5 at n=18, B=WB_B, on the walked twin batch's mass
    matrices (CRBA plus armature) and right-hand sides: against their plain
    versions elementwise (the factor, K5 on K4's factor, and the path's
    K4 + K5 against the plain path) and against float64; then their times
    beside the library calls and the bound."""
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    n = M.shape[-1]
    t0 = phase(f"K4 chol_factor + K5 chol_solve vs plain, B={M.shape[0]}, "
               f"n={n}, the walked twin batch's mass matrices")
    F = chol_kernel.cholesky_cuda(M)
    x = chol_kernel.cho_solve_cuda(F, b)
    Fp = chol_kernel.cholesky_plain(M)
    x5p = chol_kernel.cho_solve_plain(F, b)
    xp = chol_kernel.cho_solve_plain(Fp, b)
    x64 = torch.linalg.solve(M.double(), b.double()[..., None])[..., 0]

    def rel(a, ref):
        return float(((a.double() - ref.double()).abs().amax(
            tuple(range(1, a.dim()))) / ref.double().abs().amax(
            tuple(range(1, a.dim())))).max())
    r4, r5, rpath = rel(F, Fp), rel(x, x5p), rel(x, xp)
    r64, rp64 = rel(x, x64), rel(xp, x64)
    err4 = float((F - Fp).abs().max())
    err5 = float((x - xp).abs().max())
    print(f"   per matrix, relative to its largest entry: K4 vs plain "
          f"{r4:.3e}; K5 on K4's factor vs plain {r5:.3e}; K4 + K5 vs the "
          f"plain path {rpath:.3e} (tol {WB_CHOL_REL_TOL}); vs float64: "
          f"kernels {r64:.3e}, plain {rp64:.3e}; max |F - F_plain| "
          f"{err4:.3e}, max |x - x_plain| {err5:.3e}", flush=True)
    check(bool(torch.isfinite(F).all() & torch.isfinite(x).all()),
          "K4 + K5 at n=18: non-finite")
    check(torch.equal(F, F.transpose(-1, -2)),
          "K4 at n=18: the upper triangle does not mirror L")
    for what, r in (("K4", r4), ("K5", r5), ("K4 + K5", rpath)):
        check(r <= WB_CHOL_REL_TOL, f"{what} at n=18 differs by {r}")
    check(r64 <= 4 * rp64 + 1e-6, f"K4 + K5 at n=18: {r64} from float64, "
          f"plain {rp64}")
    batch = M.shape[0]
    out = dict(
        err4=err4, err5=err5,
        ms4=cuda_ms(lambda: chol_kernel.cholesky_cuda(M), reps=50),
        plain4=cuda_ms(lambda: chol_kernel.cholesky_plain(M), reps=10),
        lib4=cuda_ms(lambda: torch.linalg.cholesky_ex(M), reps=10),
        ms5=cuda_ms(lambda: chol_kernel.cho_solve_cuda(F, b), reps=50),
        plain5=cuda_ms(lambda: chol_kernel.cho_solve_plain(Fp, b), reps=10),
        lib5=cuda_ms(lambda: torch.cholesky_solve(b[..., None], Fp.tril()),
                     reps=10),
        bound4=bound(batch * tri(n) * 2 * 4, batch * n ** 3 / 3),
        bound5=bound(batch * (tri(n) + 2 * n) * 4, batch * 2 * n * n))
    print(f"   time ({card}): K4 kernel {out['ms4']:.4f} ms, plain "
          f"{out['plain4']:.4f} ms, torch.linalg.cholesky_ex "
          f"{out['lib4']:.4f} ms, bound {out['bound4'][0]:.3g} ms "
          f"({out['bound4'][1]}); K5 kernel {out['ms5']:.4f} ms, plain "
          f"{out['plain5']:.4f} ms, torch.cholesky_solve {out['lib5']:.4f} "
          f"ms, bound {out['bound5'][0]:.3g} ms ({out['bound5'][1]})",
          flush=True)
    done(t0)
    return out


def phase_wb(dev, card, gates):
    """The articulated twin, kf_type 2 and the WBC on the card: the gate
    runs (`submit_gates`), side by side in three processes of their own
    started with config 4's: the twin's batched loop of
    tests/test_wb_batched.py at B=WB_B, phase_kf1's gate with the EKF, the
    WBC stand of tests/test_wb_sim.py. Their timed runs, alone on the
    card, are `phase_wb_timed`."""
    t0 = phase(f"the twin's loop (A1, B={WB_B}, trot, H={WB_H}, riccati "
               f"{WB_GATE_ITERS}, {WB_GATE_STAND} standing + {WB_GATE_WALK} "
               f"walking ticks at {WB_VELX} m/s, mass and mu randomized), "
               f"kf_type 2 (Go1, B={KF2_GATE_B}, {KF2_TICKS} ticks) and the "
               f"WBC stand (A1, one robot, {WBC_TICKS} ticks): three "
               "processes, started with config 4's")
    res = {name: gates[name, None].result() for name in ("wb", "kf2", "wbc")}
    r = res["wb"]
    print(f"   twin: kernel launches over {r['ticks']} ticks "
          f"{r['launches']}; finite {r['finite']} of {WB_B}; "
          f"{r['passed']} of {WB_B} meet every assertion of the JAX test; "
          "over the batch " + ", ".join(
              f"{k} [{lo:.4f}, {hi:.4f}]" for k, (lo, hi) in
              r["span"].items()), flush=True)
    k = res["kf2"]
    print(f"   kf_type 2: kernel launches over {k['ticks']} ticks "
          f"{k['launches']}; {k['passed']} of {KF2_GATE_B} finite, upright "
          f"and moving; over them z in [{k['z'][0]:.4f}, {k['z'][1]:.4f}], "
          f"min x {k['x_min']:.4f} m; EKF error: z {k['ez']:.4e} m, xy "
          f"{k['exy']:.4e} m", flush=True)
    w = res["wbc"]
    print(f"   WBC stand: kernel launches over {WBC_TICKS} ticks "
          f"{w['launches']}; z {w['z']:.4f} m, max |yaw|,|pitch|,|roll| "
          f"{w['att']:.4f} rad, |v_base| {w['vnorm']:.4f}", flush=True)
    check_wb_launches(r["launches"], r["ticks"], "gate")
    check(r["finite"] == WB_B, "the twin's loop: a scenario is not finite")
    check(r["passed"] >= WB_PASS_MIN, f"the twin's loop: {r['passed']} of "
          f"{WB_B} meet the JAX test's assertions")
    check(k["launches"] == {"riccati_ipm": KF2_TICKS},
          f"kf_type 2: launches {k['launches']}")
    check(k["passed"] >= KF2_PASS_MIN, f"kf_type 2: {k['passed']} of "
          f"{KF2_GATE_B} finite, upright and moving")
    check(k["ez"] < 0.025, f"EKF z estimate off truth by {k['ez']} m")
    check(k["exy"] < 0.04, f"EKF xy drift {k['exy']} m over 1.2 s")
    check(w["launches"] == {"chol_factor": WBC_TICKS * (15 + 32),
                            "chol_solve": WBC_TICKS * (30 + 32),
                            "condense": WBC_TICKS},
          f"WBC stand: launches {w['launches']}")
    check(w["finite"], "WBC stand: non-finite")
    check(0.26 < w["z"] < 0.30, f"WBC stand: z {w['z']}")
    check(w["att"] < 0.03, f"WBC stand: attitude {w['att']}")
    check(w["vnorm"] < 0.1, f"WBC stand: base velocity {w['vnorm']}")
    done(t0)



def phase_wb_timed(dev, card):
    """The twin's loop timed at B=WB_B with K4 + K5 at n=18 on its walked
    batch, the kf_type-2 loop timed at B=4096 and the WBC stand's tick
    timed (`phase_wb`'s docstring), once every gate process has ended."""
    t0 = phase(f"the twin's loop timed: B={WB_B}, {WB_WALKIN_STAND} standing "
               f"within {WB_WALKIN} walk-in ticks, then {WB_TIMED} walking "
               f"ticks timed; riccati {WB_ITERS}")
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.parallel import runner

    loop, params, model, pattern = wb_setup(dev, WB_B, 0)
    walked, _ = runner.make_batched_rollout_wb(
        pattern, model, horizon=WB_H, n_ticks=WB_WALKIN, pdip_iters=WB_ITERS,
        walk_velx=WB_VELX, stand_ticks=WB_WALKIN_STAND)(loop, params)
    roll = runner.make_batched_rollout_wb(
        pattern, model, horizon=WB_H, n_ticks=WB_TIMED, pdip_iters=WB_ITERS,
        walk_velx=WB_VELX, stand_ticks=0)
    sync(dev)
    with launch_counts() as wb_launches:
        t1 = time.perf_counter()
        final, _ = roll(walked, params)
        sync(dev)
        elapsed = time.perf_counter() - t1
    check_wb_launches(wb_launches, WB_TIMED, "timed")
    check(bool(torch.isfinite(final.sim.q).all()), "the twin: non-finite")
    rate = WB_B * WB_TIMED / elapsed
    print(f"   wb_closed_loop_scenario_ticks_per_s_b256 = {rate:.1f} "
          f"({card}; real-time bar {WB_B * 100}; {elapsed / WB_TIMED * 1e3:.2f}"
          f" ms a tick; launches {dict(wb_launches)})", flush=True)
    done(t0)
    M, b = wb_capture_solve(walked, step.broadcast_params(params, WB_B),
                            model, pattern)
    k45 = phase_wb_k45(dev, card, M, b)
    k45["launches_wb"] = {name: wb_launches[name] // WB_TIMED
                          for name in ("chol_factor", "chol_solve")}

    t0 = phase(f"kf_type 2 timed: B={B}, 10 walking ticks after 30, iters=4,"
               " warm")
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait

    go1 = go1_params(torch.float32, dev)

    def make(n, stand):
        return runner.make_batched_rollout(
            gait.trot_pattern(torch.float32, dev), horizon=10, n_ticks=n,
            pdip_iters=4, walk_velx=0.15, stand_ticks=stand, kf_type=2)
    walked2 = make(30, 20)(init_batch(go1, B, 0, dev), go1)[0]
    sync(dev)
    with launch_counts() as launches:
        t1 = time.perf_counter()
        final, _ = make(10, 0)(walked2, go1)
        sync(dev)
        elapsed = time.perf_counter() - t1
    check(dict(launches) == {"riccati_ipm": 10},
          f"kf_type 2 timed: launches {dict(launches)}")
    ok, _ = kf2_assess(final, 0.0)
    check(int(ok.sum()) >= 0.95 * B, f"kf_type 2 timed: {int(ok.sum())} of "
          f"{B} finite and upright")
    rate2 = B * 10 / elapsed
    print(f"   closed_loop_scenario_ticks_per_s_b4096_kf2 = {rate2:.1f} "
          f"({card}; real-time bar {B * 100}; {elapsed / 10 * 1e3:.2f} ms a "
          f"tick)", flush=True)
    done(t0)

    t0 = phase(f"the WBC stand timed: one robot, {WBC_TIMED} ticks")
    _, launches, times = wbc_ticks(dev, WBC_TIMED, timed=True)
    check_launched(launches, ("chol_factor", "chol_solve"), "WBC stand")
    print(f"   wb_wbc_single_robot_tick_ms_stand = "
          f"{float(np.median(times)) * 1e3:.2f} (median of {WBC_TIMED} "
          f"ticks; {card}; diagnostic; the MPC thread's budget 10 ms)",
          flush=True)
    done(t0)
    return k45, rate, rate2



# ---- the rest of the contact-implicit MPC: the wall lean (Go1, A1), the
# `--mpc lci` walk and the single-robot CI walk (A1), one robot each -------

# tests/test_ci_wall_lean.py:41-127, uncut: mu 0.6, the wall at x = 0.35,
# pitch -0.4, the front feet 1.5 mm short of the plane, mode 1 with the
# 2-tap filter warmed, `make_ci_lean_policy(iters=24)` for 250 ticks
LEAN_ROBOTS = ("go1", "a1")
LEAN_TICKS, LEAN_ITERS, LEAN_SETTLE = 250, 24, 20
LEAN_WALL_X, LEAN_PITCH = 0.35, -0.4
# a lean tick: 24 sweeps x H=10 backward stages, each a K4 + K6 gain solve
# at n=24; 8 substeps x 4 inner twin steps, each K4 + K5 at n=18
LEAN_LAUNCHES = {"chol_factor": 240 + 32, "chol_solve_multi": 240,
                 "chol_solve": 32}
# the batched wall solve held lanes against plain: lean states perturbed
# from a seed, 24 sweeps; the whole solve in K7_TOL's bracket
LEAN_B = 64
# tests/test_lci.py:92-125: A1, 20 stand ticks, then 60 walk ticks of
# `make_walk_policy(velx=0.25)` (H=8, 12 PDIP iterations: the build kernel
# once, K4 12 and K5 24 times a tick at n=96, B=1)
LCI_STAND, LCI_WALK, LCI_VELX = 20, 60, 0.25
LCI_LAUNCHES = {"chol_factor": 12, "chol_solve": 24, "condense": 1}
# tests/test_ci_mpc.py:142-179: A1, 20 stand ticks, then 300 walk ticks of
# `make_ci_walk_policy(velx=0.10)` (32 sweeps, K7 at B=1 once a tick)
CI1_STAND, CI1_WALK, CI1_VELX = 20, 300, 0.10
# the LCI walk's and the CI walk's ticks timed alone: walking ticks after
# a few standing ones
LCI_TIMED_STAND, LCI_TIMED = 5, 20


def lean_setup(dev, robot, iters=LEAN_ITERS):
    """tests/test_ci_wall_lean.py:41-99's setup on the port (float32): the
    params at mu 0.6, the twin's model and state at the lean pose, the
    wall, the lean and stand policies, the loop in mode 1 and the LCI state
    with its foot filter warmed."""
    from legged_mpc_control_tpu_torch.config import a1_params, go1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.models import kinematics as kin
    from legged_mpc_control_tpu_torch.models import whole_body as wb
    from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc
    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod
    from legged_mpc_control_tpu_torch.sim import wb_sim

    f32 = torch.float32
    base = (a1_params if robot == "a1" else go1_params)(f32, dev)
    params = base.replace(mu=torch.tensor(0.6, device=dev))
    model = wb.wb_model_for(robot, f32, dev)
    wall = terrain_mod.wall_at_x(LEAN_WALL_X, f32, dev)
    pos = torch.tensor([0.0, 0.0, 0.32], device=dev)
    eul = torch.tensor([0.0, LEAN_PITCH, 0.0], device=dev)
    tgt = torch.tensor([[LEAN_WALL_X, 0.13, 0.42], [LEAN_WALL_X, -0.13, 0.42],
                        [-0.17, 0.13, 0.0], [-0.17, -0.13, 0.0]], device=dev)
    feet = tgt.clone()
    feet[0:2, 0] -= 0.0015
    c, s_ = np.cos(np.float32(LEAN_PITCH)), np.sin(np.float32(LEAN_PITCH))
    R = torch.tensor([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]],
                     dtype=f32, device=dev)
    qj = kin.ik_legs((feet - pos) @ R, torch.tensor(
        [0.0, 0.8, -1.6], device=dev).expand(4, 3),
        wb_sim.wb_rho_fix(model, f32))
    q = torch.cat([pos, eul, qj.reshape(12)])[None]
    fp = wb.foot_positions(q, model)
    sim = wb_sim.WbSimState(q=q, v=torch.zeros_like(q),
                            anchor=fp[..., :2].clone(), wall_anchor=fp,
                            f_contact=torch.zeros_like(fp),
                            last_acc=torch.zeros((1, 3), device=dev))
    lean = ci_mpc.make_ci_lean_policy(params, wall, tgt, pos, eul,
                                      iters=iters)
    lci = lci_mpc.lci_init(f32, lean.warm_init(f32, dev), device=dev)
    lci = lci.replace(prev_foot_pos=(feet - pos)[None],
                      prev_foot_vel=torch.zeros((1, 4, 3), device=dev))
    cs = step.controller_init(params, 1, f32, dev)
    cs = cs.replace(ctrl=cs.ctrl.replace(movement_mode=torch.ones(
        (1,), dtype=torch.int32, device=dev)))
    return dict(params=params, model=model, wall=wall, lean=lean,
                stand=lci_mpc.make_stand_policy(params, body_height=0.3),
                loop=step.LoopState(controller=cs, sim=sim), lci=lci,
                pose=(tgt, pos, eul))


def lean_gate(robot, dev_type="cuda"):
    """The lean of `robot` for LEAN_TICKS ticks through
    `step.closed_loop_tick_lci_wb(wall=...)`, in a process of its own: per
    tick z, pitch, roll and the front feet's wall-normal forces, each
    tick's seconds, the launches, and the gain systems (Quu + Rr, [Qu | Qux
    + Rx]) that the first tick's wall solve hands K4 + K6 (on the CPU)."""
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    dev = torch.device(dev_type, 0)
    L = lean_setup(dev, robot)
    loop, lci = L["loop"], L["lci"]
    systems = []
    factor, solve = chol_kernel.cholesky_cuda, chol_kernel.cho_solve_multi_cuda

    def cap_factor(A):
        if A.shape[-1] == 24:
            systems.append([A.clone()])
        return factor(A)

    def cap_solve(F, R):
        systems[-1].append(R.clone())
        return solve(F, R)

    def tick(loop, lci, k):
        return step.closed_loop_tick_lci_wb(
            loop, lci, L["params"], L["model"], L["stand"], L["lean"],
            0.01 * k, wall=L["wall"])
    hist, times = [], []
    sync(dev)
    with launch_counts() as launches:
        for k in range(LEAN_TICKS):
            t1 = time.perf_counter()
            if k == 0:
                with patched(chol_kernel, cholesky_cuda=cap_factor,
                             cho_solve_multi_cuda=cap_solve):
                    loop, lci = tick(loop, lci, k)
            else:
                loop, lci = tick(loop, lci, k)
            sync(dev)
            times.append(time.perf_counter() - t1)
            q, fc = loop.sim.q[0], loop.sim.f_contact[0]
            # the wall's normal is -x: the robot's press reads as negative
            # contact force x on the front feet
            hist.append(torch.stack([q[2], q[4], q[5], -fc[0, 0],
                                     -fc[1, 0]]))
    h = torch.stack(hist).double().cpu().numpy()
    A = torch.cat([a for a, _ in systems]).cpu()
    R = torch.cat([r for _, r in systems]).cpu()
    return dict(h=h, times=times, launches=dict(launches), A=A, R=R,
                finite=bool(torch.isfinite(loop.sim.q).all()))


def lean_verdict(robot, r):
    """Every assertion of tests/test_ci_wall_lean.py:76-127 on a lean
    gate's record; prints the readings."""
    h = r["h"]
    z, pitch, roll, f0, f1 = h.T
    st = h[LEAN_SETTLE:]
    print(f"   lean {robot}: launches over {LEAN_TICKS} ticks "
          f"{r['launches']}; z in [{z.min():.4f}, {z.max():.4f}] m, pitch "
          f"in [{pitch.min():.4f}, {pitch.max():.4f}], max |roll| "
          f"{np.abs(roll).max():.4f} rad; after tick {LEAN_SETTLE} the "
          f"front feet's wall-normal force min {st[:, 3].min():.2f} / "
          f"{st[:, 4].min():.2f} N, mean {st[:, 3].mean():.2f} / "
          f"{st[:, 4].mean():.2f} N", flush=True)
    want = {k: LEAN_TICKS * v for k, v in LEAN_LAUNCHES.items()}
    check(r["launches"] == want, f"lean {robot}: launches "
          f"{r['launches']}, want {want}")
    check(r["finite"], f"lean {robot}: non-finite")
    check(bool(np.all(z > 0.2)), f"lean {robot}: collapsed")
    check(bool(np.all(pitch < -0.25)), f"lean {robot}: pitch {pitch.max()}")
    check(bool(np.all(pitch > -0.55)), f"lean {robot}: pitch {pitch.min()}")
    check(np.abs(roll).max() < 0.1, f"lean {robot}: roll")
    for i, f in ((0, st[:, 3]), (1, st[:, 4])):
        check(f.min() > 8.0, f"lean {robot}: front foot {i} wall force "
              f"{f.min()} N")
        check(f.mean() > 15.0, f"lean {robot}: front foot {i} mean wall "
              f"force {f.mean()} N")
    check(0.30 < z.min() and z.max() < 0.45,
          f"lean {robot}: z in [{z.min()}, {z.max()}]")


def lci_ticks(dev, walk_kind, n_stand, n_walk, timed=0, capture=False):
    """One A1 robot through `step.closed_loop_tick_lci` (the SRB simulator,
    the per-substep loop): `n_stand` stand ticks, then `n_walk` walk ticks
    of `make_walk_policy(velx=0.25)` ("lci") or `make_ci_walk_policy(
    velx=0.10)` ("ci"). Returns the stand's last z, the walk's x progress,
    the final loop, per walk tick z and |roll|, |pitch|, the walk's
    launches, the last `timed` ticks' seconds, and with `capture` each
    walk tick's condensed QP (P, q, mu, fz_max, contact) as the walk
    policy hands it to the PDIP (on the CPU)."""
    from legged_mpc_control_tpu_torch.config import a1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc, pdip
    from legged_mpc_control_tpu_torch.sim import srb_sim

    f32 = torch.float32
    params = a1_params(f32, dev)
    loop = step.LoopState(
        controller=step.controller_init(params, 1, f32, dev),
        sim=srb_sim.sim_init(params, torch.full((1,), 0.3), f32, dev))
    stand = lci_mpc.make_stand_policy(params, body_height=0.3)
    if walk_kind == "lci":
        walk = lci_mpc.make_walk_policy(params, velx=LCI_VELX,
                                        body_height=0.3)
        lci = lci_mpc.lci_init(f32, device=dev)
    else:
        walk = ci_mpc.make_ci_walk_policy(params, velx=CI1_VELX)
        lci = lci_mpc.lci_init(f32, walk.warm_init(f32, dev), device=dev)
    t = 0.0
    for _ in range(n_stand):
        loop, lci = step.closed_loop_tick_lci(loop, lci, params, stand, walk,
                                              t)
        t += 0.01
    z_stand = loop.sim.pos[0, 2].clone()
    loop = set_mode(loop, 1)
    x0 = loop.sim.pos[0, 0].clone()
    qps, rec, times = [], [], []
    solve = pdip._solve

    def cap(P, q, mu, fz_max, contact, **kw):
        qps.append((P[0].cpu(), q[0].cpu(), mu.cpu(), fz_max.cpu(),
                    contact[0].cpu()))
        return solve(P, q, mu, fz_max, contact, **kw)
    sync(dev)
    with launch_counts() as launches, contextlib.ExitStack() as stack:
        if capture:
            stack.enter_context(patched(pdip, _solve=cap))
        for k in range(n_walk):
            t1 = time.perf_counter()
            loop, lci = step.closed_loop_tick_lci(loop, lci, params, stand,
                                                  walk, t)
            t += 0.01
            if k >= n_walk - timed:
                sync(dev)
                times.append(time.perf_counter() - t1)
            rec.append(torch.cat([loop.sim.pos[0, 2:3],
                                  loop.controller.fbk.root_euler[0, :2]]))
    rec = torch.stack(rec).double().cpu().numpy()
    return dict(z_stand=float(z_stand), dx=float(loop.sim.pos[0, 0] - x0),
                loop=loop, z=rec[:, 0], rp=np.abs(rec[:, 1:]).max(-1),
                launches=dict(launches), times=times, qps=qps,
                params=params)


def lci_gate(dev_type="cuda"):
    """tests/test_lci.py:92-125's recipe, in a process of its own; returns
    plain numbers and the walk's QPs."""
    r = lci_ticks(torch.device(dev_type, 0), "lci", LCI_STAND, LCI_WALK,
                  capture=True)
    pos = r["loop"].sim.pos[0]
    eul = r["loop"].controller.fbk.root_euler[0]
    return dict(z_stand=r["z_stand"], dx=r["dx"], z=float(pos[2]),
                roll=float(eul[0]), pitch=float(eul[1]),
                finite=bool(torch.isfinite(pos).all()),
                launches=r["launches"], qps=r["qps"])


def ci1_gate(dev_type="cuda"):
    """tests/test_ci_mpc.py:142-179's recipe, in a process of its own."""
    r = lci_ticks(torch.device(dev_type, 0), "ci", CI1_STAND, CI1_WALK)
    pos = r["loop"].sim.pos[0]
    return dict(x=float(pos[0]), z=float(pos[2]), z_min=float(r["z"].min()),
                worst_rp=float(r["rp"].max()), launches=r["launches"],
                finite=bool(torch.isfinite(pos).all()))


def phase_lci(dev, card, gates):
    """The rest of the contact-implicit MPC on the card, one robot each:
    the gate runs (`submit_gates`), side by side in processes of their
    own, of the wall lean on the articulated twin for Go1 and A1
    (tests/test_ci_wall_lean.py), the `--mpc lci` walk (tests/test_lci.py)
    and the single-robot flat CI walk (tests/test_ci_mpc.py). The lean's
    tick time is its gate's, beside the other processes (diagnostic,
    host-bound); the two walks are timed alone, `phase_lci_timed`.
    Returns the lean gates' first-tick gain systems, the LCI walk's QPs
    and each path's launches a tick."""
    t0 = phase(f"the wall lean (Go1, A1: {LEAN_TICKS} ticks, "
               f"{LEAN_ITERS} sweeps, the twin), the LCI walk (A1: "
               f"{LCI_STAND} stand + {LCI_WALK} walk ticks) and the "
               f"single-robot CI walk (A1: {CI1_STAND} + {CI1_WALK} ticks, "
               "32 sweeps): four processes, started with config 4's")
    lean = {rb: gates["lean", rb].result() for rb in LEAN_ROBOTS}
    for rb, r in lean.items():
        lean_verdict(rb, r)
        ms = float(np.median(r["times"][LEAN_SETTLE:])) * 1e3
        print(f"   wb_ci_lean_single_robot_tick_ms_{rb} = {ms:.2f} (median "
              f"of the gate's ticks after tick {LEAN_SETTLE}, beside the "
              f"other gate processes; {card}; diagnostic, host-bound; the "
              "MPC thread's budget 10 ms)", flush=True)
    w = gates["lci", None].result()
    print(f"   LCI walk: launches over {LCI_WALK} walk ticks "
          f"{w['launches']}; z after the stand {w['z_stand']:.4f} m, x "
          f"progress {w['dx']:.4f} m, z {w['z']:.4f} m, roll "
          f"{w['roll']:.4f}, pitch {w['pitch']:.4f} rad", flush=True)
    want = {k: LCI_WALK * v for k, v in LCI_LAUNCHES.items()}
    check(w["launches"] == want,
          f"LCI walk: launches {w['launches']}, want {want}")
    check(w["finite"], "LCI walk: non-finite")
    check(0.27 < w["z_stand"] < 0.33, f"LCI stand: z {w['z_stand']}")
    check(w["dx"] > 0.05, f"LCI walk: dx {w['dx']}")
    check(w["z"] > 0.2, f"LCI walk: z {w['z']}")
    check(abs(w["roll"]) < 0.2 and abs(w["pitch"]) < 0.2,
          f"LCI walk: roll {w['roll']}, pitch {w['pitch']}")
    c = gates["ci1", None].result()
    print(f"   single-robot CI walk: launches over {CI1_WALK} walk ticks "
          f"{c['launches']}; x {c['x']:.4f} m, z {c['z']:.4f} m, min z "
          f"{c['z_min']:.4f} m, worst |roll|,|pitch| {c['worst_rp']:.4f} "
          "rad", flush=True)
    check(c["launches"] == {"ci_sweeps": CI1_WALK},
          f"CI walk: launches {c['launches']}")
    check(c["finite"], "CI walk: non-finite")
    check(c["x"] > 0.15, f"CI walk: x {c['x']}")
    check(0.25 < c["z"] < 0.35, f"CI walk: z {c['z']}")
    check(c["worst_rp"] < 0.25, f"CI walk: worst roll/pitch {c['worst_rp']}")
    check(c["z_min"] > 0.1, f"CI walk: fell (min z {c['z_min']})")
    done(t0)
    per_tick = {
        "lean": {k: v // LEAN_TICKS for k, v in
                 lean[LEAN_ROBOTS[0]]["launches"].items()},
        "lci_walk": {k: v // LCI_WALK for k, v in w["launches"].items()},
        "ci_single": {k: v // CI1_WALK for k, v in c["launches"].items()}}
    return ({rb: (r["A"], r["R"]) for rb, r in lean.items()}, w["qps"],
            per_tick)


def phase_lci_timed(dev, card):
    """The LCI walk's and the single-robot CI walk's ticks, alone on the
    card: LCI_TIMED_STAND stand ticks, then LCI_TIMED walk ticks, each
    timed. Returns the median ms of each."""
    t0 = phase(f"the LCI walk and the single-robot CI walk timed, alone on "
               f"the card: {LCI_TIMED_STAND} stand + {LCI_TIMED} walk ticks")
    out = {}
    for kind, name, want in (
            ("lci", "lci_walk_single_robot_tick_ms", LCI_LAUNCHES),
            ("ci", "ci_single_robot_tick_ms_flat", {"ci_sweeps": 1})):
        r = lci_ticks(dev, kind, LCI_TIMED_STAND, LCI_TIMED, LCI_TIMED)
        want = {k: LCI_TIMED * v for k, v in want.items()}
        check(r["launches"] == want, f"{name}: launches {r['launches']}")
        out[kind] = float(np.median(r["times"])) * 1e3
        print(f"   {name} = {out[kind]:.2f} (median of {LCI_TIMED} walk "
              f"ticks; {card}; diagnostic; the MPC thread's budget 10 ms)",
              flush=True)
    done(t0)
    return out


def lean_batch(dev, batch, seed):
    """Lean states perturbed from a seed about the lean pose (position 1
    cm, attitude 0.03 rad, rates 0.05, feet 3 mm) with their templates,
    the A1 params and the wall: the batched wall solve's inputs."""
    from legged_mpc_control_tpu_torch.mpc import ci_mpc

    L = lean_setup(dev, "a1")
    tgt, pos, eul = L["pose"]
    p = L["params"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.tensor([0.01] * 3 + [0.03] * 3 + [0.05] * 6
                         + [0.003] * 12, device=dev)
    z0 = (torch.cat([pos, eul, torch.zeros(6, device=dev), tgt.reshape(12)])
          + scale * torch.randn((batch, 24), generator=gen, device=dev))
    rz, ru, U0 = ci_mpc.make_ci_lean_reference(z0, L["wall"], tgt, pos, eul,
                                               p, None)
    args = (z0, U0, rz, ru, None, p.mass, p.trunk_inertia.expand(batch, 3, 3),
            p.mu)
    return args, dict(iters=LEAN_ITERS, wall=L["wall"])


def phase_wall_k46(dev, card, systems):
    """Kernels K4 + K6 on the wall branch: against their plain versions
    (`check_k4_k6`, the box-step phase's criterion) on the gain systems of
    each lean gate's first tick (B=1, 240 solves) and of one batched wall
    solve (`ci_solve_batched(wall=...)`, "lanes") over LEAN_B lean states
    perturbed from a seed; that whole solve against "plain" in float32
    and float64 (every scenario within K7_TOL's bracket of plain or nearer
    float64 than plain, and no farther from float64 than plain x1.5 + the
    tolerance at the 99th percentile); then
    K4 and K6 timed at the lean's shape, n=24, m=25, B=1."""
    from legged_mpc_control_tpu_torch.mpc import ci_mpc
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    t0 = phase(f"K4 + K6 on the wall branch vs plain: the lean gates' first "
               f"ticks (B=1) and a batched wall solve, B={LEAN_B}, "
               f"{LEAN_ITERS} sweeps")
    errs = []
    for rb, (A, R) in systems.items():
        errs.append(check_k4_k6(A.to(dev), R.to(dev), 0.9,
                                f"lean {rb}, tick 1")[1])
    args, kw = lean_batch(dev, LEAN_B, 5)
    seen = []
    factor, solve = chol_kernel.cholesky_cuda, chol_kernel.cho_solve_multi_cuda

    def cap_factor(A):
        seen.append([A.clone()])
        return factor(A)

    def cap_solve(F, R):
        seen[-1].append(R.clone())
        return solve(F, R)
    with patched(chol_kernel, cholesky_cuda=cap_factor,
                 cho_solve_multi_cuda=cap_solve):
        lanes = ci_mpc.ci_solve_batched(*args, backend="lanes", **kw)
    check(len(seen) == LEAN_ITERS * 10,
          f"the wall solve made {len(seen)} gain solves")
    A = torch.cat([a for a, _ in seen])
    R = torch.cat([r for _, r in seen])
    errs.append(check_k4_k6(A, R, 0.9, f"batched wall solve, {len(seen)} "
                            f"stages x B={LEAN_B}")[1])
    plain = ci_mpc.ci_solve_batched(*args, backend="plain", **kw)
    args64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    kw64 = dict(kw, wall=kw["wall"].replace(
        point=kw["wall"].point.double(), normal=kw["wall"].normal.double()))
    ref64 = ci_mpc.ci_solve_batched(*args64, backend="plain", **kw64)

    def scaled(out):
        U, Z, cost = out
        return (torch.cat([U[..., :12] / 50.0, U[..., 12:]], -1), Z, cost)
    check(all(bool(torch.isfinite(x).all()) for x in lanes),
          "the wall solve on K4 + K6: non-finite")
    e = k7_errors(scaled(lanes), scaled(plain))
    e64, p64 = (k7_errors(scaled(x), scaled(ref64)) for x in (lanes, plain))
    for name, tol in K7_TOL.items():
        k99 = float(torch.quantile(e64[name], 0.99))
        q99 = float(torch.quantile(p64[name], 0.99))
        # scenario-wise (ROADMAP fault 1's form): within the bracket of
        # plain, or nearer float64 than plain is
        out = (e[name] > tol) & (e64[name] > p64[name])
        print(f"   whole wall solve, lanes vs plain {name}: max "
              f"{float(e[name].max()):.3e} (tol {tol}), "
              f"{int((e[name] > tol).sum())} of {LEAN_B} beyond it, "
              f"{int(out.sum())} of them farther from float64 than plain; "
              f"vs float64 p99: lanes {k99:.3e}, plain {q99:.3e}",
              flush=True)
        check(not bool(out.any()), f"the wall solve: lanes vs plain {name}"
              f" {float(e[name].max())}, farther from float64 than plain")
        check(k99 <= 1.5 * q99 + tol,
              f"the wall solve {name}: p99 {k99} from float64, plain {q99}")
    A1, R1 = systems[LEAN_ROBOTS[0]]
    A1, R1 = A1[:1].to(dev), R1[:1].to(dev)
    n, m = R1.shape[1], R1.shape[2]
    F1 = chol_kernel.cholesky_cuda(A1)
    out = dict(
        err6=max(errs),
        ms4=cuda_ms(lambda: chol_kernel.cholesky_cuda(A1), reps=50),
        plain4=cuda_ms(lambda: chol_kernel.cholesky_plain(A1), reps=10),
        lib4=cuda_ms(lambda: torch.linalg.cholesky_ex(A1), reps=10),
        ms6=cuda_ms(lambda: chol_kernel.cho_solve_multi_cuda(F1, R1),
                    reps=50),
        plain6=cuda_ms(lambda: chol_kernel.cho_solve_multi_plain(F1, R1),
                       reps=10),
        lib6=cuda_ms(lambda: torch.cholesky_solve(R1, F1.tril()), reps=10),
        bound4=bound(tri(n) * 2 * 4, n ** 3 / 3),
        bound6=bound((tri(n) + 2 * n * m) * 4, 2 * n * n * m))
    print(f"   time at B=1 ({card}): K4 n={n} kernel {out['ms4']:.4f} ms, "
          f"plain {out['plain4']:.4f} ms, torch.linalg.cholesky_ex "
          f"{out['lib4']:.4f} ms, bound {out['bound4'][0]:.3g} ms "
          f"({out['bound4'][1]}); K6 n={n}, m={m} kernel {out['ms6']:.4f} "
          f"ms, plain {out['plain6']:.4f} ms, torch.cholesky_solve "
          f"{out['lib6']:.4f} ms, bound {out['bound6'][0]:.3g} ms "
          f"({out['bound6'][1]})", flush=True)
    done(t0)
    return out


def phase_lci_pdip(dev, card, qps):
    """Kernels K4 + K5 at n=96, B=1 on the LCI walk's own condensed QPs
    (every walk tick's, as `make_walk_policy` hands them to the PDIP), in
    the PDIP phase's form: each QP solved at B=1 (12 iterations, the
    unbatched rule) with the kernels, with their plain versions and in
    float64; the solves' GRFs held, as the PDIP phase holds them, at the
    99th percentile no farther from float64 than plain x1.5 + PDIP_BRACKET
    and by the size of the tail beyond the bracket. The PDIP phase's third
    rule, the two float32 solves within the bracket of each other, does not
    hold here for any float32 factorization: at 12 iterations both sit
    ~0.2 N from the float64 solve (whose freeze, clip and regularization
    differ by design), and a factor computed in float64 and rounded moves
    the plain solve as far as the kernels do (`tools/lci_pdip_rounding.py`;
    its difference is printed). Then the Newton matrices of the kernels' solves held by the factor's
    and the solve's residuals, 4x plain's + 1e-6, where the float64
    pivots are robust; then K4 and K5 timed at n=96, B=1."""
    from legged_mpc_control_tpu_torch.mpc import pdip
    from legged_mpc_control_tpu_torch.ops import chol_kernel

    t0 = phase(f"K4 + K5 at n=96, B=1 vs plain and float64: the LCI walk's "
               f"{len(qps)} QPs, 12 PDIP iterations each")
    mats = []
    factor = chol_kernel.cholesky_cuda

    def capture(K):
        mats.append(K.clone())
        return factor(K)

    def solve(P, q, mu, fz_max, c, dt=torch.float32):
        return pdip._solve(P.to(dev, dt)[None], q.to(dev, dt)[None],
                           mu.to(dev, dt), fz_max.to(dev, dt),
                           c.to(dev, dt)[None], iters=12, tol=None,
                           warm_u=None, dual_freeze=False).u[0]
    with patched(chol_kernel, cholesky_cuda=capture):
        u_k = torch.stack([solve(*qp) for qp in qps])
    plain = dict(cholesky_cuda=chol_kernel.cholesky_plain,
                 cho_solve_cuda=chol_kernel.cho_solve_plain)
    with patched(chol_kernel, **plain):
        u_p = torch.stack([solve(*qp) for qp in qps])
        u64 = torch.stack([solve(*qp, dt=torch.float64) for qp in qps])
    check(bool(torch.isfinite(u_k).all()), "LCI PDIP on K4/K5: non-finite")
    d = (u_k - u_p).abs().amax(-1).double()
    d_k64 = (u_k.double() - u64).abs().amax(-1)
    d_p64 = (u_p.double() - u64).abs().amax(-1)
    p99, k99, q99 = (float(torch.quantile(x, 0.99))
                     for x in (d, d_k64, d_p64))
    n_ok, n_op = (int((x > PDIP_BRACKET).sum()) for x in (d_k64, d_p64))
    print(f"   |u_kernels - u_plain| per QP: p99 {p99:.3e}, max "
          f"{float(d.max()):.3e} N ({int((d > PDIP_BRACKET).sum())} of "
          f"{len(qps)} over {PDIP_BRACKET} N); vs float64 p99: kernels "
          f"{k99:.3e}, plain {q99:.3e} N; over {PDIP_BRACKET} N from "
          f"float64: kernels {n_ok}, plain {n_op}", flush=True)
    check(k99 <= 1.5 * q99 + PDIP_BRACKET,
          f"LCI PDIP: p99 {k99} N from float64, plain {q99} N")
    check(n_ok <= 3 * n_op + PDIP_TAIL_SLACK,
          f"LCI PDIP: {n_ok} QPs over {PDIP_BRACKET} N from float64")
    K = torch.cat(mats)
    check(K.shape[1:] == (96, 96) and len(mats) == 12 * len(qps),
          f"LCI PDIP: {len(mats)} Newton matrices of shape {K.shape[1:]}")
    gen = torch.Generator(device=dev).manual_seed(96)
    rhs = torch.randn((K.shape[0], 96), generator=gen, device=dev)
    F, Fp = chol_kernel.cholesky_cuda(K), chol_kernel.cholesky_plain(K)
    x = chol_kernel.cho_solve_cuda(F, rhs)
    xp = chol_kernel.cho_solve_plain(Fp, rhs)
    L64, info = torch.linalg.cholesky_ex(K.double())
    robust = (info == 0) & ((L64.diagonal(dim1=-2, dim2=-1) ** 2
                             / K.double().diagonal(dim1=-2, dim2=-1)).amin(-1)
                            >= ROBUST_PIVOT)
    check(bool(torch.isfinite(F[robust]).all() & torch.isfinite(
        x[robust]).all()), "K4 + K5 at n=96: a robust matrix failed")

    def resid(F, x):
        Kd = K[robust].double()
        L = F[robust].double().tril()
        rf = float(((L @ L.mT - Kd).abs().amax((-1, -2))
                    / Kd.abs().amax((-1, -2))).max())
        r = (Kd @ x[robust].double()[..., None])[..., 0] - rhs[robust].double()
        rs = float((r.abs().amax(-1) / rhs[robust].double().abs().amax(-1))
                   .max())
        return rf, rs
    (rf, rs), (rfp, rsp) = resid(F, x), resid(Fp, xp)
    err4 = float((F - Fp)[robust].abs().max())
    err5 = float((x - xp)[robust].abs().max())
    print(f"   {int(robust.sum())} of {K.shape[0]} Newton matrices with robust"
          f" pivots: factor residual kernel {rf:.3e}, plain {rfp:.3e}; solve"
          f" residual kernel {rs:.3e}, plain {rsp:.3e}; max |F - F_plain| "
          f"{err4:.3e}, max |x - x_plain| {err5:.3e}", flush=True)
    check(rf <= 4 * rfp + 1e-6, f"K4 at n=96: residual {rf} vs {rfp}")
    check(rs <= 4 * rsp + 1e-6, f"K5 at n=96: residual {rs} vs {rsp}")
    K1, b1 = K[:1], rhs[:1]
    F1 = chol_kernel.cholesky_cuda(K1)
    n = 96
    out = dict(
        err4=err4, err5=err5,
        ms4=cuda_ms(lambda: chol_kernel.cholesky_cuda(K1), reps=50),
        plain4=cuda_ms(lambda: chol_kernel.cholesky_plain(K1), reps=10),
        lib4=cuda_ms(lambda: torch.linalg.cholesky_ex(K1), reps=10),
        ms5=cuda_ms(lambda: chol_kernel.cho_solve_cuda(F1, b1), reps=50),
        plain5=cuda_ms(lambda: chol_kernel.cho_solve_plain(F1, b1),
                       reps=10),
        lib5=cuda_ms(lambda: torch.cholesky_solve(b1[..., None], F1.tril()),
                     reps=10),
        bound4=bound(tri(n) * 2 * 4, n ** 3 / 3),
        bound5=bound((tri(n) + 2 * n) * 4, 2 * n * n))
    print(f"   time at B=1 ({card}): K4 n=96 kernel {out['ms4']:.4f} ms, "
          f"plain {out['plain4']:.4f} ms, torch.linalg.cholesky_ex "
          f"{out['lib4']:.4f} ms, bound {out['bound4'][0]:.3g} ms "
          f"({out['bound4'][1]}); K5 kernel {out['ms5']:.4f} ms, plain "
          f"{out['plain5']:.4f} ms, torch.cholesky_solve {out['lib5']:.4f} "
          f"ms, bound {out['bound5'][0]:.3g} ms ({out['bound5'][1]})",
          flush=True)
    done(t0)
    return out


# ---- the CI closed loop on estimated state and with the WBC (A1, flat) ----

# tools/ci_estimated_census.py's recipe: chip_smoke's CI batch (`ci_setup`,
# velx 0.1, 24 warm sweeps) standing CIE_STAND ticks on the stand policy
# while a filter settles, then walking. (Walking from the first tick, the
# JAX package loses most scenarios on either filter: ROADMAP fault 15.)
# name -> (tick keywords, batch, walking ticks, of them timed)
CIE_STAND = 20
CIE_VARIANTS = {"kf1": (dict(kf_type=1), 256, 40, 10),
                "kf2": (dict(kf_type=2), 256, 40, 10),
                "wbc": (dict(low_level_type=1), 32, 10, 10),
                "unfused": (dict(fused_substeps=False), 32, 40, 0)}
CIE_SEED = 11
CIE_UPRIGHT = (0.15, 0.5)       # m, the trunk height of an upright robot
# the least share of scenarios finite and upright at the end:
# the JAX package's own share over the census recipe (B=32, float32 and
# float64)
CIE_MIN_SHARE = {"kf1": 1.0, "kf2": 1.0, "wbc": 0.0, "unfused": 1.0}
# the WBC variant never stands on the SRB sim in either package (ROADMAP
# fault 15): its mean trunk height lost over the run, and the band around
# the JAX package's that holds the port to it
CIE_WBC_SINK = (0.442, 0.02)
# bench.py:221-222, the filters' mean z error and xy drift over the upright
# scenarios; bench.py:128-132, the unfused loop against the fused one:
# mean position deviation and the shift of the mean height
CIE_EST_Z, CIE_EST_XY = 0.025, 0.04
CIE_DEV, CIE_DZ = 2e-3, 1e-3
# the runs at B=32 whose K7 call on the first walking tick is held to the
# plain version (k7_gate), and whether to its bracket (K7_TOL for K7_SHARE
# of the scenarios). The WBC run's robots have sunk 0.2 m into the ground
# by then: the optimum is flat, and in one scenario of 32 the two best
# line-search candidates cost the same to one float32 rounding (ROADMAP
# fault 17), so there only the cost is held
CIE_K7_CHECKED = {"unfused": True, "wbc": False}
# the WBC's feed-forward torques (N m) and forces (N) on the card against
# the CPU's on the same inputs: both solve the hierarchy in float64, so
# they differ by the order of float64 roundings only
CIE_WBC_TAU_TOL, CIE_WBC_F_TOL = 1e-6, 1e-5


def upright(pos):
    """(B,) whether each trunk height of pos (B,3) is an upright robot's."""
    z = torch.nan_to_num(pos[:, 2])
    return (z > CIE_UPRIGHT[0]) & (z < CIE_UPRIGHT[1])


def ci_est_run(dev, kw, batch, n_walk, n_timed):
    """One CI batch (`ci_setup`) through `closed_loop_tick_lci_batched`
    with the tick keywords `kw`: CIE_STAND standing ticks, then n_walk
    walking ticks, the last n_timed of them timed. Returns (final loop,
    start positions, the launches of the whole run, the timed seconds,
    seen): seen["k7"] holds K7's arguments on the first walking tick,
    seen["wbc"] the WBC's first inputs after the first tick (with
    low_level_type 1), both as CPU copies."""
    from legged_mpc_control_tpu_torch.control import wbc
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    st = ci_setup(dev, batch, 24, seed=CIE_SEED, mode=0)
    pos0 = st["loop"].sim.pos.clone()
    seen = {}
    k7, wbc_fn = ci_kernel.ci_sweeps_cuda, wbc.wbc_from_controller

    def cap_k7(*a, **k):
        seen.setdefault("k7", (to_device(a, "cpu"), to_device(k, "cpu")))
        return k7(*a, **k)

    def cap_wbc(fbk, ctrl, model, **k):
        seen.setdefault("wbc", tuple(
            {f: getattr(o, f).cpu() for f in fields} for o, fields in
            ((fbk, wbc._FBK_READ), (ctrl, wbc._CTRL_READ))))
        return wbc_fn(fbk, ctrl, model, **k)
    sync(dev)
    with launch_counts() as launches:
        ci_roll(st, 1, **kw)
        with patched(wbc, wbc_from_controller=cap_wbc):
            ci_roll(st, CIE_STAND - 1, k0=1, **kw)
        st["loop"] = set_mode(st["loop"], 1)
        with patched(ci_kernel, ci_sweeps_cuda=cap_k7):
            ci_roll(st, n_walk - n_timed, k0=CIE_STAND, **kw)
            sync(dev)
            t1 = time.perf_counter()
            ci_roll(st, n_timed, k0=CIE_STAND + n_walk - n_timed, **kw)
            sync(dev)
            elapsed = time.perf_counter() - t1
    return st["loop"], pos0, dict(launches), elapsed, seen


def to_device(x, dev):
    """x (a tensor, or a tuple or dict of them and plain values) on dev."""
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, tuple):
        return tuple(to_device(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: to_device(v, dev) for k, v in x.items()}
    return x


def ci_est_gate(name, dev_type="cuda"):
    """One variant of CIE_VARIANTS, in a process of its own; returns plain
    numbers and CPU tensors (for "unfused" also the fused run's numbers
    from the same start; for "wbc" and "unfused" K7's arguments on the
    first walking tick, for "wbc" the WBC's inputs, for the parent to
    check)."""
    dev = torch.device(dev_type, 0)
    kw, batch, n_walk, n_timed = CIE_VARIANTS[name]
    loop, pos0, launches, elapsed, seen = ci_est_run(dev, kw, batch, n_walk,
                                                     n_timed)
    pos, cs = loop.sim.pos, loop.controller
    est = {1: cs.kf.x, 2: cs.ekf.x}.get(kw.get("kf_type"))
    finite = torch.isfinite(pos).all(-1)
    if est is not None:
        finite &= torch.isfinite(est).all(-1)
    ok = finite & upright(pos)
    out = dict(batch=batch, ticks=CIE_STAND + n_walk, launches=launches,
               upright=int(ok.sum()), finite=int(finite.sum()),
               progress=float((pos[ok, 0] - pos0[ok, 0]).mean())
               if bool(ok.any()) else None,
               sink=float((pos0[finite, 2] - pos[finite, 2]).mean()),
               rate=batch * n_timed / elapsed if n_timed else None,
               tick_ms=elapsed / n_timed * 1e3 if n_timed else None)
    if name in CIE_K7_CHECKED:
        out["k7"] = seen["k7"]
    if name == "wbc":
        out["wbc"] = seen["wbc"]
    if est is not None:
        err = (est[ok, 0:3] - pos[ok]).abs()
        out.update(est_z=float(err[:, 2].mean()),
                   est_xy=float(err[:, 0:2].mean()))
    if name == "unfused":
        fused, _, f_launches, _, _ = ci_est_run(dev, {}, batch, n_walk, 0)
        fp = fused.sim.pos
        both = ok & torch.isfinite(fp).all(-1)
        out.update(fused_launches=f_launches,
                   fused_upright=int((torch.isfinite(fp).all(-1)
                                      & upright(fp)).sum()),
                   dev=float((pos[both] - fp[both]).abs().mean()),
                   dz=abs(float(pos[both, 2].mean() - fp[both, 2].mean())))
    return out


def ci_est_k7(dev, name, r):
    """K7 against its plain version (k7_gate, CIE_K7_CHECKED) on the
    arguments it had on the first walking tick of the run `name` at B=32,
    24 sweeps. Returns the kernel's largest Z error against plain
    float32."""
    from legged_mpc_control_tpu_torch.ops import ci_kernel

    a, kw = to_device(r["k7"], dev)
    return k7_gate(ci_kernel.ci_sweeps_cuda(*a, **kw), a, kw,
                   f"B={a[0].shape[0]}, {kw['iters']} sweeps, {name} run",
                   bracket=CIE_K7_CHECKED[name])


def ci_est_wbc(dev, r):
    """The WBC's feed-forward torques and forces on the card against the
    same function on the CPU (both solve the hierarchy in float64), on the
    inputs the CI loop's WBC had after its first tick: as they were (the
    foot sensor's contacts: none) and with all four feet in contact (the
    contact forces' levels). Returns the largest torque and force
    differences."""
    from types import SimpleNamespace

    from legged_mpc_control_tpu_torch.control import wbc
    from legged_mpc_control_tpu_torch.models import whole_body as wb

    fbk, ctrl = r["wbc"]
    errs = {}
    for case, contacts in (("sensor contacts", None), ("four contacts", 1.0)):
        c = dict(ctrl)
        if contacts is not None:
            c["plan_contacts"] = torch.full_like(c["plan_contacts"],
                                                 contacts)
        (tau, F), (tau_c, F_c) = (
            [x.cpu() for x in wbc.wbc_from_controller(
                SimpleNamespace(**to_device(fbk, d)),
                SimpleNamespace(**to_device(c, d)),
                wb.a1_wb_model(torch.float32, d))]
            for d in (dev, torch.device("cpu")))
        check(all(bool(torch.isfinite(x).all()) for x in (tau, F)),
              f"WBC on the card, {case}: non-finite")
        e_tau = float((tau.double() - tau_c.double()).abs().max())
        e_F = float((F.double() - F_c.double()).abs().max())
        print(f"   WBC card vs CPU, {case} (B={tau.shape[0]}): max |tau| "
              f"{float(tau_c.abs().max()):.3e} N m, max |F| "
              f"{float(F_c.abs().max()):.3e} N; differences: tau "
              f"{e_tau:.3e} N m (tol {CIE_WBC_TAU_TOL}), F {e_F:.3e} N (tol "
              f"{CIE_WBC_F_TOL})", flush=True)
        check(e_tau < CIE_WBC_TAU_TOL and e_F < CIE_WBC_F_TOL,
              f"WBC card vs CPU, {case}: tau {e_tau}, F {e_F}")
        errs[case] = (e_tau, e_F)
    return errs


def phase_ci_estimated(dev, card, gates):
    """The batched CI closed loop on estimated state and with the WBC: the
    four runs of CIE_VARIANTS, each in a process of its own beside the
    other gate runs (`submit_gates`): the upright share at least the JAX
    package's, forward progress, the filters within bench.py's limits,
    the unfused loop within bench.py's deviation rule of the fused one,
    and the launches: K7 once a tick in every run, K2 once a tick in the
    fused kf_type-0 run only, nothing else. Then, here, K7 against its
    plain version at B=32 on the first walking tick of the WBC and the
    unfused runs, and the WBC's torques on the card against the CPU's.
    Returns (K7's launches a tick by variant, K7's largest Z error at
    B=32 by run)."""
    t0 = phase(f"CI closed loop on estimated state: A1, {CIE_STAND} stand "
               "ticks then walking; kf_type 1 and 2 (B=256, 40 walk ticks, "
               "10 timed), low_level_type 1 (B=32, 10 timed), kf_type 0 "
               "unfused beside fused (B=32, 40): four processes beside the "
               "gate runs")
    per_tick = {}
    for name, (kw, batch, n_walk, n_timed) in CIE_VARIANTS.items():
        r = gates["ci_est", name].result()
        n = r["ticks"]
        share = r["upright"] / batch
        line = (f"   {name}: {r['upright']} of {batch} finite and upright "
                f"(the JAX package's share {CIE_MIN_SHARE[name]}), "
                f"{r['finite']} finite, mean progress {r['progress']} m, "
                f"mean height lost {r['sink']:.4f} m; launches over {n} "
                f"ticks {r['launches']}")
        if "est_z" in r:
            line += (f"; estimate: mean z error {r['est_z']:.4e} m, xy "
                     f"drift {r['est_xy']:.4e} m")
        if name == "unfused":
            line += (f"; the fused run: {r['fused_upright']} upright, "
                     f"launches {r['fused_launches']}; unfused vs fused: "
                     f"mean |dpos| {r['dev']:.3e} m, mean height shift "
                     f"{r['dz']:.3e} m")
        print(line, flush=True)
        check(share >= CIE_MIN_SHARE[name],
              f"CI {name}: {r['upright']} of {batch} upright")
        if name == "wbc":
            # the reference's WBC loop on the SRB sim falls freely (fault
            # 15): held to its finite share and its mean height lost here,
            # the WBC's own output below (ci_est_wbc)
            check(r["finite"] == batch, f"CI wbc: {r['finite']} finite")
            check(abs(r["sink"] - CIE_WBC_SINK[0]) < CIE_WBC_SINK[1],
                  f"CI wbc: mean height lost {r['sink']}, the JAX "
                  f"package's {CIE_WBC_SINK[0]}")
        else:
            check(r["progress"] is not None and r["progress"] > 0.0,
                  f"CI {name}: progress {r['progress']}")
        check(r["launches"] == {"ci_sweeps": n},
              f"CI {name}: launches {r['launches']}, want K7 {n}")
        if "est_z" in r:
            check(r["est_z"] < CIE_EST_Z and r["est_xy"] < CIE_EST_XY,
                  f"CI {name}: estimate off by {r['est_z']}, "
                  f"{r['est_xy']} m")
        if name == "unfused":
            check(r["fused_launches"] == {"ci_sweeps": n,
                                          "substep_chain": n},
                  f"CI fused: launches {r['fused_launches']}")
            check(r["fused_upright"] / batch >= CIE_MIN_SHARE[name],
                  f"CI fused: {r['fused_upright']} of {batch} upright")
            check(r["dev"] < CIE_DEV and r["dz"] < CIE_DZ,
                  f"CI unfused vs fused: {r['dev']}, {r['dz']}")
        per_tick[name] = r["launches"]["ci_sweeps"] // n
    for name, metric in (("kf1", "ci_closed_loop_scenario_ticks_per_s_"
                                 "b256_kf1"),
                         ("kf2", "ci_closed_loop_scenario_ticks_per_s_"
                                 "b256_kf2"),
                         ("wbc", "ci_wbc_closed_loop_scenario_ticks_per_s_"
                                 "b32")):
        r = gates["ci_est", name].result()
        print(f"   {metric} = {r['rate']:.1f} ({r['tick_ms']:.1f} ms a "
              f"tick, beside the gate processes; {card}; diagnostic, "
              "ungated, host-bound)", flush=True)
    err32 = {name: ci_est_k7(dev, name, gates["ci_est", name].result())
             for name in CIE_K7_CHECKED}
    ci_est_wbc(dev, gates["ci_est", "wbc"].result())
    done(t0)
    return per_tick, err32


REPO_DIR = os.path.dirname(os.path.abspath(__file__))

# BASELINE config 5 (SWEEP_r05.json's recipe): the 65,536-scenario Go1 trot
# sweep, K1 + K2, as `python -m legged_mpc_control_tpu_torch.sweep` runs it;
# two shards, so that one process holds the global batch that two
# processes of one shard each hold
C5_B, C5_TICKS, C5_STAND, C5_VELX, C5_ITERS, C5_H = 65536, 25, 20, 0.15, 15, 10
C5_SHARDS = 2
# the two-process metrics against the one-process run of the same batch:
# the batches of the host's batched ops differ (32,768 against 65,536
# rows), so their float32 roundings may, over 25 closed-loop ticks
C5_METRIC_TOL = 1e-3
C5_EFF_MIN = 0.85             # BASELINE.md: weak scaling at >= 2 processes
# the report times max(2, ticks // 2) = 20 ticks a rep, 3 reps a phase
C5_EFF_BATCH, C5_EFF_TICKS = 4096, 40
C5_PROC_TIMEOUT = 300


def c5_flags():
    """The sweep CLI's flags of config 5 (its defaults, spelled out)."""
    return ["--robot", "go1", "--solver", "riccati", "--horizon", str(C5_H),
            "--iters", str(C5_ITERS), "--velx", str(C5_VELX),
            "--stand-ticks", str(C5_STAND)]


def c5_sweep(dev, mesh):
    """Config 5's params and `distributed.make_sweep` on `mesh`."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import distributed as dist

    f32 = torch.float32
    return go1_params(f32, dev), dist.make_sweep(
        gait.trot_pattern(f32, dev), mesh, horizon=C5_H, n_ticks=C5_TICKS,
        pdip_iters=C5_ITERS, solver="riccati", walk_velx=C5_VELX,
        stand_ticks=C5_STAND)


def print_metrics(label, m):
    print(f"   {label}: " + ", ".join(f"{k} {v:.6f}" for k, v in m.items()),
          flush=True)


def c5_gate(label, m, walked):
    check(m["upright_frac"] == 1.0, f"{label}: upright {m['upright_frac']}")
    check(0.2 < m["mean_height"] < 0.4,
          f"{label}: mean height {m['mean_height']}")
    if walked:
        check(m["mean_dx"] > 0.0, f"{label}: mean dx {m['mean_dx']}")


def detached(args, kw):
    """Copies of a kernel call's tensor arguments."""
    def c(x):
        return x.clone() if torch.is_tensor(x) else x
    return tuple(c(a) for a in args), {k: c(v) for k, v in kw.items()}


def phase_config5(dev, card):
    """BASELINE config 5 in one process on the card, driven through
    `parallel/distributed.make_sweep` as the sweep CLI drives it: run A,
    two reps of C5_TICKS ticks (the stand phase consumed once) and a
    sharded checkpoint; an uninterrupted third rep; run B, the checkpoint
    loaded and C5_TICKS more ticks, which must equal the third rep bit for
    bit (the same kernels at the same shapes). K1 and K2 once each a tick;
    then both held against their plain versions at B=65,536 on the sweep's
    own first-tick inputs, by the criteria of `phase_k1`'s loop call and
    `chain_gate`. Returns run A's first-rep metrics (the two-process run's
    reference) and the kernels' numbers at this batch."""
    from legged_mpc_control_tpu_torch.mpc import riccati
    from legged_mpc_control_tpu_torch.ops import riccati_kernel, substep_kernel
    from legged_mpc_control_tpu_torch.parallel import distributed as dist
    from legged_mpc_control_tpu_torch.parallel.mesh import ScenarioMesh
    from legged_mpc_control_tpu_torch.tree import tree_map

    t0 = phase(f"BASELINE config 5: the sweep, Go1, B={C5_B} ({C5_SHARDS} "
               f"shards), trot at {C5_VELX} m/s after {C5_STAND} standing "
               f"ticks, riccati iters {C5_ITERS}, H={C5_H}: run A "
               f"({2} reps of {C5_TICKS} ticks, checkpoint), run B (resume, "
               f"{C5_TICKS} ticks) against an uninterrupted third rep")
    mesh = ScenarioMesh(1, 0, C5_SHARDS, dev)
    params, sweep = c5_sweep(dev, mesh)
    loop = dist.device_sharded_loop(params, C5_B, 0, mesh)
    seen = {}
    k1, k2 = (riccati_kernel.solve_qp_riccati_cuda,
              substep_kernel.substep_chain_cuda)

    def cap1(*a, **kw):
        seen.setdefault("k1", detached(a, kw))
        return k1(*a, **kw)

    def cap2(*a, **kw):
        seen.setdefault("k2", detached(a, kw))
        return k2(*a, **kw)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls, runs = [], []
    with launch_counts() as launches_a, \
            patched(riccati_kernel, solve_qp_riccati_cuda=cap1), \
            patched(substep_kernel, substep_chain_cuda=cap2):
        final = loop
        for rep in range(2):
            t1 = time.perf_counter()
            final, m = sweep(final, params,
                             stand_ticks_now=max(0, C5_STAND
                                                 - rep * C5_TICKS))
            sync(dev)
            walls.append(time.perf_counter() - t1)
            runs.append(m)
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"riccati_ipm": 2 * C5_TICKS, "substep_chain": 2 * C5_TICKS}
    print(f"   run A: kernel launches over {2 * C5_TICKS} ticks "
          f"{launches_a}", flush=True)
    check(launches_a == want, f"config 5 run A: launches {launches_a}, "
          f"want {want}")
    for rep, m in enumerate(runs):
        print_metrics(f"run A rep {rep + 1}", m)
        c5_gate(f"config 5 run A rep {rep + 1}", m, walked=True)
    rate_a = C5_B * C5_TICKS / walls[1]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/c5"
        t1 = time.perf_counter()
        dist.save_sharded(path, final, step=2 * C5_TICKS, mesh=mesh)
        t_save = time.perf_counter() - t1
        size = os.path.getsize(f"{path}.p0")
        third, m3 = sweep(final, params, stand_ticks_now=0)
        del final
        t1 = time.perf_counter()
        loaded, step = dist.load_sharded(path, mesh)
        sync(dev)
        t_load = time.perf_counter() - t1
    check(step == 2 * C5_TICKS, f"config 5: checkpoint step {step}")
    with launch_counts() as launches_b:
        t1 = time.perf_counter()
        final_b, m_b = sweep(loaded, params,
                             stand_ticks_now=max(0, C5_STAND - step))
        sync(dev)
        wall_b = time.perf_counter() - t1
    del loaded
    rate_b = C5_B * C5_TICKS / wall_b
    print_metrics("run B (resumed)", m_b)
    print(f"   run B: kernel launches over {C5_TICKS} ticks {launches_b}; "
          f"checkpoint {size / 2 ** 20:.1f} MiB, saved in {t_save:.2f} s, "
          f"loaded in {t_load:.2f} s", flush=True)
    check(launches_b == {k: C5_TICKS for k in want},
          f"config 5 run B: launches {launches_b}")
    c5_gate("config 5 run B", m_b, walked=True)
    check(m_b["mean_dx"] > runs[1]["mean_dx"] > runs[0]["mean_dx"],
          "config 5: no forward progress across the reps")
    diffs = []

    def eq(a, b):
        diffs.append(a.dtype == b.dtype and torch.equal(a, b))
        return a
    tree_map(eq, final_b, third)
    print(f"   run B vs the uninterrupted third rep: {sum(diffs)} of "
          f"{len(diffs)} leaves equal bit for bit; metrics equal "
          f"{m_b == m3}", flush=True)
    check(all(diffs) and m_b == m3,
          "config 5: the resumed run differs from the uninterrupted rep")
    del final_b, third
    print(f"   config5_scenario_ticks_per_s = {rate_a:.1f} (run A, rep 2), "
          f"{rate_b:.1f} (run B) ({card}; real-time bar {C5_B * 100}); "
          f"peak device memory {peak / 2 ** 30:.2f} GiB "
          "(torch.cuda.max_memory_allocated over run A)", flush=True)

    # K1 and K2 at B=65,536 on the sweep's first-tick inputs
    a, kw = seen["k1"]
    print(f"   K1 at B={C5_B}: the first tick's call, iters "
          f"{kw.get('iters')}, warm start "
          f"{'zeros' if kw.get('warm_u') is not None else 'none'}",
          flush=True)
    uk, gk, _ = riccati_kernel.solve_qp_riccati_cuda(*a, **kw)
    up, gp, _ = riccati.solve_qp_riccati_batched(*a, **kw)
    a64, kw64 = (tuple(x.double() if torch.is_tensor(x)
                       and x.is_floating_point() else x for x in a),
                 {k: (v.double() if torch.is_tensor(v) else v)
                  for k, v in kw.items()})
    u64 = riccati.solve_qp_riccati_batched(*a64, **kw64)[0]
    del a64, kw64
    check(bool(torch.isfinite(uk).all()), "K1 B=65536: non-finite")
    d = (uk - up).abs().amax(-1)
    q99 = float(torch.quantile(d.double(), 0.99))
    e64 = float((uk.double() - u64).abs().max())
    p64 = float((up.double() - u64).abs().max())
    gap, gap_p = float(gk.max()), float(gp.max())
    fz = float(uk[:, 2:12:3].sum(-1).mean())
    mass = float(params.mass)
    print(f"   K1 B={C5_B}: max|u_kernel - u_plain| {float(d.max()):.3e} N "
          f"(p99 {q99:.3e}); vs float64: kernel {e64:.3e} N, plain "
          f"{p64:.3e} N; max gap kernel {gap:.3e}, plain {gap_p:.3e}; mean "
          f"stance load {fz:.2f} N", flush=True)
    check(q99 <= K1_BRACKET, f"K1 B=65536: p99 GRF difference {q99}")
    check(e64 <= 1.5 * p64 + K1_BRACKET,
          f"K1 B=65536: {e64} N from float64, plain {p64} N")
    check(gap < max(1e-4, 2.0 * gap_p), f"K1 B=65536: gap {gap}")
    check(0.3 * 9.8 * mass < fz < 2.0 * 9.8 * mass,
          f"K1 B=65536: implausible stance load {fz}")
    k1_err = float(d.max())
    del uk, up, u64
    k1_ms = cuda_ms(lambda: riccati_kernel.solve_qp_riccati_cuda(*a, **kw),
                    reps=5)
    H, iters = a[1].shape[1], kw["iters"]
    k1_bound = bound(C5_B * 4 * (NX_IN_K1(H) + NX_OUT_K1(H) + 12 * H),
                     C5_B * H * iters * K1_FLOP_PER_STAGE_ITER)
    del a, kw
    a, kw = seen.pop("k2")
    k2_err = chain_gate(f"K2 B={C5_B}",
                        substep_kernel.substep_chain_cuda(*a, **kw),
                        substep_kernel.substep_chain_plain(*a, **kw))
    k2_ms = cuda_ms(lambda: substep_kernel.substep_chain_cuda(*a, **kw),
                    reps=10)
    k2_bound = bound(
        C5_B * 4 * (substep_kernel.N_IN + 1 + substep_kernel.N_OUT),
        C5_B * (8 * K2_FLOP_PER_SUBSTEP + K2_FLOP_TAIL))
    print(f"   time at B={C5_B} ({card}): K1 {k1_ms:.3f} ms (iters "
          f"{iters}, bound {k1_bound[0]:.3g} ms, {k1_bound[1]}), K2 "
          f"{k2_ms:.4f} ms (bound {k2_bound[0]:.3g} ms, {k2_bound[1]})",
          flush=True)
    seen.clear()
    done(t0)
    return runs[0], dict(k1_ms=k1_ms, k1_err=k1_err, k2_ms=k2_ms,
                         k2_err=k2_err, k1_bound=k1_bound, k2_bound=k2_bound,
                         launches=want, rate_a=rate_a, rate_b=rate_b,
                         peak=peak)


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sweep_procs(argv, n=2):
    """`python -m legged_mpc_control_tpu_torch.sweep argv` in `n`
    processes on the one card, under torchrun's variables (Gloo on
    127.0.0.1); returns each rank's metrics record and rank 0's output."""
    port = str(free_port())
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "legged_mpc_control_tpu_torch.sweep",
             *argv, "--metrics", f"{tmp}/m"],
            env={**os.environ, "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": port, "WORLD_SIZE": str(n), "RANK": str(r),
                 "LOCAL_RANK": str(r),
                 # the host's cores shared out, as torchrun does
                 "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // n))},
            cwd=REPO_DIR, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
            for r in range(n)]
        try:
            outs = [p.communicate(timeout=C5_PROC_TIMEOUT)[0]
                    for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"sweep rank {r} exited "
                  f"{p.returncode}:\n{out[-3000:]}")
        recs = []
        for r in range(n):
            with open(f"{tmp}/m.p{r}.json") as fh:
                recs.append(json.load(fh))
    return recs, outs[0]


def phase_config5_procs(dev, card, one):
    """Config 5 across two processes on the one card, through the sweep
    CLI: 2 x 32,768 scenarios (one shard each; the global batch of
    `phase_config5`'s two shards), C5_TICKS ticks: the metrics equal on
    both ranks, and within C5_METRIC_TOL of run A's first rep. Then the
    weak-scaling report at C5_EFF_BATCH scenarios a process, efficiency
    >= C5_EFF_MIN."""
    t0 = phase(f"config 5 across two processes on the one card (Gloo): "
               f"2 x {C5_B // 2} scenarios, {C5_TICKS} ticks; then the "
               f"weak-scaling report at {C5_EFF_BATCH} a process")
    recs, out = sweep_procs(["--scenarios", str(C5_B), "--ticks",
                             str(C5_TICKS), *c5_flags()])
    print("   rank 0: " + out.strip().splitlines()[-1], flush=True)
    m0, m1 = recs[0]["metrics"], recs[1]["metrics"]
    print_metrics("rank 0", m0)
    check(m0 == m1, f"config 5, two processes: the ranks' metrics differ: "
          f"{m0} vs {m1}")
    c5_gate("config 5, two processes", m0, walked=True)
    worst = max(abs(m0[k] - one[k]) for k in one)
    print(f"   largest difference from the one-process run of the same "
          f"global batch: {worst:.3e} (tolerance {C5_METRIC_TOL})",
          flush=True)
    check(worst <= C5_METRIC_TOL, f"config 5: two processes differ from "
          f"one by {worst}")
    rate2 = C5_B * C5_TICKS / max(r["wall_s"] for r in recs)
    recs, out = sweep_procs(["--scenarios", str(2 * C5_EFF_BATCH),
                             "--ticks", str(C5_EFF_TICKS), *c5_flags(),
                             "--report-efficiency", "--per-device-batch",
                             str(C5_EFF_BATCH)])
    rep = recs[0]["report"]
    print(f"   weak scaling ({card}): {json.dumps(rep)}", flush=True)
    check(rep == recs[1]["report"], "weak-scaling reports differ")
    eff = rep["weak_scaling_efficiency"]
    check(eff >= C5_EFF_MIN, f"weak-scaling efficiency {eff} < "
          f"{C5_EFF_MIN}")
    print(f"   config5_two_process_scenario_ticks_per_s = {rate2:.1f}; "
          f"weak_scaling_efficiency_2proc = {eff:.4f} ({card})",
          flush=True)
    done(t0)
    return dict(rate2=rate2, eff=eff)


# the CLI's three MPC paths (`main.main` in a worker process): A1, 0.5 s,
# velx 0.25 (0.1 for ci); walk from tick min(20, ticks // 4)
CLI_SECONDS, CLI_TICKS = 0.5, 50
CLI_WALK_FROM = min(20, CLI_TICKS // 4)
CLI_VELX = {"convex": 0.25, "lci": 0.25, "ci": 0.1}


def cli_launches(mpc):
    """The launches a CLI run of CLI_TICKS ticks must make, every tick, the
    standing ones too (the LCI seam evaluates its walk policy every tick
    and picks by mode): the condensed build and PDIP 15 (the build kernel
    once, K4 15, K5 30); the LCI walk's, PDIP 12 at n=96 (the build once,
    K4 12, K5 24); K7 once."""
    per_tick = {"convex": {"chol_factor": 15, "chol_solve": 30,
                           "condense": 1},
                "lci": LCI_LAUNCHES, "ci": {"ci_sweeps": 1}}[mpc]
    return {k: v * CLI_TICKS for k, v in per_tick.items()}


def cli_gate(mpc, dev_type="cuda"):
    """`main.main` for `--mpc mpc` with `--bag`, in a process of its own:
    its exit code, summary, launches and the bag read back."""
    import io

    from legged_mpc_control_tpu_torch import main as cli
    from legged_mpc_control_tpu_torch.ops import cuda_build
    from legged_mpc_control_tpu_torch.utils import bag

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--robot", "a1", "--mpc", mpc, "--seconds", str(CLI_SECONDS),
                "--velx", str(CLI_VELX[mpc]), "--bag", f"{tmp}/run.npz"]
        if dev_type == "cpu":
            argv.append("--cpu")
        buf = io.StringIO()
        cuda_build.LAUNCHES.clear()
        with contextlib.redirect_stdout(buf):
            code = cli.main(argv)
        launches = dict(cuda_build.LAUNCHES)
        data, meta = bag.load_bag(f"{tmp}/run.npz")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    return dict(code=code, summary=summary, launches=launches,
                bag_ticks=int(data["root_pos"].shape[0]),
                bag_mpc=meta["args"]["mpc"],
                tick_ms=float(np.median(data["tick_wall_ms"][-20:])))


def cli_profile_gate(dev_type="cuda"):
    """The CLI with `--profile` over 2 ticks, and `python -m
    legged_mpc_control_tpu_torch --seconds 0.3` as a real subprocess, in a
    process of their own."""
    from legged_mpc_control_tpu_torch import main as cli

    extra = ["--cpu"] if dev_type == "cpu" else []
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        code = cli.main(["--seconds", "0.02", "--profile", tmp, *extra])
        trace = os.path.join(tmp, "trace.json")
        size = os.path.getsize(trace) if os.path.exists(trace) else 0
        with open(trace) as fh:
            events = len(json.load(fh)["traceEvents"])
    out = subprocess.run([sys.executable, "-m",
                          "legged_mpc_control_tpu_torch", "--seconds", "0.3",
                          *extra], cwd=REPO_DIR, capture_output=True,
                         text=True, timeout=300)
    return dict(code=code, trace_bytes=size, events=events,
                sub_code=out.returncode, sub_out=out.stdout[-2000:],
                sub_err=out.stderr[-2000:])


def phase_cli(dev, card, gates):
    """The CLI (`python -m legged_mpc_control_tpu_torch`) on the card: its
    three `--mpc` paths, each `main.main` in a process of its own beside the
    other gate runs (`submit_gates`): exit 0, upright, the kernels' launches
    a tick, the bag read back; then a 2-tick run with `--profile` and one
    real subprocess run. Returns the launches a tick of each path."""
    t0 = phase(f"the CLI: --mpc convex, lci, ci (A1, {CLI_SECONDS} s, "
               f"walking from tick {CLI_WALK_FROM}), --profile, and one "
               "subprocess run: four processes beside the gate runs")
    per_tick = {}
    for mpc in CLI_VELX:
        r = gates["cli", mpc].result()
        print(f"   --mpc {mpc}: exit {r['code']}, launches {r['launches']}, "
              f"summary {json.dumps(r['summary'])}; bag {r['bag_ticks']} "
              f"ticks; median tick {r['tick_ms']:.1f} ms (beside the gate "
              f"processes; {card})", flush=True)
        check(r["code"] == 0 and r["summary"]["upright"],
              f"CLI --mpc {mpc}: exit {r['code']}")
        want = cli_launches(mpc)
        check(r["launches"] == want,
              f"CLI --mpc {mpc}: launches {r['launches']}, want {want}")
        check(r["bag_ticks"] == CLI_TICKS and r["bag_mpc"] == mpc,
              f"CLI --mpc {mpc}: the bag did not load back")
        per_tick[mpc] = {k: v // CLI_TICKS for k, v in r["launches"].items()}
    r = gates["cli_profile", None].result()
    print(f"   --profile: exit {r['code']}, trace {r['trace_bytes']} bytes, "
          f"{r['events']} events; subprocess run: exit {r['sub_code']}, "
          f"{r['sub_out'].strip().splitlines()[-1] if r['sub_out'] else ''}",
          flush=True)
    check(r["code"] == 0 and r["events"] > 0, "CLI --profile: no trace")
    check(r["sub_code"] == 0, f"CLI subprocess exited {r['sub_code']}: "
          f"{r['sub_err']}")
    summary = json.loads(r["sub_out"].strip().splitlines()[-1])
    check(summary["upright"] and summary["final_height_m"] > 0.25,
          f"CLI subprocess: {summary}")
    done(t0)
    return per_tick


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
    admm_step = phase_admm_step(dev, card)
    condense = phase_condense(dev, card)
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
    with concurrent.futures.ProcessPoolExecutor(
            POOL_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        _, gates = phase_config4(dev, card, pool)
        phase_wb(dev, card, gates)
        lean_systems, lci_qps, per_tick = phase_lci(dev, card, gates)
        cli_per_tick = phase_cli(dev, card, gates)
        ci_est_per_tick, k7_err_b32 = phase_ci_estimated(dev, card, gates)
    config4_timed(dev, card)
    wb_k45, _, _ = phase_wb_timed(dev, card)
    phase_lci_timed(dev, card)
    wall = phase_wall_k46(dev, card, lean_systems)
    n96 = phase_lci_pdip(dev, card, lci_qps)
    t_c5 = time.perf_counter()
    c5_one, c5 = phase_config5(dev, card)
    phase_config5_procs(dev, card, c5_one)
    print(f"== config 5's phases took {time.perf_counter() - t_c5:.1f} s",
          flush=True)
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
            (k7["bound_ms"], k7["bound_by"]), None),
        row("admm_step", "admm_step.cu", REPO_ADMM,
            loops["admm"]["launches"]["admm_step"], admm_step["err"],
            admm_step["ms"], admm_step["plain_ms"], admm_step["bound"],
            None),
        row("condense", "condense.cu", REPO_CONDENSE,
            loops["admm"]["launches"]["condense"], condense["err"],
            condense["ms"], condense["plain_ms"], condense["bound"], None)]}
    # the twin's mass-matrix solve (n=18, B=256): launches a tick and time
    for r, k in zip(kernels["kernels"][3:5], ("4", "5")):
        r["launches_wb"] = wb_k45["launches_wb"][r["name"]]
        r["ms_wb"] = wb_k45["ms" + k]
    # the wall lean (K4 at n=24 and 18, K6 at n=24, m=25, K5 at n=18, B=1),
    # the LCI walk (K4 and K5 at n=96, B=1) and the single-robot CI walk
    # (K7 at B=1, 32 sweeps): launches a tick and times
    rows = {r["name"]: r for r in kernels["kernels"]}
    for name, r in rows.items():
        for path in ("lean", "lci_walk", "ci_single"):
            if name in per_tick[path]:
                r["launches_" + path] = per_tick[path][name]
    rows["chol_factor"]["ms_lean_n24_b1"] = wall["ms4"]
    rows["chol_solve_multi"]["ms_lean_b1"] = wall["ms6"]
    rows["chol_solve_multi"]["max_abs_err_lean"] = wall["err6"]
    rows["chol_factor"]["ms_n96_b1"] = n96["ms4"]
    rows["chol_solve"]["ms_n96_b1"] = n96["ms5"]
    rows["ci_sweeps"]["ms_b1"] = k7["ms1"]
    rows["ci_sweeps"]["bound_ms_b1"] = k7["bound_ms_b1"]
    for key in ("ms_b4096", "ms_b4096_latency", "bound_ms_b4096",
                "blocks_per_sm"):
        rows["ci_sweeps"][key] = k7[key]
    for r, k in zip(kernels["kernels"][1:3], (k2, k3)):
        r["ms_b256"] = k["ms_b256"]
        r["bound_ms_b256"] = k["bound_ms_b256"]
    # the CI loop on estimated state and with the WBC: K7's launches a tick
    for name, n in ci_est_per_tick.items():
        if name != "unfused":
            rows["ci_sweeps"]["launches_ci_" + name] = n
    rows["ci_sweeps"]["max_abs_err_b32"] = k7_err_b32["unfused"]
    rows["ci_sweeps"]["max_abs_err_b32_wbc"] = k7_err_b32["wbc"]
    # the ADMM step's first launch of a solve (the right-hand side alone)
    rows["admm_step"]["ms_rhs_only"] = admm_step["ms_first"]
    rows["admm_step"]["plain_ms_rhs_only"] = admm_step["plain_ms_first"]
    rows["admm_step"]["bound_ms_rhs_only"] = admm_step["bound_first"][0]
    # config 5 (B=65,536): launches a tick, time, error and bound; the
    # CLI's paths: launches a tick
    for name, k in (("riccati_ipm", "k1"), ("substep_chain", "k2")):
        r = rows[name]
        r["launches_sweep_per_tick"] = c5["launches"][name] // (2 * C5_TICKS)
        r["ms_b65536"] = c5[k + "_ms"]
        r["max_abs_err_b65536"] = c5[k + "_err"]
        r["bound_ms_b65536"] = c5[k + "_bound"][0]
    for mpc, counts in cli_per_tick.items():
        for name, n in counts.items():
            rows[name]["launches_cli_" + mpc] = n
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
