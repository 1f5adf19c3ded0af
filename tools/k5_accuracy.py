"""K5 and K6 against another checkout's K5 and K6, element by element, and
their times side by side.

    python3 tools/k5_accuracy.py [TREE ...]

TREE is another checkout of the port (its `csrc/chol_lanes.cu` built with
nvcc for sm_90a and launched through its own wrapper, `ops/chol_kernel.py`).
Every solve takes this checkout's factor (K4). Prints, for each TREE:

- K5 on chip_smoke.py's four CHOL_CASES (the Newton matrices of a real PDIP
  solve: B=4096, n=120 at iterations 1 and 15; B=512, n=360; B=1, n=120):
  the elements that differ and the largest difference over the matrices
  both factor, and both kernels' CUDA-event times in turns (this, TREE,
  TREE, this);
- K5 over every solve of a cold PDIP solve (B=4096, H=10, 15 iterations)
  and of a warm ADMM solve (30 iterations on a 200-iteration warm tuple):
  each call's result from both kernels;
- K6 over every gain solve of one tick of chip_smoke.py's box-step terrain
  loop (A1, B=256, n=24, m=25, 48 sweeps; 20 standing and 10 walking ticks
  first), and the times at chip_smoke.py's K6_PICK call.

Needs a CUDA device.

    mkdir -p checkouts/parent
    git archive eb71c5a | tar -x -C checkouts/parent
    python3 tools/k5_accuracy.py checkouts/parent
"""

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import k7_spans  # noqa: E402
from k5_spans import tree_solves  # noqa: E402
from legged_mpc_control_tpu_torch.ops import chol_kernel, cuda_build  # noqa: E402


class Diff:
    """Elements compared, elements that differ, the largest difference,
    over the matrices where both results are finite."""

    def __init__(self):
        self.n = self.ne = 0
        self.max = 0.0
        self.calls = 0
        self.nonfinite_mismatch = 0

    def add(self, a, b):
        B = a.shape[0]
        fa = torch.isfinite(a.reshape(B, -1)).all(-1)
        fb = torch.isfinite(b.reshape(B, -1)).all(-1)
        self.nonfinite_mismatch += int((fa != fb).sum())
        both = fa & fb
        a, b = a[both], b[both]
        self.calls += 1
        self.n += a.numel()
        self.ne += int((a != b).sum())
        if a.numel():
            self.max = max(self.max, float((a - b).abs().max()))

    def __str__(self):
        return (f"{self.ne} of {self.n} elements differ (max {self.max:.3e}) "
                f"over {self.calls} calls; matrices finite in one result "
                f"only: {self.nonfinite_mismatch}")


def comparing(ours, theirs, diff):
    def fn(F, b):
        x = ours(F, b)
        diff.add(x, theirs(F, b))
        return x
    return fn


def turns(fns, reps):
    """CUDA-event times of each of fns (name -> fn) in turns: forward, then
    backward; the mean of the two for each."""
    ms = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            ms[k].append(chip_smoke.cuda_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in ms.items()}


def main():
    dev = torch.device("cuda", 0)
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    work = cuda_build.BUILD_DIR / "k5_accuracy"
    work.mkdir(parents=True, exist_ok=True)
    solves = {}
    for i, tree in enumerate(trees):
        lib, keep = k7_spans.build(
            tree / k7_spans.PKG / "csrc" / "chol_lanes.cu",
            work / f"libchol_lanes_{i}.so")
        print(f"{tree}: " + " | ".join(keep), flush=True)
        solves[str(tree)] = tree_solves(tree, lib)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"this checkout: {ROOT} ({card})", flush=True)

    for label, (batch, horizon, it) in chip_smoke.CHOL_CASES.items():
        K, rhs = chip_smoke.newton_matrices(batch, horizon, dev, it)
        F = chol_kernel.cholesky_cuda(K)
        x = chol_kernel.cho_solve_cuda(F, rhs)
        fns = {"this": lambda: chol_kernel.cho_solve_cuda(F, rhs)}
        print(f"K5 {label}: B={batch}, n={12 * horizon}", flush=True)
        for name, (k5, _) in solves.items():
            d = Diff()
            d.add(x, k5(F, rhs))
            print(f"   vs {name}: {d}", flush=True)
            fns[name] = lambda k5=k5: k5(F, rhs)
        ms = turns(fns, reps=10)
        print("   ms: " + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()),
              flush=True)

    params, x0, contact, lin = chip_smoke.qp_problem(chip_smoke.B, 10, dev)
    for name, (k5, _) in solves.items():
        d = Diff()
        with chip_smoke.patched(chol_kernel, cho_solve_cuda=comparing(
                chol_kernel.cho_solve_cuda, k5, d)):
            chip_smoke.condensed_solve(params, contact, lin, x0, 15)
        print(f"K5 over a cold PDIP solve (B={chip_smoke.B}, 15 iterations)"
              f" vs {name}: {d}", flush=True)

    # a warm ADMM solve, 30 iterations on a 200-iteration tuple, as the
    # B=1 latency cell (chip_smoke.phase_latency) at B=4096
    from legged_mpc_control_tpu_torch.mpc import admm, qp_builder
    x_ref, A_seq, Bm = lin(x0)
    qp = qp_builder.build_condensed_qp(
        x0, x_ref, A_seq, Bm, contact, params.q_weights, params.r_weights,
        params.mu, params.fz_max, chip_smoke.DT)
    warm = admm.solve_qp_admm_batched(qp.P, qp.q, qp.mu, qp.fz_max, contact,
                                      iters=200).warm
    for name, (k5, _) in solves.items():
        d = Diff()
        with chip_smoke.patched(chol_kernel, cho_solve_cuda=comparing(
                chol_kernel.cho_solve_cuda, k5, d)):
            admm.solve_qp_admm_batched(qp.P, qp.q, qp.mu, qp.fz_max,
                                       contact, iters=30, warm=warm)
        print(f"K5 over a warm ADMM solve (B={chip_smoke.B}, 30 iterations) "
              f"vs {name}: {d}", flush=True)

    from legged_mpc_control_tpu_torch.sim import terrain as terrain_mod
    box = terrain_mod.add_box(terrain_mod.flat(extent=3.0, cell=0.05,
                                               dtype=torch.float32,
                                               device=dev), **chip_smoke.BOX)
    st = chip_smoke.ci_roll(chip_smoke.ci_setup(
        dev, chip_smoke.CI_B, 48, velx=0.12, terrain=box, mode=0), 20)
    st["loop"] = chip_smoke.set_mode(st["loop"], 1)
    chip_smoke.ci_roll(st, 10, t0=0.2)
    diffs = {name: Diff() for name in solves}
    seen = {"n": 0}
    ours = chol_kernel.cho_solve_multi_cuda

    def compare(F, R):
        X = ours(F, R)
        for name, (_, k6) in solves.items():
            diffs[name].add(X, k6(F, R))
        if seen["n"] == chip_smoke.K6_PICK:
            seen["F"], seen["R"] = F.clone(), R.clone()
        seen["n"] += 1
        return X
    with chip_smoke.patched(chol_kernel, cho_solve_multi_cuda=compare):
        chip_smoke.ci_roll(st, 1, t0=0.3)
    print(f"K6 over one box-step tick's {seen['n']} gain solves (B="
          f"{chip_smoke.CI_B}, n=24, m=25):", flush=True)
    for name, d in diffs.items():
        print(f"   vs {name}: {d}", flush=True)
    F, R = seen["F"], seen["R"]
    fns = {"this": lambda: ours(F, R)}
    for name, (_, k6) in solves.items():
        fns[name] = lambda k6=k6: k6(F, R)
    ms = turns(fns, reps=20)
    print("   ms at the K6_PICK call: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ms.items()), flush=True)


if __name__ == "__main__":
    main()
