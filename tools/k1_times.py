"""K1's times against another checkout, in turns, and what its float64
factor sweep costs at each horizon.

    python3 tools/k1_times.py [TREE]

Builds this checkout's `csrc/riccati_ipm.cu` with nvcc (sm_90a) as it is
(factor sweep in float64 for H >= 14), with the factor sweep in float64 at
every horizon (`-DK1_F64_MIN_H=0`) and in float32 at every horizon
(`-DK1_F64_MIN_H=1000`), and TREE's source as it is (another checkout of
the port, e.g. the parent unpacked with `git archive` under `checkouts/`).
Each build is launched through its own tree's wrapper on chip_smoke.py's
synthetic Go1 trot batch, B=4096, at H=10 iters=15 cold, at the loop's
call (H=10, iters=4, warm from the shifted plain solution), at H=13 and
at H=30 iters=15 cold, timed by CUDA events in turns: TREE, this, this,
TREE, then the two variants. Prints each build's ptxas lines and, for each case, the
times and each build's largest distance to the float64 solve.
"""

import concurrent.futures
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
import k1_spans  # noqa: E402
from legged_mpc_control_tpu_torch.mpc import riccati  # noqa: E402
from legged_mpc_control_tpu_torch.ops import cuda_build  # noqa: E402


def main():
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    src = ROOT / k1_spans.PKG / "csrc" / "riccati_ipm.cu"
    work = cuda_build.BUILD_DIR / "k1_times"
    work.mkdir(parents=True, exist_ok=True)
    jobs = {"this": (src, work / "libk1.so", ()),
            "f64 factor at every H": (src, work / "libk1_f64.so",
                                      ("-DK1_F64_MIN_H=0",)),
            "f32 factor at every H": (src, work / "libk1_f32.so",
                                      ("-DK1_F64_MIN_H=1000",))}
    if tree is not None:
        jobs["tree"] = (tree / k1_spans.PKG / "csrc" / "riccati_ipm.cu",
                        work / "libk1_tree.so", ())
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: k1_spans.build(*j),
                                        jobs.values())))
    for name, (_, keep) in built.items():
        print(f"   {name}: " + " | ".join(keep), flush=True)
    solvers = {name: k1_spans.tree_k1(tree if name == "tree" else ROOT, lib)
               for name, (lib, _) in built.items()}
    order = (("tree", "this", "this", "tree") if tree is not None
             else ("this", "this"))
    order += ("f64 factor at every H", "f32 factor at every H")

    dev = torch.device("cuda", 0)
    B, dt = chip_smoke.B, chip_smoke.DT
    print(f"K1 of {ROOT}" + (f" against {tree}" if tree else "")
          + f", B={B} ({k1_spans.card_name()}):")
    for H, iters, start in ((10, 15, "cold"), (10, 4, "warm"),
                            (13, 15, "cold"), (30, 15, "cold")):
        params, x0, contact, lin = chip_smoke.qp_problem(B, H, dev)
        x_ref, A_seq, Bm = lin(x0)
        args = (x0, x_ref, A_seq, Bm, contact, params.q_weights,
                params.r_weights, params.mu, params.fz_max, dt)
        warm = None
        if start == "warm":
            warm = riccati.warm_shift(
                riccati.solve_qp_riccati_batched(*args, iters=15)[0],
                contact)
        u64 = riccati.solve_qp_riccati_batched(
            *(a.double() if torch.is_tensor(a) else a for a in args),
            iters=iters, warm_u=None if warm is None else warm.double())[0]
        reps = 20 if iters == 4 else 5
        ms = [chip_smoke.cuda_ms(
            lambda: solvers[n](*args, iters=iters, warm_u=warm), reps=reps)
            for n in order]
        dist = {n: float((s(*args, iters=iters, warm_u=warm)[0].double()
                          - u64).abs().max()) for n, s in solvers.items()}
        print(f"   H={H} iters={iters} {start}: ms in turns "
              + ", ".join(f"{n} {t:.3f}" for n, t in zip(order, ms)),
              flush=True)
        print("      largest distance to float64 (N): "
              + ", ".join(f"{n} {d:.4f}" for n, d in dist.items()),
              flush=True)


if __name__ == "__main__":
    main()
