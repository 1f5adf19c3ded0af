"""K1 against its plain version and the float64 solve, on the card tests'
batch.

    python3 tools/k1_accuracy.py [TREE]

Builds the trotting Go1 batch of tests/test_torch_cuda.py (B=257, kf_type 0,
20 standing and 10 trotting ticks) and, for every case of its
`test_riccati_kernel_matches_plain` (H = 1, 10, 13, 30; the first 1, 5 or
257 scenarios; cold and warm; iters=15), prints how far this checkout's K1
is from the plain float32 version, scenario by scenario: the 0.99 quantile
(at B=1 and 5 that is the largest, or next to it), the largest, and the
number over the 2e-2 N bracket; and how far K1 and the plain version are
from the float64 solve. With TREE, a checkout of the port (an earlier
commit, unpacked with `git archive`), its K1 is built from its own source
and held to the same answers on the same inputs:

    mkdir -p checkouts/v1
    git archive 5509e69 | tar -x -C checkouts/v1
    python3 tools/k1_accuracy.py checkouts/v1

Needs a CUDA device and pytest (the batch comes from the test module).
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests"), str(ROOT / "tools")]

import k1_spans  # noqa: E402
import test_torch_cuda  # noqa: E402
from legged_mpc_control_tpu_torch.mpc import convex_mpc, riccati  # noqa: E402
from legged_mpc_control_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    riccati_kernel,
)

BRACKET = 2e-2


def stats(u, up, u64):
    """p99, max and count over the bracket of |u - up| by scenario, and
    the largest |u - u64|."""
    d = (u - up).abs().amax(-1).double()
    return (float(torch.quantile(d, 0.99)), float(d.max()),
            int((d > BRACKET).sum()), float((u.double() - u64).abs().max()))


def main():
    solvers = {"this K1": riccati_kernel.solve_qp_riccati_cuda}
    if len(sys.argv) > 1:
        tree = Path(sys.argv[1]).resolve()
        work = cuda_build.BUILD_DIR / "k1_accuracy"
        work.mkdir(parents=True, exist_ok=True)
        lib, _ = k1_spans.build(
            tree / k1_spans.PKG / "csrc" / "riccati_ipm.cu",
            work / "libk1_tree.so")
        solvers[f"K1 of {tree.name}"] = k1_spans.tree_k1(tree, lib)
    dev = torch.device("cuda", 0)
    loop, params, pattern = test_torch_cuda._trot(dev, 0)
    print(f"K1 vs plain float32 and float64, iters=15, the card tests' "
          f"batch ({k1_spans.card_name()}); per case: p99 and max "
          f"|u_K1 - u_plain| by scenario (N), scenarios over {BRACKET}, "
          "max |u - u_float64|", flush=True)
    for horizon in (1, 10, 13, 30):
        _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern,
                                          0.01, horizon=horizon)
        for batch in (1, 5, test_torch_cuda.B):
            args = tuple(x[:batch] for x in (
                stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
                stage.q_weights, stage.r_weights, stage.mu,
                stage.fz_max)) + (0.01,)
            args64 = tuple(a.double() if torch.is_tensor(a) else a
                           for a in args)
            for start in ("cold", "warm"):
                warm_u = None
                if start == "warm":
                    warm_u = riccati.warm_shift(
                        riccati.solve_qp_riccati_batched(
                            *args, iters=15)[0], args[4])
                up = riccati.solve_qp_riccati_batched(
                    *args, iters=15, warm_u=warm_u)[0]
                u64 = riccati.solve_qp_riccati_batched(
                    *args64, iters=15,
                    warm_u=None if warm_u is None else warm_u.double())[0]
                line = (f"H={horizon:2d} B={batch:3d} {start}: plain "
                        f"{float((up.double() - u64).abs().max()):.3e} "
                        "from float64")
                for name, solve in solvers.items():
                    q99, mx, n, e64 = stats(
                        solve(*args, iters=15, warm_u=warm_u)[0], up, u64)
                    line += (f"; {name} p99 {q99:.3e} max {mx:.3e} over "
                             f"{n}, {e64:.3e} from float64")
                print(line, flush=True)


if __name__ == "__main__":
    main()
