"""K7 against its plain version and the float64 solve, scenario by scenario.

    python3 tools/k7_accuracy.py [TREE ...]

Walks an A1 batch of B=256 on the flat CI loop for 6 ticks (the card
tests' set-up, tests/test_torch_cuda.py:_ci_walked, at 24 sweeps) with the
walk policy's plain backend, so the batch does not depend on the kernel
under test, at H=10 and at H=12, and captures the sweeps' arguments of a
7th tick. Then this checkout's K7, and each TREE's (another checkout of
the port, its `csrc/ci_sweeps.cu` built and launched through its own
wrapper), run on those arguments. Prints, for each kernel and horizon, the
scenarios outside chip_smoke.py's K7_TOL bracket of the plain float32
version, and each error's largest value and 0.99 quantile against plain
and against the float64 plain solve; and the plain float32 version's own
distance from float64. Needs a CUDA device.

    mkdir -p checkouts/old
    git archive 9054cac | tar -x -C checkouts/old
    python3 tools/k7_accuracy.py checkouts/old
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import k7_spans  # noqa: E402
from legged_mpc_control_tpu_torch.config import a1_params  # noqa: E402
from legged_mpc_control_tpu_torch.control import step  # noqa: E402
from legged_mpc_control_tpu_torch.mpc import ci_mpc, lci_mpc  # noqa: E402
from legged_mpc_control_tpu_torch.ops import ci_kernel, cuda_build  # noqa: E402
from legged_mpc_control_tpu_torch.parallel import runner  # noqa: E402

B = 256
F32 = torch.float32


def tick_args(dev, horizon):
    """The sweeps' arguments of the 7th tick of a plain-walked batch."""
    params = a1_params(F32, dev)
    walk = ci_mpc.make_ci_walk_policy_batched(params, velx=0.1, iters=24,
                                              horizon=horizon,
                                              backend="plain")
    stand = lci_mpc.make_stand_policy(params)
    gen = torch.Generator(device=dev).manual_seed(3)
    loop = runner.init_loop_batch(params, B, gen, dtype=F32, device=dev)
    loop = chip_smoke.set_mode(loop, 1)
    lci = lci_mpc.lci_init_batched(B, F32, walk.warm_init(B, F32, dev),
                                   device=dev)
    for k in range(6):
        loop, lci = step.closed_loop_tick_lci_batched(loop, lci, params,
                                                      stand, walk, 0.01 * k)
    seen = {}
    sweeps = ci_mpc._sweeps

    def capture(z0, Uh0, ref_zu, refT, f_mask, rho0, wvec, mu, mass, Iw_inv,
                terrain, **kw):
        seen["args"] = ((z0, Uh0, ref_zu, refT, f_mask, rho0, wvec, mu,
                         mass, Iw_inv),
                        {k: kw[k] for k in ("iters", "dt", "s_f", "rho_min",
                                            "reg", "state_reg")})
        return sweeps(z0, Uh0, ref_zu, refT, f_mask, rho0, wvec, mu, mass,
                      Iw_inv, terrain, **kw)
    with chip_smoke.patched(ci_mpc, _sweeps=capture):
        step.closed_loop_tick_lci_batched(loop, lci, params, stand, walk,
                                          0.06)
    return seen["args"]


def report(name, got, plain, ref64):
    e = chip_smoke.k7_errors(got, plain)
    e64 = chip_smoke.k7_errors(got, ref64)
    outside = torch.zeros(B, dtype=torch.bool, device=got[0].device)
    for k, tol in chip_smoke.K7_TOL.items():
        outside |= e[k] > tol

    def stats(err):
        return ", ".join(f"{k} {float(v.max()):.3e} / "
                         f"{float(torch.quantile(v, 0.99)):.3e}"
                         for k, v in err.items())
    print(f"   {name}: outside the bracket {outside.nonzero().flatten().tolist()}")
    print(f"      vs plain (max / p99): {stats(e)}")
    print(f"      vs float64 (max / p99): {stats(e64)}")


def main():
    dev = torch.device("cuda", 0)
    trees = [Path(t).resolve() for t in sys.argv[1:]]
    work = cuda_build.BUILD_DIR / "k7_accuracy"
    work.mkdir(parents=True, exist_ok=True)
    kernels = {"this tree": ci_kernel.ci_sweeps_cuda}
    for i, tree in enumerate(trees):
        lib, _ = k7_spans.build(
            tree / k7_spans.PKG / "csrc" / "ci_sweeps.cu",
            work / f"libk7_{i}.so")
        kernels[str(tree)] = k7_spans.tree_k7(tree, lib)
    for horizon in (10, 12):
        a, kw = tick_args(dev, horizon)
        a64 = tuple(x.double() if torch.is_tensor(x) else x for x in a)
        plain = ci_kernel.ci_sweeps_plain(*a, **kw)
        ref64 = ci_kernel.ci_sweeps_plain(*a64, **kw)
        print(f"H={horizon}, B={B}, {kw['iters']} sweeps:")
        for name, fn in kernels.items():
            report(name, fn(*a, **kw), plain, ref64)
        e = chip_smoke.k7_errors(plain, ref64)
        print("   plain float32 vs float64 (max / p99): " + ", ".join(
            f"{k} {float(v.max()):.3e} / "
            f"{float(torch.quantile(v, 0.99)):.3e}" for k, v in e.items()))


if __name__ == "__main__":
    main()
