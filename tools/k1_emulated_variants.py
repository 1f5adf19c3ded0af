"""Where K1's float32 digits go: the CPU emulation of the kernel's own
arithmetic, one piece at a time in float64.

    python3 tools/k1_emulated_variants.py [--seeds 1-2] [--batch 64]
                                          [--procs 8] [--horizon 30]

Builds `csrc/riccati_ipm.cu` with g++ under the CUDA emulation of
`tests/test_torch_emulated.py` (a block's threads as fibers, FMA
contraction on, as nvcc does) in four variants:
- "f32": the factor sweep in float32, the LQR's triangular solves
  multiplying by stored reciprocals of the pivots (the package's kernel at
  H <= 13);
- "f32, divide": the same, the LQR's solves dividing by the pivots;
- "f64 factor": the factor sweep in float64, the LQR's solves multiplying;
- "f64 factor, divide": the package's kernel at H >= 14.
Each runs the first `--batch` scenarios of the card tests' fixture recipe
(a Go1 batch of 257 after 20 standing and 10 trotting ticks, made here on
the CPU with the plain versions, generator seeded with the seed) at
`--horizon`, iters=15, cold and warm from the shifted plain solution.
Prints, for each variant and for the plain float32 version, the largest
and median distance to the float64 solve that freezes where float32 does
(tol=1e-6: the same iterations in exact arithmetic), and how many
scenarios are more than 2e-2 N from it. The scenarios are spread over
`--procs` processes.
"""

import argparse
import concurrent.futures
import ctypes
import multiprocessing
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

# the LQR solves' pivots: stored as L[i][i] and divided by, or stored as
# 1 / L[i][i] and multiplied by
STORE = "(float)(F64 ? piv_d : inv_d)"
SOLVE = "cho_solve_vec<F64>"
DIVIDE = ((STORE, "(float)piv_d"), (SOLVE, "cho_solve_vec<true>"))
MULTIPLY = ((STORE, "(float)inv_d"), (SOLVE, "cho_solve_vec<false>"))
VARIANTS = {"f32": (("-DK1_F64_MIN_H=1000",), MULTIPLY),
            "f32, divide": (("-DK1_F64_MIN_H=1000",), DIVIDE),
            "f64 factor": (("-DK1_F64_MIN_H=0",), MULTIPLY),
            "f64 factor, divide": (("-DK1_F64_MIN_H=0",), DIVIDE)}


def build(out_dir: Path, name, flags, edit):
    """The emulated K1 library of one variant."""
    import test_torch_emulated as emu

    src = (ROOT / "legged_mpc_control_tpu_torch" / "csrc"
           / "riccati_ipm.cu").read_text()
    for old, new in edit:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    src = src.replace("#include <cuda_runtime.h>", emu.PRELUDE)
    src = src[:src.index('extern "C"')].replace(
        "extern __shared__ float4 smem4[];", "static float4 smem4[8192];")
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cpp = out_dir / f"k1_{tag}.cpp"
    cpp.write_text(src + emu.RICCATI_LAUNCH)
    lib = out_dir / f"libk1_{tag}.so"
    subprocess.run(["g++", "-std=c++20", "-O2", "-mfma", "-ffp-contract=fast",
                    "-shared", "-fPIC", *flags, "-o", str(lib), str(cpp)],
                   check=True)
    return lib


def run(lib, ins, warm):
    """u of the emulated K1 (iters=15) on CPU tensors."""
    k1 = ctypes.CDLL(str(lib))
    k1.riccati_ipm_emu.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3 + [ctypes.c_float])
    ins = [x.contiguous() for x in ins]
    Bn, H = ins[1].shape[:2]
    u, gap = torch.empty((Bn, 12 * H)), torch.empty(Bn)
    lam = torch.empty((Bn, H, 4, 6))
    scr = torch.empty((Bn, k1.riccati_ipm_scratch_emu(H)))
    k1.riccati_ipm_emu(
        *[x.data_ptr() for x in ins], 12, 12, 1, 1,
        None if warm is None else warm.contiguous().data_ptr(), u.data_ptr(),
        gap.data_ptr(), lam.data_ptr(), scr.data_ptr(), Bn, H, 15, 0.01)
    return u


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="1-2")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--horizon", type=int, default=30)
    opt = ap.parse_args()
    torch.set_num_threads(1)

    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait, riccati
    from legged_mpc_control_tpu_torch.parallel import runner

    out_dir = ROOT / "legged_mpc_control_tpu_torch" / "_build" / "k1_emu"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {n: build(out_dir, n, f, e) for n, (f, e) in VARIANTS.items()}
    lo, _, hi = opt.seeds.partition("-")
    f32 = torch.float32
    params = go1_params(f32, "cpu")
    pattern = gait.trot_pattern(f32, "cpu")
    errs = {n: [] for n in list(libs) + ["plain"]}
    for seed in range(int(lo), int(hi or lo) + 1):
        loop = runner.init_loop_batch(
            params, 257, torch.Generator().manual_seed(seed), dtype=f32,
            body_height=0.28, device="cpu")
        loop, _ = runner.make_batched_rollout(
            pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15,
            stand_ticks=20)(loop, params)
        _, stage = convex_mpc.mpc_prepare(
            loop.controller, step.broadcast_params(params, 257), pattern,
            0.01, horizon=opt.horizon)
        ins = [x[:opt.batch].contiguous() for x in (
            stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu, stage.fz_max)]
        args = tuple(ins) + (0.01,)
        a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
        for start in ("cold", "warm"):
            warm = None
            if start == "warm":
                warm = riccati.warm_shift(riccati.solve_qp_riccati_batched(
                    *args, iters=15)[0], args[4])
            w64 = None if warm is None else warm.double()
            uf = riccati.solve_qp_riccati_batched(*a64, iters=15, warm_u=w64,
                                                  tol=1e-6)[0]
            up = riccati.solve_qp_riccati_batched(*args, iters=15,
                                                  warm_u=warm)[0]
            errs["plain"].append((up.double() - uf).abs().amax(-1))
            cuts = torch.arange(opt.batch).tensor_split(opt.procs)
            with concurrent.futures.ProcessPoolExecutor(
                    opt.procs,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                for name, lib in libs.items():
                    parts = pool.map(run, [lib] * len(cuts),
                                     [[x[c] for x in ins] for c in cuts],
                                     [None if warm is None else warm[c]
                                      for c in cuts])
                    u = torch.cat(list(parts)).double()
                    errs[name].append((u - uf).abs().amax(-1))
            print(f"seed {seed} {start}: " + ", ".join(
                f"{n} {float(e[-1].max()):.4f}" for n, e in errs.items()),
                flush=True)
    print(f"distance to the float64 solve with float32's freeze (N), "
          f"H={opt.horizon}, "
          f"seeds {opt.seeds}, {opt.batch} scenarios each, cold and warm:")
    for name, e in errs.items():
        e = torch.cat(e)
        print(f"   {name:20s} max {float(e.max()):.4f}, median "
              f"{float(e.median()):.5f}, over 2e-2 N {int((e > 2e-2).sum())}"
              f" of {len(e)}")


if __name__ == "__main__":
    main()
