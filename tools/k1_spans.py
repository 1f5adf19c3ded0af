"""Where a K1 solve's cycles go, by phase, and what the place of its
per-stage store costs.

    python3 tools/k1_spans.py [TREE] [--f64]

TREE is a checkout of the port, by default this one. Its
`csrc/riccati_ipm.cu` is built with nvcc (sm_90a) as it is, and with
clock64() reads around the phases of an interior-point iteration: each
thread (for the warp-a-scenario kernel, lane 0 of each warp) sums its own
cycles a phase and adds them to device counters at its end. The
warp-a-scenario source is built a third time with its per-stage store in
device scratch at every horizon (`-DK1_SMEM_MAX_H=0`). Each build is
launched through TREE's own wrapper (`ops/riccati_kernel.py`) on the
synthetic Go1 trot batch of chip_smoke.py at B=4096, H=10, and timed at
iters=15 cold and at the loop's call, iters=4 warm. Prints each build's
ptxas lines and times, and each phase's share of the cycles of one iters=15
cold launch. With --f64 the first two builds run the factor sweep in
float64 at every horizon (`-DK1_F64_MIN_H=0`), so that the phases of the
float64 sweep show at H=10.

The warp-a-scenario source marks its phases with K1_SPAN(n), empty in the
package's build. The thread-a-scenario kernel of the port's first slices
has no marks; its source is fixed in git history, and this script inserts
them by its text:

    mkdir -p checkouts/v1
    git archive 5509e69 | tar -x -C checkouts/v1
    python3 tools/k1_spans.py checkouts/v1
"""

import collections
import concurrent.futures
import ctypes
import importlib.util
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from legged_mpc_control_tpu_torch.mpc import riccati  # noqa: E402
from legged_mpc_control_tpu_torch.ops import cuda_build  # noqa: E402

PKG = "legged_mpc_control_tpu_torch"

# The warp-a-scenario kernel's phases, by the index of their mark. The LQR
# backward sweep's marks sit inside its lambda, so the affine and corrector
# solves share them.
PHASES = ("init", "rollout", "adjoint + residual",
          "factor: products, Hu, P", "factor: chol12 + A^T W",
          "factor: K solve", "factor: last P", "lqr forward affine",
          "step lengths affine", "lqr forward corrector",
          "step lengths corrector", "update", "final",
          "lqr backward: Hux^T kff", "lqr backward: rhs, A^T psi",
          "lqr backward: cho_solve_vec")
MARKS = """#define K1_SPANS
constexpr int NSPAN = %d;
__device__ unsigned long long g_spans[NSPAN];
#define K1_SPANS_BEGIN long long span_acc[NSPAN] = {}; \\
  long long span_t = clock64();
#define K1_SPAN(n) { long long _t = clock64(); span_acc[n] += _t - span_t; \\
  span_t = _t; }
#define K1_SPANS_END if (lane == 0) for (int i = 0; i < NSPAN; ++i) \\
  atomicAdd(&g_spans[i], (unsigned long long)span_acc[i]);
"""


def span(n):
    return "{ long long _t = clock64(); span_acc[%d] += _t - span_t; " \
           "span_t = _t; }" % n


# The thread-a-scenario kernel (git 5509e69): phase names, then (text of the
# source, what it becomes), each found exactly once.
V1_PHASES = ("init", "rollout + residual", "factor", "lqr_solve affine",
             "step lengths affine", "lqr_solve corrector",
             "step lengths corrector", "update", "final")
V1_PATCHES = (
    ("  for (int it = 0; it < iters; ++it) {\n    rollout_psi(p, qw);\n",
     "  " + span(0) + "\n"
     "  for (int it = 0; it < iters; ++it) {\n    rollout_psi(p, qw);\n"),
    ("    const float mu_gap = sl / m;\n",
     "    " + span(1) + "\n    const float mu_gap = sl / m;\n"),
    ("    factor(p, qw, rw);\n", "    factor(p, qw, rw);\n    " + span(2)
     + "\n"),
    ("    lqr_solve(p, false, 0.0f, mu_gap, SCR_DUA);\n",
     "    lqr_solve(p, false, 0.0f, mu_gap, SCR_DUA);\n    " + span(3)
     + "\n"),
    ("    const float mu_aff = saff / m;\n",
     "    " + span(4) + "\n    const float mu_aff = saff / m;\n"),
    ("    lqr_solve(p, true, sigma, mu_gap, SCR_DU);\n",
     "    lqr_solve(p, true, sigma, mu_gap, SCR_DU);\n    " + span(5)
     + "\n"),
    ("    ap *= 0.99f;\n", "    " + span(6) + "\n    ap *= 0.99f;\n"),
    ("      for (int i = 0; i < NX; ++i) p.U(k, i) += ap * p.S(k, SCR_DU + "
     "i);\n    }\n  }\n",
     "      for (int i = 0; i < NX; ++i) p.U(k, i) += ap * p.S(k, SCR_DU + "
     "i);\n    }\n    " + span(7) + "\n  }\n"),
    ("  gap_out[b] = sl / m;\n",
     "  gap_out[b] = sl / m;\n  " + span(8) + "\n"
     "  for (int i = 0; i < NSPAN; ++i)\n"
     "    atomicAdd(&g_spans[i], (unsigned long long)span_acc[i]);\n"),
    ("  const float m = (float)(H * NCON);\n",
     "  const float m = (float)(H * NCON);\n"
     "  long long span_acc[NSPAN] = {};\n"
     "  long long span_t = clock64();\n"),
)

READ = r"""
extern "C" int k1_spans_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  int e = (int)cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans));
  unsigned long long z[NSPAN] = {};
  cudaMemcpyToSymbol(g_spans, z, sizeof(z));
  return e;
}
"""


def build(src: Path, out: Path, flags=()):
    """nvcc `src` into the library `out`; returns (out, its ptxas lines)."""
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
           str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stderr}")
    keep = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "stack frame" in ln]
    return out, keep


def tree_k1(tree: Path, lib: Path):
    """`solve_qp_riccati_cuda` of checkout `tree`, loaded under a name of
    its own and launching the library `lib`."""
    spec = importlib.util.spec_from_file_location(
        f"k1_wrapper_{lib.stem}", tree / PKG / "ops" / "riccati_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_build = types.SimpleNamespace(
        load=lambda name: ctypes.CDLL(str(lib)), check=cuda_build.check,
        LAUNCHES=collections.Counter())
    return mod.solve_qp_riccati_cuda


def card_name():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    args = [a for a in sys.argv[1:] if a != "--f64"]
    # --f64: the builds as is and with spans run the factor sweep in
    # float64 at every horizon (-DK1_F64_MIN_H=0), H=10 included
    f64 = ("-DK1_F64_MIN_H=0",) if "--f64" in sys.argv[1:] else ()
    tree = Path(args[0]).resolve() if args else ROOT
    src = tree / PKG / "csrc" / "riccati_ipm.cu"
    text = src.read_text()
    warp = "K1_SPAN(" in text
    if warp:
        phases = PHASES
        spanned = MARKS % len(phases) + text
    else:
        phases = V1_PHASES
        for old, new in V1_PATCHES:
            if text.count(old) != 1:
                raise SystemExit(f"{src}: neither marked nor the kernel of "
                                 f"git 5509e69 (no single {old!r})")
            text = text.replace(old, new)
        spanned = text.replace(
            "namespace {\n", f"constexpr int NSPAN = {len(phases)};\n"
            "__device__ unsigned long long g_spans[NSPAN];\n"
            "namespace {\n", 1)
    work = cuda_build.BUILD_DIR / "k1_spans"
    work.mkdir(parents=True, exist_ok=True)
    spanned_src = work / "riccati_ipm_spans.cu"
    spanned_src.write_text(spanned + READ)
    jobs = {"as it is": (src, work / "libk1.so", f64),
            "with spans": (spanned_src, work / "libk1_spans.so", f64)}
    if warp:
        jobs["store in device scratch"] = (src, work / "libk1_scratch.so",
                                           ("-DK1_SMEM_MAX_H=0",))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    for name, (_, keep) in built.items():
        print(f"   {name}: " + " | ".join(keep), flush=True)
    solvers = {name: tree_k1(tree, lib) for name, (lib, _) in built.items()}

    dev = torch.device("cuda", 0)
    B, H, dt = chip_smoke.B, 10, chip_smoke.DT
    params, x0, contact, lin = chip_smoke.qp_problem(B, H, dev)
    x_ref, A_seq, Bm = lin(x0)
    args = (x0, x_ref, A_seq, Bm, contact, params.q_weights,
            params.r_weights, params.mu, params.fz_max, dt)
    warm_u = riccati.warm_shift(
        riccati.solve_qp_riccati_batched(*args, iters=15)[0], contact)
    card = card_name()
    who = "warp" if warp else "thread"
    print(f"K1 of {tree}, a {who} a scenario, B={B}, H={H} ({card}):")
    for name, solve in solvers.items():
        ms15 = chip_smoke.cuda_ms(lambda: solve(*args, iters=15), reps=5)
        ms4 = chip_smoke.cuda_ms(
            lambda: solve(*args, iters=4, warm_u=warm_u), reps=20)
        print(f"   {name:24s} {ms15:.3f} ms at iters=15 cold, {ms4:.3f} ms "
              "at iters=4 warm", flush=True)

    lib = ctypes.CDLL(str(built["with spans"][0]))
    lib.k1_spans_read.argtypes = [ctypes.c_void_p]
    cyc = (ctypes.c_ulonglong * len(phases))()
    lib.k1_spans_read(cyc)            # drop the timed launches
    gap = solvers["with spans"](*args, iters=15)[1]
    lib.k1_spans_read(cyc)            # one launch
    total = sum(cyc)
    print(f"one iters=15 cold launch: max gap {float(gap.max()):.3e}; "
          f"cycles a {who}: {total / B:.4g}")
    for name, c in zip(phases, cyc):
        print(f"   {name:34s} {c / total:7.4f}  ({c / B:.4g} cycles a "
              f"{who})")


if __name__ == "__main__":
    main()
