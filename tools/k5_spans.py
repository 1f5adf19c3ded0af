"""Where a K5 or K6 solve's cycles go, by phase.

    python3 tools/k5_spans.py [TREE ...] [--sass]

Each TREE is a checkout of the port, by default this one. Its
`csrc/chol_lanes.cu` marks its phases with K5_SPAN(n), empty in the
package's build, and names them in its header (`K5_SPAN(n): name`). The
source is built with nvcc (sm_90a) as it is, and with the marks defined:
thread 0 of each block reads clock64() at every mark, adds the cycles since
the last mark to the phase's counter in shared memory and, at the end of
the launch, to device counters. Both builds are launched through TREE's own
wrapper (`ops/chol_kernel.py`) on chip_smoke.py's K5 shapes (the Newton
matrices of a PDIP solve's first iteration: B=4096 and B=1 at n=120, B=512
at n=360) and on K6's (B=256, n=24, m=25, well-conditioned SPD matrices),
with this checkout's factor (K4). Prints each build's ptxas lines, the
as-built times, and each phase's cycles a block (thread 0) in one launch of
each shape, with a forward or backward phase's cycles a step. With --sass,
writes the as-built SASS (cuobjdump) beside that build, as chol_lanes.sass
(the path is printed).
"""

import collections
import concurrent.futures
import ctypes
import importlib.util
import re
import subprocess
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
import k7_spans  # noqa: E402
from legged_mpc_control_tpu_torch.ops import chol_kernel, cuda_build  # noqa: E402

MARKS = """#define K5_SPANS
constexpr int NSPAN = %d;
__device__ unsigned long long g_spans[NSPAN];
__shared__ long long k5_span[NSPAN + 1];
#define K5_SPANS_BEGIN if (threadIdx.x == 0) { \\
  for (int i_ = 0; i_ < NSPAN; ++i_) k5_span[i_] = 0; \\
  k5_span[NSPAN] = clock64(); }
#define K5_SPAN(n) if (threadIdx.x == 0) { long long t_ = clock64(); \\
  k5_span[n] += t_ - k5_span[NSPAN]; k5_span[NSPAN] = t_; }
#define K5_SPANS_END if (threadIdx.x == 0) \\
  for (int i_ = 0; i_ < NSPAN; ++i_) \\
    atomicAdd(&g_spans[i_], (unsigned long long)k5_span[i_]);
"""

READ = r"""
extern "C" int k5_spans_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  int e = (int)cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans));
  unsigned long long z[NSPAN] = {};
  cudaMemcpyToSymbol(g_spans, z, sizeof(z));
  return e;
}
"""


def phases(text):
    """The phase names the source's header gives its marks, by index."""
    names = dict((int(n), name.strip()) for n, name in re.findall(
        r"//\s*K5_SPAN\((\d+)\):\s*(.+)", text))
    if not names or sorted(names) != list(range(len(names))):
        raise SystemExit("the source names no phases 0..n-1 "
                         "(`// K5_SPAN(n): name` lines)")
    return [names[i] for i in range(len(names))]


def tree_solves(tree: Path, lib: Path):
    """(cho_solve_cuda, cho_solve_multi_cuda) of checkout `tree`, loaded
    under a name of its own and launching the library `lib`."""
    spec = importlib.util.spec_from_file_location(
        f"k5_spans_wrapper_{lib.stem}",
        tree / k7_spans.PKG / "ops" / "chol_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_build = types.SimpleNamespace(
        load=lambda name: (ctypes.CDLL(str(lib)) if name == "chol_lanes"
                           else cuda_build.load(name)),
        check=cuda_build.check, LAUNCHES=collections.Counter())
    return mod.cho_solve_cuda, mod.cho_solve_multi_cuda


def inputs(dev):
    """(label, kernel index, args, steps a sweep) of each shape: K5 on the
    Newton matrices, K6 on SPD matrices."""
    out = []
    for label in ("early", "b=1", "n=360"):
        batch, horizon, it = chip_smoke.CHOL_CASES[label]
        K, rhs = chip_smoke.newton_matrices(batch, horizon, dev, it)
        out.append((f"K5 B={batch}, n={12 * horizon}", 0,
                    (chol_kernel.cholesky_cuda(K), rhs), 12 * horizon))
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((chip_smoke.CI_B, 24, 24), generator=gen, device=dev)
    K = A @ A.mT + 24.0 * torch.eye(24, device=dev)
    R = torch.randn((chip_smoke.CI_B, 24, 25), generator=gen, device=dev)
    out.append((f"K6 B={chip_smoke.CI_B}, n=24, m=25", 1,
                (chol_kernel.cholesky_cuda(K), R), 24))
    return out


def main():
    args = [a for a in sys.argv[1:] if a != "--sass"]
    trees = [Path(t).resolve() for t in args] or [ROOT]
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    shapes = inputs(dev)
    for t, tree in enumerate(trees):
        src = tree / k7_spans.PKG / "csrc" / "chol_lanes.cu"
        text = src.read_text()
        names = phases(text)
        work = cuda_build.BUILD_DIR / f"k5_spans_{t}"
        work.mkdir(parents=True, exist_ok=True)
        spanned_src = work / "chol_lanes_spans.cu"
        spanned_src.write_text(MARKS % len(names) + text + READ)
        jobs = {"as it is": (src, work / "libk5.so"),
                "with spans": (spanned_src, work / "libk5_spans.so")}
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            built = dict(zip(jobs, pool.map(lambda j: k7_spans.build(*j),
                                            jobs.values())))
        print(f"K5/K6 of {tree} ({card}):", flush=True)
        for name, (_, keep) in built.items():
            print(f"   {name}: " + " | ".join(keep), flush=True)
        if "--sass" in sys.argv:
            cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
            sass = subprocess.run([str(cuobjdump), "-sass",
                                   str(built["as it is"][0])],
                                  capture_output=True, text=True).stdout
            out = work / "chol_lanes.sass"
            out.write_text(sass)
            print(f"   SASS: {out} ({len(sass.splitlines())} lines)")
        solvers = {name: tree_solves(tree, lib)
                   for name, (lib, _) in built.items()}
        try:
            report(solvers, built, names, shapes)
        except RuntimeError as e:            # a build that fails to launch
            print(f"   {tree}: {e}", flush=True)


def report(solvers, built, names, shapes):
    """Each build's times at each shape, then the phases of one launch."""
    for label, which, a, _ in shapes:
        ms = {name: chip_smoke.cuda_ms(lambda s=s: s[which](*a), reps=10)
              for name, s in solvers.items()}
        print(f"   {label}: " + ", ".join(
            f"{name} {v:.4f} ms" for name, v in ms.items()), flush=True)
    lib = ctypes.CDLL(str(built["with spans"][0]))
    lib.k5_spans_read.argtypes = [ctypes.c_void_p]
    cyc = (ctypes.c_ulonglong * len(names))()
    for label, which, a, steps in shapes:
        lib.k5_spans_read(cyc)            # drop the earlier launches
        solvers["with spans"][which](*a)
        lib.k5_spans_read(cyc)            # one launch
        nb = a[0].shape[0]
        blocks = nb if label.startswith("K5") and steps <= 128 else (
            (nb + 1) // 2)
        total = sum(cyc)
        print(f"   one launch at {label}: thread 0's cycles a block "
              f"{total / blocks:.5g}")
        for name, c in zip(names, cyc):
            if c:
                sweep = (f", {c / blocks / steps:.4g} a step"
                         if "forward" in name or "backward" in name
                         else "")
                print(f"      {name:36s} {c / blocks:9.5g}{sweep}")


if __name__ == "__main__":
    main()
