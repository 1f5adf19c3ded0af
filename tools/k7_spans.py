"""Where a K7 solve's cycles go, by phase.

    python3 tools/k7_spans.py [TREE]

TREE is a checkout of the port, by default this one. Its
`csrc/ci_sweeps.cu` marks its phases with K7_SPAN(n), empty in the
package's build, and names them in its header (`K7_SPAN(n): name`). The
source is built with nvcc (sm_90a) as it is, and with the marks defined:
thread 0 of each block reads clock64() at every mark, adds the cycles since
the last mark to the phase's counter in shared memory and, at the end of
the launch, to device counters. Both builds are launched through TREE's own
wrapper (`ops/ci_kernel.py`) on the solve of one tick of chip_smoke.py's
walked-in flat CI loop (A1, B=256, H=10, 24 warm sweeps, after 20 walking
ticks), on its first scenario alone with 32 sweeps (the B=1 policy's
call), and on the same loop's tick at B=4096 (the benchmark's CI cell,
past one wave: the wrapper launches the batch variant where the tree has
one). Prints each build's ptxas lines (every variant) and times at the
three shapes, and each phase's share of thread 0's cycles in one launch
of each. TREE's kernel is launched on the inputs this checkout's own loop
makes.
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
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from legged_mpc_control_tpu_torch.ops import ci_kernel, cuda_build  # noqa: E402

PKG = "legged_mpc_control_tpu_torch"

MARKS = """#define K7_SPANS
constexpr int NSPAN = %d;
__device__ unsigned long long g_spans[NSPAN];
__shared__ long long k7_span[NSPAN + 1];
#define K7_SPANS_BEGIN if (threadIdx.x == 0) { \\
  for (int i_ = 0; i_ < NSPAN; ++i_) k7_span[i_] = 0; \\
  k7_span[NSPAN] = clock64(); }
#define K7_SPAN(n) if (threadIdx.x == 0) { long long t_ = clock64(); \\
  k7_span[n] += t_ - k7_span[NSPAN]; k7_span[NSPAN] = t_; }
#define K7_SPANS_END if (threadIdx.x == 0) \\
  for (int i_ = 0; i_ < NSPAN; ++i_) \\
    atomicAdd(&g_spans[i_], (unsigned long long)k7_span[i_]);
"""

READ = r"""
extern "C" int k7_spans_read(unsigned long long* out) {
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
        r"//\s*K7_SPAN\((\d+)\):\s*(.+)", text))
    if not names or sorted(names) != list(range(len(names))):
        raise SystemExit("the source names no phases 0..n-1 "
                         "(`// K7_SPAN(n): name` lines)")
    return [names[i] for i in range(len(names))]


def build(src: Path, out: Path):
    """nvcc `src` into the library `out`; returns (out, its ptxas lines)."""
    cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {src}:\n{proc.stderr}")
    keep = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "stack frame" in ln]
    return out, keep


def tree_k7(tree: Path, lib: Path):
    """`ci_sweeps_cuda` of checkout `tree`, loaded under a name of its own
    and launching the library `lib`."""
    spec = importlib.util.spec_from_file_location(
        f"k7_wrapper_{lib.stem}", tree / PKG / "ops" / "ci_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_build = types.SimpleNamespace(
        load=lambda name: ctypes.CDLL(str(lib)), check=cuda_build.check,
        LAUNCHES=collections.Counter())
    return mod.ci_sweeps_cuda


def tick_args(dev, batch):
    """K7's arguments in one tick of the walked-in flat CI loop."""
    st = chip_smoke.ci_roll(chip_smoke.ci_setup(dev, batch, 24), 20)
    seen = {}
    kernel = ci_kernel.ci_sweeps_cuda

    def capture(*a, **kw):
        seen["args"] = (a, kw)
        return kernel(*a, **kw)
    with chip_smoke.patched(ci_kernel, ci_sweeps_cuda=capture):
        chip_smoke.ci_roll(st, 1, t0=0.2)
    return seen["args"]


def main():
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    src = tree / PKG / "csrc" / "ci_sweeps.cu"
    text = src.read_text()
    names = phases(text)
    work = cuda_build.BUILD_DIR / "k7_spans"
    work.mkdir(parents=True, exist_ok=True)
    spanned_src = work / "ci_sweeps_spans.cu"
    spanned_src.write_text(MARKS % len(names) + text + READ)
    jobs = {"as it is": (src, work / "libk7.so"),
            "with spans": (spanned_src, work / "libk7_spans.so")}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    for name, (_, keep) in built.items():
        print(f"   {name}: " + " | ".join(keep), flush=True)
    solvers = {name: tree_k7(tree, lib) for name, (lib, _) in built.items()}

    dev = torch.device("cuda", 0)
    a, kw = tick_args(dev, chip_smoke.CI_B)
    B = a[0].shape[0]
    one = tuple(x[:1] if torch.is_tensor(x) and x.dim() and x.shape[0] == B
                else x for x in a)
    big, kw_big = tick_args(dev, chip_smoke.K7_BATCH_B)
    calls = {f"B={B}, {kw['iters']} sweeps": (a, kw),
             "B=1, 32 sweeps": (one, dict(kw, iters=32)),
             f"B={chip_smoke.K7_BATCH_B}, {kw_big['iters']} sweeps":
                 (big, kw_big)}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"K7 of {tree}, H={a[1].shape[1]} ({card}):")
    for name, solve in solvers.items():
        ms = [chip_smoke.cuda_ms(lambda: solve(*x, **k), reps=5)
              for x, k in calls.values()]
        print(f"   {name:12s} " + ", ".join(
            f"{t:.3f} ms at {c}" for t, c in zip(ms, calls)), flush=True)

    lib = ctypes.CDLL(str(built["with spans"][0]))
    lib.k7_spans_read.argtypes = [ctypes.c_void_p]
    cyc = (ctypes.c_ulonglong * len(names))()
    for call, (x, k) in calls.items():
        lib.k7_spans_read(cyc)            # drop the earlier launches
        cost = solvers["with spans"](*x, **k)[2]
        lib.k7_spans_read(cyc)            # one launch
        nb = x[0].shape[0]
        total = sum(cyc)
        stage_sweeps = k["iters"] * x[1].shape[1]
        print(f"one launch at {call}: cost finite "
              f"{int(torch.isfinite(cost).sum())} of {nb}; thread 0's "
              f"cycles a block {total / nb:.4g}, a stage-sweep "
              f"{total / nb / stage_sweeps:.4g}")
        for name, c in zip(names, cyc):
            print(f"   {name:40s} {c / total:7.4f}  ({c / nb:.4g} cycles a "
                  "block)")


if __name__ == "__main__":
    main()
