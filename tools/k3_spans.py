"""K2's and K3's times, against another checkout in turns, and where a
scenario's cycles go by phase.

    python3 tools/k3_spans.py [TREE]

Builds this checkout's `csrc/substep_chain.cu` with nvcc (sm_90a) as it
is, and again with clock64() reads around the phases of a substep (the
source's SC_SPAN(n) marks, empty in the package's build): lane 0 of each
scenario's group sums its own cycles a phase and adds them to device
counters at its end. TREE (another checkout of the port, e.g. the parent
unpacked with `git archive` under `checkouts/`) is built as it is. Each
build is launched through its own tree's wrapper
(`ops/substep_kernel.py`) on chip_smoke.py's mid-trot batches (K2: Go1,
seed 4, 20 standing and 10 trotting ticks; K3: seed 5 with the filter in
the loop), at B=4096 and at their first 256 scenarios. Prints each
build's ptxas lines; for each case the elements where this checkout's
outputs differ from TREE's and from the spans build's, and the times in
turns (TREE, this, this, TREE); then each phase's share of the cycles of
one launch of K2 and of K3 at B=4096.
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
from legged_mpc_control_tpu_torch.ops import cuda_build  # noqa: E402

PKG = "legged_mpc_control_tpu_torch"
PHASES = ("loads", "low level: jac, f_rel, tau_ff, IK, PD",
          "safety gate, the leg's GRF, contact, anchor, the folds",
          "trunk step", "stance closure (IK, jac, solve) or swing",
          "filter: sensors", "filter: predict, the 28 rows, symmetrize",
          "Feedback tail + stores")
MARKS = """#define SC_SPANS
constexpr int NSPAN = %d;
__device__ unsigned long long g_spans[NSPAN];
#define SC_SPANS_BEGIN long long span_acc[NSPAN] = {}; \\
  long long span_t = clock64();
#define SC_SPAN(n) { long long _t = clock64(); span_acc[n] += _t - span_t; \\
  span_t = _t; }
#define SC_SPANS_END if (g == 0 && live) for (int i = 0; i < NSPAN; ++i) \\
  atomicAdd(&g_spans[i], (unsigned long long)span_acc[i]);
""" % len(PHASES)
READ = r"""
extern "C" int sc_spans_read(unsigned long long* out) {
  cudaDeviceSynchronize();
  int e = (int)cudaMemcpyFromSymbol(out, g_spans, sizeof(g_spans));
  unsigned long long z[NSPAN] = {};
  cudaMemcpyToSymbol(g_spans, z, sizeof(z));
  return e;
}
"""


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


def tree_chain(tree: Path, lib: Path):
    """`substep_chain_cuda` of checkout `tree`, loaded under a name of its
    own and launching the library `lib`."""
    spec = importlib.util.spec_from_file_location(
        f"sc_wrapper_{lib.stem}", tree / PKG / "ops" / "substep_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_build = types.SimpleNamespace(
        load=lambda name: ctypes.CDLL(str(lib)), check=cuda_build.check,
        LAUNCHES=collections.Counter())
    return mod.substep_chain_cuda


def batch(dev, kf_type):
    """chip_smoke.py's mid-trot K2 (kf_type 0) or K3 (1) batch, B=4096:
    the chain's arguments and keywords."""
    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.control import sensors, step
    from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait
    from legged_mpc_control_tpu_torch.parallel import runner

    B, dt = chip_smoke.B, chip_smoke.DT
    params = go1_params(torch.float32, dev)
    pattern = gait.trot_pattern(torch.float32, dev)
    loop = chip_smoke.init_batch(params, B, 4 if kf_type == 0 else 5, dev)
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15, stand_ticks=20,
        kf_type=kf_type)(loop, params)
    pb = step.broadcast_params(params, B)
    cs, _ = convex_mpc.mpc_tick_batched(loop.controller, pb, pattern, dt,
                                        horizon=10, iters=4)
    sim = loop.sim
    args = (sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq,
            sim.contact, sim.anchor, cs.ctrl.optimized_state,
            cs.ctrl.optimized_input, cs.ctrl.movement_mode, pb.mass, pb.mu,
            pb.kp_foot, pb.kd_foot, pb.trunk_inertia, pb.rho_fix,
            pb.default_foot_pos, pb.gait_counter_speed,
            sensors.contact_threshold(pb), cs.ctrl.root_lin_vel_d_rel)
    kw = dict(substeps=8, dt=dt / 8, kf_type=kf_type)
    if kf_type == 1:
        kw.update(kf_x=cs.kf.x, kf_P=cs.kf.P)
    return args, kw


def differ(a, b):
    """'name n/total (max |a - b|)' for every output of two chains."""
    out = []
    for name in a:
        x, y = a[name].float(), b[name].float()
        n = int((x != y).sum())
        out.append(f"{name} {n}/{x.numel()}"
                   + (f" ({float((x - y).abs().max()):.3e})" if n else ""))
    return ", ".join(out)


def main():
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    src = ROOT / PKG / "csrc" / "substep_chain.cu"
    work = cuda_build.BUILD_DIR / "k3_spans"
    work.mkdir(parents=True, exist_ok=True)
    spanned = work / "substep_chain_spans.cu"
    spanned.write_text(MARKS + src.read_text() + READ)
    jobs = {"this": (src, work / "libsc.so"),
            "this, spans": (spanned, work / "libsc_spans.so")}
    if tree is not None:
        jobs["tree"] = (tree / PKG / "csrc" / "substep_chain.cu",
                        work / "libsc_tree.so")
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: build(*j), jobs.values())))
    for name, (_, keep) in built.items():
        print(f"   {name}: " + " | ".join(keep), flush=True)
    chains = {name: tree_chain(tree if name == "tree" else ROOT, lib)
              for name, (lib, _) in built.items()}

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"K2/K3 of {ROOT}" + (f" against {tree}" if tree else "")
          + f" ({card}):")
    for kf_type, label in ((0, "K2"), (1, "K3")):
        args, kw = batch(dev, kf_type)
        for b in (chip_smoke.B, 256):
            a = tuple(x[:b] if torch.is_tensor(x) and x.dim() else x
                      for x in args)
            k = {n: (v[:b] if torch.is_tensor(v) else v)
                 for n, v in kw.items()}
            got = {n: c(*a, **k) for n, c in chains.items()}
            print(f"   {label} B={b}: spans build vs this: "
                  + differ(got["this"], got["this, spans"]), flush=True)
            if tree is None:
                ms = chip_smoke.cuda_ms(lambda: chains["this"](*a, **k),
                                        reps=20)
                print(f"   {label} B={b}: {ms:.4f} ms", flush=True)
                continue
            print(f"   {label} B={b}: this vs tree: "
                  + differ(got["this"], got["tree"]), flush=True)
            order = ("tree", "this", "this", "tree")
            ms = [chip_smoke.cuda_ms(lambda: chains[n](*a, **k), reps=20)
                  for n in order]
            print(f"   {label} B={b}: ms in turns "
                  + ", ".join(f"{n} {t:.4f}" for n, t in zip(order, ms)),
                  flush=True)

    lib = ctypes.CDLL(str(built["this, spans"][0]))
    lib.sc_spans_read.argtypes = [ctypes.c_void_p]
    cyc = (ctypes.c_ulonglong * len(PHASES))()
    for kf_type, label in ((0, "K2"), (1, "K3")):
        args, kw = batch(dev, kf_type)
        lib.sc_spans_read(cyc)            # drop earlier launches
        chains["this, spans"](*args, **kw)
        lib.sc_spans_read(cyc)            # one launch
        total = sum(cyc)
        B = chip_smoke.B
        print(f"one launch of {label} at B={B}: cycles a scenario "
              f"{total / B:.5g}, a substep {total / B / 8:.5g}")
        for name, c in zip(PHASES, cyc):
            print(f"   {name:58s} {c / total:7.4f}  ({c / B:.5g} cycles a "
                  "scenario)")


if __name__ == "__main__":
    main()
