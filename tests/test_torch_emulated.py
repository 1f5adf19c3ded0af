"""The CUDA sources of kernels K1-K7, compiled as C++ for the CPU and run
against their plain PyTorch versions: a check of the kernels' arithmetic
where there is no card.

The sources are built with g++ under a small emulation of the CUDA
constructs they use: a block's threads are fibers (ucontext) run in
turn on one host thread, `__syncthreads` a barrier of the block and
`__syncwarp` one of the warp (a thread that returns drops out of both, as
an exited thread does on the card), a named barrier (`bar.sync id, n`)
one of the first n threads to arrive, `__all_sync`, `__shfl_xor_sync` and
`__shfl_sync` an exchange through memory within the warp (the shuffles
through two buffers in turn, one barrier each), `__syncthreads_and` one through memory within the
block, `__shared__` a static (a kernel's dynamic `extern __shared__` array
is edited into a static one; asynchronous copies are the sources'
synchronous fallbacks, their waits no-ops). The
`extern "C"` launchers (CUDA's `<<<>>>` syntax) are cut off and replaced by
launchers that run the blocks in turn. Float32 on both sides, so the
comparison uses the tolerances of the card's check (chip_smoke.py): K1 its
2e-2 N GRF bracket and the float64 rule (at H=30 also 2e-2 N to the
float64 solve that freezes where float32 does), K2 and K3 its state,
filter and Feedback brackets with equal contacts, K4, K5 and K6 relative
1e-5, K7 the TPU kernel's bracket against XLA
(tests/test_ci_fused.py:49-56). K7 runs a block of 192 threads a
scenario; its cases are the walked-in tick at H=10 and at H=12 (the
largest horizon the dispatch sends it), and a scenario whose candidates
all cost NaN; its batch variant (96 threads a scenario) runs the
walked-in tick at H=10 and 12 against plain and against the latency
variant bit for bit. Skipped where there is no g++ with C++20."""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from legged_mpc_control_tpu_torch.config import a1_params, go1_params
from legged_mpc_control_tpu_torch.constants import GRAVITY
from legged_mpc_control_tpu_torch.control import sensors, step
from legged_mpc_control_tpu_torch.mpc import (
    admm,
    ci_mpc,
    convex_mpc,
    gait,
    lci_mpc,
    riccati,
)
from legged_mpc_control_tpu_torch.ops import (
    admm_kernel,
    chol_kernel,
    ci_kernel,
    condense_kernel,
    substep_kernel,
)
from legged_mpc_control_tpu_torch.ops.cuda_build import CSRC_DIR
from legged_mpc_control_tpu_torch.parallel import runner

torch.set_num_threads(1)

PRELUDE = r"""
#include <ucontext.h>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <deque>
#include <functional>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define __grid_constant__
struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct double2 { double x, y; };
struct Dim { int x; };
Dim threadIdx, blockIdx, blockDim;      // the running thread's
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidDevice = 101,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
template <class T>
cudaError_t cudaFuncSetAttribute(T, int, int) { return cudaSuccess; }
struct cudaFuncAttributes { size_t sharedSizeBytes = 0; };
template <class T>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, T) {
  return cudaSuccess;
}
// A block's threads are fibers (ucontext) on one host thread; a thread runs
// until it waits at a barrier, the last to arrive releases the others.
struct Fiber { ucontext_t ctx; std::vector<char> stack; int tid; int turn; };
static ucontext_t g_sched;
static Fiber* g_cur = nullptr;
static std::deque<Fiber*> g_ready;
struct Barrier {
  int n = 0, arrived = 0;
  std::vector<Fiber*> waiting;
  void release() {
    for (Fiber* f : waiting) g_ready.push_back(f);
    waiting.clear();
    arrived = 0;
  }
  void wait() {
    if (++arrived == n) { release(); return; }
    waiting.push_back(g_cur);
    swapcontext(&g_cur->ctx, &g_sched);
  }
  void drop() {                         // a thread that returned
    --n;
    if (arrived > 0 && arrived == n) release();
  }
};
static Barrier g_bar;                   // the block's
static std::vector<Barrier> g_warp_bar; // a warp's
static int g_pred[1024];
inline Barrier& warp_bar() { return g_warp_bar[threadIdx.x / 32]; }
inline void __syncwarp() { warp_bar().wait(); }
inline void __syncthreads() { g_bar.wait(); }
// named barriers (bar.sync id, n): the first arrival sets the count
static Barrier g_named[16];
inline void named_sync(int id, int n) {
  if (g_named[id].arrived == 0) g_named[id].n = n;
  g_named[id].wait();
}
inline int __syncthreads_and(int p) {
  g_pred[threadIdx.x] = p;
  g_bar.wait();
  bool all = true;
  for (int i = 0; i < blockDim.x; ++i) all = all && g_pred[i];
  g_bar.wait();
  return all;
}
inline bool __all_sync(unsigned, bool p) {
  g_pred[threadIdx.x] = p;
  warp_bar().wait();
  bool all = true;
  for (int i = threadIdx.x & ~31; i < (threadIdx.x | 31) + 1; ++i)
    all = all && g_pred[i];
  warp_bar().wait();
  return all;
}
// two exchange buffers used in turn: a lane writes the next one while a
// slower lane may still read this one, and one barrier a shuffle suffices
static float g_xchg[2][1024];
inline float __shfl_sync(unsigned, float x, int src) {
  float* buf = g_xchg[g_cur->turn ^= 1];
  buf[threadIdx.x] = x;
  warp_bar().wait();
  return buf[(threadIdx.x & ~31) | src];
}
inline float __shfl_xor_sync(unsigned m, float x, int o) {
  return __shfl_sync(m, x, (threadIdx.x ^ o) & 31);
}
static double g_xchg_d[2][1024];
inline double __shfl_sync(unsigned, double x, int src) {
  double* buf = g_xchg_d[g_cur->turn ^= 1];
  buf[threadIdx.x] = x;
  warp_bar().wait();
  return buf[(threadIdx.x & ~31) | src];
}
using std::isfinite;
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
// the rounded-alone arithmetic intrinsics (no FMA contraction on the host:
// g++ targets x86-64 without FMA here)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
static std::function<void()>* g_body;
static void fiber_main() {
  (*g_body)();
  g_bar.drop();
  warp_bar().drop();
}
static void run_blocks(int B, int T, std::function<void()> body) {
  blockDim.x = T;
  g_body = &body;
  std::vector<Fiber> fibers(T);
  for (auto& f : fibers) f.stack.resize(1 << 18);
  for (int b = 0; b < B; ++b) {
    blockIdx.x = b;
    g_bar = Barrier{T};
    for (auto& nb : g_named) nb = Barrier{};
    g_warp_bar.assign((T + 31) / 32, Barrier{});
    for (int w = 0; w * 32 < T; ++w)
      g_warp_bar[w].n = T - 32 * w < 32 ? T - 32 * w : 32;
    for (int t = 0; t < T; ++t) {
      Fiber& f = fibers[t];
      f.tid = t;
      f.turn = 0;
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = &g_sched;
      makecontext(&f.ctx, fiber_main, 0);
      g_ready.push_back(&f);
    }
    while (!g_ready.empty()) {
      g_cur = g_ready.front();
      g_ready.pop_front();
      threadIdx.x = g_cur->tid;
      // back here when the fiber waits at a barrier or has returned
      swapcontext(&g_sched, &g_cur->ctx);
    }
    if (g_bar.n != 0) {                 // a thread still waits
      std::fprintf(stderr, "emulation: block %d deadlocked\n", b);
      std::abort();
    }
  }
}
"""

CI_LAUNCH = r"""
extern "C" void ci_sweeps_emu(const float* z0, const float* uh0,
    const float* ref_zu, const float* refT, const float* f_mask,
    const float* rho0, const float* iw_inv, const float* misc, float* U,
    float* Z, float* cost, int B, int H, int iters, float dt, float s_f,
    float rho_min, float reg, float state_reg) {
  Args p{z0, uh0, ref_zu, refT, f_mask, rho0, iw_inv, misc, U, Z, cost, H,
         iters, dt, s_f, rho_min, reg, state_reg};
  run_blocks(B, Latency::NT, [&]() { ci_sweeps(p); });
}
extern "C" void ci_sweeps_batch_emu(const float* z0, const float* uh0,
    const float* ref_zu, const float* refT, const float* f_mask,
    const float* rho0, const float* iw_inv, const float* misc, float* U,
    float* Z, float* cost, int B, int H, int iters, float dt, float s_f,
    float rho_min, float reg, float state_reg) {
  Args p{z0, uh0, ref_zu, refT, f_mask, rho0, iw_inv, misc, U, Z, cost, H,
         iters, dt, s_f, rho_min, reg, state_reg};
  run_blocks(B, Batch::NT, [&]() { ci_sweeps_batch(p); });
}
"""

CHOL_LAUNCH = r"""
extern "C" void chol_solve_emu(const float* F, const float* b, float* x,
                               int B, int n) {
  if (k5_staged(n, F)) {
    TriRows rows;
    tri_layout(n, &rows);
    run_blocks(B, WARP, [&]() { chol_solve_tri(F, b, x, n, rows); });
  } else if (n <= STREAM_N) {
    run_blocks((B + STREAM_WARPS - 1) / STREAM_WARPS, STREAM_WARPS * WARP,
               [&]() { chol_solve_stream<STREAM_R>(F, b, x, B, n); });
  } else {
    const int w = ring_warps(n);
    run_blocks((B + w - 1) / w, w * WARP,
               [&]() { chol_solve_ring(F, b, x, B, n); });
  }
}
extern "C" void chol_solve_multi_emu(const float* F, const float* R,
                                     float* X, int B, int n, int m) {
  if (k6_regs(n, m, F)) {
    run_blocks((B + MULTI_WARPS - 1) / MULTI_WARPS, MULTI_WARPS * WARP,
               [&]() { chol_solve_multi_regs<MULTI_N>(F, R, X, B, m); });
    return;
  }
  int t = 32 * ((m + 31) / 32);
  if (t > MULTI_THREADS_MAX) t = MULTI_THREADS_MAX;
  run_blocks(B, t, [&]() { chol_solve_multi_smem(F, R, X, n, m); });
}
"""

FACTOR_LAUNCH = r"""
extern "C" void chol_factor_emu(const float* K, float* F, int B, int n) {
  if (n <= SMALL_N) {
    run_blocks((B + SMALL_MATS - 1) / SMALL_MATS, SMALL_MATS * WARP,
               [&]() { chol_factor_small(K, F, B, n); });
  } else if (n <= MID_N) {
    run_blocks(B, MID_T * MID_T, [&]() { chol_factor_mid(K, F, n); });
  } else {
    int nb = (int)(SMEM_MAX / ((n | 1) * sizeof(float)));
    if (nb > NB) nb = NB;
    run_blocks(B, LARGE_THREADS, [&]() { chol_factor_large(K, F, n, nb); });
  }
}
"""

SUBSTEP_LAUNCH = r"""
extern "C" void substep_chain_emu(const float* in, const int* mode,
                                  float* out, int B, int substeps, float dt,
                                  int kf1) {
  const int per_warp = THREADS / lanes(kf1);
  run_blocks((B + per_warp - 1) / per_warp, THREADS, [&]() {
    if (kf1) substep_chain_kernel<true>(in, mode, out, B, substeps, dt);
    else substep_chain_kernel<false>(in, mode, out, B, substeps, dt);
  });
}
"""

ADMM_LAUNCH = r"""
extern "C" void admm_step_emu(const float* xt, const float* x,
    const float* z, const float* y, const float* G, const float* h,
    const float* q, float* x_out, float* z_out, float* y_out, float* rhs,
    int B, int H, float rho, float sigma, float alpha, float beta,
    float neg) {
  const long legs = (long)B * H * 4;
  run_blocks((int)((legs + THREADS - 1) / THREADS), THREADS, [&]() {
    admm_step_kernel(xt, x, z, y, G, h, q, x_out, z_out, y_out, rhs, legs,
                     rho, sigma, alpha, beta, neg);
  });
}
"""

CONDENSE_LAUNCH = r"""
extern "C" void condense_emu(const float* x0, const float* xref,
    const float* A, const float* Bm, const float* contact, const float* qw,
    const float* rw, int qs, int rs, float* P, float* q, int B, int H,
    double dt, double g) {
  const Args a{x0, xref, A, Bm, contact, qw, rw, P, q, qs, rs, H, dt,
               g * dt};
  run_blocks(B, THREADS, [&]() { condense_kernel(a); });
}
"""

RICCATI_LAUNCH = r"""
extern "C" int riccati_ipm_scratch_emu(int H) {
  return H <= SMEM_MAX_H ? 0 : H * ST_PER_STAGE;
}
extern "C" void riccati_ipm_emu(const float* x0, const float* xref,
    const float* A, const float* Bm, const float* contact, const float* qw,
    const float* rw, const float* mu, const float* fz, int qs, int rs,
    int ms, int fs, const float* u0, float* u, float* gap, float* lam,
    float* scr, int B, int H, int iters, float dt) {
  const Args a{x0, xref, A, Bm, contact, qw, rw, mu, fz, u0, u, gap, lam,
               scr, qs, rs, ms, fs, B, H, iters, dt};
  const bool smem = H <= SMEM_MAX_H, f64 = H >= F64_MIN_H;
  const int wpb = smem ? WARPS_SMEM : WARPS_GLOBAL;
  run_blocks((B + wpb - 1) / wpb, 32 * wpb, [&]() {
    if (smem) {
      if (f64) riccati_ipm_kernel<true, true>(a);
      else riccati_ipm_kernel<true, false>(a);
    } else {
      if (f64) riccati_ipm_kernel<false, true>(a);
      else riccati_ipm_kernel<false, false>(a);
    }
  });
}
"""


def _emulated(name, launcher, out_dir: Path, edits=()):
    src = (CSRC_DIR / f"{name}.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", PRELUDE)
    src = src[:src.index('extern "C"')]          # the CUDA launchers
    for old, new in edits:
        src = src.replace(old, new)
    cpp = out_dir / f"{name}.cpp"
    cpp.write_text(src + launcher)
    lib = out_dir / f"lib{name}_emu.so"
    proc = subprocess.run(
        ["g++", "-std=c++20", "-O2", "-shared", "-fPIC", "-pthread", "-o",
         str(lib), str(cpp)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the CUDA sources for the "
                    "CPU")
    out = tmp_path_factory.mktemp("emulated")
    # the kernels' dynamic (extern) shared arrays: static buffers here
    ci = _emulated("ci_sweeps", CI_LAUNCH, out, edits=(
        ("extern __shared__ float4 smem4[];", "static float4 smem4[8192];"),
        ('asm volatile("bar.sync 1, %0;" ::"n"(NT - WARP) : "memory");',
         "named_sync(1, NT - WARP);")))
    for entry in (ci.ci_sweeps_emu, ci.ci_sweeps_batch_emu):
        entry.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                          + [ctypes.c_float] * 5)
    chol = _emulated("chol_lanes", CHOL_LAUNCH, out, edits=(
        ("extern __shared__ float4 sm4[];", "static float4 sm4[8192];"),))
    chol.chol_solve_emu.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    chol.chol_solve_multi_emu.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3
    return ci, chol


@pytest.fixture(scope="module")
def factor_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the CUDA sources for the "
                    "CPU")
    lib = _emulated("chol_factor", FACTOR_LAUNCH,
                    tmp_path_factory.mktemp("emulated_k4"), edits=(
        ("extern __shared__ float tri[];", "static float tri[128 * 129];"),
        ("extern __shared__ float panel[];", "static float panel[65536];")))
    lib.chol_factor_emu.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    return lib


@pytest.mark.parametrize("n,batch", [(7, 3), (18, 3), (24, 3), (120, 2),
                                     (360, 2)])
def test_k4_emulated_matches_plain(factor_lib, n, batch):
    """K4's three variants (a warp a matrix for n <= 32, a register-tiled
    block for n <= 128, the blocked panel factor above) on well-conditioned
    SPD matrices, NaN above the diagonal (only the lower triangle may be
    read) and a negative pivot in matrix 1 (its factor, and only its, must
    come out non-finite)."""
    gen = torch.Generator().manual_seed(n)
    A = torch.randn((batch, n, n), generator=gen)
    K = A @ A.mT * 0.05 + 5.0 * torch.eye(n)
    K[1, n // 2, n // 2] = -1.0
    nan_upper = torch.full((n, n), float("nan")).triu(1)
    Kin = (K.tril() + nan_upper).contiguous()
    F = torch.empty_like(K)
    factor_lib.chol_factor_emu(Kin.data_ptr(), F.data_ptr(), batch, n)
    finite = torch.isfinite(F.reshape(batch, -1)).all(-1).tolist()
    assert finite == [i != 1 for i in range(batch)]
    good = torch.arange(batch) != 1
    Fg, Fp = F[good], chol_kernel.cholesky_plain(K[good])
    assert torch.equal(Fg, Fg.mT)
    assert float((Fg - Fp).abs().max() / Fp.abs().max()) < 1e-5


def _spd_factor(batch, n, seed):
    """Factors (cholesky_plain) of well-conditioned SPD matrices, with a
    NaN on matrix 1's diagonal halfway down."""
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn((batch, n, n), generator=gen)
    F = chol_kernel.cholesky_plain(A @ A.mT * 0.05 + 5.0 * torch.eye(n))
    F[1, n // 2, n // 2] = float("nan")
    return F, gen


def _check_solution(X, Xp):
    """Matrix 1 (the NaN factor) non-finite, the others within 1e-5 of the
    plain version, relative to its largest entry. (Matrix 2's right-hand
    side starts with a zero, a dividend the kernels' fast division takes;
    matrix 0's with a subnormal, which sends it to their solve with IEEE
    divisions.)"""
    batch = X.shape[0]
    finite = torch.isfinite(X.reshape(batch, -1)).all(-1).tolist()
    assert finite == [i != 1 for i in range(batch)]
    good = torch.arange(batch) != 1
    assert float((X[good] - Xp[good]).abs().max()
                 / Xp[good].abs().max()) < 1e-5


# n = 24 and 120 take the staged-triangle variant, 7, 18 (the articulated
# twin's mass matrices) and 360 the streamed rows, 400 the ring with its
# right-hand side in shared memory; batch 3 leaves the streamed variants'
# last block of two warps ragged
@pytest.mark.parametrize("n", [7, 18, 24, 120, 360, 400])
def test_k5_emulated_matches_plain(libs, n):
    _, chol = libs
    batch = 3
    F, gen = _spd_factor(batch, n, n)
    b = torch.randn((batch, n), generator=gen)
    b[2, 0], b[0, 0] = 0.0, 1e-40
    x = torch.empty_like(b)
    chol.chol_solve_emu(F.data_ptr(), b.data_ptr(), x.data_ptr(), batch, n)
    _check_solution(x, chol_kernel.cho_solve_plain(F, b))


# (24, 25) is the path's shape (X in registers), the others take the
# shared-memory variant; batch 3 leaves a block of two warps ragged
@pytest.mark.parametrize("n,m", [(24, 25), (7, 3), (33, 40)])
def test_k6_emulated_matches_plain(libs, n, m):
    _, chol = libs
    batch = 3
    F, gen = _spd_factor(batch, n, n + m)
    R = torch.randn((batch, n, m), generator=gen)
    R[2, 0], R[0, 0] = 0.0, 1e-40
    X = torch.empty_like(R)
    chol.chol_solve_multi_emu(F.data_ptr(), R.data_ptr(), X.data_ptr(),
                              batch, n, m)
    _check_solution(X, chol_kernel.cho_solve_multi_plain(F, R))


def _ci_tick_args(batch, horizon=10):
    """K7's arguments (float32, CPU) in the solve of a walked-in flat CI
    tick: A1, `batch` scenarios, 6 ticks of 24 sweeps, then the 7th's."""
    f32 = torch.float32
    p = a1_params(f32, "cpu")
    walk = ci_mpc.make_ci_walk_policy_batched(p, velx=0.1, iters=24,
                                              horizon=horizon)
    stand = lci_mpc.make_stand_policy(p)
    loop = runner.init_loop_batch(p, batch, torch.Generator().manual_seed(0),
                                  dtype=f32, device="cpu")
    cs = loop.controller
    loop = loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=torch.ones(batch, dtype=torch.int32))))
    lci = lci_mpc.lci_init_batched(batch, f32,
                                   walk.warm_init(batch, f32, "cpu"),
                                   device="cpu")
    for k in range(6):
        loop, lci = step.closed_loop_tick_lci_batched(loop, lci, p, stand,
                                                      walk, 0.01 * k)
    seen = {}
    plain = ci_kernel.ci_sweeps_cuda

    def capture(*a, **kw):
        seen["args"] = (a, kw)
        return plain(*a, **kw)
    ci_mpc.ci_kernel.ci_sweeps_cuda = capture
    try:
        step.closed_loop_tick_lci_batched(loop, lci, p, stand, walk, 0.06)
    finally:
        ci_mpc.ci_kernel.ci_sweeps_cuda = plain
    a, kw = seen["args"]
    return tuple(x.contiguous() for x in a), kw


@pytest.fixture(scope="module")
def ci_tick4():
    return _ci_tick_args(4)


def _k7_emulated(ci, a, kw, batch=False):
    """K7's latency variant emulated, or its batch variant."""
    z0, Uh0, ref_zu, refT, f_mask, rho0, wvec, mu, mass, Iw_inv = a
    B, H = Uh0.shape[:2]
    misc = torch.cat([wvec, mu.reshape(1), mass.reshape(1)])
    U, Z = torch.empty((B, H, 24)), torch.empty((B, H + 1, 24))
    cost = torch.empty(B)
    (ci.ci_sweeps_batch_emu if batch else ci.ci_sweeps_emu)(
        z0.data_ptr(), Uh0.data_ptr(), ref_zu.data_ptr(), refT.data_ptr(),
        f_mask.data_ptr(), rho0.data_ptr(), Iw_inv.data_ptr(),
        misc.data_ptr(), U.data_ptr(), Z.data_ptr(), cost.data_ptr(), B, H,
        kw["iters"], kw["dt"], kw["s_f"], kw["rho_min"], kw["reg"],
        kw["state_reg"])
    return U, Z, cost


def _k7_errors(got, want):
    """Per-scenario errors keyed as chip_smoke.py's K7_TOL."""
    (U, Z, cost), (Up, Zp, cp) = got, want
    B = U.shape[0]

    def per(x, y):
        return (x.double() - y.double()).abs().reshape(B, -1).amax(-1)
    return {"forces": 50.0 * per(U[..., :12], Up[..., :12]),
            "foot_vel": per(U[..., 12:], Up[..., 12:]), "Z": per(Z, Zp),
            "cost": (cost - cp).abs() / cp.abs()}


K7_TOL = (("forces", 0.5), ("foot_vel", 2e-2), ("Z", 2e-3), ("cost", 2e-3))


def _k7_against_plain(ci, a, kw, batch=False):
    """K7 emulated against its plain version in float32 (the bracket, every
    scenario) and float64 (printed); returns its result."""
    got = _k7_emulated(ci, a, kw, batch)
    err = _k7_errors(got, ci_kernel.ci_sweeps_plain(*a, **kw))
    U64 = ci_kernel.ci_sweeps_plain(*(x.double() for x in a), **kw)[0]
    f64 = 50.0 * (got[0][..., :12].double() - U64[..., :12]).abs().max()
    print({k: float(v.max()) for k, v in err.items()},
          "forces vs float64:", float(f64))
    for name, tol in K7_TOL:
        assert float(err[name].max()) <= tol, name
    assert bool(torch.isfinite(got[0]).all())
    return got


def test_k7_emulated_matches_plain(libs, ci_tick4):
    """K7 on the solve of a walked-in flat CI tick (A1, B=4, 6 ticks of 24
    sweeps), against its plain version in float32 and float64."""
    ci, _ = libs
    _k7_against_plain(ci, *ci_tick4)


def test_k7_emulated_horizon_12(libs):
    """The same at H=12, the largest horizon the dispatch sends K7 (B=2)."""
    ci, _ = libs
    a, kw = _ci_tick_args(2, horizon=12)
    assert a[1].shape[1] == 12
    _k7_against_plain(ci, a, kw)


def test_k7_emulated_all_nonfinite_keeps_nominal(libs, ci_tick4):
    """A NaN in scenario 1's input reference at stage 5 makes all its five
    candidates cost NaN: it keeps its nominal (the warm start and its
    rollout) with cost inf, as the plain version does; the other scenarios
    match plain (tests/test_torch_ci.py's all-non-finite case, 2 sweeps)."""
    ci, _ = libs
    a, kw = ci_tick4
    kw = dict(kw, iters=2)
    ref_zu = a[2].clone()
    ref_zu[1, 5, 24] = float("nan")
    a = a[:2] + (ref_zu,) + a[3:]
    U, Z, cost = _k7_emulated(ci, a, kw)
    Up, Zp, cp = ci_kernel.ci_sweeps_plain(*a, **kw)
    assert torch.equal(Up[1], a[1][1]) and bool(torch.isinf(cp[1]))
    assert torch.equal(U[1], a[1][1]) and bool(torch.isinf(cost[1]))
    rollout = _k7_emulated(ci, a, dict(kw, iters=0))[1]
    assert torch.equal(Z[1], rollout[1])
    assert float((Z[1] - Zp[1]).abs().max()) <= 2e-3
    keep = torch.tensor([0, 2, 3])
    err = _k7_errors((U[keep], Z[keep], cost[keep]),
                     (Up[keep], Zp[keep], cp[keep]))
    for name, tol in K7_TOL:
        assert float(err[name].max()) <= tol, name


@pytest.fixture(scope="module")
def ci_tick4_h12():
    return _ci_tick_args(4, horizon=12)


@pytest.mark.parametrize("horizon", [10, 12])
def test_k7_batch_emulated_matches_plain(libs, ci_tick4, ci_tick4_h12,
                                         horizon):
    """K7's batch variant (three warps a scenario, its stage scratch
    aliased, Fz and Fu by column) on the walked-in tick of
    test_k7_emulated_matches_plain (B=4) at H=10 and H=12: against the
    plain version under the same tolerances, and bit for bit the latency
    variant's result (the same device functions, in the same order)."""
    ci, _ = libs
    a, kw = ci_tick4 if horizon == 10 else ci_tick4_h12
    assert a[1].shape[:2] == (4, horizon)
    got = _k7_against_plain(ci, a, kw, batch=True)
    for x, y in zip(got, _k7_emulated(ci, a, kw)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def riccati_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the CUDA sources for the "
                    "CPU")
    lib = _emulated("riccati_ipm", RICCATI_LAUNCH,
                    tmp_path_factory.mktemp("emulated_k1"), edits=(
        ("extern __shared__ float4 smem4[];", "static float4 smem4[8192];"),))
    lib.riccati_ipm_emu.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 3 + [ctypes.c_float])
    return lib


@pytest.fixture(scope="module")
def trot3():
    """A Go1 batch of 3 after 20 standing and 6 trotting ticks (CPU,
    float32, the plain solver)."""
    f32 = torch.float32
    params = go1_params(f32, "cpu")
    pattern = gait.trot_pattern(f32, "cpu")
    loop = runner.init_loop_batch(params, 3, torch.Generator().manual_seed(3),
                                  dtype=f32, body_height=0.28, device="cpu")
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=26, pdip_iters=4, walk_velx=0.15,
        stand_ticks=20)(loop, params)
    return loop, step.broadcast_params(params, 3), pattern


# H=10 keeps K1's per-stage store in shared memory, H=13 in device scratch
@pytest.mark.parametrize("horizon,start", [(10, "cold"), (10, "warm"),
                                           (13, "cold"), (13, "warm")])
def test_k1_emulated_matches_plain(riccati_lib, trot3, horizon, start):
    """K1 on the QP of the port's own `mpc_prepare` (cold, or warm from the
    shifted plain solution, as the loop calls it) against the plain
    float32 version, with float64 as the exact reference."""
    loop, params, pattern = trot3
    _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern,
                                      0.01, horizon=horizon)
    args = (stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu, stage.fz_max, 0.01)
    iters = 15 if start == "cold" else 4
    warm_u = None
    if start == "warm":
        warm_u = riccati.warm_shift(
            riccati.solve_qp_riccati_batched(*args, iters=15)[0],
            stage.contact)
    Bn, H = stage.x_ref.shape[:2]
    ins = [x.contiguous() for x in (stage.x0, stage.x_ref, stage.A_seq,
                                    stage.B, stage.contact, stage.q_weights,
                                    stage.r_weights, stage.mu,
                                    stage.fz_max)]
    u, gap = torch.empty((Bn, 12 * H)), torch.empty(Bn)
    lam = torch.empty((Bn, H, 4, 6))
    scr = torch.empty((Bn, riccati_lib.riccati_ipm_scratch_emu(H)))
    riccati_lib.riccati_ipm_emu(
        *[x.data_ptr() for x in ins], 12, 12, 1, 1,
        None if warm_u is None else warm_u.contiguous().data_ptr(),
        u.data_ptr(), gap.data_ptr(), lam.data_ptr(), scr.data_ptr(), Bn, H,
        iters, 0.01)
    up, gp, lp = riccati.solve_qp_riccati_batched(*args, iters=iters,
                                                  warm_u=warm_u)
    u64 = riccati.solve_qp_riccati_batched(
        *(a.double() if torch.is_tensor(a) else a for a in args),
        iters=iters, warm_u=None if warm_u is None else warm_u.double())[0]
    d = (u - up).abs().amax(-1)
    e64 = float((u.double() - u64).abs().max())
    p64 = float((up.double() - u64).abs().max())
    print(f"H={H} {start}: max|u - u_plain| {float(d.max()):.3e} N; vs "
          f"float64 {e64:.3e} N (plain {p64:.3e}); gap {gap.tolist()} "
          f"(plain {gp.tolist()})")
    assert bool(torch.isfinite(u).all()) and bool(torch.isfinite(lam).all())
    assert float(torch.quantile(d.double(), 0.99)) <= 2e-2
    assert e64 <= 1.5 * p64 + 2e-2
    if start == "cold":
        assert float(gap.max()) < 1e-4


def test_k1_emulated_horizon_30(riccati_lib):
    """K1 at H=30 (its per-stage store in device scratch, its factor sweep
    in float64) on the card tests' batch recipe at B=8: a Go1 batch (seed 1)
    after 20 standing and 10 trotting ticks, cold, iters=15. Besides the
    card test's float64 rule: within the 2e-2 N bracket of the float64
    solve that freezes where float32 does (tol=1e-6), i.e. the same
    iterations in exact arithmetic. The kernel is 4e-4 N from it; the plain
    float32 version, and the port's earlier kernel with its float32 factor
    sweep, are 0.10 N from it."""
    f32 = torch.float32
    params = go1_params(f32, "cpu")
    pattern = gait.trot_pattern(f32, "cpu")
    loop = runner.init_loop_batch(params, 8, torch.Generator().manual_seed(1),
                                  dtype=f32, body_height=0.28, device="cpu")
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15,
        stand_ticks=20)(loop, params)
    _, stage = convex_mpc.mpc_prepare(loop.controller,
                                      step.broadcast_params(params, 8),
                                      pattern, 0.01, horizon=30)
    ins = [x.contiguous() for x in (stage.x0, stage.x_ref, stage.A_seq,
                                    stage.B, stage.contact, stage.q_weights,
                                    stage.r_weights, stage.mu,
                                    stage.fz_max)]
    u, gap = torch.empty((8, 360)), torch.empty(8)
    lam = torch.empty((8, 30, 4, 6))
    scr = torch.empty((8, riccati_lib.riccati_ipm_scratch_emu(30)))
    riccati_lib.riccati_ipm_emu(
        *[x.data_ptr() for x in ins], 12, 12, 1, 1, None, u.data_ptr(),
        gap.data_ptr(), lam.data_ptr(), scr.data_ptr(), 8, 30, 15, 0.01)
    args = tuple(ins) + (0.01,)
    up = riccati.solve_qp_riccati_batched(*args, iters=15)[0]
    a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
    u64 = riccati.solve_qp_riccati_batched(*a64, iters=15)[0]
    u64_freeze = riccati.solve_qp_riccati_batched(*a64, iters=15,
                                                  tol=1e-6)[0]
    e64 = (u.double() - u64).abs().amax(-1)
    p64 = (up.double() - u64).abs().amax(-1)
    arith = float((u.double() - u64_freeze).abs().max())
    print(f"H=30 cold, B=8: vs float64 kernel {float(e64.max()):.4f} N, "
          f"plain {float(p64.max()):.4f} N; vs float64 with tol=1e-6 "
          f"kernel {arith:.2e} N")
    assert bool(torch.isfinite(u).all()) and float(gap.max()) < 1e-4
    assert float(e64.max()) <= 1.5 * float(p64.max()) + 2e-2
    assert float(torch.quantile(e64 - 1.5 * p64, 0.99)) <= 2e-2
    assert arith <= 2e-2

@pytest.fixture(scope="module")
def substep_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the CUDA sources for the "
                    "CPU")
    lib = _emulated("substep_chain", SUBSTEP_LAUNCH,
                    tmp_path_factory.mktemp("emulated_k2"),
                    edits=(("#include <math.h>",
                            "#include <math.h>\nusing std::isnan;"),))
    lib.substep_chain_emu.argtypes = ([ctypes.c_void_p] * 3
                                      + [ctypes.c_int] * 2
                                      + [ctypes.c_float, ctypes.c_int])
    return lib


# chip_smoke.py's brackets of K2 and K3 against the plain version
STATE_TOL = {"pos": 2e-4, "quat": 2e-4, "vel": 2e-3, "omega": 5e-3,
             "q": 2e-3, "dq": 5e-2, "anchor": 2e-4, "q_tgt": 2e-3,
             "dq_tgt": 5e-2, "tau_ff": 1e-2, "kf_x": 2e-3}
FB_TOL = {"euler": 1e-4, "rotmat": 1e-4, "foot_pos_rel": 2e-3,
          "foot_pos_abs": 2e-3, "foot_vel_rel": 6e-2, "foot_vel_abs": 6e-2,
          "foot_vel_world": 6e-2, "jac": 2e-3, "foot_force_sensor": 0.5,
          "contact_sig": 0.05, "contact_bool": 0.0, "force_tau_est": 0.5,
          "raibert_abs": 2e-3, "imu_acc": 5e-2, "imu_gyro": 5e-3}
KF_P_TOL = (2e-4, 2e-3)                 # (atol, rtol)


# B=5 leaves the last warp ragged: K2 runs two scenarios a warp (16 lanes
# each), K3 four (8 lanes each)
@pytest.mark.parametrize("kf_type", [0, 1])
def test_k2_k3_emulated_match_plain(substep_lib, kf_type):
    """K2 (kf_type 0) and K3 (kf_type 1) over one tick's 8 substeps from
    mid-trot (Go1, B=5, 20 standing and 10 trotting ticks; under kf_type 1
    with the filter in the loop), against the plain version with the
    brackets of chip_smoke.py: the same contacts in every scenario."""
    f32, batch = torch.float32, 5
    params = go1_params(f32, "cpu")
    pattern = gait.trot_pattern(f32, "cpu")
    loop = runner.init_loop_batch(params, batch,
                                  torch.Generator().manual_seed(4),
                                  height_range=(0.26, 0.30), dtype=f32,
                                  body_height=0.28, device="cpu")
    loop, _ = runner.make_batched_rollout(
        pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15, stand_ticks=20,
        kf_type=kf_type)(loop, params)
    pb = step.broadcast_params(params, batch)
    cs, _ = convex_mpc.mpc_tick_batched(loop.controller, pb, pattern, 0.01,
                                        horizon=10, iters=4)
    sim = loop.sim
    assert 0.0 < float(sim.contact.float().mean()) < 1.0
    args = (sim.pos, sim.quat, sim.vel, sim.omega, sim.q, sim.dq,
            sim.contact, sim.anchor, cs.ctrl.optimized_state,
            cs.ctrl.optimized_input, cs.ctrl.movement_mode, pb.mass, pb.mu,
            pb.kp_foot, pb.kd_foot, pb.trunk_inertia, pb.rho_fix,
            pb.default_foot_pos, pb.gait_counter_speed,
            sensors.contact_threshold(pb), cs.ctrl.root_lin_vel_d_rel)
    kw = dict(substeps=8, dt=0.00125, kf_type=kf_type)
    if kf_type == 1:
        kw.update(kf_x=cs.kf.x, kf_P=cs.kf.P)
    packed, mode, out = substep_kernel.pack(*args, **{
        k: v for k, v in kw.items() if k.startswith("kf")})
    out.fill_(float("nan"))
    substep_lib.substep_chain_emu(packed.data_ptr(), mode.data_ptr(),
                                  out.data_ptr(), batch, 8, 0.00125, kf_type)
    got = substep_kernel.unpack(out, kf_type)
    want = substep_kernel.substep_chain_plain(*args, **kw)
    assert bool(torch.isfinite(out).all())      # every row written
    assert torch.equal(got["contact"], want["contact"])
    for name, tol in STATE_TOL.items():
        if name in want:
            assert float((got[name] - want[name]).abs().max()) <= tol, name
    for name, (off, n) in substep_kernel.FB_ROWS.items():
        e = float((got["fb"][:, off:off + n]
                   - want["fb"][:, off:off + n]).abs().max())
        assert e <= FB_TOL[name], (name, e)
    if kf_type == 1:
        atol, rtol = KF_P_TOL
        dP = (got["kf_P"] - want["kf_P"]).abs()
        assert float((dP - rtol * want["kf_P"].abs()).max()) <= atol


@pytest.fixture(scope="module")
def admm_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the CUDA sources for the "
                    "CPU")
    lib = _emulated("admm_step", ADMM_LAUNCH,
                    tmp_path_factory.mktemp("emulated_admm"))
    lib.admm_step_emu.argtypes = ([ctypes.c_void_p] * 11
                                  + [ctypes.c_int] * 2
                                  + [ctypes.c_float] * 5)
    return lib


def _emulated_step(lib, calls):
    """`admm_kernel.admm_step` with the emulated kernel in the launch's
    place; appends to `calls` whether each call updates (x_t given)."""
    def step_emu(x_t, x, z, y, Gb, hs, qs, *, rho, sigma, alpha, neg):
        calls.append(x_t is not None)
        B, H = Gb.shape[:2]
        x, z, y, Gb, hs, qs = (t.contiguous() for t in (x, z, y, Gb, hs,
                                                         qs))
        outs, ptrs = (x, z, y), (None,) * 3
        if x_t is not None:
            x_t = x_t.contiguous()
            outs = tuple(torch.full_like(t, float("nan")) for t in outs)
            ptrs = tuple(t.data_ptr() for t in outs)
        r = torch.full_like(x, float("nan"))
        lib.admm_step_emu(
            None if x_t is None else x_t.data_ptr(), x.data_ptr(),
            z.data_ptr(), y.data_ptr(), Gb.data_ptr(), hs.data_ptr(),
            qs.data_ptr(), *ptrs, r.data_ptr(), B, H, rho, sigma, alpha,
            1.0 - alpha, neg)
        return (*outs, r)
    return step_emu


# H=30 is the ADMM cell's horizon (n = 360), H=10 the loop's default
@pytest.mark.parametrize("horizon,start", [(30, "cold"), (30, "warm"),
                                           (10, "warm")])
def test_admm_step_emulated_matches_plain(admm_lib, trot3, monkeypatch,
                                          horizon, start):
    """Thirty ADMM iterations (rho 1e-3, the cell's) on the condensed QP of
    the port's own `mpc_prepare` (a trotting Go1 batch of 3, so some legs
    swing over the horizon), with per-scenario mu and fz_max, cold or warm
    from a plain solve: K5's plain version and the emulated step kernel
    against the plain solve, in float32. The kernel rounds every product
    and sum alone, in the torch operations' order (the 3- and 6-term
    products summed from the first term on, as torch's small batched
    products sum them on the CPU), so the emulation reproduces the plain
    solve's bits here. The tolerance, 5e-4 of each array's largest entry,
    leaves room for a torch that sums those products in another order or
    with FMAs: the iterations carry one rounding more or less in every
    product to at most 1.2e-4 of it after thirty (u 7e-5, x 1.2e-4, both
    products summed in float64 and rounded once, on these QPs)."""
    loop, params, pattern = trot3
    _, stage = convex_mpc.mpc_prepare(loop.controller, params, pattern,
                                      0.01, horizon=horizon)
    qp = convex_mpc.build_condensed_from_stage(stage, 0.01)
    assert 0.0 < float(qp.contact.float().mean()) < 1.0
    args = (qp.P, qp.q, torch.tensor([0.35, 0.6, 0.9]),
            torch.tensor([140.0, 180.0, 250.0]), qp.contact)
    kw = dict(iters=30, rho=1e-3)
    warm = (admm.solve_qp_admm_batched(*args, **kw).warm
            if start == "warm" else None)
    want = admm.solve_qp_admm_batched(*args, warm=warm, **kw)
    calls = []
    monkeypatch.setattr(admm_kernel, "admm_step",
                        _emulated_step(admm_lib, calls))
    got = admm.solve_qp_admm_batched(*args, warm=warm, **kw)
    assert calls == [False] + [True] * 30
    assert float(want.u.abs().max()) > 10.0
    for a, b in zip((got.u, *got.warm), (want.u, *want.warm)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 5e-4 * float(b.abs().max())
    print(f"H={horizon} {start}: bit for bit "
          f"{all(torch.equal(a, b) for a, b in zip(got.warm, want.warm))}")


@pytest.fixture(scope="module")
def condense_lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (C++20) to compile the CUDA sources for the "
                    "CPU")
    lib = _emulated("condense", CONDENSE_LAUNCH,
                    tmp_path_factory.mktemp("emulated_condense"), edits=(
        ("extern __shared__ double smem[];",
         "static double smem[smem_doubles(MAX_H)];"),))
    lib.condense_emu.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 2 + [ctypes.c_double] * 2)
    return lib


def _ulp32(x):
    """The spacing of float32 at |x| (float64 in, float64 out)."""
    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


# H=5 leaves the last 2 x 2 tile of block pairs half outside the matrix
@pytest.mark.parametrize("horizon", [5, 10, 30])
def test_condense_emulated_matches_plain(condense_lib, trot3, horizon):
    """The build kernel on the port's own `mpc_prepare` QP of the trotting
    Go1 batch of 3, the third with leg 1 in swing over the whole horizon,
    and a fourth scenario, the first's state with every leg in stance
    throughout; Q per scenario (stride 12), R shared (stride 0). Float32 in, held to the plain version in float64 on
    the same inputs: every P entry within 2 float32 ulps of itself plus
    1e-9 of the largest, P exactly symmetric, the swing legs' rows and
    columns exactly zero but for R on the diagonal, q within relative
    1e-6."""
    loop, params, pattern = trot3
    _, st = convex_mpc.mpc_prepare(loop.controller, params, pattern, 0.01,
                                   horizon=horizon)

    def four(t):
        return torch.cat([t, t[:1]]).contiguous()
    x0, x_ref, A, Bm, contact, qw = (four(t) for t in (
        st.x0, st.x_ref, st.A_seq, st.B, st.contact, st.q_weights))
    contact[2, :, 1] = 0.0
    contact[3] = 1.0
    rw = st.r_weights[0].contiguous()
    assert 0.0 < float(contact[:2].mean()) < 1.0
    Bn, H, n = 4, horizon, 12 * horizon
    P, q = torch.empty((Bn, n, n)), torch.empty((Bn, n))
    condense_lib.condense_emu(
        *[t.data_ptr() for t in (x0, x_ref, A, Bm, contact, qw, rw)], 12, 0,
        P.data_ptr(), q.data_ptr(), Bn, H, 0.01, GRAVITY)
    P64, q64 = condense_kernel.condense_plain(
        *(t.double() for t in (x0, x_ref, A, Bm, contact, qw, rw)), 0.01)
    err = (P.double() - P64).abs()
    top = P64.abs().amax((-1, -2), keepdim=True)
    print(f"H={H}: max |P - P64| / ulp32 {float((err / _ulp32(P64)).max())}"
          f", / max|P64| {float((err / top).max()):.2e}; max |q - q64| / "
          f"|q64| {float(((q.double() - q64).abs() / q64.abs()).nan_to_num().max()):.2e}")
    assert bool(torch.isfinite(P).all()) and bool(torch.isfinite(q).all())
    assert bool((err <= 2 * _ulp32(P64) + 1e-9 * top).all())
    assert torch.equal(P, P.transpose(-1, -2))
    swing = (contact.repeat_interleave(3, -1) == 0).reshape(Bn, n)
    assert bool(swing[2].any()) and not bool(swing[3].any())
    off = swing[:, :, None] | swing[:, None, :]
    off &= ~torch.eye(n, dtype=torch.bool)
    assert bool((P[off] == 0).all())
    diag = P.diagonal(dim1=-2, dim2=-1)
    assert torch.equal(diag[swing], rw.repeat(H).expand(Bn, n)[swing])
    torch.testing.assert_close(q.double(), q64, rtol=1e-6,
                               atol=1e-9 * float(q64.abs().max()))
