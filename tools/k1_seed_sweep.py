"""K1 against the card test's float64 criteria over the fixture's seeds.

    python3 tools/k1_seed_sweep.py [TREE] [--seeds 1-16] [--out FILE]
    python3 tools/k1_seed_sweep.py [TREE] --trace SEED H B START

For each seed, the fixture of `tests/test_torch_cuda.py` (`_trot`: a Go1
batch of 257 after 20 standing and 10 trotting ticks on the card, its
generator seeded with the seed) and, at H = 10 (the per-stage store in
shared memory), 13 and 30 (device scratch), for B = 1, 5, 257 and a cold
and a warm start, the case of `test_riccati_kernel_matches_plain`: K1,
the plain float32 version and the plain float64 version, iters=15. TREE
is another checkout of the port (e.g. the parent, unpacked with `git
archive` under `checkouts/`): its package, kernels and fixture are used
instead of this checkout's.

Prints a JSON line a case and a summary. For K1 and plain, the largest
distance to the float64 solve and its 0.99 quantile (N); their distance
to the float64 solve that freezes where float32 does (tol=1e-6: the same
iterations in exact arithmetic, the kernel's own arithmetic error); which
of the card test's assertions fail:
- "max": K1's largest distance > 1.5 x plain's + 2e-2 N;
- "q99": the 0.99 quantile of K1's distance - 1.5 x plain's > 2e-2 N;
- "bracket": today's form, at B=257 the 0.99 quantile of |u_K1 - u_plain|
  > 2e-2 N, at B < 257 a scenario outside 2e-2 N of plain and not nearer
  float64 than plain;
- "sw": the scenario-wise form at every B: fewer than 99 % (B=257), or not
  all (B < 257), of the scenarios within 2e-2 N of plain or nearer float64;
- "gap": a non-finite force or a gap >= 1e-4;
and, for reference, which of "max", "q99", "sw" the freeze-matched float64
solve itself fails in K1's place ("ideal").

--trace runs one case's solves again at iters = 1 .. 15 and prints, for
K1's worst scenario, each solver's distance to the float64 solve (iters=15)
and K1's gap after each iteration count: where each one froze.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HORIZONS = (10, 13, 30)
BATCHES = (1, 5, 257)
BRACKET = 2e-2


def seeds(spec):
    lo, _, hi = spec.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def criteria(e64, p64, d, n_full):
    """The card test's assertions that fail, from the distances of the
    kernel (e64) and plain (p64) to float64 and between them (d)."""
    import torch

    fails = []
    if float(e64.max()) > 1.5 * float(p64.max()) + BRACKET:
        fails.append("max")
    if float(torch.quantile(e64 - 1.5 * p64, 0.99)) > BRACKET:
        fails.append("q99")
    near = ((d <= BRACKET) | (e64 < p64)).double().mean()
    if len(d) == n_full:
        if float(torch.quantile(d, 0.99)) > BRACKET:
            fails.append("bracket")
    elif float(near) < 1.0:
        fails.append("bracket")
    if float(near) < (0.99 if len(d) == n_full else 1.0):
        fails.append("sw")
    return fails


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--seeds", default="1-16")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace", nargs=4, default=None,
                    metavar=("SEED", "H", "B", "START"))
    ap.add_argument("--dump", default=None,
                    help="with --trace: torch.save the case's arguments, "
                         "warm start and K1's worst scenario there")
    opt = ap.parse_args()
    tree = Path(opt.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    from legged_mpc_control_tpu_torch.config import go1_params
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import convex_mpc, gait, riccati
    from legged_mpc_control_tpu_torch.ops import riccati_kernel
    from legged_mpc_control_tpu_torch.parallel import runner

    assert Path(riccati_kernel.__file__).is_relative_to(tree)
    dev = torch.device("cuda", 0)
    f32, n_full = torch.float32, max(BATCHES)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = open(opt.out, "w") if opt.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    t0 = time.time()
    rows = []
    params = go1_params(f32, dev)
    pattern = gait.trot_pattern(f32, dev)

    def fixture(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        loop = runner.init_loop_batch(params, n_full, gen, dtype=f32,
                                      body_height=0.28, device=dev)
        loop, _ = runner.make_batched_rollout(
            pattern, n_ticks=30, pdip_iters=4, walk_velx=0.15,
            stand_ticks=20, kf_type=0)(loop, params)
        return loop, step.broadcast_params(params, n_full)

    if opt.trace:
        seed, H, batch, start = (int(opt.trace[0]), int(opt.trace[1]),
                                 int(opt.trace[2]), opt.trace[3])
        loop, bp = fixture(seed)
        _, stage = convex_mpc.mpc_prepare(loop.controller, bp, pattern,
                                          0.01, horizon=H)
        args = tuple(x[:batch] for x in (
            stage.x0, stage.x_ref, stage.A_seq, stage.B, stage.contact,
            stage.q_weights, stage.r_weights, stage.mu,
            stage.fz_max)) + (0.01,)
        a64 = tuple(a.double() if torch.is_tensor(a) else a for a in args)
        warm = None
        if start == "warm":
            warm = riccati.warm_shift(riccati.solve_qp_riccati_batched(
                *args, iters=15)[0], args[4])
        w64 = None if warm is None else warm.double()
        u64 = riccati.solve_qp_riccati_batched(*a64, iters=15,
                                               warm_u=w64)[0]
        uk = riccati_kernel.solve_qp_riccati_cuda(*args, iters=15,
                                                  warm_u=warm)[0]
        worst = int((uk.double() - u64).abs().amax(-1).argmax())
        if opt.dump:
            torch.save(dict(args=[a.cpu() if torch.is_tensor(a) else a
                                  for a in args],
                            warm=None if warm is None else warm.cpu(),
                            worst=worst, u_k1=uk.cpu(), u64=u64.cpu()),
                       opt.dump)
        print(f"K1 of {tree} ({card}), seed {seed} H={H} B={batch} {start}:"
              f" scenario {worst}; distance to float64 (N) after k "
              "iterations, K1's gap")
        for k in range(1, 16):
            got = {
                "K1": riccati_kernel.solve_qp_riccati_cuda(
                    *args, iters=k, warm_u=warm),
                "plain": riccati.solve_qp_riccati_batched(
                    *args, iters=k, warm_u=warm),
                "float64 tol=1e-6": riccati.solve_qp_riccati_batched(
                    *a64, iters=k, warm_u=w64, tol=1e-6)}
            dist = {n: float((r[0][worst].double() - u64[worst]).abs().max())
                    for n, r in got.items()}
            print(f"   k={k:2d}: " + ", ".join(
                f"{n} {d:.4f}" for n, d in dist.items())
                + f"; K1 gap {float(got['K1'][1][worst]):.3e}", flush=True)
        return
    for seed in seeds(opt.seeds):
        loop, bp = fixture(seed)
        for H in HORIZONS:
            _, stage = convex_mpc.mpc_prepare(loop.controller, bp, pattern,
                                              0.01, horizon=H)
            full = (stage.x0, stage.x_ref, stage.A_seq, stage.B,
                    stage.contact, stage.q_weights, stage.r_weights,
                    stage.mu, stage.fz_max)
            for batch in BATCHES:
                args = tuple(x[:batch] for x in full) + (0.01,)
                a64 = tuple(a.double() if torch.is_tensor(a) else a
                            for a in args)
                for start in ("cold", "warm"):
                    warm = None
                    if start == "warm":
                        warm = riccati.warm_shift(
                            riccati.solve_qp_riccati_batched(
                                *args, iters=15)[0], args[4])
                    w64 = None if warm is None else warm.double()
                    uk, gk, _ = riccati_kernel.solve_qp_riccati_cuda(
                        *args, iters=15, warm_u=warm)
                    up = riccati.solve_qp_riccati_batched(
                        *args, iters=15, warm_u=warm)[0]
                    u64 = riccati.solve_qp_riccati_batched(
                        *a64, iters=15, warm_u=w64)[0]
                    uf = riccati.solve_qp_riccati_batched(
                        *a64, iters=15, warm_u=w64, tol=1e-6)[0]
                    uk, up = uk.double(), up.double()
                    e64 = (uk - u64).abs().amax(-1)
                    p64 = (up - u64).abs().amax(-1)
                    f64 = (uf - u64).abs().amax(-1)
                    d = (uk - up).abs().amax(-1)
                    fails = criteria(e64, p64, d, n_full)
                    if not (bool(torch.isfinite(uk).all())
                            and float(gk.max()) < 1e-4):
                        fails.append("gap")
                    ideal = [f for f in criteria(
                        f64, p64, (uf - up).abs().amax(-1), n_full)
                        if f in ("max", "q99", "sw")]
                    rec = dict(
                        tree=str(tree), seed=seed, H=H, B=batch, start=start,
                        k1_max=float(e64.max()),
                        k1_q99=float(torch.quantile(e64, 0.99)),
                        plain_max=float(p64.max()),
                        plain_q99=float(torch.quantile(p64, 0.99)),
                        k1_arith=float((uk - uf).abs().max()),
                        plain_arith=float((up - uf).abs().max()),
                        freeze_max=float(f64.max()), fails=fails,
                        ideal=ideal)
                    rows.append(rec)
                    emit(rec)

    def name(r):
        return f"seed {r['seed']} H={r['H']} B={r['B']} {r['start']}"

    print(f"K1 of {tree} ({card}), seeds {opt.seeds}: {len(rows)} cases "
          f"in {time.time() - t0:.0f} s")
    for H in HORIZONS:
        rh = [r for r in rows if r["H"] == H]
        for crit in ("max", "q99", "bracket", "sw", "gap"):
            bad = [r for r in rh if crit in r["fails"]]
            print(f"   H={H} {crit}: {len(bad)} of {len(rh)} fail"
                  + (": " + "; ".join(name(r) for r in bad) if bad else ""))
        f64_bad = [r for r in rh if {"max", "q99"} & set(r["fails"])]
        ideal_bad = [r for r in rh if r["ideal"]]
        full = [r for r in rh if r["B"] == n_full]
        nearer = sum(r["k1_max"] < r["plain_max"] for r in full)
        print(f"   H={H}: float64 criteria (max, q99) {len(rh) - len(f64_bad)}"
              f" of {len(rh)} pass; the freeze-matched float64 solve fails "
              f"max/q99/sw itself in {len(ideal_bad)}; at B={n_full} K1's "
              f"worst nearer float64 than plain's in {nearer} of {len(full)}; "
              f"largest arithmetic error K1 "
              f"{max(r['k1_arith'] for r in rh):.4f} N, plain "
              f"{max(r['plain_arith'] for r in rh):.4f} N")


if __name__ == "__main__":
    main()
