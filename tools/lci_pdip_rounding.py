"""How far the `--mpc lci` walk's float32 PDIP solves move with the last
bits of their Cholesky factor (CPU).

    python3 tools/lci_pdip_rounding.py

Captures the condensed QPs of tests/test_lci.py's walk (A1, 20 stand
ticks, 60 walk ticks of `make_walk_policy(velx=0.25)`: H=8, n=96) as the
policy hands them to the PDIP (`chip_smoke.lci_ticks`), and solves each at
B=1 with 12 iterations three ways: the plain float32 solve, the same solve
with each factor and solve computed in float64 and rounded to float32
(another correct float32 factorization, nearer the exact one), and in
float64. Prints, per QP, the largest GRF difference of the rounded
variant from plain and of both from float64 (p99, max, and how many QPs
exceed chip_smoke's PDIP_BRACKET): the spread any float32 factorization
gives this solve, against which chip_smoke holds K4 + K5 at n=96.
"""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from legged_mpc_control_tpu_torch.mpc import pdip  # noqa: E402
from legged_mpc_control_tpu_torch.ops import chol_kernel  # noqa: E402


def solve(P, q, mu, fz_max, contact, dt=torch.float32):
    return pdip._solve(P.to(dt)[None], q.to(dt)[None], mu.to(dt),
                       fz_max.to(dt), contact.to(dt)[None], iters=12,
                       tol=None, warm_u=None, dual_freeze=False).u[0]


def main():
    torch.set_num_threads(4)
    qps = cs.lci_ticks(torch.device("cpu"), "lci", cs.LCI_STAND,
                       cs.LCI_WALK, capture=True)["qps"]
    u_p = torch.stack([solve(*qp) for qp in qps])
    u64 = torch.stack([solve(*qp, dt=torch.float64) for qp in qps])

    def factor(K):
        return chol_kernel.cholesky_plain(K.double()).float()

    def fsolve(F, b):
        return chol_kernel.cho_solve_plain(F.double(), b.double()).float()
    with cs.patched(chol_kernel, cholesky_cuda=factor,
                    cho_solve_cuda=fsolve):
        u_r = torch.stack([solve(*qp) for qp in qps])
    br = cs.PDIP_BRACKET
    for name, d in (
            ("rounded vs plain", (u_r - u_p).abs().amax(-1)),
            ("plain vs float64", (u_p.double() - u64).abs().amax(-1)),
            ("rounded vs float64", (u_r.double() - u64).abs().amax(-1))):
        d = d.double()
        print(f"{name}: p99 {float(torch.quantile(d, 0.99)):.4e} N, max "
              f"{float(d.max()):.4e} N, {int((d > br).sum())} of {len(qps)} "
              f"QPs over {br} N", flush=True)


if __name__ == "__main__":
    main()
