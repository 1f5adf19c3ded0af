"""Which scenarios of a benchmark cell go non-finite, and when.

    python3 tools/ci_nonfinite.py [TREE] --seed S [--workload a1_ci.b4096]
        [--ticks 1000] [--every 10]

Sets the cell up as `benchmark/run.py` does (from TREE's own benchmark and
package, by default this checkout's), ticks it `--ticks` times and, every
`--every` ticks, prints the scenarios that have newly gained a non-finite
leaf in the program's state, which leaves, and which of them the cell's
check samples; then the trunks' final quality. A sampled non-finite
scenario makes the check's `last.*` read inf. Card only.
"""

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--workload", default="a1_ci.b4096")
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--every", type=int, default=10)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import torch
    from benchmark import compare, harness

    spec = harness.cell_spec(args.workload, tree)
    cells = harness.load_driver(spec["root"], spec["config"]["driver"])
    dev = torch.device("cuda", 0)
    cell = cells.Cell(spec["config"], spec["traffic"], args.seed, dev)
    t0 = time.perf_counter()
    cell.setup()
    B, sampled = cell.batch, set(cell.idx.tolist())
    print(f"{tree.name} {args.workload} seed {args.seed}: set-up "
          f"{time.perf_counter() - t0:.1f} s, {len(sampled)} of {B} "
          "scenarios sampled", flush=True)
    first = {}
    for i in range(1, args.ticks + 1):
        cell.tick()
        if i % args.every:
            continue
        bad = torch.zeros(B, dtype=torch.bool, device=dev)
        leaves = {}
        for k, v in compare.leaves(cell.state).items():
            if v.dim() and v.shape[0] == B and v.is_floating_point():
                nf = ~torch.isfinite(v.reshape(B, -1)).all(-1)
                if bool(nf.any()):
                    leaves[k] = int(nf.sum())
                    bad |= nf
        new = [s for s in torch.nonzero(bad).flatten().tolist()
               if s not in first]
        first.update({s: i for s in new})
        if new:
            print(f"  after tick {i} of the window: {len(new)} new "
                  f"non-finite {new[:10]}, sampled "
                  f"{[s for s in new if s in sampled]}; leaves {leaves}",
                  flush=True)
    print(f"  {args.ticks} ticks: {len(first)} non-finite scenarios; "
          f"{compare.final_quality(cell.state['loop'].sim)}", flush=True)


if __name__ == "__main__":
    main()
