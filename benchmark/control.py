"""The readings the correctness limits are set from, on the card:

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 2 [--control] [--out FILE]

runs the cell once per seed in this one process (set-up, a short window,
the check) and prints, per seed, every compared number with the
distribution of its per-scenario errors (p50, the compared quantile, p99,
max). Without `--control` the program runs: the lower readings. With
`--control` the plain reference in float32 with TF32 matrix products
(`benchmark/tf32.py`) stands in the program's place: the upper readings,
which the limits have to stay below. The benchmark's own runs never run
the control."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def readings(spec, seeds, seconds, device, clock, control):
    """[{seed, correct, numbers: {name: distribution}}] of one run a seed."""
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        result, _, _, cell = harness.measure(spec, seed, seconds, False,
                                             device, clock, t0,
                                             control=control)
        out.append({"seed": seed, "correct": result["correct"],
                    "attempted": result["attempted"],
                    "numbers": cell.distributions,
                    "seconds": time.perf_counter() - t0})
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = harness.cell_spec(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = readings(spec, seeds, args.seconds, device,
                    harness.CudaClock(torch), args.control)
    side = "control" if args.control else "program"
    for r in rows:
        print(json.dumps({"workload": args.workload, "side": side, **r}),
              flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, "side": side,
                                    **r}) + "\n")
    names = list(rows[0]["numbers"])
    print(f"{side} over seeds {seeds}: the largest and least reading of "
          "each number")
    for n in names:
        vals = [r["numbers"][n]["value"] for r in rows]
        print(f"  {n}: max {max(vals)!r}, min {min(vals)!r}")
    print(harness.power_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
