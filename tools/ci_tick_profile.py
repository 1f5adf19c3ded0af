"""Where a tick of the flat contact-implicit MPC loop goes, on the card.

    python3 tools/ci_tick_profile.py [--b1]

Walks chip_smoke.py's flat CI batch in as its timed phase does (A1, B=256,
24 warm sweeps, 20 walking ticks), then runs 10 more ticks under
torch.profiler with a span around each layer of the tick (the feedback
update, the CI walk policy's prep, kernel K7's wrapper, its post, the
substep chain's wrapper). With --b1, 20 calls of chip_smoke.py's B=1 CI
walk policy (32 sweeps) instead. Prints the host-clock time a tick (or
call), each span's host time, the device time of each kernel and of the
rest, and the device's idle share of the window. Needs a CUDA device.
"""

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tools")]

import chip_smoke  # noqa: E402
from k1_tick_profile import profile  # noqa: E402
from legged_mpc_control_tpu_torch.control import step  # noqa: E402
from legged_mpc_control_tpu_torch.mpc import ci_mpc  # noqa: E402
from legged_mpc_control_tpu_torch.ops import ci_kernel  # noqa: E402

# (module, attribute, span name): the layers of a tick, each called through
# its module's attribute
LAYERS = ((step, "feedback_update", "feedback update"),
          (ci_mpc, "_walk_prep", "CI walk prep"),
          (ci_kernel, "ci_sweeps_cuda", "K7 sweeps (wrapper)"),
          (ci_mpc, "_walk_post", "CI walk post"),
          (step, "_substep_chain", "substep chain (wrapper)"))
TICKS = 10
CALLS = 20


def b1_policy(dev):
    """chip_smoke.py's B=1 CI walk policy and its call (phase_ci_latency)."""
    from legged_mpc_control_tpu_torch.config import a1_params

    f32 = torch.float32
    params = a1_params(f32, dev)
    policy = ci_mpc.make_ci_walk_policy(params, velx=chip_smoke.CI_VELX,
                                        horizon=10, iters=32)
    x = torch.zeros(40, dtype=f32, device=dev)
    x[2] = 0.3
    x[6:18] = params.default_foot_pos.reshape(-1)
    x[18] = chip_smoke.CI_VELX
    x[36:40] = 30.0
    warm = policy(x, 0.0, policy.warm_init(f32, dev))[1]

    def run():
        for k in range(CALLS):
            policy(x + 1e-4 * (k % 8), 0.01 * (k % 8), warm)
    return run, CALLS, "call"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b1", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ci_tick_profile.py: no CUDA device available")
    dev = torch.device("cuda", 0)
    if args.b1:
        run, n, unit = b1_policy(dev)
        what = "B=1 CI walk policy, H=10, 32 sweeps"
    else:
        st = chip_smoke.ci_roll(
            chip_smoke.ci_setup(dev, chip_smoke.CI_B, 24), 20)

        def run():
            chip_smoke.ci_roll(st, TICKS, t0=0.2)
        n, unit = TICKS, "tick"
        what = f"flat CI loop, B={chip_smoke.CI_B}, 24 sweeps"
    profile(run, LAYERS, n, what, unit)


if __name__ == "__main__":
    main()
