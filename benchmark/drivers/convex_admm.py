"""Driver of the condensed convex-MPC cells: the port's
`control.step.closed_loop_tick_batched` with solver "admm", the upstream
controller's own QP solver (OSQP, an ADMM splitting, warm-started:
ConvexQPSolver.cpp:182-185) at a fixed iteration count. A tick condenses
the QP (a batched float32 matrix product), factors its constant ADMM
matrix once (kernel K4) and solves with it once an iteration (kernel K5),
then runs the fused substep chain (kernel K2); the Feedback and the ADMM
warm tuple (x, z, y) are carried from tick to tick.

Set-up and window as `convex.py`'s: the batch from the seed, the opening
feedback pass, the stand ticks (the joystick already at the trot's speed),
the command switched to the trot once, the walk-in ticks; the window
ticks on with the command held. The first tick starts the solver cold
(a zero warm tuple).

The check, as `convex.py`'s, holds a sample of scenarios in float64
against the plain reference (`benchmark/reference/control/
condensed_step.py`) at set-up's first tick, from the reference's own
start, and at the window's last, from the program's state before it (the
loop, the warm tuple). Layers: `qp`, the ADMM solution over the horizon
(B, 12H) in N, which the program's tick hands to its GRF and keeps no
copy of, so each program tick keeps it aside (one Python call, no device
work); `sim` and `fbk`, as `convex.py`'s. With `control=True` the
reference in float32 with TF32 matrix products stands in the program's
place.

The window has to run past the trot's first ~40 ticks (~5 s on the card):
every scenario's gait phase advances in float32 by the same step, on
whose multiples the trot's switches sit, so until its roundings have
carried it off that grid the contact predicted for some horizon step is
a tie that float32 and float64 may break apart, moving every scenario's
solution at once by up to a leg's load (CPU, float32 against float64,
B=64: 28-117 N at 16 of the first 35 window ends, none of the 265 after
them at B=8)."""

from types import SimpleNamespace

import torch

from benchmark import chol_counts, compare, counts
from benchmark.drivers import convex
from benchmark.reference.control import condensed_step as ref_condensed
from benchmark.reference.mpc import gait as ref_gait

# the settings this cell module supports; a configuration that asks for
# anything else is refused
FIXED = {"solver": "admm", "warm_start": True, "kf_type": 0,
         "low_level_type": 0, "fused_substeps": True, "carry_feedback": True,
         "terrain": "flat", "dtype": "float32"}

LAYERS = {"qp": ("u",), "sim": convex.LAYERS["sim"],
          "fbk": convex.LAYERS["fbk"]}


def _cold(batch, horizon, dtype, device):
    """The zero ADMM warm tuple (x, z, y): a cold start."""
    z = torch.zeros((batch, horizon, 4, 6), dtype=dtype, device=device)
    return (torch.zeros((batch, 12 * horizon), dtype=dtype, device=device),
            z, z.clone())


def _tree(warm):
    return {"x": warm[0], "z": warm[1], "y": warm[2]}


def _port(cfg, device):
    """The system under test: the port's batch and feedback pass
    (`convex._port`), and its tick with the ADMM solver, which also
    returns the solve's (B, 12H) solution."""
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import admm, gait

    pattern = gait.named_pattern(cfg["gait"], torch.float32, device)

    def tick(loop, warm, pb):
        solve = admm.solve_qp_admm_batched
        kept = {}

        def keep(*args, **kwargs):
            res = solve(*args, **kwargs)
            kept["u"] = res.u
            return res
        admm.solve_qp_admm_batched = keep
        try:
            loop, warm = step.closed_loop_tick_batched(
                loop, pb, pattern, horizon=cfg["horizon"], kf_type=0,
                iters=cfg["iters"], solver="admm", warm=warm,
                fused_substeps=True, carry_feedback=True,
                admm_rho=cfg["rho"])
        finally:
            admm.solve_qp_admm_batched = solve
        if "u" not in kept:                 # a tick that solved nothing
            kept["u"] = torch.full_like(warm[0], float("nan"))
        return loop, warm, kept["u"]
    return SimpleNamespace(init=convex._port(cfg, device).init, tick=tick,
                           dtype=torch.float32)


def _plain(cfg, device, dtype):
    """The plain reference in `dtype`: the same batch and feedback pass
    (`convex._plain`), and the reference's ADMM tick."""
    pattern = ref_gait.named_pattern(cfg["gait"], dtype, device)

    def tick(loop, warm, pb):
        loop, res = ref_condensed.closed_loop_tick_admm_batched(
            loop, pb, pattern, horizon=cfg["horizon"], iters=cfg["iters"],
            rho=cfg["rho"], warm=warm)
        return loop, res.warm, res.u
    return SimpleNamespace(init=convex._plain(cfg, device, dtype).init,
                           tick=tick, dtype=dtype)


class Cell(compare.SampledCell):
    fixed = FIXED

    def setup(self):
        cfg, trf, B, H = self.cfg, self.trf, self.batch, self.cfg["horizon"]
        self.side = (compare.tf32_side(_plain(cfg, self.device,
                                              torch.float32))
                     if self.control else _port(cfg, self.device))
        loop, self.pb = self.side.init(B, self.seed)
        loop = convex._command(loop, 0, trf["velx"])
        warm = _cold(B, H, self.side.dtype, self.device)
        loop, warm, u = self.side.tick(loop, warm, self.pb)
        self.first = compare.rows(compare.leaves({"loop": loop, "u": u}),
                                  self.idx, B)
        for _ in range(trf["stand_ticks"] - 1):
            loop, warm, _ = self.side.tick(loop, warm, self.pb)
        loop = convex._command(loop, 1, trf["velx"])
        for _ in range(trf["walk_in_ticks"]):
            loop, warm, _ = self.side.tick(loop, warm, self.pb)
        self.loop, self.warm, self.u, self.prev = loop, warm, u, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self):
        self.prev = (self.loop, self.warm)
        self.loop, self.warm, self.u = self.side.tick(self.loop, self.warm,
                                                      self.pb)

    def layers(self):
        """(owner, attribute, span label) of the tick's layers."""
        from legged_mpc_control_tpu_torch.control import step
        from legged_mpc_control_tpu_torch.mpc import convex_mpc

        return [(self, "tick", "tick"),
                (convex_mpc, "mpc_prepare", "MPC prepare"),
                (convex_mpc, "build_condensed_from_stage", "condensed build"),
                (step, "_substep_chain", "K2 substep chain (wrapper)"),
                (step, "unpack_fused_feedback", "feedback unpack")]

    def kernels(self):
        B, n = self.batch, 12 * self.cfg["horizon"]
        return {"K2": ("substep_chain_kernel", counts.k2_work(B)),
                "K4": ("chol_factor", chol_counts.k4_work(B, n)),
                "K5": ("chol_solve", chol_counts.k5_work(B, n))}

    def quality(self):
        """`parallel/distributed.reduce_metrics`' statistics of the
        window's final state, and the scenarios not finite."""
        return compare.final_quality(self.loop.sim)

    def check(self):
        """[(name, value, limit)]: the program's first and last checked
        ticks against the float64 reference, by layer. Frees the program's
        state first."""
        B, H = self.batch, self.cfg["horizon"]
        prev = compare.rows(compare.leaves(
            {"loop": self.prev[0], "warm": _tree(self.prev[1])}), self.idx,
            B)
        cur = compare.rows(compare.leaves({"loop": self.loop, "u": self.u}),
                           self.idx, B)
        self.loop = self.warm = self.u = self.prev = self.pb = None
        self.side = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        ref = _plain(self.cfg, self.device, torch.float64)
        loop, pb = ref.init(B, self.seed, self.idx)
        loop = convex._command(loop, 0, self.trf["velx"])
        loop, warm, u = ref.tick(
            loop, _cold(len(self.idx), H, torch.float64, self.device), pb)
        r_first = compare.leaves({"loop": loop, "u": u})
        start = compare.fill({"loop": loop, "warm": _tree(warm)}, prev)
        w = start["warm"]
        loop, _, u = ref.tick(start["loop"], (w["x"], w["z"], w["y"]), pb)
        r_last = compare.leaves({"loop": loop, "u": u})
        checks, self.distributions = compare.judged(
            self.cfg["limits"], compare.layer_errors(
                (("first", self.first, r_first), ("last", cur, r_last)),
                LAYERS))
        return checks
