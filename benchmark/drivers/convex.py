"""Driver of the convex-MPC cells: the port's
`control.step.closed_loop_tick_batched` with the Riccati IPM (kernel K1)
and the fused substep chain (kernel K2), the Feedback carried from each
tick's chain to the next, as `parallel/runner.make_batched_rollout` and the
sweep run it.

Set-up: the batch as `parallel/distributed.device_sharded_loop` builds it
(one shard, seeded from `--seed`), the opening feedback pass, the stand
ticks (the joystick already at the trot's speed, as the sweep's rollout
sets it), the command switched to the trot once, the walk-in ticks. The
window ticks on; the command is held.

The check (`check`) takes a sample of scenarios drawn from the seed and
holds, in float64 against the plain reference under `benchmark/reference/`:
the first tick of set-up, which the reference runs from a start it builds
itself from the seed, and the window's last tick, which it runs from the
program's state before that tick (the closed loop is chaotic, so no
reference follows the program's trajectory over hundreds of ticks). Each
is compared in three layers: `qp`, the solution of the QP the tick built
(MPC prepare and K1); `sim`, the simulated state after the substeps (K2);
`fbk`, the Feedback unpacked from the chain's block and the joint targets.
With `control=True` the reference itself, in float32 with TF32 matrix
products (`benchmark/tf32.py`), stands where the program runs: the check's
control, which has to come out not correct.
"""

from types import SimpleNamespace

import torch

from benchmark import compare, counts
from benchmark.reference import config as ref_config
from benchmark.reference.control import step as ref_step
from benchmark.reference.mpc import gait as ref_gait

# the settings this cell module supports; a configuration that asks for anything else is
# refused
FIXED = {"solver": "riccati", "warm_start": True, "kf_type": 0,
         "low_level_type": 0, "fused_substeps": True, "carry_feedback": True,
         "terrain": "flat", "dtype": "float32"}

LAYERS = {
    "qp": ("warm",),
    "sim": tuple(f"loop.sim.{k}" for k in ("pos", "quat", "vel", "omega",
                                           "q", "dq")),
    "fbk": ("loop.controller.fbk",) + tuple(
        f"loop.controller.ctrl.{k}" for k in (
            "joint_ang_tgt", "joint_vel_tgt", "joint_tau_tgt",
            "foot_pos_target_abs", "foot_pos_target_world")),
}


def _command(loop, mode, velx):
    """The joystick's forward speed and the movement mode, every
    scenario."""
    cs = loop.controller
    B, dev = cs.joy.velx.shape[0], cs.joy.velx.device
    return loop.replace(controller=cs.replace(
        ctrl=cs.ctrl.replace(movement_mode=torch.full(
            (B,), mode, dtype=torch.int32, device=dev)),
        joy=cs.joy.replace(velx=torch.full((B,), velx,
                                           dtype=cs.joy.velx.dtype,
                                           device=dev))))


def _port(cfg, device):
    """The system under test: the port's batch, feedback pass and tick."""
    from legged_mpc_control_tpu_torch import config as port_config
    from legged_mpc_control_tpu_torch.control import step
    from legged_mpc_control_tpu_torch.mpc import gait
    from legged_mpc_control_tpu_torch.parallel import distributed
    from legged_mpc_control_tpu_torch.parallel.mesh import ScenarioMesh

    f32 = torch.float32
    params = getattr(port_config, f"{cfg['robot']}_params")(f32, device)
    pattern = gait.named_pattern(cfg["gait"], f32, device)

    def init(batch, seed):
        loop = distributed.device_sharded_loop(
            params, batch, seed, ScenarioMesh(1, 0, 1, device),
            height_range=tuple(cfg["height_range"]),
            body_height=cfg["body_height"])
        pb = step.broadcast_params(params, batch)
        return step.seed_batched_feedback(loop, pb), pb

    def tick(loop, warm, pb):
        return step.closed_loop_tick_batched(
            loop, pb, pattern, horizon=cfg["horizon"], kf_type=0,
            iters=cfg["iters"], solver="riccati", warm=warm,
            fused_substeps=True, carry_feedback=True)
    return SimpleNamespace(init=init, tick=tick, dtype=f32)


def _plain(cfg, device, dtype):
    """The plain reference in `dtype`: the same batch, feedback pass and
    tick (`benchmark/reference/control/step.py`)."""
    params = getattr(ref_config, f"{cfg['robot']}_params")(dtype, device)
    pattern = ref_gait.named_pattern(cfg["gait"], dtype, device)

    def init(batch, seed, idx=None):
        gen = torch.Generator(device=device).manual_seed(
            ref_step.shard_seed(seed, 0))
        loop = ref_step.init_loop_batch(
            params, batch, gen, height_range=tuple(cfg["height_range"]),
            dtype=dtype, body_height=cfg["body_height"],
            draw_dtype=torch.float32)
        if idx is not None:
            loop = compare.fill(loop, compare.rows(
                compare.leaves(loop), idx, batch))
        n = batch if idx is None else len(idx)
        pb = ref_step.broadcast_params(params, n)
        return ref_step.seed_batched_feedback(loop, pb), pb

    def tick(loop, warm, pb):
        return ref_step.closed_loop_tick_batched(
            loop, pb, pattern, horizon=cfg["horizon"], iters=cfg["iters"],
            warm=warm)
    return SimpleNamespace(init=init, tick=tick, dtype=dtype)


class Cell(compare.SampledCell):
    fixed = FIXED

    def setup(self):
        cfg, trf, B = self.cfg, self.trf, self.batch
        self.side = (compare.tf32_side(_plain(cfg, self.device,
                                              torch.float32))
                     if self.control else _port(cfg, self.device))
        loop, self.pb = self.side.init(B, self.seed)
        loop = _command(loop, 0, trf["velx"])
        warm = torch.zeros((B, 12 * cfg["horizon"]), dtype=self.side.dtype,
                           device=self.device)
        loop, warm = self.side.tick(loop, warm, self.pb)
        self.first = compare.rows(compare.leaves({"loop": loop,
                                                  "warm": warm}),
                                  self.idx, B)
        for _ in range(trf["stand_ticks"] - 1):
            loop, warm = self.side.tick(loop, warm, self.pb)
        loop = _command(loop, 1, trf["velx"])
        for _ in range(trf["walk_in_ticks"]):
            loop, warm = self.side.tick(loop, warm, self.pb)
        self.loop, self.warm, self.prev = loop, warm, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self):
        self.prev = (self.loop, self.warm)
        self.loop, self.warm = self.side.tick(self.loop, self.warm, self.pb)

    def layers(self):
        """(owner, attribute, span label) of the tick's layers."""
        from legged_mpc_control_tpu_torch.control import step
        from legged_mpc_control_tpu_torch.mpc import convex_mpc
        from legged_mpc_control_tpu_torch.ops import riccati_kernel

        return [(self, "tick", "tick"),
                (convex_mpc, "mpc_prepare", "MPC prepare"),
                (riccati_kernel, "solve_qp_riccati_cuda", "K1 (wrapper)"),
                (step, "_substep_chain", "K2 substep chain (wrapper)"),
                (step, "unpack_fused_feedback", "feedback unpack")]

    def kernels(self):
        B, H = self.batch, self.cfg["horizon"]
        return {"K1": ("riccati_ipm_kernel",
                       counts.k1_work(B, H, self.cfg["iters"], warm=True)),
                "K2": ("substep_chain_kernel", counts.k2_work(B))}

    def quality(self):
        """`parallel/distributed.reduce_metrics`' statistics of the
        window's final state, and the scenarios not finite."""
        return compare.final_quality(self.loop.sim)

    def check(self):
        """[(name, value, limit)]: the program's first and last checked
        ticks against the float64 reference, by layer. Frees the program's
        state first."""
        B = self.batch
        prev = compare.rows(compare.leaves(
            {"loop": self.prev[0], "warm": self.prev[1]}), self.idx, B)
        cur = compare.rows(compare.leaves({"loop": self.loop,
                                           "warm": self.warm}), self.idx, B)
        self.loop = self.warm = self.prev = self.pb = self.side = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        ref = _plain(self.cfg, self.device, torch.float64)
        S = len(self.idx)
        H = self.cfg["horizon"]
        loop, pb = ref.init(B, self.seed, self.idx)
        loop = _command(loop, 0, self.trf["velx"])
        warm = torch.zeros((S, 12 * H), dtype=torch.float64,
                           device=self.device)
        loop, warm = ref.tick(loop, warm, pb)
        r_first = compare.leaves({"loop": loop, "warm": warm})
        start = compare.fill({"loop": loop, "warm": warm}, prev)
        loop, warm = ref.tick(start["loop"], start["warm"], pb)
        r_last = compare.leaves({"loop": loop, "warm": warm})
        checks, self.distributions = compare.judged(
            self.cfg["limits"], compare.layer_errors(
                (("first", self.first, r_first), ("last", cur, r_last)),
                LAYERS))
        return checks
