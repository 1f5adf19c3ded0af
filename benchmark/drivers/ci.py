"""Driver of the contact-implicit MPC cells: the port's
`control.step.closed_loop_tick_lci_batched` on flat ground with kf_type 0:
the feedback pass, the LCI seam with `mpc.ci_mpc.make_ci_walk_policy_batched`
(its prep, one `ci_solve_batched` on kernel K7, its post) and the stand
policy, and the fused substep chain (kernel K2), as `bench.py`'s CI loop
and `chip_smoke.ci_roll` drive it.

Set-up: the batch of `parallel/runner.init_loop_batch` seeded from
`--seed`, the movement mode at walking from the first tick, the LCI state
with the walk policy's cold warm slot, the walk-in ticks. The clock `t` is
a device tensor advanced by the tick period each tick.

The check holds the first tick of set-up (the reference from a start it
builds itself from the seed) and the window's last tick (the reference
from the program's state before it) in float64 against the plain
reference, in four layers: `plan`, the walk solve's inputs (the prep and
K7); `seam`, the commanded forces, foot velocities and the desired state
with the foot targets; `sim`, the simulated state after the substeps (K2);
`fbk`, the Feedback the tick's feedback pass built and the joint targets.
`control=True` puts the reference, in float32 with TF32 matrix products,
in the program's place.
"""

from types import SimpleNamespace

import torch

from benchmark import compare, counts
from benchmark.reference import config as ref_config
from benchmark.reference.control import step as ref_step
from benchmark.reference.mpc import ci_mpc as ref_ci
from benchmark.reference.mpc import lci_mpc as ref_lci

# the settings this cell module supports; a configuration that asks for anything else is
# refused
FIXED = {"warm_start": True, "kf_type": 0, "low_level_type": 0,
         "fused_substeps": True, "terrain": "flat", "dtype": "float32"}

# the layers compared leaf by leaf; the plan (the walk solve's output, the
# warm slot `lci.policy_warm.u`) is judged by its objective (`_Replay`)
LAYERS = {
    "seam": ("loop.controller.ctrl.optimized_input",
             "loop.controller.ctrl.optimized_state"),
    "sim": tuple(f"loop.sim.{k}" for k in ("pos", "quat", "vel", "omega",
                                           "q", "dq")),
    "fbk": ("loop.controller.fbk",) + tuple(
        f"loop.controller.ctrl.{k}" for k in (
            "joint_ang_tgt", "joint_vel_tgt", "joint_tau_tgt",
            "foot_pos_target_abs", "foot_pos_target_world")),
}


def _walking(loop, mode):
    cs = loop.controller
    B, dev = cs.ctrl.movement_mode.shape[0], cs.ctrl.movement_mode.device
    return loop.replace(controller=cs.replace(ctrl=cs.ctrl.replace(
        movement_mode=torch.full((B,), mode, dtype=torch.int32,
                                 device=dev))))


def _side(cfg, trf, device, dtype, port):
    """The port (`port=True`) or the plain reference in `dtype`: the batch,
    the policies and the tick, with the same signatures."""
    if port:
        from legged_mpc_control_tpu_torch import config as cmod
        from legged_mpc_control_tpu_torch.control import step as smod
        from legged_mpc_control_tpu_torch.mpc import ci_mpc as cim
        from legged_mpc_control_tpu_torch.mpc import lci_mpc as lcim
        from legged_mpc_control_tpu_torch.parallel import runner

        def make_loop(params, batch, gen):
            return runner.init_loop_batch(
                params, batch, gen, height_range=tuple(cfg["height_range"]),
                dtype=dtype, body_height=cfg["body_height"], device=device)
    else:
        cmod, smod, cim, lcim = ref_config, ref_step, ref_ci, ref_lci

        def make_loop(params, batch, gen):
            return ref_step.init_loop_batch(
                params, batch, gen, height_range=tuple(cfg["height_range"]),
                dtype=dtype, body_height=cfg["body_height"],
                draw_dtype=torch.float32)
    params = getattr(cmod, f"{cfg['robot']}_params")(dtype, device)
    walk = cim.make_ci_walk_policy_batched(
        params, velx=trf["velx"], horizon=cfg["horizon"],
        iters=cfg["sweeps"])
    stand = lcim.make_stand_policy(params, body_height=cfg["body_height"])

    def init(batch, seed, idx=None):
        gen = torch.Generator(device=device).manual_seed(seed)
        loop = _walking(make_loop(params, batch, gen), 1)
        lci = lcim.lci_init_batched(batch, dtype,
                                    walk.warm_init(batch, dtype, device),
                                    device=device)
        state = {"loop": loop, "lci": lci}
        if idx is not None:
            state = compare.fill(state, compare.rows(
                compare.leaves(state), idx, batch))
        return state

    def tick(state, t):
        loop, lci = smod.closed_loop_tick_lci_batched(
            state["loop"], state["lci"], params, stand, walk, t)
        return {"loop": loop, "lci": lci}
    return SimpleNamespace(init=init, tick=tick, dtype=dtype)


class Cell(compare.SampledCell):
    fixed = FIXED

    def setup(self):
        B = self.batch
        f32 = torch.float32
        self.side = (compare.tf32_side(_side(self.cfg, self.trf,
                                             self.device, f32, False))
                     if self.control else
                     _side(self.cfg, self.trf, self.device, f32, True))
        self.dt = torch.tensor(self.trf["tick_s"], dtype=f32,
                               device=self.device)
        self.t = torch.zeros((), dtype=f32, device=self.device)
        state = self.side.init(B, self.seed)
        state = self.side.tick(state, self.t)
        self.first = compare.rows(compare.leaves(state), self.idx, B)
        self.t = self.t + self.dt
        for _ in range(self.trf["walk_in_ticks"] - 1):
            state = self.side.tick(state, self.t)
            self.t = self.t + self.dt
        self.state, self.prev = state, None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self):
        self.prev = (self.state, self.t)
        self.state = self.side.tick(self.state, self.t)
        self.t = self.t + self.dt

    def layers(self):
        """(owner, attribute, span label) of the tick's layers."""
        from legged_mpc_control_tpu_torch.control import step
        from legged_mpc_control_tpu_torch.mpc import ci_mpc
        from legged_mpc_control_tpu_torch.ops import ci_kernel

        return [(self, "tick", "tick"),
                (step, "feedback_update", "feedback update"),
                (ci_mpc, "_walk_prep", "CI walk prep"),
                (ci_kernel, "ci_sweeps_cuda", "K7 sweeps (wrapper)"),
                (ci_mpc, "_walk_post", "CI walk post"),
                (step, "_substep_chain", "K2 substep chain (wrapper)")]

    def kernels(self):
        B = self.batch
        return {"K7": ("ci_sweeps", counts.k7_work(B, self.cfg["horizon"],
                                                   self.cfg["sweeps"])),
                "K2": ("substep_chain_kernel", counts.k2_work(B))}

    def quality(self):
        return compare.final_quality(self.state["loop"].sim)

    def check(self):
        """[(name, value, limit)]: the program's first and last checked
        ticks against the float64 reference, by layer. Frees the program's
        state first."""
        B = self.batch
        prev_state, prev_t = self.prev
        prev = compare.rows(compare.leaves(prev_state), self.idx, B)
        cur = compare.rows(compare.leaves(self.state), self.idx, B)
        t_last = float(prev_t)
        self.state = self.prev = self.side = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        f64 = torch.float64
        ref = _side(self.cfg, self.trf, self.device, f64, False)
        ticks, gaps = [], {}
        for tag, start, t, prog in (
                ("first", ref.init(B, self.seed, self.idx), 0.0, self.first),
                ("last", None, t_last, cur)):
            if start is None:
                start = compare.fill(r_state, prev)
            replay = _Replay(prog["lci.policy_warm.u"])
            with replay.standing_in():
                r_state = ref.tick(start, torch.tensor(
                    t, dtype=f64, device=self.device))
            ticks.append((tag, prog, compare.leaves(r_state)))
            gaps[f"{tag}.plan"] = replay.gap.cpu()
        errors = compare.layer_errors(ticks, LAYERS)
        errors.update(gaps)
        # the first tick's walk solve starts cold and does not converge in
        # its sweeps: its objective depends on the rounding path, and
        # float32 and float64 read it apart by several percent; the plan is
        # judged on the window's last, warm tick
        names = (["last.plan"] + [f"{tag}.{layer}" for tag in ("first", "last")
                                  for layer in LAYERS])
        checks, self.distributions = compare.judged(
            self.cfg["limits"], {n: errors[n] for n in names})
        return checks


def plan_cost(z0, U, refs_z, refs_u, mass, inertia_w, mu, f_mask, dt, rho,
              f_scale=ref_ci.F0):
    """The CI solve's objective (`ci_mpc._traj_cost_k`, in the solver's
    scaled coordinates) of the plan U (B,H,NU) from z0 at the relaxation
    rho, and its rollout Z."""
    B = z0.shape[0]
    wts = ref_ci.default_weights(z0.dtype, z0.device)
    s_u, wvec, ref_zu = ref_ci._kernel_form(wts, refs_z, refs_u, f_scale)
    Uh = U / s_u
    Z = ref_ci._rollout_b(z0, Uh, mass, torch.linalg.inv(inertia_w), dt,
                          f_scale)
    rho = torch.full((B,), rho, dtype=z0.dtype, device=z0.device)
    return ref_ci._traj_cost_k(Z, Uh, ref_zu, refs_z[:, -1], f_mask, None,
                               wvec, mu, rho, f_scale), Z


class _Replay:
    """Stands in for the reference's `ci_solve_batched` while the reference
    follows the program through a tick. The walk solve's optimum is flat:
    float32 and float64 solves of one problem end at plans far apart whose
    objectives agree (a line-search step flips on a rounding). So the
    reference solves as it does, the program's plan is judged by its
    objective against the reference plan's (`gap`: their difference over
    the reference's, at the final relaxation), and the program's plan goes
    on to the seam and the substeps, which are compared leaf by leaf."""

    def __init__(self, plan):
        self.plan = plan
        self.gap = None

    def __call__(self, z0, U0, refs_z, refs_u, terrain, mass, inertia_w, mu,
                 wts=None, f_mask=None, *, iters, dt, rho0, rho_min=0.05,
                 **kw):
        U, _, _ = self.solve(z0, U0, refs_z, refs_u, terrain, mass,
                             inertia_w, mu, wts, f_mask, iters=iters, dt=dt,
                             rho0=rho0, rho_min=rho_min, **kw)
        mask = torch.ones_like(U[..., 0:4]) if f_mask is None else f_mask
        args = (refs_z, refs_u, mass, inertia_w, mu, mask, dt, rho_min)
        j_ref, _ = plan_cost(z0, U, *args)
        plan = self.plan.to(U.device, U.dtype)
        j_prog, Z = plan_cost(z0, plan, *args)
        self.gap = (j_prog - j_ref) / j_ref.abs()
        return plan, Z, j_prog

    def standing_in(self):
        """Context: this object is the reference's `ci_solve_batched`."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            self.solve = ref_ci.ci_solve_batched
            ref_ci.ci_solve_batched = self
            try:
                yield self
            finally:
                ref_ci.ci_solve_batched = self.solve
        return ctx()
