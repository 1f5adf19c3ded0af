"""Multi-process runtime: the process group and global scenario sweeps
(`legged_mpc_control_tpu/parallel/distributed.py`).

The reference's scale-out fabric is ROS pub/sub + UDP on one machine
(SURVEY.md §2.4). The JAX package runs one SPMD program over a global
(host, chip) mesh. The port runs one process per device (or per group of
CPU shards): every process initializes only its own shards of the scenario
batch, seeded by their global position, so the global batch is the same
whatever the process count; every process runs the batched rollout on its
own rows, and the processes meet in one `torch.distributed` reduction of
the sweep's metric scalars, after which every rank reports the same
floats.

The collectives ride Gloo, not NCCL: the only traffic is a handful of
float64 scalars, which Gloo reduces on the host, and NCCL refuses two
ranks on one GPU (a one-card machine runs the two-process sweep that
way).

Deliverables covered (BASELINE.md): the 65,536-scenario sweep (config 5)
with sharded checkpoints, and the weak-scaling efficiency report (fixed
load per process, efficiency = t_local / t_global, target >= 0.85).
"""

import os
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from legged_mpc_control_tpu_torch.config import RobotParams, resolve_device
from legged_mpc_control_tpu_torch.mpc import gait as gait_mod
from legged_mpc_control_tpu_torch.parallel import runner
from legged_mpc_control_tpu_torch.parallel.mesh import (
    ScenarioMesh,
    replicate,
)
from legged_mpc_control_tpu_torch.tree import tree_map
from legged_mpc_control_tpu_torch.utils import checkpoint as ckpt

UPRIGHT_MIN_HEIGHT = 0.15


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> bool:
    """Bring up the Gloo process group; True when this call did.

    Arguments default to torchrun's variables (`tcp://MASTER_ADDR:
    MASTER_PORT`, WORLD_SIZE, RANK); a no-op when the world size is <= 1 or
    the group is already up."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if world_size <= 1 or dist.is_initialized():
        return False
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def _world():
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def global_mesh(shards_per_process: int = 1,
                device="cuda") -> ScenarioMesh:
    """This process's mesh in the job's process group. On the card, rank r
    takes device `LOCAL_RANK % device_count` (every rank the one device of
    a one-card machine)."""
    world, rank = _world()
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return ScenarioMesh(world, rank, shards_per_process, device)


def shard_seed(seed: int, gidx: int) -> int:
    """The generator seed of global shard `gidx` of a sweep seeded `seed`."""
    return int(np.random.SeedSequence([seed, gidx]).generate_state(
        1, np.uint64)[0])


def device_sharded_loop(params: RobotParams, global_batch: int,
                        seed: int = 0, mesh: Optional[ScenarioMesh] = None,
                        dtype=torch.float32, height_range=(0.26, 0.30),
                        body_height=0.28):
    """This process's rows of the global scenario LoopState: each of its
    shards drawn by its own generator, seeded from (seed, global shard
    index), and the shards concatenated in order on the mesh's device. No
    process ever builds the global batch, and the global batch is the same
    whatever the process count. `mesh` defaults to `global_mesh()`, on the
    card."""
    mesh = global_mesh() if mesh is None else mesh
    if global_batch % mesh.n_shards:
        raise ValueError(f"global_batch {global_batch} % {mesh.n_shards} "
                         "shards")
    b_loc = global_batch // mesh.n_shards
    params = replicate(mesh, params)
    shards = []
    for gidx in mesh.shard_ids():
        gen = torch.Generator(device=mesh.device).manual_seed(
            shard_seed(seed, gidx))
        shards.append(runner.init_loop_batch(
            params, b_loc, gen, height_range=height_range, dtype=dtype,
            body_height=body_height, device=mesh.device))
    if len(shards) == 1:
        return shards[0]
    return tree_map(lambda *xs: torch.cat(xs), *shards)


def reduce_metrics(final, vel, mesh: ScenarioMesh) -> dict:
    """The five sweep metrics of the global batch from this process's rows:
    local float64 sums, counts and minimum, one all_reduce of SUM and one of
    MIN across the mesh's processes, as Python floats every rank shares."""
    z = final.sim.pos[:, 2].double()
    sums = torch.stack([
        z.sum(), final.sim.pos[:, 0].double().sum(),
        vel[-1][:, 0].double().sum(),
        (z > UPRIGHT_MIN_HEIGHT).double().sum(),
        torch.tensor(float(z.shape[0]), dtype=torch.float64,
                     device=z.device)]).cpu()
    low = z.min().reshape(1).cpu()
    if mesh.world_size > 1:
        dist.all_reduce(sums, dist.ReduceOp.SUM)
        dist.all_reduce(low, dist.ReduceOp.MIN)
    s_z, s_x, s_v, n_up, n = sums.tolist()
    return {"mean_height": s_z / n, "min_height": float(low[0]),
            "mean_dx": s_x / n, "mean_speed": s_v / n,
            "upright_frac": n_up / n}


def make_sweep(pattern: gait_mod.GaitPattern,
               mesh: Optional[ScenarioMesh] = None, *, horizon=10,
               n_ticks=10, pdip_iters=15, solver="pdip", walk_velx=0.25,
               stand_ticks=20):
    """The batched rollout of this process's rows + the metrics' reduction.

    Returns sweep(loop_local, params, stand_ticks_now=None) ->
      (final local LoopState, metrics dict of floats every rank shares).
    stand_ticks_now: the stand ticks this call has left (a resumed sweep,
    or a later rep, passes what the earlier ones did not stand), None for
    the build-time `stand_ticks`."""
    mesh = global_mesh() if mesh is None else mesh
    roll = runner.make_batched_rollout(
        pattern, horizon=horizon, n_ticks=n_ticks, pdip_iters=pdip_iters,
        solver=solver, walk_velx=walk_velx, stand_ticks=stand_ticks)

    def sweep(loop, params, stand_ticks_now=None):
        final, (_, vel) = roll(loop, params, stand_ticks_now)
        return final, reduce_metrics(final, vel, mesh)

    return sweep


def save_sharded(path: str, tree, step: int = 0,
                 mesh: Optional[ScenarioMesh] = None):
    """Checkpoint this process's rows of a sharded tree to `path.p{rank}`:
    no process ever gathers the global batch (utils/checkpoint.py does the
    pickling). Resume with `load_sharded` on the same process layout."""
    rank = _world()[1] if mesh is None else mesh.rank
    ckpt.save_checkpoint(f"{path}.p{rank}", tree, step=step)


def load_sharded(path: str, mesh: ScenarioMesh, step_only: bool = False):
    """Restore this process's rows of a `save_sharded` checkpoint onto the
    mesh's device (the same process and shard layout). Returns (tree,
    step)."""
    tree, step = ckpt.load_checkpoint(f"{path}.p{mesh.rank}")
    if step_only:
        return None, step

    def put(x):
        if x.shape[0] % mesh.shards_per_process:
            raise ValueError(f"shard axis {x.shape[0]} % "
                             f"{mesh.shards_per_process}")
        return x.to(mesh.device)
    return tree_map(put, tree), step


def _barrier():
    """Align every process before and after a timed region."""
    if _world()[0] > 1:
        dist.barrier()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weak_scaling_report(pattern: gait_mod.GaitPattern,
                        params: RobotParams, *, per_device_batch=64,
                        horizon=10, n_ticks=5, pdip_iters=15,
                        solver="pdip", reps=3, dtype=torch.float32,
                        mesh: Optional[ScenarioMesh] = None):
    """Weak-scaling efficiency: per-tick wall time of (rollout + metric
    reduction) with the SAME load per shard on (a) this process's shards
    alone, no collective, and (b) the whole job's mesh, with the all_reduce
    across processes. efficiency = t_local / t_global (1.0 = perfect;
    BASELINE target >= 0.85 at >= 2 processes).

    Fairness on shared hardware: every process runs BOTH phases at the
    same time, barrier-aligned, so in the local phase all processes still
    compete for the cores and the card as they do in the global one: the
    ratio isolates what scaling adds (the collective and the processes'
    alignment), not the contention of sharing a machine. Each phase's tick
    time is the slowest rank's (a MAX reduction after the timed region), so
    every process reports the same numbers."""
    mesh = global_mesh() if mesh is None else mesh
    local_mesh = ScenarioMesh(1, 0, mesh.shards_per_process, mesh.device)
    results = {}
    for scope, m in (("local", local_mesh), ("global", mesh)):
        loop = device_sharded_loop(params, per_device_batch * m.n_shards, 0,
                                   m, dtype=dtype)
        params_d = replicate(m, params)
        sweep = make_sweep(pattern, m, horizon=horizon, n_ticks=n_ticks,
                           pdip_iters=pdip_iters, solver=solver)
        sweep(loop, params_d)                  # warm (kernel loads)
        _sync(m.device)
        _barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            sweep(loop, params_d)
        _sync(m.device)
        results[scope] = (time.perf_counter() - t0) / (reps * n_ticks)
        _barrier()
    t = torch.tensor([results["local"], results["global"]],
                     dtype=torch.float64)
    if mesh.world_size > 1:
        dist.all_reduce(t, dist.ReduceOp.MAX)
    t_local, t_global = t.tolist()
    return {
        "hosts": mesh.world_size,
        "devices_global": mesh.n_shards,
        "per_device_batch": per_device_batch,
        "tick_s_local": t_local,
        "tick_s_global": t_global,
        "weak_scaling_efficiency": t_local / t_global,
    }
