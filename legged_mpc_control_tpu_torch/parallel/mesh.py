"""The scenario mesh and its row helpers (`legged_mpc_control_tpu/parallel/
mesh.py`).

The JAX package lays the scenario axis over a mesh of devices and lets XLA
place each shard. The PyTorch idiom is one process per device: a process
holds the rows of its own shards, on its own device, and the processes
meet only in `torch.distributed` collectives (parallel/distributed.py). A
`ScenarioMesh` says which rows are this process's: the global batch is
cut into `world_size * shards_per_process` equal shards, in rank order,
and a process may hold several of them (a CPU process stands in for
several devices that way, as the JAX tests' virtual CPU devices do).
"""

from dataclasses import dataclass

import torch

from legged_mpc_control_tpu_torch.tree import tree_map


@dataclass(frozen=True)
class ScenarioMesh:
    """This process's place in the job: `rank` of `world_size` processes,
    each holding `shards_per_process` consecutive shards on `device`."""
    world_size: int = 1
    rank: int = 0
    shards_per_process: int = 1
    device: torch.device = torch.device("cpu")

    @property
    def n_shards(self) -> int:
        return self.world_size * self.shards_per_process

    def shard_ids(self) -> range:
        """Global indices of this process's shards."""
        first = self.rank * self.shards_per_process
        return range(first, first + self.shards_per_process)

    def local_rows(self, batch: int) -> slice:
        """This process's rows of a global batch of `batch`."""
        if batch % self.n_shards:
            raise ValueError(f"global batch {batch} % {self.n_shards} shards")
        n = batch // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)


def shard_scenarios(mesh: ScenarioMesh, tree):
    """This process's rows of a scenario-batched tree (every leaf's leading
    axis is the global batch), on the mesh's device."""
    def rows(x):
        return x[mesh.local_rows(x.shape[0])].to(mesh.device)
    return tree_map(rows, tree)


def replicate(mesh: ScenarioMesh, tree):
    """The whole tree on the mesh's device (e.g. RobotParams shared across
    scenarios): every process holds its own copy."""
    return tree_map(lambda x: x.to(mesh.device), tree)


def shard_mixed(mesh: ScenarioMesh, tree, batch: int):
    """This process's rows of the leaves whose leading axis is the global
    `batch`; the other leaves whole. For trees like a domain-randomized
    RobotParams where only some leaves carry the scenario axis
    (runner.randomize_params)."""
    sl = mesh.local_rows(batch)

    def put(x):
        if x.dim() >= 1 and x.shape[0] == batch:
            x = x[sl]
        return x.to(mesh.device)
    return tree_map(put, tree)
