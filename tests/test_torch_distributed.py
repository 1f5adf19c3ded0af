"""The port's multi-process sweep: 2 CPU processes x 4 shards over Gloo on
127.0.0.1, the library end to end (the counterpart of
tests/test_distributed.py, whose processes run the JAX package).

Each process imports torch and the port only. The replicated metrics are
equal across the ranks bit for bit and agree within 1e-12 with this
process's one-process sweep of the same global batch (A1, 16 scenarios,
float64, tests/test_distributed.py's horizon 5, 3 ticks, PDIP 8, velx 0).
Each rank's `save_sharded` / `load_sharded` round trip is exact, and
`weak_scaling_report` gives JAX's keys with finite, positive times. The
efficiency itself is asserted on the card (chip_smoke.py), not here: on a
loaded CPU it reads the machine's load."""

import json
import math
import os
import socket
import subprocess
import sys

import torch

from legged_mpc_control_tpu_torch.config import a1_params
from legged_mpc_control_tpu_torch.mpc import gait
from legged_mpc_control_tpu_torch.parallel import distributed as tdist
from legged_mpc_control_tpu_torch.parallel.mesh import ScenarioMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC, SHARDS, BATCH = 2, 4, 16
SWEEP_KW = dict(horizon=5, n_ticks=3, pdip_iters=8, walk_velx=0.0)
METRIC_TOL = 1e-12
REPORT_KEYS = {"hosts", "devices_global", "per_device_batch",
               "tick_s_local", "tick_s_global", "weak_scaling_efficiency"}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_RANK_SCRIPT = r"""
import json, os, sys
rank, nproc, port, ckpt = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
import torch
torch.set_num_threads(1)
from legged_mpc_control_tpu_torch.config import a1_params
from legged_mpc_control_tpu_torch.mpc import gait
from legged_mpc_control_tpu_torch.parallel import distributed as dist
from legged_mpc_control_tpu_torch.tree import tree_map

assert dist.initialize("tcp://127.0.0.1:" + port, nproc, rank)
mesh = dist.global_mesh(4, "cpu")
assert (mesh.world_size, mesh.rank, mesh.n_shards) == (nproc, rank,
                                                       4 * nproc)
f64, cpu = torch.float64, torch.device("cpu")
params = a1_params(f64, cpu)
pattern = gait.trot_pattern(f64, cpu)
loop = dist.device_sharded_loop(params, 16, 0, mesh, dtype=f64)
assert loop.sim.pos.shape == (16 // nproc, 3)
sweep = dist.make_sweep(pattern, mesh, horizon=5, n_ticks=3, pdip_iters=8,
                        walk_velx=0.0)
final, metrics = sweep(loop, params)
print("METRICS" + str(rank) + " " + json.dumps(metrics), flush=True)

dist.save_sharded(ckpt, final, step=3, mesh=mesh)
restored, step = dist.load_sharded(ckpt, mesh)
assert step == 3
same = []
tree_map(lambda a, b: same.append(a.dtype == b.dtype and torch.equal(a, b)),
         restored, final)
assert len(same) > 50 and all(same)
assert os.path.exists(ckpt + ".p" + str(rank))
print("CKPT" + str(rank) + " ok", flush=True)

rep = dist.weak_scaling_report(pattern, params, per_device_batch=2,
                               horizon=5, n_ticks=2, pdip_iters=4, reps=2,
                               dtype=f64, mesh=mesh)
print("EFF" + str(rank) + " " + json.dumps(rep), flush=True)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                     "legged_mpc_control_tpu")]
assert not bad, bad
torch.distributed.destroy_process_group()
print("OK" + str(rank), flush=True)
"""


def _line(out, tag):
    return json.loads(out.split(tag + " ")[1].splitlines()[0])


def test_two_process_sweep(tmp_path):
    port = str(_free_port())
    ckpt = str(tmp_path / "sweep")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(r), str(NPROC), port, ckpt],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(NPROC)]
    try:
        # the same global batch in this one process, while the two run
        f64, cpu = torch.float64, torch.device("cpu")
        params = a1_params(f64, cpu)
        mesh = ScenarioMesh(1, 0, NPROC * SHARDS, cpu)
        sweep = tdist.make_sweep(gait.trot_pattern(f64, cpu), mesh,
                                 **SWEEP_KW)
        _, want = sweep(tdist.device_sharded_loop(params, BATCH, 0, mesh,
                                                  dtype=f64), params)
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, out in enumerate(outs):
        assert f"OK{r}" in out, f"rank {r} failed:\n{out[-4000:]}"
    m = [_line(out, f"METRICS{r}") for r, out in enumerate(outs)]
    assert m[0] == m[1], m                   # replicated, bit for bit
    assert m[0].keys() == want.keys()
    for k, v in want.items():
        assert abs(m[0][k] - v) <= METRIC_TOL, (k, m[0][k], v)
    assert m[0]["upright_frac"] == 1.0 and 0.2 < m[0]["mean_height"] < 0.4
    for r, out in enumerate(outs):
        rep = _line(out, f"EFF{r}")
        assert rep.keys() == REPORT_KEYS
        assert rep["hosts"] == NPROC
        assert rep["devices_global"] == NPROC * SHARDS
        for k in ("tick_s_local", "tick_s_global",
                  "weak_scaling_efficiency"):
            assert math.isfinite(rep[k]) and rep[k] > 0, (k, rep)
    # the report's times are the slowest rank's: every rank prints them
    assert _line(outs[0], "EFF0") == _line(outs[1], "EFF1")
