"""The port does what the JAX package does: a census of public names.

Parses every module of `legged_mpc_control_tpu/` with `ast` (nothing is
imported, so neither package's dependencies are needed) and, for each
public top-level function, class and constant, asserts that

- the port's module at the same path under `legged_mpc_control_tpu_torch/`
  has the same name at its top level, defined or imported (`KfState` and
  `EkfState` live in the port's `types.py`, and `estimation/basic_kf.py`
  and `ekf.py` import them), or
- the name sits in NOT_PORTED, whose value names the port's replacement and
  why the name has no counterpart.

For each public function present in both packages every JAX parameter must
be a parameter of the port's function (or of the function its `**kw` goes
to, FORWARDED), or sit in RENAMED with the reason. A reverse check fails on
a map entry that no longer names anything in the JAX package, or whose
name the port now has, so the maps cannot go stale.

The TPU kernels (`ops/*_pallas.py`, the functions that reach
`pl.pallas_call`) have hand-written CUDA counterparts instead of Python
ones: KERNELS names each module's `csrc/*.cu` sources, which must exist.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "legged_mpc_control_tpu"
PORT = ROOT / "legged_mpc_control_tpu_torch"
CSRC = PORT / "csrc"

# the TPU kernels' modules -> the CUDA sources that replace them
KERNELS = {
    "ops/riccati_pallas.py": ("riccati_ipm.cu",),                 # K1
    "ops/substep_pallas.py": ("substep_chain.cu",),               # K2, K3
    "ops/chol_pallas.py": ("chol_factor.cu", "chol_lanes.cu"),    # K4-K6
    "ops/ci_pallas.py": ("ci_sweeps.cu",),                        # K7
}

_SHARDING = ("the port scales out over torch.distributed (Gloo), one "
             "process per device with `parallel/mesh.ScenarioMesh` shards "
             "(`parallel/distributed.py`); JAX's named device mesh and "
             "array shardings have no PyTorch counterpart")
# (JAX module, name) -> the port's replacement, and why
NOT_PORTED = {
    ("control/step.py", "default_backend"):
        "the tensors' device picks the path: CUDA tensors launch the "
        "kernels, CPU tensors run their plain versions (no 'pallas'/'xla' "
        "switch)",
    ("mpc/riccati.py", "STAGE_UNROLL"):
        "an XLA scan-unroll setting of the JAX stagewise solve; kernel K1 "
        "(csrc/riccati_ipm.cu) and its plain version replace that solve",
    ("parallel/mesh.py", "BATCH_AXIS"): _SHARDING,
    ("parallel/mesh.py", "scenario_mesh"): _SHARDING,
    ("parallel/mesh.py", "batch_sharding"): _SHARDING,
    ("parallel/distributed.py", "HOST_AXIS"): _SHARDING,
    ("parallel/distributed.py", "CHIP_AXIS"): _SHARDING,
    ("parallel/distributed.py", "BATCH_SPEC"): _SHARDING,
    ("parallel/distributed.py", "batch_sharding"): _SHARDING,
    ("parallel/distributed.py", "replicate_global"):
        _SHARDING + "; every process holds its own rows, and the metrics "
        "meet in an all_reduce",
}

_KEY = "a torch.Generator (`generator`) replaces the JAX PRNG key"
_BACKEND = ("the tensors' device picks the path: CUDA tensors launch the "
            "kernels, CPU tensors run their plain versions")
_LEG = ("the port's gait FSM updates every leg at once, batch-first (B, 4), "
        "instead of one leg under vmap")
_HEIGHT = "`heights`, one standing height per scenario (B,)"
_GROUND_TRUTH = ("`kf_type` (0 ground truth, 1 the KF, 2 the EKF); "
                 "`use_ground_truth` was JAX's legacy alias of kf_type 0/1")
_DTYPE = "the dtype (and device) follow the sensor tensors passed in"
_DIST = ("torch.distributed's names: `init_method` (tcp://host:port), "
         "`world_size`, `rank` for JAX's coordinator, num_processes, "
         "process_id")
# (JAX module, function, parameter) -> the port's parameter, and why
RENAMED = {
    ("parallel/runner.py", "randomize_params", "key"): _KEY,
    ("parallel/runner.py", "init_loop_batch", "key"): _KEY,
    ("parallel/runner.py", "init_wb_loop_batch", "key"): _KEY,
    ("parallel/distributed.py", "device_sharded_loop", "key"):
        "a seed: each shard draws from `shard_seed(seed, shard)` on its "
        "own generator",
    ("sim/terrain.py", "random_rough", "key"): _KEY,
    ("mpc/admm.py", "solve_qp_admm_batched", "backend"): _BACKEND,
    ("mpc/pdip.py", "solve_qp_pdip_batched", "backend"): _BACKEND,
    ("mpc/convex_mpc.py", "mpc_tick_batched", "backend"): _BACKEND,
    ("mpc/riccati.py", "solve_qp_riccati", "backend"): _BACKEND,
    ("mpc/riccati.py", "solve_qp_riccati", "interpret"):
        "Pallas interpret mode; the plain version of K1 runs on CPU "
        "tensors instead",
    ("parallel/distributed.py", "make_sweep", "backend"): _BACKEND,
    ("parallel/distributed.py", "weak_scaling_report", "backend"): _BACKEND,
    ("parallel/runner.py", "make_batched_rollout", "backend"): _BACKEND,
    ("parallel/runner.py", "make_batched_rollout_wb", "backend"): _BACKEND,
    ("sim/wb_sim.py", "wb_sim_step_batched", "backend"): _BACKEND,
    ("control/step.py", "closed_loop_tick_batched", "backend"): _BACKEND,
    ("control/step.py", "closed_loop_tick_wb_batched", "backend"): _BACKEND,
    ("mpc/gait.py", "gait_leg_init", "leg"): _LEG,
    ("mpc/gait.py", "gait_leg_reset", "leg"): _LEG,
    ("mpc/gait.py", "gait_leg_update", "leg"): _LEG,
    ("mpc/gait.py", "predict_contact_state", "leg"): _LEG,
    ("sim/srb_sim.py", "sim_init", "height"): _HEIGHT,
    ("sim/wb_sim.py", "wb_sim_init", "height"): _HEIGHT,
    ("parallel/runner.py", "make_batched_rollout", "use_ground_truth"):
        _GROUND_TRUTH,
    ("control/step.py", "feedback_update", "use_ground_truth"):
        _GROUND_TRUTH,
    ("control/step.py", "closed_loop_tick", "use_ground_truth"):
        _GROUND_TRUTH,
    ("estimation/basic_kf.py", "kf_init", "dtype"): _DTYPE,
    ("estimation/ekf.py", "ekf_init", "dtype"): _DTYPE,
    ("mpc/qp_builder.py", "build_condensed_qp", "B"):
        "`Bm`, the input matrix (B names the batch size in the port)",
    ("parallel/distributed.py", "initialize", "coordinator"): _DIST,
    ("parallel/distributed.py", "initialize", "num_processes"): _DIST,
    ("parallel/distributed.py", "initialize", "process_id"): _DIST,
}

# (module, function) whose `**kw` in the port goes to another function of
# the same module, which must take the JAX parameters
FORWARDED = {("mpc/ci_mpc.py", "ci_solve"): "ci_solve_batched"}

# names the port once lacked; no map may excuse them
MUST_BE_PORTED = {
    "control/step.py": ("closed_loop_tick_lci_batched",
                        "seed_batched_feedback"),
    "sim/srb_sim.py": ("sim_step",),
    "ops/filters.py": ("savgol_coeffs", "SavgolState", "savgol_init",
                       "savgol_update", "moving_window_init"),
    "ops/bezier.py": ("swing_foot_pos_vel",),
    "models/kinematics.py": ("_calf_rot", "fk_cal", "jac_cal", "dfk_drho",
                             "dJ_dq", "dJ_drho"),
    "models/srb.py": ("gravity_affine", "srb_continuous_dynamics"),
    "models/whole_body.py": ("N_Q", "N_JOINTS"),
    "mpc/qp_builder.py": ("reference_sparse_qp",),
    "mpc/lci_mpc.py": ("X_DIM", "OUT_DIM", "PolicyFn"),
}


def _top_level(path, imports=True):
    """name -> ast node of every top-level definition and assignment of the
    module at `path`, and with `imports` every `from ... import` (descending
    into top-level if/try blocks)."""
    names = {}

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                names[node.name] = node
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:
                    for leaf in ast.walk(tgt):
                        if isinstance(leaf, ast.Name):
                            names[leaf.id] = node
            elif (isinstance(node, ast.AnnAssign)
                  and isinstance(node.target, ast.Name)):
                names[node.target.id] = node
            elif imports and isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    names[alias.asname or alias.name] = node
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for handler in getattr(node, "handlers", ()):
                    visit(handler.body)
    visit(ast.parse(path.read_text()).body)
    return names


def _params(fn):
    """The named parameters of a function node, and whether it takes
    **kwargs."""
    a = fn.args
    named = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return named, a.kwarg is not None


def _is_function(node):
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


def _modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                  if not (p.parent.name == "ops"
                          and p.name.endswith("_pallas.py")))


MODULES = _modules()


def _jax_names(rel):
    """The JAX module's public names: what it defines, not what it
    imports."""
    return {k: v for k, v in _top_level(JAX / rel, imports=False).items()
            if not k.startswith("_")}


@pytest.mark.parametrize("rel", MODULES)
def test_module_census(rel):
    port_path = PORT / rel
    assert port_path.exists(), f"the port has no {rel}"
    port = _top_level(port_path)
    missing, kw_missing = [], []
    for name, node in _jax_names(rel).items():
        if (rel, name) in NOT_PORTED:
            continue
        if name not in port:
            missing.append(name)
            continue
        if not (_is_function(node) and _is_function(port[name])):
            continue
        got, takes_kw = _params(port[name])
        if takes_kw and (rel, name) in FORWARDED:
            got = got + _params(port[FORWARDED[rel, name]])[0]
        for p in _params(node)[0]:
            if p not in got and (rel, name, p) not in RENAMED:
                kw_missing.append(f"{name}({p}=)")
    assert not missing, f"{rel}: the port lacks {missing}"
    assert not kw_missing, f"{rel}: the port's functions lack {kw_missing}"


def test_the_kernels_have_cuda_sources():
    """Every `ops/*_pallas.py` reaches `pl.pallas_call` and has its CUDA
    sources in the port's csrc/."""
    pallas = sorted(str(p.relative_to(JAX))
                    for p in (JAX / "ops").glob("*_pallas.py"))
    assert pallas == sorted(KERNELS)
    for rel, sources in KERNELS.items():
        assert "pallas_call" in (JAX / rel).read_text(), rel
        for src in sources:
            assert (CSRC / src).exists(), f"{rel}: csrc/{src} is missing"


def test_the_maps_are_current():
    """Each entry still names a JAX module, name and parameter, names
    something the port lacks at that path, and gives a reason."""
    for (rel, name), why in NOT_PORTED.items():
        assert name in _jax_names(rel), (rel, name)
        assert name not in _top_level(PORT / rel), (rel, name)
        assert len(why) > 40, (rel, name)
    for (rel, name, p), why in RENAMED.items():
        jfn = _jax_names(rel)[name]
        assert p in _params(jfn)[0], (rel, name, p)
        got, _ = _params(_top_level(PORT / rel)[name])
        assert p not in got, (rel, name, p)
        assert len(why) > 20, (rel, name, p)
    for (rel, name), target in FORWARDED.items():
        port = _top_level(PORT / rel)
        assert _params(port[name])[1] and _is_function(port[target]), (
            rel, name, target)


def test_no_map_excuses_a_required_name():
    for rel, names in MUST_BE_PORTED.items():
        port = _top_level(PORT / rel)
        for name in names:
            assert (rel, name) not in NOT_PORTED
            assert not any(k[:2] == (rel, name) for k in RENAMED), name
            assert name in port, f"{rel}:{name}"
            jfn, pfn = _top_level(JAX / rel, False)[name], port[name]
            if _is_function(jfn):
                assert set(_params(jfn)[0]) <= set(_params(pfn)[0]), name
