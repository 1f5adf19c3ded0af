"""PyTorch/CUDA port of the legged convex-MPC framework.

The second package beside the JAX one (`legged_mpc_control_tpu`, the
reference it is tested against); it imports no JAX. Module paths mirror the
JAX package. The main path is the batched Go1 convex-MPC closed loop
(`parallel/runner.make_batched_rollout`) with the solvers "riccati", "pdip"
and "admm" and kf_type 0 (ground truth) or 1 (the linear KF), on
hand-written CUDA kernels: the Riccati interior-point MPC solve
(`ops/riccati_kernel.py`, `csrc/riccati_ipm.cu`), the fused low-level/sim
substep chain with and without the in-chain KF (`ops/substep_kernel.py`,
`csrc/substep_chain.cu`) and the batched Cholesky factor and solve of the
condensed solvers (`ops/chol_kernel.py`, `csrc/chol_factor.cu` and
`csrc/chol_lanes.cu`). The
contact-implicit MPC (`mpc/ci_mpc.py` behind the LCI seam `mpc/lci_mpc.py`,
`control/step.closed_loop_tick_lci_batched`, on ground truth, either
filter or the WBC) runs all its sweeps in one kernel on flat ground
(`ops/ci_kernel.py`, `csrc/ci_sweeps.cu`) and its gain solves on the
Cholesky kernels on a height field (`sim/terrain.py`). Every public name
of the JAX package has its counterpart here or a stated replacement
(tests/test_torch_census.py).
CUDA tensors run the kernels, CPU tensors their plain PyTorch versions.
Entry points that build state from nothing default to the card; pass
`device="cpu"` to build on the CPU. The sweep across processes
(`sweep.py` over `parallel/distributed.py`, Gloo) and the CLI
(`python -m legged_mpc_control_tpu_torch`, `main.py`, with the robot
interfaces of `interfaces/`) run on the card unless given `--cpu`.
"""

__version__ = "0.3.0"
