"""PyTorch/CUDA port of the legged convex-MPC framework.

The second package beside the JAX one (`legged_mpc_control_tpu`, the
reference it is tested against); it imports no JAX. Module paths mirror the
JAX package. The main path is the batched Go1 convex-MPC closed loop
(`parallel/runner.make_batched_rollout`), with two hand-written CUDA kernels:
the Riccati interior-point MPC solve (`ops/riccati_kernel.py`,
`csrc/riccati_ipm.cu`) and the fused low-level/sim substep chain
(`ops/substep_kernel.py`, `csrc/substep_chain.cu`). CUDA tensors run the
kernels, CPU tensors their plain PyTorch versions.
"""

__version__ = "0.1.0"
