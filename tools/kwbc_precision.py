"""The WBC's hierarchy in float32 and in float64, in the port and in the JAX
package (CPU).

    python3 tools/kwbc_precision.py [--no-jax]

Solves tests/test_wbc.py's standing case (A1 at 0.3 m, all four feet down,
the MPC asking mg/4 of each foot) with `wbc_update` in both dtypes and
prints the feet's normal forces and the largest |tau| and |q_dd|. The
hierarchy's null-space threshold is 1e-8 of the largest singular value
(`control/hoqp.soft_nullspace`), below float32's rounding; the port's
controller adapter (`wbc_from_controller`) solves in float64 whatever the
state's dtype for that reason.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TOTAL_MASS = 6.0 + 4 * (0.595 + 0.888 + 0.151 + 0.06)


def standing():
    q = np.zeros(18)
    q[2] = 0.3
    q[6:18] = np.tile([0.0, 0.8, -1.6], 4)
    grf = np.tile([0.0, 0.0, TOTAL_MASS * 9.81 / 4], (4, 1))
    return q, grf


def report(name, tau, F, qdd):
    F = np.asarray(F, np.float64).reshape(4, 3)
    print(f"{name}: feet fz {np.round(F[:, 2], 3).tolist()} N (asked "
          f"{TOTAL_MASS * 9.81 / 4:.3f}); max |tau| "
          f"{np.abs(np.asarray(tau)).max():.4f} N m; max |q_dd| "
          f"{np.abs(np.asarray(qdd)).max():.4e}", flush=True)


def port(dtype):
    from legged_mpc_control_tpu_torch.control import wbc
    from legged_mpc_control_tpu_torch.models import whole_body as wb
    from legged_mpc_control_tpu_torch.models import whole_body_b as wbb

    model = wb.a1_wb_model(dtype, "cpu")
    q, grf = standing()
    q = torch.tensor(q, dtype=dtype)[None]
    v = torch.zeros_like(q)
    feet = wbb.foot_positions_b(q, model)
    tau, qdd, F = wbc.wbc_update(
        q, v, torch.ones((1, 4), dtype=dtype),
        torch.tensor(grf, dtype=dtype)[None], q[:, 0:3], q[:, 3:6], feet,
        torch.zeros((1, 4, 3), dtype=dtype), model, ip_iters=14)
    report(f"port, wbc_update, {dtype}", tau[0], F[0], qdd[0])


def jax_package(dtype_name):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from legged_mpc_control_tpu.control import wbc
    from legged_mpc_control_tpu.models import whole_body as wb

    dt = {"float32": jnp.float32, "float64": jnp.float64}[dtype_name]
    model = wb.a1_wb_model()
    q, grf = standing()
    q, grf = jnp.asarray(q, dt), jnp.asarray(grf, dt)
    feet = wb.foot_positions(q, model)
    tau, qdd, F = jax.jit(lambda qq: wbc.wbc_update(
        qq, jnp.zeros(18, dt), jnp.ones(4, dt), grf, qq[0:3], qq[3:6], feet,
        jnp.zeros((4, 3), dt), model, ip_iters=14))(q)
    report(f"JAX package, wbc_update, {dtype_name}", tau, F, qdd)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--no-jax", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    for dtype in (torch.float64, torch.float32):
        port(dtype)
    if not args.no_jax:
        for name in ("float64", "float32"):
            jax_package(name)


if __name__ == "__main__":
    main()
