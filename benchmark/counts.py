"""The yardstick of the kernels' rooflines: one H100's published peaks and
the work of kernels K1, K2 and K7 per launch, frozen here from
`chip_smoke.py` (its peaks, `bound`, the operation counts and the floats
each kernel reads and writes). The counts depend only on the problem's
shapes and iteration counts, so any implementation of the same
mathematics reads the same work."""

# NVIDIA H100 SXM data sheet, dense, outside the tensor cores: these
# kernels do scalar float32 (and K1's float64 factor sweep from H=14) work
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12

# K1 (csrc/riccati_ipm.cu), per stage and IPM iteration: the backward
# factor sweep's eight 12x12x12 products, its 12x12 Cholesky, two LQR
# solve sweeps (four 12x12 matrix-vector products each) and the
# dual-residual rollout and adjoint (two more)
K1_FLOP_PER_STAGE_ITER = 2 * (8 * 12 ** 3 + 12 ** 3 // 6 + 2 * 4 * 12 ** 2
                              + 2 * 12 ** 2)
# of which the factor sweep's, float64 for H >= 14
K1_FACTOR_FLOP_PER_STAGE_ITER = 2 * (8 * 12 ** 3 + 12 ** 3 // 6)
K1_F64_MIN_H = 14

# K2 (csrc/substep_chain.cu): per substep and leg ~600 (Jacobian, three
# rotations, two four-branch IKs, two 3x3 solves, FK, the friction
# pyramid), per substep ~250 for the trunk; the Feedback tail ~1,500
K2_FLOP_PER_SUBSTEP = 4 * 600 + 250
K2_FLOP_TAIL = 1500
# floats a scenario K2 reads (its packed input rows and the movement mode)
# and writes (its packed output rows): ops/substep_kernel.N_IN, N_OUT
K2_IN_FLOATS = 149 + 1
K2_OUT_FLOATS = 242

# K7 (csrc/ci_sweeps.cu), per stage and sweep: three dense 24x24x24
# products, the 24x24 Cholesky, the 25-column triangular solve pair, the
# block-sparse dynamics applications (12,096) and 3x3 block products
# (2,430), ~21 elementwise 24x24 updates, the Q and value vectors (~3,900),
# the per-foot quadratization (~700); then six forward passes, each the
# feedback product (1,152), the step (~150) and the stage cost (~600)
K7_FLOP_PER_STAGE_SWEEP = (3 * 2 * 24 ** 3 + 24 ** 3 // 3
                           + 2 * 24 ** 2 * 25 + 12_096 + 2_430
                           + 21 * 24 ** 2 + 3_900 + 700
                           + 6 * (2 * 24 ** 2 + 150 + 600))
# the 54 shared floats of K7's weights and scalars
K7_SHARED_FLOATS = 54


def least_time_s(nbytes, flops, flops64=0):
    """(seconds, bound) of work moving `nbytes` and doing `flops` float32
    and `flops64` float64 operations: the larger of the bytes bound and the
    operations bound, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S + flops64 / F64_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_floats_in(H, warm=True):
    """Floats K1 reads a scenario: x0, x_ref, A_seq, B, contact, the two
    weight vectors, mu and fz_max, and the warm start."""
    return 12 + 12 * H + 144 * H + 144 + 4 * H + 24 + 2 + (12 * H if warm
                                                           else 0)


def k1_floats_out(H):
    """Floats K1 writes a scenario: u, gap, the duals."""
    return 12 * H + 1 + 24 * H


def k1_work(batch, H, iters, warm=True):
    """(bytes, float32 operations, float64 operations) of one K1 launch."""
    f64 = K1_FACTOR_FLOP_PER_STAGE_ITER if H >= K1_F64_MIN_H else 0
    n = batch * H * iters
    return (batch * 4 * (k1_floats_in(H, warm) + k1_floats_out(H)),
            n * (K1_FLOP_PER_STAGE_ITER - f64), n * f64)


def k2_work(batch, substeps=8):
    """(bytes, float32 operations, float64 operations) of one K2 launch."""
    return (batch * 4 * (K2_IN_FLOATS + K2_OUT_FLOATS),
            batch * (substeps * K2_FLOP_PER_SUBSTEP + K2_FLOP_TAIL), 0)


def k7_floats(H):
    """Floats K7 reads and writes a scenario: z0, the warm inputs, the
    references, the terminal reference, the stage masks, rho0, the world
    inverse inertia, U, Z and the cost."""
    return (24 + 24 * H + 48 * H + 24 + 4 * H + 1 + 9 + 24 * H
            + 24 * (H + 1) + 1)


def k7_work(batch, H, sweeps):
    """(bytes, float32 operations, float64 operations) of one K7 launch."""
    return (batch * k7_floats(H) * 4 + K7_SHARED_FLOATS * 4,
            batch * sweeps * H * K7_FLOP_PER_STAGE_SWEEP, 0)
