"""The frozen operation and byte counts of K1, K2 and K7 against
chip_smoke.py's, at known shapes."""

import chip_smoke
import pytest

from benchmark import counts


def test_peaks_and_counts_are_chip_smokes():
    assert counts.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert counts.F32_FLOP_PER_S == chip_smoke.F32_FLOP_PER_S
    assert counts.F64_FLOP_PER_S == chip_smoke.F64_FLOP_PER_S
    for name in ("K1_FLOP_PER_STAGE_ITER", "K1_FACTOR_FLOP_PER_STAGE_ITER",
                 "K1_F64_MIN_H", "K2_FLOP_PER_SUBSTEP", "K2_FLOP_TAIL",
                 "K7_FLOP_PER_STAGE_SWEEP"):
        assert getattr(counts, name) == getattr(chip_smoke, name), name


def test_k2_row_counts_are_the_kernels():
    from legged_mpc_control_tpu_torch.ops import substep_kernel

    assert counts.K2_IN_FLOATS == substep_kernel.N_IN + 1
    assert counts.K2_OUT_FLOATS == substep_kernel.N_OUT


@pytest.mark.parametrize("H", [10, 30])
def test_k1_cold_matches_chip_smoke(H):
    B, iters = 4096, 15
    f64 = (chip_smoke.K1_FACTOR_FLOP_PER_STAGE_ITER
           if H >= chip_smoke.K1_F64_MIN_H else 0)
    want = chip_smoke.bound(
        B * 4 * (chip_smoke.NX_IN_K1(H) + chip_smoke.NX_OUT_K1(H)),
        B * H * iters * (chip_smoke.K1_FLOP_PER_STAGE_ITER - f64),
        B * H * iters * f64)
    got = counts.least_time_s(*counts.k1_work(B, H, iters, warm=False))
    assert got[1] == want[1]
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)


def test_k1_config5_warm():
    # chip_smoke's config-5 phase: 4.56 ms, bound by the operations
    B, H, iters = 65536, 10, 15
    want = chip_smoke.bound(
        B * 4 * (chip_smoke.NX_IN_K1(H) + chip_smoke.NX_OUT_K1(H) + 12 * H),
        B * H * iters * chip_smoke.K1_FLOP_PER_STAGE_ITER)
    got = counts.least_time_s(*counts.k1_work(B, H, iters, warm=True))
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)
    assert got[1] == "operations" and got[0] == pytest.approx(4.5637e-3,
                                                              rel=1e-4)


@pytest.mark.parametrize("B,ms", [(4096, 0.0019), (256, 1.20e-4),
                                  (65536, 0.0307)])
def test_k2_bytes_bound(B, ms):
    want = chip_smoke.bound(
        B * 4 * (counts.K2_IN_FLOATS + counts.K2_OUT_FLOATS),
        B * (8 * chip_smoke.K2_FLOP_PER_SUBSTEP + chip_smoke.K2_FLOP_TAIL))
    got = counts.least_time_s(*counts.k2_work(B))
    assert got[1] == want[1] == "bytes"
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)
    assert got[0] * 1e3 == pytest.approx(ms, rel=0.03)


@pytest.mark.parametrize("B,sweeps,ms", [(256, 24, 0.146), (1, 32, 7.59e-4),
                                         (4096, 24, 2.333)])
def test_k7_operations_bound(B, sweeps, ms):
    H = 10
    floats = (24 + 24 * H + 48 * H + 24 + 4 * H + 1 + 9 + 24 * H
              + 24 * (H + 1) + 1)
    want = chip_smoke.bound(B * floats * 4 + 54 * 4,
                            B * sweeps * H * chip_smoke.K7_FLOP_PER_STAGE_SWEEP)
    got = counts.least_time_s(*counts.k7_work(B, H, sweeps))
    assert got[1] == want[1] == "operations"
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)
    assert got[0] * 1e3 == pytest.approx(ms, rel=0.01)
