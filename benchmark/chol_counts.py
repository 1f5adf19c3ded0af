"""The work of kernels K4 (the batched Cholesky factor, csrc/chol_factor.cu)
and K5 (the batched Cholesky solve, csrc/chol_lanes.cu) a launch, beside
`counts.py`'s peaks and its K1, K2 and K7. Like those, the counts depend
only on the shapes, so any implementation of the same mathematics reads the
same work.

K4 factors K (B, n, n): it reads K's lower triangle, writes F whole (L in
the lower triangle and its mirror above it, the layout K5 reads), and does
n^3 / 3 operations a matrix. K5 solves L L^T x = b with that F: its forward
sweep reads the mirror, its backward sweep L, so F's n^2 floats once each,
b and x; 2 n^2 operations a solve."""


def tri(n):
    """Floats of one n x n triangle, diagonal included."""
    return n * (n + 1) // 2


def k4_work(batch, n):
    """(bytes, float32 operations, float64 operations) of one K4 launch."""
    return batch * 4 * (tri(n) + n * n), batch * n ** 3 / 3, 0


def k5_work(batch, n):
    """(bytes, float32 operations, float64 operations) of one K5 launch."""
    return batch * 4 * (n * n + 2 * n), batch * 2 * n * n, 0
