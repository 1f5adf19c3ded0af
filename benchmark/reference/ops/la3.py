"""Closed-form 3x3 linear algebra (`legged_mpc_control_tpu/ops/la3.py`).

Adjugate/Cramer forms of the tiny leg-Jacobian and inertia solves: a few
dozen elementwise products where a batched library LU would launch a
kernel per call. All functions take (..., 3, 3) and broadcast.
"""

import torch


def det3(A):
    """Determinant of (..., 3, 3)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def adj3(A):
    """Adjugate (transposed cofactor matrix) of (..., 3, 3)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    return torch.stack([torch.stack([c00, c01, c02], dim=-1),
                        torch.stack([c10, c11, c12], dim=-1),
                        torch.stack([c20, c21, c22], dim=-1)], dim=-2)


def inv3(A):
    """Inverse of (..., 3, 3)."""
    return adj3(A) / det3(A)[..., None, None]


def solve3(A, b):
    """Solve A x = b for b (..., 3)."""
    return (adj3(A) @ b[..., None])[..., 0] / det3(A)[..., None]


def solve3_t(A, b):
    """Solve A^T x = b for b (..., 3)."""
    return (adj3(A).transpose(-1, -2) @ b[..., None])[..., 0] \
        / det3(A)[..., None]
