"""Shared helpers of the parity tests between ``repro`` (JAX, the
reference) and ``repro_torch`` (the PyTorch/CUDA port).

Inputs are made with numpy from a seed and handed to both packages as
numpy arrays; results come back as numpy and are compared there.
"""

import numpy as np
import torch

CPU = torch.device("cpu")


def instance(seed, M=60, N=400):
    """``(facilities [M, 2], users [N, 2], rng)`` uniform in the unit square."""
    rng = np.random.default_rng(seed)
    return rng.random((M, 2)), rng.random((N, 2)), rng


def non_tie_mask(U, F, q_row, eps=1e-6):
    """Users with no competitor facility at a near-tie distance to the
    query ``F[q_row]``: a strict-< verdict at a 1-ulp boundary is arbitrary,
    so rank counts are compared exactly on the others only.

    The JAX tests' ``_non_tie_mask`` (``tests/test_kernels.py``) also scans
    the query's own row, which always ties with itself and so marks every
    user; here that row is left out, as the count excludes it.
    """
    U = np.asarray(U, np.float64)
    comp = np.delete(np.asarray(F, np.float64), q_row, axis=0)
    q = np.asarray(F, np.float64)[q_row]
    d2 = np.sum((U[:, None, :] - comp[None, :, :]) ** 2, axis=-1)
    d2q = np.sum((U - q) ** 2, axis=1)
    return ~np.any(np.abs(d2 - d2q[:, None]) < eps * (1.0 + d2q[:, None]), axis=1)


def edge_tie_mask(xs, ys, coeffs, rel=1e-6):
    """Users at a rounding-level tie of some triangle: one edge function
    within ``rel`` of its terms' magnitude from 0 while the other two edges
    hold, evaluated in float64.  XLA on the CPU contracts ``a*x + b*y``
    into a fused multiply-add and the port rounds every operation (its
    rounding contract), so at such a tie the two packages may count the
    triangle differently; the float64 oracle decides neither way."""
    x = np.asarray(xs, np.float64)[:, None, None]
    y = np.asarray(ys, np.float64)[:, None, None]
    c = np.asarray(coeffs, np.float64)[None]
    e = x * c[..., 0] + y * c[..., 1] + c[..., 2]  # [N, M, 3]
    tol = rel * (np.abs(x * c[..., 0]) + np.abs(y * c[..., 1]) + np.abs(c[..., 2]))
    near = np.abs(e) <= tol
    holds = e >= -tol
    return np.any(np.any(near, -1) & np.all(holds, -1), -1)
