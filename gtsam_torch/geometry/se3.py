"""SE(3) as an (R, t) pair of tensors.

Counterpart of gtsam_tpu/geometry/se3.py.  Tangent ordering is [omega; v]
(rotation first); retract is the true SE(3) exponential, applied on the
right.  All ops broadcast over leading dims.
"""

from typing import NamedTuple

import torch

from . import so3


class SE3(NamedTuple):
    """Rigid transform: x_world = R @ x_local + t.  R:(...,3,3), t:(...,3)."""

    R: torch.Tensor
    t: torch.Tensor


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def expmap(xi):
    """xi = [omega; v] (...,6) -> SE3 with t = V(omega) @ v."""
    w, v = xi[..., :3], xi[..., 3:]
    return SE3(so3.expmap(w), _mv(so3.left_jacobian(w), v))


def logmap(T):
    """SE3 -> (...,6) [omega; v]."""
    w = so3.logmap(T.R)
    return torch.cat([w, _mv(so3.left_jacobian_inverse(w), T.t)], dim=-1)


def inverse(T):
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -_mv(Rt, T.t))


def compose(T1, T2):
    return SE3(T1.R @ T2.R, _mv(T1.R, T2.t) + T1.t)


def between(T1, T2):
    """T1^-1 * T2."""
    return compose(inverse(T1), T2)


def transform_to(T, p):
    """World -> local: R^T (p - t)."""
    return torch.einsum("...ji,...j->...i", T.R, p - T.t)


def retract(T, xi):
    """Right retraction: T * Exp(xi)."""
    return compose(T, expmap(xi))


def local(T1, T2):
    """Log(T1^-1 T2)."""
    return logmap(between(T1, T2))
