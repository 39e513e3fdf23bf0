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


def identity(dtype=torch.float64):
    return SE3(torch.eye(3, dtype=dtype), torch.zeros(3, dtype=dtype))


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


def transform_from(T, p):
    """Local -> world: R p + t."""
    return _mv(T.R, p) + T.t


def adjoint(T):
    """Ad_T (6x6) in [omega; v] ordering: [[R, 0], [hat(t) R, R]]
    (reference Pose3.h:148 AdjointMap)."""
    R = T.R
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([so3.hat(T.t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


# theta^2 below which the coefficients of right_jacobian_inverse take their
# Taylor series (four terms: truncation < 1e-17 there; the closed forms lose
# ~eps/theta^4 to cancellation, 2e-10 relative at this threshold)
_JR_SMALL = 5e-3


def jr_inv_coeffs(theta2):
    """(a1, a2, a3, E) of right_jacobian_inverse for theta^2 = |omega|^2:
    a1 = (t - sin t)/t^3, a2 = (t^2 + 2 cos t - 2)/(2 t^4),
    a3 = (2t - 3 sin t + t cos t)/(2 t^5) (Barfoot's Q coefficients) and
    E = 1/t^2 - cos(t/2) / (2 t sin(t/2)) (the W^2 coefficient of the SO(3)
    Jr^-1, finite at t = pi)."""
    small = theta2 < _JR_SMALL
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    s, c = torch.sin(t), torch.cos(t)
    x = theta2
    a1 = torch.where(small, 1 / 6 - x / 120 + x * x / 5040
                     - x * x * x / 362880, (t - s) / (t2 * t))
    a2 = torch.where(small, 1 / 24 - x / 720 + x * x / 40320
                     - x * x * x / 3628800, (t2 + 2 * c - 2) / (2 * t2 * t2))
    a3 = torch.where(small, 1 / 120 - x / 2520 + x * x / 120960
                     - x * x * x / 9979200,
                     (2 * t - 3 * s + t * c) / (2 * t2 * t2 * t))
    E = torch.where(small, 1 / 12 + x / 720 + x * x / 30240
                    + x * x * x / 1209600,
                    1 / t2 - torch.cos(0.5 * t) / (2 * t * torch.sin(0.5 * t)))
    return a1, a2, a3, E


def right_jacobian_inverse(xi):
    """Jr^-1 of SE(3) at xi = [omega; v] (...,6) -> (...,6,6):
    [[Jw, 0], [-Jw Q Jw, Jw]] with Jw = I + W/2 + E W^2 the SO(3) Jr^-1 and
    Q(omega, v) the right-Jacobian coupling block (reference Pose3.cpp
    LogmapDerivative, computeQforExpmapDerivative).  d Log(T Exp(d)) / d d
    at d = 0 is right_jacobian_inverse(Log(T))."""
    w, v = xi[..., :3], xi[..., 3:]
    a1, a2, a3, E = (c[..., None, None]
                     for c in jr_inv_coeffs(torch.sum(w * w, dim=-1)))
    W, V = so3.hat(w), so3.hat(v)
    WW, WV, VW = W @ W, W @ V, V @ W
    WVW = WV @ W
    Q = (-0.5 * V + a1 * (WV + VW - WVW) - a2 * (W @ WV + VW @ W - 3 * WVW)
         + a3 * (WVW @ W + W @ WVW))
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    Jw = eye + 0.5 * W + E * WW
    top = torch.cat([Jw, torch.zeros_like(Jw)], dim=-1)
    bot = torch.cat([-(Jw @ Q @ Jw), Jw], dim=-1)
    return torch.cat([top, bot], dim=-2)


def retract(T, xi):
    """Right retraction: T * Exp(xi)."""
    return compose(T, expmap(xi))


def local(T1, T2):
    """Log(T1^-1 T2)."""
    return logmap(between(T1, T2))


def stack(transforms):
    """One batched SE3 of a list of SE3."""
    return SE3(torch.stack([T.R for T in transforms]),
               torch.stack([T.t for T in transforms]))
