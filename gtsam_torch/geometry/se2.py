"""SE(2) stored compactly as (..., 3) = [x, y, theta] tensors.

Counterpart of gtsam_tpu/geometry/se2.py (reference gtsam/geometry/Pose2.h).
Tangent ordering is [vx, vy, omega] (translation first); retract is the
exact SE(2) exponential, applied on the right (not GTSAM's first-order
ChartAtOrigin).  logmap wraps the angle by atan2(sin, cos), into
[-pi, pi]; compose does not wrap.
All ops broadcast over leading dims.  Small-angle branches use the
double-`where` pattern, so values and forward-mode derivatives stay
NaN-free at omega == 0.
"""

import torch

_SMALL = 1e-10


def identity(dtype=torch.float64):
    return torch.zeros(3, dtype=dtype)


def theta(p):
    return p[..., 2]


def rot(p):
    """(..., 2, 2) rotation matrix of the pose."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def _small2(w2):
    """Dtype-aware small-angle threshold (see so3._small2): float32 needs
    the Taylor branch well before 1 - cos(w) cancels to zero."""
    return _SMALL if w2.dtype == torch.float64 else 1e-3


def _wrap(a):
    """Wrap an angle into [-pi, pi] by atan2(sin a, cos a)."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def expmap(xi):
    """xi = [vx, vy, w] -> pose [x, y, theta]; t = V(w) v with SE(2)'s V."""
    w = xi[..., 2]
    w2 = w * w
    small = w2 < _small2(w2)
    sw = torch.where(small, torch.ones_like(w), w)
    # A = sin w / w, B = (1 - cos w) / w
    A = torch.where(small, 1.0 - w2 / 6.0, torch.sin(sw) / sw)
    B = torch.where(small, 0.5 * w - w2 * w / 24.0, (1.0 - torch.cos(sw)) / sw)
    x = A * xi[..., 0] - B * xi[..., 1]
    y = B * xi[..., 0] + A * xi[..., 1]
    return torch.stack([x, y, w], dim=-1)


def logmap(p):
    """pose -> [vx, vy, w], w wrapped (_wrap)."""
    w = _wrap(p[..., 2])
    w2 = w * w
    small = w2 < _small2(w2)
    sw = torch.where(small, torch.ones_like(w), w)
    A = torch.where(small, 1.0 - w2 / 6.0, torch.sin(sw) / sw)
    B = torch.where(small, 0.5 * w, (1.0 - torch.cos(sw)) / sw)
    det = A * A + B * B
    # V^-1 = 1 / det [[A, B], [-B, A]]
    vx = (A * p[..., 0] + B * p[..., 1]) / det
    vy = (-B * p[..., 0] + A * p[..., 1]) / det
    return torch.stack([vx, vy, w], dim=-1)


def inverse(p):
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x, y = p[..., 0], p[..., 1]
    return torch.stack([-(c * x + s * y), -(-s * x + c * y), -p[..., 2]],
                       dim=-1)


def compose(p1, p2):
    c, s = torch.cos(p1[..., 2]), torch.sin(p1[..., 2])
    x = p1[..., 0] + c * p2[..., 0] - s * p2[..., 1]
    y = p1[..., 1] + s * p2[..., 0] + c * p2[..., 1]
    return torch.stack([x, y, p1[..., 2] + p2[..., 2]], dim=-1)


def between(p1, p2):
    """p1^-1 * p2."""
    return compose(inverse(p1), p2)


def retract(p, xi):
    return compose(p, expmap(xi))


def local(p1, p2):
    return logmap(between(p1, p2))


def transform_from(p, pt):
    """Local -> world."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = c * pt[..., 0] - s * pt[..., 1] + p[..., 0]
    y = s * pt[..., 0] + c * pt[..., 1] + p[..., 1]
    return torch.stack([x, y], dim=-1)


def transform_to(p, pt):
    """World -> local."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    dx, dy = pt[..., 0] - p[..., 0], pt[..., 1] - p[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], dim=-1)


def bearing(p, pt):
    """Bearing angle (Rot2 as an angle) from the pose to a 2D point."""
    local_pt = transform_to(p, pt)
    return torch.atan2(local_pt[..., 1], local_pt[..., 0])


def range_to(p, pt):
    return torch.linalg.norm(pt - p[..., :2], dim=-1)


# -- closed-form Jacobians (kernel 6's Pose2 variant and its plain version) --

# threshold on w^2 of right_jacobian_inverse's series (as se3._JR_SMALL)
_JR_SMALL = 5e-3


def right_jacobian_inverse(xi):
    """Jr^-1(xi) (..., 3, 3) of SE(2)'s exponential in the [vx, vy, w]
    order:  [[1 - w g, -w / 2, g vx + vy / 2],
             [w / 2, 1 - w g, g vy - vx / 2],
             [0, 0, 1]]
    with g = 1/w - cot(w/2) / 2 (w g = 1 - w sin w / (2 (1 - cos w))), by
    its series g = w (1/12 + w^2/720 + w^4/30240 + w^6/1209600) below
    w^2 = _JR_SMALL."""
    vx, vy, w = xi[..., 0], xi[..., 1], xi[..., 2]
    x = w * w
    small = x < _JR_SMALL
    sw = torch.where(small, torch.ones_like(w), w)
    series = w * (1.0 / 12 + x * (1.0 / 720 + x * (1.0 / 30240
                                                   + x * (1.0 / 1209600))))
    h = 0.5 * sw
    exact = 1.0 / sw - 0.5 * torch.cos(h) / torch.sin(h)
    g = torch.where(small, series, exact)
    a = 1.0 - w * g
    z, o = torch.zeros_like(w), torch.ones_like(w)
    return torch.stack([
        torch.stack([a, -0.5 * w, g * vx + 0.5 * vy], -1),
        torch.stack([0.5 * w, a, g * vy - 0.5 * vx], -1),
        torch.stack([z, z, o], -1)], -2)


def adjoint(p):
    """Ad(p) (..., 3, 3) in the [vx, vy, w] order: [[R, (y, -x)^T], [0, 1]]."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x, y = p[..., 0], p[..., 1]
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, y], -1),
                        torch.stack([s, c, -x], -1),
                        torch.stack([z, z, o], -1)], -2)
