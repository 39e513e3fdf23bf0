"""Triangulation: DLT, LOST and nonlinear refinement, batched with masks.

Counterpart of gtsam_tpu/geometry/triangulation.py (reference
gtsam/geometry/triangulation.h: triangulateDLT:88, triangulateLOST:111,
triangulateNonlinear:191, triangulateSafe:421).  A track is M cameras
(an SE3 with a trailing dimension M: R (..., M, 3, 3), t (..., M, 3)), M
normalized measurements (..., M, 2) and M valid flags; any leading
dimensions batch tracks.  Nothing raises: a degenerate, behind-camera or
outlier track returns valid=False.
"""

from typing import NamedTuple

import torch

from . import se3
from .se3 import SE3


class TriangulationResult(NamedTuple):
    point: torch.Tensor   # (..., 3)
    valid: torch.Tensor   # (...,) bool


def _mask(meas, mask):
    if mask is None:
        return torch.ones(meas.shape[:-1], dtype=torch.bool,
                          device=meas.device)
    return torch.as_tensor(mask, dtype=torch.bool, device=meas.device)


def _projections(poses: SE3):
    """World -> camera projection matrices P = [R^T | -R^T t] (..., M, 3, 4)."""
    Rt = poses.R.transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", Rt, poses.t)
    return torch.cat([Rt, t[..., None]], dim=-1)


def _rows(P, meas, w):
    """The DLT rows u P[2] - P[0] and v P[2] - P[1], weighted (..., 2M, 4)."""
    u, v = meas[..., 0:1], meas[..., 1:2]
    r1 = (u * P[..., 2, :] - P[..., 0, :]) * w[..., None]
    r2 = (v * P[..., 2, :] - P[..., 1, :]) * w[..., None]
    return torch.cat([r1, r2], dim=-2)


def _null_point(A, tol):
    """The homogeneous least-squares point of A by SVD, dehomogenized; the
    last right singular vector and the singular values."""
    _, s, Vh = torch.linalg.svd(A, full_matrices=True)
    X = Vh[..., -1, :]
    w = X[..., 3]
    ws = torch.where(torch.abs(w) > tol, w, torch.ones_like(w))
    return X[..., :3] / ws[..., None], X, s


def triangulate_dlt(poses: SE3, measurements_calibrated, mask=None,
                    rank_tol=1e-9) -> TriangulationResult:
    """DLT from normalized image points: the cross-product constraints
    solved by SVD."""
    m = measurements_calibrated
    mask = _mask(m, mask)
    A = _rows(_projections(poses), m, mask.to(m.dtype))
    point, X, s = _null_point(A, rank_tol)
    ok = ((torch.abs(X[..., 3]) > rank_tol) & (s[..., -2] > rank_tol)
          & (mask.sum(-1) >= 2))
    return TriangulationResult(point, ok)


def triangulate_lost(poses: SE3, measurements_calibrated, mask=None,
                     measurement_sigma=1e-3) -> TriangulationResult:
    """LOST (Henry and Christian 2022; triangulation.h:111): the DLT rows
    weighted by the inverse of the range estimated from the DLT point."""
    m = measurements_calibrated
    init = triangulate_dlt(poses, m, mask)
    mask = _mask(m, mask)
    d = torch.linalg.norm(init.point[..., None, :] - poses.t, dim=-1)
    w = 1.0 / torch.clamp(measurement_sigma * d, min=1e-12)
    A = _rows(_projections(poses), m, w * mask.to(m.dtype))
    point, X, _ = _null_point(A, 1e-9)
    return TriangulationResult(point, init.valid
                               & (torch.abs(X[..., 3]) > 1e-9))


def _reprojection(poses, p, meas, mask):
    """Normalized reprojection residuals (..., M, 2) of point p (..., 3)
    and the camera-frame points (..., M, 3)."""
    pc = se3.transform_to(poses, p[..., None, :].expand(poses.t.shape))
    z = torch.where(pc[..., 2] > 1e-6, pc[..., 2], torch.ones_like(pc[..., 2]))
    r = (pc[..., :2] / z[..., None] - meas) * mask[..., None]
    return r, pc, z


def triangulate_nonlinear(poses: SE3, measurements_calibrated, point0,
                          mask=None, iterations=5) -> TriangulationResult:
    """Gauss-Newton refinement of the normalized reprojection error, a
    fixed number of iterations (H = J^T J + 1e-9 I)."""
    m = measurements_calibrated
    mask = _mask(m, mask)
    mk = mask.to(m.dtype)
    Rt = poses.R.transpose(-1, -2)
    p = point0
    for _ in range(iterations):
        r, pc, z = _reprojection(poses, p, m, mk)
        front = pc[..., 2] > 1e-6
        iz = 1.0 / z
        # d(x/z, y/z)/d pc, with z held at 1 where it was clamped
        zero = torch.zeros_like(iz)
        dz = torch.where(front, iz, zero)
        D = torch.stack([
            torch.stack([iz, zero, -pc[..., 0] * iz * dz], -1),
            torch.stack([zero, iz, -pc[..., 1] * iz * dz], -1)], -2)
        J = (D @ Rt) * mk[..., None, None]
        J = J.reshape(J.shape[:-3] + (-1, 3))
        rr = r.reshape(r.shape[:-2] + (-1,))
        H = J.transpose(-1, -2) @ J + 1e-9 * torch.eye(
            3, dtype=m.dtype, device=m.device)
        p = p - torch.linalg.solve(
            H, torch.einsum("...ki,...k->...i", J, rr)[..., None])[..., 0]
    pc = se3.transform_to(poses, p[..., None, :].expand(poses.t.shape))
    in_front = torch.all(torch.where(mask, pc[..., 2] > 0,
                                     torch.ones_like(mask)), dim=-1)
    return TriangulationResult(p, in_front)


def triangulate_safe(poses: SE3, measurements_calibrated, mask=None,
                     landmark_distance_threshold=1e10,
                     dyn_outlier_rejection_threshold=None
                     ) -> TriangulationResult:
    """triangulateSafe: DLT, nonlinear refinement, then the cheirality,
    degeneracy, distance and outlier masks (TriangulationParameters)."""
    m = measurements_calibrated
    init = triangulate_dlt(poses, m, mask)
    res = triangulate_nonlinear(poses, m, init.point, mask)
    mask = _mask(m, mask)
    ones = torch.ones_like(mask)
    dist = torch.linalg.norm(res.point[..., None, :] - poses.t, dim=-1)
    ok = init.valid & res.valid & torch.all(
        torch.where(mask, dist < landmark_distance_threshold, ones), dim=-1)
    if dyn_outlier_rejection_threshold is not None:
        r, _, _ = _reprojection(poses, res.point, m,
                                torch.ones_like(m[..., 0]))
        reproj = torch.linalg.norm(r, dim=-1)
        ok = ok & torch.all(torch.where(
            mask, reproj < dyn_outlier_rejection_threshold, ones), dim=-1)
    return TriangulationResult(res.point, ok)
