"""Cameras and calibrations, batched.

Counterpart of gtsam_tpu/geometry/cameras.py (reference
gtsam/geometry/Cal3_S2.h, Cal3Bundler.h, PinholeCamera.h,
SphericalCamera.h, StereoCamera.h).  Pose is camera-to-world; p_cam =
pose^-1 * p_world; pinhole (x/z, y/z); then the calibration.  Points at
z <= CHEIRALITY_EPS are flagged invalid instead of raising.
"""

from typing import NamedTuple

import torch

from . import se3
from .se3 import SE3

CHEIRALITY_EPS = 1e-8


class BalCamera(NamedTuple):
    """PinholeCamera<Cal3Bundler>: pose + (f, k1, k2), a 9-dof manifold
    with tangent [pose(6); calib(3)]."""

    pose: SE3
    calib: torch.Tensor  # (..., 3) = f, k1, k2


def bal_retract(cam: BalCamera, d):
    """Tangent ordering [pose(6); calib(3)] (PinholeCamera.h retract)."""
    return BalCamera(se3.retract(cam.pose, d[..., :6]), cam.calib + d[..., 6:])


def bal_local(c1: BalCamera, c2: BalCamera):
    return torch.cat([se3.local(c1.pose, c2.pose), c2.calib - c1.calib],
                     dim=-1)


def bal_identity():
    return BalCamera(se3.identity(), torch.tensor([1.0, 0.0, 0.0],
                                                  dtype=torch.float64))


def uncalibrate_bundler(calib, p):
    """Normalized (...,2) -> pixels: g = f (1 + k1 r2 + k2 r2^2), pixel = g p."""
    f, k1, k2 = calib[..., 0], calib[..., 1], calib[..., 2]
    r2 = torch.sum(p * p, dim=-1)
    g = f * (1.0 + k1 * r2 + k2 * r2 * r2)
    return p * g[..., None]


def calibrate_bundler(calib, pixel, iterations=5):
    """Inverse of uncalibrate_bundler (fixed-point iteration,
    Cal3Bundler::calibrate)."""
    f = calib[..., 0:1]
    p = pixel / f
    for _ in range(iterations):
        r2 = torch.sum(p * p, dim=-1, keepdim=True)
        g = 1.0 + calib[..., 1:2] * r2 + calib[..., 2:3] * r2 * r2
        p = pixel / (f * g)
    return p


def project_point(pose: SE3, calib, point, uncalibrate):
    """World point -> (pixel, valid)."""
    pc = se3.transform_to(pose, point)
    z = pc[..., 2]
    valid = z > CHEIRALITY_EPS
    zs = torch.where(valid, z, torch.ones_like(z))
    return uncalibrate(calib, pc[..., :2] / zs[..., None]), valid


def bal_project(cam: BalCamera, point):
    return project_point(cam.pose, cam.calib, point, uncalibrate_bundler)


# -- Cal3_S2 pinhole (fx, fy, s, u0, v0) --------------------------------------


def uncalibrate_cal3s2(K, p):
    """K: (...,5) = fx, fy, s, u0, v0 (Cal3_S2.h)."""
    fx, fy, s, u0, v0 = (K[..., i] for i in range(5))
    u = fx * p[..., 0] + s * p[..., 1] + u0
    v = fy * p[..., 1] + v0
    return torch.stack([u, v], dim=-1)


def calibrate_cal3s2(K, pixel):
    fx, fy, s, u0, v0 = (K[..., i] for i in range(5))
    v = (pixel[..., 1] - v0) / fy
    u = (pixel[..., 0] - u0 - s * v) / fx
    return torch.stack([u, v], dim=-1)


class PinholeCameraS2(NamedTuple):
    """PinholeCamera<Cal3_S2>: pose + 5-dof calibration, an 11-dof
    manifold with tangent [pose(6); calib(5)]."""

    pose: SE3
    calib: torch.Tensor  # (..., 5)


def pinhole_s2_retract(cam: PinholeCameraS2, d):
    return PinholeCameraS2(se3.retract(cam.pose, d[..., :6]),
                           cam.calib + d[..., 6:])


def pinhole_s2_local(a: PinholeCameraS2, b: PinholeCameraS2):
    return torch.cat([se3.local(a.pose, b.pose), b.calib - a.calib], dim=-1)


def pinhole_s2_identity():
    return PinholeCameraS2(se3.identity(), torch.tensor(
        [1.0, 1.0, 0.0, 0.0, 0.0], dtype=torch.float64))


def pinhole_s2_project(cam: PinholeCameraS2, point):
    return project_point(cam.pose, cam.calib, point, uncalibrate_cal3s2)


def backproject(pose: SE3, calib, pixel, depth, calibrate):
    """Pixel + depth -> world point (PinholeCamera::backproject)."""
    p = calibrate(calib, pixel)
    pc = torch.cat([p * depth[..., None], depth[..., None]], dim=-1)
    return se3.transform_from(pose, pc)


# -- spherical -----------------------------------------------------------------


def spherical_project(pose: SE3, point):
    """SphericalCamera::project2 (SphericalCamera.h:159): world point -> the
    Unit3 bearing in the camera frame; valid iff the point is not at the
    camera centre."""
    pc = se3.transform_to(pose, point)
    n = torch.linalg.norm(pc, dim=-1, keepdim=True)
    valid = n[..., 0] > CHEIRALITY_EPS
    ns = torch.where(valid[..., None], n, torch.ones_like(n))
    return pc / ns, valid


def spherical_backproject(pose: SE3, bearing, depth):
    """Unit3 bearing + range -> world point (SphericalCamera::backproject)."""
    return se3.transform_from(pose, bearing * depth[..., None])


def spherical_reprojection_error(pose: SE3, point, measured):
    """The 2D tangent-space error B(measured)^T projected
    (SphericalCamera.cpp:90-104), zero where the projection is invalid."""
    from . import unit3

    projected, valid = spherical_project(pose, point)
    err = unit3.error_vector(measured, projected)
    return torch.where(valid[..., None], err, torch.zeros_like(err)), valid


# -- stereo ----------------------------------------------------------------------


def stereo_project(pose: SE3, K, baseline, point):
    """StereoCamera::project: (uL, uR, v) and valid."""
    pc = se3.transform_to(pose, point)
    z = pc[..., 2]
    valid = z > CHEIRALITY_EPS
    zs = torch.where(valid, z, torch.ones_like(z))
    fx, fy, s, u0, v0 = (K[..., i] for i in range(5))
    uL = u0 + fx * pc[..., 0] / zs
    uR = u0 + fx * (pc[..., 0] - baseline) / zs
    v = v0 + fy * pc[..., 1] / zs
    return torch.stack([uL, uR, v], dim=-1), valid
