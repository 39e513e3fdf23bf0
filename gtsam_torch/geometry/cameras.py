"""Bundler cameras (PinholeCamera<Cal3Bundler>), batched.

Counterpart of the BAL part of gtsam_tpu/geometry/cameras.py.  Pose is
camera-to-world; p_cam = pose^-1 * p_world; pinhole (x/z, y/z); then the
Bundler radial distortion.  Points at z <= CHEIRALITY_EPS are flagged
invalid instead of raising.
"""

from typing import NamedTuple

import torch

from . import se3
from .se3 import SE3

CHEIRALITY_EPS = 1e-8


class BalCamera(NamedTuple):
    """Pose + (f, k1, k2): a 9-dof manifold, tangent [pose(6); calib(3)]."""

    pose: SE3
    calib: torch.Tensor  # (..., 3) = f, k1, k2


def bal_retract(cam: BalCamera, d):
    return BalCamera(se3.retract(cam.pose, d[..., :6]), cam.calib + d[..., 6:])


def bal_local(c1: BalCamera, c2: BalCamera):
    return torch.cat([se3.local(c1.pose, c2.pose), c2.calib - c1.calib],
                     dim=-1)


def uncalibrate_bundler(calib, p):
    """Normalized (...,2) -> pixels: g = f (1 + k1 r2 + k2 r2^2), pixel = g p."""
    f, k1, k2 = calib[..., 0], calib[..., 1], calib[..., 2]
    r2 = torch.sum(p * p, dim=-1)
    g = f * (1.0 + k1 * r2 + k2 * r2 * r2)
    return p * g[..., None]


def project_point(pose: SE3, calib, point, uncalibrate):
    """World point -> (pixel, valid)."""
    pc = se3.transform_to(pose, point)
    z = pc[..., 2]
    valid = z > CHEIRALITY_EPS
    zs = torch.where(valid, z, torch.ones_like(z))
    return uncalibrate(calib, pc[..., :2] / zs[..., None]), valid


def bal_project(cam: BalCamera, point):
    return project_point(cam.pose, cam.calib, point, uncalibrate_bundler)
