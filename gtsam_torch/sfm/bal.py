"""BAL (Bundle Adjustment in the Large) problems and file I/O.

Numpy copy of gtsam_tpu/sfm/bal.py (BalProblem, read_bal, write_bal) plus
the torch projection residual.  Conventions mirror gtsam/sfm/SfmData.cpp:
measurements stored as (u, -v), camera rotation from a Rodrigues vector,
openGL2gtsam: wRc = R^T @ diag(1,-1,-1), center = R^T(-t).
"""

import dataclasses

import numpy as np
import torch

from ..geometry import so3
from ..geometry.cameras import bal_project

_R90 = np.diag([1.0, -1.0, -1.0])

CHEIRALITY_PENALTY = 1.0e3  # constant residual for points behind the camera


@dataclasses.dataclass
class BalProblem:
    """Raw BAL arrays (GTSAM-converted conventions)."""

    cam_R: np.ndarray      # (M, 3, 3) camera-to-world rotations
    cam_t: np.ndarray      # (M, 3) camera centers (world)
    cam_calib: np.ndarray  # (M, 3) f, k1, k2
    points: np.ndarray     # (N, 3)
    obs_cam: np.ndarray    # (K,) camera index
    obs_pt: np.ndarray     # (K,) point index
    obs_uv: np.ndarray     # (K, 2) pixel measurements (v negated)

    @property
    def num_cameras(self):
        return self.cam_R.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def num_observations(self):
        return self.obs_cam.shape[0]


def _rodrigues(w):
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def read_bal(path: str) -> BalProblem:
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)
    m = int(next(it)); n = int(next(it)); k = int(next(it))
    obs_cam = np.empty(k, dtype=np.int32)
    obs_pt = np.empty(k, dtype=np.int32)
    obs_uv = np.empty((k, 2))
    for i in range(k):
        obs_cam[i] = int(next(it))
        obs_pt[i] = int(next(it))
        u = float(next(it)); v = float(next(it))
        obs_uv[i] = (u, -v)  # the reference negates v (SfmData.cpp:209)
    cam_R = np.empty((m, 3, 3))
    cam_t = np.empty((m, 3))
    cam_calib = np.empty((m, 3))
    for i in range(m):
        w = np.array([float(next(it)) for _ in range(3)])
        t = np.array([float(next(it)) for _ in range(3)])
        f_k1_k2 = np.array([float(next(it)) for _ in range(3)])
        R = _rodrigues(w)
        cam_R[i] = R.T @ _R90
        cam_t[i] = R.T @ (-t)
        cam_calib[i] = f_k1_k2
    points = np.array([[float(next(it)) for _ in range(3)] for _ in range(n)])
    return BalProblem(cam_R, cam_t, cam_calib, points, obs_cam, obs_pt, obs_uv)


def write_bal(path: str, prob: BalProblem) -> None:
    """Inverse of read_bal (gtsam2openGL + v negation)."""
    lines = [f"{prob.num_cameras} {prob.num_points} {prob.num_observations}"]
    for c, p, uv in zip(prob.obs_cam, prob.obs_pt, prob.obs_uv):
        lines.append(f"{c} {p} {uv[0]} {-uv[1]}")
    R_gl = _R90 @ np.swapaxes(prob.cam_R, -1, -2)
    rotvec = so3.logmap(torch.from_numpy(R_gl)).numpy()
    for i in range(prob.num_cameras):
        t_gl = -(R_gl[i] @ prob.cam_t[i])
        lines += [f"{x}" for x in (*rotvec[i], *t_gl, *prob.cam_calib[i])]
    for p in prob.points:
        lines += [f"{x}" for x in p]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _projection_residual(cam, point, uv):
    """GeneralSFMFactor error: project(camera, point) - measurement.

    Cheirality (z <= CHEIRALITY_EPS) yields the constant residual
    CHEIRALITY_PENALTY: zero gradient, but a large error so LM rejects steps
    that push points behind cameras.
    """
    pixel, valid = bal_project(cam, point)
    return torch.where(valid[..., None], pixel - uv,
                       torch.full_like(pixel, CHEIRALITY_PENALTY))
