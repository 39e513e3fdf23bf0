"""BAL (Bundle Adjustment in the Large) and Bundler problems, file I/O,
and bundle adjustment as a factor graph.

Counterpart of gtsam_tpu/sfm/bal.py: numpy copies of BalProblem,
read_bal, read_bundler and write_bal; to_graph, the graph form of the
reference's timing/timeSFMBAL.cpp (a BalCamera variable a camera, a
Point3 a point, one ProjectionBal batch of every observation, which
kernels 17 and 18 linearize and evaluate on the supernodal path); and the
projection residuals.  Conventions mirror gtsam/sfm/SfmData.cpp:
measurements stored as (u, -v), camera rotation from a Rodrigues vector,
openGL2gtsam: wRc = R^T @ diag(1,-1,-1), center = R^T(-t).
"""

import dataclasses

import numpy as np
import torch

from ..base import keys as keys_mod
from ..base import noise as noise_mod
from ..geometry import so3
from ..geometry.cameras import BalCamera, bal_project
from ..geometry.se3 import SE3
from ..graph import factors as factors_mod
from ..graph.graph import FactorGraph
from ..graph.values import Values

CAM = keys_mod.shorthand("c")
PT = keys_mod.shorthand("p")

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


def read_bundler(path: str) -> BalProblem:
    """Bundler v0.3 file -> BalProblem (gtsam/sfm/SfmData.cpp
    FromBundlerFile): the header line ignored; per camera f k1 k2, a 3x3 R
    and t, with BAL's openGL2gtsam conversion; per point its xyz, rgb and
    view list (camera, sift index, u, v), v negated as in BAL.  Colours and
    sift indices are not kept."""
    with open(path) as f:
        f.readline()  # "# Bundle file v0.3"
        tokens = f.read().split()
    it = iter(tokens)
    m = int(next(it)); n = int(next(it))
    cam_R = np.empty((m, 3, 3))
    cam_t = np.empty((m, 3))
    cam_calib = np.empty((m, 3))
    for i in range(m):
        cam_calib[i] = [float(next(it)) for _ in range(3)]
        R = np.array([float(next(it)) for _ in range(9)]).reshape(3, 3)
        if not R.any():
            raise ValueError(f"zero rotation matrix for camera {i} in {path}")
        t = np.array([float(next(it)) for _ in range(3)])
        cam_R[i] = R.T @ _R90
        cam_t[i] = R.T @ (-t)
    points = np.empty((n, 3))
    obs_cam, obs_pt, obs_uv = [], [], []
    for j in range(n):
        points[j] = [float(next(it)) for _ in range(3)]
        next(it); next(it); next(it)  # rgb
        for _ in range(int(next(it))):
            ci = int(next(it)); next(it)  # the sift index is not kept
            u = float(next(it)); v = float(next(it))
            obs_cam.append(ci)
            obs_pt.append(j)
            obs_uv.append((u, -v))
    return BalProblem(cam_R, cam_t, cam_calib, points,
                      np.asarray(obs_cam, dtype=np.int32),
                      np.asarray(obs_pt, dtype=np.int32),
                      np.asarray(obs_uv, dtype=np.float64).reshape(-1, 2))


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


def to_graph(prob: BalProblem, sigma: float = 1.0):
    """(FactorGraph, Values) of BalCamera and Point3 variables, on the
    CPU: one ProjectionBal batch of every observation, camera keys c_i,
    point keys p_j (timeSFMBAL.h's camera-as-9-dof-variable BA)."""
    cam_keys = np.array([CAM(i) for i in range(prob.num_cameras)],
                        dtype=np.int64)
    pt_keys = np.array([PT(j) for j in range(prob.num_points)],
                       dtype=np.int64)
    keys = np.stack([cam_keys[prob.obs_cam], pt_keys[prob.obs_pt]], axis=1)
    batch = factors_mod.custom_factors(
        "ProjectionBal", ("BalCamera", "Point3"), keys, _projection_residual,
        2, prob.obs_uv, noise_mod.isotropic(2, sigma))
    f64 = torch.float64
    values = Values(
        arrays={"BalCamera": BalCamera(
            SE3(torch.as_tensor(prob.cam_R, dtype=f64),
                torch.as_tensor(prob.cam_t, dtype=f64)),
            torch.as_tensor(prob.cam_calib, dtype=f64)),
            "Point3": torch.as_tensor(prob.points, dtype=f64)},
        keys={"BalCamera": cam_keys, "Point3": pt_keys})
    return FactorGraph([batch]), values


def _projection_residual(xs, uv):
    """GeneralSFMFactor error: project(camera, point) - measurement, of
    one factor's (or stacked) elements xs = (BalCamera, Point3).

    Cheirality (z <= CHEIRALITY_EPS) yields the constant residual
    CHEIRALITY_PENALTY: zero gradient, but a large error so LM rejects steps
    that push points behind cameras.  Kernels 17 and 18 compute it on the
    supernodal path (projection_group; factors.kernel_route)."""
    cam, point = xs
    return _schur_projection_residual(cam, point, uv)


_projection_residual.projection_group = "BalCamera"


def _schur_projection_residual(cam, point, uv):
    """The same residual of a BalCamera and a point given apart (BA's
    Schur form, sfm/ba.py)."""
    pixel, valid = bal_project(cam, point)
    return torch.where(valid[..., None], pixel - uv,
                       torch.full_like(pixel, CHEIRALITY_PENALTY))
