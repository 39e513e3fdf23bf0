"""More SLAM factor batches: generic projection (pose + landmark), stereo,
essential matrix, priors on a pose's rotation or translation, the Karcher
mean, nonlinear equality and anti-factors.

Counterpart of gtsam_tpu/slam/factors.py (reference gtsam/slam:
ProjectionFactor.h, StereoFactor.h, EssentialMatrixFactor.h,
PoseRotationPrior.h, PoseTranslationPrior.h, KarcherMeanFactor-inl.h,
NonlinearEquality.h, AntiFactor.h).  Every residual broadcasts over
stacked elements.  A generic projection batch goes to kernel 17 on the
supernodal path (its residual names the kernel's group and carries K and
the extrinsic); the other batches take the generic linearization.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..base import noise as noise_mod
from ..geometry import se3, so3
from ..geometry.cameras import (CHEIRALITY_EPS, stereo_project,
                                uncalibrate_cal3s2)
from ..geometry.se3 import SE3
from ..graph import factors as factors_mod
from ..graph import manifolds

PENALTY = 1.0e3   # the residual of a point behind the camera


def _f64(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _keys2(a, b):
    return np.stack([np.asarray(a), np.asarray(b)], axis=1)


class _OnDevice:
    """Fixed tensors of a residual, kept once per device."""

    def __init__(self, **tensors):
        self._cpu = tensors
        self._by_dev = {}

    def on(self, device):
        key = str(device)
        if key not in self._by_dev:
            self._by_dev[key] = {k: None if v is None else v.to(device)
                                 for k, v in self._cpu.items()}
        return self._by_dev[key]


class GenericProjectionResidual:
    """GenericProjectionFactor<Pose3, Point3, Cal3_S2>'s residual: the
    pixel of the point seen by the sensor at pose * body_P_sensor (or the
    pose itself) with the fixed K = (fx, fy, s, u0, v0), less the
    measurement; the constant PENALTY behind the camera.  Kernel 17's
    GenericProjection variant reads K and the extrinsic from it
    (kernel_args)."""

    projection_group = "GenericProjection"

    def __init__(self, K, body_P_sensor: Optional[SE3] = None):
        ext = None
        if body_P_sensor is not None:
            ext = torch.cat([_f64(body_P_sensor.R).reshape(9),
                             _f64(body_P_sensor.t).reshape(3)])
        self._t = _OnDevice(K=_f64(K).reshape(5), ext=ext)

    def kernel_args(self, device):
        """(K (5,), ext (12,) or None) on `device`."""
        t = self._t.on(device)
        return t["K"], t["ext"]

    def __call__(self, xs, uv):
        pose, point = xs
        K, ext = self.kernel_args(point.device)
        if ext is not None:
            pose = se3.compose(pose, SE3(ext[:9].view(3, 3), ext[9:]))
        pc = se3.transform_to(pose, point)
        z = pc[..., 2]
        ok = z > CHEIRALITY_EPS
        zs = torch.where(ok, z, torch.ones_like(z))
        pix = uncalibrate_cal3s2(K, pc[..., :2] / zs[..., None])
        return torch.where(ok[..., None], pix - uv,
                           torch.full_like(pix, PENALTY))


def generic_projection_factors(pose_keys, point_keys, measurements, K,
                               noise: noise_mod.NoiseModel,
                               body_P_sensor: Optional[SE3] = None
                               ) -> factors_mod.FactorBatch:
    """GenericProjectionFactor<Pose3, Point3, Cal3_S2>: a fixed K, a pose
    and a landmark a factor; body_P_sensor the optional extrinsic."""
    return factors_mod.FactorBatch(
        "GenericProjection", ("SE3", "Point3"), _keys2(pose_keys, point_keys),
        2, GenericProjectionResidual(K, body_P_sensor),
        _f64(measurements), noise)


class _StereoResidual:
    def __init__(self, K, baseline):
        self._t = _OnDevice(K=_f64(K).reshape(5))
        self.baseline = float(baseline)

    def __call__(self, xs, m):
        pose, point = xs
        z, ok = stereo_project(pose, self._t.on(point.device)["K"],
                               self.baseline, point)
        return torch.where(ok[..., None], z - m, torch.full_like(z, PENALTY))


def stereo_factors(pose_keys, point_keys, measurements, K, baseline,
                   noise: noise_mod.NoiseModel) -> factors_mod.FactorBatch:
    """GenericStereoFactor: measurement (uL, uR, v)."""
    return factors_mod.FactorBatch(
        "Stereo", ("SE3", "Point3"), _keys2(pose_keys, point_keys), 3,
        _StereoResidual(K, baseline), _f64(measurements), noise)


def essential_matrix_from_pose(T: SE3):
    """E = hat(t / |t|) R of a relative pose (EssentialMatrix.h)."""
    n = torch.linalg.norm(T.t, dim=-1, keepdim=True)
    return so3.hat(T.t / torch.clamp(n, min=1e-12)) @ T.R


def _epipolar(xs, pts):
    rel = se3.between(xs[0], xs[1])  # cam_j -> cam_i coordinates
    E = essential_matrix_from_pose(rel)
    one = torch.ones_like(pts[..., 0, :1])
    xi = torch.cat([pts[..., 0, :], one], dim=-1)
    xj = torch.cat([pts[..., 1, :], one], dim=-1)
    return torch.einsum("...i,...ij,...j->...", xi, E, xj)[..., None]


def essential_matrix_factors(pose_keys_i, pose_keys_j, point_pairs,
                             noise: noise_mod.NoiseModel
                             ) -> factors_mod.FactorBatch:
    """The epipolar constraint between two poses, r = x_i^T E(T_i^-1 T_j)
    x_j; point_pairs (N, 2, 2) normalized coordinates in cameras i and j
    (EssentialMatrixConstraint by the relative pose)."""
    return factors_mod.FactorBatch(
        "EssentialEpipolar", ("SE3", "SE3"), _keys2(pose_keys_i, pose_keys_j),
        1, _epipolar, _f64(point_pairs), noise)


def _rotation_prior(xs, R):
    return so3.logmap(so3.between(R, xs[0].R))


def pose_rotation_priors(keys, rotations, noise) -> factors_mod.FactorBatch:
    """PoseRotationPrior<Pose3>: a prior on the rotation part only."""
    return factors_mod.FactorBatch(
        "PoseRotationPrior", ("SE3",), np.asarray(keys).reshape(-1, 1), 3,
        _rotation_prior, _f64(rotations), noise)


def _translation_prior(xs, t):
    return xs[0].t - t


def pose_translation_priors(keys, translations, noise
                            ) -> factors_mod.FactorBatch:
    """PoseTranslationPrior<Pose3>: a prior on the translation part only."""
    return factors_mod.FactorBatch(
        "PoseTranslationPrior", ("SE3",), np.asarray(keys).reshape(-1, 1), 3,
        _translation_prior, _f64(translations), noise)


def karcher_mean_so3(rotations, iterations: int = 10):
    """FindKarcherMean (KarcherMeanFactor.h:34): the Riemannian mean on
    SO(3), a fixed number of iterations from the first rotation."""
    R = torch.as_tensor(rotations, dtype=torch.float64)
    mean = R[0]
    for _ in range(iterations):
        logs = so3.logmap(so3.between(mean.expand_as(R), R))
        mean = so3.retract(mean, torch.mean(logs, dim=0))
    return mean


class _EqualityResidual:
    def __init__(self, tname):
        self.local = manifolds.get(tname).local

    def __call__(self, xs, target):
        return self.local(target, xs[0])


def nonlinear_equality_factors(tname: str, keys, targets, mu: float = 1e6,
                               exact: bool = False
                               ) -> factors_mod.FactorBatch:
    """NonlinearEquality<T> (constrained noise, NoiseModel.h:260):
    exact=False approximates the constraint with precision mu (every
    solver takes it); exact=True gives sigma = 0 constrained noise, the
    hard rows the solvers keep apart."""
    m = manifolds.get(tname)
    noise = (noise_mod.constrained_all(m.dim, mu=mu) if exact
             else noise_mod.isotropic(m.dim, 1.0 / np.sqrt(mu)))
    return factors_mod.FactorBatch(
        f"NonlinearEquality{tname}", (tname,), np.asarray(keys).reshape(-1, 1),
        m.dim, _EqualityResidual(tname),
        factors_mod._as_measurements(targets), noise)


def anti_factor(batch: factors_mod.FactorBatch) -> factors_mod.FactorBatch:
    """AntiFactor (gtsam/slam/AntiFactor.h): subtracts a batch's
    information, cancelling its effect in the Gauss-Newton assembly."""
    return dataclasses.replace(batch, sign=-batch.sign,
                               name=f"Anti{batch.name}")
