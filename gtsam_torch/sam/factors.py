"""Bearing, range and bearing-range factor batches.

Counterpart of gtsam_tpu/sam/factors.py (reference
gtsam/sam/{BearingFactor,RangeFactor,BearingRangeFactor}.h): residual
functions over the geometry, broadcast over stacked elements, on the
generic linearization.
"""

import numpy as np
import torch

from ..base import noise as noise_mod
from ..geometry import se2
from ..graph import factors as factors_mod


def _wrap_angle(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _keys2(a, b):
    return np.stack([np.asarray(a), np.asarray(b)], axis=1)


def _f64(x):
    return torch.as_tensor(np.asarray(x, dtype=float), dtype=torch.float64)


def _bearing_range(xs, m):
    local = se2.transform_to(xs[0], xs[1])
    b = torch.atan2(local[..., 1], local[..., 0])
    r = torch.linalg.norm(local, dim=-1)
    return torch.stack([_wrap_angle(b - m[..., 0]), r - m[..., 1]], dim=-1)


def bearing_range_2d_factors(pose_keys, point_keys, bearings, ranges,
                             noise: noise_mod.NoiseModel
                             ) -> factors_mod.FactorBatch:
    """BearingRangeFactor<Pose2, Point2>: [wrap(bearing - b), range - r]."""
    meas = np.stack([np.asarray(bearings), np.asarray(ranges)], axis=1)
    return factors_mod.FactorBatch(
        "BearingRange2D", ("SE2", "Point2"), _keys2(pose_keys, point_keys), 2,
        _bearing_range, _f64(meas), noise)


def _range2(xs, m):
    return (se2.range_to(xs[0], xs[1]) - m)[..., None]


def range_2d_factors(pose_keys, point_keys, ranges, noise
                     ) -> factors_mod.FactorBatch:
    """RangeFactor<Pose2, Point2>."""
    return factors_mod.FactorBatch(
        "Range2D", ("SE2", "Point2"), _keys2(pose_keys, point_keys), 1,
        _range2, _f64(ranges), noise)


def _bearing2(xs, m):
    return _wrap_angle(se2.bearing(xs[0], xs[1]) - m)[..., None]


def bearing_2d_factors(pose_keys, point_keys, bearings, noise
                       ) -> factors_mod.FactorBatch:
    """BearingFactor<Pose2, Point2>."""
    return factors_mod.FactorBatch(
        "Bearing2D", ("SE2", "Point2"), _keys2(pose_keys, point_keys), 1,
        _bearing2, _f64(bearings), noise)


def _range3(xs, m):
    return (torch.linalg.norm(xs[1] - xs[0].t, dim=-1) - m)[..., None]


def range_3d_factors(pose_keys, point_keys, ranges, noise
                     ) -> factors_mod.FactorBatch:
    """RangeFactor<Pose3, Point3>."""
    return factors_mod.FactorBatch(
        "Range3D", ("SE3", "Point3"), _keys2(pose_keys, point_keys), 1,
        _range3, _f64(ranges), noise)
