"""Trajectory metrics: ATE with SE(3)/Sim(3) Umeyama alignment, and RPE
(numpy).

Counterpart of gtsam_tpu/utils/metrics.py.
"""

import numpy as np


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform dst ~ s R src + t: (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate(estimate: np.ndarray, groundtruth: np.ndarray, align: bool = True,
        with_scale: bool = False) -> dict:
    """Absolute trajectory error on (N, 3) position arrays."""
    est = np.asarray(estimate, dtype=float)
    gt = np.asarray(groundtruth, dtype=float)
    if align:
        s, R, t = umeyama(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return {"rmse": float(np.sqrt(np.mean(err ** 2))),
            "mean": float(err.mean()),
            "median": float(np.median(err)),
            "max": float(err.max())}


def rpe(estimate: np.ndarray, groundtruth: np.ndarray, delta: int = 1) -> dict:
    """Relative pose (translation) error over index gaps of `delta`."""
    est = np.asarray(estimate, dtype=float)
    gt = np.asarray(groundtruth, dtype=float)
    err = np.linalg.norm((est[delta:] - est[:-delta])
                         - (gt[delta:] - gt[:-delta]), axis=1)
    return {"rmse": float(np.sqrt(np.mean(err ** 2))),
            "mean": float(err.mean()), "max": float(err.max())}
