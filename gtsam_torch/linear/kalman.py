"""Kalman filters: linear KF, RTS smoother and EKF.

Counterpart of gtsam_tpu/linear/kalman.py (reference gtsam/linear/
KalmanFilter.h:41, predict :104, update :135; gtsam/nonlinear/
ExtendedKalmanFilter-inl.h): the closed-form equations, algebraically the
reference's elimination on two-step graphs.  Dense algebra on one state,
so torch.linalg is its port as jnp.linalg is the JAX package's; the
smoother is a host loop in place of lax.scan, and the EKF's Jacobians come
from forward-mode autodiff (torch.func.jacfwd) on tangent perturbations.
"""

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..config import resolve_device


class GaussianState(NamedTuple):
    mean: torch.Tensor   # (n,)
    cov: torch.Tensor    # (n, n)


def kf_init(x0, P0, device=None) -> GaussianState:
    """The state N(x0, P0) on `device` (the CUDA device when None, which
    raises without CUDA: pass device='cpu' on a CPU-only host)."""
    dev = resolve_device(device)
    return GaussianState(torch.as_tensor(x0, device=dev),
                         torch.as_tensor(P0, device=dev))


def _like(ref, *ms):
    """The model matrices as tensors of ref's dtype on ref's device (None
    stays None)."""
    return tuple(None if m is None else torch.as_tensor(
        m, dtype=ref.dtype, device=ref.device) for m in ms)


def kf_predict(state: GaussianState, F, B, u, Q) -> GaussianState:
    """x' = F x + B u + w, w ~ N(0, Q)  (KalmanFilter::predict)."""
    F, B, u, Q = _like(state.cov, F, B, u, Q)
    x = F @ state.mean + (B @ u if B is not None else 0.0)
    P = F @ state.cov @ F.T + Q
    return GaussianState(x, P)


def _joseph(state, H, R, K):
    """The Joseph-form covariance (I - K H) P (I - K H)^T + K R K^T
    (numerically symmetric positive semi-definite)."""
    n = state.mean.shape[0]
    IKH = torch.eye(n, dtype=state.cov.dtype, device=state.cov.device) \
        - K @ H
    return IKH @ state.cov @ IKH.T + K @ R @ K.T


def kf_update(state: GaussianState, H, z, R) -> GaussianState:
    """z = H x + v, v ~ N(0, R)  (KalmanFilter::update)."""
    H, z, R = _like(state.cov, H, z, R)
    y = z - H @ state.mean
    S = H @ state.cov @ H.T + R
    K = torch.linalg.solve(S, H @ state.cov).T
    return GaussianState(state.mean + K @ y, _joseph(state, H, R, K))


def kf_smoother(filt_means, filt_covs, pred_means, pred_covs, F):
    """RTS smoother.  filt_*: (T, ...) filtered estimates; pred_*[k]: the
    prediction of step k made from step k-1 (pred_*[0] unused).  Returns
    the smoothed (T, ...) means and covariances."""
    (F,) = _like(filt_covs, F)
    T = filt_means.shape[0]
    xs, Ps = filt_means[-1], filt_covs[-1]
    means, covs = [xs], [Ps]
    for k in range(T - 2, -1, -1):
        C = torch.linalg.solve(pred_covs[k + 1], F @ filt_covs[k]).T
        xs = filt_means[k] + C @ (xs - pred_means[k + 1])
        Ps = filt_covs[k] + C @ (Ps - pred_covs[k + 1]) @ C.T
        means.append(xs)
        covs.append(Ps)
    return torch.stack(means[::-1]), torch.stack(covs[::-1])


@dataclasses.dataclass
class ExtendedKalmanFilter:
    """Nonlinear EKF over a manifold type (retract/local callables).

    motion:      f(x) -> x_pred (on the manifold)
    measurement: h(x) -> z
    Jacobians by jacfwd on tangent perturbations."""

    retract: Callable
    local: Callable
    dim: int

    def _zero(self, like):
        return torch.zeros(self.dim, dtype=like.dtype, device=like.device)

    def predict(self, state: GaussianState, x_repr, f, Q):
        """state.mean is a tangent delta around x_repr (kept at zero);
        returns (new x_repr, GaussianState with zero mean)."""
        x_new = f(x_repr)
        F = torch.func.jacfwd(
            lambda d: self.local(x_new, f(self.retract(x_repr, d))))(
                self._zero(state.cov))
        P = F @ state.cov @ F.T + Q
        return x_new, GaussianState(self._zero(state.cov), P)

    def update(self, state: GaussianState, x_repr, h, z, R):
        H = torch.func.jacfwd(lambda d: h(self.retract(x_repr, d)))(
            self._zero(state.cov))
        y = z - h(x_repr)
        S = H @ state.cov @ H.T + R
        K = torch.linalg.solve(S, H @ state.cov).T
        x_new = self.retract(x_repr, K @ y)
        return x_new, GaussianState(self._zero(state.cov),
                                    _joseph(state, H, R, K))
