"""Vectorized noise models for factor batches.

Counterpart of gtsam_tpu/base/noise.py (reference gtsam/linear/NoiseModel.h).
A NoiseModel describes the noise of all N factors of a batch at once;
whiten acts on (N, rdim) residual stacks and (N, rdim, d) Jacobian stacks.
It holds the square-root information R (whitened = R r) as nothing (unit),
per-row inverse sigmas (diagonal, (N or 1, rdim)) or full matrices
(gaussian, (N or 1, rdim, rdim)); a leading dimension of 1 is shared by
every factor.  A robust loss reweights the whitened rows (IRLS,
graph/factors.py::linearize) and replaces 0.5 ||R r||^2 in the error by
rho(||R r||).  Constrained models (reference noiseModel::Constrained,
NoiseModel.h:260) hold per-row inverse sigmas whose zeros mark hard rows:
whiten gives those rows weight 0, the solvers keep them as exact equality
constraints (graph/graph.py::BoundGraph.constraint_system), and the error
adds 0.5 mu r^2 on them.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import losses as losses_mod

_MAX_PRECISION = 1e8  # effective precision substituted for sigma == 0 rows
KINDS = ("unit", "diagonal", "gaussian", "constrained")


@dataclasses.dataclass
class NoiseModel:
    """kind: 'unit' | 'diagonal' | 'gaussian' | 'constrained', with an
    optional robust loss on top (not on 'constrained')."""

    kind: str
    data: Optional[torch.Tensor] = None
    loss: Optional[losses_mod.Loss] = None
    # 'constrained' only: the penalty weight of the hard rows in the error
    # (reference Constrained mu, NoiseModel.h:260, default 1000)
    mu: float = 1000.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise NotImplementedError(f"noise model kind {self.kind!r} is not "
                                      "ported yet")

    def to(self, device) -> "NoiseModel":
        if self.data is None:
            return self
        return NoiseModel(self.kind, self.data.to(device), self.loss, self.mu)

    def whiten(self, r):
        """(N, rdim) -> (N, rdim), without the robust reweighting; the hard
        rows of 'constrained' get weight 0."""
        if self.kind == "unit":
            return r
        if self.kind in ("diagonal", "constrained"):
            return r * self.data
        return (self.data @ r[..., None])[..., 0]

    def whiten_jacobian(self, A):
        """(N, rdim, d) -> (N, rdim, d)."""
        if self.kind == "unit":
            return A
        if self.kind in ("diagonal", "constrained"):
            return A * self.data[..., None]
        return self.data @ A

    def robust_weights(self, wr):
        """IRLS square-root weights (N,) of whitened residuals (N, rdim);
        None without a loss."""
        if self.loss is None:
            return None
        return torch.sqrt(self.loss.weight(torch.linalg.norm(wr, dim=-1)))

    def error(self, r):
        """The batch's error (a 0-d tensor): the sum of 0.5 ||whiten(r)||^2,
        or of rho(||whiten(r)||) with a loss; 'constrained' adds
        0.5 mu r^2 on the hard rows (reference
        Constrained::squaredMahalanobisDistance)."""
        wr = self.whiten(r)
        if self.kind == "constrained":
            pen = 0.5 * self.mu * torch.sum(
                torch.where(self.data == 0, r, 0.0) ** 2)
            return 0.5 * torch.sum(wr * wr) + pen
        if self.loss is None:
            return 0.5 * torch.sum(wr * wr)
        return torch.sum(self.loss.loss(torch.linalg.norm(wr, dim=-1)))

    def with_loss(self, loss) -> "NoiseModel":
        """This model with a robust loss (a Loss, or a name of LOSSES with
        its default parameter)."""
        if isinstance(loss, str):
            loss = losses_mod.LOSSES[loss]()
        if self.kind == "constrained":
            raise NotImplementedError(
                "robust loss on a constrained noise model is not supported")
        return NoiseModel(self.kind, self.data, loss, self.mu)


def _f64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def unit() -> NoiseModel:
    return NoiseModel("unit")


def sigmas(s) -> NoiseModel:
    """Per-row standard deviations, (rdim,) or (N, rdim); a zero sigma gets
    precision 1e8."""
    s = torch.atleast_2d(_f64(s))
    inv = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-300),
                      torch.full_like(s, np.sqrt(_MAX_PRECISION)))
    return NoiseModel("diagonal", inv)


def isotropic(rdim: int, sigma: float) -> NoiseModel:
    return sigmas(np.full((1, rdim), sigma))


def precisions(p) -> NoiseModel:
    return NoiseModel("diagonal", torch.sqrt(torch.atleast_2d(_f64(p))))


def information(M) -> NoiseModel:
    """Full information matrices, (rdim, rdim) or (N, rdim, rdim): R =
    chol(M)^T (upper), whiten(r) = R r (noiseModel::Gaussian::Information)."""
    M = _f64(M)
    if M.ndim == 2:
        M = M[None]
    return NoiseModel("gaussian", torch.linalg.cholesky(M).transpose(-1, -2)
                      .contiguous())


def covariance(S) -> NoiseModel:
    S = _f64(S)
    if S.ndim == 2:
        S = S[None]
    return information(torch.linalg.inv(S))


def constrained(s, mu: float = 1000.0) -> NoiseModel:
    """Mixed hard and soft rows (noiseModel::Constrained::MixedSigmas):
    sigma (rdim,) or (N, rdim); a zero sigma is an exact equality
    constraint, and mu weights its violation in the error."""
    s = torch.atleast_2d(_f64(s))
    inv = torch.where(s > 0, 1.0 / torch.clamp(s, min=1e-300),
                      torch.zeros_like(s))
    return NoiseModel("constrained", inv, mu=mu)


def constrained_all(rdim: int, mu: float = 1000.0) -> NoiseModel:
    """Every row hard (noiseModel::Constrained::All)."""
    return constrained(np.zeros((1, rdim)), mu=mu)


def robust(base: NoiseModel, loss) -> NoiseModel:
    return base.with_loss(loss)
