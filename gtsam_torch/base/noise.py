"""Vectorized noise models for factor batches.

Counterpart of gtsam_tpu/base/noise.py (reference gtsam/linear/NoiseModel.h).
A NoiseModel describes the noise of all N factors of a batch at once;
whiten acts on (N, rdim) residual stacks and (N, rdim, d) Jacobian stacks.
It holds the square-root information R (whitened = R r) as nothing (unit),
per-row inverse sigmas (diagonal, (N or 1, rdim)) or full matrices
(gaussian, (N or 1, rdim, rdim)); a leading dimension of 1 is shared by
every factor.  Robust losses and constrained (sigma == 0) rows are not
ported yet and raise.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

_MAX_PRECISION = 1e8  # effective precision substituted for sigma == 0 rows
KINDS = ("unit", "diagonal", "gaussian")


@dataclasses.dataclass
class NoiseModel:
    kind: str
    data: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise NotImplementedError(f"noise model kind {self.kind!r} is not "
                                      "ported yet")

    def to(self, device) -> "NoiseModel":
        if self.data is None:
            return self
        return NoiseModel(self.kind, self.data.to(device))

    def whiten(self, r):
        """(N, rdim) -> (N, rdim)."""
        if self.kind == "unit":
            return r
        if self.kind == "diagonal":
            return r * self.data
        return (self.data @ r[..., None])[..., 0]

    def whiten_jacobian(self, A):
        """(N, rdim, d) -> (N, rdim, d)."""
        if self.kind == "unit":
            return A
        if self.kind == "diagonal":
            return A * self.data[..., None]
        return self.data @ A

    def error(self, r):
        """Sum over the batch of 0.5 ||whiten(r)||^2 (a 0-d tensor)."""
        wr = self.whiten(r)
        return 0.5 * torch.sum(wr * wr)


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
    raise NotImplementedError("constrained noise is not ported yet")


def robust(base: NoiseModel, loss) -> NoiseModel:
    raise NotImplementedError("robust losses are not ported yet")
