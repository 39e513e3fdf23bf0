"""Graduated non-convexity (GNC) robust optimization.

Counterpart of gtsam_tpu/optimize/gnc.py (reference
gtsam/nonlinear/GncOptimizer.h:44, initializeMu:194, updateMu:277;
GncParams.h): the GM and TLS surrogates with a mu continuation schedule
around levenberg_marquardt; per-factor inlier weights reweight the noise
models of the robust batches.  On the card every inner LM of an SE3 pose
graph runs kernel 6 (a weighted batch is a per-factor diagonal model).
"""

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from scipy.stats import chi2 as chi2_dist

from ..base.noise import NoiseModel
from ..config import resolve_device
from ..graph import factors as factors_mod
from ..graph.graph import BoundGraph, FactorGraph
from ..graph.values import Values
from . import optimizers as opt_mod


@dataclasses.dataclass
class GncParams:
    loss_type: str = "TLS"            # "GM" | "TLS"
    max_iterations: int = 20
    barc_quantile: float = 0.99       # inlier threshold: a chi2 quantile
    mu_step: float = 1.4
    relative_cost_tol: float = 1e-5
    weights_tol: float = 1e-4
    inner: Optional[opt_mod.LMParams] = None
    robust_batches: Optional[Sequence[int]] = None  # indices; None: all


def _scale_noise(noise: NoiseModel, w: torch.Tensor,
                 rdim: int) -> NoiseModel:
    """A batch's noise model reweighted by per-factor weights w (N,): its
    square-root information times sqrt(w).  A unit model becomes the
    diagonal sqrt(w) broadcast to (N, rdim), where the JAX package keeps
    (N, 1): the same whitening, in the shape kernel 6 takes."""
    sw = torch.sqrt(w)
    n = len(w)
    if noise.kind == "unit":
        return NoiseModel("diagonal", sw[:, None].expand(n, rdim)
                          .contiguous(), noise.loss)
    if noise.kind == "diagonal":
        data = noise.data.to(sw.device).expand(n, noise.data.shape[-1])
        return NoiseModel("diagonal", data * sw[:, None], noise.loss)
    return NoiseModel("gaussian", noise.data.to(sw.device)
                      * sw[:, None, None], noise.loss)


def _factor_chi2(graph: FactorGraph, values: Values, batch_idx: List[int],
                 device):
    """Per-factor squared whitened residuals (twice each factor's error)
    of the batches batch_idx."""
    bound = BoundGraph(graph, values, device)
    out = []
    for bi in batch_idx:
        b, st = bound.graph.batches[bi], bound.structures[bi]
        r = factors_mod.residuals(b, bound._xs(b, st, values.arrays))
        wr = b.noise.whiten(r)
        out.append(torch.sum(wr * wr, dim=1))
    return out


def gnc_optimize(graph: FactorGraph, initial: Values,
                 params: Optional[GncParams] = None,
                 device=None) -> opt_mod.OptimizeResult:
    """GNC over `graph` from `initial`; the result of the last inner LM,
    whose history ends with ("gnc_weights", [weights of each robust batch,
    numpy]) and, in this port, also carries the outer iterations
    (`result.gnc_iterations`)."""
    params = params or GncParams()
    dev = resolve_device(device)
    inner = params.inner or opt_mod.LMParams(max_iterations=50)
    robust_idx = list(params.robust_batches
                      if params.robust_batches is not None
                      else range(len(graph.batches)))
    barc_sq = {bi: chi2_dist.ppf(params.barc_quantile, graph.batches[bi].rdim)
               for bi in robust_idx}

    # the auto solver of the graph, kept for every inner run: the weights
    # change no structure, so a sparse solver keeps its plan
    solver = opt_mod._auto_solver(BoundGraph(graph, initial.to(dev), dev))

    # the initial fit, unweighted
    res = opt_mod.levenberg_marquardt(graph, initial, inner, solver=solver,
                                      device=dev)
    values = res.values
    r2 = _factor_chi2(graph, values, robust_idx, dev)

    # mu's start (GncOptimizer.h:194)
    r2max = max(float(torch.max(x)) for x in r2)
    barc_mean = float(np.mean(list(barc_sq.values())))
    if params.loss_type == "GM":
        mu = 2.0 * r2max / barc_mean
    else:  # TLS
        mu = 1.0 / max(2.0 * r2max / barc_mean - 1.0, 1e-6)
    prev_cost = res.error
    weights = [torch.ones_like(x) for x in r2]

    it = 0
    for it in range(params.max_iterations):
        # the weights (GncOptimizer::calculateWeights)
        new_weights = []
        for x, bi in zip(r2, robust_idx):
            bc = float(barc_sq[bi])
            if params.loss_type == "GM":
                w = (mu * bc / (x + mu * bc)) ** 2
            else:  # TLS
                up = bc * (mu + 1.0) / mu
                lo = bc * mu / (mu + 1.0)
                w_mid = torch.sqrt(torch.clamp(
                    bc * mu * (mu + 1.0) / torch.clamp(x, min=1e-12),
                    min=0.0)) - mu
                w = torch.where(x >= up, 0.0, torch.where(
                    x <= lo, 1.0, torch.clamp(w_mid, 0.0, 1.0)))
            new_weights.append(w)
        weights = new_weights

        # the weighted inner optimization
        wg = FactorGraph()
        for bi, b in enumerate(graph.batches):
            if bi in robust_idx:
                w = weights[robust_idx.index(bi)]
                wg.add(dataclasses.replace(b, noise=_scale_noise(
                    b.noise, w, b.rdim)))
            else:
                wg.add(b)
        res = opt_mod.levenberg_marquardt(wg, values, inner, solver=solver,
                                          device=dev)
        values = res.values
        r2 = _factor_chi2(graph, values, robust_idx, dev)

        # mu's update and the convergence test (GncOptimizer::updateMu,
        # checkConvergence)
        if params.loss_type == "GM":
            mu = max(1.0, mu / params.mu_step)
            mu_converged = mu <= 1.0 + 1e-9
        else:
            mu = mu * params.mu_step
            mu_converged = False
        cost = res.error
        if mu_converged or abs(prev_cost - cost) < params.relative_cost_tol \
                * max(prev_cost, 1e-12):
            break
        prev_cost = cost

    res.history.append(("gnc_weights",
                        [w.detach().cpu().numpy() for w in weights]))
    res.gnc_iterations = it + 1
    return res
