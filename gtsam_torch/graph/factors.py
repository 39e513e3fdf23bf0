"""Typed factor batches.

Counterpart of gtsam_tpu/graph/factors.py: all factors of one type form a
FactorBatch (a key table and stacked measurements).  The generic
linearization is `torch.func.vmap` of forward-mode `jacfwd` of the
tangent-perturbed residual, the port of linearize_raw.  On the supernodal
path, SE3 and SE2 between and prior batches take kernel 6 instead, and
the BalCamera and SE3 projection batches kernel 17
(linear/supernodal_kernels.py; `kernel_route`), robust or constrained ones
too, when their loss is one of the nine of base/losses.py; every other
batch (a loss of the user's own callables included) takes this path, which
counts its calls in GENERIC_LINEARIZATIONS.

A residual_fn has the signature (xs: tuple of elements, meas) -> (rdim,);
the port's geometry broadcasts, so it is also applied to stacked batches.
"""

import dataclasses
import functools
from typing import Any, Callable, Tuple

import numpy as np
import torch

from ..base import losses
from ..base.noise import NoiseModel
from ..geometry import se2, se3
from . import manifolds
from .values import first_leaf, take_rows, tree_map

# calls of linearize() on a batch without linearize_fn
GENERIC_LINEARIZATIONS = [0]
# calls of linearize_raw() for the hard rows of constrained batches
# (graph.BoundGraph.constraint_system)
CONSTRAINT_LINEARIZATIONS = [0]


@dataclasses.dataclass
class FactorBatch:
    name: str
    var_types: Tuple[str, ...]       # manifold type of each slot
    keys: np.ndarray                 # (N, arity) int64, host-side
    rdim: int
    residual_fn: Callable            # (xs, meas) -> (rdim,)
    measurements: Any                # tensor or NamedTuple, leading dim N
    noise: NoiseModel
    # optional custom whitened linearization:
    # (xs_one, meas_one) -> (tuple of (rdim, d_i) jacobians, (rdim,) b)
    linearize_fn: Callable = None
    # +1.0 normally; -1.0 subtracts this batch's information (AntiFactor.h)
    sign: float = 1.0
    # residual_fn takes one factor's elements only (custom_factors): the
    # batched residuals run it under vmap
    vmap_residual: bool = False

    def __post_init__(self):
        self.keys = np.atleast_2d(np.asarray(self.keys, dtype=np.int64))

    @property
    def num_factors(self) -> int:
        return self.keys.shape[0]

    @property
    def arity(self) -> int:
        return self.keys.shape[1]

    def dims(self) -> Tuple[int, ...]:
        return tuple(manifolds.get(t).dim for t in self.var_types)

    def to(self, device) -> "FactorBatch":
        meas = self.measurements
        if meas is not None:
            meas = tree_map(lambda a: a.to(device), meas)
        return dataclasses.replace(self, measurements=meas,
                                   noise=self.noise.to(device))


def residuals(batch: FactorBatch, xs):
    """Batched unwhitened residuals (N, rdim): xs = tuple of stacked
    elements per slot."""
    if batch.vmap_residual:
        return torch.func.vmap(batch.residual_fn)(xs, batch.measurements)
    return batch.residual_fn(xs, batch.measurements)


def linearize_raw(batch: FactorBatch, xs):
    """Batched UNWHITENED tangent-space Jacobians and residuals: (J, r) with
    J = tuple of (N, rdim, d_i), r = (N, rdim)."""
    dims = batch.dims()
    retracts = tuple(manifolds.get(t).retract for t in batch.var_types)
    def res_tangent(deltas, xs_one, meas_one):
        xs_p = tuple(r(x, d) for r, x, d in zip(retracts, xs_one, deltas))
        return batch.residual_fn(xs_p, meas_one)

    def one(xs_one, meas_one):
        dev = torch.utils._pytree.tree_leaves(xs_one)[0].device
        zeros = tuple(torch.zeros(d, dtype=torch.float64, device=dev)
                      for d in dims)
        return torch.func.jacfwd(res_tangent)(zeros, xs_one, meas_one)

    J = torch.func.vmap(one)(xs, batch.measurements)
    return tuple(J), residuals(batch, xs)


def linearize(batch: FactorBatch, xs):
    """Batched whitened Jacobians and right-hand sides in tangent space:
    (A: tuple of (N, rdim, d_i), b: (N, rdim)) with ||A dx - b||^2 and
    b = -whitened residual; a robust loss scales both rows of factor n by
    sqrt(w(||R r_n||)), after the whitening (IRLS)."""
    if batch.linearize_fn is not None:
        J, b = torch.func.vmap(batch.linearize_fn)(xs, batch.measurements)
        return J, b
    GENERIC_LINEARIZATIONS[0] += 1
    J, r = linearize_raw(batch, xs)
    wr = batch.noise.whiten(r)
    wJ = tuple(batch.noise.whiten_jacobian(Ji) for Ji in J)
    w = batch.noise.robust_weights(wr)
    if w is not None:
        wr = wr * w[:, None]
        wJ = tuple(Ji * w[:, None, None] for Ji in wJ)
    return wJ, -wr


# -- concrete factor constructors -------------------------------------------


@functools.lru_cache(maxsize=None)
def _between_residual(tname):
    # memoized: every Between<T> batch shares one residual function object,
    # which is how the supernodal path recognises the SE3 and SE2 ones
    if tname == "SE3":
        def fn(xs, meas):
            return se3.local(meas, se3.between(xs[0], xs[1]))
    elif tname == "SE2":
        def fn(xs, meas):
            return se2.local(meas, se2.between(xs[0], xs[1]))
    else:
        mt = manifolds.get(tname)
        if not tname.startswith(("Point", "Vec")):
            raise NotImplementedError(f"Between{tname} is not ported yet")

        def fn(xs, meas):
            return mt.local(meas, xs[1] - xs[0])
    return fn


@functools.lru_cache(maxsize=None)
def _prior_residual(tname):
    mt = manifolds.get(tname)

    def fn(xs, meas):
        return mt.local(meas, xs[0])

    return fn


def _as_measurements(m):
    """float64 tensors of a measurement array or NamedTuple of arrays."""
    if isinstance(m, tuple):
        return tree_map(lambda a: torch.as_tensor(a, dtype=torch.float64), m)
    return torch.as_tensor(np.asarray(m), dtype=torch.float64)


def between_factors(tname: str, keys1, keys2, measurements,
                    noise: NoiseModel, name=None) -> FactorBatch:
    """BetweenFactor<T> batch: error = Local(measured, between(x1, x2))
    (reference gtsam/slam/BetweenFactor.h)."""
    keys = np.stack([np.asarray(keys1), np.asarray(keys2)], axis=1)
    return FactorBatch(name=name or f"Between{tname}",
                       var_types=(tname, tname), keys=keys,
                       rdim=manifolds.get(tname).dim,
                       residual_fn=_between_residual(tname),
                       measurements=_as_measurements(measurements),
                       noise=noise)


def prior_factors(tname: str, keys, measurements, noise: NoiseModel,
                  name=None) -> FactorBatch:
    """PriorFactor<T> batch: error = Local(prior, x) (reference
    gtsam/slam/PriorFactor.h)."""
    keys = np.asarray(keys).reshape(-1, 1)
    return FactorBatch(name=name or f"Prior{tname}", var_types=(tname,),
                       keys=keys, rdim=manifolds.get(tname).dim,
                       residual_fn=_prior_residual(tname),
                       measurements=_as_measurements(measurements),
                       noise=noise)


def _take(meas, rows):
    return None if meas is None else take_rows(meas, rows)


def slice_batch(batch: FactorBatch, rows) -> FactorBatch:
    """The factors `rows` of a batch (the residual shared, the data sliced;
    a per-factor noise model sliced, its loss and mu kept)."""
    rows = np.asarray(rows)
    noise = batch.noise
    data = noise.data
    if data is not None and data.shape[0] > 1:
        data = data[torch.as_tensor(rows, device=data.device)]
    meas = batch.measurements
    if meas is not None:
        dev = first_leaf(meas).device
        meas = _take(meas, torch.as_tensor(rows, device=dev))
    return dataclasses.replace(
        batch, keys=batch.keys[rows], measurements=meas,
        noise=NoiseModel(noise.kind, data, noise.loss, noise.mu))


def custom_factors(name: str, var_types, keys, residual_fn, rdim,
                   measurements, noise: NoiseModel) -> FactorBatch:
    """An arbitrary residual, the CustomFactor / ExpressionFactor analog
    (gtsam/nonlinear/CustomFactor.h:36): Jacobians from torch.func.  The
    residual must accept one factor's elements (it runs under vmap);
    measurements are a tensor (or SE3) with a leading dimension N, or
    None."""
    if measurements is not None:
        measurements = _as_measurements(measurements)
    return FactorBatch(name, tuple(var_types), np.asarray(keys), rdim,
                       residual_fn, measurements, noise, vmap_residual=True)


# the groups of kernel 6's variants: SE3 (csrc/pg_between.cu) and SE2
# (csrc/pg_pose2.cu)
KERNEL_GROUPS = ("SE3", "SE2")
# the groups of kernel 17's variants (csrc/proj_factor.cu): a residual
# function with a `projection_group` attribute names its group, which
# fixes its computation: "BalCamera" (sfm/bal.py::_projection_residual,
# BalCamera + Point3) and "GenericProjection"
# (slam/factors.py::GenericProjectionResidual, SE3 + Point3 with a fixed
# Cal3_S2 and optional extrinsic, which the residual object carries)
PROJECTION_GROUPS = ("BalCamera", "GenericProjection")


def kernel_route(batch: FactorBatch):
    """(group, "between" or "prior") for an SE3 or SE2 batch that kernel 6
    linearizes, (group, "projection") for a projection batch that kernel
    17 linearizes (no custom linearize_fn, no loss but one of the nine of
    base/losses.py, both), else None."""
    if batch.linearize_fn is not None:
        return None
    if losses.kernel_code(batch.noise.loss) is None:
        return None
    group = getattr(batch.residual_fn, "projection_group", None)
    if group in PROJECTION_GROUPS:
        return group, "projection"
    for group in KERNEL_GROUPS:
        if batch.residual_fn is _between_residual(group):
            return group, "between"
        if batch.residual_fn is _prior_residual(group):
            return group, "prior"
    return None
