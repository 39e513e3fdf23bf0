"""FactorGraph: a list of typed factor batches, and its bound form.

Counterpart of gtsam_tpu/graph/graph.py (reference
gtsam/nonlinear/NonlinearFactorGraph.cpp:239-274).  `bind()` freezes the
graph structure against a Values' key table and moves measurements, noise
and row indices to the values' device once; the bound graph's error,
linearization and dense Gauss-Newton system are functions of the arrays.
The error of an SE3 or SE2 between or prior batch is kernel 6's (pg_error,
pg2_error), on every device, robust and constrained ones included
(factors.kernel_route); other batches use the generic residuals.  The hard
(sigma == 0) rows of constrained noise models are also exact equality
constraints C dx = c (constraint_system), which the solvers keep apart
from the least-squares system.
"""

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..base import losses
from ..geometry.se3 import SE3
from . import factors as factors_mod
from .values import Layout, Values, take_rows


class FactorGraph:
    def __init__(self, batches: List[factors_mod.FactorBatch] = None):
        self.batches: List[factors_mod.FactorBatch] = list(batches or [])

    def add(self, batch: factors_mod.FactorBatch) -> "FactorGraph":
        self.batches.append(batch)
        return self

    @property
    def num_factors(self) -> int:
        return sum(b.num_factors for b in self.batches)

    def keys(self):
        out = set()
        for b in self.batches:
            out.update(int(k) for k in b.keys.reshape(-1))
        return out

    def error(self, values: Values):
        return self.bind(values).error(values.arrays)

    def bind(self, values: Values) -> "BoundGraph":
        return BoundGraph(self, values)


@dataclasses.dataclass(frozen=True)
class _BatchStructure:
    rows: Tuple[np.ndarray, ...]         # per slot: (N,) row index into type array
    col_offsets: Tuple[np.ndarray, ...]  # per slot: (N,) global column offset
    rows_dev: Tuple[torch.Tensor, ...]   # rows on the device, int64
    rows_i32: torch.Tensor               # (N, arity) int32 on the device


def _device_of(values: Values):
    a = next(iter(values.arrays.values()))
    return (a.t if isinstance(a, SE3) else a).device


class BoundGraph:
    """Graph structure frozen against a Values key table, on one device."""

    def __init__(self, graph: FactorGraph, values: Values, device=None):
        self.device = torch.device(device) if device is not None \
            else _device_of(values)
        self.graph = FactorGraph([b.to(self.device) for b in graph.batches])
        self.layout: Layout = values.layout()
        self.structures: List[_BatchStructure] = []
        for b in graph.batches:
            rows, offs = [], []
            for s, t in enumerate(b.var_types):
                r = values.rows_of(t, b.keys[:, s])
                rows.append(r)
                offs.append(self.layout.offsets[t][r])
            rows_dev = tuple(torch.as_tensor(r, dtype=torch.long,
                                             device=self.device)
                             for r in rows)
            rows_i32 = torch.as_tensor(np.stack(rows, axis=1),
                                       dtype=torch.int32, device=self.device)
            self.structures.append(_BatchStructure(tuple(rows), tuple(offs),
                                                   rows_dev, rows_i32))
        # the hard rows of constrained noise models: exact equality
        # constraints C dx = c (reference constraint-aware QR,
        # NoiseModel.h:260), host-side (batch, factors, rows, first row)
        self._constraints = []
        nc = 0
        for bi, b in enumerate(graph.batches):
            if b.noise.kind != "constrained":
                continue
            if b.linearize_fn is not None:
                raise NotImplementedError(
                    "constrained noise requires the autodiff linearize path")
            data = b.noise.data.cpu().numpy()
            mask = np.broadcast_to(data == 0, (b.num_factors, b.rdim))
            n_idx, r_idx = np.nonzero(mask)
            if len(n_idx):
                self._constraints.append(
                    (bi, n_idx.astype(np.int64), r_idx.astype(np.int64), nc))
                nc += len(n_idx)
        self.num_constraints = nc

    def _xs(self, b, st, arrays):
        return tuple(take_rows(arrays[t], st.rows_dev[s])
                     for s, t in enumerate(b.var_types))

    def error(self, arrays):
        """Total graph error: the sum of the batches' half-chi2 (0-d)."""
        from ..linear import supernodal_kernels as sk
        total = None
        for b, st in zip(self.graph.batches, self.structures):
            route = factors_mod.kernel_route(b)
            if route is not None:
                group = route[0]
                e = sk.ERROR[group](*sk.group_args(group, arrays,
                                                   st.rows_i32, b),
                                    b.noise.kind, b.noise.data, b.sign,
                                    *losses.kernel_code(b.noise.loss),
                                    b.noise.mu)
            else:
                r = factors_mod.residuals(b, self._xs(b, st, arrays))
                e = b.sign * b.noise.error(r)
            total = e if total is None else total + e
        if total is None:
            total = torch.zeros((), dtype=torch.float64, device=self.device)
        return total

    def linearize_batch(self, i, arrays):
        """Whitened (wJ tuple, b) of batch i by the generic path."""
        b, st = self.graph.batches[i], self.structures[i]
        return factors_mod.linearize(b, self._xs(b, st, arrays))

    def linearize(self, arrays):
        """Per-batch whitened (A, b) blocks; list of (wJ tuple, b)."""
        return [self.linearize_batch(i, arrays)
                for i in range(len(self.graph.batches))]

    def gn_system(self, arrays):
        """Dense Gauss-Newton normal equations (H, g) in the canonical
        tangent layout: H = J^T J, g = J^T b (reference
        linearizeToHessianFactor, NonlinearFactorGraph.cpp:312)."""
        D = self.layout.total_dim
        dev = self.device
        H = torch.zeros((D, D), dtype=torch.float64, device=dev)
        g = torch.zeros(D, dtype=torch.float64, device=dev)
        for (wJ, bvec), bt, st in zip(self.linearize(arrays),
                                      self.graph.batches, self.structures):
            dims = bt.dims()
            idx = [torch.as_tensor(st.col_offsets[i][:, None]
                                   + np.arange(dims[i])[None, :],
                                   dtype=torch.long, device=dev)
                   for i in range(bt.arity)]
            for i in range(bt.arity):
                gi = bt.sign * torch.einsum("nrd,nr->nd", wJ[i], bvec)
                g.index_put_((idx[i],), gi, accumulate=True)
                for j in range(i, bt.arity):
                    Hij = bt.sign * torch.einsum("nri,nrj->nij", wJ[i], wJ[j])
                    H.index_put_((idx[i][:, :, None], idx[j][:, None, :]),
                                 Hij, accumulate=True)
                    if j > i:
                        H.index_put_((idx[j][:, :, None], idx[i][:, None, :]),
                                     Hij.transpose(1, 2), accumulate=True)
        return H, g

    def constraint_system(self, arrays):
        """The linearized hard constraints C dx = c of the sigma == 0 rows:
        C (Nc, D) their unwhitened Jacobian rows, c (Nc,) their negated
        residuals, by the generic linearization of their batches (counted
        in factors.CONSTRAINT_LINEARIZATIONS)."""
        D = self.layout.total_dim
        dev = self.device
        C = torch.zeros((self.num_constraints, D), dtype=torch.float64,
                        device=dev)
        c = torch.zeros(self.num_constraints, dtype=torch.float64,
                        device=dev)
        for bi, n_idx, r_idx, row0 in self._constraints:
            b, st = self.graph.batches[bi], self.structures[bi]
            factors_mod.CONSTRAINT_LINEARIZATIONS[0] += 1
            J, r = factors_mod.linearize_raw(b, self._xs(b, st, arrays))
            n_t = torch.as_tensor(n_idx, device=dev)
            r_t = torch.as_tensor(r_idx, device=dev)
            rows = torch.arange(row0, row0 + len(n_idx), device=dev)
            c[rows] = -r[n_t, r_t]
            for i, d in enumerate(b.dims()):
                cols = torch.as_tensor(st.col_offsets[i][n_idx][:, None]
                                       + np.arange(d)[None, :],
                                       dtype=torch.long, device=dev)
                C.index_put_((rows[:, None].expand_as(cols), cols),
                             J[i][n_t, r_t, :], accumulate=True)
        return C, c

    def gradient(self, arrays):
        """The gradient of the half-chi2 at `arrays` (-g of gn_system)."""
        _, g = self.gn_system(arrays)
        return -g
