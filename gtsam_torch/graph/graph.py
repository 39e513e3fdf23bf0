"""FactorGraph: a list of typed factor batches, and its bound form.

Counterpart of gtsam_tpu/graph/graph.py (reference
gtsam/nonlinear/NonlinearFactorGraph.cpp:239-274).  `bind()` freezes the
graph structure against a Values' key table and moves measurements, noise
and row indices to the values' device once; the bound graph's error,
linearization and dense Gauss-Newton system are functions of the arrays.
The error of an SE3 or SE2 between or prior batch is kernel 6's (pg_error,
pg2_error), of a projection batch kernel 18's (proj_error, proj3_error),
on every device, robust and constrained ones included
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
from . import factors as factors_mod
from .values import Layout, Values, first_leaf, take_rows


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
    return first_leaf(next(iter(values.arrays.values()))).device


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

    def contributions(self, bi, arrays, H, gv, flips):
        """Batch bi's Gram blocks and gradient rows, as the supernodal
        assembly takes them: sign A_s1^T A_s2 of each slot pair (s1 <= s2)
        into H (N, npair, d*d), the (s1, s2) block transposed where
        flips[pair] says so, and sign A_s^T b into gv (N, arity, d), zero
        outside each block's leading dims x dims.  Kernel 6 for the SE3
        and SE2 batches it routes, kernel 17 for the projection batches
        (factors.kernel_route), the generic linearization for the
        others."""
        from ..linear import supernodal_kernels as sk
        b, st = self.graph.batches[bi], self.structures[bi]
        N, arity = b.num_factors, b.arity
        d = gv.shape[-1]
        route = factors_mod.kernel_route(b)
        if route is not None:
            group = route[0]
            flip = flips[1] if arity == 2 else flips[0]
            sk.LINEARIZE[group](*sk.group_args(group, arrays, st.rows_i32, b),
                                b.noise.kind, b.noise.data, b.sign, flip, H,
                                gv, *losses.kernel_code(b.noise.loss))
            return
        wJ, bvec = self.linearize_batch(bi, arrays)
        dims = b.dims()
        H.zero_()
        gv.zero_()
        Hv = H.view(N, -1, d, d)
        pairs = [(s1, s2) for s1 in range(arity) for s2 in range(s1, arity)]
        for p, (s1, s2) in enumerate(pairs):
            Hij = b.sign * torch.einsum("nri,nrj->nij", wJ[s1], wJ[s2])
            Hij = torch.nn.functional.pad(Hij, (0, d - dims[s2],
                                                0, d - dims[s1]))
            Hv[:, p] = torch.where(flips[p][:, None, None],
                                   Hij.transpose(1, 2), Hij)
        for s in range(arity):
            gv[:, s, :dims[s]] = b.sign * torch.einsum("nrd,nr->nd", wJ[s],
                                                       bvec)

    def jacobian_rows(self, bi, arrays, out):
        """Batch bi's whitened Jacobian rows A_s into out (N, arity, rmax,
        d): rows rdim.. and columns past each slot's dims zero (kernel 6 in
        its Jacobian mode leaves rows rdim.. unwritten)."""
        from ..linear import supernodal_kernels as sk
        b, st = self.graph.batches[bi], self.structures[bi]
        route = factors_mod.kernel_route(b)
        if route is not None:
            group = route[0]
            sk.JACOBIANS[group](*sk.group_args(group, arrays, st.rows_i32, b),
                                b.noise.kind, b.noise.data,
                                *losses.kernel_code(b.noise.loss), out)
            return
        wJ, _ = self.linearize_batch(bi, arrays)
        out.zero_()
        for s, Js in enumerate(wJ):
            out[:, s, :Js.shape[1], :Js.shape[2]] = Js

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

    def _gradient_plan(self):
        """The sparse gradient's plan, built once: the contribution buffer
        (factor-major per batch, a d-row per factor slot, as the
        supernodal system's), the sorted CSR of its rows by variable in the
        canonical order (stable: a variable's rows summed in (batch,
        factor, slot) order), and the flat index of each tangent entry in
        the (n, d) sum."""
        if getattr(self, "_grad", None) is not None:
            return self._grad
        from . import manifolds
        lay, dev = self.layout, self.device
        dims, var0 = [], {}
        for t in lay.type_order:
            var0[t] = len(dims)
            dims += [manifolds.get(t).dim] * len(lay.offsets[t])
        n, dims = len(dims), np.asarray(dims, np.int64)
        d = int(dims.max()) if n else 1
        tgt, base, hbase, gb, hb = [], [], [], 0, 0
        for b, st in zip(self.graph.batches, self.structures):
            ids = np.stack([var0[t] + np.asarray(st.rows[s]) for s, t in
                            enumerate(b.var_types)], axis=1)
            base.append(gb)
            hbase.append(hb)
            tgt.append(ids.reshape(-1))
            gb += ids.size
            hb += b.num_factors * b.arity * (b.arity + 1) // 2
        tgt = np.concatenate(tgt) if tgt else np.zeros(0, np.int64)
        ptr = np.concatenate([[0], np.cumsum(np.bincount(tgt, minlength=n))])
        flat = (np.repeat(np.arange(n) * d, dims)
                + np.arange(int(dims.sum())) - np.repeat(
                    np.cumsum(dims) - dims, dims))

        def i32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                   device=dev)
        empty = i32(np.zeros(0))
        # sign * mu of each hard row of constraint_system
        mu = [np.zeros(0)] + [
            np.full(len(n_idx), self.graph.batches[bi].sign
                    * self.graph.batches[bi].noise.mu)
            for bi, n_idx, _, _ in self._constraints]
        self._grad = dict(
            n=n, d=d, base=base, hbase=hbase, ngc=gb, nhc=hb,
            g_src=i32(np.argsort(tgt, kind="stable")), g_ptr=i32(ptr),
            flat=torch.as_tensor(flat, dtype=torch.long, device=dev),
            flips=[[torch.zeros(b.num_factors, dtype=torch.bool,
                                device=dev)] * (b.arity * (b.arity + 1) // 2)
                   for b in self.graph.batches],
            pad=torch.zeros((n, d), dtype=torch.float64, device=dev),
            empty=empty, ptr0=i32([0]),
            hc0=torch.zeros((0, d * d), dtype=torch.float64, device=dev),
            mu=torch.as_tensor(np.concatenate(mu), dtype=torch.float64,
                               device=dev))
        return self._grad

    def gradient(self, arrays):
        """The gradient of the half-chi2 at `arrays` (-g of gn_system),
        flat in the canonical layout, without H: each batch's gradient rows
        sign A_s^T b (kernel 6 for the batches it routes, the generic
        linearization for the others; contributions), summed per variable
        in a fixed order by kernel 6's assembly (pg_assemble over no
        blocks: its g half)."""
        from ..linear import supernodal_kernels as sk
        gp = self._gradient_plan()
        d, dev = gp["d"], self.device
        hc = torch.empty((gp["nhc"], d * d), dtype=torch.float64, device=dev)
        gc = torch.empty((gp["ngc"], d), dtype=torch.float64, device=dev)
        for bi, b in enumerate(self.graph.batches):
            N, arity = b.num_factors, b.arity
            npair = arity * (arity + 1) // 2
            h0, g0 = gp["hbase"][bi], gp["base"][bi]
            self.contributions(
                bi, arrays, hc[h0:h0 + N * npair].view(N, npair, d * d),
                gc[g0:g0 + N * arity].view(N, arity, d), gp["flips"][bi])
        e = gp["empty"]
        _, g = sk.pg_assemble(gp["hc0"], gc, e, gp["ptr0"], e, e,
                              gp["g_src"], gp["g_ptr"], gp["pad"], 1)
        return -g.reshape(-1)[gp["flat"]]

    def error_gradient(self, arrays):
        """The gradient of error(arrays): gradient, plus on a graph with
        hard rows the gradient sign mu C^T r of their penalty 0.5 mu r^2
        (the whitened rows give them weight 0; C and c = -r from
        constraint_system)."""
        g = self.gradient(arrays)
        if not self.num_constraints:
            return g
        C, c = self.constraint_system(arrays)
        return g - C.T @ (self._gradient_plan()["mu"] * c)
