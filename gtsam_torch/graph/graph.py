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
import types
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

    def contribution_plan(self) -> "ContributionPlan":
        """The contribution buffer's plan of this graph, built once and
        shared by the supernodal and level solvers' systems and by
        gradient."""
        if getattr(self, "_cplan", None) is None:
            self._cplan = ContributionPlan(self)
        return self._cplan

    def contributions(self, bi, arrays, plan, hc, gc, flips):
        """Batch bi's Gram blocks and gradient rows into its rows of the
        contribution buffer (plan: a ContributionPlan of this structure; hc
        (plan.n_hc, d*d), gc (plan.n_gc, d)): a row a factor and slot pair
        (s1 <= s2) of sign A_s1^T A_s2, transposed where flips[pair] says
        so, and a row a factor and slot of sign A_s^T b, zero outside each
        block's leading dims x dims; for a batch that kernel 17 linearizes
        the rows of its Gram plan instead, each the sum over its factors of
        one chunk (flips: one a row).  Kernel 6 for the SE3 and SE2 batches
        it routes, kernel 17 for the projection batches
        (factors.kernel_route), the generic linearization for the
        others."""
        from ..linear import supernodal_kernels as sk
        b, st = self.graph.batches[bi], self.structures[bi]
        N, arity = b.num_factors, b.arity
        d = gc.shape[-1]
        h0, g0 = plan.h_base[bi], plan.g_base[bi]
        route = factors_mod.kernel_route(b)
        gram = plan.gram[bi]
        if gram is not None:
            group = route[0]
            sk.LINEARIZE[group](*sk.group_args(group, arrays, st.rows_i32, b),
                                b.noise.kind, b.noise.data, b.sign,
                                plan.device_gram(hc.device)[bi], flips,
                                hc[h0:h0 + gram.nh], gc[g0:g0 + gram.ng],
                                *losses.kernel_code(b.noise.loss))
            return
        npair = arity * (arity + 1) // 2
        H = hc[h0:h0 + N * npair].view(N, npair, d * d)
        gv = gc[g0:g0 + N * arity].view(N, arity, d)
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
        (contribution_plan's), the sorted CSR of its gradient rows by
        variable in the canonical order (stable: a variable's rows summed
        in (batch, factor, slot) order, a Gram plan's in chunk order), and
        the flat index of each tangent entry in the (n, d) sum."""
        if getattr(self, "_grad", None) is not None:
            return self._grad
        from . import manifolds
        lay, dev = self.layout, self.device
        cp = self.contribution_plan()
        dims, var0 = [], {}
        for t in lay.type_order:
            var0[t] = len(dims)
            dims += [manifolds.get(t).dim] * len(lay.offsets[t])
        n, dims = len(dims), np.asarray(dims, np.int64)
        d = int(dims.max()) if n else 1
        slot_tgt = [[var0[t] + np.asarray(st.rows[s]) for s, t in
                     enumerate(b.var_types)]
                    for b, st in zip(self.graph.batches, self.structures)]
        asm = cp.assembly(None, slot_tgt, 0, np.zeros(0, np.int64), n,
                          factor_major=True)
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
            n=n, d=d, g_src=i32(asm["g_src"]), g_ptr=i32(asm["g_ptr"]),
            flat=torch.as_tensor(flat, dtype=torch.long, device=dev),
            flips=cp.row_flips([[np.zeros(b.num_factors, dtype=bool)]
                                * (b.arity * (b.arity + 1) // 2)
                                for b in self.graph.batches], dev),
            pad=torch.zeros((n, d), dtype=torch.float64, device=dev),
            empty=empty, ptr0=i32([0]),
            hc0=torch.zeros((0, d * d), dtype=torch.float64, device=dev),
            mu=torch.as_tensor(np.concatenate(mu), dtype=torch.float64,
                               device=dev))
        return self._grad

    def gradient(self, arrays):
        """The gradient of the half-chi2 at `arrays` (-g of gn_system),
        flat in the canonical layout, without H: each batch's gradient rows
        sign A_s^T b (kernel 6 for the batches it routes, kernel 17 for the
        projection batches, the generic linearization for the others;
        contributions), summed per variable in a fixed order by kernel 6's
        assembly (pg_assemble over no blocks: its g half)."""
        from ..linear import supernodal_kernels as sk
        gp = self._gradient_plan()
        cp = self.contribution_plan()
        d, dev = gp["d"], self.device
        hc = torch.empty((cp.n_hc, d * d), dtype=torch.float64, device=dev)
        gc = torch.empty((cp.n_gc, d), dtype=torch.float64, device=dev)
        for bi in range(len(self.graph.batches)):
            self.contributions(bi, arrays, cp, hc, gc, gp["flips"][bi])
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


class ContributionPlan:
    """The contribution buffer of a bound graph: where each batch's Gram
    blocks and gradient rows go, and in what order the assembly sums them
    (pg_assemble's asm_src / asm_ptr and g_src / g_ptr), built once on the
    host for the supernodal and level solvers' systems and for
    BoundGraph.gradient.  hc (n_hc, d*d) holds batch bi's H rows from
    h_base[bi], gc (n_gc, d) its gradient rows from g_base[bi]: a batch
    that kernel 17 linearizes (a projection batch) the rows of its Gram
    plan (gram[bi]: the plan, each row's first factor `rep`, its nh rows of
    H and ng of gv), a row a (chunk, target); any other batch a row a factor
    and slot pair, factor-major, and a row a factor and slot."""

    def __init__(self, bound: BoundGraph):
        from ..linear import supernodal_kernels as sk
        self.h_base, self.g_base, self.gram = [], [], []
        self._dev = {}
        hb = gb = 0
        for b, st in zip(bound.graph.batches, bound.structures):
            self.h_base.append(hb)
            self.g_base.append(gb)
            route = factors_mod.kernel_route(b)
            if route is not None and route[1] == "projection":
                plan, rep = sk.proj_gram_plan(st.rows[0], st.rows[1])
                nh, ng = sk.gram_rows(plan)
                self.gram.append(types.SimpleNamespace(plan=plan, rep=rep,
                                                       nh=nh, ng=ng))
                hb, gb = hb + nh, gb + ng
            else:
                self.gram.append(None)
                hb += b.num_factors * b.arity * (b.arity + 1) // 2
                gb += b.num_factors * b.arity
        self.n_hc, self.n_gc = hb, gb

    def device_gram(self, device):
        """Each batch's Gram plan as int32 tensors on `device` (None for a
        batch without one), made once a device."""
        from ..linear import supernodal_kernels as sk
        key = str(torch.device(device))
        if key not in self._dev:
            self._dev[key] = [None if g is None else sk.GramPlan(*(
                torch.as_tensor(a, dtype=torch.int32, device=device)
                for a in g.plan)) for g in self.gram]
        return self._dev[key]

    def _rows(self, bi, N, k, nslot, base):
        """(rows, factors): batch bi's buffer rows of Gram kind k (or its
        slot pair or slot k of `nslot` without a Gram plan), from `base`,
        and a factor of each row's target."""
        g = self.gram[bi]
        if g is None:
            return base + np.arange(N) * nslot + k, np.arange(N)
        r = np.flatnonzero(g.plan.rkind == k)
        return base + g.plan.rout[r].astype(np.int64), g.rep[r]

    def assembly(self, pair_tgt, slot_tgt, nb, diag_col_blocks, n,
                 factor_major=False):
        """pg_assemble's plan over this buffer.  pair_tgt[bi][p] (N,): the
        store block of factor n's slot pair p (None: no H); slot_tgt[bi][s]
        (N,): factor n's slot-s variable; nb store blocks, the diagonal
        block of each of the n variables in diag_col_blocks.  A target's
        rows are summed batch after batch, slot pair after pair (slot after
        slot; factor_major: a factor's slots in order), a Gram plan's in
        chunk order.  Returns int32 arrays asm_src, asm_ptr, asm_blk (T:
        the blocks that get a row, and every diagonal), asm_diag (the
        column of a diagonal block of T, else -1), g_src, g_ptr, and the
        bool mask in_t (nb,)."""
        from ..linear.supernodal_kernels import GRAM_SLOT0
        h_src, h_tgt, g_src, g_tgt = [], [], [], []
        for bi, sl in enumerate(slot_tgt):
            N, arity = len(sl[0]), len(sl)
            npair = arity * (arity + 1) // 2
            if pair_tgt is not None:
                for p in range(npair):
                    src, rep = self._rows(bi, N, p, npair, self.h_base[bi])
                    h_src.append(src)
                    h_tgt.append(np.asarray(pair_tgt[bi][p])[rep])
            if factor_major and self.gram[bi] is None:
                g_src.append(self.g_base[bi] + np.arange(N * arity))
                g_tgt.append(np.stack([np.asarray(t) for t in sl],
                                      1).reshape(-1))
                continue
            for s in range(arity):
                k = s if self.gram[bi] is None else s + GRAM_SLOT0
                src, rep = self._rows(bi, N, k, arity, self.g_base[bi])
                g_src.append(src)
                g_tgt.append(np.asarray(sl[s])[rep])

        def cat(xs):
            return np.concatenate(xs).astype(np.int64) if xs else \
                np.zeros(0, np.int64)
        h_src, h_tgt, g_src, g_tgt = map(cat, (h_src, h_tgt, g_src, g_tgt))
        counts = np.bincount(h_tgt, minlength=nb)
        diag_col = np.full(nb, -1, np.int32)
        diag_col[np.asarray(diag_col_blocks, np.int64)] = np.arange(
            len(diag_col_blocks), dtype=np.int32)
        in_t = (counts > 0) | (diag_col >= 0)
        asm_blk = np.flatnonzero(in_t)
        i32 = np.int32
        return dict(
            asm_src=h_src[np.argsort(h_tgt, kind="stable")].astype(i32),
            asm_ptr=np.concatenate([[0], np.cumsum(counts[asm_blk])]).astype(
                i32),
            asm_blk=asm_blk.astype(i32), asm_diag=diag_col[asm_blk],
            g_src=g_src[np.argsort(g_tgt, kind="stable")].astype(i32),
            g_ptr=np.concatenate([[0], np.cumsum(np.bincount(
                g_tgt, minlength=n))]).astype(i32),
            in_t=in_t)

    def row_flips(self, pair_flip, device):
        """contributions' flips of each batch, bool tensors on `device`,
        from pair_flip[bi][p] (N,), each factor's: the same list, or for a
        Gram batch one a row (its camera-point rows' factors')."""
        out = []
        for g, fl in zip(self.gram, pair_flip):
            if g is None:
                out.append([torch.as_tensor(np.asarray(f, dtype=bool),
                                            device=device) for f in fl])
            else:
                out.append(torch.as_tensor(
                    (g.plan.rkind == 1) & np.asarray(fl[1], dtype=bool)[g.rep],
                    device=device))
        return out
