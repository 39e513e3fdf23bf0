"""Matrix-free preconditioned conjugate gradient on the GN normal equations.

Counterpart of gtsam_tpu/linear/pcg.py (reference gtsam/linear/
PCGSolver.h:55, iterative.h:104, Preconditioner.h:64 BlockJacobi,
SubgraphSolver.h:76).  The Hessian is never formed: the matvec
v -> (J^T J + lam) v runs over the whitened Jacobian rows of every factor
slot (kernel 15), and the CG iteration's steps are kernel 16's.

  system: kernel 6's Jacobian mode writes each factor slot's whitened rows
          into a pool the solver owns (the generic torch.func path for other
          batches; BoundGraph.jacobian_rows), g = J^T b is the bound graph's
          gradient (kernel 6's linearize and assembly), and kernel 15's
          second entry forms the block-Jacobi diagonal from the pool, with
          the identity on each variable's padding;
  solve:  block-Jacobi: kernel 16's loop runs the whole solve in one
          launch (M^-1 = (diag + lam I)^-1 once a solve, x = 0, r = g, z, p,
          the tolerance; then each iteration kernel 15's matvec with p.Ap,
          the update (alpha, x, r, z, r.z, beta, the iteration count and the
          stop test into the done word) and the direction p = z + beta p,
          until the done word is set), and the host reads the done word
          once.  The subgraph preconditioner applies the spanning tree's
          sparse Cholesky (linear/sparse.py, kernels 14 and 11) between two
          launches of the loop an iteration: [matvec, update] and [FINISH
          (r.z and beta), direction].

The loop stops where the JAX while_loop stops: r.r <= tol^2 max(g.g,
1e-300) or max_iterations.  The test runs on the device into the done
word; the subgraph loop's launches return at once when it is set, and the
host reads the word every CHECK_EVERY iterations (fewer before
max_iterations), so the iteration count is the JAX loop's without a read
an iteration.  `last_solve` keeps the last solve's iterations, reads of
the word and iterations launched (block-Jacobi: one read, the iterations
run; the subgraph's: those past the stop return at once).

Hard (sigma == 0) rows and anti-factor batches are refused at bind:
whitened to weight 0 the former would be dropped, and the JAX package's PCG
sums the latter's information with a positive sign; diagonal damping is
ignored, as in the JAX package.
"""

import numpy as np
import torch

from ..graph import manifolds
from ..graph.graph import BoundGraph, FactorGraph, _BatchStructure
from . import sparse_kernels as K

F64 = torch.float64
I32 = torch.int32

# CG iterations between two reads of the done word
CHECK_EVERY = 16


class PCGSolver:
    """Pluggable solver for the nonlinear optimizers (matrix-free CG with
    a block-Jacobi preconditioner).  It owns the pool of whitened rows,
    zeroed once and rewritten by every system() call: a system holds until
    the next call, which the optimizers make once an iteration."""

    def __init__(self, max_iterations: int = 500, tol: float = 1e-9):
        self.max_iterations = max_iterations
        self.tol = tol
        self.last_solve = None

    def bind(self, bound: BoundGraph):
        if bound.num_constraints > 0:
            raise NotImplementedError(
                "PCG solvers do not support constrained (sigma==0) noise; "
                "use the dense solver's KKT path")
        if any(b.sign < 0 for b in bound.graph.batches):
            raise NotImplementedError(
                "PCG solvers do not support anti-factor batches (sign < 0)")
        self._bound = bound
        layout = bound.layout
        dev = bound.device
        # variables in the canonical order: offsets and dims
        var_off, var_dim, var0 = [], [], {}
        for t in layout.type_order:
            var0[t] = len(var_off)
            var_off += list(layout.offsets[t])
            var_dim += [manifolds.get(t).dim] * len(layout.offsets[t])
        self._nv = len(var_off)
        self._dmax = max(var_dim, default=1)
        self._rmax = max((b.rdim for b in bound.graph.batches), default=1)
        if self._dmax > K.MAX_D or self._rmax > K.MAX_R:
            raise NotImplementedError(
                f"PCG takes blocks of up to {K.MAX_R} x {K.MAX_D}")
        # slots: factor-major per batch; each slot's variable, each
        # factor's slots
        slot_var, self._base = [], []
        q = 0
        for b, st in zip(bound.graph.batches, bound.structures):
            ids = np.stack([var0[t] + np.asarray(st.rows[s], np.int64)
                            for s, t in enumerate(b.var_types)], axis=1)
            self._base.append(q)
            slot_var.append(ids.reshape(-1))
            q += ids.size
        self._Q = q
        slot_var = (np.concatenate(slot_var) if slot_var
                    else np.zeros(0, np.int64))
        arity = np.concatenate([np.full(b.num_factors, b.arity)
                                for b in bound.graph.batches]) \
            if bound.graph.batches else np.zeros(0, np.int64)
        fptr = np.concatenate([[0], np.cumsum(arity)])
        slot_fac = np.repeat(np.arange(len(arity)), arity)
        vslot = np.argsort(slot_var, kind="stable")
        vptr = np.concatenate([[0], np.cumsum(np.bincount(
            slot_var, minlength=self._nv))])

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=I32, device=dev)
        self._plan = dict(vptr=t(vptr), vslot=t(vslot),
                          slot_fac=t(slot_fac), fptr=t(fptr),
                          slot_var=t(slot_var), var_off=t(var_off),
                          var_dim=t(var_dim))
        self._pool = None
        return self

    # -- the system ---------------------------------------------------------

    def _jacobians(self, arrays):
        """The owned pool (Q, rmax, dmax) of every slot's whitened rows,
        zeroed once (rows past a batch's rdim stay zero) and rewritten."""
        bound, dev = self._bound, self._bound.device
        if self._pool is None:
            self._pool = torch.zeros((self._Q, self._rmax, self._dmax),
                                     dtype=F64, device=dev)
        for bi, b in enumerate(bound.graph.batches):
            q0 = self._base[bi]
            N, arity = b.num_factors, b.arity
            bound.jacobian_rows(bi, arrays, self._pool[
                q0:q0 + N * arity].view(N, arity, self._rmax, self._dmax))
        return self._pool

    def system(self, arrays):
        """(pool, g, diag): the whitened rows, g = J^T b (flat, canonical)
        and the block-Jacobi diagonal (nv, dmax, dmax)."""
        pool = self._jacobians(arrays)
        g = -self._bound.gradient(arrays)
        pl = self._plan
        diag = torch.empty((self._nv, self._dmax, self._dmax), dtype=F64,
                           device=g.device)
        K.pcg_jacobi(pool, pl["vptr"], pl["vslot"], pl["var_dim"], diag)
        return pool, g, diag

    def matvec(self, pool, v, lam):
        """(J^T J + lam) v over the pool (kernel 15), outside a CG loop."""
        st, ist = self._state(v.device)
        return K.pcg_matvec(pool, v, *self._mv_plan(), lam,
                            torch.empty_like(v), st, ist)

    def _mv_plan(self):
        pl = self._plan
        return (pl["vptr"], pl["vslot"], pl["slot_fac"], pl["fptr"],
                pl["slot_var"], pl["var_off"], pl["var_dim"])

    @staticmethod
    def _state(device):
        return (torch.zeros(K.ST_SIZE, dtype=F64, device=device),
                torch.zeros(K.IST_SIZE, dtype=I32, device=device))

    # -- the CG loop ------------------------------------------------------

    def _loop(self, pool, g, diag, lam, precondition=None):
        """x of the CG loop on (J^T J + lam) x = g: block-Jacobi, or with
        `precondition(r, z, stop)` (z = M^-1 r, every launch returning at
        once where stop's done word is set) the subgraph's."""
        dev = g.device
        st, ist = self._state(dev)
        x, r, z, p, Ap = (torch.empty_like(g) for _ in range(5))
        Minv = torch.empty_like(diag)
        jacobi = precondition is None
        mv = self._mv_plan()
        vecs = (diag, Minv, g, x, r, z, p, Ap)
        args = (lam, self.tol, self.max_iterations, jacobi)

        def group(bits, loop=False, first=False):
            K.pcg_loop(bits, loop, pool, *vecs, *mv, *args, first, st, ist)

        if jacobi:
            # the whole solve in one launch, its done word read once
            group(K.G_INIT | K.G_MATVEC | K.G_UPDATE | K.G_DIRECTION,
                  loop=True)
            it = int(ist[K.IT])
            self.last_solve = {"iterations": it, "reads": 1, "launched": it}
            return x
        group(K.G_INIT)
        precondition(r, z, ist)
        group(K.G_FINISH | K.G_DIRECTION, first=True)
        reads = launched = it = 0
        while True:
            # never past max_iterations: a loop that runs to it launches
            # nothing after its done word is set
            n = min(CHECK_EVERY, self.max_iterations - it)
            for _ in range(n):
                group(K.G_MATVEC | K.G_UPDATE)
                precondition(r, z, ist)
                group(K.G_FINISH | K.G_DIRECTION)
            launched += n
            done, it = ist[:2].tolist()
            reads += 1
            if done:
                break
        self.last_solve = {"iterations": it, "reads": reads,
                           "launched": launched}
        return x

    def solve(self, system, lam, diagonal_damping):
        """(x, ok): the CG solution of (J^T J + lam I) x = g (diagonal
        damping ignored, as in the JAX package); ok is True (NaN in x
        rejects the try through its error)."""
        pool, g, diag = system[:3]
        x = self._loop(pool, g, diag, lam)
        return x, torch.ones((), dtype=torch.bool, device=x.device)


class SubgraphPCGSolver(PCGSolver):
    """PCG preconditioned by a spanning-tree subgraph solve (reference
    SubgraphSolver.h:76, SubgraphPreconditioner.h:54): every unary row, and
    the binary rows that join two DSF components, in batch order; the tree
    system factored by the level-scheduled sparse Cholesky at lam = 1e-8."""

    def bind(self, bound):
        super().bind(bound)
        from ..base.dsf import DSF
        from ..graph import factors as factors_mod
        from .sparse import SparseCholeskySolver

        off_to_var = {int(o): i for i, o in
                      enumerate(np.concatenate([bound.layout.offsets[t]
                                                for t in
                                                bound.layout.type_order]))}
        dsf = DSF(self._nv)
        tree_rows = []
        for bi, (b, st) in enumerate(zip(bound.graph.batches,
                                         bound.structures)):
            if b.arity == 1:
                tree_rows.append((bi, np.arange(b.num_factors)))
                continue
            v0 = [off_to_var[int(o)] for o in st.col_offsets[0]]
            v1 = [off_to_var[int(o)] for o in st.col_offsets[1]]
            rows = []
            for n in range(b.num_factors):
                if dsf.find(v0[n]) != dsf.find(v1[n]):
                    dsf.union(v0[n], v1[n])
                    rows.append(n)
            if rows:
                tree_rows.append((bi, np.asarray(rows)))
        self.tree_rows = tree_rows
        tree = BoundGraph.__new__(BoundGraph)
        tree.device = bound.device
        tree.graph = FactorGraph([
            factors_mod.slice_batch(bound.graph.batches[bi], rows)
            for bi, rows in tree_rows])
        tree.layout = bound.layout
        tree.structures = []
        for bi, rows in tree_rows:
            st = bound.structures[bi]
            r = torch.as_tensor(rows, dtype=torch.long, device=bound.device)
            tree.structures.append(_BatchStructure(
                tuple(a[rows] for a in st.rows),
                tuple(a[rows] for a in st.col_offsets),
                tuple(a[r] for a in st.rows_dev), st.rows_i32[r]))
        tree._constraints = []
        tree.num_constraints = 0
        self._tree = SparseCholeskySolver(tree)
        self._tree_store = None
        return self

    def system(self, arrays):
        pool, g, diag = super().system(arrays)
        if self._tree_store is None:
            self._tree_store = self._tree.new_store()
        blocks, _ = self._tree.system(arrays, out=self._tree_store)
        return pool, g, diag, self._tree.factorize(blocks, 1e-8)

    def solve(self, system, lam, diagonal_damping):
        """(x, ok): ok is the tree factorization's."""
        pool, g, diag, tree_fact = system
        tree = self._tree

        def precondition(r, z, stop):
            tree.solve_factored(tree_fact, r, tree.dev.map_canon, stop,
                                out=z)

        x = self._loop(pool, g, diag, lam, precondition)
        return x, tree_fact.ok
