"""Batch nonlinear optimizers: Gauss-Newton, Levenberg-Marquardt, Dogleg
and nonlinear conjugate gradient.

Counterpart of gtsam_tpu/optimize/optimizers.py.  Semantics mirror the
reference optimizers (NonlinearOptimizer.cpp:62-120, :182 checkConvergence;
LevenbergMarquardtOptimizer.cpp:121-273; DoglegOptimizerImpl.h:95, 138;
NonlinearConjugateGradientOptimizer.cpp).  The loops run on the host; each
try is the solver's device work and one device-to-host read.  Solvers:
DenseSolver (normal equations, small graphs; an exact KKT solve for the
hard rows of constrained noise), DenseQRSolver (dense QR of the whitened
rows) and SparseSolver (the supernodal Cholesky or, method="qr", the
multifrontal QR, linear/supernodal.py; hard rows by the method of
weighting and three augmented-Lagrangian passes; method="levels", the
level-scheduled sparse Cholesky, linear/sparse.py); linear/pcg.py's
PCGSolver and SubgraphPCGSolver plug in the same way.  A system is
(H-like, g) or, with hard rows, (H-like, g, C, c); the sparse QR's carries
the Jacobian rows too.
"""

import copy
import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..base.noise import NoiseModel
from ..config import resolve_device
from ..graph.graph import BoundGraph, FactorGraph
from ..graph.values import Values, arrays_to, retract_arrays
from ..linear.sparse import SparseCholeskySolver
from ..linear.supernodal import SupernodalCholeskySolver


@dataclasses.dataclass
class OptimizerParams:
    max_iterations: int = 100
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    error_tol: float = 0.0
    verbose: bool = False


@dataclasses.dataclass
class LMParams(OptimizerParams):
    lambda_initial: float = 1e-5
    lambda_factor: float = 10.0
    lambda_upper_bound: float = 1e5
    lambda_lower_bound: float = 0.0
    diagonal_damping: bool = False
    min_diagonal: float = 1e-6
    max_diagonal: float = 1e32
    # "gtsam": always decrease lambda on accept (LevenbergMarquardtOptimizer);
    # "conservative": decrease only on a clean first-try accept and never
    # probe a lambda that already failed.
    lambda_policy: str = "gtsam"


def check_convergence(current: float, new: float, p: OptimizerParams) -> bool:
    """Reference NonlinearOptimizer.cpp:182 checkConvergence."""
    if new <= p.error_tol:
        return True
    delta = abs(current - new)
    return (delta <= p.absolute_error_tol
            or delta <= p.relative_error_tol * max(current, 1e-300))


@dataclasses.dataclass
class DoglegParams(OptimizerParams):
    initial_delta: float = 1.0


@dataclasses.dataclass
class OptimizeResult:
    values: Values
    error: float
    iterations: int
    converged: bool
    history: list


def _kkt_solve(H, g, C, c, lam, diagonal_damping, min_diag=1e-6,
               max_diag=1e32):
    """The equality-constrained GN step: min 0.5 dx'H dx - g'dx s.t.
    C dx = c, from the KKT system [[H + damping, C'], [C, -eps I]]
    [dx; nu] = [g; c] (damping on H only; the -eps regularizer keeps the
    LU nonsingular under redundant constraints).  (dx, ok)."""
    D, m = H.shape[0], C.shape[0]
    Hd = H + torch.diag(DenseSolver._damp(H, lam, diagonal_damping,
                                          min_diag, max_diag))
    eps = 1e-12 if H.dtype == torch.float64 else 1e-6
    K = torch.cat([torch.cat([Hd, C.T], dim=1), torch.cat(
        [C, -eps * torch.eye(m, dtype=H.dtype, device=H.device)], dim=1)])
    sol, info = torch.linalg.solve_ex(K, torch.cat([g, c]))
    return sol[:D], info == 0


class DenseSolver:
    """Dense normal equations and Cholesky (small graphs); graphs with
    hard (constrained) rows get an exact KKT solve.  The solve returns
    (dx, ok), ok from cholesky_ex (or the KKT solve's LU)."""

    def bind(self, bound):
        self._bound = bound
        return self

    def system(self, arrays):
        if self._bound.num_constraints:
            H, g = self._bound.gn_system(arrays)
            return (H, g) + self._bound.constraint_system(arrays)
        return self._bound.gn_system(arrays)

    @staticmethod
    def _damp(H, lam, diagonal_damping, min_diag=1e-6, max_diag=1e32):
        if diagonal_damping:
            return lam * torch.clamp(torch.diagonal(H), min_diag, max_diag)
        return lam * torch.ones(H.shape[0], dtype=H.dtype, device=H.device)

    def solve(self, system, lam, diagonal_damping):
        if len(system) == 4:
            return _kkt_solve(*system, lam, diagonal_damping)
        H, g = system
        Hd = H + torch.diag(self._damp(H, lam, diagonal_damping))
        L, info = torch.linalg.cholesky_ex(Hd)
        return torch.cholesky_solve(g[:, None], L)[:, 0], info == 0

    def predicted_decrease(self, system, dx, lam, diagonal_damping):
        """Linear-model decrease 0.5 (dx'g + lam dx'D dx) of the damped GN
        model (the gain ratio's denominator)."""
        H, g = system[0], system[1]
        d = torch.clamp(torch.diagonal(H), 1e-6, 1e32) if diagonal_damping \
            else 1.0
        return 0.5 * (torch.dot(dx, g) + lam * torch.sum(d * dx * dx))


class DenseQRSolver:
    """Dense QR elimination (EliminatePreferQR, gtsam/linear/
    JacobianFactor.cpp): the whitened Jacobian rows stacked densely,
    [A; sqrt(lam) I] = QR, R dx = Q^T b; conditioning kappa(A), not
    kappa(A)^2.  Hard (constrained) rows: QR of the rows weighted by 1e3
    and three augmented-Lagrangian passes over R (the JAX package's
    DenseQRSolver).  A pivot |R_kk| <= 1e-10 max |R_jj| poisons the step
    with NaN (and its ok is False), so the optimizer rejects it;
    check_system names the first such column.  torch.linalg.qr does the
    factorization, as jnp.linalg.qr does the JAX package's (systems of up
    to ~1,000 dimensions); plain lambda damping only."""

    def bind(self, bound):
        self._orig_bound = bound
        self._w = None
        if bound.num_constraints:
            self._w = CONSTRAINT_WEIGHT
            bound = _soften_constraints(bound, self._w)
        self._bound = bound
        return self

    def system(self, arrays):
        if self._w is not None:
            return self._assemble(arrays) + \
                self._orig_bound.constraint_system(arrays)
        return self._assemble(arrays)

    def _assemble(self, arrays):
        """The whitened rows (A (rows, D), b (rows,)), batch after batch,
        factor after factor."""
        bound = self._bound
        D, dev = bound.layout.total_dim, bound.device
        A_rows, b_rows = [], []
        for (wJ, wb), bt, st in zip(bound.linearize(arrays),
                                    bound.graph.batches, bound.structures):
            n, r = bt.num_factors, bt.rdim
            A = torch.zeros((n, r, D), dtype=torch.float64, device=dev)
            for s, dim in enumerate(bt.dims()):
                cols = torch.as_tensor(st.col_offsets[s][:, None]
                                       + np.arange(dim)[None, :],
                                       dtype=torch.long, device=dev)
                A.scatter_add_(2, cols[:, None, :].expand(n, r, dim), wJ[s])
            A_rows.append(A.reshape(n * r, D))
            b_rows.append(wb.reshape(n * r))
        return torch.cat(A_rows), torch.cat(b_rows)

    def solve(self, system, lam, diagonal_damping):
        if diagonal_damping:
            raise NotImplementedError("the dense QR takes plain lambda "
                                      "damping only")
        A, b = system[0], system[1]
        D = A.shape[1]
        eye = torch.eye(D, dtype=A.dtype, device=A.device)
        Q, R = torch.linalg.qr(torch.cat([A, math.sqrt(lam) * eye]))
        rdiag = torch.abs(torch.diagonal(R))
        rhs = Q.T @ torch.cat([b, torch.zeros(D, dtype=b.dtype,
                                              device=b.device)])
        dx = torch.linalg.solve_triangular(R, rhs[:, None], upper=True)[:, 0]
        if len(system) == 4:
            # augmented-Lagrangian passes over R (corrected seminormal
            # solves) to the exact KKT point of the hard rows
            C, c = system[2], system[3]
            w2 = self._w ** 2
            nu = torch.zeros_like(c)
            gb = A.T @ b
            for _ in range(3):
                nu = nu + w2 * (c - C @ dx)
                y = torch.linalg.solve_triangular(
                    R.T, (gb + C.T @ nu)[:, None], upper=False)
                dx = torch.linalg.solve_triangular(R, y, upper=True)[:, 0]
        bad = torch.any(rdiag <= 1e-10 * torch.max(rdiag))
        return torch.where(bad, torch.full_like(dx, math.nan), dx), ~bad

    def check_system(self, arrays, lam=0.0):
        """Raise IndeterminantLinearSystemError naming the first column
        whose pivot |R_kk| <= 1e-9 max |R_jj| (unpivoted QR of A, padded
        with zero rows to square when wide)."""
        from ..linear.exceptions import IndeterminantLinearSystemError
        A = self.system(arrays)[0]
        D = A.shape[1]
        if A.shape[0] < D:
            A = torch.cat([A, torch.zeros((D - A.shape[0], D),
                                          dtype=A.dtype, device=A.device)])
        rdiag = torch.abs(torch.diagonal(torch.linalg.qr(A, mode="r").R))
        rdiag = rdiag.cpu().numpy()
        scale = float(rdiag.max()) if rdiag.size else 1.0
        bad = np.where(rdiag <= 1e-9 * max(scale, 1e-30))[0]
        if len(bad):
            raise IndeterminantLinearSystemError(int(bad[0]))


# the method of weighting's weight of the hard rows (precision 1e6), modest:
# the augmented-Lagrangian passes give exactness, and a large weight would
# put cond ~ w^2 into the factorization
CONSTRAINT_WEIGHT = 1e3


def _soften_constraints(bound, weight: float):
    """The bound graph with its hard rows made soft rows of weight
    `weight` (precision weight^2): the sparse path's method of weighting
    (the reference pivots constrained rows in QR, NoiseModel.h:514).  The
    structures and layout are the original's; no constraint is left."""
    batches = []
    for b in bound.graph.batches:
        nz = b.noise
        if nz.kind == "constrained":
            data = torch.where(nz.data == 0, weight, nz.data)
            b = dataclasses.replace(
                b, noise=NoiseModel("diagonal", data, nz.loss, nz.mu))
        batches.append(b)
    soft = copy.copy(bound)
    soft.graph = type(bound.graph)(batches)
    soft._constraints = []
    soft.num_constraints = 0
    return soft


class SparseSolver:
    """The supernodal sparse Cholesky (linear/supernodal.py), with
    refine_iters float64 refinement passes per solve (solve_refined); or,
    method="qr", the multifrontal QR of the whitened Jacobian on the same
    supernodal structure (the reference's EliminateQR,
    JacobianFactor.cpp:778: conditioning kappa(A) instead of kappa(A)^2),
    whose system also carries the Jacobian rows (kernel 6's Jacobian mode,
    once an iteration), a solve factorizing them with kernel 12 and
    refining against the Gram matvec; plain lambda damping only, no
    gain-ratio denominator; or, method="levels", the level-scheduled sparse
    Cholesky (linear/sparse.py: kernels 13 and 14 a level, the dense root
    on kernels 10 and 11) with plain lambda damping (diagonal_damping is
    ignored, as in the JAX package), no refinement and no gain-ratio
    denominator.  method="levels" refuses hard rows at bind (the JAX
    package's levels path fails on them with a TypeError in
    _solve_constrained).

    Hard (constrained) rows: bind() softens them to precision
    constraint_weight^2 (method of weighting; 1e3 by default), and a solve
    factorizes that system once and makes three augmented-Lagrangian
    passes over it (SparseSolver._solve_constrained of the JAX package),
    with no refinement inside them.

    It owns one block store, zeroed once at its first system() call, and
    every system() call assembles into it: only H's own blocks are written,
    the rest stays zero.  So a system() result holds until the next call,
    which the optimizers make once per iteration after dropping the last
    one; nothing writes into it (factorize works on a copy)."""

    def __init__(self, order: str = "auto", method: str = "supernodal",
                 constraint_weight: Optional[float] = None,
                 refine_iters: Optional[int] = None,
                 supernodal_kwargs: Optional[dict] = None):
        if method not in ("supernodal", "qr", "levels"):
            raise NotImplementedError(f"SparseSolver method {method!r} is "
                                      "not ported yet")
        self._method = method
        self._order = order
        self._cweight = constraint_weight
        self._sn_kwargs = supernodal_kwargs or {}
        self._refine = refine_iters or 0
        self._s = None

    def bind(self, bound):
        """Bind to a bound graph.  A solver bound before keeps its plan
        (and its owned store) when the new graph has the same structure
        (SupernodalCholeskySolver.rebind): GNC's inner runs change only
        noise models."""
        self._orig_bound = bound
        self._w = None
        if self._method == "levels":
            if bound.num_constraints:
                raise NotImplementedError(
                    "SparseSolver(method='levels') does not support "
                    "constrained (sigma==0) noise; use the supernodal "
                    "method")
            self._s = SparseCholeskySolver(bound, order=self._order)
            self.store = None
            return self
        if bound.num_constraints:
            self._w = CONSTRAINT_WEIGHT if self._cweight is None \
                else self._cweight
            bound = _soften_constraints(bound, self._w)
        if self._s is None or not self._s.rebind(bound):
            self._s = SupernodalCholeskySolver(bound, order=self._order,
                                               **self._sn_kwargs)
            self.store = None
        return self

    def system(self, arrays):
        if self.store is None:
            self.store = self._s.new_store()
        sys_ = self._s.system(arrays, out=self.store)
        if self._method == "qr":
            sys_ = sys_ + (self._s.jacobian_pool(arrays),)
        if self._w is not None:
            return sys_ + self._orig_bound.constraint_system(arrays)
        return sys_

    def solve(self, system, lam, diagonal_damping):
        qr = self._method == "qr"
        if qr and diagonal_damping:
            raise NotImplementedError(
                "sparse QR supports plain lambda damping only")
        if self._method == "levels":
            blocks, g = system
            factored = self._s.factorize(blocks, lam)
            return self._s.solve_factored(factored, g), factored.ok
        if len(system) == 4 + qr:
            return self._solve_constrained(system, lam, diagonal_damping)
        if qr:
            return self._s.solve_qr(*system, lam, self._refine)
        blocks, g = system
        return self._s.solve_refined(blocks, g, lam, diagonal_damping,
                                     self._refine)

    def _solve_constrained(self, system, lam, diagonal_damping,
                           al_iters: int = 3):
        """Exact hard rows on the sparse path: the factorization of the
        weighted system M = H + w^2 C'C (damped; method="qr": the QR of
        the weighted rows), then al_iters passes of dx = M^-1 (g + C' nu),
        nu += w^2 (c - C dx), each contracting the constraint violation by
        ~1/w^2.  (dx, ok)."""
        blocks, g, C, c = system[:2] + system[-2:]
        if self._method == "qr":
            factored = self._s.factorize_qr(system[2], lam)
        else:
            factored = self._s.factorize(blocks, lam, diagonal_damping)
        w2 = self._w ** 2
        nu = torch.zeros_like(c)
        dx = None
        for _ in range(al_iters):
            dx = self._s.solve_factored(factored, g + self._s.pack_rhs(
                C.T @ nu))
            nu = nu + w2 * (c - C @ dx)
        return dx, factored.ok

    def predicted_decrease(self, system, dx, lam, diagonal_damping):
        """0.5 (dx'g + dx'D dx) on the block store (gain-ratio
        denominator); the supernodal Cholesky's only, as in the JAX
        package."""
        if self._method != "supernodal":
            raise NotImplementedError(
                "gain-ratio lambda policy needs the supernodal solver")
        blocks, g = system[0], system[1]
        xp = self._s.pack_rhs(dx)
        damp = self._s.damp_vec(blocks, lam, diagonal_damping)
        return 0.5 * (torch.sum(xp * g) + torch.sum(damp * xp * xp))

    def check_system(self, arrays, lam=0.0):
        """Raise IndeterminantLinearSystemError on a bad pivot (the
        supernodal Cholesky's; the JAX package checks no QR or levels
        system)."""
        if self._method == "supernodal":
            self._s.check_system(arrays, lam)


def _auto_solver(bound):
    """DenseSolver for graphs with hard rows and for systems of up to 1024
    dimensions, the supernodal sparse solver above (reference default
    MULTIFRONTAL_CHOLESKY)."""
    if bound.num_constraints or bound.layout.total_dim <= 1024:
        return DenseSolver()
    return SparseSolver()


def _bind(graph, values, solver, device):
    dev = resolve_device(device)
    values = values.to(dev)
    bound = BoundGraph(graph, values, dev)
    solver = (solver or _auto_solver(bound)).bind(bound)
    return bound, values, solver


def _read(*scalars):
    """One device-to-host copy of a few 0-d tensors, as floats."""
    return torch.stack([s.to(torch.float64) for s in scalars]).tolist()


def _make_step_fns(graph: FactorGraph, values: Values, solver=None,
                   device=None):
    bound, values, solver = _bind(graph, values, solver, device)
    layout = values.layout()

    def try_step(arrays, system, lam, diagonal_damping):
        dx, ok = solver.solve(system, lam, diagonal_damping)
        new_arrays = retract_arrays(arrays, dx, layout)
        return dx, new_arrays, bound.error(new_arrays), ok

    return bound, values, bound.error, solver.system, try_step, solver


def gauss_newton(graph: FactorGraph, initial: Values,
                 params: OptimizerParams = None, solver=None,
                 device=None) -> OptimizeResult:
    params = params or OptimizerParams()
    bound, values, error_fn, system_fn, try_step, solver_obj = \
        _make_step_fns(graph, initial, solver, device)
    arrays = values.arrays
    error = float(error_fn(arrays))
    history = [error]
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        system = system_fn(arrays)
        _, new_arrays, new_error, ok = try_step(arrays, system, 0.0, False)
        new_error, ok = _read(new_error, ok)
        if not (math.isfinite(new_error) and ok):
            if hasattr(solver_obj, "check_system"):
                solver_obj.check_system(arrays, lam=0.0)
            break
        arrays, prev, error = new_arrays, error, new_error
        history.append(error)
        if check_convergence(prev, error, params):
            converged = True
            break
    return OptimizeResult(values.replace_arrays(arrays), error, it,
                          converged, history)


def levenberg_marquardt(graph: FactorGraph, initial: Values,
                        params: LMParams = None, solver=None,
                        device=None) -> OptimizeResult:
    """Host LM loop with the "gtsam" lambda policy (tryLambda:
    LevenbergMarquardtOptimizer.cpp:121-273)."""
    params = params or LMParams()
    bound, values, error_fn, system_fn, try_step, _ = _make_step_fns(
        graph, initial, solver, device)
    arrays = values.arrays
    error = float(error_fn(arrays))
    history = [error]
    lam = params.lambda_initial
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        system = system_fn(arrays)
        accepted = False
        prev = error
        while True:
            _, new_arrays, new_error, ok = try_step(
                arrays, system, lam, params.diagonal_damping)
            new_error, ok = _read(new_error, ok)
            if ok and math.isfinite(new_error) and new_error < error:
                arrays, error = new_arrays, new_error
                lam = max(lam / params.lambda_factor,
                          params.lambda_lower_bound)
                accepted = True
                break
            lam *= params.lambda_factor
            if lam > params.lambda_upper_bound:
                break
        history.append(error)
        if not accepted:
            break
        if check_convergence(prev, error, params):
            converged = True
            break
    return OptimizeResult(values.replace_arrays(arrays), error, it,
                          converged, history)


def make_fused_lm(graph: FactorGraph, initial: Values,
                  params: LMParams = None, solver=None, device=None):
    """LM with the JAX package's make_fused_lm semantics (its lambda
    policies "gtsam", "conservative" and "gain", its tries and history),
    as a host loop: each try reads its error, the factorization's ok flag
    and (gain policy) the predicted decrease in one device-to-host copy.
    Returns fn(arrays) -> (it, arrays, error, converged, hist, tries):
    `hist` a float64 tensor (max_iterations + 1,) on the CPU, NaN past
    `it`, the others Python numbers and the final arrays on the device."""
    params = params or LMParams()
    bound, values, solver = _bind(graph, initial, solver, device)
    layout = values.layout()
    maxit = params.max_iterations
    use_gain = params.lambda_policy == "gain"
    conservative = params.lambda_policy == "conservative"
    dd = params.diagonal_damping

    def lm(arrays0):
        arrays = arrays_to(arrays0, bound.device)
        error = float(bound.error(arrays))
        hist = torch.full((maxit + 1,), math.nan, dtype=torch.float64)
        hist[0] = error
        lam, ceil, nu = params.lambda_initial, 0.0, 2.0
        it, tries, conv = 0, 0, False
        while it < maxit:
            system = solver.system(arrays)
            lam_t, accepted, rho = lam, False, 0.0
            new_arrays, new_error = arrays, error
            while not accepted and lam_t <= params.lambda_upper_bound:
                dx, ok = solver.solve(system, lam_t, dd)
                cand = retract_arrays(arrays, dx, layout)
                ne = bound.error(cand)
                if use_gain:
                    ne, okf, pred = _read(ne, ok, solver.predicted_decrease(
                        system, dx, lam_t, dd))
                else:
                    (ne, okf), pred = _read(ne, ok), 0.0
                tries += 1
                accepted = bool(okf) and math.isfinite(ne) and ne < error
                if accepted:
                    new_arrays, new_error = cand, ne
                    rho = (error - ne) / max(pred, 1e-30) if use_gain else 0.0
                else:
                    fac = max(nu, params.lambda_factor) if use_gain \
                        else params.lambda_factor
                    ceil = max(ceil, lam_t)
                    lam_t *= fac
                    nu *= 2.0
            if use_gain:
                if accepted:
                    t = 2.0 * rho - 1.0
                    dec = max(1.0 / 3.0, 1.0 - t * t * t)
                    lam = max(lam_t * dec, params.lambda_lower_bound)
                    nu = 2.0
                else:
                    lam = lam_t
            else:
                nxt = max(lam_t / params.lambda_factor,
                          params.lambda_lower_bound)
                dec_ok = (accepted and lam_t == lam and nxt > ceil) \
                    if conservative else accepted
                lam = nxt if dec_ok else lam_t
            delta = abs(error - new_error)
            converged = (new_error <= params.error_tol
                         or delta <= params.absolute_error_tol
                         or delta <= params.relative_error_tol
                         * max(error, 1e-300))
            hist[it + 1] = new_error
            it += 1
            arrays, error = new_arrays, new_error
            if not accepted or converged:
                conv = accepted and converged
                break
        return it, arrays, error, conv, hist, tries

    lm.bound, lm.solver = bound, solver
    return lm


def levenberg_marquardt_fused(graph: FactorGraph, initial: Values,
                              params: LMParams = None, solver=None,
                              device=None) -> OptimizeResult:
    """make_fused_lm run once from `initial`, as an OptimizeResult (the JAX
    package's levenberg_marquardt_fused): the history is the run's
    half-chi2 after each iteration, the values on the solver's device."""
    fn = make_fused_lm(graph, initial, params, solver, device)
    it, arrays, error, conv, hist, _ = fn(initial.arrays)
    history = [h for h in hist[:it + 1].tolist() if math.isfinite(h)]
    values = initial.to(fn.bound.device).replace_arrays(arrays)
    return OptimizeResult(values, float(error), it, bool(conv), history)


def nonlinear_conjugate_gradient(graph: FactorGraph, initial: Values,
                                 params: OptimizerParams = None,
                                 device=None) -> OptimizeResult:
    """Nonlinear CG on the manifold with Polak-Ribiere+ directions and an
    Armijo backtracking line search of up to 30 halvings, warm-started at
    twice the last step (gtsam/nonlinear/
    NonlinearConjugateGradientOptimizer.{h,cpp}: gradient + lineSearch; the
    JAX package's nonlinear_conjugate_gradient).  The tangent gradient is
    BoundGraph.error_gradient: sum_s sign A_s^T (-b) of the linearization
    plus the hard rows' penalty term (the JAX package differentiates the
    error through retract with jax.grad: the same gradient).  Each iteration
    reads the directional derivative, each line-search probe its error
    and the iteration its beta, one device-to-host copy each."""
    params = params or OptimizerParams()
    dev = resolve_device(device)
    values = initial.to(dev)
    bound = BoundGraph(graph, values, dev)
    layout = values.layout()
    arrays = values.arrays
    error = float(bound.error(arrays))
    history = [error]
    g = bound.error_gradient(arrays)
    d = -g
    converged = False
    it = 0
    step0 = 1.0
    for it in range(1, params.max_iterations + 1):
        gd, = _read(torch.dot(g, d))
        if gd >= 0:   # not a descent direction: restart with steepest descent
            d = -g
            gd, = _read(torch.dot(g, d))
            if gd >= 0:
                break
        t = step0
        for _ in range(30):
            cand = retract_arrays(arrays, t * d, layout)
            ce, = _read(bound.error(cand))
            if math.isfinite(ce) and ce <= error + 1e-4 * t * gd:
                break
            t *= 0.5
        else:
            break
        arrays, new_error = cand, ce
        step0 = min(max(t * 2.0, 1e-8), 10.0)
        g_new = bound.error_gradient(arrays)
        beta, = _read(torch.dot(g_new, g_new - g)
                      / torch.clamp(torch.dot(g, g), min=1e-300))
        d = -g_new + max(beta, 0.0) * d
        g = g_new
        prev, error = error, new_error
        history.append(error)
        if check_convergence(prev, error, params):
            converged = True
            break
    return OptimizeResult(values.replace_arrays(arrays), error, it, converged,
                          history)


def _dogleg_point(dx_gn, dx_u, n_gn, n_u, delta):
    """DoglegOptimizerImpl.h:95 ComputeDoglegPoint: the Gauss-Newton step
    inside the trust region, else the steepest-descent step cut to it, else
    the blend dx_u + tau (dx_gn - dx_u) on its boundary (tensor ops: no
    read)."""
    d = dx_gn - dx_u
    a = torch.dot(d, d)
    b = 2.0 * torch.dot(dx_u, d)
    c = torch.dot(dx_u, dx_u) - delta * delta
    disc = torch.clamp(b * b - 4 * a * c, min=0.0)
    tau = (-b + torch.sqrt(disc)) / torch.clamp(2 * a, min=1e-300)
    return torch.where(
        n_gn <= delta, dx_gn,
        torch.where(n_u >= delta, dx_u * (delta / torch.clamp(n_u, min=1e-300)),
                    dx_u + tau * d))


def dogleg(graph: FactorGraph, initial: Values, params: DoglegParams = None,
           solver=None, device=None) -> OptimizeResult:
    """Trust-region dogleg of the Gauss-Newton and steepest-descent steps
    (DoglegOptimizerImpl.h:95, 138; the JAX package's dogleg): up to 10
    tries an iteration, delta doubled at rho > 0.75 and halved below 0.25,
    a try accepted when the error falls.

    The Gauss-Newton step and the Cauchy step depend on the iteration alone,
    so each iteration factorizes once: SparseSolver (the supernodal
    Cholesky) on kernels 7 and 8 at lam = 0, one factorization an
    iteration where the JAX package factorizes again on each try (the
    kernels are deterministic: the same steps); DenseSolver by
    cholesky_ex.  Graphs with hard (constrained) rows take the exact KKT
    step of the softened system (weight 1e3) and measure the error on the
    softened graph.  Each try reads its error, predicted decrease and the
    factorization's ok in one copy.  A failed factorization (ok false)
    rejects the try as a non-finite error would and halves delta: the JAX
    package reaches the same rejection through NaN in the step, but its
    delta then changes as NaN comparisons fall."""
    params = params or DoglegParams()
    bound, values, solver = _bind(graph, initial, solver, device)
    layout = values.layout()
    constrained = bool(bound.num_constraints)
    if isinstance(solver, SparseSolver) and solver._method != "supernodal" \
            and not constrained:
        raise NotImplementedError(
            "dogleg's sparse path takes the supernodal Cholesky, not "
            f"SparseSolver(method={solver._method!r})")
    err_bound = bound
    if constrained:
        # the method-of-weighting objective drives the Cauchy leg and the
        # trust region; the GN leg is the exact KKT step
        err_bound = _soften_constraints(bound, CONSTRAINT_WEIGHT)

    def iteration(arrays):
        """(dx_gn, g, Hv, ok) of the iteration at `arrays`."""
        if constrained:
            Hs, gs = err_bound.gn_system(arrays)
            C, c = bound.constraint_system(arrays)
            dx_gn, ok = _kkt_solve(Hs, gs, C, c, 0.0, False)
            return dx_gn, gs, lambda x: Hs @ x, ok
        if isinstance(solver, SparseSolver):
            sup = solver._s
            blocks, gpad = solver.system(arrays)
            factored = sup.factorize(blocks, 0.0, False)
            return (sup.solve_factored(factored, gpad), sup._flatten(gpad),
                    lambda x: sup._flatten(sup.matvec(blocks,
                                                      sup.pack_rhs(x))),
                    factored.ok)
        H, g = solver.system(arrays)
        L, info = torch.linalg.cholesky_ex(H)
        return (torch.cholesky_solve(g[:, None], L)[:, 0], g,
                lambda x: H @ x, info == 0)

    arrays = values.arrays
    error = float(err_bound.error(arrays))
    history = [error]
    delta = params.initial_delta
    converged = False
    it = 0
    for it in range(1, params.max_iterations + 1):
        dx_gn, g, Hv, ok = iteration(arrays)
        # steepest descent: dx_u = alpha g, alpha = g'g / g'Hg
        gHg = torch.dot(g, Hv(g))
        alpha = torch.where(gHg > 0, torch.dot(g, g)
                            / torch.clamp(gHg, min=1e-300), 0.0)
        dx_u = alpha * g
        n_gn, n_u = torch.linalg.norm(dx_gn), torch.linalg.norm(dx_u)
        prev = error
        accepted = False
        for _ in range(10):
            dx = _dogleg_point(dx_gn, dx_u, n_gn, n_u, delta)
            new_arrays = retract_arrays(arrays, dx, layout)
            # the linear model's decrease g'dx - 0.5 dx'H dx
            new_error, pred, okf = _read(err_bound.error(new_arrays),
                                         torch.dot(g, dx)
                                         - 0.5 * torch.dot(dx, Hv(dx)), ok)
            if not okf:
                new_error, rho = math.nan, -1.0
            else:
                rho = (error - new_error) / pred if pred > 0 else -1.0
            if rho > 0.75:
                delta = min(2 * delta, 1e10)
            elif rho < 0.25:
                delta = delta / 2.0
            if math.isfinite(new_error) and new_error < error:
                arrays, error = new_arrays, new_error
                accepted = True
                break
            if delta < 1e-10:
                break
        history.append(error)
        if not accepted:
            break
        if check_convergence(prev, error, params):
            converged = True
            break
    return OptimizeResult(values.replace_arrays(arrays), error, it, converged,
                          history)
