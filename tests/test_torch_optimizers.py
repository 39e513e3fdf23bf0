"""Parity of gtsam_torch's dogleg, nonlinear CG, fused-LM wrapper, dense QR
and sparse gradient with gtsam_tpu's (CPU).

The JAX side runs float64 (tests/conftest.py turns x64 on); the torch side
float64 on the CPU, where every kernel wrapper computes its plain PyTorch
version.  Inputs are made with numpy from seeds and handed to both
packages.  Graphs: a 6-ring x 8-pose sphere (scripts/port_sphere_data.py)
with bench.py's prior (SE3, D = 288) and a 60-pose Manhattan world
(scripts/port_2d_data.py, 150 edges) with a prior on pose 0 (SE2, D =
180); their hard-prior variants (the prior's noise constrained); a graph
mixing SE3 poses with Point3 landmarks through a custom factor (the
generic linearization).  Tolerances, each stated where it is used.
"""

import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_tpu.base import losses as jlosses
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.geometry import se3 as jse3
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.graph.values import retract_arrays as jretract
from gtsam_tpu.io import datasets as jdatasets
from gtsam_tpu.linear.exceptions import (
    IndeterminantLinearSystemError as JIndeterminant)
from gtsam_tpu.optimize import optimizers as JO
from gtsam_tpu.slam.initialize import initialize_pose2_lago as jlago
from gtsam_tpu.slam.initialize import initialize_pose3_chordal as jchordal

from gtsam_torch import _kernels
from gtsam_torch.base import losses as tlosses
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se3
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.graph.values import retract_arrays as tretract
from gtsam_torch.io import datasets as tdatasets
from gtsam_torch.linear.exceptions import IndeterminantLinearSystemError
from gtsam_torch.optimize import optimizers as TO
from gtsam_torch.slam.initialize import (initialize_pose2_lago,
                                         initialize_pose3_chordal)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SN_KW = dict(force_width=4, max_width=8)
PRIOR = {"SE3": [[1e-3] * 3 + [1e-2] * 3], "SE2": [[1e-3, 1e-3, 1e-4]]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.abs(ref).max(), 1e-300))


def _graphs(group, tmp, hard=False):
    """(JAX graph, JAX start, torch graph, torch start) of the small sphere
    (SE3, chordal start) or the Manhattan world (SE2, LAGO start); `hard`:
    the prior's noise constrained in every row."""
    if group == "SE3":
        path = os.path.join(tmp, "sphere.g2o")
        _script("port_sphere_data").write_sphere_g2o(
            path, laps=6, per_lap=8, radius=10.0, sigma_t=0.1, sigma_r=0.05,
            seed=1)
        jg, _ = jdatasets.load_3d(path)
        tg, _ = tdatasets.load_3d(path)
        jz = gt.SE3(np.eye(3)[None], np.zeros((1, 3)))
        tz = SE3(np.eye(3)[None], np.zeros((1, 3)))
    else:
        path = os.path.join(tmp, "manhattan.graph")
        _script("port_2d_data").write_manhattan_graph(path, 60, 150, seed=3)
        jg, jv = jdatasets.load_2d(path)
        tg, tv = tdatasets.load_2d(path)
        jz, tz = np.asarray(jv.at(0))[None], tv.at(0)[None].numpy()
    r = 6 if group == "SE3" else 3
    jn = jnoise.constrained_all(r) if hard else jnoise.sigmas(PRIOR[group])
    tn = tnoise.constrained_all(r) if hard else tnoise.sigmas(PRIOR[group])
    jg.add(gt.prior_factors(group, [0], jz, jn))
    tg.add(tfactors.prior_factors(group, [0], tz, tn))
    if group == "SE3":
        return jg, jchordal(jg), tg, initialize_pose3_chordal(tg)
    # LAGO of the soft-prior graph: the hard prior's start is the same
    jl = jlago(jg) if not hard else None
    return jg, jl, tg, initialize_pose2_lago(tg) if not hard else None


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """Each graph of the file, built once: {(group, hard): graphs}."""
    tmp = str(tmp_path_factory.mktemp("opt"))
    out = {}
    for group in ("SE3", "SE2"):
        out[group, False] = _graphs(group, tmp)
        jg, _, tg, _ = _graphs(group, tmp, hard=True)
        _, jv, _, tv = out[group, False]
        out[group, True] = (jg, jv, tg, tv)
    return out


def _mixed():
    """SE3 poses and Point3 landmarks joined by a pose-frame landmark
    factor (the generic linearization), SE3 between factors and a prior."""
    rng = np.random.default_rng(3)
    n_pose, n_pt = 6, 5
    T = se3.expmap(torch.as_tensor(rng.normal(size=(n_pose, 6))
                                   * np.array([0.3] * 3 + [2.0] * 3)))
    R, tr = T.R.numpy(), T.t.numpy()
    pts = rng.normal(size=(n_pt, 3)) * 3.0
    i = np.arange(n_pose - 1)
    Rij = np.einsum("nji,njk->nik", R[i], R[i + 1])
    tij = np.einsum("nji,nj->ni", R[i], tr[i + 1] - tr[i])
    op = np.arange(2 * n_pt) % n_pose
    ol = np.arange(2 * n_pt) // 2
    z = np.einsum("nji,nj->ni", R[op], pts[ol] - tr[op])
    z = z + rng.normal(size=z.shape) * 0.1
    T0 = se3.retract(T, torch.as_tensor(rng.normal(size=(n_pose, 6)) * 0.05))
    pts0 = pts + rng.normal(size=pts.shape) * 0.2
    info = np.diag([400.0] * 3 + [100.0] * 3)
    jg = JGraph()
    jg.add(jfactors.between_factors("SE3", i, i + 1, gt.SE3(
        jnp.asarray(Rij), jnp.asarray(tij)), jnoise.information(info)))
    jg.add(gt.prior_factors("SE3", [0], gt.SE3(np.eye(3)[None],
                                               np.zeros((1, 3))),
                            jnoise.sigmas(PRIOR["SE3"])))
    jg.add(jfactors.custom_factors(
        "Obs", ("SE3", "Point3"), np.stack([op, ol + 100], 1),
        lambda xs, m: jse3.transform_to(xs[0], xs[1]) - m, 3,
        jnp.asarray(z), jnoise.isotropic(3, 0.1)))
    jv = JValues({"SE3": gt.SE3(jnp.asarray(T0.R.numpy()),
                                jnp.asarray(T0.t.numpy())),
                  "Point3": jnp.asarray(pts0)},
                 {"SE3": np.arange(n_pose), "Point3": np.arange(n_pt) + 100})
    tg = FactorGraph()
    tg.add(tfactors.between_factors("SE3", i, i + 1, SE3(Rij, tij),
                                    tnoise.information(info)))
    tg.add(tfactors.prior_factors("SE3", [0], SE3(np.eye(3)[None],
                                                  np.zeros((1, 3))),
                                  tnoise.sigmas(PRIOR["SE3"])))
    tg.add(tfactors.FactorBatch(
        "Obs", ("SE3", "Point3"), np.stack([op, ol + 100], 1), 3,
        lambda xs, m: se3.transform_to(xs[0], xs[1]) - m,
        torch.as_tensor(z), tnoise.isotropic(3, 0.1)))
    tv = Values({"SE3": T0, "Point3": torch.as_tensor(pts0)},
                {"SE3": np.arange(n_pose), "Point3": np.arange(n_pt) + 100})
    return jg, jv, tg, tv


def _solvers(kind):
    if kind == "dense":
        return JO.DenseSolver(), TO.DenseSolver()
    return (JO.SparseSolver(supernodal_kwargs=SN_KW),
            TO.SparseSolver(supernodal_kwargs=SN_KW))


# -- dogleg -------------------------------------------------------------------

DOGLEG = dict(max_iterations=20, relative_error_tol=1e-9,
              absolute_error_tol=1e-12)


@pytest.mark.parametrize("group", ["SE3", "SE2"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_dogleg(graphs, group, kind):
    """dogleg with DenseSolver and SparseSolver against the JAX package's:
    the same iterations and convergence, the history at 1e-9 relative (the
    same steps; the port factorizes once an iteration where the JAX
    package factorizes on each try)."""
    jg, jv, tg, tv = graphs[group, False]
    js, ts = _solvers(kind)
    jr = JO.dogleg(jg, jv, JO.DoglegParams(**DOGLEG), solver=js)
    tr = TO.dogleg(tg, tv, TO.DoglegParams(**DOGLEG), solver=ts,
                   device="cpu")
    assert (tr.iterations, tr.converged) == (jr.iterations, jr.converged)
    assert _rel(tr.history, jr.history) <= 1e-9
    assert tr.error < tr.history[0]


@pytest.mark.parametrize("group", ["SE3", "SE2"])
def test_dogleg_constrained(graphs, group):
    """dogleg on a graph with a hard prior (the exact KKT step on the
    softened system, the error of the softened graph) against the JAX
    package's: the same iterations, the history at 1e-9 relative, and the
    prior exact at the end to 1e-9."""
    jg, jv, tg, tv = graphs[group, True]
    jr = JO.dogleg(jg, jv, JO.DoglegParams(**DOGLEG))
    tr = TO.dogleg(tg, tv, TO.DoglegParams(**DOGLEG), device="cpu")
    assert tr.iterations == jr.iterations
    assert _rel(tr.history, jr.history) <= 1e-9
    _, c = BoundGraph(tg, tr.values, "cpu").constraint_system(
        tr.values.arrays)
    assert float(c.abs().max()) <= 1e-9


def test_dogleg_rejects_a_failed_factorization(graphs):
    """The port's documented divergence: a factorization whose ok is false
    rejects the try (as a non-finite error) and halves delta.  Without its
    prior the sphere's Cholesky at lam = 0 fails every try: dogleg stops
    after ten tries of its first iteration, the values unmoved."""
    _, _, tg, tv = graphs["SE3", False]
    free = FactorGraph([b for b in tg.batches if b.arity == 2])
    res = TO.dogleg(free, tv, TO.DoglegParams(**DOGLEG),
                    solver=TO.SparseSolver(supernodal_kwargs=SN_KW),
                    device="cpu")
    assert res.iterations == 1 and not res.converged
    assert res.history == [res.history[0]] * 2
    assert torch.equal(res.values.arrays["SE3"].t, tv.arrays["SE3"].t)


def test_dogleg_refuses_the_sparse_qr(graphs):
    _, _, tg, tv = graphs["SE2", False]
    with pytest.raises(NotImplementedError):
        TO.dogleg(tg, tv, solver=TO.SparseSolver(method="qr"), device="cpu")


# -- nonlinear CG and the sparse gradient ---------------------------------------

@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("group", ["SE3", "SE2"])
def test_nonlinear_conjugate_gradient(graphs, group, hard):
    """nonlinear_conjugate_gradient for 15 iterations against the JAX
    package's (its gradient by jax.grad through retract, the port's from
    the linearization and the hard rows' penalty): the same iterations and
    history at 1e-9 relative, and a history that never rises; `hard`: the
    graph with the hard prior, whose penalty 0.5 mu r^2 the error holds."""
    jg, jv, tg, tv = graphs[group, hard]
    p = dict(max_iterations=15, relative_error_tol=0.0,
             absolute_error_tol=0.0)
    jr = JO.nonlinear_conjugate_gradient(jg, jv, JO.OptimizerParams(**p))
    tr = TO.nonlinear_conjugate_gradient(tg, tv, TO.OptimizerParams(**p),
                                         device="cpu")
    assert tr.iterations == jr.iterations
    assert _rel(tr.history, jr.history) <= 1e-9
    assert all(b <= a for a, b in zip(tr.history, tr.history[1:]))


def _jax_grad(jg, jv):
    bound = jg.bind(jv)
    layout = jv.layout()
    zero = jnp.zeros(layout.total_dim)
    return np.asarray(jax.grad(lambda dx: bound.error(
        jretract(jv.arrays, dx, layout)))(zero))


# The sparse gradient's closed-form Jacobians (kernel 6's) against autodiff
# through the closed-form SO(3) coefficients, which loses ~eps / theta^2 at
# the sphere's small residual angles (test_torch_posegraph.py::test_system
# holds g at 1e-11 for the same reason): 1e-11 on the sphere's SE3 factors,
# 1e-12 elsewhere.
GRAD_TOL = {"SE3": 1e-11, "robust": 1e-11, "hard_SE3": 1e-11}


def _moved(jv, tv, seed):
    """Both packages' values moved by one seeded tangent step (0.05 scale),
    so that a hard prior is violated."""
    layout = tv.layout()
    dx = 0.05 * np.random.default_rng(seed).normal(size=layout.total_dim)
    return (jv.replace_arrays(jretract(jv.arrays, jnp.asarray(dx),
                                       jv.layout())),
            tv.replace_arrays(tretract(tv.arrays, torch.as_tensor(dx), layout)))


@pytest.mark.parametrize("which", ["SE3", "SE2", "mixed", "robust",
                                   "hard_SE3", "hard_SE2"])
def test_gradient_against_jax_grad(graphs, which):
    """BoundGraph.error_gradient (NCG's: kernel 6's gradient rows and its
    assembly's g half, or the generic linearization for the custom factor,
    no dense H; and the hard rows' penalty term) against jax.grad of the
    JAX package's error through retract at zero, at GRAD_TOL relative;
    "robust": the sphere's between factors under Huber (IRLS's gradient is
    the robust error's); "hard_*": the graph with the hard prior at values
    that violate it, where error_gradient adds the penalty's sign mu C^T r
    to gradient (-g of the normal equations)."""
    if which == "mixed":
        jg, jv, tg, tv = _mixed()
    elif which.startswith("hard_"):
        jg, jv, tg, tv = graphs[which[5:], True]
        jv, tv = _moved(jv, tv, seed=7)
    else:
        jg, jv, tg, tv = graphs["SE3" if which == "robust" else which, False]
    if which == "robust":
        jg = JGraph([dataclasses.replace(b, noise=jnoise.robust(
            b.noise, jlosses.huber(0.5))) if b.arity == 2 else b
            for b in jg.batches])
        tg = FactorGraph([dataclasses.replace(b, noise=tnoise.robust(
            b.noise, tlosses.huber(0.5))) if b.arity == 2 else b
            for b in tg.batches])
    bound = BoundGraph(tg, tv, "cpu")
    g = bound.error_gradient(tv.arrays)
    tol = GRAD_TOL.get(which, 1e-12)
    assert _rel(g, _jax_grad(jg, jv)) <= tol
    # gradient: -g of the dense normal equations (the port's generic
    # linearization: torch.func.jacfwd); error_gradient: the same vector
    # plus the hard rows' penalty gradient mu C^T r (c = -r)
    ref = -bound.gn_system(tv.arrays)[1]
    assert _rel(bound.gradient(tv.arrays), ref) <= tol
    if which.startswith("hard_"):
        C, c = bound.constraint_system(tv.arrays)
        assert float(c.abs().max()) > 1e-3
        ref = ref - 1000.0 * C.T @ c
    assert _rel(g, ref) <= tol


def test_gradient_on_the_cpu_launches_nothing(graphs):
    _, _, tg, tv = graphs["SE3", False]
    _kernels.reset_launch_counts()
    BoundGraph(tg, tv, "cpu").gradient(tv.arrays)
    assert not any(_kernels.launch_counts().values())


# -- the fused-LM wrapper -------------------------------------------------------

@pytest.mark.parametrize("group,kind,policy", [
    ("SE3", "sparse", "gain"), ("SE3", "dense", "gtsam"),
    ("SE2", "sparse", "conservative")])
def test_levenberg_marquardt_fused(graphs, group, kind, policy):
    """levenberg_marquardt_fused against the JAX package's: the same
    iterations and convergence, the history at 1e-10 relative, the values
    at 1e-8 of their largest entry."""
    jg, jv, tg, tv = graphs[group, False]
    js, ts = _solvers(kind)
    p = dict(max_iterations=10, relative_error_tol=1e-9,
             absolute_error_tol=1e-12, lambda_policy=policy)
    jr = JO.levenberg_marquardt_fused(jg, jv, JO.LMParams(**p), solver=js)
    tr = TO.levenberg_marquardt_fused(tg, tv, TO.LMParams(**p), solver=ts,
                                      device="cpu")
    assert (tr.iterations, tr.converged) == (jr.iterations, jr.converged)
    assert _rel(tr.history, jr.history) <= 1e-10
    assert tr.error == tr.history[-1]
    a = tr.values.arrays[group]
    b = jr.values.arrays[group]
    if group == "SE3":
        a, b = a.t, b.t
    assert _rel(a, b) <= 1e-8


# -- the dense QR ----------------------------------------------------------------

@pytest.mark.parametrize("group", ["SE3", "SE2"])
def test_dense_qr_gauss_newton(graphs, group):
    """gauss_newton with DenseQRSolver against the JAX package's: the same
    iterations, the history at 1e-10 relative; and one damped solve's
    step against the dense (H + lam I)^-1 g at 1e-10."""
    jg, jv, tg, tv = graphs[group, False]
    p = dict(max_iterations=8)
    jr = JO.gauss_newton(jg, jv, JO.OptimizerParams(**p),
                         solver=JO.DenseQRSolver())
    tr = TO.gauss_newton(tg, tv, TO.OptimizerParams(**p),
                         solver=TO.DenseQRSolver(), device="cpu")
    assert tr.iterations == jr.iterations
    assert _rel(tr.history, jr.history) <= 1e-10
    bound = BoundGraph(tg, tv, "cpu")
    ts = TO.DenseQRSolver().bind(bound)
    dx, ok = ts.solve(ts.system(tv.arrays), 1e-3, False)
    H, g = bound.gn_system(tv.arrays)
    ref = torch.linalg.solve(H + 1e-3 * torch.eye(H.shape[0],
                                                  dtype=torch.float64), g)
    assert bool(ok)
    assert _rel(dx, ref) <= 1e-10


@pytest.mark.parametrize("group", ["SE3", "SE2"])
def test_dense_qr_rank_deficient_raises(graphs, group):
    """Without its prior the graph's gauge is free: gauss_newton with
    DenseQRSolver raises IndeterminantLinearSystemError naming the column
    the JAX package names."""
    jg, jv, tg, tv = graphs[group, False]
    jfree = JGraph([b for b in jg.batches if b.arity == 2])
    tfree = FactorGraph([b for b in tg.batches if b.arity == 2])
    with pytest.raises(JIndeterminant) as je:
        JO.gauss_newton(jfree, jv, solver=JO.DenseQRSolver())
    with pytest.raises(IndeterminantLinearSystemError) as te:
        TO.gauss_newton(tfree, tv, solver=TO.DenseQRSolver(), device="cpu")
    assert str(te.value) == str(je.value)
    with pytest.raises(NotImplementedError):
        TO.DenseQRSolver().bind(BoundGraph(tg, tv, "cpu")).solve(
            (None, None), 1e-3, True)


@pytest.mark.parametrize("group", ["SE3", "SE2"])
def test_dense_qr_constrained(graphs, group):
    """A hard prior under DenseQRSolver (QR of the weighted rows and three
    augmented-Lagrangian passes over R): gauss_newton's history against the
    JAX package's at 1e-9 relative, and the prior exact at the end to
    1e-9."""
    jg, jv, tg, tv = graphs[group, True]
    p = dict(max_iterations=6)
    jr = JO.gauss_newton(jg, jv, JO.OptimizerParams(**p),
                         solver=JO.DenseQRSolver())
    tr = TO.gauss_newton(tg, tv, TO.OptimizerParams(**p),
                         solver=TO.DenseQRSolver(), device="cpu")
    assert tr.iterations == jr.iterations
    assert _rel(tr.history, jr.history) <= 1e-9
    _, c = BoundGraph(tg, tr.values, "cpu").constraint_system(
        tr.values.arrays)
    assert float(c.abs().max()) <= 1e-9
    assert math.isfinite(tr.error)
