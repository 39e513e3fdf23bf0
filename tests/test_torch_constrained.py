"""Parity of gtsam_torch's constrained (sigma == 0) noise with gtsam_tpu's (CPU).

Hard rows are exact equality constraints: the dense solver eliminates them
through a KKT solve, the sparse one by the method of weighting and three
augmented-Lagrangian passes, as in the JAX package.  The JAX side runs
float64 (tests/conftest.py turns x64 on); the torch side float64 on the
CPU, where kernel 6's wrappers compute their plain versions.  Tolerances,
each stated where it is used.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.io import datasets as jdatasets
from gtsam_tpu.optimize import optimizers as JO
from gtsam_tpu.slam.initialize import initialize_pose3_chordal as jchordal

from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se3
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.io import datasets as tdatasets
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.optimize import optimizers as TO
from gtsam_torch.slam.initialize import initialize_pose3_chordal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, ref, rtol):
    """rtol against each entry, atol rtol x the largest entry."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _jse3(T):
    return gt.SE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy()))


SIGMAS = [[0.0, 0.5, 0.0, 2.0, 0.1, 1.0]]


@pytest.mark.parametrize("scope", ["shared", "per-factor", "all"])
def test_constrained_whiten_and_error(scope):
    """whiten, whiten_jacobian and error of constrained models (hard rows
    weight 0 when whitening; the error adds 0.5 mu r^2 on them) against
    the JAX package's: 1e-13."""
    rng = np.random.default_rng(1)
    r = rng.normal(size=(4, 6)) * 3.0
    A = rng.normal(size=(4, 6, 5))
    s = np.array(SIGMAS * 4)
    s[2, 1] = 0.0
    make = {"shared": lambda m: m.constrained(SIGMAS, mu=50.0),
            "per-factor": lambda m: m.constrained(s),
            "all": lambda m: m.constrained_all(6, mu=7.0)}[scope]
    tm, jm = make(tnoise), make(jnoise)
    assert tm.kind == "constrained" and tm.mu == jm.mu
    _close(tm.whiten(_t(r)), jm.whiten(jnp.asarray(r)), 1e-13)
    _close(tm.whiten_jacobian(_t(A)), jm.whiten_jacobian(jnp.asarray(A)),
           1e-13)
    _close(tm.error(_t(r)), jm.error(jnp.asarray(r)), 1e-13)
    assert tm.to("cpu").mu == tm.mu


def test_robust_loss_on_constrained_noise_raises():
    """A robust loss on a constrained model is refused by both packages,
    and kernel 6's wrappers refuse the combination too."""
    with pytest.raises(NotImplementedError):
        jnoise.robust(jnoise.constrained_all(6), "huber")
    with pytest.raises(NotImplementedError):
        tnoise.robust(tnoise.constrained_all(6), "huber")
    with pytest.raises(NotImplementedError):
        tnoise.constrained_all(6).with_loss("cauchy")
    meta = [torch.empty(s, dtype=d, device="meta") for s, d in (
        ((3, 3, 3), torch.float64), ((3, 3), torch.float64),
        ((2, 2), torch.int32), ((2, 3, 3), torch.float64),
        ((2, 3), torch.float64), ((1, 6), torch.float64))]
    with pytest.raises(ValueError, match="robust loss on constrained"):
        K.pg_error(*meta[:5], "constrained", meta[5], 1.0, 3, 1.0)


def _chain(mods, seed=3, n=7):
    """An SE3 chain: a hard prior on pose 0 (rows 0 and 3 hard, the rest
    soft), odometry, and a per-factor constrained between (one hard row in
    one factor); (graph, values) for each of `mods`."""
    rng = np.random.default_rng(seed)
    T = se3.expmap(_t(rng.normal(size=(n, 6)) * np.array([0.3] * 3
                                                          + [2.0] * 3)))
    i = np.arange(n - 1)
    Z = se3.compose(se3.between(SE3(T.R[i], T.t[i]),
                                SE3(T.R[i + 1], T.t[i + 1])),
                    se3.expmap(_t(rng.normal(size=(n - 1, 6)) * 0.05)))
    P = se3.compose(SE3(T.R[:1], T.t[:1]),
                    se3.expmap(_t(rng.normal(size=(1, 6)) * 0.1)))
    ci, cj = np.array([0, 2]), np.array([4, 6])
    Zc = se3.between(SE3(T.R[ci], T.t[ci]), SE3(T.R[cj], T.t[cj]))
    sc = np.full((2, 6), 0.2)
    sc[1, 5] = 0.0
    T0 = se3.retract(T, _t(rng.normal(size=(n, 6)) * 0.1))
    out = []
    for noise, fac, cv, vals in mods:
        g = FactorGraph() if cv is None else JGraph()
        c = cv or (lambda x: x)
        g.add(fac.prior_factors("SE3", [0], c(P), noise.constrained(
            [[0.0, 0.1, 0.1, 0.0, 0.2, 0.2]])))
        g.add(fac.between_factors("SE3", i, i + 1, c(Z),
                                  noise.isotropic(6, 0.1)))
        g.add(fac.between_factors("SE3", ci, cj, c(Zc),
                                  noise.constrained(sc)))
        out.append((g, vals({"SE3": c(T0)}, {"SE3": np.arange(n)})))
    return out


TORCH_SIDE = (tnoise, tfactors, None, Values)
JAX_SIDE = (jnoise, jfactors, _jse3, JValues)


def test_constraint_system_and_gradient():
    """BoundGraph.num_constraints and constraint_system (C, c of the hard
    rows, by the generic linearization) against the JAX package's at
    1e-12 (both from forward-mode Jacobians of the same residuals); the
    error with its mu penalty at 1e-12 (kernel 6's plain error for the SE3
    batches); gradient (-g of gn_system) at 1e-12."""
    (tg, tv), (jg, jv) = _chain((TORCH_SIDE, JAX_SIDE))
    tb, jb = BoundGraph(tg, tv, "cpu"), jg.bind(jv)
    assert tb.num_constraints == jb.num_constraints == 3
    n0 = tfactors.CONSTRAINT_LINEARIZATIONS[0]
    C, c = tb.constraint_system(tv.arrays)
    assert tfactors.CONSTRAINT_LINEARIZATIONS[0] == n0 + 2
    jC, jc = jb.constraint_system(jv.arrays)
    _close(C, jC, 1e-12)
    _close(c, jc, 1e-12)
    _close(tb.error(tv.arrays), jb.error(jv.arrays), 1e-12)
    _close(tb.gradient(tv.arrays), jb.gradient(jv.arrays), 1e-12)


def test_kernel6_plain_versions_under_constrained_noise():
    """Kernel 6's plain versions of a constrained SE3 batch against the
    JAX package: pg_jacobians_plain's A and b (hard rows zero) against
    factors.linearize, and pg_error_plain (0.5 ||R_w r||^2 + 0.5 mu r^2 on
    the hard rows) against the noise model's error of the JAX residuals:
    1e-12."""
    (tg, tv), (jg, jv) = _chain((TORCH_SIDE, JAX_SIDE), seed=5)
    tb = BoundGraph(tg, tv, "cpu")
    T = tv.arrays["SE3"]
    for bi in (0, 2):
        b, st, jbatch = tg.batches[bi], tb.structures[bi], jg.batches[bi]
        assert tfactors.kernel_route(b) is not None
        rows = st.rows_i32
        args = (T.R, T.t, rows, b.measurements.R, b.measurements.t,
                b.noise.kind, b.noise.data)
        jxs = tuple(gt.SE3(jnp.asarray(T.R.numpy()[rows[:, s].numpy()]),
                           jnp.asarray(T.t.numpy()[rows[:, s].numpy()]))
                    for s in range(b.arity))
        A, bv = K.pg_jacobians_plain(*args)
        jA, jbv = jfactors.linearize(jbatch, jxs)
        for a, ja in zip(A, jA):
            _close(a, ja, 1e-12)
        _close(bv, jbv, 1e-12)
        err = K.pg_error_plain(*args, -1.0, 0, 0.0, b.noise.mu)
        ref = -jbatch.noise.error(jfactors.residuals(jbatch, jxs))
        _close(err, ref, 1e-12)


def test_dense_kkt_lm():
    """levenberg_marquardt and gauss_newton on the chain with the auto
    solver (DenseSolver's KKT solve: constrained graphs always take it)
    against the JAX package's: iterations and the history at 1e-9; the
    hard rows of the prior hold to 1e-9."""
    (tg, tv), (jg, jv) = _chain((TORCH_SIDE, JAX_SIDE), seed=7)
    assert isinstance(TO._auto_solver(BoundGraph(tg, tv, "cpu")),
                      TO.DenseSolver)
    p = dict(max_iterations=10, relative_error_tol=1e-9,
             absolute_error_tol=1e-12)
    for jf, tf_, P in ((JO.levenberg_marquardt, TO.levenberg_marquardt,
                        "LMParams"),
                       (JO.gauss_newton, TO.gauss_newton,
                        "OptimizerParams")):
        jres = jf(jg, jv, getattr(gt, P)(**p))
        tres = tf_(tg, tv, getattr(TO, P)(**p), device="cpu")
        assert tres.iterations == jres.iterations
        _close(tres.history, jres.history, 1e-9)
        prior = tg.batches[0]
        r = tfactors.residuals(prior, (SE3(
            tres.values.arrays["SE3"].R[:1], tres.values.arrays["SE3"].t[:1]),))
        assert float(torch.abs(r[0, [0, 3]]).max()) <= 1e-9


def _sphere(tmp, mods):
    """The 6 x 8 sphere of scripts/port_sphere_data.py with a hard prior
    on pose 0 (noise.constrained_all(6)), chordal-initialized, for each of
    `mods` ("t" or "j")."""
    spec = importlib.util.spec_from_file_location(
        "port_sphere_data", os.path.join(REPO, "scripts",
                                         "port_sphere_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    path = os.path.join(tmp, "sphere.g2o")
    mod.write_sphere_g2o(path, laps=6, per_lap=8, radius=10.0, sigma_t=0.1,
                         sigma_r=0.05, seed=1)
    out = {}
    if "j" in mods:
        jg, _ = jdatasets.load_3d(path)
        jg.add(gt.prior_factors("SE3", [0], gt.SE3(np.eye(3)[None],
                                                   np.zeros((1, 3))),
                                jnoise.constrained_all(6)))
        out["j"] = (jg, jchordal(jg))
    if "t" in mods:
        tg, _ = tdatasets.load_3d(path)
        tg.add(tfactors.prior_factors("SE3", [0], SE3(np.eye(3)[None],
                                                      np.zeros((1, 3))),
                                      tnoise.constrained_all(6)))
        out["t"] = (tg, initialize_pose3_chordal(tg))
    return out


def test_sparse_constrained_solve(tmp_path):
    """One constrained step on the sphere: SparseSolver (method of
    weighting at w = 1e3, three augmented-Lagrangian passes over one
    factorization) against the dense KKT solve of the same system and
    against the JAX package's SparseSolver: dx at 1e-9 relative to its
    largest entry (the passes leave the KKT point ~1/w^2 per pass away
    from exact, and the two factorizations round differently), the hard
    rows C dx = c to 1e-9."""
    d = _sphere(str(tmp_path), "tj")
    (tg, tv), (jg, jv) = d["t"], d["j"]
    sn = dict(force_width=4, max_width=8)
    tb = BoundGraph(tg, tv, "cpu")
    ts = TO.SparseSolver(supernodal_kwargs=sn).bind(tb)
    sys_ = ts.system(tv.arrays)
    assert len(sys_) == 4
    dx, ok = ts.solve(sys_, 1e-3, False)
    assert bool(ok)
    ds = TO.DenseSolver().bind(tb)
    ddx, dok = ds.solve(ds.system(tv.arrays), 1e-3, False)
    assert bool(dok)
    _close(dx, ddx, 1e-9)
    C, c = sys_[2], sys_[3]
    assert float(torch.abs(C @ dx - c).max()) <= 1e-9
    js = JO.SparseSolver(supernodal_kwargs=sn).bind(jg.bind(jv))
    jdx = js.solve(js.system(jv.arrays), 1e-3, False)
    _close(dx, jdx, 1e-9)


def test_fused_lm_with_a_hard_prior(tmp_path):
    """make_fused_lm (SparseSolver, gain policy) on the sphere with a hard
    prior against the JAX package's: iterations, tries and convergence
    equal, the history at 1e-9; ||Local(prior, x0)|| <= 1e-9; only the
    constrained batch's hard rows take the generic linearization."""
    d = _sphere(str(tmp_path), "tj")
    (tg, tv), (jg, jv) = d["t"], d["j"]
    p = dict(max_iterations=10, relative_error_tol=1e-9,
             absolute_error_tol=1e-12, lambda_policy="gain")
    sn = dict(force_width=4, max_width=8)
    jit, _, jerr, jconv, jhist, jtries = JO.make_fused_lm(
        jg, jv, gt.LMParams(**p), solver=JO.SparseSolver(
            refine_iters=1, supernodal_kwargs=sn))(jv.arrays)
    tfactors.GENERIC_LINEARIZATIONS[0] = 0
    n0 = tfactors.CONSTRAINT_LINEARIZATIONS[0]
    fn = TO.make_fused_lm(tg, tv, TO.LMParams(**p), solver=TO.SparseSolver(
        refine_iters=1, supernodal_kwargs=sn), device="cpu")
    it, arrays, err, conv, hist, tries = fn(tv.arrays)
    assert (it, tries, conv) == (int(jit), int(jtries), bool(jconv))
    assert it >= 2
    _close(hist[:it + 1], np.asarray(jhist)[:it + 1], 1e-9)
    assert tfactors.GENERIC_LINEARIZATIONS[0] == 0
    assert tfactors.CONSTRAINT_LINEARIZATIONS[0] - n0 == it
    x0 = SE3(arrays["SE3"].R[:1], arrays["SE3"].t[:1])
    local = se3.local(SE3(torch.eye(3, dtype=torch.float64)[None],
                          torch.zeros((1, 3), dtype=torch.float64)), x0)
    assert float(torch.linalg.norm(local)) <= 1e-9
