"""Parity of gtsam_torch's robust losses, IRLS and GNC with gtsam_tpu's (CPU).

The JAX side runs float64 (tests/conftest.py turns x64 on); the torch side
runs float64 on the CPU, where kernel 6's wrappers compute their plain
versions.  Inputs are made with numpy from seeds and handed to both
packages.  Tolerances, each stated where it is used.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_tpu.base import losses as jlosses
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.optimize import gnc as jgnc
from gtsam_tpu.optimize import optimizers as JO

from gtsam_torch import _kernels
from gtsam_torch.base import losses as tlosses
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se3
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.optimize import gnc as tgnc
from gtsam_torch.optimize import optimizers as TO

# a non-default parameter of each loss (the thresholds sit where the
# distances below put values on both sides)
PARAMS = {"null": None, "fair": 0.7, "huber": 1.5, "cauchy": 0.4,
          "tukey": 2.5, "welsch": 1.2, "geman_mcclure": 0.8, "dcs": 2.0,
          "l2_with_dead_zone": 0.9}


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


def _loss(mod, name):
    fn = mod.LOSSES[name]
    return fn() if PARAMS[name] is None else fn(PARAMS[name])


def _branch_points(name):
    """0, tiny, the threshold exactly and one ulp on each side of it, and
    points well inside and far beyond (the dcs threshold is on d^2)."""
    c = PARAMS[name] or 1.0
    th = np.sqrt(c) if name == "dcs" else c
    return np.array([0.0, 1e-12, 0.3 * th, np.nextafter(th, 0.0), th,
                     np.nextafter(th, np.inf), 1.7 * th, 40.0 * th, 1e6])


@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_loss_weight_and_rho_at_branch_points(name):
    """Each loss's weight(d) and loss(d) against the JAX package's at its
    branch points, at 1e-14 relative to each value (the same formulas; an
    ulp of difference in pow or log1p)."""
    d = _branch_points(name)
    tl, jl = _loss(tlosses, name), _loss(jlosses, name)
    for f in ("weight", "loss"):
        got = getattr(tl, f)(_t(d))
        ref = np.asarray(getattr(jl, f)(jnp.asarray(d)))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=0.0)
    assert tlosses.kernel_code(tl) == (tlosses.CODES[name],
                                       float(PARAMS[name] or 0.0))
    back = tlosses.from_code(*tlosses.kernel_code(tl))
    assert torch.equal(back.weight(_t(d)), tl.weight(_t(d)))


def test_a_loss_of_the_users_own_has_no_kernel_code():
    """A Loss of callables of the user's own (even under a built-in name)
    goes the generic way: kernel_code gives None, and kernel_route sends its
    SE3 batch to the generic linearization."""
    mine = tlosses.Loss("huber", lambda d: torch.ones_like(d),
                        lambda d: 0.5 * d * d, 1.0)
    assert tlosses.kernel_code(mine) is None
    assert tlosses.kernel_code(None) == (0, 0.0)
    T = se3.expmap(_t(np.random.default_rng(0).normal(size=(3, 6))))
    b = tfactors.between_factors("SE3", [0, 1], [1, 2],
                                 SE3(T.R[:2], T.t[:2]),
                                 tnoise.robust(tnoise.unit(), mine))
    assert tfactors.kernel_route(b) is None
    b2 = dataclasses.replace(b, noise=tnoise.robust(tnoise.unit(), "huber"))
    assert tfactors.kernel_route(b2) == ("SE3", "between")


def _spd(n, count, seed):
    A = np.random.default_rng(seed).normal(size=(count, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


BASES = {
    "unit": lambda m: m.unit(),
    "diagonal": lambda m: m.sigmas(np.random.default_rng(2).uniform(
        0.1, 2.0, size=(7, 5))),
    "gaussian": lambda m: m.information(_spd(5, 7, 3)),
}


@pytest.mark.parametrize("base", sorted(BASES))
@pytest.mark.parametrize("loss", ["huber", "cauchy"])
def test_robust_noise_model(base, loss):
    """A robust model's whiten, robust_weights and error against the JAX
    package's (unit, diagonal and gaussian bases), with residuals whose
    whitened norms fall on both sides of the threshold: 1e-13."""
    r = np.random.default_rng(5).normal(size=(7, 5)) * np.geomspace(
        0.01, 30.0, 7)[:, None]
    tm = tnoise.robust(BASES[base](tnoise), _loss(tlosses, loss))
    jm = jnoise.robust(BASES[base](jnoise), _loss(jlosses, loss))
    wr = tm.whiten(_t(r))
    _close(wr, jm.whiten(jnp.asarray(r)), 1e-13)
    w = tm.robust_weights(wr)
    _close(w, jm.robust_weights(jm.whiten(jnp.asarray(r))), 1e-13)
    assert 0 < int((w < 1).sum()) < 7 if loss == "huber" else \
        bool((w[1:] < w[:-1]).all())
    _close(tm.error(_t(r)), jm.error(jnp.asarray(r)), 1e-13)
    assert tm.to("cpu").loss is tm.loss


def _se3_between_parts(seed, n=6, N=10, scale=0.3):
    rng = np.random.default_rng(seed)
    T = se3.expmap(_t(rng.normal(size=(n, 6)) * np.array([0.8] * 3
                                                          + [3.0] * 3)))
    i = rng.integers(0, n, N)
    j = (i + 1 + rng.integers(0, n - 1, N)) % n
    Z = se3.compose(se3.between(SE3(T.R[i], T.t[i]), SE3(T.R[j], T.t[j])),
                    se3.expmap(_t(rng.normal(size=(N, 6)) * scale)))
    return T, i, j, Z


def _jse3(T):
    return gt.SE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy()))


@pytest.mark.parametrize("batch", ["se3_between", "point3_prior"])
def test_irls_linearize(batch):
    """factors.linearize of a robust batch (Huber on a gaussian base)
    against the JAX package's: the whitened rows scaled by sqrt(w) after
    whitening.  Residual angles of ~0.3 rad keep jacfwd's SO(3)-log
    cancellation below 1e-12 (tests/test_torch_posegraph.py); 1e-12."""
    rng = np.random.default_rng(7)
    info = _spd(3 if batch == "point3_prior" else 6, 1, 8)
    if batch == "se3_between":
        info = info * 0.1   # whitened norms on both sides of Huber's k
        T, i, j, Z = _se3_between_parts(9)
        tb = tfactors.between_factors("SE3", i, j, Z, tnoise.robust(
            tnoise.information(info), "huber"))
        jb = jfactors.between_factors("SE3", i, j, _jse3(Z), jnoise.robust(
            jnoise.information(info), "huber"))
        txs = (SE3(T.R[i], T.t[i]), SE3(T.R[j], T.t[j]))
        jxs = (_jse3(txs[0]), _jse3(txs[1]))
    else:
        p = rng.normal(size=(9, 3)) * 4.0
        z = p + rng.normal(size=(9, 3)) * np.geomspace(0.01, 3.0, 9)[:, None]
        tb = tfactors.prior_factors("Point3", np.arange(9), z, tnoise.robust(
            tnoise.information(info), "huber"))
        jb = gt.prior_factors("Point3", np.arange(9), z, jnoise.robust(
            jnoise.information(info), "huber"))
        txs, jxs = (_t(p),), (jnp.asarray(p),)
    tA, tbv = tfactors.linearize(tb, txs)
    jA, jbv = jfactors.linearize(jb, jxs)
    for a, b in zip(tA, jA):
        _close(a, b, 1e-12)
    _close(tbv, jbv, 1e-12)
    w = tb.noise.robust_weights(tb.noise.whiten(tfactors.residuals(tb, txs)))
    assert bool((w < 1).any()) and bool((w == 1).any())


@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_kernel6_plain_versions_with_each_loss(name):
    """Kernel 6's plain versions with each loss (code and parameter as the
    wrappers take them) against the JAX package on a seeded graph of SE3
    between factors (gaussian base, one model a factor) and a prior
    (diagonal): pg_error_plain through BoundGraph.error against the JAX
    bound graph's error, pg_jacobians_plain's reweighted A and b against
    factors.linearize, and pg_linearize_plain's H and gv blocks against
    the products of the JAX Jacobians.  The loss's parameter is set at the
    median whitened norm, so both branches run.  Residual angles of ~0.3
    rad (jacfwd's cancellation stays below 1e-12): 1e-12."""
    T, i, j, Z = _se3_between_parts(11, n=8, N=16)
    rng = np.random.default_rng(13)
    info = _spd(6, 16, 14)
    Zp = se3.compose(SE3(T.R[2:3], T.t[2:3]),
                     se3.expmap(_t(rng.normal(size=(1, 6)) * 0.3)))
    sig = [[0.2, 0.3, 0.1, 0.5, 0.4, 0.25]]
    tv = Values({"SE3": T}, {"SE3": np.arange(8)})
    # the loss's parameter: the median whitened norm of the between batch
    plain = tfactors.between_factors("SE3", i, j, Z, tnoise.information(info))
    d = torch.linalg.norm(plain.noise.whiten(tfactors.residuals(
        plain, (SE3(T.R[i], T.t[i]), SE3(T.R[j], T.t[j])))), dim=-1)
    med = float(torch.median(d))
    param = None if name == "null" else (med * med if name == "dcs"
                                         else med)

    def mk(mod):
        fn = mod.LOSSES[name]
        return fn() if param is None else fn(param)
    tg, jg = FactorGraph(), JGraph()
    tg.add(tfactors.between_factors("SE3", i, j, Z, tnoise.robust(
        tnoise.information(info), mk(tlosses))))
    tg.add(tfactors.prior_factors("SE3", [2], Zp, tnoise.robust(
        tnoise.sigmas(sig), mk(tlosses))))
    jg.add(jfactors.between_factors("SE3", i, j, _jse3(Z), jnoise.robust(
        jnoise.information(info), mk(jlosses))))
    jg.add(gt.prior_factors("SE3", [2], _jse3(Zp), jnoise.robust(
        jnoise.sigmas(sig), mk(jlosses))))
    jv = JValues({"SE3": _jse3(T)}, {"SE3": np.arange(8)})
    tb = BoundGraph(tg, tv, "cpu")
    _close(tb.error(tv.arrays), jg.bind(jv).error(jv.arrays), 1e-12)
    for jbatch, b, st in zip(jg.batches, tg.batches, tb.structures):
        rows = st.rows_i32
        assert tfactors.kernel_route(b) is not None
        jxs = tuple(gt.SE3(jnp.asarray(T.R.numpy()[rows[:, s].numpy()]),
                           jnp.asarray(T.t.numpy()[rows[:, s].numpy()]))
                    for s in range(b.arity))
        jA, jbv = jfactors.linearize(jbatch, jxs)
        la = tlosses.kernel_code(b.noise.loss)
        args = (T.R, T.t, rows, b.measurements.R, b.measurements.t,
                b.noise.kind, b.noise.data)
        A, bv = K.pg_jacobians_plain(*args, *la)
        for a, ja in zip(A, jA):
            _close(a, ja, 1e-12)
        _close(bv, jbv, 1e-12)
        N, d8 = b.num_factors, 8
        npair = 3 if b.arity == 2 else 1
        H = torch.zeros((N, npair, d8 * d8), dtype=torch.float64)
        gv = torch.zeros((N, b.arity, d8), dtype=torch.float64)
        flip = torch.zeros(N, dtype=torch.bool)
        K.pg_linearize_plain(*args, 1.0, flip, H, gv, *la)
        Hv = H.view(N, npair, d8, d8)
        pairs = ((0, 0), (0, 1), (1, 1)) if b.arity == 2 else ((0, 0),)
        for p, (s1, s2) in enumerate(pairs):
            ref = np.einsum("nri,nrj->nij", np.asarray(jA[s1]),
                            np.asarray(jA[s2]))
            _close(Hv[:, p, :6, :6], ref, 1e-12)
        for s in range(b.arity):
            _close(gv[:, s, :6], np.einsum("nrd,nr->nd", np.asarray(jA[s]),
                                           np.asarray(jbv)), 1e-12)


def test_slice_batch():
    """slice_batch keeps the rows' keys, measurements and per-factor noise
    rows, and the loss and mu, as the JAX package's does (error of the
    sliced batch equal at 1e-13)."""
    T, i, j, Z = _se3_between_parts(15, N=12)
    info = _spd(6, 12, 16)
    rows = np.array([1, 4, 5, 9])
    tb = tfactors.between_factors("SE3", i, j, Z, tnoise.robust(
        tnoise.information(info), "cauchy"))
    jb = jfactors.between_factors("SE3", i, j, _jse3(Z), jnoise.robust(
        jnoise.information(info), "cauchy"))
    ts, js = tfactors.slice_batch(tb, rows), jfactors.slice_batch(jb, rows)
    assert ts.noise.loss is tb.noise.loss and ts.noise.mu == tb.noise.mu
    np.testing.assert_array_equal(ts.keys, js.keys)
    assert torch.equal(ts.noise.data, tb.noise.data[rows])
    assert torch.equal(ts.measurements.R, tb.measurements.R[rows])
    _close(ts.noise.data, js.noise.data, 1e-13)
    _close(ts.measurements.t, js.measurements.t, 0.0)
    tv = Values({"SE3": T}, {"SE3": np.arange(6)})
    jv = JValues({"SE3": _jse3(T)}, {"SE3": np.arange(6)})
    _close(FactorGraph([ts]).error(tv), JGraph([js]).error(jv), 1e-13)
    shared = tfactors.slice_batch(tfactors.between_factors(
        "SE3", i, j, Z, tnoise.constrained([[0.0, 1, 1, 1, 1, 1]], mu=7.0)),
        rows)
    assert shared.noise.kind == "constrained" and shared.noise.mu == 7.0
    assert shared.noise.data.shape == (1, 6)


def test_custom_factors():
    """custom_factors: a residual of one factor's elements (it runs under
    torch.func.vmap), with a robust loss, linearized by jacfwd, against the
    JAX package's custom_factors: 1e-12."""
    rng = np.random.default_rng(17)
    T = se3.expmap(_t(rng.normal(size=(4, 6))))
    pts = rng.normal(size=(5, 3)) * 3.0
    op, ol = np.array([0, 1, 2, 3, 0, 2]), np.array([0, 1, 2, 3, 4, 4])
    z = rng.normal(size=(6, 3))

    def t_res(xs, m):
        return se3.transform_to(xs[0], xs[1]) - m

    def j_res(xs, m):
        from gtsam_tpu.geometry import se3 as jse3
        return jse3.transform_to(xs[0], xs[1]) - m
    tb = tfactors.custom_factors("Obs", ("SE3", "Point3"),
                                 np.stack([op, ol + 10], 1), t_res, 3, z,
                                 tnoise.robust(tnoise.isotropic(3, 0.5),
                                               "huber"))
    jb = jfactors.custom_factors("Obs", ("SE3", "Point3"),
                                 np.stack([op, ol + 10], 1), j_res, 3,
                                 jnp.asarray(z),
                                 jnoise.robust(jnoise.isotropic(3, 0.5),
                                               "huber"))
    assert tfactors.kernel_route(tb) is None
    txs = (SE3(T.R[op], T.t[op]), _t(pts)[ol])
    jxs = (_jse3(txs[0]), jnp.asarray(pts[ol]))
    tA, tbv = tfactors.linearize(tb, txs)
    jA, jbv = jfactors.linearize(jb, jxs)
    for a, b in zip(tA, jA):
        _close(a, b, 1e-12)
    _close(tbv, jbv, 1e-12)
    _close(tfactors.residuals(tb, txs), jfactors.residuals(jb, jxs), 1e-13)


def _robust_chain(mods, seed=19, n=10, closure_loss="huber"):
    """A pose chain with a prior, odometry and two closures, one of them
    wrong (translated by 5 m, rotated by 1 rad), the closures under a
    robust loss; returns (graph, values) of `mods` ((tnoise, tfactors) or
    the JAX modules)."""
    rng = np.random.default_rng(seed)
    T = se3.expmap(_t(rng.normal(size=(n, 6)) * np.array([0.2] * 3
                                                          + [2.0] * 3)))
    i = np.arange(n - 1)
    Z = se3.between(SE3(T.R[i], T.t[i]), SE3(T.R[i + 1], T.t[i + 1]))
    Z = se3.compose(Z, se3.expmap(_t(rng.normal(size=(n - 1, 6)) * 0.01)))
    ci, cj = np.array([0, 2]), np.array([5, 8])
    Zc = se3.between(SE3(T.R[ci], T.t[ci]), SE3(T.R[cj], T.t[cj]))
    Zc = se3.compose(Zc, se3.expmap(_t(np.array(
        [[0.0] * 6, [1.0, 0, 0, 5.0, 0, 0]]))))
    T0 = se3.retract(T, _t(rng.normal(size=(n, 6)) * 0.05))
    out = []
    for noise, fac, wrap, vals in mods:
        g = FactorGraph() if wrap is None else JGraph()
        cv = wrap or (lambda x: x)
        g.add(fac.prior_factors("SE3", [0], cv(SE3(T.R[:1], T.t[:1])),
                                noise.isotropic(6, 0.01)))
        g.add(fac.between_factors("SE3", i, i + 1, cv(Z),
                                  noise.isotropic(6, 0.05)))
        base = noise.isotropic(6, 0.05)
        g.add(fac.between_factors("SE3", ci, cj, cv(Zc), base if
                                  closure_loss is None else
                                  noise.robust(base, closure_loss)))
        out.append((g, vals({"SE3": cv(T0)}, {"SE3": np.arange(n)})))
    return out


TORCH_SIDE = (tnoise, tfactors, None, Values)
JAX_SIDE = (jnoise, jfactors, _jse3, JValues)


def test_robust_fused_lm_with_a_wrong_closure():
    """make_fused_lm (SparseSolver, gain policy) on a pose chain whose
    closures carry a Huber loss, one of them wrong, against the JAX
    package's: iterations, tries and convergence equal, the history at
    1e-9 (the JAX package refines in two-float pairs); the robust batch
    takes kernel 6's plain versions, never the generic linearization."""
    (tg, tv), (jg, jv) = _robust_chain((TORCH_SIDE, JAX_SIDE))
    p = dict(max_iterations=30, relative_error_tol=1e-9,
             absolute_error_tol=1e-12, lambda_policy="gain")
    sn = dict(force_width=2)
    jit, _, jerr, jconv, jhist, jtries = JO.make_fused_lm(
        jg, jv, gt.LMParams(**p), solver=JO.SparseSolver(
            refine_iters=1, supernodal_kwargs=sn))(jv.arrays)
    tfactors.GENERIC_LINEARIZATIONS[0] = 0
    _kernels.reset_launch_counts()
    fn = TO.make_fused_lm(tg, tv, TO.LMParams(**p), solver=TO.SparseSolver(
        refine_iters=1, supernodal_kwargs=sn), device="cpu")
    it, arrays, err, conv, hist, tries = fn(tv.arrays)
    assert (it, tries, conv) == (int(jit), int(jtries), bool(jconv))
    assert it >= 3
    _close(hist[:it + 1], np.asarray(jhist)[:it + 1], 1e-9)
    assert tfactors.GENERIC_LINEARIZATIONS[0] == 0
    assert all(n == 0 for n in _kernels.launch_counts().values())
    # Huber down-weights the wrong closure more than the right one
    b, st = fn.bound.graph.batches[2], fn.bound.structures[2]
    w = b.noise.robust_weights(b.noise.whiten(tfactors.residuals(
        b, fn.bound._xs(b, st, arrays))))
    assert float(w[1]) < 0.25 and float(w[1]) < float(w[0])


def test_gnc_tls_rejects_an_outlier_closure():
    """GNC (TLS) on an SE3 chain with a right and a wrong closure (the SE3
    form of tests/test_estimators.py's SE2 test) against the JAX package's:
    the same weights (1e-9) and values (1e-8 relative); the right closure
    kept, the wrong one rejected."""
    (tg, tv), (jg, jv) = _robust_chain((TORCH_SIDE, JAX_SIDE),
                                       closure_loss=None)
    p = dict(robust_batches=[2], max_iterations=8)
    jres = jgnc.gnc_optimize(jg, jv, jgnc.GncParams(**p))
    tres = tgnc.gnc_optimize(tg, tv, tgnc.GncParams(**p), device="cpu")
    (_, (jw,)), (_, (tw,)) = jres.history[-1], tres.history[-1]
    _close(tw, np.asarray(jw), 1e-9)
    assert tw[0] > 0.9 and tw[1] < 0.1
    assert abs(tres.error - jres.error) <= 1e-8 * max(jres.error, 1.0)
    _close(tres.values.arrays["SE3"].t,
           np.asarray(jres.values.arrays["SE3"].t), 1e-8)


def test_gnc_gm_on_point2_priors():
    """GNC (GM) on Point2 priors, 10 inliers near (1, 0) and 3 outliers at
    (10, 10) (tests/test_estimators.py's test), against the JAX package's:
    weights and values at 1e-9; the estimate near (1, 0); a unit-noise
    batch's weights make an (N, rdim) diagonal (kernel 6's shape)."""
    rng = np.random.default_rng(8)
    targets = np.vstack([np.tile([1.0, 0.0], (10, 1))
                         + rng.normal(scale=0.05, size=(10, 2)),
                         np.tile([10.0, 10.0], (3, 1))])
    res = {}
    for name, (noise, fac, _, vals) in (("t", TORCH_SIDE), ("j", JAX_SIDE)):
        g = FactorGraph() if name == "t" else JGraph()
        g.add(fac.prior_factors("Point2", [0], np.zeros((1, 2)),
                                noise.isotropic(2, 0.1)))
        g.add(fac.prior_factors("Point2", [1] * 13, targets,
                                noise.isotropic(2, 0.1)))
        arr = {"Point2": np.array([[0.0, 0.0], [3.0, 3.0]])}
        v = vals({"Point2": _t(arr["Point2"]) if name == "t"
                  else jnp.asarray(arr["Point2"])}, {"Point2": np.arange(2)})
        p = (tgnc if name == "t" else jgnc).GncParams(loss_type="GM",
                                                      robust_batches=[1])
        res[name] = tgnc.gnc_optimize(g, v, p, device="cpu") \
            if name == "t" else jgnc.gnc_optimize(g, v, p)
    (_, (tw,)), (_, (jw,)) = res["t"].history[-1], res["j"].history[-1]
    _close(tw, np.asarray(jw), 1e-9)
    got = res["t"].values.arrays["Point2"]
    _close(got, np.asarray(res["j"].values.arrays["Point2"]), 1e-9)
    np.testing.assert_allclose(got[1].numpy(), [1.0, 0.0], atol=0.2)
    sc = tgnc._scale_noise(tnoise.unit(), torch.tensor([0.25, 1.0]), 6)
    assert sc.kind == "diagonal" and sc.data.shape == (2, 6)
    assert torch.equal(sc.data[:, 5], torch.tensor([0.5, 1.0],
                                                   dtype=sc.data.dtype))


def test_sparse_solver_keeps_its_plan_across_noise_models():
    """SparseSolver.bind keeps its supernodal plan and owned store for a
    graph of the same structure (GNC's reweighted inner runs), whose
    system equals a new solver's bit for bit; another structure gets a
    new plan."""
    (tg, tv), = _robust_chain((TORCH_SIDE,))
    sn = dict(force_width=2)
    solver = TO.SparseSolver(supernodal_kwargs=sn).bind(
        BoundGraph(tg, tv, "cpu"))
    solver.system(tv.arrays)
    plan, store = solver._s, solver.store
    w = torch.tensor([0.3, 0.0], dtype=torch.float64)
    wg = FactorGraph([tg.batches[0], tg.batches[1], dataclasses.replace(
        tg.batches[2], noise=tgnc._scale_noise(tg.batches[2].noise, w, 6))])
    wb = BoundGraph(wg, tv, "cpu")
    solver.bind(wb)
    assert solver._s is plan and solver.store is store
    got = solver.system(tv.arrays)
    ref = TO.SparseSolver(supernodal_kwargs=sn).bind(wb).system(tv.arrays)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    solver.bind(BoundGraph(FactorGraph(tg.batches[:2]), tv, "cpu"))
    assert solver._s is not plan
