"""Parity of gtsam_torch's slam/factors.py and sam/factors.py with
gtsam_tpu's (CPU, float64): the generic projection factors on kernel 17
and 18's GenericProjection plain versions, the stereo, essential-matrix,
pose-component prior, nonlinear-equality and anti-factor batches, the
Karcher mean, the bearing and range factors, load_2d's BR and LANDMARK
rows, and small LM runs over them.

Inputs are made with numpy from seeds and handed to both packages.
Tolerances: errors 1e-12 relative, linearizations and Gauss-Newton systems
1e-11 relative to the largest entry (closed forms or jacfwd against
jacfwd: the same terms in another order), LM runs the same iterations and
histories within 1e-9 (every graph here has priors: no gauge freedom).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.geometry import cameras as jcam
from gtsam_tpu.geometry import se3 as jse3
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.io import datasets as jdatasets
from gtsam_tpu.optimize import optimizers as JO
from gtsam_tpu.sam import factors as jsam
from gtsam_tpu.slam import factors as jslam

from gtsam_torch.base import losses as tlosses
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se3
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.io import datasets as tdatasets
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.optimize import optimizers as TO
from gtsam_torch.sam import factors as tsam
from gtsam_torch.slam import factors as tslam

ERR_TOL = 1e-12
LIN_TOL = 1e-11
HIST_TOL = 1e-9
# the gradient rows A^T b: two products of A (at LIN_TOL) and b (pixel
# residuals of ~0.5 px, each a difference of ~300 px values) whose sum
# cancels: 1e-10 relative to the largest row (chip_smoke.py's PG_TOL holds
# kernel 6's A^T b so for the same reason)
GRAD_TOL = 1e-10


def gram_per_factor(linearize, args, sign, flip, d):
    """Kernel 17's plain Gram mode on a plan whose rows are single factors,
    its rows put back a factor each: H (M, 3, d*d) and gv (M, 2, d)
    (tests/test_torch_sfm_graph.py's helper of the same name)."""
    M = flip.shape[0]
    plan, rep = K.proj_gram_plan(np.arange(M), M + np.arange(M))
    nh, ng = K.gram_rows(plan)
    H = torch.full((nh, d * d), np.nan, dtype=torch.float64)
    gv = torch.full((ng, d), np.nan, dtype=torch.float64)
    linearize(*args, sign, K.GramPlan(*map(torch.as_tensor, plan)),
              torch.as_tensor((plan.rkind == 1) & flip.numpy()[rep]), H, gv)
    h = plan.rkind < K.GRAM_SLOT0
    Hf = torch.full((M, 3, d * d), np.nan, dtype=torch.float64)
    gf = torch.full((M, 2, d), np.nan, dtype=torch.float64)
    Hf[rep[h], plan.rkind[h]] = H[plan.rout[h]]
    gf[rep[~h], plan.rkind[~h] - K.GRAM_SLOT0] = gv[plan.rout[~h]]
    return Hf, gf


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _close(got, ref, tol):
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    scale = max(float(np.max(np.abs(r))), 1e-300)
    err = float(np.max(np.abs(g - r))) / scale
    assert err <= tol, (err, tol)


K5 = np.array([520.0, 510.0, 0.5, 320.0, 240.0])


class World:
    """Seeded SE3 poses on a ring looking inward at Point3 landmarks, each
    landmark seen by 3 poses; both packages' Values of them."""

    def __init__(self, n_poses=6, n_points=30, seed=0):
        rng = np.random.default_rng(seed)
        ang = np.linspace(0, 2 * np.pi, n_poses, endpoint=False)
        c = np.stack([10 * np.cos(ang), 10 * np.sin(ang), rng.normal(
            size=n_poses) * 0.3], 1)
        R = []
        for ci in c:
            z = -ci / np.linalg.norm(ci)
            x = np.cross([0.0, 0.0, 1.0], z)
            x /= np.linalg.norm(x)
            R.append(np.stack([x, np.cross(z, x), z], 1))
        self.R, self.t = np.stack(R), c
        self.pts = rng.normal(size=(n_points, 3)) * 2.0
        self.obs_pose = np.concatenate([(np.arange(n_points) + k) % n_poses
                                        for k in range(3)])
        self.obs_pt = np.tile(np.arange(n_points), 3)
        self.rng = rng
        self.pose_keys = np.arange(n_poses)
        self.pt_keys = 1000 + np.arange(n_points)

    def values(self, noise=0.0):
        """Both packages' Values, the start moved by `noise`."""
        rng = np.random.default_rng(5)
        T = se3.retract(SE3(_t(self.R), _t(self.t)), _t(
            rng.normal(size=(len(self.t), 6)) * noise))
        P = self.pts + rng.normal(size=self.pts.shape) * noise * 3
        keys = {"SE3": self.pose_keys, "Point3": self.pt_keys}
        tv = Values({"SE3": T, "Point3": _t(P)}, keys)
        jv = JValues({"SE3": jse3.SE3(jnp.asarray(T.R.numpy()),
                                      jnp.asarray(T.t.numpy())),
                      "Point3": jnp.asarray(P)}, keys)
        return tv, jv

    def priors(self, mods):
        """Both packages' priors on the first two poses (sigma 1e-2)."""
        out = []
        for fmod, nmod, se3cls, arr in mods:
            Z = se3cls(arr(self.R[:2]), arr(self.t[:2]))
            out.append(fmod.prior_factors("SE3", self.pose_keys[:2], Z,
                                          nmod.sigmas([[1e-2] * 6])))
        return out


def _both_priors(w):
    return w.priors([(jfactors, jnoise, jse3.SE3, jnp.asarray),
                     (tfactors, tnoise, SE3, _t)])


def _body():
    T = se3.expmap(_t(np.array([0.05, -0.1, 0.02, 0.1, 0.0, -0.05])))
    return T, jse3.SE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy()))


def _proj_batches(w, body, noise_kind="isotropic", loss=None):
    """Both packages' generic projection batches of the world's
    observations, measured through the JAX residual with 0.5 px noise;
    two observations moved behind their camera's image plane."""
    tb, jb = _body() if body else (None, None)
    jn = jnoise.isotropic(2, 1.5)
    tn = tnoise.isotropic(2, 1.5)
    if noise_kind == "gaussian_per_factor":
        rng = np.random.default_rng(3)
        A = rng.normal(size=(len(w.obs_pt), 2, 2))
        M = A @ A.transpose(0, 2, 1) + np.eye(2)
        jn, tn = jnoise.information(M), tnoise.information(M)
    if loss is not None:
        jn = jnoise.robust(jn, loss)
        tn = tnoise.robust(tn, loss)
    zero = np.zeros((len(w.obs_pt), 2))
    probe = jslam.generic_projection_factors(w.pose_keys[w.obs_pose],
                                             w.pt_keys[w.obs_pt], zero, K5,
                                             jn, jb)
    _, jv = w.values()
    jxs = (jax.tree.map(lambda a: a[w.obs_pose], jv.arrays["SE3"]),
           jv.arrays["Point3"][w.obs_pt])
    uv = np.asarray(jfactors.residuals(probe, jxs)) + w.rng.normal(
        size=zero.shape) * 0.5
    jbatch = jslam.generic_projection_factors(
        w.pose_keys[w.obs_pose], w.pt_keys[w.obs_pt], uv, K5, jn, jb)
    tbatch = tslam.generic_projection_factors(
        w.pose_keys[w.obs_pose], w.pt_keys[w.obs_pt], uv, K5, tn, tb)
    return jbatch, tbatch


@pytest.mark.parametrize("body", [False, True])
@pytest.mark.parametrize("noise_kind", ["isotropic", "gaussian_per_factor"])
def test_generic_projection_kernel17_plain(body, noise_kind):
    """GenericProjection batches (with and without body_P_sensor) route to
    kernel 17; its plain Jacobian and Gram modes and kernel 18's plain
    error against the JAX package's linearize and error, a few points
    behind their camera."""
    w = World()
    w.pts[:2] = w.t[w.obs_pose[:2]] * 1.5    # behind the first camera
    jb, tb = _proj_batches(w, body, noise_kind)
    tv, jv = w.values()
    assert tfactors.kernel_route(tb) == ("GenericProjection", "projection")
    bound = BoundGraph(FactorGraph([tb]), tv, "cpu")
    b, st = bound.graph.batches[0], bound.structures[0]
    args = K.group_args("GenericProjection", tv.arrays, st.rows_i32, b)
    assert args[-1] is None if not body else args[-1].shape == (12,)
    jxs = (jax.tree.map(lambda a: a[w.obs_pose], jv.arrays["SE3"]),
           jv.arrays["Point3"][w.obs_pt])
    jA, jbv = jfactors.linearize(jb, jxs)
    A, bv = K.proj3_jacobians_plain(*args, b.noise.kind, b.noise.data)
    assert (A[0].abs().sum((1, 2)) == 0).sum() >= 2   # behind the camera
    for a, ja in zip(A, jA):
        _close(a, ja, LIN_TOL)
    _close(bv, jbv, LIN_TOL)
    gA, gb = tfactors.linearize(b, bound._xs(b, st, tv.arrays))
    for a, g in zip(A, gA):
        _close(a, g, LIN_TOL)
    M, d = b.num_factors, 6
    fl = torch.as_tensor(np.arange(M) % 2 == 0)
    H, gv = gram_per_factor(K.proj3_linearize_plain,
                            args + (b.noise.kind, b.noise.data), 1.0, fl, d)
    H = H.view(M, 3, d, d).numpy()
    jA = [np.asarray(a) for a in jA]
    cp = np.einsum("nri,nrj->nij", jA[0], jA[1])
    ref = np.zeros((M, d, d))
    ref[:, :6, :3] = cp
    tr = np.zeros((M, d, d))
    tr[:, :3, :6] = cp.transpose(0, 2, 1)
    _close(H[:, 1], np.where(fl.numpy()[:, None, None], tr, ref), LIN_TOL)
    _close(H[:, 0], np.einsum("nri,nrj->nij", jA[0], jA[0]), LIN_TOL)
    _close(gv[:, 1, :3], np.einsum("nrd,nr->nd", jA[1], jbv), GRAD_TOL)
    err = K.proj3_error_plain(*args, b.noise.kind, b.noise.data, 1.0)
    _close(err, JGraph([jb]).bind(jv).error(jv.arrays), ERR_TOL)
    _close(bound.error(tv.arrays), JGraph([jb]).bind(jv).error(jv.arrays),
           ERR_TOL)


def test_generic_projection_with_a_loss():
    """Kernel 17's GenericProjection plain version under Huber."""
    w = World()
    jb, tb = _proj_batches(w, True, "isotropic", "huber")
    tv, jv = w.values()
    bound = BoundGraph(FactorGraph([tb]), tv, "cpu")
    b, st = bound.graph.batches[0], bound.structures[0]
    args = K.group_args("GenericProjection", tv.arrays, st.rows_i32, b)
    la = tlosses.kernel_code(b.noise.loss)
    assert la[0] > 0
    jxs = (jax.tree.map(lambda a: a[w.obs_pose], jv.arrays["SE3"]),
           jv.arrays["Point3"][w.obs_pt])
    jA, jbv = jfactors.linearize(jb, jxs)
    A, bv = K.proj3_jacobians_plain(*args, b.noise.kind, b.noise.data, *la)
    for a, ja in zip(A, jA):
        _close(a, ja, LIN_TOL)
    _close(bv, jbv, LIN_TOL)
    _close(K.proj3_error_plain(*args, b.noise.kind, b.noise.data, 1.0, *la),
           JGraph([jb]).bind(jv).error(jv.arrays), ERR_TOL)


def _lm_pair(jg, tg, jv, tv, iterations=10):
    jres = JO.levenberg_marquardt(jg, jv, JO.LMParams(
        max_iterations=iterations), solver=JO.SparseSolver())
    res = TO.levenberg_marquardt(tg, tv, TO.LMParams(
        max_iterations=iterations), solver=TO.SparseSolver(), device="cpu")
    assert res.iterations == jres.iterations
    h, jh = np.asarray(res.history), np.asarray(jres.history)
    assert h.shape == jh.shape and h[-1] < h[0]
    assert np.max(np.abs(h - jh) / jh) <= HIST_TOL
    return res, jres


def test_generic_projection_lm_matches_jax():
    """SE3 + Point3 SLAM on generic projection factors (with an
    extrinsic) and priors on two poses: the port's LM (kernel 17's plain
    version) against the JAX run."""
    w = World()
    jb, tb = _proj_batches(w, True)
    jp, tp = _both_priors(w)
    tv, jv = w.values(noise=0.02)
    before = tfactors.GENERIC_LINEARIZATIONS[0]
    _lm_pair(JGraph([jb, jp]), FactorGraph([tb, tp]), jv, tv)
    # the prior batch is kernel 6's, the projections kernel 17's
    assert tfactors.GENERIC_LINEARIZATIONS[0] == before


def test_stereo_lm_matches_jax():
    """Stereo factors (the generic route, by their residual's missing
    projection group) and priors on two poses: LM against the JAX run."""
    w = World()
    tv0, jv0 = w.values()
    jxs = (jax.tree.map(lambda a: a[w.obs_pose], jv0.arrays["SE3"]),
           jv0.arrays["Point3"][w.obs_pt])
    z, ok = jax.vmap(lambda p, x: jcam.stereo_project(
        p, jnp.asarray(K5), 0.2, x))(*jxs)
    assert bool(np.all(ok))
    meas = np.asarray(z) + w.rng.normal(size=z.shape) * 0.5
    args = (w.pose_keys[w.obs_pose], w.pt_keys[w.obs_pt], meas, K5, 0.2)
    jb = jslam.stereo_factors(*args, jnoise.isotropic(3, 1.0))
    tb = tslam.stereo_factors(*args, tnoise.isotropic(3, 1.0))
    assert tfactors.kernel_route(tb) is None
    jp, tp = _both_priors(w)
    tv, jv = w.values(noise=0.02)
    _lm_pair(JGraph([jb, jp]), FactorGraph([tb, tp]), jv, tv)


def _gn_close(jg, tg, jv, tv):
    """The dense Gauss-Newton systems and errors of both graphs."""
    H, g = BoundGraph(tg, tv, "cpu").gn_system(tv.arrays)
    jH, jgv = jg.bind(jv).gn_system(jv.arrays)
    _close(H, jH, LIN_TOL)
    _close(g, jgv, LIN_TOL)
    _close(tg.error(tv), jg.error(jv), ERR_TOL)


BATCHES = ["essential", "rotation_prior", "translation_prior",
           "equality_soft", "equality_exact_point", "anti_projection",
           "range3d"]


def _batch_pair(name, w, rng):
    pk, qk = w.pose_keys, w.pt_keys
    if name == "essential":
        pairs = rng.normal(size=(5, 2, 2)) * 0.2
        args = (pk[:5], pk[1:6], pairs)
        return (jslam.essential_matrix_factors(*args, jnoise.isotropic(1, .1)),
                tslam.essential_matrix_factors(*args, tnoise.isotropic(1, .1)))
    if name == "rotation_prior":
        Rs = se3.expmap(_t(rng.normal(size=(3, 6)))).R.numpy()
        return (jslam.pose_rotation_priors(pk[:3], jnp.asarray(Rs),
                                           jnoise.sigmas([[0.1] * 3])),
                tslam.pose_rotation_priors(pk[:3], Rs,
                                           tnoise.sigmas([[0.1] * 3])))
    if name == "translation_prior":
        ts = rng.normal(size=(3, 3))
        return (jslam.pose_translation_priors(pk[:3], ts,
                                              jnoise.isotropic(3, 0.3)),
                tslam.pose_translation_priors(pk[:3], ts,
                                              tnoise.isotropic(3, 0.3)))
    if name == "equality_soft":
        T = se3.expmap(_t(rng.normal(size=(2, 6))))
        jT = jse3.SE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy()))
        return (jslam.nonlinear_equality_factors("SE3", pk[:2], jT, mu=1e4),
                tslam.nonlinear_equality_factors("SE3", pk[:2], T, mu=1e4))
    if name == "equality_exact_point":
        P = rng.normal(size=(2, 3))
        return (jslam.nonlinear_equality_factors(
            "Point3", qk[:2], jnp.asarray(P), exact=True),
                tslam.nonlinear_equality_factors("Point3", qk[:2], P,
                                                 exact=True))
    if name == "range3d":
        r = rng.uniform(5, 15, 4)
        return (jsam.range_3d_factors(pk[:4], qk[:4], r,
                                      jnoise.isotropic(1, 0.1)),
                tsam.range_3d_factors(pk[:4], qk[:4], r,
                                      tnoise.isotropic(1, 0.1)))
    jb, tb = _proj_batches(w, False)
    sl = np.arange(6)
    return (jslam.anti_factor(jfactors.slice_batch(jb, sl)),
            tslam.anti_factor(tfactors.slice_batch(tb, sl)))


@pytest.mark.parametrize("name", BATCHES)
def test_slam_batches_match_jax(name):
    """Each further batch constructor, with priors on two poses, the world's
    projections at 0.5 (the anti-factor subtracts six of them): the dense
    Gauss-Newton system (the generic linearization of every batch) and the
    error against the JAX package's.  The anti-factor keeps its route to
    kernel 17 (its sign flips the blocks) and is held there too."""
    w = World()
    rng = np.random.default_rng(11)
    jb, tb = _batch_pair(name, w, rng)
    assert tb.name == jb.name and tb.rdim == jb.rdim
    assert tb.var_types == jb.var_types and tb.sign == jb.sign
    jbase, tbase = _proj_batches(w, False)
    jp, tp = _both_priors(w)
    tv, jv = w.values(noise=0.02)
    jg, tg = JGraph([jbase, jp, jb]), FactorGraph([tbase, tp, tb])
    _gn_close(jg, tg, jv, tv)
    if name == "anti_projection":
        assert tfactors.kernel_route(tb) == ("GenericProjection",
                                             "projection")
        bound = BoundGraph(tg, tv, "cpu")
        H, g = bound.gn_system(tv.arrays)
        s = TO.SparseSolver().bind(bound)
        blocks, gp = s.system(tv.arrays)
        dx, _ = s.solve((blocks, gp), 1.0, False)
        ref = torch.linalg.solve(H + torch.eye(len(g), dtype=H.dtype), g)
        _close(dx, ref, 1e-10)


def test_karcher_mean_matches_jax():
    rng = np.random.default_rng(12)
    base = se3.expmap(_t(rng.normal(size=6))).R
    Rs = base @ se3.expmap(_t(rng.normal(size=(7, 6)) * 0.2)).R
    _close(tslam.karcher_mean_so3(Rs), jslam.karcher_mean_so3(
        jnp.asarray(Rs.numpy())), ERR_TOL)


def test_essential_matrix_from_pose_matches_jax():
    rng = np.random.default_rng(13)
    T = se3.expmap(_t(rng.normal(size=6)))
    jT = jse3.SE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy()))
    _close(tslam.essential_matrix_from_pose(T),
           jslam.essential_matrix_from_pose(jT), ERR_TOL)


SAM = ["bearing_range", "range2d", "bearing2d"]


def _planar(n_poses=8, n_lm=5, seed=21):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(size=(n_poses, 2)) * 3,
                        rng.uniform(-3, 3, (n_poses, 1))], 1)
    lm = rng.normal(size=(n_lm, 2)) * 4
    pi = np.repeat(np.arange(n_poses), 2)
    li = rng.integers(0, n_lm, len(pi))
    return rng, x, lm, pi, li


@pytest.mark.parametrize("name", SAM)
def test_sam_factors_match_jax(name):
    """The 2D bearing, range and bearing-range batches: error and dense
    Gauss-Newton system against the JAX package's."""
    rng, x, lm, pi, li = _planar()
    d = lm[li] - x[pi, :2]
    b = np.arctan2(d[:, 1], d[:, 0]) - x[pi, 2] + rng.normal(size=len(pi)) * .1
    r = np.linalg.norm(d, axis=1) + rng.normal(size=len(pi)) * 0.1
    lk = 100 + li
    if name == "bearing_range":
        jb = jsam.bearing_range_2d_factors(pi, lk, b, r,
                                           jnoise.sigmas([[0.1, 0.2]]))
        tb = tsam.bearing_range_2d_factors(pi, lk, b, r,
                                           tnoise.sigmas([[0.1, 0.2]]))
    elif name == "range2d":
        jb = jsam.range_2d_factors(pi, lk, r, jnoise.isotropic(1, 0.2))
        tb = tsam.range_2d_factors(pi, lk, r, tnoise.isotropic(1, 0.2))
    else:
        jb = jsam.bearing_2d_factors(pi, lk, b, jnoise.isotropic(1, 0.1))
        tb = tsam.bearing_2d_factors(pi, lk, b, tnoise.isotropic(1, 0.1))
    keys = {"SE2": np.arange(len(x)), "Point2": 100 + np.arange(len(lm))}
    tv = Values({"SE2": _t(x), "Point2": _t(lm)}, keys)
    jv = JValues({"SE2": jnp.asarray(x), "Point2": jnp.asarray(lm)}, keys)
    assert tb.name == jb.name and tb.var_types == jb.var_types
    _gn_close(JGraph([jb]), FactorGraph([tb]), jv, tv)


def _planar_file(path, rng):
    """A planar SLAM dataset: an odometry chain of 12 poses (EDGE2 rows)
    with BR and LANDMARK sightings of 4 landmarks."""
    x = np.zeros((12, 3))
    for i in range(1, 12):
        x[i] = x[i - 1] + [np.cos(x[i - 1, 2]), np.sin(x[i - 1, 2]), 0.3]
    lm = rng.normal(size=(4, 2)) * 3
    def f(*v):
        return " ".join(repr(float(a)) for a in v)
    rows = [f"VERTEX2 0 {f(*x[0])}"]
    for i in range(11):
        dth = x[i + 1, 2] - x[i, 2]
        c, s = np.cos(x[i, 2]), np.sin(x[i, 2])
        dx = x[i + 1, :2] - x[i, :2]
        m = [c * dx[0] + s * dx[1] + rng.normal() * 0.05,
             -s * dx[0] + c * dx[1] + rng.normal() * 0.05,
             dth + rng.normal() * 0.02]
        rows.append(f"EDGE2 {i} {i + 1} {f(*m)} 100 0 100 400 0 0")
    for i in range(12):
        for j in range(4):
            if (i + j) % 3:
                continue
            d = lm[j] - x[i, :2]
            c, s = np.cos(x[i, 2]), np.sin(x[i, 2])
            loc = [c * d[0] + s * d[1], -s * d[0] + c * d[1]]
            if (i + j) % 2:
                b = np.arctan2(loc[1], loc[0]) + rng.normal() * 0.01
                r = np.hypot(*loc) + rng.normal() * 0.05
                rows.append(f"BR {i} {j} {f(b, r)} 0.01 0.05")
            else:
                rows.append(f"LANDMARK {i} {j} {f(*loc)} 0.5 0 0.5")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def test_load_2d_landmarks_and_planar_lm(tmp_path):
    """load_2d of a file with BR and LANDMARK rows (written by the test)
    gives the JAX package's graph and values (a bearing-range batch, the
    landmarks' first-sighting initials); LM over it with a prior on pose 0
    against the JAX run."""
    path = str(tmp_path / "planar.graph")
    _planar_file(path, np.random.default_rng(31))
    tg, tv = tdatasets.load_2d(path)
    jg, jv = jdatasets.load_2d(path)
    assert [b.name for b in tg.batches] == [b.name for b in jg.batches]
    assert tg.batches[1].name == "BearingRange2D"
    for t in ("SE2", "Point2"):
        assert np.array_equal(tv.keys[t], jv.keys[t])
        _close(tv.arrays[t], jv.arrays[t], ERR_TOL)
    _close(tg.batches[1].noise.data, jg.batches[1].noise.data, 0.0)
    _close(tg.error(tv), jg.error(jv), ERR_TOL)
    x0 = tv.arrays["SE2"][:1].numpy()
    jg.add(jfactors.prior_factors("SE2", [0], jnp.asarray(x0),
                                  jnoise.sigmas([[1e-3, 1e-3, 1e-4]])))
    tg.add(tfactors.prior_factors("SE2", [0], x0,
                                  tnoise.sigmas([[1e-3, 1e-3, 1e-4]])))
    res, jres = _lm_pair(jg, tg, jv, tv)
    assert res.error < 0.1 * res.history[0]


def test_slice_and_anti_of_a_projection_batch():
    """slice_batch and anti_factor keep a projection batch's residual (its
    route and kernel arguments) and take its rows."""
    w = World()
    _, tb = _proj_batches(w, True)
    part = tfactors.slice_batch(tb, np.arange(4, 9))
    anti = tslam.anti_factor(part)
    assert anti.sign == -1.0 and anti.name == "AntiGenericProjection"
    assert anti.residual_fn is tb.residual_fn
    assert torch.equal(anti.measurements, tb.measurements[4:9])
    K5t, ext = anti.residual_fn.kernel_args(torch.device("cpu"))
    assert torch.equal(K5t, _t(K5)) and ext.shape == (12,)
    assert dataclasses.replace(anti, sign=1.0).keys.shape == (5, 2)
