"""Parity of gtsam_torch's geometry of the cameras slice with gtsam_tpu's
(CPU, float64): Unit3, the cameras and calibrations, triangulation, the
camera and SO3 manifolds and Values of camera types.

Inputs are made with numpy from seeds and handed to both packages.
Tolerances: 1e-12 relative to the reference's largest entry for the
closed-form geometry (both packages evaluate the same formulas; the fixed-
point and Newton inverses of the calibrations run the same iteration
counts); the SVD-based triangulations within 1e-9 (LAPACK's SVD in
numpy-backed JAX and in torch differ in their last bits, which a DLT's
dehomogenization by X[3] amplifies by the track's conditioning).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_tpu.geometry import calibrations as jcal
from gtsam_tpu.geometry import cameras as jcam
from gtsam_tpu.geometry import se3 as jse3
from gtsam_tpu.geometry import triangulation as jtri
from gtsam_tpu.geometry import unit3 as junit3
from gtsam_tpu.graph import manifolds as jmanifolds
from gtsam_tpu.graph.values import Values as JValues

from gtsam_torch.geometry import calibrations as tcal
from gtsam_torch.geometry import cameras as tcam
from gtsam_torch.geometry import se3, so3
from gtsam_torch.geometry import triangulation as ttri
from gtsam_torch.geometry import unit3 as tunit3
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import manifolds, values as tvalues
from gtsam_torch.graph.values import Values

TOL = 1e-12
TRI_TOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(a) for a in x)
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, ref, tol=TOL):
    if isinstance(ref, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, tol)
        return
    g, r = _np(got), np.asarray(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    if r.dtype == bool:
        assert np.array_equal(g, r)
        return
    scale = max(float(np.max(np.abs(r))), 1e-300) if r.size else 1.0
    err = float(np.max(np.abs(g - r))) / scale if r.size else 0.0
    assert err <= tol, (err, tol)


def _poses(rng, n):
    T = se3.expmap(_t(rng.normal(size=(n, 6))))
    return T, jse3.SE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy()))


def _unit(rng, n):
    p = rng.normal(size=(n, 3))
    # two rows near the x axis take basis()'s other branch
    p[:2] = [[1.0, 1e-3, -2e-3], [-3.0, 0.1, 0.05]]
    return p / np.linalg.norm(p, axis=1, keepdims=True)


UNIT3_CASES = ["basis", "retract", "local", "error_vector", "identity"]


@pytest.mark.parametrize("name", UNIT3_CASES)
def test_unit3_matches_jax(name):
    rng = np.random.default_rng(0)
    p, q = _unit(rng, 20), _unit(rng, 20)
    xi = rng.normal(size=(20, 2)) * 0.3
    xi[3] = 0.0     # the small-angle branch of retract
    q[4] = p[4]     # local of a point with itself
    args = {"basis": (p,), "retract": (p, xi), "local": (p, q),
            "error_vector": (p, q), "identity": ()}[name]
    got = getattr(tunit3, name)(*map(_t, args))
    ref = getattr(junit3, name)(*map(jnp.asarray, args))
    _close(got, ref)


def _bal_cams(rng, n):
    T, jT = _poses(rng, n)
    calib = np.stack([500 + rng.normal(size=n) * 10,
                      rng.normal(size=n) * 1e-2,
                      rng.normal(size=n) * 1e-3], 1)
    return T, jT, calib


def _points_in_front(rng, T, depth=(2.0, 20.0)):
    """A world point in front of each pose (and one behind the first)."""
    n = T.t.shape[0]
    pc = np.concatenate([rng.normal(size=(n, 2)) * 0.3,
                         rng.uniform(*depth, size=(n, 1))], 1)
    pc[:, :2] *= pc[:, 2:]
    pc[0, 2] = -1.0
    return se3.transform_from(T, _t(pc)).numpy()


def _k_s2(rng, n):
    return np.stack([rng.uniform(400, 600, n), rng.uniform(400, 600, n),
                     rng.normal(size=n), rng.uniform(200, 400, n),
                     rng.uniform(150, 300, n)], 1)


CAMERA_CASES = ["bal_identity", "calibrate_bundler", "uncalibrate_cal3s2",
                "calibrate_cal3s2", "pinhole_s2_project", "bal_project",
                "backproject_s2", "backproject_bundler", "spherical_project",
                "spherical_backproject", "spherical_reprojection_error",
                "stereo_project"]


@pytest.mark.parametrize("name", CAMERA_CASES)
def test_cameras_match_jax(name):
    rng = np.random.default_rng(1)
    n = 12
    T, jT, calib = _bal_cams(rng, n)
    X = _points_in_front(rng, T)
    K = _k_s2(rng, n)
    pix = rng.normal(size=(n, 2)) * 100.0
    depth = rng.uniform(1.0, 10.0, n)
    tc, jc = _t(calib), jnp.asarray(calib)
    if name == "bal_identity":
        got, ref = tcam.bal_identity(), jcam.bal_identity()
        _close((got.pose.R, got.pose.t, got.calib),
               (ref.pose.R, ref.pose.t, ref.calib))
        return
    if name == "calibrate_bundler":
        got = tcam.calibrate_bundler(tc, _t(pix))
        ref = jcam.calibrate_bundler(jc, jnp.asarray(pix))
    elif name in ("uncalibrate_cal3s2", "calibrate_cal3s2"):
        got = getattr(tcam, name)(_t(K), _t(pix / 500.0 if name[0] == "u"
                                             else pix))
        ref = getattr(jcam, name)(jnp.asarray(K), jnp.asarray(
            pix / 500.0 if name[0] == "u" else pix))
    elif name == "pinhole_s2_project":
        got = tcam.pinhole_s2_project(tcam.PinholeCameraS2(T, _t(K)), _t(X))
        ref = jcam.pinhole_s2_project(jcam.PinholeCameraS2(jT, jnp.asarray(K)),
                                      jnp.asarray(X))
    elif name == "bal_project":
        got = tcam.bal_project(tcam.BalCamera(T, tc), _t(X))
        ref = jcam.bal_project(jcam.BalCamera(jT, jc), jnp.asarray(X))
    elif name == "backproject_s2":
        got = tcam.backproject(T, _t(K), _t(pix), _t(depth),
                               tcam.calibrate_cal3s2)
        ref = jcam.backproject(jT, jnp.asarray(K), jnp.asarray(pix),
                               jnp.asarray(depth), jcam.calibrate_cal3s2)
    elif name == "backproject_bundler":
        got = tcam.backproject(T, tc, _t(pix), _t(depth),
                               tcam.calibrate_bundler)
        ref = jcam.backproject(jT, jc, jnp.asarray(pix), jnp.asarray(depth),
                               jcam.calibrate_bundler)
    elif name == "spherical_project":
        Xs = X.copy()
        Xs[1] = T.t[1].numpy()          # at the camera centre: invalid
        got = tcam.spherical_project(T, _t(Xs))
        ref = jcam.spherical_project(jT, jnp.asarray(Xs))
    elif name == "spherical_backproject":
        b = _unit(rng, n)
        got = tcam.spherical_backproject(T, _t(b), _t(depth))
        ref = jcam.spherical_backproject(jT, jnp.asarray(b),
                                         jnp.asarray(depth))
    elif name == "spherical_reprojection_error":
        b = _unit(rng, n)
        got = tcam.spherical_reprojection_error(T, _t(X), _t(b))
        ref = jcam.spherical_reprojection_error(jT, jnp.asarray(X),
                                                jnp.asarray(b))
    else:
        got = tcam.stereo_project(T, _t(K[0]), 0.12, _t(X))
        ref = jcam.stereo_project(jT, jnp.asarray(K[0]), 0.12,
                                  jnp.asarray(X))
    _close(got, tuple(ref) if isinstance(ref, tuple) else ref)


def _distortion(rng, n, model):
    K = _k_s2(rng, n)
    if model in ("ds2", "unified"):
        K = np.concatenate([K, rng.normal(size=(n, 4)) * [1e-2, 1e-3, 1e-4,
                                                          1e-4]], 1)
    if model == "unified":
        K = np.concatenate([K, rng.uniform(0.1, 0.9, (n, 1))], 1)
    if model == "s2stereo":
        K = np.concatenate([K, rng.uniform(0.05, 0.2, (n, 1))], 1)
    if model == "fisheye":
        K = np.concatenate([K, rng.normal(size=(n, 4)) * [1e-2, 1e-3, 1e-4,
                                                          1e-5]], 1)
    return K


@pytest.mark.parametrize("model", ["ds2", "unified", "s2stereo", "fisheye"])
@pytest.mark.parametrize("way", ["uncalibrate", "calibrate"])
def test_calibrations_match_jax(model, way):
    rng = np.random.default_rng(2)
    n = 16
    K = _distortion(rng, n, model)
    p = rng.normal(size=(n, 2)) * 0.4
    p[0] = 0.0          # the fisheye's r = 0 branch
    if way == "calibrate":   # pixels of the normalized points
        p = getattr(jcal, f"uncalibrate_{model}")(jnp.asarray(K),
                                                  jnp.asarray(p))
    got = getattr(tcal, f"{way}_{model}")(_t(K), _t(p))
    ref = getattr(jcal, f"{way}_{model}")(jnp.asarray(K), jnp.asarray(p))
    _close(got, ref)


def _tracks(rng, n_tracks, M):
    """Tracks of M cameras around a point each: poses looking at the point
    from ~10 m, normalized measurements with 1e-3 noise, masks with one
    camera dropped in some tracks and a one-camera track (degenerate)."""
    R, t, meas, mask, pts = [], [], [], [], []
    for k in range(n_tracks):
        X = rng.normal(size=3) * 2.0
        Ts = se3.expmap(_t(rng.normal(size=(M, 6)) * 0.3))
        pc = np.concatenate([rng.normal(size=(M, 2)) * 0.2,
                             rng.uniform(8, 12, (M, 1))], 1)
        # pose = world-from-camera placing the point at pc in the camera
        Rm = Ts.R.numpy()
        tm = X[None] - np.einsum("mij,mj->mi", Rm, pc)
        m = pc[:, :2] / pc[:, 2:] + rng.normal(size=(M, 2)) * 1e-3
        mk = np.ones(M, bool)
        if k % 3 == 1:
            mk[0] = False
        if k == n_tracks - 1:
            mk[1:] = False
        R.append(Rm); t.append(tm); meas.append(m); mask.append(mk)
        pts.append(X)
    return (np.stack(R), np.stack(t), np.stack(meas), np.stack(mask),
            np.stack(pts))


TRI_CASES = ["dlt", "lost", "nonlinear", "safe", "safe_outliers"]


@pytest.mark.parametrize("name", TRI_CASES)
def test_triangulation_matches_jax(name):
    """The port's batched functions against the JAX package's vmapped over
    the same tracks; the point within TRI_TOL, the valid flags equal."""
    import jax
    rng = np.random.default_rng(3)
    R, t, meas, mask, X = _tracks(rng, 7, 4)
    tp = SE3(_t(R), _t(t))
    jp = jse3.SE3(jnp.asarray(R), jnp.asarray(t))
    p0 = X + rng.normal(size=X.shape) * 0.1
    if name == "dlt":
        got = ttri.triangulate_dlt(tp, _t(meas), mask)
        ref = jax.vmap(jtri.triangulate_dlt)(jp, jnp.asarray(meas),
                                             jnp.asarray(mask))
    elif name == "lost":
        got = ttri.triangulate_lost(tp, _t(meas), mask)
        ref = jax.vmap(jtri.triangulate_lost)(jp, jnp.asarray(meas),
                                              jnp.asarray(mask))
    elif name == "nonlinear":
        got = ttri.triangulate_nonlinear(tp, _t(meas), _t(p0), mask)
        ref = jax.vmap(jtri.triangulate_nonlinear)(
            jp, jnp.asarray(meas), jnp.asarray(p0), jnp.asarray(mask))
    else:
        kw = dict(landmark_distance_threshold=11.5)
        if name == "safe_outliers":
            kw["dyn_outlier_rejection_threshold"] = 2e-3
        got = ttri.triangulate_safe(tp, _t(meas), mask, **kw)
        ref = jax.vmap(lambda p, m, k: jtri.triangulate_safe(p, m, k, **kw))(
            jp, jnp.asarray(meas), jnp.asarray(mask))
    valid = np.asarray(ref.valid)
    assert np.array_equal(got.valid.numpy(), valid)
    # every refined point lies in front; the other cases flag the
    # one-camera track (and, with the thresholds, a far or outlier track)
    assert valid.any() and (name == "nonlinear" or not valid.all())
    ok = valid | (name == "nonlinear")
    _close(got.point[ok], np.asarray(ref.point)[ok], TRI_TOL)
    if name != "nonlinear":   # the true points, a noisy measurement's way
        assert np.abs(got.point[valid].numpy() - X[valid]).max() < 0.1


MANIFOLD_CASES = ["SO3", "BalCamera", "PinholeCameraS2"]


def _element(rng, tname, n):
    T, jT = _poses(rng, n)
    if tname == "SO3":
        return T.R, jT.R
    k = 3 if tname == "BalCamera" else 5
    c = rng.normal(size=(n, k))
    tcls = getattr(tcam, tname)
    jcls = getattr(jcam, tname)
    return tcls(T, _t(c)), jcls(jT, jnp.asarray(c))


def _leaves(x):
    return tuple(_leaves(a) for a in x) if isinstance(x, tuple) else x


def _flat(x):
    if isinstance(x, tuple):
        return tuple(y for a in x for y in _flat(a))
    return (x,)


@pytest.mark.parametrize("tname", MANIFOLD_CASES)
def test_camera_manifolds_match_jax(tname):
    """Registered in the port with the JAX package's dimension, retract,
    local and identity (retract of a stacked element, local of two)."""
    import jax
    rng = np.random.default_rng(4)
    m, jm = manifolds.get(tname), jmanifolds.get(tname)
    assert m.dim == jm.dim
    x, jx = _element(rng, tname, 6)
    d = rng.normal(size=(6, m.dim)) * 0.2
    got = m.retract(x, _t(d))
    ref = jax.vmap(jm.retract)(jx, jnp.asarray(d))
    _close(_flat(got), _flat(ref))
    y, jy = _element(rng, tname, 6)
    _close(m.local(x, y), jax.vmap(jm.local)(jx, jy))
    _close(_flat(m.identity()), _flat(jm.identity()))


def test_values_of_cameras():
    """Values carry BalCamera and PinholeCameraS2 arrays: from_numpy takes
    the JAX package's NamedTuples, the layout and retract match the JAX
    Values', take_rows, to() and from_entries walk the nested fields."""
    rng = np.random.default_rng(5)
    cams, jcams = _element(rng, "BalCamera", 4)
    s2, js2 = _element(rng, "PinholeCameraS2", 3)
    pts = rng.normal(size=(5, 3))
    keys = {"BalCamera": np.arange(4), "PinholeCameraS2": np.arange(10, 13),
            "Point3": np.arange(20, 25)}
    jv = JValues({"BalCamera": jcams, "PinholeCameraS2": js2,
                  "Point3": jnp.asarray(pts)}, keys)
    tv = Values.from_numpy(jv.arrays, keys, device="cpu")
    assert isinstance(tv.arrays["BalCamera"], tcam.BalCamera)
    assert isinstance(tv.arrays["PinholeCameraS2"].pose, SE3)
    assert tv.layout().total_dim == jv.layout().total_dim == 4 * 9 + 33 + 15
    delta = rng.normal(size=tv.layout().total_dim) * 0.1
    got = tv.retract(_t(delta)).arrays
    ref = jv.retract(jnp.asarray(delta)).arrays
    for t in keys:
        _close(_flat(got[t]), _flat(ref[t]))
    row = tvalues.take_rows(tv.arrays["BalCamera"], 2)
    assert row.calib.shape == (3,) and row.pose.R.shape == (3, 3)
    _close(_flat(tv.at(2)), _flat(jax_row(jv, 2)))
    moved = tv.to("cpu").arrays["BalCamera"]
    assert moved.pose.t.dtype == torch.float64
    fe = Values.from_entries([(k, "BalCamera", tvalues.take_rows(
        tv.arrays["BalCamera"], i)) for i, k in enumerate(keys["BalCamera"])])
    _close(_flat(fe.arrays["BalCamera"]), _flat(tv.arrays["BalCamera"]))


def test_values_from_numpy_default_to_cuda(monkeypatch):
    """Values.from_numpy and element_from_numpy with no device go to the
    card, as the port's other entry points do: with no CUDA present they
    raise config.resolve_device's error."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(6)
    _, cams = _element(rng, "BalCamera", 2)
    pts = rng.normal(size=(3, 3))
    keys = {"BalCamera": np.arange(2), "Point3": np.arange(10, 13)}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Values.from_numpy({"BalCamera": cams, "Point3": pts}, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvalues.element_from_numpy("Point3", pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvalues.element_from_numpy("BalCamera", cams)
    tv = Values.from_numpy({"BalCamera": cams, "Point3": pts}, keys,
                           device="cpu")
    assert tv.arrays["Point3"].device.type == "cpu"


def jax_row(jv, key):
    return jv.at(key)


def test_so3_group_functions_match_jax():
    """The SO3 functions the slice added: inverse, compose, between,
    rotate, unrotate, retract, local, identity."""
    from gtsam_tpu.geometry import so3 as jso3
    rng = np.random.default_rng(6)
    R1 = so3.expmap(_t(rng.normal(size=(5, 3))))
    R2 = so3.expmap(_t(rng.normal(size=(5, 3))))
    p, w = rng.normal(size=(5, 3)), rng.normal(size=(5, 3)) * 0.3
    j1, j2 = jnp.asarray(R1.numpy()), jnp.asarray(R2.numpy())
    _close(so3.inverse(R1), jso3.inverse(j1))
    _close(so3.compose(R1, R2), jso3.compose(j1, j2))
    _close(so3.between(R1, R2), jso3.between(j1, j2))
    _close(so3.rotate(R1, _t(p)), jso3.rotate(j1, jnp.asarray(p)))
    _close(so3.unrotate(R1, _t(p)), jso3.unrotate(j1, jnp.asarray(p)))
    _close(so3.retract(R1, _t(w)), jso3.retract(j1, jnp.asarray(w)))
    _close(so3.local(R1, R2), jso3.local(j1, j2))
    _close(so3.identity(), jso3.identity())
