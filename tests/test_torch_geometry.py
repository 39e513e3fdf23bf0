"""Parity of gtsam_torch.geometry with gtsam_tpu.geometry (float64, CPU).

The same numpy inputs, made from a seed, go through the JAX function and its
torch counterpart; outputs agree to rtol 1e-12 (atol 1e-12 times the
largest entry, for entries that are near zero).  Batches of 64 include
zero, near-zero and near-pi rotation angles, where the small-angle and
quaternion branches switch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_torch.geometry import cameras, se3, so3
from gtsam_tpu.geometry import cameras as jcameras
from gtsam_tpu.geometry import se3 as jse3
from gtsam_tpu.geometry import so3 as jso3

B = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _angles(rng):
    w = rng.normal(size=(B, 3))
    w[0] = 0.0
    w[1] *= 1e-12
    w[2] *= 1e-7
    w[3] *= 1e-5
    w[4] = w[4] / np.linalg.norm(w[4]) * (np.pi - 1e-6)
    w[5] = w[5] / np.linalg.norm(w[5]) * np.pi
    return w


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def _se3_pair(rng):
    w, v = _angles(rng), rng.normal(size=(B, 3)) * 3.0
    R = np.asarray(jso3.expmap(jnp.asarray(w)))
    return (se3.SE3(_t(R), _t(v)), jse3.SE3(jnp.asarray(R), jnp.asarray(v)))


SO3_CASES = {
    "hat": (so3.hat, jso3.hat),
    "expmap": (so3.expmap, jso3.expmap),
    "left_jacobian": (so3.left_jacobian, jso3.left_jacobian),
    "left_jacobian_inverse": (so3.left_jacobian_inverse,
                              jso3.left_jacobian_inverse),
    "right_jacobian": (so3.right_jacobian, jso3.right_jacobian),
}


@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3_tangent_functions(name):
    fn, jfn = SO3_CASES[name]
    w = _angles(np.random.default_rng(1))
    _close(fn(_t(w)), jfn(jnp.asarray(w)))


def test_so3_logmap():
    w = _angles(np.random.default_rng(2))
    R = np.asarray(jso3.expmap(jnp.asarray(w)))
    _close(so3.logmap(_t(R)), jso3.logmap(jnp.asarray(R)))


def test_se3_expmap_and_logmap():
    rng = np.random.default_rng(3)
    xi = np.concatenate([_angles(rng), rng.normal(size=(B, 3))], axis=1)
    T, jT = se3.expmap(_t(xi)), jse3.expmap(jnp.asarray(xi))
    _close(T.R, jT.R)
    _close(T.t, jT.t)
    _close(se3.logmap(T), jse3.logmap(jT))


@pytest.mark.parametrize("name", ["retract", "compose", "between", "local"])
def test_se3_binary(name):
    rng = np.random.default_rng(4)
    T1, jT1 = _se3_pair(rng)
    if name == "retract":
        xi = np.concatenate([_angles(rng), rng.normal(size=(B, 3))], axis=1)
        out, jout = se3.retract(T1, _t(xi)), jse3.retract(jT1, jnp.asarray(xi))
    else:
        T2, jT2 = _se3_pair(rng)
        out = getattr(se3, name)(T1, T2)
        jout = getattr(jse3, name)(jT1, jT2)
    for got, ref in (zip(out, jout) if name != "local" else [(out, jout)]):
        _close(got, ref)


def test_se3_inverse_and_transform_to():
    rng = np.random.default_rng(5)
    T, jT = _se3_pair(rng)
    inv, jinv = se3.inverse(T), jse3.inverse(jT)
    _close(inv.R, jinv.R)
    _close(inv.t, jinv.t)
    p = rng.normal(size=(B, 3)) * 10.0
    _close(se3.transform_to(T, _t(p)), jse3.transform_to(jT, jnp.asarray(p)))


def _cameras(rng):
    T, jT = _se3_pair(rng)
    calib = np.stack([500.0 + rng.normal(size=B) * 10.0,
                      rng.normal(size=B) * 1e-2, rng.normal(size=B) * 1e-3],
                     axis=1)
    return (cameras.BalCamera(T, _t(calib)),
            jcameras.BalCamera(jT, jnp.asarray(calib)))


def test_bal_project():
    rng = np.random.default_rng(6)
    cam, jcam = _cameras(rng)
    # points in front of, and (for the first 8) behind or at the camera
    depth = rng.uniform(2.0, 20.0, size=B)
    depth[:8] = [-3.0, -1e-9, 0.0, 1e-9, 5e-9, -10.0, 1.5e-8, 2e-8]
    local = np.concatenate([rng.normal(size=(B, 2)) * depth[:, None] * 0.3,
                            depth[:, None]], axis=1)
    R, t = cam.pose.R.numpy(), cam.pose.t.numpy()
    p = np.einsum("bij,bj->bi", R, local) + t
    pix, valid = cameras.bal_project(cam, _t(p))
    jpix, jvalid = jcameras.bal_project(jcam, jnp.asarray(p))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    assert not valid[:3].any() and valid[8:].all()
    _close(pix, jpix)


def test_bal_retract_and_local():
    rng = np.random.default_rng(7)
    cam, jcam = _cameras(rng)
    d = np.concatenate([_angles(rng), rng.normal(size=(B, 6))], axis=1)
    c2 = cameras.bal_retract(cam, _t(d))
    jc2 = jcameras.bal_retract(jcam, jnp.asarray(d))
    _close(c2.pose.R, jc2.pose.R)
    _close(c2.pose.t, jc2.pose.t)
    _close(c2.calib, jc2.calib)
    _close(cameras.bal_local(cam, c2), jcameras.bal_local(jcam, jc2))


def test_so3_vee():
    """vee inverts hat, as the JAX package's does (exactly)."""
    w = _angles(np.random.default_rng(11))
    _close(so3.vee(so3.hat(_t(w))), jso3.vee(jso3.hat(jnp.asarray(w))))
    assert torch.equal(so3.vee(so3.hat(_t(w))), _t(w))


def test_so3_axis_rotations_ypr_and_quaternions():
    """rx, ry, rz, ypr and from_quaternion against the JAX package's, and
    from_quaternion inverting to_quaternion."""
    rng = np.random.default_rng(12)
    a = rng.uniform(-np.pi, np.pi, size=(3, B))
    for f in ("rx", "ry", "rz"):
        _close(getattr(so3, f)(_t(a[0])), getattr(jso3, f)(jnp.asarray(a[0])))
    _close(so3.ypr(*map(_t, a)), jso3.ypr(*map(jnp.asarray, a)))
    q = rng.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(so3.from_quaternion(_t(q)), jso3.from_quaternion(jnp.asarray(q)))
    R = so3.from_quaternion(_t(q))
    _close(so3.from_quaternion(so3.to_quaternion(R)), R.numpy())


def test_se3_stack():
    """stack makes one batched SE3 of a list, as the JAX package's does."""
    T, jT = _se3_pair(np.random.default_rng(13))
    got = se3.stack([se3.SE3(T.R[k], T.t[k]) for k in range(4)])
    ref = jse3.stack([jse3.SE3(jT.R[k], jT.t[k]) for k in range(4)])
    _close(got.R, ref.R)
    _close(got.t, ref.t)
    assert got.R.shape == (4, 3, 3)
