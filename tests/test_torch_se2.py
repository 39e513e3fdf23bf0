"""Parity of gtsam_torch.geometry.se2 with gtsam_tpu.geometry.se2 (float64,
CPU).

The same numpy inputs, made from a seed, go through the JAX function and its
torch counterpart.  Each batch holds the angles where SE(2)'s branches
switch: 0, 1e-7 (below the Taylor threshold w^2 < 1e-10 of expmap and
logmap), mid-range, +-pi and past pi (logmap's wrap by atan2; compose
does not wrap).  Outputs agree to 1e-14 relative to each entry, with an
absolute floor of 1e-14 times the largest entry: the functions are the
same few operations in the same order on both sides (sin, cos and atan2
from the same libm), which leaves a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_torch.geometry import se2
from gtsam_tpu.geometry import se2 as jse2

TOL = 1e-14


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _angles(rng, n):
    th = rng.uniform(-3.0, 3.0, size=n)
    th[:8] = [0.0, 1e-7, -1e-7, 0.7, np.pi, -np.pi, np.pi + 0.4,
              -2 * np.pi - 0.3]
    return th


def _poses(rng, n=24):
    return np.concatenate([rng.normal(size=(n, 2)) * 4.0,
                           _angles(rng, n)[:, None]], axis=1)


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _inputs(name, rng):
    """Numpy arguments of se2's function `name`."""
    p, q = _poses(rng), _poses(rng)
    pt = rng.normal(size=(24, 2)) * 5.0
    xi = np.concatenate([rng.normal(size=(24, 2)) * 2.0,
                         _angles(rng, 24)[:, None]], axis=1)
    return {"theta": (p,), "rot": (p,), "expmap": (xi,), "logmap": (p,),
            "inverse": (p,), "compose": (p, q), "between": (p, q),
            "retract": (p, xi), "local": (p, q), "transform_from": (p, pt),
            "transform_to": (p, pt), "bearing": (p, pt),
            "range_to": (p, pt), "_wrap": (p[:, 2],)}[name]


FUNCTIONS = ["theta", "rot", "_wrap", "expmap", "logmap", "inverse",
             "compose", "between", "retract", "local", "transform_from",
             "transform_to", "bearing", "range_to"]


@pytest.mark.parametrize("name", FUNCTIONS)
def test_against_jax(name):
    """Each function of gtsam_tpu/geometry/se2.py on the same batch (the
    branch angles included) at 1e-14."""
    args = _inputs(name, np.random.default_rng(FUNCTIONS.index(name)))
    got = getattr(se2, name)(*map(_t, args))
    ref = getattr(jse2, name)(*map(jnp.asarray, args))
    _close(got, ref)


def test_identity():
    assert torch.equal(se2.identity(), torch.zeros(3, dtype=torch.float64))
    np.testing.assert_array_equal(se2.identity().numpy(),
                                  np.asarray(jse2.identity()))


def test_wrap_and_logmap_range():
    """logmap wraps by atan2(sin, cos) into [-pi, pi] (the JAX package's
    values at +-pi, where sin rounds to +-1.2e-16, included), compose
    keeps the sum of the angles, and expmap keeps its angle as given."""
    th = np.array([np.pi, -np.pi, 3 * np.pi, np.pi + 1e-3, -np.pi - 1e-3])
    w = se2.logmap(_t(np.stack([np.zeros(5), np.zeros(5), th], 1)))[:, 2]
    assert torch.all(w.abs() <= np.pi)
    assert abs(float(w[3]) + np.pi - 1e-3) < 1e-12
    _close(w, jse2.logmap(jnp.asarray(np.stack([np.zeros(5), np.zeros(5),
                                                th], 1)))[:, 2])
    p = _t([[0.0, 0.0, 3.0]])
    assert float(se2.compose(p, p)[0, 2]) == 6.0
    assert float(se2.expmap(_t([[0.0, 0.0, 4.0]]))[0, 2]) == 4.0


def test_small2_branch():
    """_small2's threshold by dtype (1e-10 in float64, 1e-3 in float32), as
    the JAX package's; expmap and logmap at w^2 just below and above the
    float64 threshold agree with the JAX package's, and float32 inputs take
    the float32 threshold."""
    assert se2._small2(torch.zeros((), dtype=torch.float64)) == 1e-10
    assert se2._small2(torch.zeros((), dtype=torch.float32)) == 1e-3
    assert jse2._small2(jnp.zeros((), jnp.float32)) == 1e-3
    w = np.array([0.99e-5, 1.01e-5, -0.99e-5, -1.01e-5])
    xi = np.stack([np.full(4, 1.5), np.full(4, -0.5), w], 1)
    _close(se2.expmap(_t(xi)), jse2.expmap(jnp.asarray(xi)))
    _close(se2.logmap(_t(xi)), jse2.logmap(jnp.asarray(xi)))
    x32 = torch.tensor([[1.0, 2.0, 0.02]], dtype=torch.float32)
    ref = jse2.expmap(jnp.asarray(x32.numpy()))
    _close(se2.expmap(x32).double(), np.asarray(ref, dtype=np.float64), 1e-6)


@pytest.mark.parametrize("w", [0.0, 1e-7, 0.03, 0.07, 0.5, 3.0, np.pi])
def test_right_jacobian_inverse_and_adjoint(w):
    """The closed forms kernel 6's Pose2 variant uses: Jr^-1(r) and
    Ad(Tj^-1 Ti) give jacfwd of the JAX package's between residual
    Local(Z, Ti^-1 Tj) under right retractions, A_j = Jr^-1(r) and
    A_i = -Jr^-1(r) Ad(Tj^-1 Ti), with the residual's angle at w (either
    side of Jr^-1's series threshold w^2 = 5e-3).  1e-12 relative to the
    largest entry; at 0.03 and 0.07 plus 4e-16 / w^2: there jacfwd
    differentiates logmap's closed form (w^2 above its 1e-10 threshold),
    whose cancellation in 1 - cos w costs ~eps / w^2, where the closed form
    takes its series (measured: 2e-13 at 0.03; 1.6e-7 at w = 1e-4)."""
    rng = np.random.default_rng(int(w * 1000) + 5)
    Ti = np.array([1.3, -0.4, 0.6])
    Tj = np.array([2.1, 0.9, -1.1])
    E = jse2.between(jnp.asarray(Ti), jnp.asarray(Tj))
    off = np.concatenate([rng.normal(size=2) * 0.3, [w]])
    Z = np.asarray(jse2.compose(E, jse2.expmap(-jnp.asarray(off))))

    def res(di, dj):
        return jse2.local(jnp.asarray(Z), jse2.between(
            jse2.retract(jnp.asarray(Ti), di), jse2.retract(jnp.asarray(Tj),
                                                            dj)))
    z3 = jnp.zeros(3)
    Ji, Jj = jax.jacfwd(res, argnums=(0, 1))(z3, z3)
    r = np.asarray(res(z3, z3))
    assert abs(abs(r[2]) - w) < 1e-9
    Jinv = se2.right_jacobian_inverse(_t(r))
    Ai = -(Jinv @ se2.adjoint(se2.between(_t(Tj), _t(Ti))))
    tol = 1e-12 if w == 0.0 or w > 0.1 or w < 1e-5 else 1e-12 + 4e-16 / w ** 2
    _close(Jinv, Jj, tol)
    _close(Ai, Ji, tol)
