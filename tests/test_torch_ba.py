"""Parity of gtsam_torch's Schur bundle adjustment with gtsam_tpu's (CPU).

The JAX side runs float64 (tests/conftest.py turns x64 on); the torch side
runs the plain PyTorch versions of the CUDA kernels, which is what the port
computes on CPU tensors.  Inputs are made with numpy from seeds and handed
to both packages.  Tolerances, each stated where it is used: 1e-10 for the
linearization, 1e-12 for the assembled reduced system, 1e-8 for the Schur
step where the system's conditioning allows it, 1e-6 for the LM result.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_torch import LMParams
from gtsam_torch.geometry.cameras import BalCamera, bal_retract
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.sfm import ba, ba_kernels, bal, synthetic
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.geometry.cameras import BalCamera as JBalCamera
from gtsam_tpu.geometry.se3 import SE3 as JSE3
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.sfm import ba as jba
from gtsam_tpu.sfm import bal as jbal
from gtsam_tpu.sfm import synthetic as jsynthetic

FIELDS = ("cam_R", "cam_t", "cam_calib", "points", "obs_cam", "obs_pt",
          "obs_uv")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, rtol):
    """rtol against each entry, atol rtol x the largest entry (near-zero
    entries of Jacobians and steps)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _push_behind(prob, pts):
    """Move points `pts` outside the camera ring: behind every camera that
    sees them (the cheirality penalty)."""
    prob = dataclasses.replace(prob, points=prob.points.copy())
    for j in pts:
        c = prob.obs_cam[np.argmax(prob.obs_pt == j)]
        prob.points[j] = 3.0 * prob.cam_t[c]
    return prob


def _with_special_tracks(prob, seed):
    """Append a point seen 70 times (a track longer than the JAX package's
    64-observation group cap, cycling through every camera, so it sees each
    one several times) and a 3-observation point that sees one camera
    twice.  Measurements are projections plus 1 px noise."""
    rng = np.random.default_rng(seed)
    M = prob.num_cameras
    cams = [np.arange(70) % M, np.array([1, 1, 2])]
    new_pts = [np.zeros(3) + rng.normal(size=3), rng.normal(size=3)]
    obs_cam, obs_pt, obs_uv = [prob.obs_cam], [prob.obs_pt], [prob.obs_uv]
    for i, (cs, p) in enumerate(zip(cams, new_pts)):
        pc = np.einsum("kji,kj->ki", prob.cam_R[cs], p - prob.cam_t[cs])
        assert (pc[:, 2] > 1.0).all()
        uv = pc[:, :2] / pc[:, 2:] * prob.cam_calib[cs, :1]
        obs_cam.append(cs.astype(np.int32))
        obs_pt.append(np.full(len(cs), prob.num_points + i, np.int32))
        obs_uv.append(uv + rng.normal(size=uv.shape))
    return dataclasses.replace(
        prob, points=np.concatenate([prob.points, np.stack(new_pts)]),
        obs_cam=np.concatenate(obs_cam), obs_pt=np.concatenate(obs_pt),
        obs_uv=np.concatenate(obs_uv))


def _jax_linearize(prob, obs_cam, obs_pt, uv):
    """JAX factors.linearize of the BAL projection batch with unit noise, as
    gtsam_tpu/sfm/ba.py:1319 builds it, on the given observation rows."""
    batch = jfactors.custom_factors(
        "ProjectionBal", ("BalCamera", "Point3"), np.zeros((1, 2), np.int64),
        jbal._projection_residual, 2, None, jnoise.unit())
    cams = JBalCamera(JSE3(jnp.asarray(prob.cam_R), jnp.asarray(prob.cam_t)),
                      jnp.asarray(prob.cam_calib))
    cam_k = jax.tree.map(lambda a: a[obs_cam], cams)
    (A_cam, A_pt), b = jfactors.linearize(
        batch, (cam_k, jnp.asarray(prob.points)[obs_pt]),
        measurements=jnp.asarray(uv))
    return np.asarray(A_cam), np.asarray(A_pt), np.asarray(b)


def _torch_problem(prob):
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cpu")
    uv = torch.as_tensor(prob.obs_uv[plan.order])
    cams, pts = ba.state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                                    prob.points, device="cpu")
    return plan, uv, cams, pts


# -- problem generation and I/O ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_make_bal_problem_identical(seed):
    a = synthetic.make_bal_problem(30, 800, 4, seed=seed)
    b = jsynthetic.make_bal_problem(30, 800, 4, seed=seed)
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_bal_file_roundtrip(tmp_path):
    prob = synthetic.make_bal_problem(12, 150, 4, seed=5)
    path = str(tmp_path / "synthetic.bal")
    bal.write_bal(path, prob)
    got, ref = bal.read_bal(path), jbal.read_bal(path)
    for f in FIELDS:
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    np.testing.assert_allclose(got.cam_R, prob.cam_R, atol=1e-12)
    np.testing.assert_allclose(got.cam_t, prob.cam_t, atol=1e-12 * 50.0)
    assert np.array_equal(got.points, prob.points)
    assert np.array_equal(got.obs_uv, prob.obs_uv)


# -- linearization and error ---------------------------------------------------


@pytest.fixture(scope="module")
def behind():
    """(12, 150) problem with four points pushed behind their cameras."""
    return _push_behind(synthetic.make_bal_problem(12, 150, 4, seed=0),
                        [0, 5, 17, 40])


def test_linearize_matches_jax(behind):
    plan, uv, cams, pts = _torch_problem(behind)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv)
    order = plan.order
    jA_cam, jA_pt, jb = _jax_linearize(behind, behind.obs_cam[order],
                                       behind.obs_pt[order],
                                       behind.obs_uv[order])
    invalid = (jb == -bal.CHEIRALITY_PENALTY).all(1)
    assert invalid.sum() >= 4
    assert not A_cam[invalid].any() and not A_pt[invalid].any()
    _close(A_cam, jA_cam, 1e-10)
    _close(A_pt, jA_pt, 1e-10)
    _close(b, jb, 1e-10)


def test_linearize_matches_jacfwd(behind):
    """The analytic Jacobians equal forward-mode derivatives of the port's
    own residual through the right retraction of the camera and point."""
    plan, uv, cams, pts = _torch_problem(behind)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv)
    oc, op = plan.obs_cam.long(), plan.obs_pt.long()
    cam_k = BalCamera(SE3(cams.pose.R[oc], cams.pose.t[oc]), cams.calib[oc])

    def residual(dc, dp, cam, point, m):
        return bal._projection_residual(bal_retract(cam, dc), point + dp, m)

    zc, zp = torch.zeros(9, dtype=torch.float64), torch.zeros(3,
                                                            dtype=torch.float64)
    Jc, Jp = torch.func.vmap(
        torch.func.jacfwd(residual, argnums=(0, 1)),
        in_dims=(None, None, 0, 0, 0))(zc, zp, cam_k, pts[op], uv)
    _close(A_cam, Jc, 1e-10)
    _close(A_pt, Jp, 1e-10)
    _close(b, -residual(zc, zp, cam_k, pts[op], uv), 1e-12)


def test_error_matches_jax(behind):
    plan, uv, cams, pts = _torch_problem(behind)
    _, _, jb = _jax_linearize(behind, behind.obs_cam, behind.obs_pt,
                              behind.obs_uv)
    np.testing.assert_allclose(ba.error(plan, cams, pts, uv),
                               0.5 * np.sum(jb * jb), rtol=1e-12)


# -- the Schur step ------------------------------------------------------------


def _schur_case(prob, lam, dd):
    """JAX and port Schur steps on the same Jacobians (JAX's linearization,
    permuted into each package's observation order)."""
    st, order = jba.SchurStructure.build(prob.obs_cam, prob.obs_pt,
                                         prob.num_cameras, prob.num_points)
    jA, jP, jb = _jax_linearize(prob, prob.obs_cam[order],
                                prob.obs_pt[order], prob.obs_uv[order])
    plan, uv, cams, pts = _torch_problem(prob)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    rows = inv[plan.order]
    tA, tP, tb = (torch.from_numpy(x[rows]) for x in (jA, jP, jb))
    M = prob.num_cameras
    jA, jP, jb = jnp.asarray(jA), jnp.asarray(jP), jnp.asarray(jb)
    Sj, gj = jba.schur_solve(st, jA, jP, jb, lam, dd, _stage="S")
    # JAX assembles parameter-major (row i*M + c); the port camera-major
    Sj = np.asarray(Sj).reshape(9, M, 9, M).transpose(1, 0, 3, 2).reshape(
        9 * M, 9 * M)
    S = torch.empty((9 * M, 9 * M), dtype=torch.float64)
    g, _, _, _ = ba.assemble(plan, tA, tP, tb, lam, dd, S)
    dcj, dlj = jba.schur_solve(st, jA, jP, jb, lam, dd)
    dc, dl = ba.schur_solve(plan, tA, tP, tb, lam, dd)
    return dict(st=st, S=S, g=g, Sj=Sj, gj=np.asarray(gj), dc=dc, dl=dl,
                dcj=np.asarray(dcj), dlj=np.asarray(dlj), plan=plan, uv=uv,
                cams=cams, pts=pts)


@pytest.mark.parametrize("dd", [False, True], ids=["lam_I", "diagonal"])
def test_schur_solve_matches_jax(dd):
    prob = synthetic.make_bal_problem(12, 150, 4, seed=0)
    c = _schur_case(prob, 1e-4, dd)
    # the assembled reduced system: same sums in another order
    _close(c["S"], c["Sj"], 1e-12)
    _close(c["g"], c["gj"], 1e-12)
    if dd:
        _close(c["dc"], c["dcj"], 1e-8)
        _close(c["dl"], c["dlj"], 1e-8)
        return
    # With lam I damping at 1e-4 the equilibrated system's condition number
    # exceeds 1e7 (the 7-dof gauge of BA is held only by the damping), so
    # two float64 Cholesky solves of it agree only to ~cond x eps, which is
    # above 1e-8 on dc.  Held instead: the port's step solves JAX's system
    # as well as JAX's step does, and moves the half-chi2 identically.
    d = np.sqrt(np.diag(c["Sj"]))
    assert np.linalg.cond(c["Sj"] / np.outer(d, d)) > 1e7
    x, xj = c["dc"].numpy().reshape(-1), c["dcj"].reshape(-1)
    res = np.abs(c["Sj"] @ x - c["gj"].reshape(-1)).max()
    resj = np.abs(c["Sj"] @ xj - c["gj"].reshape(-1)).max()
    assert res <= 10 * resj + 1e-14 * np.abs(c["gj"]).max()

    def moved(dc, dl):
        dc, dl = torch.as_tensor(np.array(dc)), torch.as_tensor(np.array(dl))
        return ba.error(c["plan"], bal_retract(c["cams"], dc), c["pts"] + dl,
                        c["uv"])

    np.testing.assert_allclose(moved(c["dc"], c["dl"]),
                               moved(c["dcj"], c["dlj"]), rtol=1e-8)


def test_schur_solve_long_track_and_repeated_camera():
    prob = _with_special_tracks(synthetic.make_bal_problem(12, 150, 4, seed=2),
                                seed=2)
    c = _schur_case(prob, 1e-4, True)
    assert c["st"].pt_tail is not None   # JAX took its general pair path
    _close(c["S"], c["Sj"], 1e-12)
    _close(c["g"], c["gj"], 1e-12)
    _close(c["dc"], c["dcj"], 1e-8)
    _close(c["dl"], c["dlj"], 1e-8)


@pytest.mark.parametrize("dd", [False, True], ids=["lam_I", "diagonal"])
def test_plain_kernels_match_dense_schur(dd):
    """The plain versions of kernels 2-4 against the reduced system and the
    back-substitution built densely from J: S = Hpp - Hpl Hll^-1 Hlp.
    Under lam I damping one point lies behind its cameras (zero rows); under
    diagonal damping such a point has a singular block in both packages."""
    prob = _with_special_tracks(synthetic.make_bal_problem(8, 60, 4, seed=4),
                                seed=4)
    if not dd:
        prob = _push_behind(prob, [3])
    plan, uv, cams, pts = _torch_problem(prob)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv)
    M, N, K = prob.num_cameras, prob.num_points, prob.num_observations
    # lam 1 keeps each damped point block well conditioned.  S is held to
    # 1e-9 of its largest entry: the 70-observation track's camera blocks
    # cancel heavily (Hpp and W C W^T nearly equal), so the dense product
    # and the per-pair sums differ by a few 1e-10 of max |S|.
    lam = 1.0
    J = torch.zeros((2 * K, 9 * M + 3 * N), dtype=torch.float64)
    for k in range(K):
        c, p = int(plan.obs_cam[k]), int(plan.obs_pt[k])
        J[2 * k:2 * k + 2, 9 * c:9 * c + 9] = A_cam[k]
        J[2 * k:2 * k + 2, 9 * M + 3 * p:9 * M + 3 * p + 3] = A_pt[k]
    H, gr = J.T @ J, J.T @ b.reshape(-1)
    Hcc, Hcl, Hll = H[:9 * M, :9 * M], H[:9 * M, 9 * M:], H[9 * M:, 9 * M:]
    eye9 = torch.eye(9 * M, dtype=torch.float64)
    Hcc_d = Hcc + torch.diag(lam * Hcc.diagonal()) if dd else Hcc + lam * eye9
    blocks = Hll.reshape(N, 3, N, 3).diagonal(dim1=0, dim2=2).permute(2, 0, 1)
    lam_eff = (blocks.diagonal(dim1=1, dim2=2).sum(1) / 3.0 * lam if dd
               else torch.full((N,), lam, dtype=torch.float64))
    Hll_d = Hll + torch.diag(lam_eff.repeat_interleave(3))
    Hll_inv = torch.linalg.inv(Hll_d)
    S_dense = Hcc_d - Hcl @ Hll_inv @ Hcl.T
    g_dense = gr[:9 * M] - Hcl @ Hll_inv @ gr[9 * M:]

    S = torch.empty((9 * M, 9 * M), dtype=torch.float64)
    g, W, C, gl = ba.assemble(plan, A_cam, A_pt, b, lam, dd, S)
    _close(S, S_dense, 1e-9)
    _close(g.reshape(-1), g_dense, 1e-10)
    dc = torch.from_numpy(np.random.default_rng(0).normal(size=(M, 9)))
    dl = ba_kernels.back_substitute(plan.pt_ptr, plan.obs_cam, W, dc, C, gl)
    dl_dense = Hll_inv @ (gr[9 * M:] - Hcl.T @ dc.reshape(-1))
    _close(dl.reshape(-1), dl_dense, 1e-10)


def test_dense_spd_solve():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(40, 40))
    d = np.exp(rng.uniform(-6, 6, size=40))     # scales spanning ~1e5
    Sn = d[:, None] * (A @ A.T + 40 * np.eye(40)) * d[None, :]
    rhs = rng.normal(size=40)
    x = ba._dense_spd_solve(torch.from_numpy(Sn.copy()), torch.from_numpy(rhs))
    _close(x, np.linalg.solve(Sn, rhs), 1e-10)
    indefinite = torch.from_numpy(np.diag([1.0, -1.0, 2.0]))
    assert ba._dense_spd_solve(indefinite, torch.ones(3,
                                                      dtype=torch.float64)) \
        is None


def test_cholesky_failure_is_a_failed_try():
    """A camera without observations under diagonal damping leaves S
    singular: the step is NaN and LM rejects it without raising, as the JAX
    package rejects its NaN step."""
    prob = synthetic.make_bal_problem(12, 150, 4, seed=0)
    prob = dataclasses.replace(
        prob, cam_R=np.concatenate([prob.cam_R, prob.cam_R[:1]]),
        cam_t=np.concatenate([prob.cam_t, prob.cam_t[:1]]),
        cam_calib=np.concatenate([prob.cam_calib, prob.cam_calib[:1]]))
    plan, uv, cams, pts = _torch_problem(prob)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv)
    dc, dl = ba.schur_solve(plan, A_cam, A_pt, b, 1e-4, True)
    assert torch.isnan(dc).all() and torch.isnan(dl).all()
    params = LMParams(max_iterations=3, diagonal_damping=True)
    _, info = ba.ba_optimize(prob, params, device="cpu")
    assert not info["converged"] and info["iterations"] == 1
    assert info["error"] == info["history"][0]
    _, jinfo = jba.ba_optimize(prob, gt.LMParams(max_iterations=3,
                                                 diagonal_damping=True))
    np.testing.assert_allclose(info["error"], jinfo["error"], rtol=1e-12)


# -- the LM loop -------------------------------------------------------------


@pytest.mark.parametrize("policy", ["gtsam", "conservative"])
def test_ba_optimize_matches_jax(policy):
    """Final half-chi2 against JAX's float64 ba_optimize (the bar of
    tests/test_sfm.py:98); the conservative case uses bench.py's settings."""
    prob = synthetic.make_bal_problem(30, 800, 4, seed=0)
    kw = dict(max_iterations=20)
    if policy == "conservative":
        kw.update(relative_error_tol=1e-6, lambda_policy="conservative",
                  lambda_initial=1e-4, lambda_lower_bound=1e-4)
    _, info = ba.ba_optimize(prob, LMParams(**kw), device="cpu")
    _, jinfo = jba.ba_optimize(prob, gt.LMParams(**kw))
    np.testing.assert_allclose(info["error"], jinfo["error"], rtol=1e-6)
    assert info["converged"] and jinfo["converged"]
    assert set(info) >= {"error", "iterations", "converged", "history",
                         "iter_times", "phases"}
    assert info["phases"] == ["float64"] * len(info["iter_times"])
    assert len(info["history"]) == info["iterations"] + 1


def test_target_error_stops_early():
    prob = synthetic.make_bal_problem(30, 800, 4, seed=0)
    _, full = ba.ba_optimize(prob, LMParams(max_iterations=20), device="cpu")
    target = full["history"][1] * (1 + 1e-9)
    _, info = ba.ba_optimize(prob, LMParams(max_iterations=20), device="cpu",
                             target_error=target)
    assert info["iterations"] == 1 and info["converged"]
    assert info["error"] <= target


def test_state_carry_continues_jax_run():
    """One JAX LM iteration, carried into the port, gives the next error of
    a JAX two-iteration run.  lambda 1e-2 keeps the damped system well
    conditioned, so the two packages' steps agree closely."""
    prob = synthetic.make_bal_problem(20, 400, 4, seed=6)
    lm = dict(lambda_initial=1e-2, lambda_factor=10.0)
    vals, j1 = jba.ba_optimize(prob, gt.LMParams(max_iterations=1, **lm))
    _, j2 = jba.ba_optimize(prob, gt.LMParams(max_iterations=2, **lm))
    assert j1["history"][1] < j1["history"][0]    # accepted at 1e-2
    cam = vals["cams"]
    state = ba.state_from_numpy(np.asarray(cam.pose.R), np.asarray(cam.pose.t),
                                np.asarray(cam.calib),
                                np.asarray(vals["points"]), device="cpu")
    np.testing.assert_allclose(
        ba.state_to_numpy(*state)[3], np.asarray(vals["points"]), rtol=0)
    _, info = ba.ba_optimize(
        prob, LMParams(max_iterations=1, lambda_initial=1e-3), device="cpu",
        initial=state)
    np.testing.assert_allclose(info["history"][0], j2["history"][1],
                               rtol=1e-12)
    np.testing.assert_allclose(info["history"][1], j2["history"][2],
                               rtol=1e-8)
