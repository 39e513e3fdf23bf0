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
    M = prob.num_cameras
    return synthetic.add_tracks(prob, [np.arange(70) % M, np.array([1, 1, 2])],
                                seed)


def _jax_linearize(prob, obs_cam, obs_pt, uv, **dtypes):
    """JAX factors.linearize of the BAL projection batch with unit noise, as
    gtsam_tpu/sfm/ba.py:1319 builds it, on the given observation rows
    (dtypes: its out_dtype and b_dtype)."""
    batch = jfactors.custom_factors(
        "ProjectionBal", ("BalCamera", "Point3"), np.zeros((1, 2), np.int64),
        jbal._projection_residual, 2, None, jnoise.unit())
    cams = JBalCamera(JSE3(jnp.asarray(prob.cam_R), jnp.asarray(prob.cam_t)),
                      jnp.asarray(prob.cam_calib))
    cam_k = jax.tree.map(lambda a: a[obs_cam], cams)
    (A_cam, A_pt), b = jfactors.linearize(
        batch, (cam_k, jnp.asarray(prob.points)[obs_pt]),
        measurements=jnp.asarray(uv), **dtypes)
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
        return bal._schur_projection_residual(bal_retract(cam, dc), point + dp,
                                              m)

    zc, zp = torch.zeros(9, dtype=torch.float64), torch.zeros(3,
                                                            dtype=torch.float64)
    Jc, Jp = torch.func.vmap(
        torch.func.jacfwd(residual, argnums=(0, 1)),
        in_dims=(None, None, 0, 0, 0))(zc, zp, cam_k, pts[op], uv)
    _close(A_cam, Jc, 1e-10)
    _close(A_pt, Jp, 1e-10)
    _close(b, -residual(zc, zp, cam_k, pts[op], uv), 1e-12)


def test_linearize_f32_matches_jax(behind):
    """The mixed mode's linearization, float32 Jacobians and float64 b,
    against JAX's factors.linearize(out_dtype=f32, b_dtype=f64)
    (gtsam_tpu/graph/factors.py:147-176; with x64 on it computes in float64
    and rounds once, as the port does).  Each Jacobian entry within one f32
    ulp of its row's largest entry: two float64 values that differ at ~1e-13
    may round to neighbouring floats.  b to 1e-10, as in float64."""
    plan, uv, cams, pts = _torch_problem(behind)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv, torch.float32)
    assert A_cam.dtype == A_pt.dtype == torch.float32
    assert b.dtype == torch.float64
    order = plan.order
    jA_cam, jA_pt, jb = _jax_linearize(
        behind, behind.obs_cam[order], behind.obs_pt[order],
        behind.obs_uv[order], out_dtype=jnp.float32, b_dtype=jnp.float64)
    assert jA_cam.dtype == np.float32 and jb.dtype == np.float64
    for got, ref in ((A_cam.numpy(), jA_cam), (A_pt.numpy(), jA_pt)):
        ulp = np.spacing(np.abs(ref).max(axis=2, keepdims=True))
        assert (np.abs(got.astype(np.float64) - ref) <= ulp).all()
    _close(b, jb, 1e-10)
    # the float32 Jacobians are the float64 ones rounded once
    A64, P64, b64 = ba.linearize(plan, cams, pts, uv)
    assert torch.equal(A_cam, A64.float()) and torch.equal(A_pt, P64.float())
    assert torch.equal(b, b64)


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
    g, s = ba.assemble(plan, tA, tP, tb, lam, dd, S)[:2]
    dcj, dlj = jba.schur_solve(st, jA, jP, jb, lam, dd)
    dc, dl = ba.schur_solve(plan, tA, tP, tb, lam, dd)
    return dict(st=st, S=S, s=s, g=g, Sj=Sj, gj=np.asarray(gj), dc=dc, dl=dl,
                dcj=np.asarray(dcj), dlj=np.asarray(dlj), plan=plan, uv=uv,
                cams=cams, pts=pts)


def _check_equilibrated(c, g_rtol=1e-12):
    """The port's S is JAX's S equilibrated: S / (s s^T) equals JAX's S and
    s equals rsqrt(clamp(diag S_jax, 1e-12)), both to 1e-12 (the same sums
    in another order); g~ to g_rtol."""
    s = c["s"].numpy()
    _close(c["S"].numpy() / np.outer(s, s), c["Sj"], 1e-12)
    _close(s, 1.0 / np.sqrt(np.clip(np.diag(c["Sj"]), 1e-12, None)), 1e-12)
    _close(c["g"], c["gj"], g_rtol)


@pytest.mark.parametrize("dd", [False, True], ids=["lam_I", "diagonal"])
def test_schur_solve_matches_jax(dd):
    prob = synthetic.make_bal_problem(12, 150, 4, seed=0)
    c = _schur_case(prob, 1e-4, dd)
    # the assembled reduced system
    _check_equilibrated(c)
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
    _check_equilibrated(c)
    _close(c["dc"], c["dcj"], 1e-8)
    _close(c["dl"], c["dlj"], 1e-8)


def test_schur_solve_long_track_and_repeated_camera_lam_I():
    """The same tracks under lam I damping: the gauge-limited system of
    test_schur_solve_matches_jax, so the step is held by residual as there."""
    prob = _with_special_tracks(synthetic.make_bal_problem(12, 150, 4, seed=2),
                                seed=2)
    c = _schur_case(prob, 1e-4, False)
    # g~ carries C gl of the track that sees camera 1 twice: at lam 1e-4 its
    # depth is held only by lam, and two correct 3x3 inverses of its block
    # differ at ~1e-11 of max |g~|
    _check_equilibrated(c, g_rtol=1e-10)
    x, xj = c["dc"].numpy().reshape(-1), c["dcj"].reshape(-1)
    res = np.abs(c["Sj"] @ x - c["gj"].reshape(-1)).max()
    resj = np.abs(c["Sj"] @ xj - c["gj"].reshape(-1)).max()
    assert res <= 10 * resj + 1e-14 * np.abs(c["gj"]).max()


def _cell_problems():
    return {"synthetic": synthetic.make_bal_problem(12, 150, 4, seed=0),
            "special": _with_special_tracks(
                synthetic.make_bal_problem(12, 150, 4, seed=2), seed=2)}


@pytest.mark.parametrize("name", ["synthetic", "special"])
def test_cell_plan_covers_every_pair_once(name):
    """The cell CSR, built by to(device) with torch: every directed pair of
    every point's rows exactly once, cells sorted by ca * M + cb with their
    pairs in point order, and the cell set of the JAX plan
    (gtsam_tpu/sfm/ba.py:110-113)."""
    prob = _cell_problems()[name]
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cpu")
    M, K = prob.num_cameras, prob.num_observations
    pt_ptr, oc = plan.pt_ptr.numpy(), plan.obs_cam.numpy().astype(np.int64)
    want = np.sort(np.concatenate([
        (np.arange(s, e)[:, None] * K + np.arange(s, e)[None, :]).reshape(-1)
        for s, e in zip(pt_ptr[:-1], pt_ptr[1:])]))
    a, b = plan.cell_a.numpy().astype(np.int64), plan.cell_b.numpy()
    assert plan.num_pairs == len(a) == len(want)
    assert np.array_equal(np.sort(a * K + b), want)
    cell_ptr = plan.cell_ptr.numpy()
    ca, cb = plan.cell_ca.numpy(), plan.cell_cb.numpy()
    keys = ca.astype(np.int64) * M + cb
    assert cell_ptr[0] == 0 and cell_ptr[-1] == len(a)
    assert (np.diff(keys) > 0).all() and (np.diff(cell_ptr) > 0).all()
    of = np.repeat(np.arange(len(keys)), np.diff(cell_ptr))
    assert np.array_equal(oc[a], ca[of]) and np.array_equal(oc[b], cb[of])
    pos = a * K + b     # point order: rows of one point are contiguous
    for u in range(len(keys)):
        assert (np.diff(pos[cell_ptr[u]:cell_ptr[u + 1]]) > 0).all()
    diag = plan.diag_cell.numpy()
    has = np.flatnonzero(diag >= 0)
    assert np.array_equal(ca[diag[has]], has) and np.array_equal(cb[diag[has]],
                                                                 has)
    assert set(has) == set(oc) and (ca == cb).sum() == len(has)
    st, _ = jba.SchurStructure.build(prob.obs_cam, prob.obs_pt, M,
                                     prob.num_points)
    assert set(keys.tolist()) == set(np.asarray(st.cell_unique).tolist())


@pytest.mark.parametrize("name", ["synthetic", "special"])
def test_point_tiles_cover_every_point_once(name):
    """Kernel 2's row tiles: tile j holds the points whose first row lies in
    [j, j + 1) x POINT_TILE_ROWS (the last tile also those past the end),
    so every point is in exactly one tile and tiles do not share rows."""
    prob = _cell_problems()[name]
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cpu")
    tile, pt_ptr = plan.pt_tile.numpy(), plan.pt_ptr.numpy()
    R, K = ba_kernels.POINT_TILE_ROWS, prob.num_observations
    assert len(tile) == max(1, -(-K // R)) + 1
    assert tile[0] == 0 and tile[-1] == prob.num_points
    assert (np.diff(tile) >= 0).all()
    for j in range(len(tile) - 1):
        starts = pt_ptr[tile[j]:tile[j + 1]]
        assert (starts >= j * R).all()
        assert j == len(tile) - 2 or (starts < (j + 1) * R).all()


def test_assembly_is_reproducible():
    """No atomics: two assemblies of the same inputs give the same bits."""
    prob = _with_special_tracks(synthetic.make_bal_problem(12, 150, 4, seed=2),
                                seed=2)
    plan, uv, cams, pts = _torch_problem(prob)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv)
    n = 9 * prob.num_cameras
    outs = []
    for _ in range(2):
        S = torch.full((n, n), float("nan"), dtype=torch.float64)
        red = ba.assemble(plan, A_cam, A_pt, b, 1e-4, False, S)
        assert red.Hpp_d is None
        outs.append((S,) + tuple(red[:6]))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert not torch.isnan(outs[0][0]).any()


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
    g, s, W, C, gl = ba.assemble(plan, A_cam, A_pt, b, lam, dd, S)[:5]
    # S comes equilibrated: undo the scaling s s^T
    _close(S / torch.outer(s, s), S_dense, 1e-9)
    _close(s, S_dense.diagonal().clamp(min=1e-12).rsqrt(), 1e-12)
    _close(g.reshape(-1), g_dense, 1e-10)
    dc = torch.from_numpy(np.random.default_rng(0).normal(size=(M, 9)))
    dl = ba_kernels.back_substitute(plan.pt_ptr, plan.pt_tile, plan.obs_cam,
                                    W, dc, C, gl)
    dl_dense = Hll_inv @ (gr[9 * M:] - Hcl.T @ dc.reshape(-1))
    _close(dl.reshape(-1), dl_dense, 1e-10)


def test_dense_spd_solve():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(40, 40))
    d = np.exp(rng.uniform(-6, 6, size=40))     # scales spanning ~1e5
    Sn = d[:, None] * (A @ A.T + 40 * np.eye(40)) * d[None, :]
    rhs = rng.normal(size=40)
    S = torch.from_numpy(Sn.copy())
    s = ba.equilibrate(S)
    _close(S.diagonal(), np.ones(40), 1e-14)
    x = ba._dense_spd_solve(S, torch.from_numpy(rhs), s)
    _close(x, np.linalg.solve(Sn, rhs), 1e-10)
    indefinite = torch.from_numpy(np.diag([1.0, -1.0, 2.0]))
    s = ba.equilibrate(indefinite)
    assert ba._dense_spd_solve(indefinite, torch.ones(3, dtype=torch.float64),
                               s) is None


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


# -- the mixed-precision mode ---------------------------------------------------


def _dense_system(plan, A_cam, A_pt, b, lam, dd):
    """The damped Gauss-Newton system of the Jacobians in float64, dense:
    (H, g, Hcc_d, Hcl, Hll_d) with the damping of gtsam_tpu/sfm/ba.py
    (lam I, or cameras x (1 + lam) and points + trace / 3 x lam)."""
    A_cam, A_pt = A_cam.double(), A_pt.double()
    M, N, K = plan.num_cameras, plan.num_points, A_cam.shape[0]
    J = torch.zeros((2 * K, 9 * M + 3 * N), dtype=torch.float64)
    for k in range(K):
        c, p = int(plan.obs_cam[k]), int(plan.obs_pt[k])
        J[2 * k:2 * k + 2, 9 * c:9 * c + 9] = A_cam[k]
        J[2 * k:2 * k + 2, 9 * M + 3 * p:9 * M + 3 * p + 3] = A_pt[k]
    H, g = J.T @ J, J.T @ b.reshape(-1)
    Hcc, Hcl, Hll = H[:9 * M, :9 * M], H[:9 * M, 9 * M:], H[9 * M:, 9 * M:]
    if dd:
        Hcc_d = Hcc + torch.diag(lam * Hcc.diagonal())
        blocks = Hll.reshape(N, 3, N, 3).diagonal(dim1=0, dim2=2)
        lam_eff = blocks.diagonal(dim1=0, dim2=1).sum(1) / 3.0 * lam
    else:
        Hcc_d = Hcc + lam * torch.eye(9 * M, dtype=torch.float64)
        lam_eff = torch.full((N,), lam, dtype=torch.float64)
    Hll_d = Hll + torch.diag(lam_eff.repeat_interleave(3))
    H_d = torch.cat([torch.cat([Hcc_d, Hcl], 1),
                     torch.cat([Hcl.T, Hll_d], 1)], 0)
    return H_d, g, Hcc_d, Hcl, Hll_d


@pytest.mark.parametrize("dd", [False, True], ids=["lam_I", "diagonal"])
def test_mixed_schur_solve_matches_df_and_oracle(dd):
    """The mixed mode's Schur step (float32 Jacobians, float64 b) against
    the JAX package's two-float _schur_solve_df and against the dense
    float64 solve of the damped system built from the same float32 entries,
    on the fixture of tests/test_sfm.py:192-248.  The port's error to that
    oracle is no larger than the JAX package's (the port sums in float64
    where JAX sums in f32 pairs; both factorize in float32 and refine), and
    dc and dl are within that test's 2e-4 and 3e-3 of their largest
    entries.  dc comes back float64 and dl float32, as in the JAX
    package."""
    prob = jsynthetic.make_bal_problem(num_cameras=8, num_points=80,
                                       obs_per_point=3, seed=3)
    M, N = prob.num_cameras, prob.num_points
    st, order = jba.SchurStructure.build(prob.obs_cam, prob.obs_pt, M, N)
    jA, jP, jb = _jax_linearize(prob, prob.obs_cam[order], prob.obs_pt[order],
                                prob.obs_uv[order], out_dtype=jnp.float32,
                                b_dtype=jnp.float64)
    lam = 1e-3
    dcj, dlj = jba._schur_solve_df(st, jnp.asarray(jA), jnp.asarray(jP),
                                   jnp.asarray(jb), lam, dd)
    plan, _, _, _ = _torch_problem(prob)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    rows = inv[plan.order]
    tA, tP, tb = (torch.from_numpy(x[rows]) for x in (jA, jP, jb))
    dc, dl = ba.schur_solve(plan, tA, tP, tb, lam, dd, mixed_precision=True)
    assert dc.dtype == torch.float64 and dl.dtype == torch.float32

    H, g, *_ = _dense_system(plan, tA, tP, tb, lam, dd)
    sol = torch.linalg.solve(H, g).numpy()
    dc_ref, dl_ref = sol[:9 * M].reshape(M, 9), sol[9 * M:].reshape(N, 3)
    for got, jgot, ref, tol in ((dc.numpy(), np.asarray(dcj), dc_ref, 2e-4),
                                (dl.numpy(), np.asarray(dlj), dl_ref, 3e-3)):
        err, jerr = np.abs(got - ref).max(), np.abs(jgot - ref).max()
        assert err <= jerr, (err, jerr)
        assert err <= tol * np.abs(ref).max()


@pytest.mark.parametrize("name", ["synthetic", "special"])
def test_schur_matvec_plain_matches_dense(name):
    """schur_matvec_plain (Hpp_d x - sum WC u, from the float32 Jacobians'
    exact float64 Gram products) against the dense unequilibrated
    S_red = Hcc_d - Hcl Hll_d^-1 Hlc of the same entries times x, to 1e-12
    of max |Hcc_d x| (the scale of the terms that cancel in S_red x);
    Hpp_d against the damped camera blocks of J^T J to 1e-14."""
    prob = _cell_problems()[name]
    plan, uv, cams, pts = _torch_problem(prob)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv, torch.float32)
    M, lam = prob.num_cameras, 1.0
    S = torch.empty((9 * M, 9 * M), dtype=torch.float32)
    red = ba.assemble(plan, A_cam, A_pt, b, lam, False, S)
    _, _, Hcc_d, Hcl, Hll_d = _dense_system(plan, A_cam, A_pt, b, lam, False)
    S_red = Hcc_d - Hcl @ torch.linalg.inv(Hll_d) @ Hcl.T
    blocks = Hcc_d.reshape(M, 9, M, 9).diagonal(dim1=0, dim2=2)
    _close(red.Hpp_d, blocks.permute(2, 0, 1), 1e-14)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(M, 9)))
    y = ba_kernels.schur_matvec_plain(
        plan.pt_ptr, plan.pt_tile, plan.obs_cam, plan.obs_pt, plan.cam_ptr,
        plan.cam_obs, red.W, red.WC, red.Hpp_d, x)
    scale = float((Hcc_d @ x.reshape(-1)).abs().max())
    assert float((y.reshape(-1) - S_red @ x.reshape(-1)).abs().max()) \
        <= 1e-12 * scale


@pytest.mark.parametrize("name", ["synthetic", "special"])
def test_mixed_assembly_rounds_once(name):
    """The float32 S of the mixed mode is the float64 assembly of the same
    float32 Jacobian entries, each entry rounded once; g~, s, W, C, gl and
    WC are the float64 assembly's to the last bit."""
    prob = _cell_problems()[name]
    plan, uv, cams, pts = _torch_problem(prob)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv, torch.float32)
    n = 9 * prob.num_cameras
    S32 = torch.full((n, n), float("nan"), dtype=torch.float32)
    S64 = torch.full((n, n), float("nan"), dtype=torch.float64)
    red = ba.assemble(plan, A_cam, A_pt, b, 1e-4, False, S32)
    red64 = ba.assemble(plan, A_cam.double(), A_pt.double(), b, 1e-4, False,
                        S64)
    assert torch.equal(S32, S64.float()) and not torch.isnan(S32).any()
    for x, y in zip(red[:6], red64[:6]):
        assert torch.equal(x, y)
    assert red.Hpp_d is not None and red64.Hpp_d is None


@pytest.mark.parametrize("mode", ["implicit", "dense"])
def test_dense_spd_solve_mixed(mode):
    """The refined solves of _dense_spd_solve against numpy's float64
    solve: an equilibrated float32 S refined against an exact matvec
    (the working phase), and a float64 S factorized through its float32
    copy and refined against itself (the fallback phase).  The system's
    condition number after equilibration is ~1e4, so each refinement pass
    gains about 1e-4 x eps32 / eps32, and 3 (or 2) passes reach 1e-10."""
    rng = np.random.default_rng(2)
    n = 60
    Q = np.linalg.qr(rng.normal(size=(n, n)))[0]
    B = Q @ np.diag(np.logspace(0, 4, n)) @ Q.T
    d = np.exp(rng.uniform(-6, 6, size=n))      # scales spanning ~1e5
    Sn = d[:, None] * B * d[None, :]
    rhs = rng.normal(size=n)
    S = torch.from_numpy(Sn.copy())
    s = ba.equilibrate(S)
    if mode == "implicit":
        Sd = torch.from_numpy(Sn)
        x = ba._dense_spd_solve(S.float(), torch.from_numpy(rhs), s, True,
                                lambda v: Sd @ v)
    else:
        x = ba._dense_spd_solve(S, torch.from_numpy(rhs), s, True,
                                S32=torch.empty((n, n), dtype=torch.float32))
        # the float64 S is left intact for the refinement's products
        _close(S / torch.outer(s, s), Sn, 1e-15)
    assert x.dtype == torch.float64
    _close(x, np.linalg.solve(Sn, rhs), 1e-10)
    indefinite = torch.from_numpy(np.diag([1.0, -1.0, 2.0]))
    s = ba.equilibrate(indefinite)
    one = torch.ones(3, dtype=torch.float64)
    assert (ba._dense_spd_solve(indefinite.float(), one, s, True, lambda v: v)
            if mode == "implicit" else
            ba._dense_spd_solve(indefinite, one, s, True,
                                S32=torch.empty((3, 3)))) is None


def test_mixed_ba_optimize_matches_jax():
    """Mixed-precision BA end to end (as tests/test_sfm.py:250-261) against
    the JAX package's ba_optimize(dtype=f32, mixed_precision=True) and
    against the port's float64 optimum: within 1e-4 relative of both, with
    every iteration in the float32 working phase in both packages."""
    prob = synthetic.make_bal_problem(12, 150, 3, seed=4)
    lm = dict(max_iterations=15)
    _, info64 = ba.ba_optimize(prob, LMParams(**lm), device="cpu")
    _, info = ba.ba_optimize(prob, LMParams(**lm), device="cpu",
                             dtype=torch.float32, mixed_precision=True)
    _, jinfo = jba.ba_optimize(prob, gt.LMParams(**lm), dtype=jnp.float32,
                               mixed_precision=True)
    assert info["error"] <= info64["error"] * (1 + 1e-4)
    np.testing.assert_allclose(info["error"], float(jinfo["error"]),
                               rtol=1e-4)
    assert info["phases"] == ["float32"] * len(info["iter_times"])
    assert jinfo["phases"] == ["float32"] * len(jinfo["iter_times"])


def test_mixed_stall_switches_to_float64():
    """A gain below switch_tol = max(10 relative_error_tol, 1e-7) of the
    error ends the float32 phase: the rest of the run is float64 (an f32
    factorization refined against the float64 S), with lambda capped at
    lambda_initial, as in the JAX package.  relative_error_tol 0.02 makes
    the switch fire after the first iteration that gains under 20%."""
    prob = synthetic.make_bal_problem(12, 150, 3, seed=4)
    lm = dict(max_iterations=8, relative_error_tol=0.02)
    _, info = ba.ba_optimize(prob, LMParams(**lm), device="cpu",
                             dtype=torch.float32, mixed_precision=True)
    _, jinfo = jba.ba_optimize(prob, gt.LMParams(**lm), dtype=jnp.float32,
                               mixed_precision=True)
    phases = info["phases"]
    assert "float32" in phases and "float64" in phases
    first = phases.index("float64")
    assert phases == ["float32"] * first + ["float64"] * (len(phases) - first)
    assert phases == jinfo["phases"]
    np.testing.assert_allclose(info["history"], np.asarray(jinfo["history"]),
                               rtol=1e-6)


def test_mixed_cholesky_failure_retries_in_float64():
    """The singular system of test_cholesky_failure_is_a_failed_try in the
    mixed mode: the float32 try fails, so the iteration is tried again in
    the float64 phase, which fails too; the JAX package does the same."""
    prob = synthetic.make_bal_problem(12, 150, 4, seed=0)
    prob = dataclasses.replace(
        prob, cam_R=np.concatenate([prob.cam_R, prob.cam_R[:1]]),
        cam_t=np.concatenate([prob.cam_t, prob.cam_t[:1]]),
        cam_calib=np.concatenate([prob.cam_calib, prob.cam_calib[:1]]))
    plan, uv, cams, pts = _torch_problem(prob)
    A_cam, A_pt, b = ba.linearize(plan, cams, pts, uv, torch.float32)
    dc, dl = ba.schur_solve(plan, A_cam, A_pt, b, 1e-4, True,
                            mixed_precision=True)
    assert torch.isnan(dc).all() and torch.isnan(dl).all()
    lm = dict(max_iterations=3, diagonal_damping=True)
    _, info = ba.ba_optimize(prob, LMParams(**lm), device="cpu",
                             dtype=torch.float32, mixed_precision=True)
    _, jinfo = jba.ba_optimize(prob, gt.LMParams(**lm), dtype=jnp.float32,
                               mixed_precision=True)
    assert info["phases"] == ["float32", "float64"] == jinfo["phases"]
    assert not info["converged"] and info["error"] == info["history"][0]
    np.testing.assert_allclose(info["error"], float(jinfo["error"]),
                               rtol=1e-12)


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
