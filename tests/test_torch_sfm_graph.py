"""Parity of gtsam_torch's graph-form bundle adjustment with gtsam_tpu's
(CPU, float64): read_bundler, to_graph, kernels 17 and 18's plain
versions (the BalCamera variant: the generic projection variant is in
tests/test_torch_slam_factors.py), the supernodal system at store width
d = 9 and the LM of the reference's timeSFMBAL path.

Inputs are made with numpy from seeds (sfm/synthetic.make_bal_problem) and
handed to both packages.  Tolerances: geometry and errors 1e-12 relative;
linearizations 1e-11 relative to the largest entry (the plain versions'
closed forms against jacfwd's chain rule: the same terms summed in
another order); the LM against the JAX run: the same iterations and
tries, its history within HIST_TOL (below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_tpu.base import losses as jlosses
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.optimize import optimizers as JO
from gtsam_tpu.sfm import bal as jbal

from gtsam_torch.base import losses as tlosses
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry.cameras import BalCamera
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
from gtsam_torch.optimize import optimizers as TO
from gtsam_torch.sfm import ba, synthetic
from gtsam_torch.sfm import bal as tbal

LIN_TOL = 1e-11
ERR_TOL = 1e-12
# The small LM's history against the JAX run's.  Graph-form BA has a 7-dof
# gauge freedom, so at lambda 1e-5 its steps solve systems of condition
# ~1e11 along the gauge: scripts/port_sfm_reference.py --cameras 4 --points
# 60 --obs 3 --iterations 40 --spread 12 moves the JAX run's own history
# (40 iterations, 81 tries) by 5.8e-9 to 2.9e-8 when the points move by
# 1e-15 of their value, its iterations and tries unchanged.  Two runs that
# round differently (the port and the JAX package) each lie so far from a
# common history: the history is held to twice that spread, 6e-8 (1e-9
# would hold the port to less than the problem's own rounding spread), and
# the final error, past the gauge's transient, to 1e-9.
HIST_TOL = 6e-8
FINAL_TOL = 1e-9
SCHUR_TOL = 1e-6
SMALL = (4, 60, 3)


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


def _problem(behind=3):
    """The small stand-in with `behind` observed points moved behind every
    camera that sees them (the cheirality branch)."""
    prob = synthetic.make_bal_problem(*SMALL, seed=0)
    if behind:
        pts = prob.points.copy()
        for j in range(behind):
            c = prob.obs_cam[np.argmax(prob.obs_pt == j)]
            pts[j] = 3.0 * prob.cam_t[c]
        prob = type(prob)(**{**prob.__dict__, "points": pts})
    return prob


def _write_bundler(path, prob, rng):
    """A Bundler v0.3 file of prob: the inverse of read_bundler's
    openGL2gtsam and v negation, colours and sift indices made up."""
    R90 = np.diag([1.0, -1.0, -1.0])
    lines = ["# Bundle file v0.3",
             f"{prob.num_cameras} {prob.num_points}"]
    for i in range(prob.num_cameras):
        R = (prob.cam_R[i] @ R90).T
        t = -R @ prob.cam_t[i]
        lines.append(" ".join(repr(float(x)) for x in prob.cam_calib[i]))
        lines += [" ".join(repr(float(x)) for x in row) for row in R]
        lines.append(" ".join(repr(float(x)) for x in t))
    for j in range(prob.num_points):
        lines.append(" ".join(repr(float(x)) for x in prob.points[j]))
        lines.append(" ".join(str(int(c)) for c in rng.integers(0, 255, 3)))
        obs = np.flatnonzero(prob.obs_pt == j)
        views = [f"{prob.obs_cam[k]} {rng.integers(0, 9999)} "
                 f"{float(prob.obs_uv[k, 0])!r} {float(-prob.obs_uv[k, 1])!r}"
                 for k in obs]
        lines.append(" ".join([str(len(obs))] + views))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_read_bundler_matches_jax(tmp_path):
    """read_bundler of a Bundler file written by the test gives the JAX
    package's arrays, and the problem the file was written from."""
    prob = synthetic.make_bal_problem(5, 40, 3, seed=1)
    order = np.lexsort((prob.obs_cam, prob.obs_pt))
    prob = type(prob)(**{**prob.__dict__, "obs_cam": prob.obs_cam[order],
                         "obs_pt": prob.obs_pt[order],
                         "obs_uv": prob.obs_uv[order]})
    path = str(tmp_path / "bundle.out")
    _write_bundler(path, prob, np.random.default_rng(0))
    got, ref = tbal.read_bundler(path), jbal.read_bundler(path)
    for f in ("cam_R", "cam_t", "cam_calib", "points", "obs_cam", "obs_pt",
              "obs_uv"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == b.dtype
        _close(a, b, ERR_TOL)
        _close(a, getattr(prob, f), 1e-12)
    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n1 0\n500 0 0\n" + "0 " * 9 + "\n0 0 0\n")
    with pytest.raises(ValueError, match="zero rotation"):
        tbal.read_bundler(path)


def _jax_values(jv):
    return Values.from_numpy(jv.arrays, jv.keys)


def test_to_graph_matches_jax():
    """to_graph's keys, batch, noise and values are the JAX package's, and
    its error (kernel 18's plain version) equals the JAX graph's."""
    prob = _problem()
    tg, tv = tbal.to_graph(prob)
    jg, jv = jbal.to_graph(prob)
    (tb,), (jb,) = tg.batches, jg.batches
    assert tb.name == jb.name == "ProjectionBal"
    assert tb.var_types == jb.var_types == ("BalCamera", "Point3")
    assert np.array_equal(tb.keys, jb.keys) and tb.rdim == jb.rdim == 2
    assert tb.noise.kind == jb.noise.kind
    _close(tb.noise.data, jb.noise.data, 0.0)
    _close(tb.measurements, jb.measurements, 0.0)
    assert tfactors.kernel_route(tb) == ("BalCamera", "projection")
    for t in ("BalCamera", "Point3"):
        assert np.array_equal(tv.keys[t], jv.keys[t])
    ref = _jax_values(jv)
    c, rc = tv.arrays["BalCamera"], ref.arrays["BalCamera"]
    for a, b in ((c.pose.R, rc.pose.R), (c.pose.t, rc.pose.t),
                 (c.calib, rc.calib),
                 (tv.arrays["Point3"], ref.arrays["Point3"])):
        assert torch.equal(a, b)
    _close(tg.error(tv), jg.error(jv), ERR_TOL)
    assert tbal.CAM(3) == jbal.CAM(3) and tbal.PT(7) == jbal.PT(7)


def _args(tb, st, arrays):
    return K.group_args("BalCamera", arrays, st.rows_i32, tb)


def _jxs(jv, rows):
    cams = jax.tree.map(lambda a: a[rows[:, 0]], jv.arrays["BalCamera"])
    return cams, jv.arrays["Point3"][rows[:, 1]]


NOISES = ["unit", "isotropic", "sigmas_per_factor", "gaussian",
          "gaussian_per_factor", "constrained"]


def _noise(mod, kind, N, rng):
    if kind == "unit":
        return mod.unit()
    if kind == "isotropic":
        return mod.isotropic(2, 2.5)
    if kind == "sigmas_per_factor":
        return mod.sigmas(rng.uniform(0.5, 3.0, (N, 2)))
    if kind == "constrained":
        return mod.constrained(np.array([[0.0, 1.5]]))
    A = rng.normal(size=(N if kind.endswith("factor") else 1, 2, 2))
    return mod.information(A @ A.transpose(0, 2, 1) + np.eye(2))


def _batches(prob, kind, loss=None, param=None):
    """The JAX and port ProjectionBal batches of prob with noise `kind`
    (made from one seed for both) and an optional loss."""
    N = prob.num_observations
    jn = _noise(jnoise, kind, N, np.random.default_rng(7))
    tn = _noise(tnoise, kind, N, np.random.default_rng(7))
    if loss is not None:
        jl, tl = (mod.LOSSES[loss]() if param is None else
                  mod.LOSSES[loss](param) for mod in (jlosses, tlosses))
        jn, tn = jnoise.robust(jn, jl), tnoise.robust(tn, tl)
    jg, jv = jbal.to_graph(prob)
    tg, tv = tbal.to_graph(prob)
    jb = jfactors.custom_factors("ProjectionBal", ("BalCamera", "Point3"),
                                 jg.batches[0].keys, jbal._projection_residual,
                                 2, jnp.asarray(prob.obs_uv), jn)
    tb = tfactors.custom_factors("ProjectionBal", ("BalCamera", "Point3"),
                                 tg.batches[0].keys, tbal._projection_residual,
                                 2, prob.obs_uv, tn)
    return jb, jv, tb, tv


def _check_kernel17_plain(jb, jv, tb, tv, d=9):
    """Kernel 17's plain Jacobian mode and Gram mode and kernel 18's plain
    error on the port's batch against the JAX package's linearize and
    error: A and b at LIN_TOL, the H and gv blocks at store width d (zero
    past each block's leading dims; sign -1; the (0, 1) block transposed
    where flip says so) against the same products of the JAX Jacobians,
    the error at ERR_TOL."""
    tg, jg = FactorGraph([tb]), type(jv)  # noqa: F841 (jg unused)
    bound = BoundGraph(tg, tv, "cpu")
    st, b = bound.structures[0], bound.graph.batches[0]
    assert tfactors.kernel_route(b) == ("BalCamera", "projection")
    rows = st.rows_i32.numpy()
    jA, jbv = jfactors.linearize(jb, _jxs(jv, rows))
    jA = [np.asarray(a) for a in jA]
    la = tlosses.kernel_code(b.noise.loss)
    args = _args(b, st, tv.arrays) + (b.noise.kind, b.noise.data)
    A, bv = K.proj_jacobians_plain(*args, *la)
    for a, ja in zip(A, jA):
        _close(a, ja, LIN_TOL)
    _close(bv, jbv, LIN_TOL)
    M = b.num_factors
    fl = torch.as_tensor(np.arange(M) % 3 == 1)
    H = torch.full((M, 3, d * d), np.nan, dtype=torch.float64)
    gv = torch.full((M, 2, d), np.nan, dtype=torch.float64)
    K.proj_linearize_plain(*args, -1.0, fl, H, gv, *la)
    H, gv = H.view(M, 3, d, d).numpy(), gv.numpy()
    dims = (9, 3)
    for p, (s1, s2) in enumerate(((0, 0), (0, 1), (1, 1))):
        ref = -np.einsum("nri,nrj->nij", jA[s1], jA[s2])
        full = np.zeros((M, d, d))
        full[:, :dims[s1], :dims[s2]] = ref
        if s1 != s2:
            tr = np.zeros((M, d, d))
            tr[:, :dims[s2], :dims[s1]] = ref.transpose(0, 2, 1)
            full = np.where(fl.numpy()[:, None, None], tr, full)
        _close(H[:, p], full, LIN_TOL)
    for s in range(2):
        ref = np.zeros((M, d))
        ref[:, :dims[s]] = -np.einsum("nrd,nr->nd", jA[s], jbv)
        _close(gv[:, s], ref, LIN_TOL)
    jbound = JGraphOf(jb).bind(jv)
    err = K.proj_error_plain(*_args(b, st, tv.arrays), b.noise.kind,
                             b.noise.data, -1.0, *la, b.noise.mu)
    _close(err, -np.asarray(jbound.error(jv.arrays)), ERR_TOL)


def JGraphOf(batch):
    from gtsam_tpu.graph.graph import FactorGraph as JGraph
    return JGraph([batch])


@pytest.mark.parametrize("kind", NOISES)
def test_kernel17_plain_matches_jax(kind):
    """Each noise kind (shared and a model a factor; constrained: a hard
    row of weight 0 in the rows, mu r^2 in the error); three observations
    behind their cameras (zero Jacobians, residual 1e3)."""
    jb, jv, tb, tv = _batches(_problem(), kind)
    _check_kernel17_plain(jb, jv, tb, tv)


@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_kernel17_plain_with_each_loss(name):
    """Each of the nine losses on a gaussian model a factor, its parameter
    the median whitened norm (dcs: its square), so both branches run."""
    prob = _problem()
    jb, jv, tb, tv = _batches(prob, "gaussian_per_factor")
    bound = BoundGraph(FactorGraph([tb]), tv, "cpu")
    r = tfactors.residuals(tb, bound._xs(tb, bound.structures[0], tv.arrays))
    med = float(torch.median(torch.linalg.norm(tb.noise.whiten(r), dim=-1)))
    param = None if name == "null" else (med * med if name == "dcs" else med)
    jb, jv, tb, tv = _batches(prob, "gaussian_per_factor", name, param)
    _check_kernel17_plain(jb, jv, tb, tv, d=11)


def test_kernel17_plain_matches_jacfwd():
    """The plain closed forms against the port's own generic
    linearization (jacfwd of the residual through the right retraction of
    the camera and the point) of the same batch."""
    prob = _problem()
    tg, tv = tbal.to_graph(prob)
    bound = BoundGraph(tg, tv, "cpu")
    b, st = bound.graph.batches[0], bound.structures[0]
    before = tfactors.GENERIC_LINEARIZATIONS[0]
    gA, gb = tfactors.linearize(b, bound._xs(b, st, tv.arrays))
    assert tfactors.GENERIC_LINEARIZATIONS[0] == before + 1
    A, bv = K.proj_jacobians_plain(*_args(b, st, tv.arrays), b.noise.kind,
                                   b.noise.data)
    behind = (gb == -tbal.CHEIRALITY_PENALTY).all(1)
    assert behind.sum() >= 3 and not A[0][behind].any()
    for a, g in zip(A, gA):
        _close(a, g, LIN_TOL)
    _close(bv, gb, LIN_TOL)


def _solver(graph, vals, **kw):
    return SupernodalCholeskySolver(BoundGraph(graph, vals, "cpu"), **kw)


def _unrouted(graph):
    """The graph with its projection residual stripped of its kernel
    group: the generic linearization's route."""
    import dataclasses

    def res(xs, uv):
        return tbal._projection_residual(xs, uv)
    return FactorGraph([dataclasses.replace(graph.batches[0],
                                            residual_fn=res)])


def test_system_at_store_width_9():
    """The supernodal system of the graph form: a store 9 wide, each
    Point3's diagonal block padded with the identity; kernel 17's Gram mode
    (through pg_assemble) gives the generic route's blocks and gradient at
    LIN_TOL, and kernel 17's Jacobian mode its QR pool rows; a damped
    solve on kernels 7-8's plain versions at d = 9 equals a dense solve of
    the JAX package's Gauss-Newton system."""
    prob = _problem(behind=0)
    tg, tv = tbal.to_graph(prob)
    s = _solver(tg, tv)
    assert s.d == 9 and s.nvars == prob.num_cameras + prob.num_points
    blocks, g = s.system(tv.arrays)
    s2 = _solver(_unrouted(tg), tv)
    before = tfactors.GENERIC_LINEARIZATIONS[0]
    blocks2, g2 = s2.system(tv.arrays)
    assert tfactors.GENERIC_LINEARIZATIONS[0] == before + 1
    _close(blocks, blocks2, LIN_TOL)
    _close(g, g2, LIN_TOL)
    _close(s.jacobian_pool(tv.arrays), s2.jacobian_pool(tv.arrays), LIN_TOL)
    pad = torch.as_tensor(s.pad_diag)
    assert int((pad.sum(1) == 6).sum()) == prob.num_points
    lam = 1.0
    dx, ok = s.solve_refined(blocks, g, lam, False, 1)
    assert bool(ok)
    jg, jv = jbal.to_graph(prob)
    H, jgv = jg.bind(jv).gn_system(jv.arrays)
    H, jgv = np.asarray(H), np.asarray(jgv)
    ref = np.linalg.solve(H + lam * np.eye(len(jgv)), jgv)
    _close(dx, ref, 1e-10)


def count_tries(monkeypatch, module):
    """A list whose length counts the tries (the calls of try_step, the
    second-last of what _make_step_fns returns, in both packages) of
    `module`'s optimizers from now on."""
    calls = []
    orig = module._make_step_fns

    def wrapped(*a, **kw):
        out = list(orig(*a, **kw))
        try_step = out[-2]

        def counted(*args, **kws):
            calls.append(1)
            return try_step(*args, **kws)
        out[-2] = counted
        return tuple(out)
    monkeypatch.setattr(module, "_make_step_fns", wrapped)
    return calls


LM_ITERATIONS = 40


def test_graph_lm_matches_jax(monkeypatch):
    """to_graph -> levenberg_marquardt(SparseSolver()) on the small
    stand-in: the same iterations and tries as the JAX run (so the same
    tries rejected: the JAX package on a non-finite or larger error, the
    port also on kernel 7's pivot flag), its history within HIST_TOL, the
    final error within FINAL_TOL; the port's run makes no generic
    linearization."""
    prob = _problem(behind=0)
    tg, tv = tbal.to_graph(prob)
    jg, jv = jbal.to_graph(prob)
    params = dict(max_iterations=LM_ITERATIONS)
    tries, jtries = count_tries(monkeypatch, TO), count_tries(monkeypatch, JO)
    before = tfactors.GENERIC_LINEARIZATIONS[0]
    res = TO.levenberg_marquardt(tg, tv, TO.LMParams(**params),
                                 solver=TO.SparseSolver(), device="cpu")
    assert tfactors.GENERIC_LINEARIZATIONS[0] == before
    jres = JO.levenberg_marquardt(jg, jv, JO.LMParams(**params),
                                  solver=JO.SparseSolver())
    assert res.iterations == jres.iterations
    assert len(tries) == len(jtries) >= res.iterations
    h, jh = np.asarray(res.history), np.asarray(jres.history)
    assert h.shape == jh.shape
    assert np.max(np.abs(h - jh) / jh) <= HIST_TOL
    assert abs(res.error - jres.error) <= FINAL_TOL * jres.error
    assert isinstance(res.values.arrays["BalCamera"], BalCamera)


def test_graph_lm_matches_schur_ba():
    """The graph form's LM and the port's Schur-form ba_optimize reach the
    same error at the same LMParams (tests/test_sfm.py holds the JAX pair
    so)."""
    prob = _problem(behind=0)
    tg, tv = tbal.to_graph(prob)
    params = TO.LMParams(max_iterations=LM_ITERATIONS)
    res = TO.levenberg_marquardt(tg, tv, params, solver=TO.SparseSolver(),
                                 device="cpu")
    _, info = ba.ba_optimize(prob, params, device="cpu")
    assert abs(res.error - info["error"]) <= SCHUR_TOL * info["error"]
