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
    return Values.from_numpy(jv.arrays, jv.keys, device="cpu")


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


def gram_per_factor(linearize, args, sign, flip, d, la=()):
    """Kernel 17's plain Gram mode (`linearize`, on the batch's leading
    arguments, noise kind and data `args`) on a plan whose rows are single
    factors (each factor with a camera and a point of its own), the rows
    put back a factor each: H (M, 3, d*d) and gv (M, 2, d), the (0, 1)
    block transposed where the factor's flip says so."""
    M = flip.shape[0]
    plan, rep = K.proj_gram_plan(np.arange(M), M + np.arange(M))
    assert (np.diff(plan.mptr) == 1).all()
    nh, ng = K.gram_rows(plan)
    f64 = torch.float64
    H = torch.full((nh, d * d), np.nan, dtype=f64)
    gv = torch.full((ng, d), np.nan, dtype=f64)
    rflip = torch.as_tensor((plan.rkind == 1) & flip.numpy()[rep])
    linearize(*args, sign, K.GramPlan(*map(torch.as_tensor, plan)), rflip,
              H, gv, *la)
    h = plan.rkind < K.GRAM_SLOT0
    Hf = torch.full((M, 3, d * d), np.nan, dtype=f64)
    gf = torch.full((M, 2, d), np.nan, dtype=f64)
    Hf[rep[h], plan.rkind[h]] = H[plan.rout[h]]
    gf[rep[~h], plan.rkind[~h] - K.GRAM_SLOT0] = gv[plan.rout[~h]]
    return Hf, gf


def _check_kernel17_plain(jb, jv, tb, tv, d=9):
    """Kernel 17's plain Jacobian mode and Gram mode and kernel 18's plain
    error on the port's batch against the JAX package's linearize and
    error: A and b at LIN_TOL, the H and gv blocks at store width d (the
    Gram mode on a plan of single factors; zero past each block's leading
    dims; sign -1; the (0, 1) block transposed where flip says so) against
    the same products of the JAX Jacobians, the error at ERR_TOL."""
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
    H, gv = gram_per_factor(K.proj_linearize_plain, args, -1.0, fl, d, la)
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


# -- kernel 17's Gram plan: a row a chunk of factors and target ---------------


def _gram_batch(variant, noise_kind, seed=3):
    """A projection batch of a seeded stand-in (5 cameras, 300 points: more
    than three chunks), bound on the CPU: BalCamera (its graph form) or
    GenericProjection (its cameras as SE3 poses with a fixed K and an
    extrinsic); noise_kind "loss" (a gaussian model a factor under Huber
    at the median whitened norm) or "constrained" (the first row hard).
    Returns (the plain Gram mode, its leading arguments with the noise, the
    rows (N, 2), the loss arguments, the sign)."""
    from gtsam_torch.geometry import se3
    from gtsam_torch.geometry.se3 import SE3
    from gtsam_torch.slam import factors as tslam
    prob = synthetic.make_bal_problem(5, 300, 4, seed=seed)
    N = prob.num_observations
    rng = np.random.default_rng(seed)
    if noise_kind == "constrained":
        model = tnoise.constrained(np.array([[0.0, 1.5]]))
    else:
        A = rng.normal(size=(N, 2, 2))
        model = tnoise.information(A @ A.transpose(0, 2, 1) + np.eye(2))
    if variant == "GenericProjection":
        T = SE3(torch.as_tensor(prob.cam_R), torch.as_tensor(prob.cam_t))
        body = se3.expmap(torch.tensor([0.1, 0.0, -0.1, 0.2, 0.1, 0.0],
                                       dtype=torch.float64))
        graph = FactorGraph([tslam.generic_projection_factors(
            prob.obs_cam, 100 + prob.obs_pt, prob.obs_uv,
            [500.0, 490.0, 0.0, 1.0, -2.0], model, body)])
        vals = Values({"SE3": T, "Point3": torch.as_tensor(prob.points)},
                      {"SE3": np.arange(prob.num_cameras),
                       "Point3": 100 + np.arange(prob.num_points)})
        fn, sign = K.proj3_linearize_plain, -1.0
    else:
        graph, vals = tbal.to_graph(prob)
        graph.batches[0].noise = model
        fn, sign = K.proj_linearize_plain, 1.0
    if noise_kind == "loss":
        bound = BoundGraph(graph, vals, "cpu")
        b = bound.graph.batches[0]
        r = tfactors.residuals(b, bound._xs(b, bound.structures[0],
                                            vals.arrays))
        med = float(torch.median(torch.linalg.norm(b.noise.whiten(r), dim=-1)))
        graph.batches[0].noise = tnoise.robust(model, tlosses.huber(med))
    bound = BoundGraph(graph, vals, "cpu")
    b, st = bound.graph.batches[0], bound.structures[0]
    group = tfactors.kernel_route(b)[0]
    args = K.group_args(group, vals.arrays, st.rows_i32, b) + (
        b.noise.kind, b.noise.data)
    return fn, args, st.rows_i32.numpy(), tlosses.kernel_code(b.noise.loss), \
        sign


def _by_target(parts, cam, pt):
    """parts[k] = (values, each value's factor): the sums per target of
    Gram kind k (a camera, a camera-point pair, a point, a camera, a
    point), each target's values added in the order given; [(target ids,
    sums)] by kind."""
    keys = (cam, cam * (int(pt.max()) + 1) + pt, pt, cam, pt)
    out = []
    for k, (vals, fac) in enumerate(parts):
        u, inv = np.unique(keys[k][fac], return_inverse=True)
        out.append((u, torch.zeros((len(u),) + tuple(vals.shape[1:]),
                                   dtype=torch.float64).index_add_(
            0, torch.as_tensor(inv), vals)))
    return out


GRAM_CASES = [("BalCamera", 9, "loss"), ("BalCamera", 9, "constrained"),
              ("BalCamera", 11, "loss"), ("BalCamera", 11, "constrained"),
              ("GenericProjection", 6, "loss"),
              ("GenericProjection", 6, "constrained")]


@pytest.mark.parametrize("variant,d,noise_kind", GRAM_CASES)
def test_gram_mode_sums_the_per_factor_rows(variant, d, noise_kind):
    """Kernel 17's plain Gram mode on its batch's plan (the factors sorted
    by point, chunks of PROJ_CHUNK, a row a chunk and target) writes every
    row, and its rows summed per target (a camera's block, a camera-point
    block, a point's block, a camera's and a point's gradient row) in plan
    order equal the per-factor rows (a plan of single factors) summed per
    target in factor order, at LIN_TOL: both variants, store widths 9, 11
    and 6, a loss and constrained noise, camera-point blocks transposed
    where their flip says so."""
    fn, args, rows, la, sign = _gram_batch(variant, noise_kind)
    cam, pt = rows[:, 0].astype(np.int64), rows[:, 1].astype(np.int64)
    N = len(cam)
    fl = (cam * 7 + pt) % 3 == 1          # a function of the block
    plan, rep = K.proj_gram_plan(cam, pt)
    assert len(plan.cptr) - 1 == -(-N // K.PROJ_CHUNK) >= 3
    nh, ng = K.gram_rows(plan)
    H = torch.full((nh, d * d), np.nan, dtype=torch.float64)
    gv = torch.full((ng, d), np.nan, dtype=torch.float64)
    rflip = (plan.rkind == 1) & fl[rep]
    assert rflip.any() and not rflip[plan.rkind == 1].all()
    fn(*args, sign, K.GramPlan(*map(torch.as_tensor, plan)),
       torch.as_tensor(rflip), H, gv, *la)
    assert torch.isfinite(H).all() and torch.isfinite(gv).all()
    Hf, gf = gram_per_factor(fn, args, sign, torch.as_tensor(fl), d, la)
    kinds, rout = plan.rkind, plan.rout
    new = ([(H[rout[kinds == k]], rep[kinds == k]) for k in range(3)]
           + [(gv[rout[kinds == k]], rep[kinds == k]) for k in (3, 4)])
    old = ([(Hf[:, k], np.arange(N)) for k in range(3)]
           + [(gf[:, k], np.arange(N)) for k in range(2)])
    for (u1, s1), (u2, s2) in zip(_by_target(new, cam, pt),
                                  _by_target(old, cam, pt)):
        assert np.array_equal(u1, u2)
        _close(s1, s2, LIN_TOL)
    # fewer rows of H than the per-factor layout's 3 a factor
    assert nh < 2 * N


def test_gram_single_factor_plan_is_per_factor():
    """A plan whose rows are single factors (each factor a camera and a
    point of its own) writes each factor's own products, exactly: its rows
    are the Jacobian mode's sign A_s1^T A_s2 (zero past the leading dims,
    the camera-point block transposed where flip says so) and sign A_s^T
    b, one term each."""
    fn, args, rows, la, sign = _gram_batch("BalCamera", "loss")
    N, d = rows.shape[0], 9
    fl = torch.as_tensor(np.arange(N) % 3 == 1)
    Hf, gf = gram_per_factor(fn, args, sign, fl, d, la)
    (Ac, Ap), b = K.proj_jacobians_plain(*args, *la)
    pad = torch.nn.functional.pad
    cp = pad(sign * torch.einsum("nri,nrj->nij", Ac, Ap), (0, 6, 0, 0))
    ref = torch.stack([
        sign * torch.einsum("nri,nrj->nij", Ac, Ac),
        torch.where(fl[:, None, None], cp.mT, cp),
        pad(sign * torch.einsum("nri,nrj->nij", Ap, Ap), (0, 6, 0, 6))], 1)
    assert torch.equal(Hf, ref.reshape(N, 3, d * d))
    gref = torch.stack([sign * torch.einsum("nrd,nr->nd", Ac, b),
                        pad(sign * torch.einsum("nrd,nr->nd", Ap, b),
                            (0, 6))], 1)
    assert torch.equal(gf, gref)


def _graph_with_prior(prob):
    """Both packages' graph forms of prob with a second batch on the camera
    blocks: a prior on every camera (the generic route)."""
    tg, tv = tbal.to_graph(prob)
    jg, jv = jbal.to_graph(prob)
    keys = tv.keys["BalCamera"]
    tg.add(tfactors.prior_factors("BalCamera", keys, tv.arrays["BalCamera"],
                                  tnoise.isotropic(9, 0.5)))
    jg.add(jfactors.prior_factors("BalCamera", keys, jv.arrays["BalCamera"],
                                  jnoise.isotropic(9, 0.5)))
    return tg, tv, jg, jv


def test_gram_plan_adds_each_factor_once():
    """A sequential model of kernel 17's walk over the plan (chunk after
    chunk, a chunk's rows in order, a row's members in order) and of
    pg_assemble's over the supernodal solver's CSRs, on the graph form of a
    stand-in with a camera prior batch: every (factor, slot pair) and
    (factor, slot) is added exactly once, to the store block or variable
    that the JAX package's assembly plan names for it; every row of the
    contribution buffer is summed once; a chunk's rows of H and of gv are
    each one span of consecutive rows.  (A check of the plan, not of the
    kernel's arithmetic.)"""
    from gtsam_tpu.linear.supernodal import SupernodalCholeskySolver as JS
    prob = synthetic.make_bal_problem(4, 200, 3, seed=2)
    tg, tv, jg, jv = _graph_with_prior(prob)
    ts = SupernodalCholeskySolver(BoundGraph(tg, tv, "cpu"))
    js = JS(jg.bind(jv))
    cp = ts._cplan
    assert cp.gram[0] is not None and cp.gram[1] is None
    # the JAX plan's target of each (batch, pair, factor) and (batch, slot,
    # factor) position
    jt = np.empty(len(js._asm_order), np.int64)
    jt[js._asm_order] = js._asm_uniq[js._asm_seg]
    gt_ = np.empty(len(js._g_order), np.int64)
    gt_[js._g_order] = js._g_uniq[js._g_seg]
    # the port's target of each buffer row
    for a, n in (("asm_src", cp.n_hc), ("g_src", cp.n_gc)):
        assert np.array_equal(np.sort(getattr(ts, a)), np.arange(n))
    hblk = np.empty(cp.n_hc, np.int64)
    hblk[ts.asm_src] = np.repeat(ts.asm_blk, np.diff(ts.asm_ptr))
    gvar = np.empty(cp.n_gc, np.int64)
    gvar[ts.g_src] = np.repeat(np.arange(ts.nvars), np.diff(ts.g_ptr))
    jpos, gpos = 0, 0
    for bi, b in enumerate(tg.batches):
        N, arity = b.num_factors, b.arity
        npair = arity * (arity + 1) // 2
        seen = np.zeros((N, npair + arity), np.int64)
        g = cp.gram[bi]
        if g is None:
            for n in range(N):
                for p in range(npair):
                    seen[n, p] += 1
                    assert hblk[cp.h_base[bi] + n * npair + p] == \
                        jt[jpos + p * N + n]
                for s in range(arity):
                    seen[n, npair + s] += 1
                    assert gvar[cp.g_base[bi] + n * arity + s] == \
                        gt_[gpos + s * N + n]
        else:
            pl = g.plan
            for c in range(len(pl.cptr) - 1):
                # the chunk's rows of H first, then of gv, each a span of
                # consecutive rows (the kernel writes them so)
                rk = pl.rkind[pl.cptr[c]:pl.cptr[c + 1]]
                ro = pl.rout[pl.cptr[c]:pl.cptr[c + 1]]
                nh = int((rk < K.GRAM_SLOT0).sum())
                assert (rk[:nh] < K.GRAM_SLOT0).all() and nh < len(rk)
                assert (np.diff(ro[:nh]) == 1).all()
                assert (np.diff(ro[nh:]) == 1).all()
                for r in range(pl.cptr[c], pl.cptr[c + 1]):
                    k = int(pl.rkind[r])
                    for m in range(pl.mptr[r], pl.mptr[r + 1]):
                        n = int(pl.order[c * K.PROJ_CHUNK + pl.mem[m]])
                        seen[n, k] += 1
                        if k < K.GRAM_SLOT0:
                            assert hblk[cp.h_base[bi] + pl.rout[r]] == \
                                jt[jpos + k * N + n]
                        else:
                            s = k - K.GRAM_SLOT0
                            assert gvar[cp.g_base[bi] + pl.rout[r]] == \
                                gt_[gpos + s * N + n]
        assert (seen == 1).all()
        jpos += npair * N
        gpos += arity * N


def test_gram_plan_bounds_the_camera_rows():
    """On a stand-in of 4 cameras (~1,000 observations each) with a camera
    prior batch, the longest assembly row of a camera's diagonal block (and
    of its gradient row) is at most ceil(N / PROJ_CHUNK) chunk partials
    plus the one prior factor that shares the block, where a row a factor
    summed every observation of the camera; the system equals the JAX
    package's at LIN_TOL."""
    from gtsam_tpu.linear.supernodal import SupernodalCholeskySolver as JS
    prob = synthetic.make_bal_problem(4, 600, 4, seed=1)
    tg, tv, jg, jv = _graph_with_prior(prob)
    ts = SupernodalCholeskySolver(BoundGraph(tg, tv, "cpu"))
    N = prob.num_observations
    bound = -(-N // K.PROJ_CHUNK) + 1
    cams = ts.sym.inv_perm[np.arange(prob.num_cameras)]
    dblk = ts.sym.diag_block_by_col[cams]
    lens = np.diff(ts.asm_ptr)[np.searchsorted(ts.asm_blk, dblk)]
    glens = np.diff(ts.g_ptr)[cams]
    per_cam = np.bincount(prob.obs_cam, minlength=prob.num_cameras)
    assert lens.max() <= bound and glens.max() <= bound
    assert (lens < per_cam).all() and per_cam.min() > 3 * bound
    blocks, g = ts.system(tv.arrays)
    jblocks, jgv = JS(jg.bind(jv)).system(jv.arrays)
    _close(blocks, np.asarray(jblocks), LIN_TOL)
    _close(g, np.asarray(jgv), LIN_TOL)


def test_gradient_of_a_projection_graph_matches_jax_grad():
    """BoundGraph.gradient on the graph form with a camera prior (kernel
    17's Gram rows, summed a chunk at a time, beside the prior's generic
    rows) against jax.grad of the JAX package's error through retract at
    zero, at 1e-10 (the gradient rows' cancellation: tests/
    test_torch_slam_factors.py's GRAD_TOL)."""
    from gtsam_tpu.graph.values import retract_arrays as jretract
    prob = synthetic.make_bal_problem(4, 400, 3, seed=4)
    tg, tv, jg, jv = _graph_with_prior(prob)
    bound = BoundGraph(tg, tv, "cpu")
    assert bound.contribution_plan().gram[0] is not None
    layout = jv.layout()
    jb = jg.bind(jv)
    ref = np.asarray(jax.grad(lambda dx: jb.error(jretract(
        jv.arrays, dx, layout)))(jnp.zeros(layout.total_dim)))
    _close(bound.gradient(tv.arrays), ref, 1e-10)
