"""Parity of gtsam_torch's pose-graph slice with gtsam_tpu's (CPU).

The JAX side runs float64 (tests/conftest.py turns x64 on); the torch side
runs float64 on the CPU, where every kernel wrapper computes its plain
PyTorch version.  Inputs are made with numpy from seeds and handed to both
packages.  Graphs: a 6-ring x 8-pose sphere (scripts/port_sphere_data.py)
with the prior of bench.py, factorized with force_width 4 (five levels), and
a graph mixing SE3 poses with Point3 landmarks through a custom
pose-landmark factor (so the 6-wide store pads the 3-dim landmarks).
Tolerances, each stated where it is used.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.geometry import se3 as jse3
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.inference import ordering as jordering
from gtsam_tpu.inference import supernodes as jsupernodes
from gtsam_tpu.io import datasets as jdatasets
from gtsam_tpu.linear.supernodal import SupernodalCholeskySolver as JSolver
from gtsam_tpu.optimize import optimizers as JO
from gtsam_tpu.slam.initialize import initialize_pose3_chordal as jchordal
from gtsam_tpu.utils import metrics as jmetrics

from gtsam_torch import _kernels
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se3, so3
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph import manifolds
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.inference import ordering as tordering
from gtsam_torch.inference import supernodes as tsupernodes
from gtsam_torch.io import datasets as tdatasets
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.linear.exceptions import IndeterminantLinearSystemError
from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
from gtsam_torch.optimize import optimizers as TO
from gtsam_torch.slam.initialize import initialize_pose3_chordal
from gtsam_torch.utils import metrics as tmetrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SN_KW = dict(force_width=4, max_width=8)
PRIOR_SIGMAS = [[1e-3] * 3 + [1e-2] * 3]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data_module():
    spec = importlib.util.spec_from_file_location(
        "port_sphere_data", os.path.join(REPO, "scripts",
                                         "port_sphere_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, ref, rtol):
    """rtol against each entry, atol rtol x the largest entry."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.asarray(a))


class Case:
    """One graph in both packages, bound at its initial values, with the
    supernodal solvers of both."""

    def __init__(self, jgraph, jvals, tgraph, tvals, **kw):
        self.jgraph, self.jvals = jgraph, jvals
        self.tgraph, self.tvals = tgraph, tvals
        self.jbound = jgraph.bind(jvals)
        self.tbound = BoundGraph(tgraph, tvals, "cpu")
        self.js = JSolver(self.jbound, **kw)
        self.ts = SupernodalCholeskySolver(self.tbound, **kw)
        self._sys = None

    def systems(self):
        if self._sys is None:
            jb, jg = jax.jit(self.js.system)(self.jvals.arrays)
            tb, tg = self.ts.system(self.tvals.arrays)
            self._sys = (np.asarray(jb), np.asarray(jg), tb, tg)
        return self._sys


def _sphere_graphs(tmp):
    path = os.path.join(tmp, "sphere.g2o")
    _data_module().write_sphere_g2o(path, laps=6, per_lap=8, radius=10.0,
                                    sigma_t=0.1, sigma_r=0.05, seed=1)
    jg, _ = jdatasets.load_3d(path)
    jg.add(gt.prior_factors("SE3", [0], gt.SE3(np.eye(3)[None],
                                               np.zeros((1, 3))),
                            gt.noise.sigmas(PRIOR_SIGMAS)))
    tg, _ = tdatasets.load_3d(path)
    tg.add(tfactors.prior_factors("SE3", [0], SE3(np.eye(3)[None],
                                                  np.zeros((1, 3))),
                                  tnoise.sigmas(PRIOR_SIGMAS)))
    return jg, tg


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    jg, tg = _sphere_graphs(str(tmp_path_factory.mktemp("sphere")))
    return Case(jg, jchordal(jg), tg, initialize_pose3_chordal(tg), **SN_KW)


def _mixed_parts(seed=3, n_pose=6, n_pt=5):
    """Numpy inputs of the mixed graph: a pose chain with a prior, and each
    landmark seen from two poses (pose-frame position, sigma 0.1)."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n_pose, 6)) * np.array([0.3] * 3 + [2.0] * 3)
    T = se3.expmap(_t(xi))
    R, tr = T.R.numpy(), T.t.numpy()
    pts = rng.normal(size=(n_pt, 3)) * 3.0
    i = np.arange(n_pose - 1)
    Rij = np.einsum("nji,njk->nik", R[i], R[i + 1])
    tij = np.einsum("nji,nj->ni", R[i], tr[i + 1] - tr[i])
    obs_pose = np.array([k % n_pose for k in range(2 * n_pt)])
    obs_pt = np.array([k // 2 for k in range(2 * n_pt)])
    z = np.einsum("nji,nj->ni", R[obs_pose], pts[obs_pt] - tr[obs_pose])
    z = z + rng.normal(size=z.shape) * 0.1
    noisy = rng.normal(size=(n_pose, 6)) * 0.05
    T0 = se3.retract(T, _t(noisy))
    pts0 = pts + rng.normal(size=pts.shape) * 0.2
    return dict(Rij=Rij, tij=tij, obs_pose=obs_pose, obs_pt=obs_pt + 100,
                z=z, R0=T0.R.numpy(), t0=T0.t.numpy(), pts0=pts0,
                n_pose=n_pose, n_pt=n_pt)


def _mixed_case(**kw):
    p = _mixed_parts()
    n_pose = p["n_pose"]
    info = np.diag([400.0] * 3 + [100.0] * 3)
    jg = JGraph()
    jg.add(jfactors.between_factors(
        "SE3", np.arange(n_pose - 1), np.arange(1, n_pose),
        gt.SE3(jnp.asarray(p["Rij"]), jnp.asarray(p["tij"])),
        jnoise.information(info)))
    jg.add(gt.prior_factors("SE3", [0], gt.SE3(np.eye(3)[None],
                                               np.zeros((1, 3))),
                            gt.noise.sigmas(PRIOR_SIGMAS)))
    jg.add(jfactors.custom_factors(
        "Obs", ("SE3", "Point3"), np.stack([p["obs_pose"], p["obs_pt"]], 1),
        lambda xs, m: jse3.transform_to(xs[0], xs[1]) - m, 3,
        jnp.asarray(p["z"]), jnoise.isotropic(3, 0.1)))
    keys_pt = np.arange(p["n_pt"]) + 100
    jv = JValues({"SE3": gt.SE3(jnp.asarray(p["R0"]), jnp.asarray(p["t0"])),
                  "Point3": jnp.asarray(p["pts0"])},
                 {"SE3": np.arange(n_pose), "Point3": keys_pt})
    tg = FactorGraph()
    tg.add(tfactors.between_factors(
        "SE3", np.arange(n_pose - 1), np.arange(1, n_pose),
        SE3(p["Rij"], p["tij"]), tnoise.information(info)))
    tg.add(tfactors.prior_factors("SE3", [0], SE3(np.eye(3)[None],
                                                  np.zeros((1, 3))),
                                  tnoise.sigmas(PRIOR_SIGMAS)))
    tg.add(tfactors.FactorBatch(
        "Obs", ("SE3", "Point3"), np.stack([p["obs_pose"], p["obs_pt"]], 1),
        3, lambda xs, m: se3.transform_to(xs[0], xs[1]) - m, _t(p["z"]),
        tnoise.isotropic(3, 0.1)))
    tv = Values({"SE3": SE3(_t(p["R0"]), _t(p["t0"])),
                 "Point3": _t(p["pts0"])},
                {"SE3": np.arange(n_pose), "Point3": keys_pt})
    return Case(jg, jv, tg, tv, **kw)


@pytest.fixture(scope="module")
def mixed():
    return _mixed_case(force_width=2, max_width=4)


@pytest.fixture(params=["sphere", "mixed"])
def case(request):
    return request.getfixturevalue(request.param)


# -- noise models -------------------------------------------------------------

NOISES = {
    "unit": lambda m: m.unit(),
    "sigmas": lambda m: m.sigmas(np.random.default_rng(0).uniform(
        0.1, 2.0, size=(4, 5))),
    "isotropic": lambda m: m.isotropic(5, 0.3),
    "precisions": lambda m: m.precisions([[1.0, 4.0, 9.0, 0.5, 2.0]]),
    "information": lambda m: m.information(_spd(5, 4)),
    "covariance": lambda m: m.covariance(_spd(5, 1)[0]),
}


def _spd(n, count):
    A = np.random.default_rng(1).normal(size=(count, n, n))
    return A @ A.transpose(0, 2, 1) + n * np.eye(n)


@pytest.mark.parametrize("kind", sorted(NOISES))
def test_noise_whiten_and_error(kind):
    """whiten, whiten_jacobian and error of each ported model against the
    JAX package's at 1e-13 (the same products; a Cholesky for information
    and covariance)."""
    rng = np.random.default_rng(2)
    r = rng.normal(size=(4, 5))
    A = rng.normal(size=(4, 5, 3))
    jm, tm = NOISES[kind](jnoise), NOISES[kind](tnoise)
    _close(tm.whiten(_t(r)), jm.whiten(jnp.asarray(r)), 1e-13)
    _close(tm.whiten_jacobian(_t(A)), jm.whiten_jacobian(jnp.asarray(A)),
           1e-13)
    _close(tm.error(_t(r)), jm.error(jnp.asarray(r)), 1e-13)


def test_unported_noise_and_manifolds_raise():
    """What the port still refuses: a type still unported (Sim2, and
    Between of it), an unknown noise kind or manifold, a SparseSolver
    method it does not know, and diagonal damping under the sparse QR (as
    the JAX package refuses it).  SE2 and its between factors build
    (tests/test_torch_pose2.py), as do robust and constrained noise
    (tests/test_torch_robust.py, tests/test_torch_constrained.py),
    SparseSolver(method="qr") (tests/test_torch_qr.py) and
    SparseSolver(method="levels") (tests/test_torch_sparse.py)."""
    with pytest.raises(NotImplementedError):
        tnoise.NoiseModel("isotropic_robust")
    with pytest.raises(NotImplementedError):
        TO.SparseSolver(method="multifrontal_lu")
    assert TO.SparseSolver(method="levels")._method == "levels"
    with pytest.raises(NotImplementedError):
        TO.SparseSolver(method="qr").solve((None, None, None), 1e-3, True)
    with pytest.raises(NotImplementedError):
        manifolds.get("Sim2")
    with pytest.raises(NotImplementedError):
        tfactors.between_factors("Sim2", [0], [1], np.zeros((1, 4)),
                                 tnoise.unit())
    assert manifolds.get("SE2").dim == 3
    assert tfactors.between_factors("SE2", [0], [1], np.zeros((1, 3)),
                                    tnoise.unit()).rdim == 3
    assert tnoise.constrained([0.0, 1.0]).kind == "constrained"
    assert tnoise.robust(tnoise.unit(), "huber").loss.name == "huber"
    assert manifolds.get("Vec4").dim == 4
    with pytest.raises(KeyError):
        manifolds.get("NoSuchType")


# -- input, initialization, metrics -------------------------------------------


def _write_edges(path, with_vertices):
    """A small file: EDGE_SE3:QUAT rows (with vertices) or EDGE3 rows
    (roll, pitch, yaw; no vertices: the loader composes the odometry)."""
    rng = np.random.default_rng(4)
    mod = _data_module()
    lines = []
    for k in range(5):
        if with_vertices:
            R, tr = mod._se3_exp(rng.normal(size=6))
            q = mod._quat(R)
            lines.append(f"VERTEX_SE3:QUAT {k} {tr[0]} {tr[1]} {tr[2]} "
                         f"{q[1]} {q[2]} {q[3]} {q[0]}")
    A = rng.normal(size=(6, 6))
    M = A @ A.T + 6.0 * np.eye(6)
    upper = " ".join(str(M[i, j]) for i in range(6) for j in range(i, 6))
    for i, j in ((0, 1), (1, 2), (2, 3), (3, 4), (0, 4)):
        v = rng.normal(size=6)
        if with_vertices:
            q = rng.normal(size=4)
            lines.append(f"EDGE_SE3:QUAT {i} {j} {v[0]} {v[1]} {v[2]} "
                         f"{q[0]} {q[1]} {q[2]} {q[3]} {upper}")
        else:
            lines.append(f"EDGE3 {i} {j} {' '.join(map(str, v))} {upper}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("with_vertices", [True, False])
def test_load_3d(tmp_path, with_vertices):
    """Keys, measurements, square-root informations (the g2o (t, R) ->
    (R, t) reorder of EDGE_SE3:QUAT) and initial poses equal the JAX
    package's at 1e-13 (the same parse; the Cholesky of each information
    matrix in LAPACK on both sides)."""
    path = str(tmp_path / "g.g2o")
    _write_edges(path, with_vertices)
    jg, jv = jdatasets.load_3d(path)
    tg, tv = tdatasets.load_3d(path)
    (jb,), (tb,) = jg.batches, tg.batches
    np.testing.assert_array_equal(tb.keys, jb.keys)
    _close(tb.measurements.R, jb.measurements.R, 1e-13)
    _close(tb.measurements.t, jb.measurements.t, 1e-13)
    assert tb.noise.kind == jb.noise.kind == "gaussian"
    _close(tb.noise.data, jb.noise.data, 1e-13)
    np.testing.assert_array_equal(tv.keys["SE3"], jv.keys["SE3"])
    _close(tv.arrays["SE3"].R, jv.arrays["SE3"].R, 1e-13)
    _close(tv.arrays["SE3"].t, jv.arrays["SE3"].t, 1e-13)


def test_chordal_initialization(sphere):
    """Chordal rotations and translations equal the JAX package's at 1e-12
    (the same scipy factorizations on the same matrices)."""
    jv, tv = sphere.jvals, sphere.tvals
    np.testing.assert_array_equal(tv.keys["SE3"], jv.keys["SE3"])
    _close(tv.arrays["SE3"].R, jv.arrays["SE3"].R, 1e-12)
    _close(tv.arrays["SE3"].t, jv.arrays["SE3"].t, 1e-12)


def test_ate_matches():
    rng = np.random.default_rng(5)
    gt_t = rng.normal(size=(20, 3))
    Rz = so3.expmap(_t([0.1, -0.2, 0.3])).numpy()
    est = gt_t @ Rz.T + 1.5 + rng.normal(size=(20, 3)) * 0.01
    for scale in (False, True):
        a = tmetrics.ate(est, gt_t, with_scale=scale)
        b = jmetrics.ate(est, gt_t, with_scale=scale)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-12 * max(abs(b[k]), 1.0)


# -- orderings and symbolic analysis -----------------------------------------


def _adjacency(case):
    return tordering.adjacency_from_factors(case.ts.batch_var_ids,
                                            case.ts.nvars)


@pytest.mark.parametrize("order", ["amd", "nd", "nd-bfs"])
def test_orderings_equal(sphere, order):
    """The native AMD, the native nested dissection and the BFS dissection
    give the JAX package's permutations exactly."""
    adj = _adjacency(sphere)
    jadj = jordering.adjacency_from_factors(sphere.js.batch_var_ids,
                                            sphere.js.nvars)
    assert (adj != jadj).nnz == 0
    if order == "amd":
        got, ref = tordering.minimum_degree(adj), jordering.minimum_degree(adj)
    else:
        m = "bfs" if order == "nd-bfs" else "native"
        got = tordering.nested_dissection(adj, method=m)
        ref = jordering.nested_dissection(adj, method=m)
    np.testing.assert_array_equal(got, ref)
    assert sorted(got.tolist()) == list(range(adj.shape[0]))


def _plan_arrays(s):
    """Every host plan array of a solver, by name."""
    out = {"perm": s.sym.perm, "inv_perm": s.sym.inv_perm,
           "snode_start": s.sym.snode_start, "snode_width": s.sym.snode_width,
           "snode_parent": s.sym.snode_parent, "block_row": s.sym.block_row,
           "block_col": s.sym.block_col,
           "diag_block_by_col": s.sym.diag_block_by_col,
           "asm_order": s._asm_order, "asm_seg": s._asm_seg,
           "asm_uniq": s._asm_uniq, "g_order": s._g_order,
           "g_seg": s._g_seg, "g_uniq": s._g_uniq, "pad_diag": s.pad_diag}
    for i, a in enumerate(s._mv_plan):
        out[f"mv_plan{i}"] = a
    for i, (s1, s2, flip, pos) in enumerate(s._asm_plan):
        out[f"asm_plan{i}"] = np.concatenate([[s1, s2, pos], flip])
    for lvl, lp in enumerate(s.level_plans):
        for f in lp.__dataclass_fields__:
            v = getattr(lp, f)
            out[f"level{lvl}.{f}"] = v
    return out


def test_analyze_supernodal_and_plans(case):
    """The auto ordering's choice, the symbolic structure, the levels,
    block_of and every plan array (each _LevelPlan field, the assembly,
    gradient and matvec plans, pad_diag) equal the JAX package's exactly."""
    js, ts = case.js, case.ts
    assert ts.chosen_order == js.chosen_order
    assert ts.B == js.B and ts.sym.nsuper == js.sym.nsuper
    assert ts.sym.block_of == js.sym.block_of
    assert len(ts.sym.levels) == len(js.sym.levels) >= 3
    for a, b in zip(ts.sym.levels, js.sym.levels):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.sym.snode_rows, js.sym.snode_rows):
        np.testing.assert_array_equal(a, b)
    got, ref = _plan_arrays(ts), _plan_arrays(js)
    assert got.keys() == ref.keys()
    for name in ref:
        if ref[name] is None or np.isscalar(ref[name]):
            assert got[name] == ref[name], name
        else:
            np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def test_analyze_supernodal_on_its_own(sphere):
    """analyze_supernodal alone, on one ordering at other widths, equals
    the JAX package's (structure and levels)."""
    adj = _adjacency(sphere)
    perm = tordering.minimum_degree(adj)
    kw = dict(relax_tau=0.5, force_width=2, max_width=16)
    a = tsupernodes.analyze_supernodal(adj, perm, **kw)
    b = jsupernodes.analyze_supernodal(adj, perm, **kw)
    for f in ("perm", "snode_start", "snode_width", "snode_parent",
              "snode_level", "block_row", "block_col"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.block_of == b.block_of


# -- the linear system, factorization, solves ---------------------------------


def test_system(case):
    """The block store and gradient against the JAX package's: kernel 6's
    closed-form Jacobians against jacfwd (SE3), the generic torch.func path
    against jacfwd (landmark factors), and the same sorted sums.  1e-12
    relative to the largest entry for the blocks; 1e-11 for g, whose
    entries J^T r carry the ~eps/theta^2 error of jacfwd through the
    closed-form SO(3) coefficients at the residuals' small angles."""
    jb, jg, tb, tg = case.systems()
    _close(tb, jb, 1e-12)
    _close(tg, jg, 1e-11)
    assert torch.all(tb[-1] == 0)


@pytest.mark.parametrize("damping", ["lambda", "diagonal"])
def test_factorize_per_level(case, damping):
    """Each level's L and Lp, and ok / badcol, against the JAX package's at
    1e-10 (the fronts are Cholesky factors of the same matrices, summed in
    another order; 1e-10 leaves room for the fronts' conditioning at lam =
    1e-2)."""
    jb, _, tb, _ = case.systems()
    dd = damping == "diagonal"
    _, jL, jP, jok, jbad = jax.jit(case.js.factorize, static_argnums=2)(
        jnp.asarray(jb), 1e-2, dd)
    f = case.ts.factorize(tb, 1e-2, dd)
    assert bool(f.ok) and bool(jok) and int(f.badcol) == int(jbad) == -1
    assert len(f.Ldiag) == len(jL)
    for a, b, c, e in zip(f.Ldiag, jL, f.Lpanel, jP):
        _close(a, b, 1e-10)
        assert (c is None) == (e is None)
        if c is not None:
            _close(c, e, 1e-10)


def _level_outputs(s, blocks, lam, dd):
    """Each level's front kernel outputs (L, L^-1, At, rec), its panel Lp
    (None without a row structure) and a copy of the working store after
    its Schur update, on the CPU (the plain versions), along factorize's
    own path: the working store takes each level's update before the next
    level gathers."""
    dv = s.dev
    work = blocks.clone()
    out = []
    for lv in dv.levels:
        rec = torch.empty(lv.S, dtype=torch.int32)
        L, Linv, At, _ = K.sn_front_factor(
            work, blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
            lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, lam, dd, rec)
        Lp = None
        if lv.R:
            Lp = K.sn_schur_update(Linv, At, lv.schur, work, dv.schur_U)
        out.append((L, Linv, At, rec, Lp, work.clone()))
    return out


def test_front_inverses_against_numpy(case):
    """The front kernel's plain L^-1 of every front against
    numpy.linalg.inv of its L, at 1e-12 relative to the largest entry (two
    inverses of a triangular factor of condition ~sqrt(cond(H + lam I)),
    summed in another order), at lam 1e-4 and 1; both are column-major per
    front (what level_table and the panel product read) and lower
    triangular."""
    _, _, tb, _ = case.systems()
    for lam in (1e-4, 1.0):
        for L, Linv, _, rec, _, _ in _level_outputs(case.ts, tb, lam,
                                                    False):
            assert L.mT.is_contiguous() and Linv.mT.is_contiguous()
            assert torch.all(rec == -1)
            _close(Linv, np.linalg.inv(L.numpy()), 1e-12)
            assert torch.equal(Linv, Linv.tril())


def test_schur_update_against_jax(case):
    """Each level's panel Lp and the working store after its Schur update
    against the JAX package's factorize at 1e-10 relative to the largest
    entry (the products summed in another order, through L^-1 here and a
    triangular solve there): its panels (:431-434), and its store replayed
    level by level from them (the damping added once, :383-393, then
    :436-441); the port's store is undamped, so its diagonal blocks take
    the same damping for the comparison.  The plan's U offsets name the
    blocks that its src lists."""
    jb, _, tb, _ = case.systems()
    s, js, lam = case.ts, case.js, 1e-2
    _, _, jP, _, _ = jax.jit(js.factorize, static_argnums=2)(
        jnp.asarray(jb), lam, False)
    d = s.d
    diag = np.arange(d) * (d + 1)
    dbc = s.sym.diag_block_by_col
    jwork = jnp.asarray(jb).at[dbc[:, None], diag[None, :]].add(
        js._damp_vec(jnp.asarray(jb), lam, False))
    damp = s.damp_vec(tb, lam, False)
    outs = _level_outputs(s, tb, lam, False)
    assert sum(lp.R > 0 for lp in s.level_plans) >= 2
    for lp, lv, P, (_, _, _, _, Lp, work) in zip(js.level_plans, s.dev.levels,
                                                 jP, outs):
        assert (Lp is None) == (P is None) == (lp.R == 0)
        if P is None:
            continue
        _close(Lp, P, 1e-10)
        S, R = lp.S, lp.R
        U = jnp.einsum("sij,skj->sik", P, P)
        # the kernel's offsets of the summed blocks' first entries in U
        np.testing.assert_array_equal(
            np.asarray(U).reshape(-1)[lv.schur.uoff.numpy()],
            np.asarray(U).reshape(S, R, d, R, d)[:, :, 0, :, 0].reshape(-1)[
                lv.schur.src.numpy()])
        Ub = U.reshape(S, R, d, R, d).transpose(0, 1, 3, 2, 4).reshape(
            S * R * R, d * d)
        seg = jax.ops.segment_sum(Ub[lp.schur_src], lp.schur_seg,
                                  num_segments=len(lp.schur_tgt))
        jwork = jwork.at[lp.schur_tgt].add(-seg)
        got = work.clone()
        got[torch.as_tensor(dbc).long()[:, None],
            torch.as_tensor(diag)[None, :]] += damp
        _close(got, np.asarray(jwork), 1e-10)


def test_schur_update_leaves_other_rows(case):
    """The Schur update writes only its targets: at each level of a
    factorization, on a copy of the working store whose rows outside the
    level's schur_tgt (the sentinel row among them) hold NaN, those rows
    keep their bits and the targets come out finite and changed."""
    _, _, tb, _ = case.systems()
    s, dv = case.ts, case.ts.dev
    work = tb.clone()
    checked = 0
    for lv in dv.levels:
        _, Linv, At, _ = K.sn_front_factor(
            work, tb, lv.diag_ids, lv.diag_flip, lv.diag_pad,
            lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, 1.0, False,
            torch.empty(lv.S, dtype=torch.int32))
        if not lv.R:
            continue
        other = torch.ones(s.B + 1, dtype=torch.bool)
        other[lv.schur.tgt.long()] = False
        assert bool(other[s.B]) and bool(other.any())
        got = work.clone()
        got[other] = float("nan")
        K.sn_schur_update(Linv, At, lv.schur, got, dv.schur_U)
        assert bool(torch.isnan(got[other]).all())
        assert torch.equal(got[other].view(torch.int64),
                           torch.full_like(got[other], float("nan")).view(
                               torch.int64))
        K.sn_schur_update(Linv, At, lv.schur, work, dv.schur_U)
        assert torch.equal(got[~other], work[~other])
        assert not torch.equal(got[~other], tb[~other])
        checked += 1
    assert checked >= 2


def _spoil_pivot(case, blocks, level):
    """A copy of the store whose first column of front 0 of `level` has
    the diagonal -1e6: that front's first pivot fails, and no lower level
    reads it.  Returns (store, the column's permuted id)."""
    s = case.ts
    c = int(s.level_plans[level].col_vars[0, 0])
    bad = blocks.clone()
    bad[int(s.sym.diag_block_by_col[c]), 0] = -1e6
    return bad, c


def _jax_badcol(case, blocks, lam):
    _, _, _, jok, jbad = jax.jit(case.js.factorize, static_argnums=2)(
        jnp.asarray(blocks.numpy()), lam, False)
    return bool(jok), int(jbad)


def test_bad_pivot_in_a_middle_level(sphere):
    """A failed pivot in a middle level: ok is False and badcol is that
    front's first column in both packages (the JAX package's failed front
    is NaN, so its first true pivot is the first bad one; the port's first
    bad pivot is the same column), and the front's record names it."""
    _, _, tb, _ = sphere.systems()
    m = len(sphere.ts.level_plans) // 2
    assert 0 < m < len(sphere.ts.level_plans) - 1
    bad, c = _spoil_pivot(sphere, tb, m)
    f = sphere.ts.factorize(bad, 1e-2)
    assert not bool(f.ok) and int(f.badcol) == c
    assert _jax_badcol(sphere, bad, 1e-2) == (False, c)
    recs = [o[3] for o in _level_outputs(sphere.ts, bad, 1e-2, False)]
    assert all(torch.all(r == -1) for r in recs[:m])
    assert int(recs[m][0]) == c


def test_first_bad_level_wins(sphere):
    """Two levels fail (a middle one and the top one): the records of both
    say so, and the one-launch reduction over all the records, like the
    JAX package's per-level fold, reports the first bad level's column;
    the plain reduction also on records made up by hand."""
    _, _, tb, _ = sphere.systems()
    top = len(sphere.ts.level_plans) - 1
    m = top // 2
    bad, c = _spoil_pivot(sphere, tb, m)
    bad, c_top = _spoil_pivot(sphere, bad, top)
    recs = [o[3] for o in _level_outputs(sphere.ts, bad, 1e-2, False)]
    assert int(recs[m][0]) == c and int(recs[top][0]) >= 0
    f = sphere.ts.factorize(bad, 1e-2)
    assert not bool(f.ok) and int(f.badcol) == c != c_top
    assert _jax_badcol(sphere, bad, 1e-2) == (False, c)
    state = torch.zeros(2, dtype=torch.int32)
    for rec, want in (([-1, -1, 9, -1, 4], [0, 9]), ([-1, -1], [1, -1]),
                      ([3], [0, 3])):
        K.sn_pivot_check(torch.tensor(rec, dtype=torch.int32), state)
        assert state.tolist() == want


def test_factorize_on_cpu_launches_nothing(mixed):
    """factorize on CPU tensors takes the plain versions (no launch is
    counted) and leaves each level's L and Lp column-major per front, as
    the front kernel and the panel product leave them on the card, so
    level_table keeps them without a copy."""
    _, _, tb, _ = mixed.systems()
    _kernels.reset_launch_counts()
    f = mixed.ts.factorize(tb, 1e-2, True)
    assert bool(f.ok)
    assert all(n == 0 for n in _kernels.launch_counts().values())
    for L, P, Lk, Pk in zip(f.Ldiag, f.Lpanel, f.levels.Ls, f.levels.Ps):
        assert L.mT.is_contiguous() and Lk is L
        assert (P is None) == (Pk is None)
        assert P is None or (P.mT.is_contiguous() and Pk is P)


def _dense_oracle(case, lam, dd):
    """The dense (H + damping) and g in the canonical layout, from the
    port's dense gn_system (the generic jacfwd path and index_put_ sums,
    held to the JAX package's by test_dense_solver_paths)."""
    H, g = case.tbound.gn_system(case.tvals.arrays)
    H, g = H.numpy(), g.numpy()
    D = np.clip(np.diag(H), 1e-6, 1e32) if dd else np.ones(len(g))
    return H + np.diag(lam * D), g


def test_solves_against_jax_and_dense(case):
    """_solve_padded (kernel 8's plain sn_forward and sn_backward over the
    gather CSR) against the JAX package's at lam 1e-4, 1e-3 and 1, and
    solve_refined at 1e-3, at 1e-9; the refined step against the dense
    (H + lam I)^-1 g at 1e-9 (the system's condition number times eps
    leaves that room)."""
    jb, jg, tb, tg = case.systems()
    lam = 1e-3

    def jax_solves(b, g, lam_s):
        f = case.js.factorize(b, lam_s, False)
        return (case.js._solve_padded(f, g),
                case.js.solve_refined(b, g, lam, False, refine_iters=1))

    jsolve = jax.jit(jax_solves)
    for lam_s in (1e-4, 1.0, lam):
        jx, jdx = jsolve(jnp.asarray(jb), jnp.asarray(jg), lam_s)
        f = case.ts.factorize(tb, lam_s, False)
        _close(case.ts._solve_padded(f, tg), jx, 1e-9)
    dx, ok = case.ts.solve_refined(tb, tg, lam, False, refine_iters=1)
    assert bool(ok)
    _close(dx, jdx, 1e-9)
    Hd, g = _dense_oracle(case, lam, False)
    _close(dx, np.linalg.solve(Hd, g), 1e-9)


@pytest.mark.parametrize("dd", [False, True])
def test_matvec(case, dd):
    """(H + damping) x on the block store against the JAX package's matvec
    and the dense product, at 1e-12 (the same sums in the same order; the
    dense product in another)."""
    jb, _, tb, _ = case.systems()
    x = np.random.default_rng(6).normal(size=(case.ts.nvars, case.ts.d))
    x = x * (1.0 - case.ts.pad_diag)
    got = case.ts.matvec(tb, _t(x), 0.3, dd)
    jmv = jax.jit(case.js.matvec, static_argnums=3)
    _close(got, jmv(jnp.asarray(jb), jnp.asarray(x), 0.3, dd), 1e-12)
    Hd, _ = _dense_oracle(case, 0.3, dd)
    ref = case.ts._flatten(torch.as_tensor(x)).numpy()
    _close(case.ts._flatten(got), Hd @ ref, 1e-12)


def test_tile_inverses_against_numpy(case):
    """The tile inverses that factorize hands kernel 8 (the front kernel's;
    on the CPU its plain version's) against numpy.linalg.inv of every
    32x32 diagonal tile of every front, built here from the level factors
    (a partial last tile padded with the identity, the fronts' padded
    column slots included), at 1e-12 relative to the largest entry; the
    padding inverts to exactly the identity."""
    _, _, tb, _ = case.systems()
    for lam in (1e-4, 1.0):
        f = case.ts.factorize(tb, lam, False)
        ref, pads = [], []
        for L in f.Ldiag:
            Ln = L.numpy()
            S, Wd, _ = Ln.shape
            for s in range(S):
                for j0 in range(0, Wd, K.TILE):
                    nb = min(K.TILE, Wd - j0)
                    T = np.eye(K.TILE)
                    T[:nb, :nb] = np.tril(Ln[s, j0:j0 + nb, j0:j0 + nb])
                    ref.append(np.linalg.inv(T))
                    pads.append(nb)
        assert f.Linv.shape == (len(ref), K.TILE, K.TILE)
        assert any(nb < K.TILE for nb in pads)
        _close(f.Linv, np.stack(ref), 1e-12)
        for got, nb in zip(f.Linv.numpy(), pads):
            pad = np.eye(K.TILE)[nb:]
            np.testing.assert_array_equal(got[nb:], pad)
            np.testing.assert_array_equal(got[:, nb:], pad.T)


def test_gather_csr_against_the_jax_forward_plans(case):
    """The all-levels gather CSR lists, for every column slot, exactly the
    (level, c row -> target) pairs of the JAX plan's per-level fwd_src /
    fwd_seg / fwd_tgt whose target is the slot's variable: one segment per
    level, in level order, each with its rows in fwd_src order; every pair
    appears once."""
    ts, js = case.ts, case.js
    n = ts.nvars
    want, crow = {}, 0      # var -> [(level, [c rows])] in level order
    for k, lp in enumerate(js.level_plans):
        if lp.R:
            for i, u in enumerate(lp.fwd_tgt):
                rows = (lp.fwd_src[lp.fwd_seg == i] + crow).tolist()
                want.setdefault(int(u), []).append((k, rows))
            crow += lp.S * lp.R
    level_of_row = np.concatenate([np.full(lp.S * lp.R, k) for k, lp in
                                   enumerate(js.level_plans) if lp.R])
    assert ts.n_c == crow * ts.d
    np.testing.assert_array_equal(ts.sol_cols, np.concatenate(
        [lp.col_vars.reshape(-1) for lp in js.level_plans]))
    got, pairs = {}, 0
    for q, v in enumerate(ts.sol_cols):
        segs = []
        for e in range(ts.gat_ptr[q], ts.gat_ptr[q + 1]):
            rows = ts.gat_src[ts.gat_seg[e]:ts.gat_seg[e + 1]].tolist()
            assert len(set(level_of_row[rows])) == 1
            segs.append((int(level_of_row[rows[0]]), rows))
            pairs += len(rows)
        if segs:
            assert v < n
            got[int(v)] = segs
    assert got == want
    assert pairs == len(ts.gat_src) == sum(
        len(lp.fwd_src) for lp in js.level_plans if lp.R)


def _rows_outside_t(s):
    """Store rows outside T (the sentinel row B included), as a mask."""
    out = np.ones(s.B + 1, dtype=bool)
    out[s.asm_blk] = False
    return torch.as_tensor(out)


def test_store_rows_t_are_the_rows_h_fills(case):
    """T (asm_blk) is exactly the set of store rows that the JAX package's
    system leaves non-zero, at two random states (random steps from the
    initial values, so no entry of H is zero by accident)."""
    jsys = jax.jit(case.js.system)
    rng = np.random.default_rng(11)
    for _ in range(2):
        delta = rng.normal(size=case.jvals.layout().total_dim) * 0.1
        jb = np.asarray(jsys(case.jvals.retract(jnp.asarray(delta)).arrays)[0])
        np.testing.assert_array_equal(
            np.flatnonzero(np.any(jb != 0, axis=1)), case.ts.asm_blk)


def test_system_into_an_owned_store(case):
    """Two successive system calls into one store at different states give
    exactly what fresh stores give (the first state's blocks leave nothing
    behind), and a fresh store is zero outside T."""
    s = case.ts
    rng = np.random.default_rng(12)
    store = s.new_store()
    outside = _rows_outside_t(s)
    for _ in range(2):
        delta = _t(rng.normal(size=s.layout.total_dim) * 0.1)
        arrays = case.tvals.retract(delta).arrays
        fb, fg = s.system(arrays)
        assert torch.all(fb[outside] == 0)
        ob, og = s.system(arrays, out=store)
        assert ob is store
        assert torch.equal(ob, fb) and torch.equal(og, fg)


@pytest.mark.parametrize("dd", [False, True])
def test_matvec_over_t_equals_the_full_store(case, dd):
    """sn_matvec_plain over the CSRs of T equals the same function over the
    JAX plan's CSRs of the whole store (fill included) at 1e-15: the sums
    differ only by exact-zero terms."""
    s = case.ts
    _, _, tb, _ = case.systems()
    ro, _, _, _, coi, _, _ = s._mv_plan
    n = s.nvars
    full = (_t(np.concatenate([[0], np.cumsum(np.bincount(
                s.sym.block_row, minlength=n))]).astype(np.int32)),
            _t(ro.astype(np.int32)),
            _t(np.concatenate([[0], np.cumsum(np.bincount(
                s.sym.block_col[coi], minlength=n))]).astype(np.int32)),
            _t(coi.astype(np.int32)))
    dv = s.dev
    x = _t(np.random.default_rng(13).normal(size=(n, s.d)))
    rest = (dv.block_row, dv.block_col, dv.dbc, dv.pad_diag, 0.3, dd)
    got = K.sn_matvec_plain(tb, x, dv.mv_row_ptr, dv.mv_row_blk,
                            dv.mv_col_ptr, dv.mv_col_blk, *rest)
    assert len(dv.mv_row_blk) < len(ro) and len(dv.mv_col_blk) < len(coi)
    _close(got, K.sn_matvec_plain(tb, x, *full, *rest), 1e-15)


def test_plain_kernels_against_the_dense_factor(sphere):
    """The plain versions of kernels 7 and 8 against dense linear algebra:
    the level factors, placed into one lower-triangular L, give
    L L^T = P (H + lam I) P^T at 1e-12, and the forward and backward
    passes give the dense solve at 1e-10."""
    _, _, tb, tg = sphere.systems()
    s = sphere.ts
    n, d = s.nvars, s.d
    lam = 0.5
    f = s.factorize(tb, lam, False)
    Lfull = np.zeros((n * d, n * d))
    for lp, L, P in zip(s.level_plans, f.Ldiag, f.Lpanel):
        for si in range(lp.S):
            cols = lp.col_vars[si]
            w = int((cols < n).sum())
            ci = (cols[:w, None] * d + np.arange(d)).reshape(-1)
            Lfull[np.ix_(ci, ci)] = L[si, :w * d, :w * d].numpy()
            if P is not None:
                rows = lp.row_vars[si]
                r = int((rows < n).sum())
                ri = (rows[:r, None] * d + np.arange(d)).reshape(-1)
                Lfull[np.ix_(ri, ci)] = P[si, :r * d, :w * d].numpy()
    Hd, g = _dense_oracle(sphere, lam, False)
    perm = (s.sym.inv_perm[:, None] * d + np.arange(d)).reshape(-1)
    Hp = np.zeros_like(Hd)
    Hp[np.ix_(perm, perm)] = Hd
    _close(Lfull @ Lfull.T, Hp, 1e-12)
    x = s.solve_factored(f, tg).numpy()
    _close(x, np.linalg.solve(Hd, g), 1e-10)


def _jacfwd_blocks(T, Z, arity):
    """Unwhitened Jacobians of the port's own residual by torch.func.jacfwd
    at delta = 0: (J_i[, J_j])."""
    def res(di, dj):
        Ti = se3.retract(T[0], di)
        if arity == 1:
            return se3.local(Z, Ti)
        return se3.local(Z, se3.between(Ti, se3.retract(T[1], dj)))
    z = torch.zeros(6, dtype=torch.float64)
    Ji, Jj = torch.func.jacfwd(res, argnums=(0, 1))(z, z)
    return (Ji,) if arity == 1 else (Ji, Jj)


@pytest.mark.parametrize("angle", [0.0, 1e-7, 0.8, math.pi - 1e-4])
def test_kernel6_jacobians_against_jacfwd(angle):
    """Kernel 6's closed-form Jacobians (its plain version) against
    torch.func.jacfwd of the port's se3 at 1e-12 relative, for residual
    rotations of the given angle: exactly 0, in the Taylor branch, mid
    range, and next to pi.  (Between ~1e-5 and ~0.05 rad jacfwd through
    the closed-form SO(3) coefficients loses up to ~1e-7 to cancellation,
    which the closed form's Taylor branch avoids.)"""
    rng = np.random.default_rng(7)
    xi = rng.normal(size=(2, 6))
    Ti = se3.expmap(_t(xi[0]))
    Tj = se3.expmap(_t(xi[1]))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    E = se3.expmap(_t(np.concatenate([axis * angle, rng.normal(size=3)])))
    Z = se3.compose(se3.between(Ti, Tj), se3.inverse(E))   # Z^-1 Tij = E
    R = torch.stack([Ti.R, Tj.R])
    tt = torch.stack([Ti.t, Tj.t])
    for arity in (2, 1):
        if arity == 1:
            Zk = se3.compose(Ti, se3.inverse(E))
        else:
            Zk = Z
        rows = torch.tensor([[0, 1]] if arity == 2 else [[0]],
                            dtype=torch.int32)
        A, b = K.pg_jacobians_plain(R, tt, rows, Zk.R[None], Zk.t[None],
                                    "unit", None)
        ref = _jacfwd_blocks((Ti, Tj), Zk, arity)
        for a, r in zip(A, ref):
            _close(a[0], r, 1e-12)
        _close(-b[0], se3.logmap(E), 1e-12)


def test_failed_factorization(mixed):
    """A landmark that no factor touches makes H singular there: the JAX
    package and the port both report not ok; the port names the landmark
    (its permuted column, and check_system's variable) where cholesky_ex
    stopped, and Gauss-Newton raises there on its first try (cholesky_ex
    leaves no NaN in a failed front, so the port counts ok == False as a
    failed try instead of solving on with a zeroed factor, as the JAX
    package does)."""
    p = _mixed_parts()
    tg = FactorGraph(mixed.tgraph.batches[:2])     # poses only
    tv = Values({"SE3": mixed.tvals.arrays["SE3"],
                 "Point3": mixed.tvals.arrays["Point3"][:1]},
                {"SE3": np.arange(p["n_pose"]), "Point3": np.array([100])})
    jg = JGraph(mixed.jgraph.batches[:2])
    jv = JValues({"SE3": mixed.jvals.arrays["SE3"],
                  "Point3": mixed.jvals.arrays["Point3"][:1]},
                 {"SE3": np.arange(p["n_pose"]), "Point3": np.array([100])})
    ts = SupernodalCholeskySolver(BoundGraph(tg, tv, "cpu"), force_width=2)
    js = JSolver(jg.bind(jv), force_width=2)
    blocks, _ = ts.system(tv.arrays)
    f = ts.factorize(blocks, 0.0)
    jf = js.factorize(js.system(jv.arrays)[0], 0.0)
    assert not bool(f.ok) and not bool(jf[3])
    lm_var = 0                     # "Point3" sorts before "SE3"
    assert ts.sym.perm[int(f.badcol)] == lm_var
    with pytest.raises(IndeterminantLinearSystemError) as e:
        ts.check_system(tv.arrays)
    assert e.value.var == lm_var
    with pytest.raises(IndeterminantLinearSystemError) as e:
        TO.gauss_newton(tg, tv, solver=TO.SparseSolver(
            supernodal_kwargs=dict(force_width=2)), device="cpu")
    assert e.value.var == lm_var


def test_flatten_and_pack_roundtrip(mixed):
    s = mixed.ts
    v = torch.as_tensor(np.random.default_rng(8).normal(
        size=s.layout.total_dim))
    xp = s.pack_rhs(v)
    assert torch.equal(s._flatten(xp), v)
    assert torch.all(xp[torch.as_tensor(s.pad_diag) > 0] == 0)
    np.testing.assert_array_equal(
        xp.numpy(), np.asarray(mixed.js.pack_rhs(jnp.asarray(v.numpy()))))


# -- the optimizers -------------------------------------------------------------


def _lm_params(mod, policy, maxit=10, diagonal_damping=False):
    return mod.LMParams(max_iterations=maxit, relative_error_tol=1e-9,
                        absolute_error_tol=1e-12, lambda_policy=policy,
                        diagonal_damping=diagonal_damping)


@pytest.mark.parametrize("policy,dd", [("gain", False), ("gtsam", False),
                                       ("conservative", False),
                                       ("gain", True)],
                         ids=["gain", "gtsam", "conservative",
                              "gain-diagonal_damping"])
def test_make_fused_lm(sphere, policy, dd):
    """make_fused_lm (SparseSolver, one refinement pass) against the JAX
    package's on the sphere, with lam I or diagonal damping: iterations,
    tries and converged equal, the half-chi2 history at rtol 1e-9 (the JAX
    package refines in two-float pairs, the port in float64; the steps
    agree to ~1e-13).  The solver's owned store is still zero outside T
    after the run."""
    jfn = JO.make_fused_lm(sphere.jgraph, sphere.jvals,
                           _lm_params(gt, policy, diagonal_damping=dd),
                           solver=JO.SparseSolver(refine_iters=1,
                                                  supernodal_kwargs=SN_KW))
    jit, _, jerr, jconv, jhist, jtries = jfn(sphere.jvals.arrays)
    tfn = TO.make_fused_lm(sphere.tgraph, sphere.tvals,
                           _lm_params(TO, policy, diagonal_damping=dd),
                           solver=TO.SparseSolver(refine_iters=1,
                                                  supernodal_kwargs=SN_KW),
                           device="cpu")
    it, arrays, err, conv, hist, tries = tfn(sphere.tvals.arrays)
    assert (it, tries, conv) == (int(jit), int(jtries), bool(jconv))
    assert it >= 3
    _close(hist[:it + 1], np.asarray(jhist)[:it + 1], 1e-9)
    assert abs(err - float(jerr)) <= 1e-9 * float(jerr)
    assert torch.isnan(hist[it + 1:]).all()
    store = tfn.solver.store
    assert store is not None
    assert torch.all(store[_rows_outside_t(tfn.solver._s)] == 0)


def test_levenberg_marquardt_sparse(mixed):
    """levenberg_marquardt on the mixed graph with SparseSolver: the
    history and iterations of the JAX package's at rtol 1e-9."""
    jres = JO.levenberg_marquardt(
        mixed.jgraph, mixed.jvals, _lm_params(gt, "gtsam"),
        solver=JO.SparseSolver(supernodal_kwargs=dict(force_width=2)))
    tres = TO.levenberg_marquardt(
        mixed.tgraph, mixed.tvals, _lm_params(TO, "gtsam"),
        solver=TO.SparseSolver(supernodal_kwargs=dict(force_width=2)),
        device="cpu")
    assert tres.iterations == jres.iterations
    assert tres.converged == jres.converged
    _close(tres.history, jres.history, 1e-9)


def test_dense_solver_paths(mixed):
    """The auto solver of a small graph (dense normal equations through the
    generic linearization) in gauss_newton and levenberg_marquardt against
    the JAX package's at rtol 1e-9."""
    for jf, tf_ in ((JO.gauss_newton, TO.gauss_newton),
                    (JO.levenberg_marquardt, TO.levenberg_marquardt)):
        p = _lm_params(gt, "gtsam") if jf is JO.levenberg_marquardt \
            else gt.OptimizerParams(max_iterations=10,
                                    relative_error_tol=1e-9)
        tp = _lm_params(TO, "gtsam") if tf_ is TO.levenberg_marquardt \
            else TO.OptimizerParams(max_iterations=10,
                                    relative_error_tol=1e-9)
        jres = jf(mixed.jgraph, mixed.jvals, p)
        tres = tf_(mixed.tgraph, mixed.tvals, tp, device="cpu")
        assert tres.iterations == jres.iterations
        _close(tres.history, jres.history, 1e-9)


def test_graph_error_and_cpu_path_launches_nothing(case):
    """The bound graph's error (kernel 6's plain error for SE3 batches, the
    generic residuals for the rest) equals the JAX package's at 1e-12, and
    the CPU path counts no kernel launch."""
    _kernels.reset_launch_counts()
    got = case.tbound.error(case.tvals.arrays)
    ref = case.jbound.error(case.jvals.arrays)
    _close(got, ref, 1e-12)
    case.ts.solve_refined(*case.systems()[2:], 1e-3, False, 1)
    assert all(n == 0 for n in _kernels.launch_counts().values())


def test_kernel6_plain_versions_under_each_noise_kind():
    """Kernel 6's plain versions against the JAX package on a seeded graph
    of SE3 between factors and a prior, under unit, diagonal and gaussian
    noise, each one model for the batch and one a factor (unit: none):
    pg_error_plain through BoundGraph.error against the JAX bound graph's
    error; pg_jacobians_plain's whitened A and b against factors.linearize
    (jacfwd); and the H and gv blocks pg_linearize_plain writes (sign
    A_s1^T A_s2, the (0, 1) block transposed where flip says so, and sign
    A_s^T b; store width 8, its padding zero) against the same products of
    the JAX Jacobians.  Half the between measurements lie near the relative
    poses (residual angles of 0.006-0.03 rad, in Jr^-1's Taylor branch),
    half ~0.3 rad away.  1e-12 relative to the largest entry of each
    output, but 1e-11 for the near half's Jacobians and their products:
    jacfwd differentiates the SO(3) log's closed form, whose cancellation
    costs ~eps / theta^2 (6e-12 at 0.006 rad; torch's autograd of the same
    formulas agrees with jacfwd to 6e-14), where the plain versions take
    Jr^-1's Taylor series."""
    rng = np.random.default_rng(12)
    n, N, d = 12, 24, 8
    T = se3.expmap(_t(rng.normal(size=(n, 6))
                      * np.array([0.8] * 3 + [3.0] * 3)))
    i = rng.integers(0, n, N)
    j = (i + 1 + rng.integers(0, n - 1, N)) % n
    near = np.where(np.arange(N) < N // 2, 1e-2, 0.3)[:, None]
    Z = se3.compose(se3.between(SE3(T.R[i], T.t[i]), SE3(T.R[j], T.t[j])),
                    se3.expmap(_t(rng.normal(size=(N, 6)) * near)))
    Zp = se3.compose(SE3(T.R[3:4], T.t[3:4]),
                     se3.expmap(_t(rng.normal(size=(1, 6)) * 0.2)))
    flip = torch.as_tensor(rng.random(N) < 0.5)
    A6 = rng.normal(size=(N, 6, 6))
    info = A6 @ A6.transpose(0, 2, 1) + 6 * np.eye(6)
    sig = rng.uniform(0.05, 2.0, size=(N, 6))
    models = [("unit", lambda m, k: m.unit())]
    for scope, rows in (("shared", slice(0, 1)), ("per-factor", None)):
        def pick(a, k, rows=rows):
            return a[rows] if rows is not None else a[:k]
        models += [
            (f"diagonal {scope}", lambda m, k, pick=pick: m.sigmas(
                pick(sig, k))),
            (f"gaussian {scope}", lambda m, k, pick=pick: m.information(
                pick(info, k)))]
    jT = gt.SE3(jnp.asarray(T.R.numpy()), jnp.asarray(T.t.numpy()))
    jv = JValues({"SE3": jT}, {"SE3": np.arange(n)})
    tv = Values({"SE3": T}, {"SE3": np.arange(n)})
    for label, model in models:
        jg, tg = JGraph(), FactorGraph()
        jg.add(jfactors.between_factors(
            "SE3", i, j, gt.SE3(jnp.asarray(Z.R.numpy()),
                                jnp.asarray(Z.t.numpy())), model(jnoise, N)))
        jg.add(gt.prior_factors("SE3", [3], gt.SE3(
            jnp.asarray(Zp.R.numpy()), jnp.asarray(Zp.t.numpy())),
            model(jnoise, 1)))
        tg.add(tfactors.between_factors("SE3", i, j, Z, model(tnoise, N)))
        tg.add(tfactors.prior_factors("SE3", [3], Zp, model(tnoise, 1)))
        tb = BoundGraph(tg, tv, "cpu")
        _close(tb.error(tv.arrays), jg.bind(jv).error(jv.arrays), 1e-12)
        for jbatch, b, st in zip(jg.batches, tg.batches, tb.structures):
            rows = st.rows_i32
            xs = tuple(gt.SE3(jT.R[np.asarray(rows[:, s])],
                              jT.t[np.asarray(rows[:, s])])
                       for s in range(b.arity))
            jA, jb = jfactors.linearize(jbatch, xs)
            jA = [np.asarray(a) for a in jA]
            args = (T.R, T.t, rows, b.measurements.R, b.measurements.t,
                    b.noise.kind, b.noise.data)
            A, bv = K.pg_jacobians_plain(*args)
            M = b.num_factors
            cut = M // 2 if b.arity == 2 else 0

            def close(got, ref):
                if cut:
                    _close(got[:cut], ref[:cut], 1e-11)
                _close(got[cut:], ref[cut:], 1e-12)
            for a, ja in zip(A, jA):
                close(a.numpy(), ja)
            _close(bv, jb, 1e-12)
            fl = flip[:M] if b.arity == 2 else torch.zeros(M, dtype=bool)
            npair = 3 if b.arity == 2 else 1
            H = torch.full((M, npair, d * d), np.nan, dtype=torch.float64)
            gv = torch.full((M, b.arity, d), np.nan, dtype=torch.float64)
            K.pg_linearize_plain(*args, -1.0, fl, H, gv)
            H, gv = H.view(M, npair, d, d).numpy(), gv.numpy()
            for p, (s1, s2) in enumerate(K._pair_slots(b.arity)):
                ref = -np.einsum("nri,nrj->nij", jA[s1], jA[s2])
                if s1 != s2:
                    ref = np.where(fl.numpy()[:, None, None],
                                   ref.transpose(0, 2, 1), ref)
                close(H[:, p, :6, :6], ref)
            for s in range(b.arity):
                close(gv[:, s, :6],
                      -np.einsum("nrd,nr->nd", jA[s], np.asarray(jb)))
            assert not H[:, :, 6:].any() and not H[:, :, :, 6:].any()
            assert not gv[:, :, 6:].any(), label
