"""Parity of gtsam_torch's multifrontal QR (SparseSolver(method="qr")) with
gtsam_tpu's (CPU).

The JAX side runs float64 (tests/conftest.py turns x64 on); the torch side
float64 on the CPU, where kernel 6's Jacobian mode and kernel 12 compute
their plain versions (pg_jacobians_plain, pg2_jacobians_plain and
sn_front_qr_plain: torch.linalg.qr of the same gather, R's rows signed so
its diagonal is non-negative).  Inputs are made with numpy from seeds and
handed to both packages.  Graphs, factorized with force_width 4: a 6-ring
x 8-pose sphere (scripts/port_sphere_data.py) with bench.py's prior (SE3),
a 60-pose Manhattan world (scripts/port_2d_data.py, 150 edges; SE2, store
width 3: levels of odd W d and R d) with a prior on pose 0, and a graph
mixing SE3 poses with Point3 landmarks through a custom factor (the
generic linearization; the 6-wide store pads the landmarks).  The JAX
package's QR leaves R's row signs arbitrary: factors are compared through
R^T R and |diag R|.  Tolerances, each stated where it is used.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_tpu.base import losses as jlosses
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.geometry import se3 as jse3
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.io import datasets as jdatasets
from gtsam_tpu.linear.supernodal import SupernodalCholeskySolver as JSolver
from gtsam_tpu.optimize import optimizers as JO
from gtsam_tpu.slam.initialize import initialize_pose2_lago as jlago
from gtsam_tpu.slam.initialize import initialize_pose3_chordal as jchordal

from gtsam_torch import _kernels
from gtsam_torch.base import losses as tlosses
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se3
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.io import datasets as tdatasets
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
from gtsam_torch.optimize import optimizers as TO
from gtsam_torch.slam.initialize import (initialize_pose2_lago,
                                         initialize_pose3_chordal)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SN_KW = dict(force_width=4, max_width=8)
PRIOR = {"SE3": [[1e-3] * 3 + [1e-2] * 3], "SE2": [[1e-3, 1e-3, 1e-4]]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, ref):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.abs(ref).max(), 1e-300))


def _graphs(group, tmp, prior="soft"):
    """(JAX graph, JAX start, torch graph, torch start) of the small sphere
    (SE3, chordal start) or the Manhattan world (SE2, LAGO start); prior:
    "soft" (sigmas), "hard" (constrained in every row) or "none"."""
    if group == "SE3":
        path = os.path.join(tmp, "sphere.g2o")
        _script("port_sphere_data").write_sphere_g2o(
            path, laps=6, per_lap=8, radius=10.0, sigma_t=0.1, sigma_r=0.05,
            seed=1)
        jg, _ = jdatasets.load_3d(path)
        tg, _ = tdatasets.load_3d(path)
        jz = gt.SE3(np.eye(3)[None], np.zeros((1, 3)))
        tz = SE3(np.eye(3)[None], np.zeros((1, 3)))
    else:
        path = os.path.join(tmp, "manhattan.graph")
        _script("port_2d_data").write_manhattan_graph(path, 60, 150, seed=3)
        jg, jv = jdatasets.load_2d(path)
        tg, tv = tdatasets.load_2d(path)
        jz, tz = np.asarray(jv.at(0))[None], tv.at(0)[None].numpy()
    r = 6 if group == "SE3" else 3
    soft = (jnoise.sigmas(PRIOR[group]), tnoise.sigmas(PRIOR[group]))
    jn, tn = soft if prior != "hard" else (jnoise.constrained_all(r),
                                           tnoise.constrained_all(r))
    jg0, tg0 = JGraph(list(jg.batches)), FactorGraph(list(tg.batches))
    for g, z, n, add in ((jg, jz, jn, gt.prior_factors),
                         (tg, tz, tn, tfactors.prior_factors)):
        g.add(add(group, [0], z, n))
    # the start: chordal / LAGO of the soft-prior graph
    js, ts = JGraph(list(jg0.batches)), FactorGraph(list(tg0.batches))
    js.add(gt.prior_factors(group, [0], jz, soft[0]))
    ts.add(tfactors.prior_factors(group, [0], tz, soft[1]))
    if group == "SE3":
        jv, tv = jchordal(js), initialize_pose3_chordal(ts)
    else:
        jv, tv = jlago(js), initialize_pose2_lago(ts)
    if prior == "none":
        return jg0, jv, tg0, tv
    return jg, jv, tg, tv


def _mixed():
    """SE3 poses and Point3 landmarks joined by a pose-frame landmark
    factor (the generic linearization), SE3 between factors and a prior."""
    rng = np.random.default_rng(3)
    n_pose, n_pt = 6, 5
    T = se3.expmap(torch.as_tensor(rng.normal(size=(n_pose, 6))
                                   * np.array([0.3] * 3 + [2.0] * 3)))
    R, tr = T.R.numpy(), T.t.numpy()
    pts = rng.normal(size=(n_pt, 3)) * 3.0
    i = np.arange(n_pose - 1)
    Rij = np.einsum("nji,njk->nik", R[i], R[i + 1])
    tij = np.einsum("nji,nj->ni", R[i], tr[i + 1] - tr[i])
    op = np.arange(2 * n_pt) % n_pose
    ol = np.arange(2 * n_pt) // 2
    z = np.einsum("nji,nj->ni", R[op], pts[ol] - tr[op])
    z = z + rng.normal(size=z.shape) * 0.1
    T0 = se3.retract(T, torch.as_tensor(rng.normal(size=(n_pose, 6)) * 0.05))
    pts0 = pts + rng.normal(size=pts.shape) * 0.2
    info = np.diag([400.0] * 3 + [100.0] * 3)
    jg = JGraph()
    jg.add(jfactors.between_factors("SE3", i, i + 1, gt.SE3(
        jnp.asarray(Rij), jnp.asarray(tij)), jnoise.information(info)))
    jg.add(gt.prior_factors("SE3", [0], gt.SE3(np.eye(3)[None],
                                               np.zeros((1, 3))),
                            jnoise.sigmas(PRIOR["SE3"])))
    jg.add(jfactors.custom_factors(
        "Obs", ("SE3", "Point3"), np.stack([op, ol + 100], 1),
        lambda xs, m: jse3.transform_to(xs[0], xs[1]) - m, 3,
        jnp.asarray(z), jnoise.isotropic(3, 0.1)))
    jv = JValues({"SE3": gt.SE3(jnp.asarray(T0.R.numpy()),
                                jnp.asarray(T0.t.numpy())),
                  "Point3": jnp.asarray(pts0)},
                 {"SE3": np.arange(n_pose), "Point3": np.arange(n_pt) + 100})
    tg = FactorGraph()
    tg.add(tfactors.between_factors("SE3", i, i + 1, SE3(Rij, tij),
                                    tnoise.information(info)))
    tg.add(tfactors.prior_factors("SE3", [0], SE3(np.eye(3)[None],
                                                  np.zeros((1, 3))),
                                  tnoise.sigmas(PRIOR["SE3"])))
    tg.add(tfactors.FactorBatch(
        "Obs", ("SE3", "Point3"), np.stack([op, ol + 100], 1), 3,
        lambda xs, m: se3.transform_to(xs[0], xs[1]) - m,
        torch.as_tensor(z), tnoise.isotropic(3, 0.1)))
    tv = Values({"SE3": T0, "Point3": torch.as_tensor(pts0)},
                {"SE3": np.arange(n_pose), "Point3": np.arange(n_pt) + 100})
    return jg, jv, tg, tv


class Case:
    """One graph in both packages with the supernodal solvers of both."""

    def __init__(self, jg, jv, tg, tv, kw):
        self.jg, self.jv, self.tg, self.tv = jg, jv, tg, tv
        self.js = JSolver(jg.bind(jv), **kw)
        self.ts = SupernodalCholeskySolver(BoundGraph(tg, tv, "cpu"), **kw)

    def pool(self):
        return self.ts.jacobian_pool(self.tv.arrays)

    def jax_qr(self, lam):
        """The JAX package's factorize_qr and its solve of g at lam: one
        jitted program per graph (lam traced), cached."""
        if not hasattr(self, "_jqr"):
            js = self.js

            def run(arrays, lam):
                _, g = js.system(arrays)
                f = js.factorize_qr(arrays, lam)
                return f, js.solve_factored(f, g)
            self._jqr = jax.jit(run)
        return self._jqr(self.jv.arrays, lam)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("qr"))
    out = {}
    for group in ("SE3", "SE2"):
        for prior in ("soft", "none"):
            out[group, prior] = Case(*_graphs(group, tmp, prior), SN_KW)
    out["mixed", "soft"] = Case(*_mixed(), dict(force_width=2, max_width=4))
    return out


# -- the plan -------------------------------------------------------------------

@pytest.mark.parametrize("which", ["SE3", "SE2", "mixed"])
def test_qr_plan_against_the_jax_cell_maps(cases, which):
    """Each front's factor rows (their pool entries and block positions,
    in order), its children's R_sep entries (child, block row, block
    column) at their block positions, and its row count: the JAX package's
    _qr_plan cell maps (cellF, cellC) with its padding removed."""
    c = cases[which, "soft"]
    jp = c.js._qr_plan()
    ts = c.ts
    qp = ts._qr_plan()
    rb = jp["rbmax"]
    # JAX pool id -> (batch, factor, slot); the port's likewise
    jid = {}
    for bi, offs in enumerate(jp["bs_off"]):
        N = c.tg.batches[bi].num_factors
        for s, o in enumerate(offs):
            for i in range(N):
                jid[o + i] = (bi, i, s)
    tid = {}
    for bi, b in enumerate(c.tg.batches):
        for i in range(b.num_factors):
            for s in range(b.arity):
                tid[ts._pool_base[bi] + i * b.arity + s] = (bi, i, s)
    sn_of = {}
    for lp in ts.level_plans:
        for sid in lp.snodes:
            sn_of[len(sn_of)] = int(sid)
    d = ts.d
    for jl, ql, lp in zip(jp["levels"], qp.levels, ts.level_plans):
        sptr, spool, spos = (ql.sptr.numpy(), ql.spool.numpy(),
                             ql.spos.numpy())
        srow0, srows = ql.srow0.numpy(), ql.srows.numpy()
        cptr, cfront, cr = ql.cptr.numpy(), ql.cfront.numpy(), ql.cr.numpy()
        mptr, cmap = ql.mptr.numpy(), ql.cmap.numpy()
        for si in range(ql.S):
            jf = []
            for cells in jl["cellF"][si]:
                f = {int(p): jid[int(v)] for p, v in enumerate(cells)
                     if v != jp["tot"]}
                if f:
                    jf.append(f)
            tf, rows = [], 0
            for q in range(sptr[si], sptr[si + 1]):
                if not tf or srow0[q] != srow0[q - 1]:
                    tf.append({})
                    rows += srows[q]
                tf[-1][int(spos[q])] = tid[int(spool[q])]
            assert tf == jf
            jc = {(int(v) // (rb * rb), int(v) // rb % rb, int(v) % rb, p)
                  for row in jl["cellC"][si] for p, v in enumerate(row)
                  if v < jp["ncon"] - 2}
            tc = set()
            for q in range(cptr[si], cptr[si + 1]):
                pos = cmap[mptr[q]:mptr[q + 1]]
                for j in range(cr[q]):
                    for k in range(j, cr[q]):
                        tc.add((sn_of[int(cfront[q])], j, k, int(pos[k])))
                rows += cr[q] * d
            assert tc == jc
            assert ql.m[si] == rows + lp.W * d
            assert ql.m[si] <= (jl["gmax"] * jp["rmax"] + jl["hmax"] * d
                                + lp.W * d)


# -- kernel 6's Jacobian mode ----------------------------------------------------

def _jax_pool(c, jg, jv):
    """The JAX package's whitened Jacobian rows (factors.linearize) in the
    port's pool layout."""
    ts = c.ts
    pool = np.zeros((ts._n_pool, c.ts._qr_plan().rmax, ts.d))
    for bi, (wJ, _) in enumerate(jax.jit(jg.bind(jv).linearize)(
            jv.arrays)):
        b = c.tg.batches[bi]
        N = b.num_factors
        for s, J in enumerate(wJ):
            J = np.asarray(J)
            pool[ts._pool_base[bi] + np.arange(N) * b.arity + s,
                 :J.shape[1], :J.shape[2]] = J
    return pool


def _noise_variants(b, jb, group):
    """(label, JAX batch, torch batch) of a between batch under its own
    noise, Huber, and constrained noise (rows 0 and 2 hard)."""
    r = 6 if group == "SE3" else 3
    hard = np.full(r, 5.0)
    hard[[0, 2]] = 0.0
    return [("own", jb, b),
            ("huber", dataclasses.replace(jb, noise=jnoise.robust(
                jb.noise, jlosses.huber(0.5))),
             dataclasses.replace(b, noise=tnoise.robust(
                 b.noise, tlosses.huber(0.5)))),
            ("constrained", dataclasses.replace(
                jb, noise=jnoise.constrained(1.0 / np.where(hard, hard, 1)
                                             * (hard != 0))),
             dataclasses.replace(b, noise=tnoise.constrained(
                 1.0 / np.where(hard, hard, 1) * (hard != 0))))]


# The closed-form Jacobians (kernel 6's plain versions) against jacfwd
# through the closed-form SO(3) coefficients, which loses ~eps / theta^2 at
# the sphere's small residual angles (as test_torch_posegraph.py holds
# them): 1e-11 for SE3, 1e-12 for SE2 and the generic path.
POOL_TOL = {"SE3": 1e-11, "SE2": 1e-12, "mixed": 1e-12}


@pytest.mark.parametrize("which", ["SE3", "SE2", "mixed"])
def test_jacobian_pool_against_jax_linearize(cases, which):
    """jacobian_pool (kernel 6's Jacobian mode for the SE3 and SE2 between
    and prior batches, the generic linearization for the custom factor)
    against the JAX package's factors.linearize at POOL_TOL of the largest
    entry: each graph's own noise (information between factors, a sigmas
    prior, an isotropic custom factor), and its between batch under Huber
    and under constrained noise (hard rows zero, as whitening gives them);
    the CPU path launches nothing."""
    c = cases[which, "soft"]
    _kernels.reset_launch_counts()
    assert _rel(c.pool(), _jax_pool(c, c.jg, c.jv)) <= POOL_TOL[which]
    assert not any(_kernels.launch_counts().values())
    if which == "mixed":
        return
    for label, jb, tb in _noise_variants(c.tg.batches[0], c.jg.batches[0],
                                         which):
        jg = JGraph([jb] + list(c.jg.batches[1:]))
        tg = FactorGraph([tb] + list(c.tg.batches[1:]))
        t = Case(jg, c.jv, tg, c.tv, SN_KW)
        pool = t.pool()
        assert _rel(pool, _jax_pool(t, jg, c.jv)) <= POOL_TOL[which], label
        if label == "constrained":
            hard = pool[:c.tg.batches[0].num_factors * 2].reshape(
                -1, 2, pool.shape[1], pool.shape[2])[:, :, [0, 2]]
            assert bool((hard == 0).all())


# -- the factorization and the solve ----------------------------------------------

def _frontal_rows(L, P):
    """Each front's R rows over its columns, [L^T | P^T] (S, Wd, C)."""
    Lt = np.swapaxes(np.asarray(L), 1, 2)
    if P is None:
        return Lt
    return np.concatenate([Lt, np.swapaxes(np.asarray(P), 1, 2)], axis=2)


@pytest.mark.parametrize("which", ["SE3", "SE2", "mixed"])
@pytest.mark.parametrize("lam", [0.0, 1e-4])
def test_level_qr_against_jax(cases, which, lam):
    """factorize_qr (sn_front_qr_plain a level) of the JAX package's
    Jacobian rows against the JAX package's factorize_qr, level by level:
    R^T R of each front's frontal rows [L^T | Lp^T] and |diag R| at 1e-12
    of the level's largest entry (the same QR up to the rows' signs; the
    port's gather holds the true rows, the JAX package's its padded ones,
    zero rows that add nothing); the port's R diagonal non-negative and
    its L lower triangular; ok and badcol."""
    c = cases[which, "soft"]
    # the JAX package's Jacobian rows (jacfwd), so both factor one input
    f = c.ts.factorize_qr(torch.as_tensor(_jax_pool(c, c.jg, c.jv)), lam)
    (_, jL, jP, jok, jbad), _ = c.jax_qr(lam)
    assert bool(f.ok) and bool(jok) and int(f.badcol) == int(jbad) == -1
    for L, P, jl, jp in zip(f.levels.Ls, f.levels.Ps, jL, jP):
        L = L.numpy()
        assert np.all(np.diagonal(L, axis1=1, axis2=2) >= 0)
        assert np.all(np.triu(L, 1) == 0)
        R = _frontal_rows(L, None if P is None else P.numpy())
        jR = _frontal_rows(jl, jp)
        G = np.einsum("sij,sik->sjk", R, R)
        jG = np.einsum("sij,sik->sjk", jR, jR)
        assert _rel(G, jG) <= 1e-12
        assert _rel(np.diagonal(L, axis1=1, axis2=2),
                    np.abs(np.diagonal(np.asarray(jl), axis1=1,
                                       axis2=2))) <= 1e-12


@pytest.mark.parametrize("which", ["SE3", "SE2", "mixed"])
@pytest.mark.parametrize("lam", [0.0, 1e-4])
def test_solve_qr_against_jax(cases, which, lam):
    """solve_qr (factorize_qr, kernel 8's plain solves, no refinement)
    against the JAX package's solve_qr at 1e-10 of the step's largest
    entry; with one refinement pass against kernel 9's Gram matvec, the
    step against the dense (H + lam I)^-1 g at 1e-10."""
    c = cases[which, "soft"]
    blocks, g = c.ts.system(c.tv.arrays)
    pool = c.pool()
    dx, ok = c.ts.solve_qr(blocks, g, pool, lam)
    _, jdx = c.jax_qr(lam)
    assert bool(ok)
    assert _rel(dx, jdx) <= 1e-10
    dx1, _ = c.ts.solve_qr(blocks, g, pool, lam, refine_iters=1)
    bound = BoundGraph(c.tg, c.tv, "cpu")
    H, gd = bound.gn_system(c.tv.arrays)
    ref = torch.linalg.solve(H + lam * torch.eye(H.shape[0],
                                                 dtype=torch.float64), gd)
    assert _rel(dx1, ref) <= 1e-10


@pytest.mark.parametrize("group", ["SE3", "SE2"])
def test_rank_deficient_badcol(cases, group):
    """Without its prior the graph's gauge is free: at lam = 0 the QR's
    last pivots vanish.  factorize_qr's ok is false and its badcol the JAX
    package's (the first bad pivot of the first failing level), as the
    pivot check of kernel 7 reads kernel 12's records."""
    c = cases[group, "none"]
    f = c.ts.factorize_qr(c.pool(), 0.0)
    jf, _ = c.jax_qr(0.0)
    assert not bool(f.ok) and not bool(jf[3])
    assert int(f.badcol) == int(jf[4]) >= 0


def test_front_qr_plain_sign_rule_and_records(cases):
    """sn_front_qr_plain on the sphere's first level: R's diagonal is
    non-negative (each row with a negative diagonal negated), the tile
    inverses are those of L = Lt^T, and R_sep goes into the buffer upper
    triangular at each front's offset."""
    c = cases["SE3", "soft"]
    ts = c.ts
    qp = ts._qr_plan()
    lv, ql = ts.dev.levels[0], qp.levels[0]
    rec = torch.empty(ql.S, dtype=torch.int32)
    tiles = torch.empty((lv.tiles.stop - lv.tiles.start, K.TILE, K.TILE),
                        dtype=torch.float64)
    rsep = torch.full_like(qp.rsep, float("nan"))
    Lt, Pt = K.sn_front_qr(c.pool(), ql, lv.valid_diag, lv.col_vars,
                           qp.roff, qp.rld, rsep, 1.0, rec, tiles)
    assert bool((torch.diagonal(Lt, dim1=1, dim2=2) > 0).all())
    assert bool((rec == -1).all())
    assert torch.allclose(tiles, K.tile_inverses([Lt.mT]), rtol=0,
                          atol=0)
    Rd = ql.R * ts.d
    for s in range(ql.S):
        o = int(qp.roff[s])
        R = rsep[o:o + Rd * Rd].view(Rd, Rd)
        assert bool(torch.isfinite(R).all())
        assert bool((torch.tril(R, -1) == 0).all())


# -- kernel 12's blocked algorithm, modelled on the CPU ----------------------------

def _blocked_qr(front, nb=K.QR_PANEL):
    """R of `front` (m x C) as kernel 12 computes it, in torch: panels of
    nb columns, each factored column by column (dlarfg's beta, tau and v,
    its columns up to the tile's edge updated), R's row k negated where
    beta < 0; T by dlarft's recurrence from G = V^T V; the later columns
    updated as A -= V (T^T (V^T A)), the panel's rows of them then
    flipped.  Returns R (min(m, C) x C, upper trapezoidal)."""
    A = front.clone()
    m, C = A.shape
    kmax = min(m, C)
    for k0 in range(0, kmax, nb):
        tw, wp = min(nb, C - k0), min(nb, kmax - k0)
        P = A[k0:, k0:k0 + tw]
        V = torch.zeros((m - k0, nb), dtype=A.dtype)
        tau = torch.zeros(nb, dtype=A.dtype)
        flip = torch.ones(nb, dtype=A.dtype)
        for k in range(wp):
            x0, sg = float(P[k, k]), float((P[k + 1:, k] ** 2).sum())
            beta, t, scale = x0, 0.0, 0.0
            if sg != 0.0:
                beta = -np.copysign(np.hypot(x0, np.sqrt(sg)), x0)
                t, scale = (beta - x0) / beta, 1.0 / (x0 - beta)
            v = P[k:, k].clone()
            v[0], v[1:] = 1.0, v[1:] * scale
            V[k:, k], tau[k] = v, t
            P[k, k], P[k + 1:, k] = abs(beta), 0.0
            P[k:, k + 1:] -= t * torch.outer(v, v @ P[k:, k + 1:])
            if beta < 0:
                P[k, k + 1:] *= -1.0
                flip[k] = -1.0
        G = V.T @ V
        T = torch.zeros((nb, nb), dtype=A.dtype)
        for i in range(nb):
            T[:i, i] = -tau[i] * (T[:i, :i] @ G[:i, i])
            T[i, i] = tau[i]
        A2 = A[k0:, k0 + tw:]
        A2 -= V @ (T.T @ (V.T @ A2))
        A2[:nb] *= flip[:min(nb, m - k0), None]
    return torch.triu(A[:kmax])


def _level_fronts(c, lam, zero_col=False):
    """Each level's true-row fronts (the plain gather's) beside
    sn_front_qr_plain's (Lt, Pt, R_sep of each front), level after level
    on one R_sep buffer.  zero_col: the pool entries of the first level's
    first separator column zeroed (a leaf level: no child rows), so that
    its fronts hold a zero column (tau = 0)."""
    ts, pool = c.ts, c.pool()
    qp = ts._qr_plan()
    rsep = torch.zeros_like(qp.rsep)
    out = []
    for n, (lv, ql) in enumerate(zip(ts.dev.levels, qp.levels)):
        Wd, Rd = ql.W * ts.d, ql.R * ts.d
        if zero_col and n == 0:
            assert ql.R and not ql.cr.numel()
            pool = pool.clone()
            q = torch.nonzero(ql.spos == ql.W).flatten()
            pool[ql.spool[q].long(), :, 0] = 0.0
        front = K._qr_fronts(pool, ql, lv.valid_diag, qp.roff, qp.rld,
                             rsep, lam)
        rec = torch.empty(ql.S, dtype=torch.int32)
        tiles = torch.empty((lv.tiles.stop - lv.tiles.start, K.TILE,
                             K.TILE), dtype=torch.float64)
        Lt, Pt = K.sn_front_qr_plain(pool, ql, lv.valid_diag, lv.col_vars,
                                     qp.roff, qp.rld, rsep, lam, rec, tiles)
        ro = qp.roff[ql.front0:ql.front0 + ql.S].tolist()
        for s in range(ql.S):
            rs = rsep[ro[s]:ro[s] + Rd * Rd].view(Rd, Rd) if ql.R else None
            out.append((front[s, :int(ql.m[s])], Wd, Lt[s],
                        None if Pt is None else Pt[s], rs))
        if zero_col:
            break
    return out


def _hold_blocked(fronts, tol):
    for front, Wd, Lt, Pt, rs in fronts:
        R = _blocked_qr(front)
        k = R.shape[0]
        got = torch.zeros((Wd, front.shape[1]), dtype=torch.float64)
        got[:min(k, Wd)] = R[:Wd]
        ref = Lt if Pt is None else torch.cat([Lt, Pt], dim=1)
        assert _rel(got, ref) <= tol
        if rs is not None:
            sep = torch.zeros_like(rs)
            sep[:max(k - Wd, 0)] = R[Wd:, Wd:]
            assert _rel(sep.T @ sep, rs.T @ rs) <= tol


@pytest.mark.parametrize("which", ["SE3", "SE2"])
@pytest.mark.parametrize("lam", [0.0, 1.0])
def test_blocked_householder_model(cases, which, lam):
    """Kernel 12's algorithm (_blocked_qr: 32-column panels, T by dlarft's
    recurrence, the V T^T V^T trailing update, the sign rule after each
    panel) on every front of the small sphere (d = 6) and the 60-pose
    Manhattan world (d = 3: odd W d and R d) against sn_front_qr_plain:
    R's frontal block and panel at 1e-12 of the largest entry (R is unique
    once its diagonal is non-negative; two backward-stable QRs of these
    fronts differ by rounding), R_sep by its Gram R_sep^T R_sep (R_sep is
    unique only up to its rows past the separator block's rank)."""
    _hold_blocked(_level_fronts(cases[which, "soft"], lam), 1e-12)


@pytest.mark.parametrize("lam", [0.0, 1.0])
def test_blocked_householder_model_zero_column(cases, lam):
    """The same on the Manhattan world's first level with its first
    separator column zeroed in every front (sigma = 0 and x0 = 0: tau = 0,
    T's row and column zero), and on a wide front of fewer rows than
    columns (m < C: min(m, C) reflectors, the last panel short)."""
    fronts = _level_fronts(cases["SE2", "soft"], lam, zero_col=True)
    assert all(float(f[:, Wd].abs().max()) == 0.0
               for f, Wd, *_ in fronts)
    _hold_blocked(fronts, 1e-12)
    rng = np.random.default_rng(17)
    wide = torch.as_tensor(rng.standard_normal((70, 99)))
    wide[:, 40] = 0.0
    R = _blocked_qr(wide)
    ref = torch.linalg.qr(wide, mode="r").R
    ref = ref * torch.where(ref.diagonal() < 0, -1.0, 1.0)[:, None]
    assert R.shape == ref.shape and _rel(R, ref) <= 1e-12


def test_kernel12_layout(cases):
    """What the wrapper and the plan tell kernel 12: QR_PANEL is
    csrc/sn_qr.cu's panel width kNb (it sizes the scratch's panel blocks
    and the CTAs' shares); each front's scratch offset steps by its rows
    rounded up to 16 times its columns; the scratch holds every level's
    fronts and panel blocks; qr_ctas gives a level its share of the SMs,
    at most a front's column tiles, at least one CTA a front."""
    with open(os.path.join(REPO, "gtsam_torch", "csrc", "sn_qr.cu")) as f:
        assert f"constexpr int kNb = {K.QR_PANEL};" in f.read()
    ts = cases["SE3", "soft"].ts
    qp = ts._qr_plan()
    for ql in qp.levels:
        C = (ql.W + ql.R) * ql.d
        step = K.qr_ld(ql.m.long()) * C
        assert torch.equal(ql.foff, torch.cumsum(step, 0) - step)
        assert ql.fsize == int(step.sum())
    need = max(K.qr_scratch_doubles(ql) for ql in qp.levels)
    assert need > max(ql.fsize for ql in qp.levels)
    assert K.qr_ctas(1, 660, 132) == -(-660 // K.QR_PANEL)
    assert K.qr_ctas(58, 348, 132) == 2
    assert K.qr_ctas(200, 348, 132) == 1


# -- the optimizers on the sparse QR -------------------------------------------------

QR_LM = dict(max_iterations=10, relative_error_tol=1e-9,
             absolute_error_tol=1e-12, lambda_policy="gtsam")


@pytest.mark.parametrize("which", ["SE3", "SE2", "mixed"])
def test_fused_lm_on_the_sparse_qr(cases, which):
    """make_fused_lm with SparseSolver(method="qr", refine_iters=1) against
    the JAX package's: the same iterations and tries, the history at 1e-10
    relative; no kernel launched on the CPU."""
    c = cases[which, "soft"]
    kw = dict(method="qr", refine_iters=1, supernodal_kwargs=SN_KW
              if which != "mixed" else dict(force_width=2, max_width=4))
    jfn = JO.make_fused_lm(c.jg, c.jv, JO.LMParams(**QR_LM),
                           solver=JO.SparseSolver(**kw))
    jit, _, jerr, _, jhist, jtries = jfn(c.jv.arrays)
    _kernels.reset_launch_counts()
    tfn = TO.make_fused_lm(c.tg, c.tv, TO.LMParams(**QR_LM),
                           solver=TO.SparseSolver(**kw), device="cpu")
    it, _, err, _, hist, tries = tfn(c.tv.arrays)
    assert (it, tries) == (int(jit), int(jtries))
    assert _rel(hist[:it + 1], np.asarray(jhist)[:it + 1]) <= 1e-10
    assert not any(_kernels.launch_counts().values())
    with pytest.raises(NotImplementedError):
        tfn.solver.predicted_decrease(None, None, 0.0, False)


@pytest.mark.parametrize("group", ["SE2"])
def test_constrained_sparse_qr(tmp_path, group):
    """A hard prior on the sparse QR (the QR of the weighted rows, three
    augmented-Lagrangian passes over it) under fused LM against the JAX
    package's: the same iterations, the history at 1e-9 relative, the
    prior exact at the end to 1e-9."""
    jg, jv, tg, tv = _graphs(group, str(tmp_path), "hard")
    kw = dict(method="qr", supernodal_kwargs=SN_KW)
    jfn = JO.make_fused_lm(jg, jv, JO.LMParams(**QR_LM),
                           solver=JO.SparseSolver(**kw))
    jit, _, _, _, jhist, _ = jfn(jv.arrays)
    tfn = TO.make_fused_lm(tg, tv, TO.LMParams(**QR_LM),
                           solver=TO.SparseSolver(**kw), device="cpu")
    it, arrays, _, _, hist, _ = tfn(tv.arrays)
    assert it == int(jit)
    assert _rel(hist[:it + 1], np.asarray(jhist)[:it + 1]) <= 1e-9
    _, cvec = tfn.bound.constraint_system(arrays)
    assert float(cvec.abs().max()) <= 1e-9
