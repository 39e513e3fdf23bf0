"""Parity of gtsam_torch's level-scheduled sparse Cholesky and the small
linear modules beside it with gtsam_tpu's (CPU).

The symbolic analysis (native and Python paths), SparseCholeskySolver
(system, each level's factor, the dense root's factor, the solve) and
SparseSolver(method="levels") under levenberg_marquardt, held to the JAX
package on the same seeded graphs; the Kalman filters, the sparse export
and the union-find.  The JAX side runs float64 (tests/conftest.py turns x64
on) and eagerly where the JAX package allows; the torch side float64 on
the CPU, where every kernel wrapper computes its plain PyTorch version.
Graphs: a 6-ring x 8-pose sphere (SE3, chordal start), a 60-pose Manhattan
world (SE2, LAGO start), an SE2 + Point2 graph with loop closures and
landmarks (the 3-wide store pads the landmarks' 2 dimensions) and an SE3 +
Point3 graph (6-wide, Point3 padded by 3).  Tolerances, each stated where
it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_tpu.base import noise as jnoise
from gtsam_tpu.geometry import se2 as jse2
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.inference import ordering as jordering
from gtsam_tpu.inference import symbolic as jsymbolic
from gtsam_tpu.linear import kalman as jkalman
from gtsam_tpu.linear import sparse_export as jexport
from gtsam_tpu.linear.sparse import SparseCholeskySolver as JSparse
from gtsam_tpu.optimize import optimizers as JO

from gtsam_torch import _kernels
from gtsam_torch.base import dsf
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se2
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.inference import symbolic as tsymbolic
from gtsam_torch.linear import kalman as tkalman
from gtsam_torch.linear import sparse_export as texport
from gtsam_torch.linear import sparse_kernels as K
from gtsam_torch.linear.sparse import SparseCholeskySolver
from gtsam_torch.optimize import optimizers as TO
from .test_torch_optimizers import _graphs, _mixed, _rel

GRAPHS = ["SE3", "SE2", "SE2_Point2", "SE3_Point3"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _se2_point2(seed=7, n=24, nl=5):
    """(JAX graph, JAX values, torch graph, torch values): an SE2 chain
    with a prior and six loop closures, and nl Point2 landmarks each seen
    from three poses (a pose-frame position, sigma 0.1)."""
    rng = np.random.default_rng(seed)
    T = np.concatenate([np.arange(n)[:, None] * np.array([[1.0, 0.0]])
                        + rng.normal(size=(n, 2)) * 0.1,
                        rng.normal(size=(n, 1)) * 0.1], 1)
    i = np.concatenate([np.arange(n - 1), rng.integers(0, n - 8, 6)])
    j = np.concatenate([np.arange(1, n), i[n - 1:] + rng.integers(4, 8, 6)])
    Z = np.asarray(jse2.between(jnp.asarray(T[i]), jnp.asarray(T[j])))
    Z = Z + rng.normal(size=Z.shape) * 0.02
    pts = rng.normal(size=(nl, 2)) * 3.0 + np.array([n / 2, 2.0])
    op = rng.integers(0, n, 3 * nl)
    ol = np.repeat(np.arange(nl), 3)
    z = np.asarray(jse2.transform_to(jnp.asarray(T[op]),
                                     jnp.asarray(pts[ol])))
    z = z + rng.normal(size=z.shape) * 0.1
    T0 = T + rng.normal(size=T.shape) * 0.05
    pts0 = pts + rng.normal(size=pts.shape) * 0.3
    keys = np.stack([op, ol + 100], 1)
    info = np.diag([100.0, 100.0, 400.0])
    prior = [[0.1, 0.1, 0.05]]
    jg, tg = JGraph(), FactorGraph()
    jg.add(jfactors.between_factors("SE2", i, j, jnp.asarray(Z),
                                    jnoise.information(info)))
    jg.add(gt.prior_factors("SE2", [0], T0[:1], jnoise.sigmas(prior)))
    jg.add(jfactors.custom_factors(
        "Obs", ("SE2", "Point2"), keys,
        lambda xs, m: jse2.transform_to(xs[0], xs[1]) - m, 2,
        jnp.asarray(z), jnoise.isotropic(2, 0.1)))
    tg.add(tfactors.between_factors("SE2", i, j, Z,
                                    tnoise.information(info)))
    tg.add(tfactors.prior_factors("SE2", [0], T0[:1], tnoise.sigmas(prior)))
    tg.add(tfactors.custom_factors(
        "Obs", ("SE2", "Point2"), keys,
        lambda xs, m: se2.transform_to(xs[0], xs[1]) - m, 2, z,
        tnoise.isotropic(2, 0.1)))
    keys_pt = np.arange(nl) + 100
    jv = JValues({"SE2": jnp.asarray(T0), "Point2": jnp.asarray(pts0)},
                 {"SE2": np.arange(n), "Point2": keys_pt})
    tv = Values({"SE2": torch.as_tensor(T0), "Point2": torch.as_tensor(pts0)},
                {"SE2": np.arange(n), "Point2": keys_pt})
    return jg, jv, tg, tv


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """{name: (JAX graph, JAX start, torch graph, torch start)}."""
    tmp = str(tmp_path_factory.mktemp("sparse"))
    return {"SE3": _graphs("SE3", tmp), "SE2": _graphs("SE2", tmp),
            "SE2_Point2": _se2_point2(), "SE3_Point3": _mixed()}


def _bound(graphs, name):
    jg, jv, tg, tv = graphs[name]
    return jg.bind(jv), jv, BoundGraph(tg, tv, "cpu"), tv


# -- the symbolic analysis ---------------------------------------------------

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", GRAPHS)
def test_symbolic_matches(graphs, name, native):
    """The port's analyze, native and Python, gives the JAX package's
    blocks, elimination tree, levels and update triples exactly (the same
    adjacency and nested-dissection order)."""
    jb, _, tb, _ = _bound(graphs, name)
    s = SparseCholeskySolver(tb)
    adj = jordering.adjacency_from_factors(s.batch_var_ids, s.nvars)
    ref = jsymbolic.analyze(adj, s.sym.perm)
    got = tsymbolic.analyze(adj, s.sym.perm, native=native)
    assert got.n == ref.n and got.nnz_blocks == ref.nnz_blocks
    for f in ("perm", "inv_perm", "parent", "block_row", "block_col",
              "col_level", "diag_block_by_col"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert got.block_of == ref.block_of
    assert len(got.levels) == len(ref.levels)
    assert all(np.array_equal(a, b) for a, b in zip(got.levels, ref.levels))
    for tl, rl in zip(got.triples_by_level, ref.triples_by_level):
        assert all(np.array_equal(a, b) for a, b in zip(tl, rl))
    # and the JAX solver's own plan: the same order
    assert np.array_equal(got.perm, JSparse(jb).sym.perm)


# -- SparseCholeskySolver ----------------------------------------------------

# min_level_cols: the default split, a plan with no dense root (every level
# batched) and one that is all dense root
PLANS = {"default": 8, "no_tail": 1, "all_tail": 10 ** 6}


@pytest.mark.parametrize("name", GRAPHS)
def test_system(graphs, name):
    """system(): the block store and the padded g of the JAX package's
    system.  The store at 1e-12 (the same products summed in another order;
    padding's identity); g at 1e-10 on the SE3 and SE2 batches, whose
    kernel-6 plain versions form the residual in closed form where the JAX
    package differentiates through jacfwd (~1e-12 of a residual that is
    a difference of positions, PG_TOL of chip_smoke.py), 1e-12 elsewhere."""
    jb, jv, tb, tv = _bound(graphs, name)
    s, js = SparseCholeskySolver(tb), JSparse(jb)
    blocks, g = s.system(tv.arrays)
    jblocks, jg = jax.jit(js.system)(jv.arrays)
    assert blocks.shape == (s.B, s.d * s.d) and g.shape == (s.nvars, s.d)
    assert _rel(blocks.reshape(-1, s.d, s.d), jblocks) <= 1e-12
    assert _rel(g, jg) <= (1e-10 if name in ("SE3", "SE2") else 1e-12)
    # the store is zero outside H's own blocks
    outside = np.setdiff1d(np.arange(s.B), s.asm_blk)
    assert bool((blocks[outside] == 0).all())


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("name", ["SE3", "SE2_Point2", "SE3_Point3"])
def test_factorize_and_solve(graphs, name, plan):
    """factorize(): every leading level's L blocks and the dense root's
    factor, and solve_factored(), against the JAX package's (jitted) on the
    same store at lam 0, 1e-3 and 1, at 1e-10 (the same Cholesky and
    substitutions, the triple sums in another order, which the blocks'
    conditioning amplifies); the default plan (with a dense root), one
    with no dense root and one that is all dense root."""
    jb, jv, tb, tv = _bound(graphs, name)
    mlc = PLANS[plan]
    s, js = SparseCholeskySolver(tb, min_level_cols=mlc), \
        JSparse(jb, min_level_cols=mlc)
    assert (s.L_cut, s.n_tail) == (js.L_cut, js.n_tail)
    assert s.n_tail == 0 if plan == "no_tail" else s.n_tail > 0
    assert s.L_cut == 0 if plan == "all_tail" else True
    blocks, g = s.system(tv.arrays)
    jfac = jax.jit(js.factorize)
    jsolve = jax.jit(js.solve_factored)
    for lam in (0.0, 1e-3, 1.0):
        f = s.factorize(blocks, lam)
        jL, jT = jfac(jnp.asarray(blocks.numpy().reshape(-1, s.d, s.d)),
                      lam)
        assert bool(f.ok)
        lead = s.f_cblk
        if len(lead):
            assert _rel(f.L.reshape(-1, s.d, s.d)[lead],
                        np.asarray(jL)[lead]) <= 1e-10, lam
        if s.n_tail:
            assert _rel(torch.tril(f.tail[0]), jT) <= 1e-10, lam
        else:
            assert jT is None and f.tail is None
        x = s.solve_factored(f, g)
        jx = jsolve((jL, jT), jnp.asarray(g.numpy()))
        assert _rel(x, jx) <= 1e-10, lam
    # the solve reads g through its map: the canonical flat vector gives the
    # same delta
    keep = s.map_canon >= 0
    flat = torch.zeros(s.layout.total_dim, dtype=torch.float64)
    flat[s.map_canon[keep]] = g.reshape(-1)[torch.as_tensor(keep)]
    x2 = s.solve_factored(f, flat, torch.as_tensor(s.map_canon))
    assert torch.equal(x, x2)


def check_job_order(s):
    """Kernel 14's precondition on the plan of solver s, both directions:
    the level pointers partition the jobs (the forward's substituting jobs
    whole levels before the root's rhs), every leading column is written
    by one job, and every source row a job reads comes from a job of an
    earlier level, so earlier in the direction's order (backward: or is a
    dense-root row, which kernel 11 writes before the launch)."""
    n, T = s.nvars, s.n_tail
    for key, src_key in (("fw", "fsrc"), ("bw", "bsrc")):
        a = {k: v.numpy() for k, v in getattr(s.dev, key).items()}
        J = len(a["cols"])
        lptr = a["lptr"]
        assert lptr[0] == 0 and lptr[-1] == J
        assert (np.diff(lptr) > 0).all()
        level = np.repeat(np.arange(len(lptr) - 1), np.diff(lptr))
        writes = a["dbid"] >= 0 if key == "bw" else \
            np.arange(J) < s._fw_ndiag
        if key == "fw":
            assert s._fw_ndiag in lptr
            assert J - s._fw_ndiag == T
        else:
            assert (~writes).sum() == T
        rows = a["rows"][writes]
        assert sorted(rows) == sorted(set(range(n)) - set(s.tail_cols))
        job_of = np.full(n + T, -1)
        job_of[rows] = np.flatnonzero(writes)
        ptr, src = a["ptr"], a[src_key]
        assert ptr[0] == 0 and ptr[-1] == len(src)
        owner = np.repeat(np.arange(J), np.diff(ptr))
        lead = src < n
        assert (src[~lead] >= n).all() and (src[~lead] < n + T).all()
        assert key == "bw" or lead.all()
        prod = job_of[src[lead]]
        assert (prod >= 0).all()
        assert (level[prod] < level[owner[lead]]).all()


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("name", GRAPHS)
def test_kernel14_job_order(graphs, name, plan):
    """check_job_order on each graph's plans (default, no dense root, all
    dense root)."""
    _, _, tb, _ = _bound(graphs, name)
    check_job_order(SparseCholeskySolver(tb, min_level_cols=PLANS[plan]))


def _level_forward(L, rhs, Y, cols, orow, dbid, fptr, fbid, fsrc, out,
                   diag):
    """One level of the forward substitution as its own call (the rhs the
    padded g): each job's rhs less the sum of its blocks' L y_k, then
    (diag) y = L_jj^-1 acc, written to out."""
    from gtsam_torch.linear import sparse_kernels as K
    d = Y.shape[1]
    J = cols.shape[0]
    f0, f1 = int(fptr[0]), int(fptr[J])
    Lv = L.view(-1, d, d)
    contrib = torch.einsum("bij,bj->bi", Lv[fbid[f0:f1].long()],
                           Y[fsrc[f0:f1].long()])
    owner = torch.repeat_interleave(torch.arange(J),
                                    (fptr[1:] - fptr[:-1]).long())
    acc = rhs.view(-1, d)[cols.long()] - torch.zeros(
        (J, d), dtype=torch.float64).index_add_(0, owner, contrib)
    if diag:
        acc = K._forward_rows(acc, Lv[dbid.long()])
    out[orow.long()] = acc


def _level_backward(L, Y, U, out_map, cols, xrow, dbid, bptr, bbid, bsrc,
                    delta):
    """One level of the backward substitution as its own call: x_j =
    L_jj^-T (y_j less the sum of L_b^T x_i) where dbid >= 0, into U; every
    job's x to delta through out_map."""
    from gtsam_torch.linear import sparse_kernels as K
    d = Y.shape[1]
    J = cols.shape[0]
    b0, b1 = int(bptr[0]), int(bptr[J])
    Lv = L.view(-1, d, d)
    real = dbid >= 0
    contrib = torch.einsum("bij,bi->bj", Lv[bbid[b0:b1].long()],
                           U[bsrc[b0:b1].long()])
    owner = torch.repeat_interleave(torch.arange(J),
                                    (bptr[1:] - bptr[:-1]).long())
    acc = Y[cols.long()] - torch.zeros(
        (J, d), dtype=torch.float64).index_add_(0, owner, contrib)
    U[xrow[real].long()] = K._backward_rows(acc[real],
                                            Lv[dbid[real].long()])
    idx = out_map.view(-1, d)[cols.long()].long()
    keep = idx >= 0
    delta[idx[keep]] = U[xrow.long()][keep]


def _per_level_solve(s, f, g):
    """The solve a level at a time, a call a level (forward: the root's
    rhs last; backward: the levels in reverse, the root's x copied with
    the first): the delta."""
    from gtsam_torch.linear import dense_kernels
    d, n, T = s.d, s.nvars, s.n_tail
    Y = torch.zeros((n, d), dtype=torch.float64)
    U = torch.zeros((n + T, d), dtype=torch.float64)
    rt = torch.zeros((T, d), dtype=torch.float64)
    delta = torch.zeros(s.layout.total_dim, dtype=torch.float64)
    fw, bw = s.dev.fw, s.dev.bw
    lp = fw["lptr"].tolist()
    for j0, j1 in zip(lp[:-1], lp[1:]):
        diag = j1 <= s._fw_ndiag
        _level_forward(f.L, g.reshape(-1), Y, fw["cols"][j0:j1],
                       fw["rows"][j0:j1], fw["dbid"][j0:j1],
                       fw["ptr"][j0:j1 + 1], fw["fbid"], fw["fsrc"],
                       Y if diag else rt, diag)
    if T:
        Lt, Dinv, _ = f.tail
        yt = dense_kernels.solve_forward(Lt, Dinv, rt.reshape(-1),
                                         torch.empty(T * d,
                                                     dtype=torch.float64))
        dense_kernels.solve_backward(Lt, Dinv, yt, U[n:].view(-1))
    lp = bw["lptr"].tolist()
    for j0, j1 in zip(lp[:-1], lp[1:]):
        _level_backward(f.L, Y, U, s.dev.map_canon, bw["cols"][j0:j1],
                        bw["rows"][j0:j1], bw["dbid"][j0:j1],
                        bw["ptr"][j0:j1 + 1], bw["bbid"], bw["bsrc"],
                        delta)
    return delta


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("name", ["SE3", "SE2_Point2"])
def test_kernel14_one_call_matches_levels(graphs, name, plan):
    """solve_factored's one call a direction (kernel 14's plain version over
    every level) gives the bits of the solve a level at a time, job by job
    (_per_level_solve), and the JAX package's solve_factored at 1e-10
    (test_factorize_and_solve's tolerance), at lam 1e-3; every solve has
    a new epoch."""
    jb, _, tb, tv = _bound(graphs, name)
    mlc = PLANS[plan]
    s, js = SparseCholeskySolver(tb, min_level_cols=mlc), \
        JSparse(jb, min_level_cols=mlc)
    blocks, g = s.system(tv.arrays)
    f = s.factorize(blocks, 1e-3)
    x = s.solve_factored(f, g)
    assert torch.equal(x, _per_level_solve(s, f, g))
    jL, jT = jax.jit(js.factorize)(
        jnp.asarray(blocks.numpy().reshape(-1, s.d, s.d)), 1e-3)
    jx = jax.jit(js.solve_factored)((jL, jT), jnp.asarray(g.numpy()))
    assert _rel(x, jx) <= 1e-10
    e = s._epoch
    assert torch.equal(s.solve_factored(f, g), x) and s._epoch == e + 1


@pytest.mark.parametrize("plan", list(PLANS))
def test_kernel14_launches_per_solve(graphs, plan):
    """launches_per_solve: kernel 14 once a direction, whatever the levels
    (the root's rhs and its copy in the same launches), kernel 11 once a
    direction with a dense root; the CPU solve launches nothing."""
    _, _, tb, tv = _bound(graphs, "SE3_Point3")
    s = SparseCholeskySolver(tb, min_level_cols=PLANS[plan])
    T = s.n_tail
    assert s.launches_per_solve() == {
        "sp_level_forward": 1, "sp_level_backward": 1,
        "dense_forward": int(T > 0), "dense_backward": int(T > 0)}
    blocks, g = s.system(tv.arrays)
    _kernels.reset_launch_counts()
    s.solve_factored(s.factorize(blocks, 0.1), g)
    assert all(v == 0 for v in _kernels.launch_counts().values())


def check_factor_jobs(s):
    """Kernel 13's precondition on the plan of solver s: the jobs are the
    leading columns in level order (f_lptr the levels' first jobs), and
    each job waits on exactly the columns its triples read, every one a
    leading column of an earlier level, so an earlier job."""
    sym = s.sym
    J = len(s.f_cols)
    lptr = s.f_lptr
    assert lptr[0] == 0 and lptr[-1] == J and (np.diff(lptr) > 0).all()
    level = np.repeat(np.arange(len(lptr) - 1), np.diff(lptr))
    job_of = np.full(s.nvars, -1)
    job_of[s.f_cols] = np.arange(J)
    assert (sym.col_level[s.f_cols] == level).all()
    assert s.f_wptr[0] == 0 and s.f_wptr[-1] == len(s.f_wsrc)
    for q in range(J):
        t0, t1 = s.f_tptr[s.f_cptr[q]], s.f_tptr[s.f_cptr[q + 1]]
        want = np.unique(sym.block_col[np.concatenate(
            [s.f_tik[t0:t1], s.f_tjk[t0:t1]])])
        got = s.f_wsrc[s.f_wptr[q]:s.f_wptr[q + 1]]
        assert np.array_equal(got, want)
        assert (job_of[got] >= 0).all()
        assert (level[job_of[got]] < level[q]).all()


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("name", GRAPHS)
def test_kernel13_job_order(graphs, name, plan):
    """check_factor_jobs on each graph's plans (default, no dense root, all
    dense root)."""
    _, _, tb, _ = _bound(graphs, name)
    check_factor_jobs(SparseCholeskySolver(tb, min_level_cols=PLANS[plan]))


def _round_sums(s, q, cap):
    """A sequential model of the walk that kernel 13's loops make over job
    q's triples with room for `cap` triples a round (csrc/sp_level.cu: the
    round [ta, ta + nt), the blocks [eb, ee) it touches, each block's
    triples in it, a block's partial sum carried into the next round where
    its triples go on past the round): {block: the triples added to its
    sum in order}, for the blocks whose sums are written to L (the ones
    with triples).  It runs no kernel and has no concurrency: it checks the
    arithmetic of the plan's rounds, not the kernel's barriers."""
    tptr = s.f_tptr
    e0, e1 = s.f_cptr[q], s.f_cptr[q + 1]
    written, carry = {}, None
    T1, eb, ta = tptr[e1], e0, tptr[e0]
    while ta < T1:
        nt = min(T1 - ta, cap)
        while tptr[eb + 1] <= ta:
            eb += 1
        ee = eb
        while ee < e1 and tptr[ee] < ta + nt:
            ee += 1
        out = None
        for e in range(eb, ee):
            t0, t1 = tptr[e], tptr[e + 1]
            if t0 < ta:
                assert carry is not None and carry[0] == e
                acc = carry[1]
            else:
                acc = []
            acc = acc + list(range(max(t0, ta), min(t1, ta + nt)))
            if t1 > ta + nt:
                assert out is None
                out = (e, acc)
            elif t1 > t0:
                assert e not in written
                written[e] = acc
        carry = out
        ta += cap
    assert carry is None
    return written


@pytest.mark.parametrize("name", ["SE3", "SE2_Point2", "SE3_Point3"])
def test_kernel13_rounds_add_each_triple_once(graphs, name):
    """The plan of kernel 13's rounds (_round_sums' model of its walk):
    whatever a round holds (1, 2, 7 or 135 triples: kernel 13's at d = 6),
    the rounds add every triple of a block to that block's sum once, in the
    plan's order, one partial sum at most crossing a round's end, and write
    every block with triples once, so the order of the sums is the launch-
    a-level factorization's.  That the kernel follows this walk without a
    race is checked on the card (chip_smoke.py: its bits against the plain
    version's order, twice, and 1,000 factorizations in a row)."""
    _, _, tb, _ = _bound(graphs, name)
    s = SparseCholeskySolver(tb, min_level_cols=1)
    assert len(s.f_tik) > 0
    for cap in (1, 2, 7, 135):
        for q in range(len(s.f_cols)):
            got = _round_sums(s, q, cap)
            e0, e1 = s.f_cptr[q], s.f_cptr[q + 1]
            want = {e: list(range(s.f_tptr[e], s.f_tptr[e + 1]))
                    for e in range(e0, e1) if s.f_tptr[e + 1] > s.f_tptr[e]}
            assert got == want


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("name", ["SE3", "SE2_Point2"])
def test_kernel13_one_launch_matches_levels(graphs, name, plan):
    """factorize's one call of kernel 13 (its plain version over every
    level) gives the bits of the level loop, a level a call
    (factor_level_plain, a level a call), and its records, and the JAX
    package's factor at 1e-10 (test_factorize_and_solve's tolerance), at
    lam 1e-3 and 1; every factorization takes a new epoch."""
    jb, _, tb, tv = _bound(graphs, name)
    mlc = PLANS[plan]
    s = SparseCholeskySolver(tb, min_level_cols=mlc)
    jfac = jax.jit(JSparse(jb, min_level_cols=mlc).factorize)
    blocks, _ = s.system(tv.arrays)
    lead = torch.as_tensor(s.f_cblk, dtype=torch.long)
    for lam in (1e-3, 1.0):
        e = s._epoch
        f = s.factorize(blocks, lam)
        assert s._epoch == e + int(s.L_cut > 0)
        L = torch.zeros_like(blocks)
        rec = torch.full((len(s.f_cols),), -7, dtype=torch.int32)
        dv = s.dev
        for lv in range(s.L_cut):
            c0, c1 = s.lev_off[lv], s.lev_off[lv + 1]
            K.factor_level_plain(blocks, dv.f_cols[c0:c1],
                                 dv.f_cptr[c0:c1 + 1], dv.f_cblk, dv.f_tptr,
                                 dv.f_tik, dv.f_tjk, dv.pad_diag, lam, L,
                                 rec[c0:c1])
        assert torch.equal(f.L[lead], L[lead]) and torch.equal(f.rec, rec)
        if len(lead):
            jL, _ = jfac(jnp.asarray(blocks.numpy().reshape(-1, s.d, s.d)),
                         lam)
            assert _rel(f.L.reshape(-1, s.d, s.d)[lead],
                        np.asarray(jL)[lead]) <= 1e-10


def test_kernel13_epoch_wrap(graphs):
    """Before the epoch numbers start again the flags of kernels 13 and 14
    are zeroed (no flag can hold a later factorization's number early); a
    factorization and a solve each take the next number."""
    _, _, tb, tv = _bound(graphs, "SE3")
    s = SparseCholeskySolver(tb)
    blocks, g = s.system(tv.arrays)
    flags = s._scratch_buffers()[4]
    assert flags.shape == (3, s.nvars)
    flags.fill_(5)
    s._epoch = 2 ** 31 - 1
    f = s.factorize(blocks, 1e-3)
    assert s._epoch == 1 and bool((flags == 0).all())
    s.solve_factored(f, g)
    assert s._epoch == 2
    assert s.launches_per_factorization()["sp_level_factor"] == 1


def test_failed_pivot(graphs):
    """A leading column made indefinite: the JAX factor holds NaN there
    (LM rejects the try on its error); the port's ok is False and kernel
    7's pivot check names that column."""
    jb, jv, tb, tv = _bound(graphs, "SE3")
    s, js = SparseCholeskySolver(tb, min_level_cols=1), \
        JSparse(jb, min_level_cols=1)
    blocks, _ = s.system(tv.arrays)
    lv = s.L_cut // 2
    j = int(s.level_indices[lv].cols[0])
    blocks[s.sym.diag_block_by_col[j]] = -torch.eye(6).reshape(-1)
    f = s.factorize(blocks, 1e-3)
    assert not bool(f.ok) and f.state.tolist() == [0, j]
    jL, _ = jax.jit(js.factorize)(
        jnp.asarray(blocks.numpy().reshape(-1, 6, 6)), 1e-3)
    assert not np.isfinite(np.asarray(jL)[s.sym.diag_block_by_col[j]]).all()
    # the records: the bad column, then every later level's NaN pivots
    rec = f.rec.tolist()
    first = next(k for k, r in enumerate(rec) if r >= 0)
    assert rec[first] == j and s.lev_off[lv] <= first < s.lev_off[lv + 1]


@pytest.mark.parametrize("name", ["SE3", "SE2_Point2"])
def test_levels_lm(graphs, name):
    """levenberg_marquardt with SparseSolver(method="levels") against the
    JAX package's: the same iterations, the history at 1e-9 (direct solves
    that differ by rounding)."""
    jg, jv, tg, tv = graphs[name]
    p = dict(max_iterations=15, relative_error_tol=1e-9,
             absolute_error_tol=1e-12)
    ref = JO.levenberg_marquardt(jg, jv, JO.LMParams(**p),
                                 solver=JO.SparseSolver(method="levels"))
    _kernels.reset_launch_counts()
    got = TO.levenberg_marquardt(tg, tv, TO.LMParams(**p),
                                 solver=TO.SparseSolver(method="levels"),
                                 device="cpu")
    assert all(n == 0 for n in _kernels.launch_counts().values())
    assert got.iterations == ref.iterations
    assert _rel(got.history, ref.history) <= 1e-9


def test_levels_refusals(graphs):
    """method="levels": hard rows refused at bind (the JAX package fails on
    them in _solve_constrained); no gain-ratio denominator; diagonal
    damping ignored, as in the JAX package."""
    _, _, tg, tv = graphs["SE2"]
    hard = FactorGraph(list(tg.batches))
    hard.add(tfactors.prior_factors("SE2", [1], tv.at(1)[None].numpy(),
                                    tnoise.constrained_all(3)))
    with pytest.raises(NotImplementedError, match="constrained"):
        TO.SparseSolver(method="levels").bind(BoundGraph(hard, tv, "cpu"))
    sv = TO.SparseSolver(method="levels").bind(BoundGraph(tg, tv, "cpu"))
    system = sv.system(tv.arrays)
    with pytest.raises(NotImplementedError):
        sv.predicted_decrease(system, torch.zeros(1), 1.0, False)
    a, ok_a = sv.solve(system, 0.1, False)
    b, ok_b = sv.solve(system, 0.1, True)
    assert torch.equal(a, b) and bool(ok_a) and bool(ok_b)


def test_solver_owns_store(graphs):
    """SparseSolver(method="levels") assembles into one store, zeroed once:
    two systems of the same arrays give the same bits."""
    _, _, tg, tv = graphs["SE3_Point3"]
    sv = TO.SparseSolver(method="levels").bind(BoundGraph(tg, tv, "cpu"))
    b1 = sv.system(tv.arrays)[0].clone()
    b2 = sv.system(tv.arrays)[0]
    assert b2.data_ptr() == sv.store.data_ptr() and torch.equal(b1, b2)


# -- Kalman filters ----------------------------------------------------------

def _kf_inputs(seed=0, n=4, m=2, steps=6):
    rng = np.random.default_rng(seed)
    F = np.eye(n) + 0.1 * rng.normal(size=(n, n))
    B = rng.normal(size=(n, 1))
    H = rng.normal(size=(m, n))
    A = rng.normal(size=(n, n))
    Q = A @ A.T * 0.01 + 0.01 * np.eye(n)
    R = np.eye(m) * 0.3
    return dict(F=F, B=B, H=H, Q=Q, R=R, x0=rng.normal(size=n),
                P0=np.eye(n), u=rng.normal(size=(steps, 1)),
                z=rng.normal(size=(steps, m)))


def test_kalman_filter_and_smoother():
    """kf_predict / kf_update over six steps and the RTS smoother against
    the JAX package's at 1e-12 (the same closed forms; torch.linalg in
    place of jnp.linalg)."""
    p = _kf_inputs()
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    js = jkalman.kf_init(p["x0"], p["P0"])
    ts = tkalman.kf_init(t["x0"], t["P0"], device="cpu")
    jf, tf, jp, tp = [js], [ts], [js], [ts]
    for k in range(p["u"].shape[0]):
        js = jkalman.kf_predict(js, p["F"], p["B"], p["u"][k], p["Q"])
        ts = tkalman.kf_predict(ts, t["F"], t["B"], t["u"][k], t["Q"])
        jp.append(js)
        tp.append(ts)
        js = jkalman.kf_update(js, p["H"], p["z"][k], p["R"])
        ts = tkalman.kf_update(ts, t["H"], t["z"][k], t["R"])
        jf.append(js)
        tf.append(ts)
        assert _rel(ts.mean, js.mean) <= 1e-12
        assert _rel(ts.cov, js.cov) <= 1e-12
    jm, jc = jkalman.kf_smoother(
        jnp.stack([s.mean for s in jf]), jnp.stack([s.cov for s in jf]),
        jnp.stack([s.mean for s in jp]), jnp.stack([s.cov for s in jp]),
        p["F"])
    tm, tc = tkalman.kf_smoother(
        torch.stack([s.mean for s in tf]), torch.stack([s.cov for s in tf]),
        torch.stack([s.mean for s in tp]), torch.stack([s.cov for s in tp]),
        t["F"])
    assert _rel(tm, jm) <= 1e-12 and _rel(tc, jc) <= 1e-12


def test_kalman_predict_without_control():
    """kf_predict with B None: x' = F x (the model matrices given as numpy
    arrays, as the JAX package takes them)."""
    p = _kf_inputs(seed=1)
    s = tkalman.kf_predict(tkalman.kf_init(p["x0"], p["P0"], device="cpu"),
                           p["F"], None, None, p["Q"])
    assert _rel(s.mean, p["F"] @ p["x0"]) <= 1e-15


def test_kalman_init_device():
    """kf_init places the state on the CUDA device by default, as the
    port's other entry points do, and raises without CUDA; with
    device='cpu' the numpy inputs become float64 CPU tensors, and the
    filter's steps stay there."""
    p = _kf_inputs(seed=2)
    if torch.cuda.is_available():
        assert tkalman.kf_init(p["x0"], p["P0"]).mean.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tkalman.kf_init(p["x0"], p["P0"])
    s = tkalman.kf_init(p["x0"], p["P0"], device="cpu")
    assert s.mean.device.type == s.cov.device.type == "cpu"
    assert s.mean.dtype == s.cov.dtype == torch.float64
    s = tkalman.kf_update(s, p["H"], p["z"][0], p["R"])
    assert s.mean.device.type == s.cov.device.type == "cpu"


def test_extended_kalman_filter():
    """ExtendedKalmanFilter on SE(2): a motion and a range-bearing-like
    measurement, predict and update, against the JAX package's EKF at
    1e-12 (Jacobians by forward-mode autodiff on both sides)."""
    u = np.array([0.3, 0.1, 0.05])
    lm = np.array([2.0, 1.0])

    def jf(x):
        return jse2.compose(x, jnp.asarray(u))

    def tf(x):
        return se2.compose(x, torch.as_tensor(u))

    def jh(x):
        return jse2.transform_to(x, jnp.asarray(lm))

    def th(x):
        return se2.transform_to(x, torch.as_tensor(lm))

    jekf = jkalman.ExtendedKalmanFilter(jse2.retract, jse2.local, 3)
    tekf = tkalman.ExtendedKalmanFilter(se2.retract, se2.local, 3)
    x0 = np.array([0.1, -0.2, 0.3])
    P0, Q, R = np.eye(3) * 0.1, np.eye(3) * 0.01, np.eye(2) * 0.05
    z = np.array([1.7, 1.4])
    jx, jst = jnp.asarray(x0), jkalman.GaussianState(jnp.zeros(3),
                                                      jnp.asarray(P0))
    tx, tst = torch.as_tensor(x0), tkalman.GaussianState(
        torch.zeros(3, dtype=torch.float64), torch.as_tensor(P0))
    for _ in range(3):
        jx, jst = jekf.predict(jst, jx, jf, jnp.asarray(Q))
        tx, tst = tekf.predict(tst, tx, tf, torch.as_tensor(Q))
        jx, jst = jekf.update(jst, jx, jh, jnp.asarray(z), jnp.asarray(R))
        tx, tst = tekf.update(tst, tx, th, torch.as_tensor(z),
                              torch.as_tensor(R))
        assert _rel(tx, jx) <= 1e-12 and _rel(tst.cov, jst.cov) <= 1e-12


# -- the sparse export -------------------------------------------------------

@pytest.mark.parametrize("name", ["SE2_Point2"])
def test_sparse_export(graphs, name):
    """sparse_jacobian and sparse_hessian against the JAX package's on the
    same graph: the same sparsity pattern, A and b at 1e-12 (the generic
    linearization on both sides), H = A^T A and g = A^T b at 1e-12."""
    jb, jv, tb, tv = _bound(graphs, name)
    A, b = texport.sparse_jacobian(tb, tv.arrays)
    jA, jbv = jexport.sparse_jacobian(jb, jv.arrays)
    assert A.shape == jA.shape
    assert np.array_equal(A.indptr, jA.indptr)
    assert np.array_equal(A.indices, jA.indices)
    assert _rel(A.data, jA.data) <= 1e-12 and _rel(b, jbv) <= 1e-12
    H, g = texport.sparse_hessian(tb, tv.arrays)
    jH, jgv = jexport.sparse_hessian(jb, jv.arrays)
    assert _rel(H.toarray(), jH.toarray()) <= 1e-12
    assert _rel(g, jgv) <= 1e-12


def test_sparse_export_refuses_anti_factors(graphs):
    _, _, tg, tv = graphs["SE2"]
    import dataclasses
    anti = FactorGraph(list(tg.batches) + [dataclasses.replace(
        tg.batches[0], sign=-1.0)])
    with pytest.raises(NotImplementedError, match="anti-factor"):
        texport.sparse_jacobian(BoundGraph(anti, tv, "cpu"), tv.arrays)


# -- the union-find ----------------------------------------------------------

def test_dsf():
    """DSF: unions by rank with path compression; sets() partitions."""
    d = dsf.DSF(6)
    assert d.find(3) == 3
    d.union(0, 1)
    d.union(2, 3)
    d.union(1, 3)
    assert len({d.find(k) for k in range(4)}) == 1
    assert d.find(4) != d.find(0) and d.find(5) == 5
    assert d.make_set() == 6
    sets = d.sets()
    assert sorted(len(v) for v in sets.values()) == [1, 1, 1, 4]
    assert sorted(sum(sets.values(), [])) == list(range(7))


def test_dsf_map():
    """DSFMap over hashable keys, as the JAX package's."""
    from gtsam_tpu.base import dsf as jdsf
    for mod in (dsf, jdsf):
        m = mod.DSFMap()
        m.merge(("a", 1), ("b", 2))
        m.merge(("c", 3), ("b", 2))
        m.merge("x", "y")
        assert m.find(("a", 1)) == m.find(("c", 3))
        assert m.find("x") == m.find("y") != m.find(("a", 1))
        assert sorted(len(v) for v in m.sets().values()) == [2, 3]
