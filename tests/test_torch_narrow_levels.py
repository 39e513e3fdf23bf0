"""Kernel 7's narrow route (CPU): the plan's route of each level, the chunk
plan of a narrow level, and factorize through the narrow pair's plain
versions against the JAX package's factorize.

A level takes the narrow route when its fronts fit one of kernel 8's 32 x
32 tiles and its panels are at most 64 rows
(supernodal_kernels.narrow_route); its chunk plan (narrow_plan) sorts the
fronts by their first row variable, cuts them into chunks and sums each
chunk's blocks of U into a row a (chunk, target).  On the CPU the narrow
pair's plain versions are the wide pair's, so factorize keeps the wide
route's bits there.  Inputs are made with numpy from seeds and handed to
both packages; tolerances are stated where they are used.
"""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_tpu.linear.supernodal import SupernodalCholeskySolver as JSolver
from gtsam_tpu.sfm import bal as jbal

from gtsam_torch import _kernels
from gtsam_torch.graph.graph import BoundGraph
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
from gtsam_torch.sfm import bal as tbal
from gtsam_torch.sfm import synthetic


def _posegraph_module():
    """tests/test_torch_posegraph.py, for its cases (the sphere and the
    mixed graph in both packages)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_torch_posegraph.py")
    spec = importlib.util.spec_from_file_location("_posegraph_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


posegraph = _posegraph_module()
# the small graph-form BA (tests/test_torch_sfm_graph.py's stand-in),
# amalgamated as the pose-graph tests amalgamate: its point fronts (W 1,
# R up to 3 cameras, d 9) are one narrow level below a wide root
SMALL = (4, 60, 3)
SN_KW = dict(force_width=4, max_width=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _close(got, ref, tol):
    """max |got - ref| within tol of ref's largest entry."""
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, (g.shape, r.shape)
    err = float(np.max(np.abs(g - r))) / max(float(np.max(np.abs(r))),
                                             1e-300)
    assert err <= tol, (err, tol)


@pytest.fixture(scope="module")
def small_ba():
    """(torch solver, JAX solver, the torch system's blocks) of the small
    graph-form BA."""
    prob = synthetic.make_bal_problem(*SMALL, seed=0)
    tg, tv = tbal.to_graph(prob)
    jg, jv = jbal.to_graph(prob)
    ts = SupernodalCholeskySolver(BoundGraph(tg, tv, "cpu"), **SN_KW)
    js = JSolver(jg.bind(jv), **SN_KW)
    blocks, _ = ts.system(tv.arrays)
    return ts, js, blocks


def _routes(s):
    return [(lp.S, lp.W, lp.R, lp.narrow) for lp in s.level_plans]


def test_route_on_the_sfm_shape():
    """The dubrovnik-16-22106 stand-in under SparseSolver(order="amd")'s
    plan: level 0's 21,636 one-point fronts (W*d 9, R*d 36) go narrow, the
    576-wide root stays wide; level 0's chunks hold at most NARROW_CHUNK
    fronts, in the order of their first camera, and a row sums five or
    more of the level's 121,724 blocks of U on average."""
    prob = synthetic.make_bal_problem(16, 22106, 4, seed=0)
    g, v = tbal.to_graph(prob)
    s = SupernodalCholeskySolver(BoundGraph(g, v, "cpu"), order="amd")
    assert _routes(s) == [(21636, 1, 4, True), (1, 64, 0, False)]
    lv = s.dev.levels[0]
    plan = lv.narrow
    assert s.dev.levels[1].narrow is None and plan.warps == K.NARROW_WARPS
    sizes = np.diff(plan.cptr.numpy())
    assert sizes.max() <= K.NARROW_CHUNK and sizes.sum() == lv.S
    first = s.level_plans[0].row_vars[plan.order.numpy(), 0]
    assert np.all(np.diff(first) >= 0)
    assert plan.rows_max <= K.NARROW_ROW_BYTES // (81 * 8)
    assert len(s.level_plans[0].schur_src) == 121724
    assert plan.nrows * 5 < len(s.level_plans[0].schur_src)


@pytest.mark.parametrize("which", ["sphere", "mixed"])
def test_route_on_the_pose_graphs(request, which):
    """tests/test_torch_posegraph.py's cases (d = 6): the sphere's level
    0 (five-pose fronts, W*d 30, R*d 48) goes narrow and its three upper
    levels (W*d 42-48) stay wide; every level of the mixed graph (W*d
    18-24, R*d up to 12) goes narrow; each level's route is
    narrow_route's."""
    case = request.getfixturevalue(which)
    s = case.ts
    want = {"sphere": [True, False, False, False],
            "mixed": [True, True, True]}[which]
    assert [lp.narrow for lp in s.level_plans] == want
    assert all(lp.narrow == K.narrow_route(lp.W, lp.R, s.d)
               for lp in s.level_plans)
    assert [lv.narrow is not None for lv in s.dev.levels] == want


sphere = posegraph.sphere
mixed = posegraph.mixed


def _random_level(seed=0, S=300, R=4, n=40, d=3):
    """A level of S one-variable fronts over n separator variables, each
    front with up to R distinct row variables (the last R of a front's
    rows may be missing: sentinel n), and its Schur plan as the solver
    builds it (block ids of the (row, row) pairs, sorted segments)."""
    rng = np.random.default_rng(seed)
    row_vars = np.full((S, R), n, np.int32)
    block_of, src, tgt = {}, [], []
    for s in range(S):
        k = int(rng.integers(1, R + 1))
        rows = np.sort(rng.choice(n, size=k, replace=False))
        row_vars[s, :k] = rows
        for a in range(k):
            for b in range(a + 1):
                key = (int(rows[a]), int(rows[b]))
                src.append(s * R * R + a * R + b)
                tgt.append(block_of.setdefault(key, len(block_of) * 3 + 1))
    src, tgt = np.asarray(src, np.int32), np.asarray(tgt, np.int32)
    order = np.argsort(tgt, kind="stable")
    uniq, seg = np.unique(tgt[order], return_inverse=True)
    lp = types.SimpleNamespace(S=S, W=1, R=R, row_vars=row_vars,
                               schur_src=src[order],
                               schur_seg=seg.astype(np.int32),
                               schur_tgt=uniq.astype(np.int32))
    ptr = np.concatenate([[0], np.cumsum(np.bincount(seg))]).astype(np.int32)
    return lp, ptr, d, int(tgt.max()) + 2


def _check_chunk_plan(lp, ptr, d, nb, plan, seed):
    """The chunk plan adds each block of U of the level's Schur plan
    exactly once, into a row of its target; the rows of a chunk lie in
    target order, a target's rows in chunk order; urow agrees with the
    members; and the model's sums (rows in plan order, targets over chunks
    in order) give the plain segment sum at 1e-14 relative."""
    S, R = lp.S, lp.R
    T = len(lp.schur_tgt)
    tgt_of = np.full(S * R * R, -1)
    tgt_of[lp.schur_src] = np.repeat(np.arange(T), np.diff(ptr))
    msrc, mrow = plan.mem_src.numpy(), plan.mem_row.numpy()
    assert sorted(msrc.tolist()) == sorted(lp.schur_src.tolist())
    rptr, cptr = plan.rptr.numpy(), plan.cptr.numpy()
    order = plan.order.numpy()
    row_chunk = np.repeat(np.arange(len(rptr) - 1), np.diff(rptr))
    row_tgt = np.full(plan.nrows, -1)
    row_tgt[mrow] = tgt_of[msrc]
    # every member of a row has the row's target
    assert np.array_equal(row_tgt[mrow], tgt_of[msrc])
    # each member lies in its row's chunk, in plan order within the row
    pos = np.empty(S, np.int64)
    pos[order] = np.arange(S)
    mpos = pos[msrc // (R * R)]
    assert np.all((cptr[row_chunk[mrow]] <= mpos)
                  & (mpos < cptr[row_chunk[mrow] + 1]))
    same = mrow[1:] == mrow[:-1]
    assert np.all(np.diff(mrow) >= 0) and np.all(np.diff(mpos)[same] > 0)
    for c in range(len(rptr) - 1):
        assert np.all(np.diff(row_tgt[rptr[c]:rptr[c + 1]]) > 0)
    tptr, trow = plan.tptr.numpy(), plan.trow.numpy()
    for t in range(T):
        rows = trow[tptr[t]:tptr[t + 1]]
        assert np.all(row_tgt[rows] == t)
        assert np.all(np.diff(row_chunk[rows]) > 0)
    assert sorted(trow.tolist()) == list(range(plan.nrows))
    urow = plan.urow.numpy()
    tri = np.flatnonzero(np.tril(np.ones((R, R), bool)).reshape(-1))
    for m, r in zip(msrc, mrow):
        p = pos[m // (R * R)]
        ab = int(np.flatnonzero(tri == m % (R * R))[0])
        assert urow[p, ab] == r - rptr[row_chunk[r]]
    assert int((urow >= 0).sum()) == len(msrc)
    # the sums
    rng = np.random.default_rng(seed)
    Lp = torch.as_tensor(rng.normal(size=(S, R * d, lp.W * d)))
    part, seg = K.narrow_chunk_plan_model(Lp, plan)
    U = torch.bmm(Lp, Lp.mT).reshape(S, R, d, R, d).permute(
        0, 1, 3, 2, 4).reshape(-1, d * d)
    ref = torch.zeros((T, d * d), dtype=torch.float64).index_add_(
        0, torch.as_tensor(tgt_of[lp.schur_src]),
        U[torch.as_tensor(lp.schur_src, dtype=torch.long)])
    _close(seg, ref, 1e-14)
    direct = torch.zeros_like(part)
    for m, r in zip(msrc, mrow):
        direct[r] += U[m]
    assert torch.equal(part, direct)


def test_chunk_plan_on_the_small_graph_ba(small_ba):
    """The chunk plan of the small graph-form BA's narrow level (55 point
    fronts, d 9: one chunk)."""
    ts, _, _ = small_ba
    assert _routes(ts) == [(55, 1, 3, True), (1, 8, 0, False)]
    lp, lv = ts.level_plans[0], ts.dev.levels[0]
    _check_chunk_plan(lp, ts.schur_ptr[0], ts.d, ts.B + 1, lv.narrow, 1)


def test_chunk_plan_on_a_random_level():
    """The chunk plan of a random level of 300 one-variable fronts over 40
    separator variables (d 3; several chunks, fronts with fewer rows than
    R)."""
    lp, ptr, d, nb = _random_level()
    plan = K.narrow_plan(lp, ptr, d, nb, "cpu")
    assert plan.cptr.numel() - 1 == -(-lp.S // K.NARROW_CHUNK) > 1
    _check_chunk_plan(lp, ptr, d, nb, plan, 2)


def test_chunks_are_cut_at_the_row_cap():
    """A chunk whose fronts reach more targets than the cap is cut front
    by front: every chunk then reaches at most the cap, and the chunks
    cover the sorted fronts in order."""
    lp, ptr, d, nb = _random_level(seed=3, S=200)
    plan = K.narrow_plan(lp, ptr, d, nb, "cpu")
    S, R = lp.S, lp.R
    full = np.full((S, R, R), -1)
    src = lp.schur_src
    full[src // (R * R), src % (R * R) // R, src % R] = lp.schur_tgt[
        lp.schur_seg]
    tb = full[:, np.tril(np.ones((R, R), bool))]
    order, cptr = K.narrow_chunks(lp.row_vars[:, 0], tb, 12, chunk=32)
    assert np.array_equal(order, plan.order.numpy())
    assert cptr[0] == 0 and cptr[-1] == S and np.all(np.diff(cptr) > 0)
    assert np.all(np.diff(cptr) <= 32) and len(cptr) - 1 > -(-S // 32)
    for c0, c1 in zip(cptr[:-1], cptr[1:]):
        t = tb[order[c0:c1]]
        assert np.unique(t[t >= 0]).size <= 12


@pytest.mark.parametrize("damping", ["lambda", "diagonal"])
def test_factorize_against_jax(small_ba, damping):
    """factorize of the small graph-form BA (a narrow level below a wide
    root) against the JAX package's on the same store at lam 1e-2: each
    level's L and Lp at 1e-10 (Cholesky factors of the same fronts summed
    in another order, the root's conditioned by the BA's gauge), ok and
    badcol."""
    ts, js, blocks = small_ba
    dd = damping == "diagonal"
    _, jL, jP, jok, jbad = jax.jit(js.factorize, static_argnums=2)(
        jnp.asarray(blocks.numpy()), 1e-2, dd)
    f = ts.factorize(blocks, 1e-2, dd)
    assert bool(f.ok) and bool(jok) and int(f.badcol) == int(jbad) == -1
    assert len(f.Ldiag) == len(jL) == 2
    for a, b, c, e in zip(f.Ldiag, jL, f.Lpanel, jP):
        _close(a, b, 1e-10)
        assert (c is None) == (e is None)
        if c is not None:
            _close(c, e, 1e-10)


@pytest.mark.parametrize("which", ["small_ba", "mixed"])
def test_bad_pivot_on_a_narrow_level(request, which):
    """A store whose narrow level's first front has its first column's
    diagonal at -1e6: ok False and badcol that column, as in the JAX
    package."""
    case = request.getfixturevalue(which)
    if which == "small_ba":
        ts, js, blocks = case
    else:
        ts, js, blocks = case.ts, case.js, case.systems()[2]
    assert ts.level_plans[0].narrow
    c = int(ts.level_plans[0].col_vars[0, 0])
    bad = blocks.clone()
    bad[int(ts.sym.diag_block_by_col[c]), 0] = -1e6
    f = ts.factorize(bad, 1e-2)
    _, _, _, jok, jbad = jax.jit(js.factorize, static_argnums=2)(
        jnp.asarray(bad.numpy()), 1e-2, False)
    assert not bool(f.ok) and int(f.badcol) == c
    assert (bool(jok), int(jbad)) == (False, c)


def _narrow_args(ts, blocks):
    lv = ts.dev.levels[0]
    return lv, (blocks.clone(), blocks, lv.diag_ids, lv.diag_flip,
                lv.diag_pad, lv.valid_diag, lv.col_vars, ts.dev.dbc,
                lv.panel_ids, 0.5, True, torch.zeros(lv.S, dtype=torch.int32))


@pytest.mark.parametrize("name", ["sn_narrow_front", "sn_narrow_scatter"])
def test_narrow_wrappers_on_cpu_are_their_plain_versions(small_ba, name):
    """On CPU tensors each narrow wrapper returns, and writes into its
    arguments, exactly what its plain version does, and counts no
    launch."""
    ts, _, blocks = small_ba

    def args():
        lv, a = _narrow_args(ts, blocks)
        part = torch.zeros_like(ts.dev.narrow_part)
        if name == "sn_narrow_front":
            return a + (lv.narrow, part)
        Lp = K.sn_narrow_front_plain(*a, lv.narrow, part)[2]
        return (Lp, part, lv.narrow, blocks.clone())
    _kernels.reset_launch_counts()
    a1, a2 = args(), args()
    got = getattr(K, name)(*a1)
    ref = getattr(K, name + "_plain")(*a2)
    outs = [] if got is None else list(got)
    assert len(outs) == (0 if ref is None else len(ref))
    pairs = list(zip(outs, [] if ref is None else list(ref)))
    pairs += [(x, y) for x, y in zip(a1, a2) if isinstance(x, torch.Tensor)]
    assert all(torch.equal(x, y) for x, y in pairs)
    assert all(n == 0 for n in _kernels.launch_counts().values())


def test_narrow_pair_keeps_the_wide_pairs_bits(small_ba):
    """The narrow pair's plain versions on a narrow level give the wide
    pair's (the front kernel and the Schur update) bits: L, L^-1, Lp, the
    tile inverses, the records and the updated store; and the front's
    chunk rows are the model's."""
    ts, _, blocks = small_ba
    lv, a = _narrow_args(ts, blocks)
    _, b = _narrow_args(ts, blocks)
    part = torch.zeros_like(ts.dev.narrow_part)
    L1, X1, Lp1, t1 = K.sn_narrow_front(*a, lv.narrow, part)
    K.sn_narrow_scatter(Lp1, part, lv.narrow, a[0])
    L2, X2, At, t2 = K.sn_front_factor(*b)
    Lp2 = K.sn_schur_update(X2, At, lv.schur, b[0], ts.dev.schur_U)
    for x, y in ((L1, L2), (X1, X2), (Lp1, Lp2), (t1, t2), (a[11], b[11]),
                 (a[0], b[0])):
        assert torch.equal(x, y)
    assert Lp1.mT.is_contiguous()
    rows = K.narrow_chunk_plan_model(Lp1, lv.narrow)[0]
    assert torch.equal(part[:rows.numel()], rows.reshape(-1))
