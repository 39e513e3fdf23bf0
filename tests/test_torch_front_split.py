"""Kernel 7's few-front route: the front kernel split over several CTAs a
front (supernodal_kernels.front_ctas, front_split_jobs) and the Schur
update's tile plan, on the CPU.

The split route runs only on the card (chip_smoke.py holds it to the
one-CTA route bit for bit); here its plan, a sequential model of its job
walk, and factorize() on a graph with a one-front level of three column
blocks against the JAX package."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gtsam_tpu as gt
from gtsam_tpu.io import datasets as jdatasets
from gtsam_tpu.linear.supernodal import SupernodalCholeskySolver as JSolver
from gtsam_tpu.slam.initialize import initialize_pose3_chordal as jchordal

from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph
from gtsam_torch.io import datasets as tdatasets
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
from gtsam_torch.slam.initialize import initialize_pose3_chordal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132    # an H100's SMs
PRIOR_SIGMAS = [[1e-3] * 3 + [1e-2] * 3]

# Level shapes (S, W*d, R*d) of the three paths' plans (chip_smoke.py's
# logs of kernel 7's routes), with d and the CTAs a front that front_ctas
# gives each on an H100
LEVELS = {
    "sphere": (6, [((58, 204, 144), 2), ((16, 222, 198), 6),
                   ((8, 360, 288), 15), ((5, 378, 426), 16),
                   ((3, 384, 450), 16), ((1, 360, 300), 15),
                   ((1, 384, 192), 12), ((1, 192, 0), 4)]),
    "standin": (3, [((181, 189, 222), 1), ((50, 189, 333), 2),
                    ((25, 192, 465), 5), ((14, 192, 615), 9),
                    ((5, 192, 549), 24), ((5, 174, 642), 22),
                    ((3, 192, 708), 24), ((3, 192, 606), 24),
                    ((3, 192, 780), 32), ((2, 192, 753), 24),
                    ((1, 102, 618), 13), ((1, 192, 678), 24),
                    ((1, 21, 657), 3), ((1, 192, 867), 32),
                    ((1, 192, 675), 24), ((1, 192, 483), 16),
                    ((1, 192, 291), 16), ((1, 192, 99), 8),
                    ((1, 99, 0), 5)]),
    "sfm": (9, [((1, 576, 0), 25)]),
}


@pytest.mark.parametrize("path", sorted(LEVELS))
def test_front_ctas_at_level_shapes(path):
    """front_ctas at the paths' level shapes: the level's share of the SMs,
    at most the front's jobs (the row halves of its lower 128-column
    blocks, or the gathers' warp jobs), at least 1, and 1 wherever the
    level holds half the card's SMs or more; the level's CTAs fit the card
    at once (one an SM)."""
    d, levels = LEVELS[path]
    for (S, Wd, Rd), want in levels:
        W, R = Wd // d, Rd // d
        got = K.front_ctas(S, W, R, d, SMS)
        assert got == want, (S, Wd, Rd)
        nb = -(-Wd // K.FRONT_BLOCK)
        chunks = max(1, -(-Rd // K.FRONT_PANEL_ROWS))
        halves = sum((i + 1) * (2 if min(128, Wd - 128 * i) > 64 else 1)
                     for i in range(nb))
        jobs = max(halves, -(-W * chunks // K.FRONT_WARPS))
        assert 1 <= got <= max(1, min(jobs, SMS // S))
        assert got == 1 or S * got <= SMS
        if 2 * S >= SMS:
            assert got == 1
        # the flags a front takes: a diagonal block's three (factored,
        # its second half updated, its record), a lower block's three (two
        # halves solved, its L^-1 composed), a gather and an end flag a CTA
        assert K.front_flags(W, d, got) == (3 * nb + 3 * nb * (nb + 1) // 2
                                            + 2 * got)
    assert K.front_ctas(66, 64, 0, 3, SMS) == 1
    assert K.front_ctas(65, 64, 0, 3, SMS) == 2
    assert K.front_ctas(1, 1, 0, 3, SMS) == 1
    assert K.front_ctas(1, 64, 0, 9, 0) == 1    # off the card


def _check_walk(log, nb, ctas, last):
    """The split walk's log against the data each job reads and writes:
    every job once, on its owner; each row half of a lower block updated
    once a step before its column, in step order, then solved (or, both
    halves of a diagonal block, factored); a job reads a half that another
    CTA writes only once it is final, and awaits its flag; L^-1's blocks
    summed from final blocks, then scaled once D_i is factored."""
    jobs = K.front_split_jobs(nb, ctas, last)
    assert sorted(map(repr, (j for q in jobs for j in q))) == sorted(
        repr(j) for _, j in log)

    def halves(i):
        return 2 if (last if i == nb - 1 else 128) > 64 else 1
    steps, done, summed, composed, flags = {}, set(), set(), set(), set()
    for c, (kind, i, j, k, h, waits, flag) in log:
        assert all(f in flags for f in waits)
        if kind in ("sum", "scale"):
            assert c == (2 * (i * (i + 1) // 2 + j)) % ctas
        else:
            assert c == (2 * (i * (i + 1) // 2 + j) + h) % ctas
        if kind == "update":
            # half h of A_ij -= L_ik L_jk^T: the step order, from final
            # halves; a half another CTA solved is awaited
            assert steps.get((i, j, h), 0) == k < j <= i
            assert ("S", i, k, h) in done
            assert all(("S", j, k, g) in done for g in range(halves(j)))
            assert {("S", i, k, h)} | {("S", j, k, g)
                                       for g in range(halves(j))} \
                <= set(waits)
            steps[i, j, h] = k + 1
        elif kind == "solve":
            assert steps.get((i, k, h), 0) == k and ("B", k) in done
            assert ("B", k) in waits and i > k
            done.add(("S", i, k, h))
        elif kind == "factor":
            # both halves updated by every earlier step; the second
            # half's last update (another CTA's) awaited
            assert i == j == k and ("B", k) not in done
            assert all(steps.get((k, k, g), 0) == k
                       for g in range(halves(k)))
            if k and halves(k) == 2 and ctas > 1:
                assert ("U", k) in waits and ("U", k) in flags
            done.add(("B", k))
        elif kind == "sum":
            # Y_ij from L_ij .. L_i,i-1 (each half), X_jj (D_j) and
            # X_j+1,j .. X_i-1,j
            assert i > j and (i, j) not in summed
            need = ({("S", i, m, g) for m in range(j, i)
                     for g in range(halves(i))} | {("B", j)}
                    | {("X", m, j) for m in range(j + 1, i)})
            assert need <= done | composed and need <= set(waits)
            summed.add((i, j))
        else:
            # X_ij = -X_ii Y_ij: D_i factored, Y_ij summed on this CTA
            assert kind == "scale" and (i, j) in summed
            assert ("X", i, j) not in composed
            assert ("B", i) in done and ("B", i) in waits
            composed.add(("X", i, j))
        if flag is not None:
            assert flag not in flags
            flags.add(flag)
    lower = {(i, j) for i in range(nb) for j in range(i)}
    assert done == ({("B", k) for k in range(nb)}
                    | {("S", i, j, g) for i, j in lower
                       for g in range(halves(i))})
    assert composed == {("X", i, j) for i, j in lower}
    assert all(steps.get((i, j, g), 0) == j for i, j in lower | {
        (k, k) for k in range(nb)} for g in range(halves(i)))


@pytest.mark.parametrize("nb,ctas", [(1, 1), (1, 4), (2, 1), (2, 2),
                                     (2, 5), (5, 1), (5, 3), (5, 15)])
def test_front_split_walk(nb, ctas):
    """A sequential model of the split route's job walk on fronts of 1, 2
    and 5 column blocks (the sfm root's: its last block 64 wide, one row
    half), under random schedules of the CTAs: it never stalls, every
    trailing row half is updated once a step in step order, and no job
    reads a half before its flag is published (the counterpart of kernel
    13's test of its rounds)."""
    for seed in range(6):
        for last in (128, 64):
            _check_walk(K.front_split_model(nb, ctas, seed, last), nb,
                        ctas, last)


def test_front_split_walk_one_cta_is_the_kernels_order():
    """With one CTA the walk is the one-CTA kernel's order: each step's
    factorization, its solves, its trailing blocks column by column (each
    block's row halves in turn; a last block of 64 rows has one), then
    L^-1's blocks row by row, each its sum and then its scale."""
    (jobs,) = K.front_split_jobs(3, 1, last=64)
    assert [(kind, i, j, k, h) for kind, i, j, k, h, _, _ in jobs] == [
        ("factor", 0, 0, 0, 0), ("solve", 1, 0, 0, 0), ("solve", 1, 0, 0, 1),
        ("solve", 2, 0, 0, 0), ("update", 1, 1, 0, 0),
        ("update", 1, 1, 0, 1), ("update", 2, 1, 0, 0),
        ("update", 2, 2, 0, 0), ("factor", 1, 1, 1, 0),
        ("solve", 2, 1, 1, 0), ("update", 2, 2, 1, 0),
        ("factor", 2, 2, 2, 0), ("sum", 1, 0, None, None),
        ("scale", 1, 0, None, None), ("sum", 2, 0, None, None),
        ("scale", 2, 0, None, None), ("sum", 2, 1, None, None),
        ("scale", 2, 1, None, None)]


def _sphere_module():
    spec = importlib.util.spec_from_file_location(
        "port_sphere_data", os.path.join(REPO, "scripts",
                                         "port_sphere_data.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def one_front(tmp_path_factory):
    """An 8 x 10 sphere in both packages whose plan (force_width=48,
    max_width=48) has two one-front levels: a front 210 wide (two column
    blocks) with a panel of 60 rows, and a root 270 wide (three)."""
    path = str(tmp_path_factory.mktemp("sphere") / "sphere.g2o")
    _sphere_module().write_sphere_g2o(path, laps=8, per_lap=10, radius=10.0,
                                      sigma_t=0.1, sigma_r=0.05, seed=1)
    jg, _ = jdatasets.load_3d(path)
    jg.add(gt.prior_factors("SE3", [0], gt.SE3(np.eye(3)[None],
                                               np.zeros((1, 3))),
                            gt.noise.sigmas(PRIOR_SIGMAS)))
    tg, _ = tdatasets.load_3d(path)
    tg.add(tfactors.prior_factors("SE3", [0], SE3(np.eye(3)[None],
                                                  np.zeros((1, 3))),
                                  tnoise.sigmas(PRIOR_SIGMAS)))
    kw = dict(force_width=48, max_width=48)
    jv, tv = jchordal(jg), initialize_pose3_chordal(tg)
    js = JSolver(jg.bind(jv), **kw)
    ts = SupernodalCholeskySolver(BoundGraph(tg, tv, "cpu"), **kw)
    jb, _ = jax.jit(js.system)(jv.arrays)
    tb, _ = ts.system(tv.arrays)
    return js, ts, np.asarray(jb), tb


@pytest.mark.parametrize("damping", ["lambda", "diagonal"])
def test_factorize_one_front_levels_against_jax(one_front, damping):
    """factorize() on a plan with one-front levels of two and three column
    blocks (split levels on an H100: front_ctas 6 and 9) against the JAX
    package's factorize: each level's L and Lp at 1e-10 relative to the
    largest entry (Cholesky factors of the same fronts, summed in another
    order), ok and badcol."""
    js, ts, jb, tb = one_front
    shapes = [(lp.S, lp.W * ts.d, lp.R * ts.d) for lp in ts.level_plans]
    assert shapes == [(1, 210, 60), (1, 270, 0)]
    assert [K.front_ctas(lp.S, lp.W, lp.R, ts.d, SMS)
            for lp in ts.level_plans] == [6, 9]
    assert all(lv.ctas == 1 for lv in ts.dev.levels)    # off the card
    dd = damping == "diagonal"
    _, jL, jP, jok, jbad = jax.jit(js.factorize, static_argnums=2)(
        jnp.asarray(jb), 1e-2, dd)
    f = ts.factorize(tb, 1e-2, dd)
    assert bool(f.ok) and bool(jok) and int(f.badcol) == int(jbad) == -1
    assert len(f.Ldiag) == len(jL) == 2
    for a, b, c, e in zip(f.Ldiag, jL, f.Lpanel, jP):
        b = np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10,
                                   atol=1e-10 * np.abs(b).max())
        assert (c is None) == (e is None)
        if c is not None:
            e = np.asarray(e)
            np.testing.assert_allclose(c.numpy(), e, rtol=1e-10,
                                       atol=1e-10 * np.abs(e).max())


# the Schur update's levels (S, W, R) a path's plan has, by d, and shapes
# of odd R*d
UPDATE_SHAPES = {
    3: [(181, 63, 74), (50, 63, 111), (25, 64, 155), (14, 64, 205),
        (5, 58, 214), (1, 64, 289), (1, 7, 219), (1, 64, 33), (2, 5, 7)],
    6: [(58, 34, 24), (16, 37, 33), (8, 60, 48), (5, 63, 71), (3, 64, 75),
        (1, 60, 50), (1, 64, 32), (1, 3, 11)],
    9: [(21636, 1, 4), (55, 1, 3), (1, 8, 23), (3, 5, 7)],
}


@pytest.mark.parametrize("d", sorted(UPDATE_SHAPES))
def test_schur_tile_plan(d):
    """The Schur update's plan at store width d on the paths' level shapes
    and odd R*d, at its 64-wide output tile, on the scatter route and (a
    level of one front) the direct one: U's walked tiles (nt <= mt + 1,
    those without an entry of U's block-lower triangle skipped, as the
    kernel walks them) cover every entry (r, c) with c // d <= r // d
    exactly once; each product's k-chunks cover its depth once (the
    panel's row tile mt only its first (tile / 32)(mt + 1) slabs, L^-1
    being lower triangular); U's operand is at an even pitch; the scratch
    holds U (none on the direct route), the partial tiles and the
    even-pitched operand where R*d is odd."""
    tile = K.UPDATE_TILE
    assert tile == 64
    for S, W, R in UPDATE_SHAPES[d]:
        Wd, Rd = W * d, R * d
        for direct in (False, True) if S == 1 else (False,):
            sp = K.update_split(S, W, R, d, 5, direct)
            assert sp.direct == direct
            assert sp.pitch == Rd + Rd % 2
            ntn, slabs = -(-Rd // tile), -(-Wd // 32)
            cover = np.zeros((Rd, Rd), np.int64)
            walked = 0
            for mt in range(ntn):
                for nt in range(min(mt + 2, ntn)):
                    if tile * nt // d > min(tile * mt + tile - 1,
                                            Rd - 1) // d:
                        continue
                    walked += 1
                    cover[tile * mt:tile * mt + tile,
                          tile * nt:tile * nt + tile] += 1
            r, c = np.indices((Rd, Rd))
            need = c // d <= r // d
            assert (cover[need] == 1).all() and cover.max() == 1
            assert walked <= sp.u_tiles // S
            for ck, nk in ((sp.panel_chunk, sp.panel_chunks),
                           (sp.u_chunk, sp.u_chunks)):
                chunks = [(k * ck, min(slabs, k * ck + ck))
                          for k in range(nk)]
                assert chunks[0][0] == 0 and chunks[-1][1] == slabs
                assert all(x[1] == y[0] for x, y in zip(chunks, chunks[1:]))
                assert all(lo < hi for lo, hi in chunks)
            for mt in range(-(-Wd // tile)):
                deep = min(tile // 32 * (mt + 1), slabs)
                formed = -(-deep // sp.panel_chunk)
                assert 1 <= formed <= sp.panel_chunks
            part = max([t * n for t, n in ((sp.panel_tiles, sp.panel_chunks),
                                           (sp.u_tiles, sp.u_chunks))
                        if n > 1] + [0])
            assert sp.scratch == ((0 if direct else S * Rd * Rd)
                                  + part * tile * tile
                                  + (S * Wd * sp.pitch if Rd % 2 else 0))
            assert sp.scatter_ctas == (0 if direct else
                                       -(-5 * d // K.UPDATE_THREADS))


def test_schur_plan_direct_route(one_front):
    """The direct route of the Schur update is a plan property of a level
    of one front whose targets each take one U block: utgt names each
    listed block's (a, b) target row, the rest -1; the same level's split
    on the scatter route holds U, and a level of several fronts keeps the
    ordered scatter."""
    _, ts, _, _ = one_front
    lv = ts.dev.levels[0]
    sp = lv.schur
    assert lv.S == 1 and sp.split.direct and sp.utgt.shape == (lv.R, lv.R)
    assert bool((sp.ptr[1:] - sp.ptr[:-1] == 1).all())
    ab = sp.src.long() % (lv.R * lv.R)
    assert torch.equal(sp.utgt.reshape(-1)[ab], sp.tgt)
    rest = torch.ones(lv.R * lv.R, dtype=torch.bool)
    rest[ab] = False
    assert bool((sp.utgt.reshape(-1)[rest] == -1).all())
    a, b = ab // lv.R, ab % lv.R
    assert bool((b <= a).all())
    scatter = K.update_split(1, lv.W, lv.R, ts.d, sp.tgt.shape[0])
    assert not scatter.direct and scatter.scatter_ctas >= 1
    assert scatter.scratch == sp.split.scratch + (lv.R * ts.d) ** 2
    two = K.schur_plan(sp.src, sp.ptr, sp.tgt, 2, lv.W, lv.R, ts.d, sp.nb)
    assert not two.split.direct and two.utgt is None


def _cu(name):
    from gtsam_torch import _build
    return (_build.CSRC / f"{name}.cu").read_text()


def test_front_sizes_match_the_source():
    """The front kernel's sizes by which front_ctas and front_flags count
    are csrc/sn_factor.cu's own: the 128-column blocks and 8 warps of
    kernel 10's code, a warp's 256 panel rows, and a front's flags (a flag
    a lower block of L and of L^-1, a gather and an end flag a CTA, a
    record a diagonal block); the Schur update's even pitch is R*d + 1 for
    an odd R*d only."""
    from gtsam_torch import _build
    src = _cu("sn_factor")
    hdr = (_build.CSRC / "chol_tiles.cuh").read_text()
    assert "constexpr int kNB = 128;" in hdr and K.FRONT_BLOCK == 128
    assert "constexpr int kWarps = 8;" in hdr and K.FRONT_WARPS == 8
    assert "constexpr int kPanelRows = 256;" in src
    assert K.FRONT_PANEL_ROWS == 256
    assert "return 3 * nb + 3 * (nb * (nb + 1) / 2) + 2 * ctas;" in src
    for W, d, ctas in ((64, 9, 15), (63, 3, 1), (1, 6, 4)):
        nb = -(-W * d // 128)
        assert K.front_flags(W, d, ctas) == (3 * nb + 3 * nb * (nb + 1) // 2
                                             + 2 * ctas)
    assert [K.even_pitch(n) for n in (222, 333, 1, 0)] == [222, 334, 2, 0]


def test_front_buffers_are_the_kernels_layout():
    """front_buffers' L^-T and At are views of buffers at even row pitches
    (an odd W*d or R*d one wider), which _padded maps back to the buffer
    and its pitch; a contiguous tensor is that layout only at an even
    width, and is otherwise left for the checks to refuse; the front
    kernel's plain version writes the same values into them as into new
    tensors."""
    for S, Wd, Rd in ((2, 9, 7), (1, 12, 0), (3, 6, 10)):
        X, At = K.front_buffers(S, Wd, Rd, "cpu")
        ldx, lda = Wd + Wd % 2, Rd + Rd % 2
        assert X.shape == (S, Wd, Wd)
        assert X.stride() == (ldx * ldx, ldx, 1)
        buf, pitch = K._padded(X, Wd, True)
        assert pitch == ldx and buf.shape == (S, ldx, ldx)
        assert buf.data_ptr() == X.data_ptr()
        if Rd:
            assert At.shape == (S, Wd, Rd)
            assert At.stride() == (Wd * lda, lda, 1)
            buf, pitch = K._padded(At, Rd, False)
            assert pitch == lda and buf.shape == (S, Wd, lda)
        else:
            assert At is None
        c = torch.zeros(S, Wd, Wd, dtype=torch.float64)
        buf, pitch = K._padded(c, Wd, True)
        assert pitch == ldx and (buf is c) == (Wd % 2 == 1)
    rng = np.random.default_rng(5)
    d, W, R, S, nb = 3, 3, 2, 2, 20
    A = rng.standard_normal((nb, d * d))
    sym = A.reshape(nb, d, d)
    blocks = torch.from_numpy((sym + sym.transpose(0, 2, 1)).reshape(nb, -1))
    ids = torch.from_numpy(rng.integers(0, nb - 1, (S, W, W)).astype(np.int32))
    args = (blocks.clone(), blocks, ids,
            torch.zeros(S, W, W, dtype=torch.bool),
            torch.full((S, W * d), 50.0, dtype=torch.float64),
            torch.ones(S, W * d, dtype=torch.bool),
            torch.arange(S * W, dtype=torch.int32).view(S, W),
            torch.arange(S * W + 1, dtype=torch.int32),
            torch.from_numpy(rng.integers(0, nb - 1, (S, R, W))
                             .astype(np.int32)), 1e-2, False)
    ref = K.sn_front_factor(*args, torch.empty(S, dtype=torch.int32))
    X, At = K.front_buffers(S, W * d, R * d, "cpu")
    got = K.sn_front_factor(*args, torch.empty(S, dtype=torch.int32),
                            out=(None, X, At, None))
    assert got[1].data_ptr() == X.data_ptr() and got[2] is At
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_race_build_is_a_test_build_only():
    """The delay-injected copy of kernel 7 is a test build of its own
    library (its own flags, its own digest), which no kernel table names,
    so the main path never loads it; its define guards the delays only."""
    from gtsam_torch import _build
    from gtsam_torch.linear import dense_kernels, sparse_kernels
    from gtsam_torch.sfm import ba_kernels
    assert _build.TEST_BUILDS == {
        "sn_factor_race": ("sn_factor", ("-DGT_SN_RACE_DELAYS",))}
    assert "sn_factor_race" not in _build.SOURCES
    assert _build.library_path("sn_factor_race") != \
        _build.library_path("sn_factor")
    tables = (K.KERNELS, dense_kernels.KERNELS, sparse_kernels.KERNELS,
              ba_kernels.KERNELS)
    assert all(k.source != "sn_factor_race" for t in tables
               for k in t.values())
    src = _cu("sn_factor")
    assert src.count("GT_SN_RACE_DELAYS") == 2    # the comment and the guard
    assert "#ifdef GT_SN_RACE_DELAYS\n" in src
