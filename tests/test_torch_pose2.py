"""Parity of gtsam_torch's 2D pose-graph slice with gtsam_tpu's (CPU).

SE2 factors, kernel 6's Pose2 variant (its plain versions: on the CPU every
wrapper computes them), the supernodal solver at store width d = 3 (odd
W*d and R*d), the 2D loaders and writer, LAGO, the optimizers and GNC.
The JAX side runs float64 (tests/conftest.py turns x64 on); the torch side
float64 on the CPU.  Inputs are made with numpy from seeds and handed to
both packages.  Graphs: a 60-pose Manhattan world (scripts/port_2d_data.py,
150 edges) with a prior on pose 0, factorized with force_width 4, and a
graph of SE2 poses and Point2 landmarks joined by a pose-frame landmark
factor (the 3-wide store pads the landmarks' 2 dimensions).  Tolerances,
each stated where it is used.
"""

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
from gtsam_tpu.geometry import se2 as jse2
from gtsam_tpu.graph import factors as jfactors
from gtsam_tpu.graph.graph import FactorGraph as JGraph
from gtsam_tpu.graph.values import Values as JValues
from gtsam_tpu.io import datasets as jdatasets
from gtsam_tpu.linear.supernodal import SupernodalCholeskySolver as JSolver
from gtsam_tpu.optimize import gnc as jgnc
from gtsam_tpu.optimize import optimizers as JO
from gtsam_tpu.slam.initialize import initialize_pose2_lago as jlago

from gtsam_torch import _kernels
from gtsam_torch.base import losses as tlosses
from gtsam_torch.base import noise as tnoise
from gtsam_torch.geometry import se2
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.io import datasets as tdatasets
from gtsam_torch.linear import supernodal_kernels as K
from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
from gtsam_torch.optimize import gnc as tgnc
from gtsam_torch.optimize import optimizers as TO
from gtsam_torch.slam.initialize import initialize_pose2_lago

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SN_KW = dict(force_width=4, max_width=8)
PRIOR_SIGMAS = [[1e-3, 1e-3, 1e-4]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _data_module():
    spec = importlib.util.spec_from_file_location(
        "port_2d_data", os.path.join(REPO, "scripts", "port_2d_data.py"))
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
    return torch.as_tensor(np.array(a, dtype=np.float64))


class Case:
    """One graph in both packages, bound at its initial values, with the
    supernodal solvers of both."""

    def __init__(self, jgraph, jvals, tgraph, tvals, **kw):
        self.jgraph, self.jvals = jgraph, jvals
        self.tgraph, self.tvals = tgraph, tvals
        self.js = JSolver(jgraph.bind(jvals), **kw)
        self.ts = SupernodalCholeskySolver(BoundGraph(tgraph, tvals, "cpu"),
                                           **kw)
        self._sys = None

    def systems(self):
        if self._sys is None:
            jb, jg = jax.jit(self.js.system)(self.jvals.arrays)
            tb, tg = self.ts.system(self.tvals.arrays)
            self._sys = (np.asarray(jb), np.asarray(jg), tb, tg)
        return self._sys


def _manhattan_graphs(path, poses=60, edges=150, seed=3):
    """The Manhattan-world file at `path`, loaded by both packages, with
    the prior on pose 0 at its loaded value."""
    _data_module().write_manhattan_graph(path, poses, edges, seed=seed)
    jg, jv = jdatasets.load_2d(path)
    jg.add(gt.prior_factors("SE2", [0], np.asarray(jv.at(0))[None],
                            gt.noise.sigmas(PRIOR_SIGMAS)))
    tg, tv = tdatasets.load_2d(path)
    tg.add(tfactors.prior_factors("SE2", [0], tv.at(0)[None].numpy(),
                                  tnoise.sigmas(PRIOR_SIGMAS)))
    return jg, jv, tg, tv


@pytest.fixture(scope="module")
def manhattan(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("w") / "manhattan.graph")
    jg, _, tg, _ = _manhattan_graphs(path)
    return Case(jg, jlago(jg), tg, initialize_pose2_lago(tg), **SN_KW)


def _mixed_parts(seed=5, n_pose=7, n_pt=6):
    """Numpy inputs of the SE2 + Point2 graph: a pose chain with a prior,
    and each landmark seen from two poses (pose-frame position, sigma
    0.1)."""
    rng = np.random.default_rng(seed)
    T = np.concatenate([rng.normal(size=(n_pose, 2)) * 3.0,
                        rng.uniform(-3, 3, size=(n_pose, 1))], 1)
    pts = rng.normal(size=(n_pt, 2)) * 4.0
    i = np.arange(n_pose - 1)
    Z = np.asarray(jse2.between(jnp.asarray(T[i]), jnp.asarray(T[i + 1])))
    op = np.array([k % n_pose for k in range(2 * n_pt)])
    ol = np.array([k // 2 for k in range(2 * n_pt)])
    z = np.asarray(jse2.transform_to(jnp.asarray(T[op]),
                                     jnp.asarray(pts[ol])))
    z = z + rng.normal(size=z.shape) * 0.1
    T0 = T + rng.normal(size=T.shape) * 0.05
    pts0 = pts + rng.normal(size=pts.shape) * 0.2
    return dict(Z=Z, op=op, ol=ol + 100, z=z, T0=T0, pts0=pts0,
                n_pose=n_pose, n_pt=n_pt)


def _mixed_case(**kw):
    p = _mixed_parts()
    n_pose = p["n_pose"]
    info = np.diag([100.0, 100.0, 400.0])
    keys = np.stack([p["op"], p["ol"]], 1)
    keys_pt = np.arange(p["n_pt"]) + 100
    jg, tg = JGraph(), FactorGraph()
    jg.add(jfactors.between_factors("SE2", np.arange(n_pose - 1),
                                    np.arange(1, n_pose), jnp.asarray(p["Z"]),
                                    jnoise.information(info)))
    jg.add(gt.prior_factors("SE2", [0], p["T0"][:1],
                            gt.noise.sigmas(PRIOR_SIGMAS)))
    jg.add(jfactors.custom_factors(
        "Obs", ("SE2", "Point2"), keys,
        lambda xs, m: jse2.transform_to(xs[0], xs[1]) - m, 2,
        jnp.asarray(p["z"]), jnoise.isotropic(2, 0.1)))
    tg.add(tfactors.between_factors("SE2", np.arange(n_pose - 1),
                                    np.arange(1, n_pose), p["Z"],
                                    tnoise.information(info)))
    tg.add(tfactors.prior_factors("SE2", [0], p["T0"][:1],
                                  tnoise.sigmas(PRIOR_SIGMAS)))
    tg.add(tfactors.custom_factors(
        "Obs", ("SE2", "Point2"), keys,
        lambda xs, m: se2.transform_to(xs[0], xs[1]) - m, 2, p["z"],
        tnoise.isotropic(2, 0.1)))
    jv = JValues({"SE2": jnp.asarray(p["T0"]),
                  "Point2": jnp.asarray(p["pts0"])},
                 {"SE2": np.arange(n_pose), "Point2": keys_pt})
    tv = Values({"SE2": _t(p["T0"]), "Point2": _t(p["pts0"])},
                {"SE2": np.arange(n_pose), "Point2": keys_pt})
    return Case(jg, jv, tg, tv, **kw)


@pytest.fixture(scope="module")
def mixed2d():
    return _mixed_case(force_width=1, max_width=2)


@pytest.fixture(params=["manhattan", "mixed2d"])
def case(request):
    return request.getfixturevalue(request.param)


# -- factors and kernel 6's Pose2 variant -------------------------------------


def _se2_parts(seed, n=10, N=16):
    """Seeded SE2 poses (n, 3), between rows i, j and measurements Z whose
    residual angles are +-0.006 .. 0.03 rad in the first half and +-0.2 ..
    0.5 rad in the second (residual translations ~0.3 m)."""
    rng = np.random.default_rng(seed)
    T = np.concatenate([rng.normal(size=(n, 2)) * 3.0,
                        rng.uniform(-3, 3, size=(n, 1))], 1)
    i = rng.integers(0, n, N)
    j = (i + 1 + rng.integers(0, n - 1, N)) % n
    ang = np.where(np.arange(N) < N // 2, rng.uniform(0.006, 0.03, N),
                   rng.uniform(0.2, 0.5, N)) * rng.choice([-1.0, 1.0], N)
    off = np.concatenate([rng.normal(size=(N, 2)) * 0.3, ang[:, None]], 1)
    E = jse2.between(jnp.asarray(T[i]), jnp.asarray(T[j]))
    Z = np.asarray(jse2.compose(E, jse2.expmap(-jnp.asarray(off))))
    Zp = np.asarray(jse2.compose(jnp.asarray(T[3:4]), jse2.expmap(
        jnp.asarray(rng.normal(size=(1, 3)) * 0.3))))
    return T, i, j, Z, Zp


def _spd(count, seed):
    A = np.random.default_rng(seed).normal(size=(count, 3, 3))
    return A @ A.transpose(0, 2, 1) + 3 * np.eye(3)


def _models(N):
    """(label, maker(noise module, factors)) of every noise kind kernel 6
    takes: unit, diagonal and gaussian, one model for the batch or one a
    factor, and constrained (shared and per factor)."""
    rng = np.random.default_rng(21)
    sig = rng.uniform(0.05, 2.0, size=(N, 3))
    info = _spd(N, 22)
    hard = sig.copy()
    hard[rng.random((N, 3)) < 0.3] = 0.0
    out = [("unit", lambda m, k: m.unit())]
    for scope, pick in (("shared", lambda a, k: a[:1]),
                        ("per-factor", lambda a, k: a[:k])):
        out += [(f"diagonal {scope}",
                 lambda m, k, pick=pick: m.sigmas(pick(sig, k))),
                (f"gaussian {scope}",
                 lambda m, k, pick=pick: m.information(pick(info, k))),
                (f"constrained {scope}",
                 lambda m, k, pick=pick: m.constrained(pick(hard, k)))]
    return out


def _check_kernel6_plain(jg, tg, tv, T, near_cut):
    """Kernel 6's Pose2 plain versions on graphs jg / tg at poses T: the
    bound graph's error (pg2_error_plain) against the JAX bound graph's at
    1e-12; per batch pg2_jacobians_plain's A and b against
    jfactors.linearize, and the H and gv blocks pg2_linearize_plain writes
    (store width 5: zero past the leading 3x3; sign -1; the (0, 1) block
    transposed where flip says so) against the same products of the JAX
    Jacobians, at 1e-12 relative to the largest entry, but 1e-11 for the
    first `near_cut` between factors (residual angles of 0.006-0.03 rad):
    jacfwd differentiates logmap's closed form, whose cancellation in
    1 - cos w costs ~eps / w^2 (6e-12 at 0.006 rad), where the plain
    versions take Jr^-1's series."""
    jv = JValues({"SE2": jnp.asarray(T)}, {"SE2": np.arange(len(T))})
    tb = BoundGraph(tg, tv, "cpu")
    _close(tb.error(tv.arrays), jg.bind(jv).error(jv.arrays), 1e-12)
    x = tv.arrays["SE2"]
    for jbatch, b, st in zip(jg.batches, tg.batches, tb.structures):
        assert tfactors.kernel_route(b) == ("SE2", "between" if b.arity == 2
                                            else "prior")
        rows = st.rows_i32
        jxs = tuple(jnp.asarray(T[rows[:, s].numpy()])
                    for s in range(b.arity))
        jA, jbv = jfactors.linearize(jbatch, jxs)
        jA = [np.asarray(a) for a in jA]
        la = tlosses.kernel_code(b.noise.loss)
        args = (x, rows, b.measurements, b.noise.kind, b.noise.data)
        A, bv = K.pg2_jacobians_plain(*args, *la)
        M = b.num_factors
        cut = near_cut if b.arity == 2 else 0

        def close(got, ref):
            if cut:
                _close(got[:cut], ref[:cut], 1e-11)
            _close(got[cut:], ref[cut:], 1e-12)
        for a, ja in zip(A, jA):
            close(a.numpy(), ja)
        _close(bv, jbv, 1e-12)
        d = 5
        fl = torch.as_tensor(np.arange(M) % 3 == 1) if b.arity == 2 \
            else torch.zeros(M, dtype=torch.bool)
        npair = 3 if b.arity == 2 else 1
        H = torch.full((M, npair, d * d), np.nan, dtype=torch.float64)
        gv = torch.full((M, b.arity, d), np.nan, dtype=torch.float64)
        K.pg2_linearize_plain(*args, -1.0, fl, H, gv, *la)
        H, gv = H.view(M, npair, d, d).numpy(), gv.numpy()
        for p, (s1, s2) in enumerate(K._pair_slots(b.arity)):
            ref = -np.einsum("nri,nrj->nij", jA[s1], jA[s2])
            if s1 != s2:
                ref = np.where(fl.numpy()[:, None, None],
                               ref.transpose(0, 2, 1), ref)
            close(H[:, p, :3, :3], ref)
        for s in range(b.arity):
            close(gv[:, s, :3], -np.einsum("nrd,nr->nd", jA[s],
                                           np.asarray(jbv)))
        assert not H[:, :, 3:].any() and not H[:, :, :, 3:].any()
        assert not gv[:, :, 3:].any()


@pytest.mark.parametrize("model", range(7), ids=[m for m, _ in _models(1)])
def test_kernel6_pose2_plain_under_each_noise_kind(model):
    """Kernel 6's Pose2 plain versions against the JAX package on a seeded
    graph of SE2 between factors and a prior, under each noise kind
    (_check_kernel6_plain)."""
    T, i, j, Z, Zp = _se2_parts(31)
    N = len(i)
    _, mk = _models(N)[model]
    jg, tg = JGraph(), FactorGraph()
    jg.add(jfactors.between_factors("SE2", i, j, jnp.asarray(Z),
                                    mk(jnoise, N)))
    jg.add(gt.prior_factors("SE2", [3], Zp, mk(jnoise, 1)))
    tg.add(tfactors.between_factors("SE2", i, j, Z, mk(tnoise, N)))
    tg.add(tfactors.prior_factors("SE2", [3], Zp, mk(tnoise, 1)))
    tv = Values({"SE2": _t(T)}, {"SE2": np.arange(len(T))})
    _check_kernel6_plain(jg, tg, tv, T, N // 2)


@pytest.mark.parametrize("name", sorted(tlosses.LOSSES))
def test_kernel6_pose2_plain_with_each_loss(name):
    """Kernel 6's Pose2 plain versions with each loss (code and parameter
    as the wrappers take them; gaussian base, one model a factor, and a
    diagonal prior) against the JAX package (_check_kernel6_plain); the
    loss's parameter is the median whitened norm of the between batch (for
    dcs its square), so both branches run."""
    T, i, j, Z, Zp = _se2_parts(32)
    N = len(i)
    info = _spd(N, 33)
    plain = tfactors.between_factors("SE2", i, j, Z,
                                     tnoise.information(info))
    d = torch.linalg.norm(plain.noise.whiten(tfactors.residuals(
        plain, (_t(T[i]), _t(T[j])))), dim=-1)
    med = float(torch.median(d))
    param = None if name == "null" else (med * med if name == "dcs"
                                         else med)

    def mk(mod):
        fn = mod.LOSSES[name]
        return fn() if param is None else fn(param)
    sig = [[0.2, 0.3, 0.1]]
    jg, tg = JGraph(), FactorGraph()
    jg.add(jfactors.between_factors("SE2", i, j, jnp.asarray(Z),
                                    jnoise.robust(jnoise.information(info),
                                                  mk(jlosses))))
    jg.add(gt.prior_factors("SE2", [3], Zp, jnoise.robust(
        jnoise.sigmas(sig), mk(jlosses))))
    tg.add(tfactors.between_factors("SE2", i, j, Z, tnoise.robust(
        tnoise.information(info), mk(tlosses))))
    tg.add(tfactors.prior_factors("SE2", [3], Zp, tnoise.robust(
        tnoise.sigmas(sig), mk(tlosses))))
    tv = Values({"SE2": _t(T)}, {"SE2": np.arange(len(T))})
    _check_kernel6_plain(jg, tg, tv, T, N // 2)


def test_between_and_prior_residuals_and_generic_linearization():
    """SE2 between and prior batches: residuals at 1e-13 and the generic
    linearization (torch.func's jacfwd against jax.jacfwd of the same
    formulas) at 1e-12, and slice_batch and custom_factors on SE2: a slice
    keeps the rows' measurements and per-factor noise; a custom SE2 between
    residual equals the built-in batch's."""
    T, i, j, Z, Zp = _se2_parts(34)
    N = len(i)
    sig = np.random.default_rng(35).uniform(0.1, 1.0, size=(N, 3))
    jb = jfactors.between_factors("SE2", i, j, jnp.asarray(Z),
                                  jnoise.sigmas(sig))
    tb = tfactors.between_factors("SE2", i, j, Z, tnoise.sigmas(sig))
    jp = gt.prior_factors("SE2", [3], Zp, gt.noise.sigmas(sig[:1]))
    tp = tfactors.prior_factors("SE2", [3], Zp, tnoise.sigmas(sig[:1]))
    for jbat, tbat, rows in ((jb, tb, (i, j)), (jp, tp, ([3],))):
        jxs = tuple(jnp.asarray(T[r]) for r in rows)
        txs = tuple(_t(T[r]) for r in rows)
        _close(tfactors.residuals(tbat, txs), jfactors.residuals(jbat, jxs),
               1e-13)
        (tA, tbv), (jA, jbv) = (tfactors.linearize(tbat, txs),
                                jfactors.linearize(jbat, jxs))
        for a, ja in zip(tA, jA):
            _close(a, ja, 1e-12)
        _close(tbv, jbv, 1e-12)
    sl = tfactors.slice_batch(tb, [5, 2])
    np.testing.assert_array_equal(sl.keys, tb.keys[[5, 2]])
    assert torch.equal(sl.measurements, tb.measurements[[5, 2]])
    assert torch.equal(sl.noise.data, tb.noise.data[[5, 2]])
    cu = tfactors.custom_factors(
        "Mine", ("SE2", "SE2"), np.stack([i, j], 1),
        lambda xs, m: se2.local(m, se2.between(xs[0], xs[1])), 3, Z,
        tnoise.sigmas(sig))
    assert tfactors.kernel_route(cu) is None
    txs = (_t(T[i]), _t(T[j]))
    _close(tfactors.residuals(cu, txs), tfactors.residuals(tb, txs), 1e-15)
    _close(tfactors.linearize(cu, txs)[0][0], tfactors.linearize(tb, txs)[0][0],
           1e-15)


# -- the supernodal solver at d = 3 --------------------------------------------


def test_system(case):
    """The block store and gradient against the JAX package's: kernel 6's
    Pose2 plain version against jacfwd (SE2 batches), the generic torch.func
    path (landmark factors), the same sorted sums; 1e-12 relative to the
    largest entry for the blocks, 1e-11 for g (J^T r carries jacfwd's
    ~eps / w^2 at the residuals' small angles)."""
    jb, jg, tb, tg = case.systems()
    assert case.ts.d == 3
    _close(tb, jb, 1e-12)
    _close(tg, jg, 1e-11)
    assert torch.all(tb[-1] == 0)


@pytest.mark.parametrize("damping", ["lambda", "diagonal"])
def test_factorize_per_level_at_odd_widths(case, damping):
    """Each level's L and Lp, and ok / badcol, against the JAX package's at
    1e-10 (Cholesky factors of the same fronts summed in another order, at
    lam 1e-2), on plans at d = 3 whose levels include odd W*d and odd R*d
    (the widths kernels 7 and 8 take on the card); the store stays 3 wide
    (9 doubles a block)."""
    jb, _, tb, _ = case.systems()
    s = case.ts
    assert s.d == 3 and tb.shape[1] == 9
    widths = [(lp.W * 3, lp.R * 3) for lp in s.level_plans]
    assert any(w % 2 for w, _ in widths) and any(r % 2 for _, r in widths)
    dd = damping == "diagonal"
    _, jL, jP, jok, jbad = jax.jit(case.js.factorize, static_argnums=2)(
        jnp.asarray(jb), 1e-2, dd)
    f = s.factorize(tb, 1e-2, dd)
    assert bool(f.ok) and bool(jok) and int(f.badcol) == int(jbad) == -1
    assert len(f.Ldiag) == len(jL)
    for a, b, c, e in zip(f.Ldiag, jL, f.Lpanel, jP):
        assert a.shape[1] % 3 == 0
        _close(a, b, 1e-10)
        assert (c is None) == (e is None)
        if c is not None:
            _close(c, e, 1e-10)


def test_solves_and_matvec(case):
    """Kernel 8's plain forward and backward (_solve_padded) against the
    JAX package's at lam 1e-3 and 1 (1e-9: the system's condition number
    times eps), solve_refined at 1e-3 (1e-9), and kernel 9's plain matvec
    at 1e-12 (the same sums in the same order)."""
    jb, jg, tb, tg = case.systems()
    s, js, lam = case.ts, case.js, 1e-3

    def jax_solves(b, g, lam_s):
        f = js.factorize(b, lam_s, False)
        return (js._solve_padded(f, g),
                js.solve_refined(b, g, lam, False, refine_iters=1))

    jsolve = jax.jit(jax_solves)
    for lam_s in (1.0, lam):
        jx, jdx = jsolve(jnp.asarray(jb), jnp.asarray(jg), lam_s)
        _close(s._solve_padded(s.factorize(tb, lam_s, False), tg), jx, 1e-9)
    dx, ok = s.solve_refined(tb, tg, lam, False, refine_iters=1)
    assert bool(ok)
    _close(dx, jdx, 1e-9)
    x = np.random.default_rng(6).normal(size=(s.nvars, s.d)) * (
        1.0 - s.pad_diag)
    jmv = jax.jit(js.matvec, static_argnums=3)
    _close(s.matvec(tb, _t(x), 0.3, True),
           jmv(jnp.asarray(jb), jnp.asarray(x), 0.3, True), 1e-12)


def test_graph_error_gradient_and_cpu_path_launches_nothing(case):
    """The bound graph's error (kernel 6's Pose2 plain error for SE2
    batches) and gradient against the JAX package's at 1e-12 (the gradient
    1e-11, for test_system's reason); the CPU path counts no kernel
    launch."""
    _kernels.reset_launch_counts()
    tb = BoundGraph(case.tgraph, case.tvals, "cpu")
    jbd = case.jgraph.bind(case.jvals)
    _close(tb.error(case.tvals.arrays), jbd.error(case.jvals.arrays), 1e-12)
    _close(tb.gradient(case.tvals.arrays), jbd.gradient(case.jvals.arrays),
           1e-11)
    case.ts.solve_refined(*case.systems()[2:], 1e-3, False, 1)
    assert all(n == 0 for n in _kernels.launch_counts().values())


# -- initialization, input, output ---------------------------------------------


def test_lago_against_jax(manhattan):
    """initialize_pose2_lago's poses and keys equal the JAX package's at
    1e-12 (the same sparse LU solves on the host; the orientations' 2 pi
    corrections from the same spanning tree)."""
    tv, jv = manhattan.tvals, manhattan.jvals
    np.testing.assert_array_equal(tv.keys["SE2"], jv.keys["SE2"])
    _close(tv.arrays["SE2"], jv.arrays["SE2"], 1e-12)
    with pytest.raises(ValueError):
        initialize_pose2_lago(FactorGraph())


def _edge_rows(tag, layout_values, n=5, seed=40):
    rng = np.random.default_rng(seed)
    lines = [f"VERTEX2 {k} {v[0]} {v[1]} {v[2]}"
             for k, v in enumerate(rng.normal(size=(n - 1, 3)))]
    for k in range(n - 1):
        m = rng.normal(size=3)
        lines.append(f"{tag} {k} {k + 1} {m[0]} {m[1]} {m[2]} "
                     + " ".join(map(str, layout_values)))
    m = rng.normal(size=3)
    lines.append(f"{tag} 0 {n - 1} {m[0]} {m[1]} {m[2]} "
                 + " ".join(map(str, layout_values)))
    return lines


LAYOUTS = {
    # EDGE2 with a TORO-layout covariance (auto-detected "graph")
    "edge2_toro_covariance": ("EDGE2", [0.01, 0.0, 0.04, 0.0025, 0.0, 0.0]),
    # EDGE_SE2 with a g2o information (upper triangle, full)
    "edge_se2_g2o_information": ("EDGE_SE2", [50.0, 2.0, 1.0, 40.0, -3.0,
                                              300.0]),
    # EDGE2 in the auto "cov" layout (upper triangle, diagonal)
    "edge2_auto_cov": ("EDGE2", [0.02, 0.0, 0.0, 0.03, 0.0, 0.001]),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_load_2d(tmp_path, layout):
    """Keys, measurements, square-root informations and initial poses
    (the vertices, and a pose without one composed from its odometry)
    equal the JAX package's: the same parse and information rule
    (covariance inverted for the auto layouts, information kept for g2o),
    the Cholesky of each information in LAPACK on both sides: 1e-13."""
    tag, vals = LAYOUTS[layout]
    path = str(tmp_path / "g.graph")
    with open(path, "w") as f:
        f.write("\n".join(_edge_rows(tag, vals)) + "\n")
    jg, jv = jdatasets.load_2d(path)
    tg, tv = tdatasets.load_2d(path)
    (jb,), (tb,) = jg.batches, tg.batches
    np.testing.assert_array_equal(tb.keys, jb.keys)
    _close(tb.measurements, jb.measurements, 1e-13)
    assert tb.noise.kind == jb.noise.kind == "gaussian"
    _close(tb.noise.data, jb.noise.data, 1e-13)
    np.testing.assert_array_equal(tv.keys["SE2"], jv.keys["SE2"])
    _close(tv.arrays["SE2"], jv.arrays["SE2"], 1e-13)
    info = tb.noise.data[0].mT @ tb.noise.data[0]
    M = tdatasets._info2d_from_vector(vals, {"EDGE2": "auto"}.get(tag, "g2o"))
    _close(info, M, 1e-12)
    if tag == "EDGE2":   # a covariance: the information is its inverse
        _close(info @ _t(np.linalg.inv(M)), np.eye(3), 1e-12)


def test_load_2d_refuses(tmp_path):
    """An unrecognized auto layout raises ValueError as the JAX package's
    does.  BR and LANDMARK rows, which the port refused until
    sam/factors.py::bearing_range_2d_factors was ported, now load as the
    JAX package loads them (one bearing-range batch, the landmark's
    initial from its sighting), never skipped in silence."""
    path = str(tmp_path / "bad.graph")
    with open(path, "w") as f:
        f.write("\n".join(_edge_rows("EDGE2", [1.0, 0.1, 1.0, 1.0, 0.0,
                                               0.0])) + "\n")
    for load in (jdatasets.load_2d, tdatasets.load_2d):
        with pytest.raises(ValueError, match="unrecognized"):
            load(path)
    for row in ("BR 0 7 0.3 5.0 0.01 0.1", "LANDMARK 0 7 3.0 4.0 1 0 1"):
        with open(path, "w") as f:
            f.write("\n".join(_edge_rows("EDGE2", [0.01, 0, 0.01, 0.001, 0,
                                                   0]) + [row]) + "\n")
        tg, tv = tdatasets.load_2d(path)
        jg, jv = jdatasets.load_2d(path)
        assert [b.name for b in tg.batches] == [b.name for b in jg.batches]
        assert tg.batches[-1].name == "BearingRange2D"
        assert np.array_equal(tv.keys["Point2"], jv.keys["Point2"])
        _close(tv.arrays["Point2"], jv.arrays["Point2"], 1e-12)
        _close(tg.error(tv), jg.error(jv), 1e-12)


def test_write_g2o_and_read_back(tmp_path, manhattan):
    """write_g2o writes the JAX package's text for the same graph and values
    (SE2 and SE3 vertices, SE2 edges), and read_g2o reads back the keys,
    measurements and poses it wrote (exactly: repr-precise numbers)."""
    from gtsam_tpu.geometry.se3 import SE3 as JSE3
    from gtsam_torch.geometry.se3 import SE3 as TSE3
    rng = np.random.default_rng(41)
    A = np.linalg.qr(rng.normal(size=(2, 3, 3)))[0]
    R = A * np.sign(np.linalg.det(A))[:, None, None]
    t = rng.normal(size=(2, 3))
    x = manhattan.tvals.arrays["SE2"].numpy()
    keys = manhattan.tvals.keys["SE2"]
    tv = Values({"SE2": _t(x), "SE3": TSE3(_t(R), _t(t))},
                {"SE2": keys, "SE3": np.array([900, 901])})
    jv = JValues({"SE2": jnp.asarray(x), "SE3": JSE3(jnp.asarray(R),
                                                     jnp.asarray(t))},
                 {"SE2": keys, "SE3": np.array([900, 901])})
    tpath, jpath = str(tmp_path / "t.g2o"), str(tmp_path / "j.g2o")
    tdatasets.write_g2o(tpath, manhattan.tgraph, tv)
    jdatasets.write_g2o(jpath, manhattan.jgraph, jv)
    assert open(tpath).read() == open(jpath).read()
    only2d = str(tmp_path / "2d.g2o")
    tdatasets.write_g2o(only2d, manhattan.tgraph, Values(
        {"SE2": _t(x)}, {"SE2": keys}))
    g, v = tdatasets.read_g2o(only2d)
    between = manhattan.tgraph.batches[0]
    np.testing.assert_array_equal(g.batches[0].keys, between.keys)
    assert torch.equal(g.batches[0].measurements, between.measurements)
    assert torch.equal(v.arrays["SE2"], _t(x))
    assert torch.equal(g.batches[0].noise.data[0],
                       torch.eye(3, dtype=torch.float64))
    q = tdatasets._to_quat_np(R[0])
    _close(q, jdatasets._to_quat_np(R[0]), 1e-15)


def test_find_example_data(tmp_path, monkeypatch):
    """find_example_data looks through _DATA_DIRS in order, as the JAX
    package's, and raises FileNotFoundError for a name it lacks."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    (tmp_path / "b" / "w.txt").write_text("x")
    dirs = ["", str(tmp_path / "a"), str(tmp_path / "b")]
    monkeypatch.setattr(tdatasets, "_DATA_DIRS", dirs)
    monkeypatch.setattr(jdatasets, "_DATA_DIRS", dirs)
    assert tdatasets.find_example_data("w.txt") == \
        jdatasets.find_example_data("w.txt") == str(tmp_path / "b" / "w.txt")
    with pytest.raises(FileNotFoundError):
        tdatasets.find_example_data("none.txt")


# -- the optimizers and GNC ------------------------------------------------------


def _lm_params(mod, policy="gain", maxit=20):
    return mod.LMParams(max_iterations=maxit, relative_error_tol=1e-9,
                        absolute_error_tol=1e-12, lambda_policy=policy)


@pytest.mark.parametrize("policy", ["gain", "gtsam"])
def test_make_fused_lm(manhattan, policy):
    """make_fused_lm (SparseSolver, one refinement pass) from LAGO's start
    against the JAX package's: iterations, tries and converged equal, the
    half-chi2 history at rtol 1e-9 (the JAX package refines in two-float
    pairs, the port in float64)."""
    p = dict(refine_iters=1, supernodal_kwargs=SN_KW)
    jfn = JO.make_fused_lm(manhattan.jgraph, manhattan.jvals,
                           _lm_params(gt, policy),
                           solver=JO.SparseSolver(**p))
    jit, _, jerr, jconv, jhist, jtries = jfn(manhattan.jvals.arrays)
    tfn = TO.make_fused_lm(manhattan.tgraph, manhattan.tvals,
                           _lm_params(TO, policy),
                           solver=TO.SparseSolver(**p), device="cpu")
    it, arrays, err, conv, hist, tries = tfn(manhattan.tvals.arrays)
    assert (it, tries, conv) == (int(jit), int(jtries), bool(jconv))
    assert it >= 2 and conv
    _close(hist[:it + 1], np.asarray(jhist)[:it + 1], 1e-9)
    assert abs(err - float(jerr)) <= 1e-9 * float(jerr)


def test_levenberg_marquardt_and_gauss_newton(mixed2d):
    """levenberg_marquardt with SparseSolver, and the dense gauss_newton,
    on the SE2 + Point2 graph against the JAX package's: iterations and
    the history at rtol 1e-9."""
    jres = JO.levenberg_marquardt(
        mixed2d.jgraph, mixed2d.jvals, _lm_params(gt, "gtsam"),
        solver=JO.SparseSolver(supernodal_kwargs=dict(force_width=2)))
    tres = TO.levenberg_marquardt(
        mixed2d.tgraph, mixed2d.tvals, _lm_params(TO, "gtsam"),
        solver=TO.SparseSolver(supernodal_kwargs=dict(force_width=2)),
        device="cpu")
    assert tres.iterations == jres.iterations and tres.converged
    _close(tres.history, jres.history, 1e-9)
    jres = JO.gauss_newton(mixed2d.jgraph, mixed2d.jvals, gt.OptimizerParams(
        max_iterations=10, relative_error_tol=1e-9))
    tres = TO.gauss_newton(mixed2d.tgraph, mixed2d.tvals, TO.OptimizerParams(
        max_iterations=10, relative_error_tol=1e-9), device="cpu")
    assert tres.iterations == jres.iterations
    _close(tres.history, jres.history, 1e-9)


def _se2_chain(side, seed=43, n=10, hard=False):
    """An SE2 chain with a prior (hard: constrained_all(3)), odometry and
    two closures, the second wrong (3 m and 1 rad off); (graph, values) of
    `side` ("t" or "j")."""
    rng = np.random.default_rng(seed)
    T = np.concatenate([np.cumsum(rng.normal(size=(n, 2)), 0),
                        rng.uniform(-1, 1, size=(n, 1))], 1)
    i = np.arange(n - 1)
    Z = np.asarray(jse2.between(jnp.asarray(T[i]), jnp.asarray(T[i + 1])))
    Z = Z + rng.normal(size=Z.shape) * 0.01
    ci, cj = np.array([0, 2]), np.array([5, 8])
    Zc = np.array(jse2.between(jnp.asarray(T[ci]), jnp.asarray(T[cj])))
    Zc[1] += [3.0, 0.0, 1.0]
    T0 = T + rng.normal(size=T.shape) * 0.05
    noise, fac = (tnoise, tfactors) if side == "t" else (jnoise, jfactors)
    g = FactorGraph() if side == "t" else JGraph()
    g.add(fac.prior_factors("SE2", [0], T[:1], noise.constrained_all(3)
                            if hard else noise.isotropic(3, 0.01)))
    g.add(fac.between_factors("SE2", i, i + 1, Z, noise.isotropic(3, 0.05)))
    g.add(fac.between_factors("SE2", ci, cj, Zc, noise.isotropic(3, 0.05)))
    if side == "t":
        return g, Values({"SE2": _t(T0)}, {"SE2": np.arange(n)})
    return g, JValues({"SE2": jnp.asarray(T0)}, {"SE2": np.arange(n)})


def test_gnc_tls_on_an_se2_chain():
    """GNC (TLS) on an SE2 chain with a right and a wrong closure against
    the JAX package's: the same weights (1e-9) and poses (1e-8 relative);
    the right closure kept and the wrong one rejected; _scale_noise at
    rdim 3 makes the (N, 3) diagonal kernel 6 takes."""
    tg, tv = _se2_chain("t")
    jg, jv = _se2_chain("j")
    p = dict(robust_batches=[2], max_iterations=8)
    jres = jgnc.gnc_optimize(jg, jv, jgnc.GncParams(**p))
    tres = tgnc.gnc_optimize(tg, tv, tgnc.GncParams(**p), device="cpu")
    (_, (jw,)), (_, (tw,)) = jres.history[-1], tres.history[-1]
    _close(tw, np.asarray(jw), 1e-9)
    assert tw[0] > 0.9 and tw[1] < 0.1
    assert abs(tres.error - jres.error) <= 1e-8 * max(jres.error, 1.0)
    _close(tres.values.arrays["SE2"], np.asarray(jres.values.arrays["SE2"]),
           1e-8)
    sc = tgnc._scale_noise(tnoise.isotropic(3, 0.05),
                           torch.tensor([0.25, 1.0], dtype=torch.float64), 3)
    assert sc.kind == "diagonal" and sc.data.shape == (2, 3)
    assert tfactors.kernel_route(tfactors.between_factors(
        "SE2", [0, 1], [1, 2], np.zeros((2, 3)), sc)) == ("SE2", "between")


def test_hard_prior_on_an_se2_chain():
    """A constrained_all(3) prior on an SE2 chain: constraint_system (C, c
    of the hard rows by the generic linearization), the error with its mu
    penalty (kernel 6's Pose2 plain error) and the gradient against the
    JAX package's at 1e-12; levenberg_marquardt (the dense KKT solve) and
    make_fused_lm (SparseSolver's augmented-Lagrangian passes) against the
    JAX package's at rtol 1e-9, the prior kept to 1e-9."""
    tg, tv = _se2_chain("t", hard=True)
    jg, jv = _se2_chain("j", hard=True)
    tb, jb = BoundGraph(tg, tv, "cpu"), jg.bind(jv)
    assert tb.num_constraints == jb.num_constraints == 3
    C, c = tb.constraint_system(tv.arrays)
    jC, jc = jb.constraint_system(jv.arrays)
    _close(C, jC, 1e-12)
    _close(c, jc, 1e-12)
    _close(tb.error(tv.arrays), jb.error(jv.arrays), 1e-12)
    _close(tb.gradient(tv.arrays), jb.gradient(jv.arrays), 1e-12)
    jres = JO.levenberg_marquardt(jg, jv, _lm_params(gt, "gtsam"))
    tres = TO.levenberg_marquardt(tg, tv, _lm_params(TO, "gtsam"),
                                  device="cpu")
    assert tres.iterations == jres.iterations
    _close(tres.history, jres.history, 1e-9)
    p = dict(refine_iters=1, supernodal_kwargs=dict(force_width=2))
    jfn = JO.make_fused_lm(jg, jv, _lm_params(gt), solver=JO.SparseSolver(**p))
    jit, _, jerr, _, jhist, jtries = jfn(jv.arrays)
    tfn = TO.make_fused_lm(tg, tv, _lm_params(TO),
                           solver=TO.SparseSolver(**p), device="cpu")
    it, arrays, err, _, hist, tries = tfn(tv.arrays)
    assert (it, tries) == (int(jit), int(jtries))
    _close(hist[:it + 1], np.asarray(jhist)[:it + 1], 1e-9)
    moved = se2.local(_t(tg.batches[0].measurements.numpy()),
                      arrays["SE2"][:1])
    assert float(torch.linalg.norm(moved)) <= 1e-9
