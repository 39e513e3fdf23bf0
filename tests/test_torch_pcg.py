"""Parity of gtsam_torch's PCG solvers (block-Jacobi and subgraph) with
gtsam_tpu's (CPU).

PCGSolver.system (g and the block-Jacobi diagonal) and the matvec, the CG
loop's iteration count and solution against the JAX package's while_loop,
the subgraph preconditioner's spanning tree and solve, and LM with each
solver, on the graphs of tests/test_torch_sparse.py.  The JAX side runs
float64 (tests/conftest.py turns x64 on), jitted; the torch side float64
on the CPU, where every kernel wrapper computes its plain PyTorch version.
Tolerances, each stated where it is used.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsam_tpu.linear.pcg import PCGSolver as JPCG
from gtsam_tpu.linear.pcg import SubgraphPCGSolver as JSubgraph
from gtsam_tpu.optimize import optimizers as JO

from gtsam_torch import _kernels
from gtsam_torch.base import noise as tnoise
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.linear import pcg as tpcg
from gtsam_torch.linear import sparse_kernels as K
from gtsam_torch.linear.pcg import PCGSolver, SubgraphPCGSolver
from gtsam_torch.optimize import optimizers as TO
from .test_torch_optimizers import _rel
from .test_torch_sparse import _bound, check_job_order
from .test_torch_sparse import graphs  # noqa: F401

SOLVERS = {"pcg": (JPCG, PCGSolver), "subgraph": (JSubgraph,
                                                  SubgraphPCGSolver)}
# the graphs of test_torch_sparse.py but the Manhattan world, whose SE2
# batches the SE2 + Point2 graph also has
GRAPHS = ["SE3", "SE2_Point2", "SE3_Point3"]
_JAX = {}


def _jax_system(graphs, name, kind):
    """The JAX solver of `kind` bound to graph `name` and its system
    (jitted), made once for the file."""
    if (name, kind) not in _JAX:
        jb, jv, _, _ = _bound(graphs, name)
        js = SOLVERS[kind][0]().bind(jb)
        _JAX[name, kind] = js, jax.jit(js.system)(jv.arrays)
    return _JAX[name, kind]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_loop(js, system, lam, subgraph):
    """The JAX package's CG loop (PCGSolver.solve, SubgraphPCGSolver.solve)
    with its iteration count and final r.r beside tol^2 max(g.g, 1e-300):
    (x, iterations, r.r, tol2)."""
    if subgraph:
        lin, g, _, tree = system

        def apply(r):
            return js._tree.solve_factored(tree, js._tree_pad(r))
    else:
        lin, g, diag = system
        dmax = js._dmax
        Minv = jnp.linalg.inv(diag + lam * jnp.eye(dmax, dtype=g.dtype))
        idx = jnp.asarray(js._nvar_offsets[:, None]
                          + np.arange(dmax)[None, :])
        valid = jnp.asarray(np.arange(dmax)[None, :]
                            < np.asarray(js._var_dims)[:, None])
        idx = jnp.where(valid, idx, 0)

        def apply(r):
            z = jnp.einsum("nij,nj->ni", Minv, jnp.where(valid, r[idx], 0.0))
            return jnp.zeros_like(r).at[idx].add(jnp.where(valid, z, 0.0))
    z0 = apply(g)
    tol2 = js.tol ** 2 * jnp.maximum(g @ g, 1e-300)

    def cond(s):
        return (s[1] @ s[1] > tol2) & (s[5] < js.max_iterations)

    def body(s):
        x, r, z, p, gamma, it = s
        Ap = js._matvec(lin, p, lam)
        alpha = gamma / jnp.maximum(p @ Ap, 1e-300)
        x, r = x + alpha * p, r - alpha * Ap
        z = apply(r)
        gn = r @ z
        return (x, r, z, z + gn / jnp.maximum(gamma, 1e-300) * p, gn,
                it + 1)

    s = jax.lax.while_loop(cond, body, (jnp.zeros_like(g), g, z0, z0,
                                        g @ z0, jnp.zeros((), jnp.int32)))
    return s[0], s[5], s[1] @ s[1], tol2


@pytest.mark.parametrize("name", GRAPHS)
def test_pcg_system_and_matvec(graphs, name):
    """PCGSolver.system and the matvec against the JAX package's: the
    block-Jacobi diagonal and (J^T J + lam) v (lam 0.3, a seeded v) at
    1e-12 (the same products summed in another order); g at 1e-10 on the
    SE3 and SE2 graphs, whose kernel-6 plain versions form the residual in
    closed form (test_torch_sparse.test_system's reason), 1e-12 else."""
    _, _, tb, tv = _bound(graphs, name)
    js, (jlin, jg, jdiag) = _jax_system(graphs, name, "pcg")
    ts = PCGSolver().bind(tb)
    pool, g, diag = ts.system(tv.arrays)
    assert _rel(g, jg) <= (1e-10 if name in ("SE3", "SE2") else 1e-12)
    assert _rel(diag, jdiag) <= 1e-12
    v = np.random.default_rng(4).normal(size=g.shape[0])
    jy = jax.jit(js._matvec)(jlin, jnp.asarray(v), 0.3)
    assert _rel(ts.matvec(pool, torch.as_tensor(v), 0.3), jy) <= 1e-12
    # the pool: rows past a factor's rdim and columns past a variable's
    # dimension are zero
    assert pool.shape == (ts._Q, ts._rmax, ts._dmax)


def _matvec_by_lanes(pool, p, plan, lam):
    """(J^T J + lam) p as kernel 15's matvec forms it, lane by lane: a warp
    a variable, its slots in chunks of K = 32 // S (S = max(rmax, dmax));
    lane (i, r) of the chunk's slot i forms row r of u_f, lane (i, c)
    component c of A_q^T u_f from lanes (i, k), and lane c adds the
    chunk's slots' components in slot order."""
    Q, rmax, dmax = pool.shape
    S = max(rmax, dmax)
    K = 32 // S
    A = pool.tolist()
    pv = p.tolist()
    vptr, vslot, slot_fac, fptr, slot_var, var_off, var_dim = (
        t.tolist() for t in plan)
    Ap = torch.zeros_like(p)
    for v in range(len(var_dim)):
        y = [0.0] * 32
        e1 = vptr[v + 1]
        for e0 in range(vptr[v], e1, K):
            u, w = [0.0] * 32, [0.0] * 32
            for lane in range(32):
                i, r = divmod(lane, S)
                if i < K and e0 + i < e1 and r < rmax:
                    f = slot_fac[vslot[e0 + i]]
                    for s in range(fptr[f], fptr[f + 1]):
                        o, ds = var_off[slot_var[s]], var_dim[slot_var[s]]
                        u[lane] += sum(A[s][r][c] * pv[o + c]
                                       for c in range(ds))
            for lane in range(32):
                i, r = divmod(lane, S)
                i0 = i if i < K else 0
                if i < K and e0 + i < e1 and r < dmax:
                    q = vslot[e0 + i]
                    for k in range(rmax):
                        w[lane] += A[q][k][r] * u[i0 * S + k]
            for lane in range(32):
                for k in range(min(K, e1 - e0)):
                    y[lane] += w[k * S + lane % S]
        o = var_off[v]
        for c in range(var_dim[v]):
            Ap[o + c] = lam * pv[o + c] + y[c]
    return Ap


@pytest.mark.parametrize("name", GRAPHS)
def test_matvec_warp_schedule(graphs, name):
    """Kernel 15's matvec schedule (_matvec_by_lanes) gives the plain
    version's (J^T J + lam) p at 1e-13 (the same products, the slots' sums
    in the plain version's order), also with a hub variable whose slots
    take several chunks (every slot of the first variable repeated)."""
    _, _, tb, tv = _bound(graphs, name)
    ts = PCGSolver().bind(tb)
    pool, g, _ = ts.system(tv.arrays)
    p = torch.as_tensor(np.random.default_rng(9).normal(size=g.shape[0]))
    plan = ts._mv_plan()
    st, ist = ts._state("cpu")
    ref = K.pcg_matvec_plain(pool, p, *plan, 0.3, torch.empty_like(p), st,
                             ist)
    assert _rel(_matvec_by_lanes(pool, p, plan, 0.3), ref) <= 1e-13
    vptr, vslot = plan[0], plan[1]
    S = max(pool.shape[1], pool.shape[2])
    hub = vslot[:int(vptr[1])].repeat(32 // S + 2)
    extra = len(hub) - int(vptr[1])
    plan2 = (torch.cat([vptr[:1], vptr[1:] + extra]),
             torch.cat([hub, vslot[int(vptr[1]):]])) + tuple(plan[2:])
    ref2 = K.pcg_matvec_plain(pool, p, *plan2, 0.3, torch.empty_like(p), st,
                              ist)
    assert _rel(_matvec_by_lanes(pool, p, plan2, 0.3), ref2) <= 1e-13


@pytest.mark.parametrize("kind", list(SOLVERS))
@pytest.mark.parametrize("name", GRAPHS)
def test_pcg_solve(graphs, name, kind):
    """solve() against the JAX loop at lam 1e-3 and 1.  Both stop at r.r <=
    tol^2 max(g.g, 1e-300) (tol 1e-9) or max_iterations; their dot products
    round differently, so near the tolerance the loops may stop an
    iteration or two apart (more with the subgraph preconditioner, whose
    tree solve at lam 1e-8 amplifies rounding): the counts are held to
    within 1 (block-Jacobi) or max(2, 5%) (subgraph), each loop's last r.r
    to its tol2, and x at 1e-6 of its largest entry (the condition number
    of the preconditioned system times the stopping residual)."""
    _, _, tb, tv = _bound(graphs, name)
    js, jsys = _jax_system(graphs, name, kind)
    ts = SOLVERS[kind][1]().bind(tb)
    tsys = ts.system(tv.arrays)
    loop = jax.jit(lambda s, lam: _jax_loop(js, s, lam, kind == "subgraph"))
    for lam in (1e-3, 1.0):
        jx, jit, jrr, jtol2 = loop(jsys, lam)
        x, ok = ts.solve(tsys, lam, False)
        it = ts.last_solve["iterations"]
        assert bool(ok)
        assert float(jrr) <= float(jtol2) or int(jit) == js.max_iterations
        slack = 1 if kind == "pcg" else max(2, math.ceil(0.05 * int(jit)))
        assert abs(it - int(jit)) <= slack, (it, int(jit))
        if kind == "pcg":
            # one launch a solve (kernel 16's loop), its done word read once
            assert ts.last_solve["reads"] == 1
            assert ts.last_solve["launched"] == it
        else:
            assert ts.last_solve["reads"] == max(1, math.ceil(
                it / tpcg.CHECK_EVERY))
            assert ts.last_solve["launched"] == min(
                ts.max_iterations, tpcg.CHECK_EVERY * ts.last_solve["reads"])
        assert _rel(x, jx) <= 1e-6, (lam, it, int(jit))


@pytest.mark.parametrize("name", GRAPHS)
def test_subgraph_tree(graphs, name):
    """The spanning tree: every unary row and the binary rows that join two
    DSF components, in batch order, row for row the JAX package's; its
    level plan the same."""
    _, _, tb, _ = _bound(graphs, name)
    js, ts = _jax_system(graphs, name, "subgraph")[0], \
        SubgraphPCGSolver().bind(tb)
    jt, tt = js._tree.bound.graph.batches, ts._tree.bound.graph.batches
    assert [b.name for b in tt] == [b.name for b in jt]
    assert all(np.array_equal(a.keys, b.keys) for a, b in zip(tt, jt))
    assert (ts._tree.L_cut, ts._tree.n_tail) == (js._tree.L_cut,
                                                 js._tree.n_tail)
    # a spanning forest: one tree row per variable less the components
    n_bin = sum(b.num_factors for b in tt if b.arity == 2)
    assert n_bin <= ts._nv - 1


@pytest.mark.parametrize("name", GRAPHS)
def test_subgraph_tree_kernel14_plan(graphs, name):
    """The tree solver's kernel 14 plan keeps its precondition
    (test_torch_sparse.check_job_order: level pointers that partition the
    jobs, every source row from an earlier level), and a tree solve is
    one kernel 14 launch a direction, so a CG iteration launches the
    matvec, UPDATE, FINISH, DIRECTION and the tree solve's 2 + 2 (+ 2
    fills of kernel 11's outputs with a dense root)."""
    _, _, tb, _ = _bound(graphs, name)
    tree = SubgraphPCGSolver().bind(tb)._tree
    check_job_order(tree)
    sv = tree.launches_per_solve()
    assert sv["sp_level_forward"] == sv["sp_level_backward"] == 1
    assert sv["dense_forward"] == sv["dense_backward"] == int(
        tree.n_tail > 0)
    assert 4 + sum(sv.values()) <= 8


def test_subgraph_matches_dense(graphs):
    """The subgraph PCG solve (tol 1e-10) against the JAX package's dense
    solve of the same normal equations at lam 1e-3, at 1e-6 of the step's
    largest entry (tests/test_linear.py's check)."""
    jb, jv, tb, tv = _bound(graphs, "SE2_Point2")
    H, grad = jax.jit(jb.gn_system)(jv.arrays)
    dx = JO._dense_solve(H, grad, 1e-3, False)
    ts = SubgraphPCGSolver(tol=1e-10).bind(tb)
    x, _ = ts.solve(ts.system(tv.arrays), 1e-3, False)
    scale = float(jnp.abs(dx).max())
    assert float(np.abs(x.numpy() - np.asarray(dx)).max()) <= \
        1e-6 * max(scale, 1.0)


@pytest.mark.parametrize("kind", list(SOLVERS))
@pytest.mark.parametrize("name", ["SE2_Point2"])
def test_lm(graphs, name, kind):
    """levenberg_marquardt with each PCG solver against the JAX package's:
    the same iterations, the history at 1e-8 (each step a CG solve to tol
    1e-9, so the steps agree to ~1e-9 and the errors closer)."""
    jg, jv, tg, tv = graphs[name]
    J, T = SOLVERS[kind]
    p = dict(max_iterations=8, relative_error_tol=1e-9,
             absolute_error_tol=1e-12)
    ref = JO.levenberg_marquardt(jg, jv, JO.LMParams(**p), solver=J())
    _kernels.reset_launch_counts()
    got = TO.levenberg_marquardt(tg, tv, TO.LMParams(**p), solver=T(),
                                 device="cpu")
    assert all(n == 0 for n in _kernels.launch_counts().values())
    assert got.iterations == ref.iterations
    assert _rel(got.history, ref.history) <= 1e-8


def test_refusals(graphs):
    """Hard (sigma == 0) rows and anti-factor batches are refused at bind
    by both solvers (the JAX package refuses the former; its PCG would sum
    the latter's information with a positive sign)."""
    _, _, tg, tv = graphs["SE2"]
    hard = FactorGraph(list(tg.batches))
    hard.add(tfactors.prior_factors("SE2", [1], tv.at(1)[None].numpy(),
                                    tnoise.constrained_all(3)))
    anti = FactorGraph(list(tg.batches) + [dataclasses.replace(
        tg.batches[0], sign=-1.0)])
    for T in (PCGSolver, SubgraphPCGSolver):
        with pytest.raises(NotImplementedError, match="constrained"):
            T().bind(BoundGraph(hard, tv, "cpu"))
        with pytest.raises(NotImplementedError, match="anti-factor"):
            T().bind(BoundGraph(anti, tv, "cpu"))


def test_done_word(graphs):
    """The loop stops exactly at max_iterations (a tolerance never met):
    the block-Jacobi solve in one launch, its done word read once, the
    iterations it ran; max_iterations 0 leaves x at 0; the steps are
    diagonal-damping-free."""
    _, _, tb, tv = _bound(graphs, "SE3")
    ts = PCGSolver(max_iterations=37, tol=1e-300).bind(tb)
    system = ts.system(tv.arrays)
    x, _ = ts.solve(system, 1e-3, False)
    assert ts.last_solve == {"iterations": 37, "reads": 1, "launched": 37}
    x2, _ = ts.solve(system, 1e-3, True)
    assert torch.equal(x, x2)
    ts.max_iterations = 0
    x0, _ = ts.solve(system, 1e-3, False)
    assert ts.last_solve == {"iterations": 0, "reads": 1, "launched": 0}
    assert bool((x0 == 0).all())


def _phase_sequence(ts, system, lam, subgraph, max_it):
    """The CG loop as separate plain calls of kernels 15 and 16, a phase a
    call, in the order of a host loop that launches a phase a call (the
    done word read after every iteration): (x, r, z, p, st, ist)."""
    pool, g, diag = system[:3]
    st, ist = ts._state("cpu")
    x, r, z, p, Ap = (torch.empty_like(g) for _ in range(5))
    Minv = torch.empty_like(diag)
    pl, mv = ts._plan, ts._mv_plan()

    def step(phase, first=False):
        K.pcg_step_plain(phase, diag, Minv, g, x, r, z, p, Ap, pl["var_off"],
                         pl["var_dim"], lam, ts.tol, max_it, not subgraph,
                         first, st, ist)

    def precondition():
        ts._tree.solve_factored(system[3], r, ts._tree.dev.map_canon, ist,
                                out=z)

    step(K.INIT)
    if subgraph:
        precondition()
        step(K.FINISH, first=True)
        step(K.DIRECTION)
    while not int(ist[K.DONE]):
        K.pcg_matvec_plain(pool, p, *mv, lam, Ap, st, ist)
        step(K.UPDATE)
        if subgraph:
            precondition()
            step(K.FINISH)
        step(K.DIRECTION)
    return x, r, z, p, st, ist


@pytest.mark.parametrize("kind", list(SOLVERS))
@pytest.mark.parametrize("max_it", [0, 7, 500])
def test_loop_matches_phases(graphs, kind, max_it):
    """Kernel 16's loop (pcg_loop: block-Jacobi's whole solve in one call,
    the subgraph's [MATVEC, UPDATE] and [FINISH, DIRECTION] groups around
    the tree solve) gives the bits of the phases called one by one, in
    x, r, z, p and the state, at lam 1e-3: max_iterations 0 (done at INIT),
    7 (stopped by the count) and 500 (stopped by the tolerance)."""
    _, _, tb, tv = _bound(graphs, "SE3_Point3")
    ts = SOLVERS[kind][1](max_iterations=max_it).bind(tb)
    system = ts.system(tv.arrays)
    seen = {}
    group = K.pcg_loop

    def spy(bits, loop, pool, diag, Minv, g, x, r, z, p, *rest):
        seen.update(x=x, r=r, z=z, p=p, st=rest[-2], ist=rest[-1])
        return group(bits, loop, pool, diag, Minv, g, x, r, z, p, *rest)

    K.pcg_loop = spy
    try:
        x, _ = ts.solve(system, 1e-3, False)
    finally:
        K.pcg_loop = group
    ref = _phase_sequence(ts, system, 1e-3, kind == "subgraph", max_it)
    got = (x, seen["r"], seen["z"], seen["p"], seen["st"], seen["ist"])
    # z: the tree solve's output, never written where INIT stops the loop
    keep = [k for k in range(6)
            if k != 2 or kind == "pcg" or max_it > 0]
    assert all(torch.equal(got[k], ref[k]) for k in keep)
    it = int(ref[5][K.IT])
    assert ts.last_solve["iterations"] == it
    assert (it == max_it) == (max_it < 500)


def test_loop_refuses_a_loop_without_update(graphs):
    """A looping group without UPDATE would never stop: refused on the CPU
    and before any launch on the card."""
    _, _, tb, tv = _bound(graphs, "SE3")
    ts = PCGSolver().bind(tb)
    pool, g, diag = ts.system(tv.arrays)
    st, ist = ts._state("cpu")
    vecs = [torch.zeros_like(g) for _ in range(6)]
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in (pool, diag, diag, *vecs,
                                    *ts._mv_plan())]
        with pytest.raises(ValueError, match="needs UPDATE"):
            K.pcg_loop(K.G_MATVEC | K.G_DIRECTION, True, *args, 1e-3, 1e-9,
                       10, True, False, st.to(dev), ist.to(dev))


def test_loop_bits_match_the_source():
    """pcg_loop's phase bits are kernel 16's (csrc/pcg.cu kBit*)."""
    import re
    from gtsam_torch import _build
    src = (_build.CSRC / "pcg.cu").read_text()
    bits = dict(re.findall(r"kBit(\w+) = (\d+)", src))
    assert {k: int(v) for k, v in bits.items()} == {
        "Init": K.G_INIT, "Matvec": K.G_MATVEC, "Update": K.G_UPDATE,
        "Finish": K.G_FINISH, "Direction": K.G_DIRECTION}
