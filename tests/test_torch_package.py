"""Rules of the gtsam_torch package: it never imports JAX or gtsam_tpu, its
entry points run on CUDA unless asked for the CPU and raise without CUDA,
and its kernel wrappers check what they launch on and never fall back to
the plain version for a tensor that is not on the CPU."""

import os
import re
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import gtsam_torch
from gtsam_torch import _build, _kernels, config, native
from gtsam_torch.geometry.se3 import SE3
from gtsam_torch.graph import factors as tfactors
from gtsam_torch.graph.graph import BoundGraph, FactorGraph
from gtsam_torch.graph.values import Values
from gtsam_torch.linear import (dense_blocked, dense_kernels, sparse_kernels,
                                supernodal_kernels)
from gtsam_torch.linear.pcg import PCGSolver, SubgraphPCGSolver
from gtsam_torch.linear.sparse import SparseCholeskySolver
from gtsam_torch.linear.supernodal import SupernodalCholeskySolver
from gtsam_torch.optimize import optimizers
from gtsam_torch.sfm import ba, ba_kernels, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_imports_neither_jax_nor_gtsam_tpu():
    code = """
import pkgutil, sys
for name in [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gtsam_tpu')]:
    del sys.modules[name]
for name in ('jax', 'jaxlib', 'gtsam_tpu'):
    sys.modules[name] = None          # any import of them now raises
import gtsam_torch
mods = [m.name for m in pkgutil.walk_packages(gtsam_torch.__path__, 'gtsam_torch.')]
for m in mods:
    __import__(m)
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gtsam_tpu')
       and sys.modules[m] is not None]
print(len(mods), bad)
assert not bad
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n_mods = int(out.stdout.split()[0])
    assert n_mods == len(list(pkgutil.walk_packages(gtsam_torch.__path__,
                                                    "gtsam_torch.")))
    assert n_mods >= 10


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = synthetic.make_bal_problem(6, 40, 3, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ba.ba_optimize(prob)
    with pytest.raises(RuntimeError, match="CUDA"):
        ba.state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                            prob.points)
    assert config.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert config.resolve_device() == torch.device("cuda")
    assert config.default_dtype() == torch.float64


def test_working_dtype():
    """BA's Jacobians and S may be float64 or float32; nothing else, and
    float32 only in the mixed-precision mode."""
    assert config.working_dtype() == torch.float64
    assert config.working_dtype(torch.float32) == torch.float32
    with pytest.raises(ValueError, match="working dtype"):
        config.working_dtype(torch.float16)
    prob = synthetic.make_bal_problem(6, 40, 3, seed=0)
    with pytest.raises(ValueError, match="mixed_precision"):
        ba.ba_optimize(prob, device="cpu", dtype=torch.float32)
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cpu")
    K = prob.num_observations
    with pytest.raises(ValueError, match="mixed_precision"):
        ba.schur_solve(plan, torch.zeros((K, 2, 9), dtype=torch.float32),
                       torch.zeros((K, 2, 3), dtype=torch.float32),
                       torch.zeros((K, 2), dtype=torch.float64), 1e-4)


def test_cpu_path_counts_no_launch():
    """BA (both modes) and the pose-graph LM (the supernodal and the
    level-scheduled Cholesky, PCG, the subgraph preconditioner) on the CPU
    launch no kernel; the launch counts cover every kernel table."""
    prob = synthetic.make_bal_problem(6, 40, 3, seed=0)
    _kernels.reset_launch_counts()
    _, info = ba.ba_optimize(prob, device="cpu")
    assert np.isfinite(info["error"])
    _, info = ba.ba_optimize(prob, device="cpu", dtype=torch.float32,
                             mixed_precision=True)
    assert np.isfinite(info["error"])
    graph, vals = _small_pose_graph()
    fn = optimizers.make_fused_lm(
        graph, vals, optimizers.LMParams(max_iterations=3),
        solver=optimizers.SparseSolver(refine_iters=1), device="cpu")
    assert np.isfinite(fn(vals.arrays)[2])
    for solver in (optimizers.SparseSolver(method="levels"), PCGSolver(),
                   SubgraphPCGSolver()):
        res = optimizers.levenberg_marquardt(
            graph, vals, optimizers.LMParams(max_iterations=2),
            solver=solver, device="cpu")
        assert np.isfinite(res.error)
    base = {"bal_linearize", "ba_point_eliminate", "ba_camera_assemble",
            "ba_pair_assemble"}
    assert set(_kernels.launch_counts()) == (
        base | {k + "_f32" for k in base}
        | {"bal_error", "ba_back_substitute", "ba_schur_matvec"}
        | set(supernodal_kernels.KERNELS) | set(dense_kernels.KERNELS)
        | set(sparse_kernels.KERNELS))
    assert len(supernodal_kernels.KERNELS) == 22
    assert len(sparse_kernels.KERNELS) == 8
    assert all(n == 0 for n in _kernels.launch_counts().values())


def _meta_args(name, K=10, M=3, N=4, P=20, U=5):
    """Well-formed arguments of each wrapper case (a wrapper, or with
    "_f32" the same wrapper on its float32 variant's dtypes), on the meta
    device."""
    def f(*shape):
        return torch.empty(shape, dtype=torch.float64, device="meta")

    def h(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def i(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    proj = (f(M, 3, 3), f(M, 3), f(M, 3), f(N, 3), i(K), i(K), f(K, 2))
    return {
        "linearize": proj,
        "linearize_f32": proj + (torch.float32,),
        "error": proj,
        "point_eliminate": (i(N + 1), i(2), f(K, 2, 9), f(K, 2, 3), f(K, 2),
                            1e-4, False),
        "point_eliminate_f32": (i(N + 1), i(2), h(K, 2, 9), h(K, 2, 3),
                                f(K, 2), 1e-4, False),
        "camera_assemble": (i(M + 1), i(K), f(K, 2, 9), f(K, 2), f(K, 9),
                            i(U + 1), i(M), i(P), i(P), f(K, 9, 3),
                            f(K, 9, 3), 1e-4, False, f(9 * M, 9 * M)),
        "camera_assemble_f32": (i(M + 1), i(K), h(K, 2, 9), f(K, 2), f(K, 9),
                                i(U + 1), i(M), i(P), i(P), f(K, 9, 3),
                                f(K, 9, 3), 1e-4, False, h(9 * M, 9 * M)),
        "pair_assemble": (i(U + 1), i(U), i(U), i(P), i(P), f(K, 9, 3),
                          f(K, 9, 3), f(9 * M), f(9 * M, 9 * M)),
        "pair_assemble_f32": (i(U + 1), i(U), i(U), i(P), i(P), f(K, 9, 3),
                              f(K, 9, 3), f(9 * M), h(9 * M, 9 * M)),
        "back_substitute": (i(N + 1), i(2), i(K), f(K, 9, 3), f(M, 9),
                            f(N, 3, 3), f(N, 3)),
        "schur_matvec": (i(N + 1), i(2), i(K), i(K), i(M + 1), i(K),
                         f(K, 9, 3), f(K, 9, 3), f(M, 9, 9), f(M, 9)),
    }.get(name) or _meta_args_dense(name) or _meta_args_sparse(name) \
        or _meta_args_pg(name)


def _meta_args_sparse(name, B=10, n=5, J=3, T=2, nv=4, Q=8):
    """Well-formed arguments of each wrapper of kernels 13-16 (d = 6) on
    the meta device, or None for another name."""
    if name not in sparse_kernels.KERNELS:
        return None

    def f(*shape):
        return torch.empty(shape, dtype=torch.float64, device="meta")

    def i(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    vec = [f(6 * nv) for _ in range(6)]
    return {
        "sp_level_factor": (f(B, 36), i(J), i(J + 1), i(5), i(6), i(7), i(7),
                            i(3), i(J + 1), i(2), f(n, 6), 0.1, f(B, 36),
                            i(J), i(n), 1),
        "sp_tail_assemble": (f(B, 36), f(B, 36), i(T * T), i(3), i(3), i(4),
                             i(5), i(5), i(T), f(n, 6), 0.1,
                             f(6 * T, 6 * T)),
        "sp_level_forward": (f(B, 36), f(6 * n), i(6 * n), f(n, 6),
                             f(T, 6), i(J), i(J), i(J), i(J + 1), i(4),
                             i(4), i(3), J - 1, i(n), 1),
        "sp_level_backward": (f(B, 36), f(n, 6), f(n + T, 6), i(6 * n),
                              i(J), i(J), i(J), i(J + 1), i(4), i(4), i(3),
                              f(6 * nv), i(n), 1),
        "pcg_jacobi": (f(Q, 6, 6), i(nv + 1), i(Q), i(nv), f(nv, 6, 6)),
        "pcg_matvec": (f(Q, 6, 6), f(6 * nv), i(nv + 1), i(Q), i(Q), i(5),
                       i(Q), i(nv), i(nv), 0.1, f(6 * nv),
                       f(sparse_kernels.ST_SIZE),
                       i(sparse_kernels.IST_SIZE)),
        "pcg_step": (sparse_kernels.UPDATE, f(nv, 6, 6), f(nv, 6, 6), *vec,
                     i(nv), i(nv), 0.1, 1e-9, 10, True, False,
                     f(sparse_kernels.ST_SIZE),
                     i(sparse_kernels.IST_SIZE)),
        "pcg_loop": (sparse_kernels.G_MATVEC | sparse_kernels.G_UPDATE, True,
                     f(Q, 6, 6), f(nv, 6, 6), f(nv, 6, 6), *vec, i(nv + 1),
                     i(Q), i(Q), i(5), i(Q), i(nv), i(nv), 0.1, 1e-9, 10,
                     True, False, f(sparse_kernels.ST_SIZE),
                     i(sparse_kernels.IST_SIZE)),
    }[name]


def _meta_args_dense(name, n=130):
    """Well-formed arguments of each dense wrapper case on the meta device
    (float32 tensors for the "_f32" cases), or None for another name."""
    if name.removesuffix("_f32") not in DENSE_WRAPPERS:
        return None
    dt = torch.float32 if name.endswith("_f32") else torch.float64

    def f(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    P = dense_kernels.panels(n)
    info = torch.empty((), dtype=torch.int32, device="meta")
    if name.startswith("factor_diag"):
        return (f(n, n), f(P, 128, 128), info, 1)
    return (f(n, n), f(P, 128, 128), f(n), f(n))


def _meta_args_pg(name, N=4, Nv=5, n=5, nb=10, S=2, W=2, R=3, T=3):
    """Well-formed arguments of each pose-graph wrapper (d = 6) on the meta
    device."""
    def f(*shape):
        return torch.empty(shape, dtype=torch.float64, device="meta")

    def i(*shape):
        return torch.empty(shape, dtype=torch.int32, device="meta")

    def b(*shape):
        return torch.empty(shape, dtype=torch.bool, device="meta")

    def l(*shape):
        return torch.empty(shape, dtype=torch.int64, device="meta")

    Wd, Rd = 6 * W, 6 * R
    se3 = (f(Nv, 3, 3), f(Nv, 3), i(N, 2), f(N, 3, 3), f(N, 3))
    se2 = (f(Nv, 3), i(N, 2), f(N, 3))
    bal = (f(Nv, 3, 3), f(Nv, 3), f(Nv, 3), f(n, 3), i(N, 2), f(N, 2))
    pin = (f(Nv, 3, 3), f(Nv, 3), f(n, 3), i(N, 2), f(N, 2), f(5), f(12))
    levels = supernodal_kernels.Levels(
        l(1, 12), [f(S, Wd, Wd)], [f(S, Rd, Wd)], S, S * Wd, S * Rd, S * W,
        S * R, Wd + Rd)
    plan = supernodal_kernels.SchurPlan(
        i(7), i(T + 1), i(T), i(7), S, W, R, 6, nb,
        supernodal_kernels.update_split(S, W, R, 6, T))
    nrows = 5
    narrow = supernodal_kernels.NarrowPlan(
        i(S), i(2), i(2), i(S, R * (R + 1) // 2), i(T + 1), i(nrows), i(T),
        i(7), i(7), i(7), i(T + 1), S, W, R, 6, nb, nrows, nrows,
        supernodal_kernels.narrow_warps(W, R, 6))
    G = 10    # a Gram plan's rows: 6 of H, 4 of gv
    gram = supernodal_kernels.GramPlan(
        i(N), i(-(-N // supernodal_kernels.PROJ_CHUNK) + 1), i(G), i(G + 1),
        i(supernodal_kernels.GRAM_KINDS * N), i(G))
    m = 40
    qr = supernodal_kernels.QRLevel(
        S, W, R, 6, 0, m, S * m * (Wd + Rd), i(S), l(S), i(S + 1), i(3),
        i(3), i(3), i(3), i(S + 1), i(1), i(1), i(1), i(2), i(1))
    return {
        "pg_linearize": se3 + ("gaussian", f(N, 6, 6), 1.0, b(N),
                               f(N, 3, 36), f(N, 2, 6)),
        "pg_error": se3 + ("diagonal", f(N, 6), 1.0),
        "pg2_linearize": se2 + ("gaussian", f(N, 3, 3), 1.0, b(N),
                                f(N, 3, 9), f(N, 2, 3)),
        "pg2_error": se2 + ("diagonal", f(N, 3), 1.0),
        "pg_jacobians": se3 + ("gaussian", f(N, 6, 6), 0, 0.0,
                               f(N, 2, 6, 6)),
        "pg2_jacobians": se2 + ("gaussian", f(N, 3, 3), 0, 0.0,
                                f(N, 2, 3, 3)),
        "proj_linearize": bal + ("gaussian", f(N, 2, 2), 1.0, gram, b(G),
                                 f(6, 81), f(4, 9)),
        "proj_jacobians": bal + ("gaussian", f(N, 2, 2), 0, 0.0,
                                 f(N, 2, 2, 9)),
        "proj_error": bal + ("diagonal", f(N, 2), 1.0),
        "proj3_linearize": pin + ("gaussian", f(N, 2, 2), 1.0, gram, b(G),
                                  f(6, 36), f(4, 6)),
        "proj3_jacobians": pin + ("gaussian", f(N, 2, 2), 0, 0.0,
                                  f(N, 2, 2, 6)),
        "proj3_error": pin + ("diagonal", f(N, 2), 1.0),
        "sn_front_qr": (f(8, 6, 6), qr, b(S, Wd), i(S, W), l(4), i(4),
                        f(100), 0.1, i(S), f(S, 1, 32, 32).view(S, 32, 32),
                        1e-10, f(qr.fsize)),
        "pg_assemble": (f(12, 36), f(8, 6), i(12), i(T + 1), i(T), i(T),
                        i(8), i(n + 1), f(n, 6), nb),
        "sn_front_factor": (f(nb, 36), f(nb, 36), i(S, W, W), b(S, W, W),
                            f(S, Wd), b(S, Wd), i(S, W), i(n), i(S, R, W),
                            1e-3, False, i(S)),
        "sn_pivot_check": (i(3 * S), i(2)),
        "sn_schur_update": (f(S, Wd, Wd).mT, f(S, Wd, Rd), plan, f(nb, 36),
                            f(plan.split.scratch)),
        "sn_narrow_front": (f(nb, 36), f(nb, 36), i(S, W, W), b(S, W, W),
                            f(S, Wd), b(S, Wd), i(S, W), i(n), i(S, R, W),
                            1e-3, False, i(S), narrow, f(nrows * 36)),
        "sn_narrow_scatter": (f(S, Wd, Rd).mT, f(nrows * 36), narrow,
                              f(nb, 36)),
        "sn_forward": (f(n, 6), levels, f(S, 32, 32), i(S * W),
                       i(S * W + 1), i(T + 1), i(7), f(S * Wd), f(S * Rd)),
        "sn_backward": (f(S * Wd), levels, f(S, 32, 32), i(S * W), i(S * R),
                        f(n, 6)),
        "sn_matvec": (f(nb, 36), f(n, 6), i(n + 1), i(nb - 1), i(n + 1),
                      i(4), i(nb - 1), i(nb - 1), i(n), f(n, 6), 0.1, False),
    }[name]


WRAPPERS = ["linearize", "error", "point_eliminate", "camera_assemble",
            "pair_assemble", "back_substitute", "linearize_f32",
            "point_eliminate_f32", "camera_assemble_f32", "pair_assemble_f32",
            "schur_matvec"] + sorted(supernodal_kernels.KERNELS) + [
                "factor_diag", "factor_diag_f32", "solve_forward",
                "solve_forward_f32", "solve_backward", "solve_backward_f32"
            ] + sorted(sparse_kernels.KERNELS)
TABLES = {ba_kernels: ba_kernels.KERNELS,
          supernodal_kernels: supernodal_kernels.KERNELS,
          dense_kernels: dense_kernels.KERNELS,
          sparse_kernels: sparse_kernels.KERNELS}
DENSE_WRAPPERS = ("factor_diag", "solve_forward", "solve_backward")


def _module(name):
    """The kernel table's module whose wrapper a case of WRAPPERS names."""
    if name.removesuffix("_f32") in DENSE_WRAPPERS:
        return dense_kernels
    if name in sparse_kernels.KERNELS:
        return sparse_kernels
    return supernodal_kernels if name in supernodal_kernels.KERNELS \
        else ba_kernels


def _wrapper(name):
    """The wrapper function of a case of WRAPPERS."""
    return getattr(_module(name), name.removesuffix("_f32"))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_rejects_float32(name):
    """A float tensor of the other float dtype than the case's kernel takes
    (float32 where it takes float64, and the reverse for the float32
    variants: e.g. float32 A_cam with float64 A_pt) is refused; a wrapper
    that takes no float tensor (sn_pivot_check) refuses int64 for its
    first int32 tensor."""
    args = list(_meta_args(name))
    tensors = [k for k, a in enumerate(args) if isinstance(a, torch.Tensor)]
    j = next((k for k in tensors if args[k].is_floating_point()), None)
    other = {torch.float64: torch.float32, torch.float32: torch.float64,
             torch.int32: torch.int64}
    want = "must be torch.float"
    if j is None:
        j = next(k for k in tensors if args[k].dtype == torch.int32)
        want = "must be torch.int32"
    args[j] = args[j].to(other[args[j].dtype])
    with pytest.raises(TypeError, match=want):
        _wrapper(name)(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_rejects_non_contiguous(name):
    """The last tensor of two or more dimensions, transposed in memory (or,
    where the wrapper takes only vectors, the last vector as every other
    entry of a longer one), is refused."""
    args = list(_meta_args(name))
    tensors = [k for k, a in enumerate(args) if isinstance(a, torch.Tensor)]
    j = max((k for k in tensors if args[k].dim() >= 2), default=None)
    if j is None:
        j = tensors[-1]
        a = args[j]
        args[j] = torch.empty(2 * a.shape[0], dtype=a.dtype,
                              device="meta")[::2]
    else:
        a = args[j]
        args[j] = torch.empty(tuple(reversed(a.shape)), dtype=a.dtype,
                              device="meta").permute(
                                  *reversed(range(a.dim())))
    assert args[j].shape == a.shape and not args[j].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        _wrapper(name)(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_never_falls_back_off_the_cpu(name):
    """Well-formed tensors that are not on the CPU go to the kernel path,
    whose device check raises here (meta tensors), instead of running the
    plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        _wrapper(name)(*_meta_args(name))


@pytest.mark.parametrize("name", ["back_substitute", "sn_matvec"])
def test_wrapper_rejects_wrong_shape(name):
    args = list(_meta_args(name))
    j = {"back_substitute": 4, "sn_matvec": 1}[name]
    args[j] = torch.empty((3, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="shape"):
        _wrapper(name)(*args)


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_refuses_a_cpu_and_device_mix(name):
    """Every argument on the CPU but the last tensor (S for the assembly
    wrappers; a level table counts as an argument): the wrapper does not
    take the plain version, and its device check refuses the mix before
    any launch."""
    def cpu(a):
        return torch.zeros(a.shape, dtype=a.dtype)

    args = list(_meta_args(name))
    last = max(k for k, a in enumerate(args) if isinstance(a, torch.Tensor))
    args = [cpu(a) if isinstance(a, torch.Tensor) and k != last
            else a._replace(table=cpu(a.table))
            if isinstance(a, supernodal_kernels.Levels) else a
            for k, a in enumerate(args)]
    _kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="one CUDA device; .* is on cpu"):
        _wrapper(name)(*args)
    assert all(n == 0 for n in _kernels.launch_counts().values())


def _cpu_args(name):
    """Arguments of each wrapper at the shapes ba_optimize gives it, from a
    small problem, on the CPU; made anew at each call."""
    prob = synthetic.make_bal_problem(6, 40, 3, seed=0)
    plan = ba.BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                                prob.num_points).to("cpu")
    cams, pts = ba.state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                                    prob.points, device="cpu")
    uv = torch.as_tensor(prob.obs_uv[plan.order])
    proj = ba._projection_args(plan, cams, pts, uv)
    dt = torch.float32 if name.endswith("_f32") or name == "schur_matvec" \
        else torch.float64
    A_cam, A_pt, b = ba_kernels.linearize_plain(*proj, dt)
    W, WC, corr, C, gl = ba_kernels.point_eliminate_plain(
        plan.pt_ptr, plan.pt_tile, A_cam, A_pt, b, 1e-4, False)
    M = prob.num_cameras
    S = torch.zeros((9 * M, 9 * M), dtype=dt)
    cam = (plan.cam_ptr, plan.cam_obs, A_cam, b, corr, plan.cell_ptr,
           plan.diag_cell, plan.cell_a, plan.cell_b, WC, W, 1e-4, False, S)
    _, s, *Hpp_d = ba_kernels.camera_assemble_plain(*cam[:-1], S.clone())
    dc = torch.from_numpy(np.random.default_rng(0).normal(size=(M, 9)))
    pair = (plan.cell_ptr, plan.cell_ca, plan.cell_cb, plan.cell_a,
            plan.cell_b, WC, W, s, S)
    return {
        "linearize": proj,
        "linearize_f32": proj + (dt,),
        "error": proj,
        "point_eliminate": (plan.pt_ptr, plan.pt_tile, A_cam, A_pt, b, 1e-4,
                            False),
        "point_eliminate_f32": (plan.pt_ptr, plan.pt_tile, A_cam, A_pt, b,
                                1e-4, False),
        "camera_assemble": cam,
        "camera_assemble_f32": cam,
        "pair_assemble": pair,
        "pair_assemble_f32": pair,
        "back_substitute": (plan.pt_ptr, plan.pt_tile, plan.obs_cam, W, dc,
                            C, gl),
        "schur_matvec": (plan.pt_ptr, plan.pt_tile, plan.obs_cam, plan.obs_pt,
                         plan.cam_ptr, plan.cam_obs, W, WC, *Hpp_d, dc),
    }.get(name) or _cpu_args_dense(name) or _cpu_args_sparse(name) \
        or _cpu_args_pg(name)


def _cpu_args_sparse(name):
    """Arguments of each wrapper of kernels 13-16 at the shapes the level
    solver and PCG give them, from the small pose graph (a plan with leading
    levels and a dense root; the second leading level, the root, the
    forward and backward launches), on the CPU; made anew at each call, or
    None for another name."""
    if name not in sparse_kernels.KERNELS:
        return None
    graph, vals = _small_pose_graph()
    bound = BoundGraph(graph, vals, "cpu")
    s = SparseCholeskySolver(bound, min_level_cols=2)
    assert s.L_cut >= 2 and s.n_tail > 0
    dv, d, n, T = s.dev, s.d, s.nvars, s.n_tail
    blocks, g = s.system(vals.arrays)
    f = s.factorize(blocks, 0.3)
    # the factor's leading blocks (the root's blocks of the store are never
    # written), and the same with the second level's blocks zeroed
    lead = torch.as_tensor(s.f_cblk, dtype=torch.long)
    Lf = torch.zeros_like(f.L)
    Lf[lead] = f.L[lead]
    L = Lf.clone()
    c0, c1 = s.lev_off[1], s.lev_off[2]
    rows = torch.as_tensor(s.f_cblk[s.f_cptr[c0]:s.f_cptr[c1]])
    L[rows] = 0.0
    # kernel 13 writes every leading block: its output starts as zeros
    L13 = torch.zeros_like(f.L)
    rng = np.random.default_rng(6)
    fw, bw = dv.fw, dv.bw
    flags = torch.zeros(n, dtype=torch.int32)
    ps = PCGSolver().bind(bound)
    pool, gp, diag = ps.system(vals.arrays)
    pl = ps._plan
    st, ist = ps._state("cpu")
    st[sparse_kernels.GAMMA], st[sparse_kernels.PAP] = 2.0, 3.0
    vec = [torch.as_tensor(rng.normal(size=gp.shape[0])) for _ in range(6)]
    Minv = torch.linalg.inv(diag)
    return {
        "sp_level_factor": (blocks, dv.f_cols, dv.f_cptr, dv.f_cblk,
                            dv.f_tptr, dv.f_tik, dv.f_tjk, dv.f_lptr,
                            dv.f_wptr, dv.f_wsrc, dv.pad_diag, 0.3, L13,
                            torch.zeros(len(s.f_cols), dtype=torch.int32),
                            flags, 1),
        "sp_tail_assemble": (blocks, Lf, dv.t_map, dv.t_bid, dv.t_pos,
                             dv.l_ptr, dv.l_ik, dv.l_jk, dv.t_cols,
                             dv.pad_diag, 0.3,
                             torch.zeros((T * d, T * d),
                                         dtype=torch.float64)),
        "sp_level_forward": (Lf, g.reshape(-1), None,
                             torch.as_tensor(rng.normal(size=(n, d))),
                             torch.zeros((T, d), dtype=torch.float64),
                             fw["cols"], fw["rows"], fw["dbid"], fw["ptr"],
                             fw["fbid"], fw["fsrc"], fw["lptr"],
                             s._fw_ndiag, flags, 1),
        "sp_level_backward": (Lf, torch.as_tensor(rng.normal(size=(n, d))),
                              torch.as_tensor(rng.normal(size=(n + T, d))),
                              dv.map_canon, bw["cols"], bw["rows"],
                              bw["dbid"], bw["ptr"], bw["bbid"], bw["bsrc"],
                              bw["lptr"],
                              torch.zeros(s.layout.total_dim,
                                          dtype=torch.float64), flags, 1),
        "pcg_jacobi": (pool, pl["vptr"], pl["vslot"], pl["var_dim"],
                       torch.zeros_like(diag)),
        "pcg_matvec": (pool, vec[0], *ps._mv_plan(), 0.2,
                       torch.zeros_like(gp), st, ist),
        "pcg_step": (sparse_kernels.UPDATE, diag, Minv, gp, *vec[:5],
                     pl["var_off"], pl["var_dim"], 0.2, 1e-9, 10, True,
                     False, st, ist),
        "pcg_loop": (sparse_kernels.G_INIT | sparse_kernels.G_MATVEC
                     | sparse_kernels.G_UPDATE | sparse_kernels.G_DIRECTION,
                     True, pool, diag, torch.zeros_like(diag), gp, *vec[:5],
                     *ps._mv_plan(), 0.2, 1e-9, 10, True, False, st, ist),
    }[name]


def _cpu_args_dense(name, n=150):
    """Arguments of each dense wrapper case from a seeded SPD matrix and
    its blocked factor, on the CPU, or None for another name."""
    if name.removesuffix("_f32") not in DENSE_WRAPPERS:
        return None
    dt = torch.float32 if name.endswith("_f32") else torch.float64
    rng = np.random.default_rng(5)
    A = rng.normal(size=(n, n))
    S = torch.tensor(A @ A.T / n + np.eye(n), dtype=dt)
    b = torch.tensor(rng.normal(size=n), dtype=dt)
    if name.startswith("factor_diag"):
        return (S, torch.zeros((2, 128, 128), dtype=dt),
                torch.zeros((), dtype=torch.int32), 1)
    L, Dinv, _ = dense_blocked.blocked_cholesky(S)
    return (L, Dinv, b, torch.zeros_like(b))


def _small_pose_graph(laps=3, per_lap=4, seed=0):
    """A ring-to-ring pose graph (CPU) with a prior: (graph, values)."""
    rng = np.random.default_rng(seed)
    n = laps * per_lap
    T = SE3(*(torch.as_tensor(a) for a in _random_poses(rng, n)))
    ij = [(k, k + 1) for k in range(n - 1)] + [
        (k, k + per_lap) for k in range(n - per_lap)]
    i, j = (np.array(c) for c in zip(*ij))
    from gtsam_torch.base import noise
    from gtsam_torch.geometry import se3
    Z = se3.between(SE3(T.R[i], T.t[i]), SE3(T.R[j], T.t[j]))
    g = FactorGraph([tfactors.between_factors(
        "SE3", i, j, Z, noise.information(np.diag([4.0] * 3 + [1.0] * 3)))])
    g.add(tfactors.prior_factors("SE3", [0], SE3(T.R[:1], T.t[:1]),
                                 noise.sigmas([[1e-2] * 6])))
    T0 = se3.retract(T, torch.as_tensor(rng.normal(size=(n, 6)) * 0.1))
    return g, Values({"SE3": T0}, {"SE3": np.arange(n)})


def _random_poses(rng, n):
    from gtsam_torch.geometry import se3
    T = se3.expmap(torch.as_tensor(rng.normal(size=(n, 6))))
    return T.R.numpy(), T.t.numpy()


def _cpu_args_pose2(name):
    """Arguments of kernel 6's Pose2 wrappers at the shapes the supernodal
    solver gives them (store width 3), from a small SE2 ring graph with
    per-factor gaussian noise, on the CPU."""
    from gtsam_torch.base import noise
    from gtsam_torch.geometry import se2
    rng = np.random.default_rng(2)
    n = 12
    x = torch.as_tensor(np.concatenate([rng.normal(size=(n, 2)) * 3.0,
                                        rng.uniform(-3, 3, (n, 1))], 1))
    i = np.concatenate([np.arange(n - 1), np.arange(n - 4)])
    j = np.concatenate([np.arange(1, n), np.arange(4, n)])
    Z = se2.retract(se2.between(x[i], x[j]),
                    torch.as_tensor(rng.normal(size=(len(i), 3)) * 0.1))
    A = rng.normal(size=(len(i), 3, 3))
    g = FactorGraph([tfactors.between_factors(
        "SE2", i, j, Z, noise.information(A @ A.transpose(0, 2, 1)
                                          + 3 * np.eye(3)))])
    g.add(tfactors.prior_factors("SE2", [0], x[:1], noise.sigmas([[0.1] * 3])))
    vals = Values({"SE2": x}, {"SE2": np.arange(n)})
    s = SupernodalCholeskySolver(BoundGraph(g, vals, "cpu"), force_width=2,
                                 max_width=4)
    b, st = s.bound.graph.batches[0], s.bound.structures[0]
    N, d = b.num_factors, s.d
    args = (x, st.rows_i32, b.measurements)
    return {
        "pg2_linearize": args + (
            "gaussian", b.noise.data, 1.0, s.dev.flips[0][1],
            torch.zeros((N, 3, d * d), dtype=torch.float64),
            torch.zeros((N, 2, d), dtype=torch.float64)),
        "pg2_error": args + ("gaussian", b.noise.data, -1.0),
        "pg2_jacobians": args + ("gaussian", b.noise.data, 0, 0.0,
                                 torch.zeros((N, 2, 3, d),
                                             dtype=torch.float64)),
    }[name]


def _cpu_args_proj(name):
    """Arguments of kernels 17 and 18's wrappers at the shapes the
    supernodal solver gives them: the graph form of a small BA problem
    (store width 9), or for the GenericProjection variant its cameras as
    SE3 poses with a fixed K and an extrinsic (store width 6), one
    gaussian model a factor, on the CPU."""
    from gtsam_torch.base import noise
    from gtsam_torch.geometry import se3
    from gtsam_torch.sfm import bal
    from gtsam_torch.slam import factors as slam
    prob = synthetic.make_bal_problem(5, 30, 3, seed=2)
    A = np.random.default_rng(3).normal(size=(prob.num_observations, 2, 2))
    model = noise.information(A @ A.transpose(0, 2, 1) + np.eye(2))
    if name.startswith("proj3"):
        T = SE3(torch.as_tensor(prob.cam_R), torch.as_tensor(prob.cam_t))
        body = se3.expmap(torch.tensor([0.1, 0.0, -0.1, 0.2, 0.1, 0.0],
                                       dtype=torch.float64))
        graph = FactorGraph([slam.generic_projection_factors(
            prob.obs_cam, 100 + prob.obs_pt, prob.obs_uv,
            [500.0, 490.0, 0.0, 1.0, -2.0], model, body)])
        vals = Values({"SE3": T, "Point3": torch.as_tensor(prob.points)},
                      {"SE3": np.arange(prob.num_cameras),
                       "Point3": 100 + np.arange(prob.num_points)})
    else:
        graph, vals = bal.to_graph(prob)
        graph.batches[0].noise = model
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cpu"))
    b, st = s.bound.graph.batches[0], s.bound.structures[0]
    group = tfactors.kernel_route(b)[0]
    args = supernodal_kernels.group_args(group, vals.arrays, st.rows_i32, b)
    N, d = b.num_factors, s.d
    z = torch.zeros
    gram = s._cplan.gram[0]
    return {
        "linearize": args + ("gaussian", b.noise.data, 1.0,
                             s._cplan.device_gram("cpu")[0], s.dev.flips[0],
                             z((gram.nh, d * d), dtype=torch.float64),
                             z((gram.ng, d), dtype=torch.float64)),
        "jacobians": args + ("gaussian", b.noise.data, 0, 0.0,
                             z((N, 2, 2, d), dtype=torch.float64)),
        "error": args + ("gaussian", b.noise.data, -1.0),
    }[name.split("_")[1]]


def _cpu_args_pg(name):
    """Arguments of each pose-graph wrapper at the shapes the supernodal
    solver gives it, from a small pose graph, on the CPU; made anew at each
    call."""
    if name.startswith("pg2_"):
        return _cpu_args_pose2(name)
    if name.startswith("proj"):
        return _cpu_args_proj(name)
    graph, vals = _small_pose_graph()
    s = SupernodalCholeskySolver(BoundGraph(graph, vals, "cpu"),
                                 force_width=2, max_width=4)
    dv, b, st = s.dev, s.bound.graph.batches[0], s.bound.structures[0]
    arr = vals.arrays["SE3"]
    se3_args = (arr.R, arr.t, st.rows_i32, b.measurements.R,
                b.measurements.t)
    N, d = b.num_factors, s.d
    rng = np.random.default_rng(1)
    blocks, g = s.system(vals.arrays)
    lv = next(lv for lv in dv.levels if lv.R)
    assert lv.narrow is not None     # the small graph's levels are narrow
    f = s.factorize(blocks, 0.1)
    _, Linv, At, _ = supernodal_kernels.sn_front_factor(
        blocks.clone(), blocks, lv.diag_ids, lv.diag_flip, lv.diag_pad,
        lv.valid_diag, lv.col_vars, dv.dbc, lv.panel_ids, 0.1, False,
        torch.zeros(lv.S, dtype=torch.int32))
    sol = (f.levels, f.Linv, dv.sol_cols)
    qp = s._qr_plan()
    lv0, ql = dv.levels[0], qp.levels[0]    # leaves: no children's rows
    y, _ = supernodal_kernels.sn_forward_plain(
        g, *sol, dv.gat_ptr, dv.gat_seg, dv.gat_src,
        torch.zeros(s.n_y, dtype=torch.float64),
        torch.zeros(s.n_c, dtype=torch.float64))
    return {
        "pg_linearize": se3_args + (
            "gaussian", b.noise.data, 1.0, dv.flips[0][1],
            torch.zeros((N, 3, d * d), dtype=torch.float64),
            torch.zeros((N, 2, d), dtype=torch.float64)),
        "pg_error": se3_args + ("gaussian", b.noise.data, -1.0),
        "pg_jacobians": se3_args + (
            "gaussian", b.noise.data, 0, 0.0,
            torch.zeros((N, 2, 6, d), dtype=torch.float64)),
        "sn_front_qr": (
            s.jacobian_pool(vals.arrays), ql, lv0.valid_diag, lv0.col_vars,
            qp.roff, qp.rld, torch.zeros_like(qp.rsep), 0.3,
            torch.zeros(ql.S, dtype=torch.int32),
            torch.zeros((lv0.tiles.stop - lv0.tiles.start, 32, 32),
                        dtype=torch.float64)),
        "pg_assemble": (
            torch.as_tensor(rng.normal(size=(s._n_hc, d * d))),
            torch.as_tensor(rng.normal(size=(s._n_gc, d))), dv.asm_src,
            dv.asm_ptr, dv.asm_blk, dv.asm_diag, dv.g_src, dv.g_ptr,
            dv.pad_diag, s.B + 1),
        "sn_front_factor": (blocks.clone(), blocks, lv.diag_ids,
                            lv.diag_flip, lv.diag_pad, lv.valid_diag,
                            lv.col_vars, dv.dbc, lv.panel_ids, 0.3, True,
                            torch.zeros(lv.S, dtype=torch.int32)),
        "sn_pivot_check": (torch.tensor([-1, -1, 4, 2, -1],
                                        dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32)),
        "sn_schur_update": (Linv, At, lv.schur, blocks.clone(),
                            torch.zeros_like(dv.schur_U)),
        "sn_narrow_front": (blocks.clone(), blocks, lv.diag_ids,
                            lv.diag_flip, lv.diag_pad, lv.valid_diag,
                            lv.col_vars, dv.dbc, lv.panel_ids, 0.3, True,
                            torch.zeros(lv.S, dtype=torch.int32), lv.narrow,
                            torch.zeros_like(dv.narrow_part)),
        "sn_narrow_scatter": (f.levels.Ps[0], torch.as_tensor(rng.normal(
            size=dv.narrow_part.shape)), lv.narrow, blocks.clone()),
        "sn_forward": (torch.as_tensor(rng.normal(size=(s.nvars, d))), *sol,
                       dv.gat_ptr, dv.gat_seg, dv.gat_src,
                       torch.zeros(s.n_y, dtype=torch.float64),
                       torch.zeros(s.n_c, dtype=torch.float64)),
        "sn_backward": (y, *sol, dv.sol_rows,
                        torch.zeros((s.nvars, d), dtype=torch.float64)),
        "sn_matvec": (blocks, torch.as_tensor(rng.normal(size=(s.nvars, d))),
                      dv.mv_row_ptr, dv.mv_row_blk, dv.mv_col_ptr,
                      dv.mv_col_blk, dv.block_row, dv.block_col, dv.dbc,
                      dv.pad_diag, 0.2, True),
    }[name]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_on_cpu_is_its_plain_version(name):
    """On CPU tensors a wrapper returns, and writes into its arguments,
    exactly what its plain version does, and counts no launch."""
    _kernels.reset_launch_counts()
    args, ref_args = _cpu_args(name), _cpu_args(name)
    got = _wrapper(name)(*args)
    ref = getattr(_module(name), _wrapper(name).__name__ + "_plain")(
        *ref_args)

    def tensors(out):
        return [] if out is None else [out] if isinstance(
            out, torch.Tensor) else list(out)

    assert len(tensors(got)) == len(tensors(ref))
    pairs = list(zip(tensors(got), tensors(ref)))
    pairs += [(a, r) for a, r in zip(args, ref_args)
              if isinstance(a, torch.Tensor)]
    for a, r in pairs:
        assert a.device.type == "cpu" and torch.equal(a, r)
    assert not name.startswith("pair_assemble") or args[-1].abs().max() > 0
    assert all(n == 0 for n in _kernels.launch_counts().values())


def _cu_source(name):
    with open(_build.CSRC / f"{name}.cu") as f:
        return f.read()


def test_kernel1_sizes_match_the_source():
    """The rows per warp tile and per error block that the wrappers size
    their buffers by are the kernel's own constants (and kernel 6's: the
    error block, by which pg_error sizes its partials, and the factors of
    a linearize CTA, one lane pair each)."""
    def const(src, name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        return m.group(1).strip()

    src = _cu_source("bal_linearize")
    assert const(src, "kTileRows") == "gt::kWarp"
    assert ba_kernels.LINEARIZE_TILE_ROWS == 32
    assert const(src, "kErrorBlock") == "kErrorThreads * kErrorRows"
    assert ba_kernels.ERROR_BLOCK == (int(const(src, "kErrorThreads"))
                                      * int(const(src, "kErrorRows")))
    src = _cu_source("pg_between")
    assert const(src, "kErrorThreads") == "gt::kWarp"
    assert supernodal_kernels.ERROR_BLOCK == 32
    assert const(src, "kLinThreads") == "2 * kLinFactors"
    assert supernodal_kernels.LINEARIZE_FACTORS == int(const(src,
                                                             "kLinFactors"))


def test_schur_update_sizes_match_the_source():
    """sn_schur_update's output tile and threads, by which update_split
    counts its work, are the kernel's own constants (a warp a 32 x 32
    quadrant); its ring of three slabs of both operands leaves room for the
    two CTAs an SM that its launch bounds ask for; the U tiles it walks
    (nt <= mt + 1, skipping those outside U's block-lower triangle) are
    exactly the tiles that hold an entry (r, c) with c // d <= r // d; and
    each product's k-chunks cover its depth once, as the kernel counts
    them, with the scratch for U (none on the direct route), their partial
    tiles and U's even-pitched operand; at shapes with partial tiles and
    at the sphere's and the w10000 stand-in's level shapes."""
    src = _cu_source("sn_factor")

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        return m.group(1).strip()

    K = supernodal_kernels
    assert int(const("kUT")) == K.UPDATE_TILE == 64
    assert const("kUThreads") == "(kUT / 32) * (kUT / 32) * 32"
    assert K.UPDATE_THREADS == (64 // 32) ** 2 * 32 == 4 * 32
    assert int(const("kMaxChunks")) == K.UPDATE_MAX_CHUNKS
    assert int(const("kMaxD")) == K.UPDATE_MAX_D
    assert const("kUPitch") == "kUT + 4" and const("kUStages") == "3"
    assert "__launch_bounds__(kUThreads, 2)\n    sn_schur_update_kernel" \
        in src
    assert "nk1 = (slabs + ck1 - 1) / ck1, nk2 = (slabs + ck2 - 1) / ck2" \
        in src
    assert 2 * 3 * 2 * 32 * (K.UPDATE_TILE + 4) * 8 <= K.SHARED_BYTES
    tile = K.UPDATE_TILE
    shapes = [(5, 63, 71, 6), (1, 60, 50, 6), (2, 3, 11, 6), (1, 8, 23, 9),
              (58, 34, 24, 6), (16, 37, 33, 6), (8, 60, 48, 6),
              (3, 64, 75, 6), (1, 64, 32, 6), (1, 64, 289, 3),
              (181, 63, 74, 3)]
    for S, W, R, d in shapes:
        Rd = R * d
        ntn = -(-Rd // tile)
        needed = {(mt, nt) for mt in range(ntn) for nt in range(ntn)
                  if any(c // d <= r // d
                         for r in range(tile * mt, min(Rd, tile * mt + tile))
                         for c in range(tile * nt, min(Rd, tile * nt + tile)))}
        walked = {(mt, nt) for mt in range(ntn)
                  for nt in range(min(mt + 2, ntn))
                  if tile * nt // d <= min(tile * mt + tile - 1, Rd - 1) // d}
        assert walked == needed
        for direct in (False, True):
            sp = K.update_split(S, W, R, d, 7, direct)
            assert sp.direct == direct
            assert sp.pitch == Rd + Rd % 2 and sp.pitch % 2 == 0
            slabs = -(-W * d // 32)
            for tiles, ck, nk in ((sp.panel_tiles, sp.panel_chunk,
                                   sp.panel_chunks),
                                  (sp.u_tiles, sp.u_chunk, sp.u_chunks)):
                assert ck >= min(K.UPDATE_MIN_CHUNK, slabs) and nk == -(
                    -slabs // ck) and (nk - 1) * ck < slabs <= nk * ck
                assert nk <= K.UPDATE_MAX_CHUNKS
                assert nk == 1 or tiles * nk <= 2 * K.UPDATE_JOBS
            assert sp.panel_tiles == S * -(-W * d // tile) * ntn
            assert sp.u_tiles == S * sum(min(m + 2, ntn) for m in range(ntn))
            part = max(t * n for t, n in ((sp.panel_tiles, sp.panel_chunks),
                                          (sp.u_tiles, sp.u_chunks))
                       if n > 1) \
                if max(sp.panel_chunks, sp.u_chunks) > 1 else 0
            assert sp.scratch == ((0 if direct else S * Rd * Rd)
                                  + part * tile * tile
                                  + (S * W * d * sp.pitch if Rd % 2 else 0))
            assert sp.scatter_ctas == (0 if direct else
                                       -(-7 * d // K.UPDATE_THREADS))


def test_narrow_sizes_match_the_source():
    """The narrow route's limits, warps and buffers, by which narrow_route
    picks a level's route and narrow_warps and narrow_plan size a CTA's
    work, are csrc/sn_narrow.cu's own: a front one of kernel 8's tiles, a
    panel two rows a lane, a front's three buffers at an odd pitch; at every
    narrow shape (d 1-32) the warps' buffers and the most rows a chunk may
    hold fit the card's shared memory, and one row past a limit is wide."""
    src = _cu_source("sn_narrow")

    def const(name):
        m = re.search(rf"constexpr int {name} = ([^;]+);", src)
        assert m, name
        return m.group(1).strip()

    K = supernodal_kernels
    assert int(const("kMaxWd")) == K.NARROW_WD == int(const("kTile")) \
        == K.TILE
    assert int(const("kMaxRd")) == K.NARROW_RD == 2 * 32
    assert int(const("kMaxWarps")) == K.NARROW_WARPS
    assert "return Wd | 1;" in src
    assert "return (2 * Wd + Rd) * pitch(Wd) + (nblk + 1) / 2;" in src
    assert "__launch_bounds__(kMaxWarps * 32) sn_narrow_front_kernel" in src
    for d in range(1, K.NARROW_WD + 1):
        for W in range(1, K.NARROW_WD // d + 1):
            for R in range(K.NARROW_RD // d + 1):
                assert K.narrow_route(W, R, d)
                Wd, Rd, nblk = W * d, R * d, R * (R + 1) // 2
                per = ((2 * Wd + Rd) * K.narrow_pitch(Wd) + (nblk + 1) // 2) \
                    * 8
                assert K.narrow_warp_bytes(W, R, d) == per
                warps = K.narrow_warps(W, R, d)
                rows = max(K.NARROW_ROW_BYTES // (d * d * 8),
                           R * (R + 1) // 2)
                assert K.narrow_pitch(Wd) % 2 == 1
                assert 1 <= warps <= K.NARROW_WARPS
                assert warps * per <= K.NARROW_FRONT_BYTES
                assert warps * per + rows * d * d * 8 <= K.SHARED_BYTES
            assert not K.narrow_route(W, K.NARROW_RD // d + 1, d)
        assert not K.narrow_route(K.NARROW_WD // d + 1, 0, d)


def test_point_pass_sizes_match_the_source():
    """Kernels 2, 4 and 5 stage the tiles of the plan's pt_tile in buffers
    of POINT_TILE_STAGED rows and points, which hold POINT_TILE_ROWS plus
    the overhang of a track of up to 33 rows."""
    for src in (_cu_source("ba_point_eliminate"),
                _build.CSRC.joinpath("ba_point_pass.cuh").read_text()):
        for name in ("kTileRows", "kTilePts"):
            m = re.search(rf"constexpr int {name} = (\d+);", src)
            assert m and int(m.group(1)) == ba_kernels.POINT_TILE_STAGED
    assert ba_kernels.POINT_TILE_STAGED >= ba_kernels.POINT_TILE_ROWS + 32
    assert '#include "ba_point_pass.cuh"' in _cu_source("ba_back_substitute")
    assert '#include "ba_point_pass.cuh"' in _cu_source("ba_schur_matvec")


def test_pending_words_match_the_source():
    """Kernel 11's wrappers fill its output with the word the kernel reads
    as "not written yet": the same bits in csrc/dense_solve.cu, a NaN that
    is not the canonical one the kernel stores every NaN as."""
    src = _cu_source("dense_solve")
    for dt, c in (("double", "ull"), ("float", "u")):
        m = re.search(rf"struct Word<{dt}> {{.*?kPending = (0x[0-9a-f]+){c};"
                      rf".*?kNaN = (0x[0-9a-f]+){c};", src, re.S)
        assert m, dt
        word, bits = dense_kernels.PENDING[getattr(torch, dt)]
        assert bits == int(m.group(1), 16) != int(m.group(2), 16)
        v = torch.tensor([bits], dtype=word).view(getattr(torch, dt))
        assert torch.isnan(v).all()


def _kernel10_schedule():
    """Kernel 10's job list and phase offsets, read from its device code
    (csrc/chol_tiles.cuh, which kernel 7's front kernel shares)."""
    src = (_build.CSRC / "chol_tiles.cuh").read_text()
    body = re.search(r"__constant__ Job kJobs\[\] = \{(.*?)\n\};", src,
                     re.S).group(1)
    jobs = [(k, int(i), int(j), int(t), int(c)) for k, i, j, t, c in
            re.findall(r"\{(k\w+), (\d+), (\d+), (\d+), (\d+)\}", body)]
    phase = [int(x) for x in re.search(
        r"__constant__ int kPhase\[\] = \{([^}]*)\};", src).group(1).split(",")]
    return jobs, phase


def _check_kernel10_schedule(jobs, phase):
    """Walk kernel 10's lists in order (S(t) and U(t) for t < 3, then A and
    B) beside its chain (in phase t: tile (t + 1, t + 1) updated by column
    t and factored; tile (t + 2, t) solved before U(t), tile (t + 2, t + 1)
    updated by column t and solved against tile t + 1 during it) and
    assert that each job reads only tiles an earlier list finished, that no
    job of a list touches a strip another job of it (or the chain) writes,
    and that every tile of L_D and of L_D^-1 is written out once."""
    tiles = [(i, j) for i in range(4) for j in range(i + 1)]
    upd = {(i, j, c): 0 for i, j in tiles for c in (0, 16)}   # A updates
    L = {(0, 0), (1, 0)}   # final tiles of L_D (the first phase's)
    Y, X = set(), set()    # strips of sums, tiles of L_D^-1
    out_L, out_X = [], []

    def strips(m, i, j):
        return {(m, i, j, 0), (m, i, j, 16)}

    def bump(i, j):
        for c in (0, 16):
            upd[(i, j, c)] += 1

    for ph in range(8):
        touch, after = [], []   # (reads, writes) of each worker
        t = ph // 2
        if ph < 6:              # the chain of phase t
            below = t + 2 < 4
            if ph % 2 == 0:
                assert all(upd[(t + 1, t + 1, c)] == t for c in (0, 16))
                assert (t + 1, t) in L and (t, t) in L
                r = strips("A", t + 1, t) | strips("A", t, t) | {("rinv", t)}
                w = strips("A", t + 1, t + 1) | {("rinv", t + 1)}
                if below:
                    assert all(upd[(t + 2, t, c)] == t for c in (0, 16))
                    assert all(upd[(t + 2, t + 1, c)] == t for c in (0, 16))
                    w |= strips("A", t + 2, t) | strips("A", t + 2, t + 1)
                    after.append(lambda t=t: L.add((t + 2, t)))
                after.append(lambda t=t: bump(t + 1, t + 1))
            else:
                r = strips("A", t + 1, t) | {("rinv", t + 1)}
                w = strips("A", t + 1, t + 1) | {("rinv", t + 1)}
                after.append(lambda t=t: L.add((t + 1, t + 1)))
                if below:
                    r |= strips("A", t + 2, t)
                    w |= strips("A", t + 2, t + 1)
                    after.append(lambda t=t: bump(t + 2, t + 1))
                    after.append(lambda t=t: L.add((t + 2, t + 1)))
            touch.append((r - w, w))
        for kind, i, j, t, c in jobs[phase[ph]:phase[ph + 1]]:
            r, w = set(), set()
            if kind == "kSolve":
                assert all(upd[(i, t, c)] == t for c in (0, 16))
                assert (t, t) in L
                r |= strips("A", t, t) | {("rinv", t)}
                w |= strips("A", i, t)
                after.append(lambda i=i, t=t: L.add((i, t)))
            elif kind == "kInvert":
                assert (t, t) in L
                r |= strips("A", t, t) | {("rinv", t)}
                w |= strips("X", t, t)
                after.append(lambda t=t: X.add((t, t)))
                if t == 3:
                    after.append(lambda: out_X.append((3, 3)))
            elif kind == "kUpdate":
                assert (i, t) in L and (j, t) in L and upd[(i, j, c)] == t
                r |= strips("A", i, t) | strips("A", j, t)
                w |= {("A", i, j, c)}
                after.append(lambda k=(i, j, c): upd.__setitem__(k, upd[k] + 1))
            elif kind == "kSum":
                for m in range(j, i):
                    assert (i, m) in L and (m, j) in X
                    r |= strips("A", i, m) | strips("X", m, j)
                w |= {("X", i, j, c)}
                after.append(lambda k=(i, j, c): Y.add(k))
            elif kind in ("kScale", "kScaleOut"):
                assert (i, i) in X and (i, j, c) in Y
                r |= strips("X", i, i) | {("X", i, j, c)}
                if kind == "kScale":
                    w |= {("X", i, j, c)}
                    if c == 16:
                        after.append(lambda k=(i, j): X.add(k))
                else:
                    after.append(lambda k=(i, j, c): out_X.append(k))
            elif kind == "kWriteL":
                assert (i, j) in L
                r |= strips("A", i, j)
                after.append(lambda k=(i, j): out_L.append(k))
            else:
                assert kind == "kWriteX" and (i, j) in X
                r |= strips("X", i, j)
                after.append(lambda k=(i, j): out_X.append(k))
            r -= w
            touch.append((r, w))
        for a, (_, wa) in enumerate(touch):
            for b, (rb, wb) in enumerate(touch):
                assert a == b or not wa & (rb | wb), (ph, a, b)
        for f in after:
            f()
    assert sorted(out_L) == tiles
    halves = [k for k in out_X if len(k) == 3]
    assert sorted([k for k in out_X if len(k) == 2]
                  + [(i, j) for i, j, c in halves if c == 0]) == tiles
    assert sorted(halves) == sorted((i, j, c) for i, j, c0 in halves
                                    for c in (0, 16) if c0 == 0)


def test_kernel10_jobs_read_only_finished_tiles():
    """Kernel 10's job lists (csrc/chol_tiles.cuh) keep its phases' order
    beside its chain: a job reads only finished tiles, two jobs of a list
    never touch a strip one of them writes, and every tile is written out
    once."""
    jobs, phase = _kernel10_schedule()
    assert phase[0] == 0 and phase[-1] == len(jobs) and len(phase) == 9
    _check_kernel10_schedule(jobs, phase)


@pytest.mark.parametrize("module", list(TABLES), ids=lambda m: m.__name__)
def test_argtypes_match_the_c_entry_points(module):
    """Each Kernel's ctypes argtypes follow its C entry point's parameters:
    int, double, or a pointer (the stream last); a mismatch would pass
    arguments in the wrong registers on the card."""
    import ctypes
    for k in TABLES[module].values():
        m = re.search(rf"GT_EXPORT int gt_{k.name}\(([^)]*)\)",
                      _cu_source(k.source))
        assert m, k.name
        params = [p.strip() for p in m.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else
                ctypes.c_double if p.startswith("double") else ctypes.c_int
                for p in params]
        assert params[-1] == "void* stream"
        assert all(p.startswith(("int ", "double ")) for p in params
                   if "*" not in p), params
        assert k.argtypes == want, k.name


def test_build_targets_hopper():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-fPIC" in flags
    for name in _build.SOURCES:
        path = _build.library_path(name)
        assert (_build.CSRC / f"{name}.cu").is_file()
        assert path.parent == _build.BUILD_DIR
        assert path == _build.library_path(name)     # stable digest
    assert _build.BUILD_DIR.parts[-2:] == ("build", "gtsam_torch_kernels")
    kernels = {k.source for t in TABLES.values() for k in t.values()}
    assert kernels == set(_build.SOURCES)
    assert sum(len(t) for t in TABLES.values()) == len(
        _kernels.launch_counts())
    for module, table in TABLES.items():
        for k in table.values():
            assert callable(getattr(module, k.wrapper))
            assert callable(getattr(module, k.wrapper + "_plain"))
            path, line = k.replaces.split(":")
            assert os.path.isfile(os.path.join(REPO, path)) and int(line) > 0


def test_native_orderings_build_or_raise(monkeypatch, tmp_path):
    """The C orderings build with gcc into build/gtsam_torch_native/ under
    a digest of their sources; a failed build raises instead of falling
    back to other orderings."""
    assert native.BUILD_DIR.parts[-2:] == ("build", "gtsam_torch_native")
    assert native.library_path().parent == native.BUILD_DIR
    assert native.build().is_file()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CFLAGS", ("-O3", "-shared", "-fPIC",
                                           "-no-such-flag"))
    with pytest.raises(RuntimeError, match="native orderings"):
        native.build()


def test_keys_are_the_reference_keys():
    """base/keys.py is the JAX package's (pure Python) copied: the same
    keys, tags and labels."""
    from gtsam_torch.base import keys as tkeys
    from gtsam_tpu.base import keys as jkeys
    for c, j in (("x", 0), ("l", 17), ("b", (1 << 56) - 1)):
        k = tkeys.symbol(c, j)
        assert k == jkeys.symbol(c, j)
        assert (tkeys.symbol_chr(k), tkeys.symbol_index(k),
                tkeys.format_key(k)) == (jkeys.symbol_chr(k),
                                         jkeys.symbol_index(k),
                                         jkeys.format_key(k))
    k = tkeys.labeled_symbol("x", "b", 9)
    assert k == jkeys.labeled_symbol("x", "b", 9)
    assert (tkeys.labeled_symbol_chr(k), tkeys.labeled_symbol_label(k),
            tkeys.labeled_symbol_index(k)) == ("x", "b", 9)
    assert tkeys.shorthand("x")(3) == jkeys.shorthand("x")(3)
    assert tkeys.format_key(5) == "5"


def test_vmapped_retract_and_local():
    """values.vmapped_retract and vmapped_local (torch.func.vmap of a
    manifold's retract and local) against the JAX package's on SE3 and
    Point3: 1e-12."""
    import jax.numpy as jnp
    from gtsam_torch.geometry import se3
    from gtsam_torch.graph import manifolds, values
    from gtsam_tpu.graph import manifolds as jmanifolds
    from gtsam_tpu.graph import values as jvalues
    from gtsam_tpu.geometry import se3 as jse3
    rng = np.random.default_rng(21)
    xi, d = rng.normal(size=(5, 6)), rng.normal(size=(5, 6)) * 0.3
    T = se3.expmap(torch.as_tensor(xi))
    jT = jse3.expmap(jnp.asarray(xi))
    got = values.vmapped_retract(manifolds.get("SE3"))(T, torch.as_tensor(d))
    ref = jvalues.vmapped_retract(jmanifolds.get("SE3"))(jT, jnp.asarray(d))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-12,
                               atol=1e-12)
    loc = values.vmapped_local(manifolds.get("SE3"))(T, got)
    jloc = jvalues.vmapped_local(jmanifolds.get("SE3"))(jT, ref)
    np.testing.assert_allclose(loc.numpy(), np.asarray(jloc), rtol=1e-12,
                               atol=1e-12)
    p = rng.normal(size=(5, 3))
    got = values.vmapped_retract(manifolds.get("Point3"))(
        torch.as_tensor(p), torch.as_tensor(d[:, :3]))
    np.testing.assert_array_equal(got.numpy(), p + d[:, :3])


def test_constrained_last_ordering():
    """inference/ordering.py::constrained_last equals the JAX package's on
    a seeded graph: the rest by minimum degree, then the forced
    variables."""
    from gtsam_torch.inference import ordering as tordering
    from gtsam_tpu.inference import ordering as jordering
    rng = np.random.default_rng(22)
    n = 30
    keys = [np.stack([np.arange(n - 1), np.arange(1, n)], 1),
            rng.integers(0, n, size=(25, 2))]
    keys[1] = keys[1][keys[1][:, 0] != keys[1][:, 1]]
    A = tordering.adjacency_from_factors(keys, n)
    jA = jordering.adjacency_from_factors(keys, n)
    last = [17, 3, 17, 25]
    got = tordering.constrained_last(A, last)
    np.testing.assert_array_equal(got, jordering.constrained_last(jA, last))
    np.testing.assert_array_equal(got[-3:], [3, 17, 25])
    assert sorted(got) == list(range(n))


def test_rpe_matches():
    """utils/metrics.py::rpe against the JAX package's (numpy both)."""
    from gtsam_torch.utils import metrics as tmetrics
    from gtsam_tpu.utils import metrics as jmetrics
    rng = np.random.default_rng(23)
    gt_ = np.cumsum(rng.normal(size=(40, 3)), axis=0)
    est = gt_ + rng.normal(size=(40, 3)) * 0.1
    for delta in (1, 5):
        assert tmetrics.rpe(est, gt_, delta) == jmetrics.rpe(est, gt_, delta)
