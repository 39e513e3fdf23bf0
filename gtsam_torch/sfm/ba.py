"""Bundle adjustment by Schur-complement landmark elimination (torch).

Counterpart of gtsam_tpu/sfm/ba.py (non-mixed float64 path).  Landmarks are
eliminated per track with 3x3 algebra, the reduced camera system
S = Hpp - Hpl Hll^-1 Hlp is assembled dense (9M x 9M, camera-major) and
factorized by Cholesky; the LM loop is host-driven and matches the JAX
package's (GTSAM LevenbergMarquardtOptimizer semantics).

On CUDA tensors the per-observation and per-point work runs in the
hand-written kernels of gtsam_torch/csrc (see ba_kernels.py); the dense
factorization goes to cuSOLVER through torch.linalg.
"""

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ..config import default_dtype, resolve_device
from ..geometry.cameras import BalCamera, bal_retract
from ..geometry.se3 import SE3
from ..optimize.optimizers import LMParams, check_convergence
from . import ba_kernels
from .bal import BalProblem

_DEVICE_ARRAYS = ("obs_cam", "obs_pt", "pt_ptr", "cam_ptr", "cam_obs",
                  "pair_ptr", "pair_a", "pair_b")


@dataclasses.dataclass(frozen=True)
class BAStructure:
    """Static plan of one BA problem, built once on the host.

    Observations are sorted by point ("rows"); every per-point reduction is
    a run of the point CSR, every per-camera reduction a run of the camera
    CSR, and the reduced camera matrix is assembled from the directed pairs
    (a, b) of each point's rows, both orders and a == b included.  Tracks of
    any length, and tracks that see one camera twice, need no special case.
    `build` gives numpy arrays; `to(device)` the same plan with every array
    but `order` as int32 tensors.
    """

    num_cameras: int
    num_points: int
    order: object     # (K,) original observation index of each row
    obs_cam: object   # (K,) camera of each row
    obs_pt: object    # (K,) point of each row (non-decreasing)
    pt_ptr: object    # (N+1,) point CSR over rows
    cam_ptr: object   # (M+1,) camera CSR over cam_obs
    cam_obs: object   # (K,) rows grouped by camera
    pair_ptr: object  # (N+1,) per-point CSR over the pair list
    pair_a: object    # (P,) first row of each directed pair
    pair_b: object    # (P,) second row of each directed pair

    @staticmethod
    def build(obs_cam, obs_pt, num_cameras, num_points) -> "BAStructure":
        obs_cam = np.asarray(obs_cam, dtype=np.int64)
        obs_pt = np.asarray(obs_pt, dtype=np.int64)
        M, N = int(num_cameras), int(num_points)
        if obs_cam.shape != obs_pt.shape or obs_cam.ndim != 1:
            raise ValueError("obs_cam and obs_pt must be 1-D of equal length")
        if len(obs_cam) and not (0 <= obs_cam.min() and obs_cam.max() < M
                                 and 0 <= obs_pt.min() and obs_pt.max() < N):
            raise ValueError("observation index out of range")
        order = np.argsort(obs_pt, kind="stable")
        oc, op = obs_cam[order], obs_pt[order]
        counts = np.bincount(op, minlength=N)
        pt_ptr = np.concatenate([[0], np.cumsum(counts)])
        cam_obs = np.argsort(oc, kind="stable")
        cam_ptr = np.concatenate([[0], np.cumsum(np.bincount(oc, minlength=M))])
        npairs = counts * counts
        pair_ptr = np.concatenate([[0], np.cumsum(npairs)])
        owner = np.repeat(np.arange(N), npairs)
        q = np.arange(pair_ptr[-1]) - pair_ptr[owner]
        ln = counts[owner]
        pair_a = pt_ptr[owner] + q // ln
        pair_b = pt_ptr[owner] + q % ln
        if max(len(oc), pair_ptr[-1]) >= 2 ** 31:
            raise ValueError("problem too large for int32 plan indices")
        return BAStructure(M, N, order, oc, op, pt_ptr, cam_ptr, cam_obs,
                           pair_ptr, pair_a, pair_b)

    def to(self, device) -> "BAStructure":
        return dataclasses.replace(self, **{
            f: torch.as_tensor(np.asarray(getattr(self, f), dtype=np.int32),
                               device=device) for f in _DEVICE_ARRAYS})


def state_from_numpy(cam_R, cam_t, cam_calib, points, device=None):
    """BA state (BalCamera(SE3(R, t), calib), points) as float64 tensors on
    `device` (CUDA when None), from the JAX package's arrays pulled to numpy
    or a BalProblem's."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=default_dtype(),
                               device=dev).contiguous()

    return BalCamera(SE3(t(cam_R), t(cam_t)), t(cam_calib)), t(points)


def state_to_numpy(cams: BalCamera, points):
    """(cam_R, cam_t, cam_calib, points) as numpy arrays."""
    return tuple(x.detach().cpu().numpy()
                 for x in (cams.pose.R, cams.pose.t, cams.calib, points))


def _projection_args(plan, cams, points, uv):
    return (cams.pose.R.contiguous(), cams.pose.t.contiguous(),
            cams.calib.contiguous(), points.contiguous(), plan.obs_cam,
            plan.obs_pt, uv)


def linearize(plan: BAStructure, cams: BalCamera, points, uv):
    """Whitened Jacobians A_cam (K,2,9), A_pt (K,2,3) and b = -r (K,2) of
    the plan's rows; uv (K,2) is in row order.  Matches
    gtsam_tpu.graph.factors.linearize of the BAL projection factor with unit
    noise (the batch built in gtsam_tpu/sfm/ba.py:1319)."""
    return ba_kernels.linearize(*_projection_args(plan, cams, points, uv))


def error(plan: BAStructure, cams: BalCamera, points, uv) -> float:
    """Half-chi2 0.5 * sum r^2 in float64, cheirality penalty included."""
    return float(ba_kernels.error(*_projection_args(plan, cams, points, uv)))


def assemble(plan: BAStructure, A_cam, A_pt, b, lam, diagonal_damping, S):
    """Eliminate the landmarks and assemble the damped reduced camera system
    into S (9M x 9M, camera-major, overwritten).  Returns (g~ (M,9), and
    W, C, gl for the back-substitution)."""
    W, WC, corr, C, gl = ba_kernels.point_eliminate(
        plan.pt_ptr, A_cam, A_pt, b, lam, diagonal_damping)
    # One S buffer serves every try of a run: zeroed here and rebuilt (the
    # JAX package builds a fresh S each try).
    S.zero_()
    g = ba_kernels.camera_assemble(plan.cam_ptr, plan.cam_obs, A_cam, b, corr,
                                   lam, diagonal_damping, S)
    ba_kernels.pair_assemble(plan.pair_ptr, plan.pair_a, plan.pair_b,
                             plan.obs_cam, WC, W, S)
    return g, W, C, gl


def _dense_spd_solve(S, rhs):
    """Jacobi-equilibrated Cholesky solve of S x = rhs (gtsam_tpu/sfm/ba.py
    _dense_spd_solve, :468-475).  S is scratch: it is equilibrated and
    factorized in place, so no second n x n buffer is held.  Returns None
    when the factorization fails."""
    s = torch.diagonal(S).clamp(min=1e-12).rsqrt()
    S.mul_(s[:, None]).mul_(s[None, :])
    # S is symmetric, so its transpose view is the same matrix in the
    # column-major layout LAPACK/cuSOLVER use; factorizing into that view
    # leaves L in S's memory.
    L = S.mT
    info = torch.empty((), dtype=torch.int32, device=S.device)
    torch.linalg.cholesky_ex(L, out=(L, info))
    if int(info) != 0:
        return None
    y = torch.linalg.solve_triangular(L, (rhs * s)[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0] * s


def _schur_step(plan, A_cam, A_pt, b, lam, diagonal_damping, S):
    g, W, C, gl = assemble(plan, A_cam, A_pt, b, lam, diagonal_damping, S)
    x = _dense_spd_solve(S, g.reshape(-1))
    if x is None:
        return None
    dc = x.reshape(-1, 9)
    return dc, ba_kernels.back_substitute(plan.pt_ptr, plan.obs_cam, W, dc, C,
                                          gl)


def schur_solve(plan: BAStructure, A_cam, A_pt, b, lam,
                diagonal_damping=False):
    """Solve the damped Gauss-Newton system by landmark elimination.

    A_cam (K,2,9), A_pt (K,2,3), b (K,2) in the plan's row order (a plan on
    the tensors' device).  Returns (dc (M,9), dl (N,3)) with dl in original
    point numbering and 0 for points without observations; both are NaN when
    the Cholesky factorization fails.
    """
    M = plan.num_cameras
    S = torch.empty((9 * M, 9 * M), dtype=default_dtype(), device=A_cam.device)
    step = _schur_step(plan, A_cam, A_pt, b, lam, diagonal_damping, S)
    if step is None:
        nan = float("nan")
        return (torch.full((M, 9), nan, dtype=S.dtype, device=S.device),
                torch.full((plan.num_points, 3), nan, dtype=S.dtype,
                           device=S.device))
    return step


def ba_optimize(prob: BalProblem, params: Optional[LMParams] = None,
                verbose: bool = False, target_error: Optional[float] = None,
                device=None, initial=None):
    """Full BAL bundle adjustment: LM with Schur elimination, float64.

    Returns ({"cams": BalCamera, "points": (N,3)}, info) with info keys
    error, iterations, converged, history, iter_times, phases.
    target_error: stop as soon as the half-chi2 is at or below it.
    device: CUDA when None (raises without CUDA); "cpu" runs the plain
    versions of the kernels.  initial: optional (cams, points) state, as
    from state_from_numpy, in place of the problem's own.
    """
    params = params or LMParams()
    dev = resolve_device(device)
    plan = BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                             prob.num_points).to(dev)
    uv = torch.as_tensor(prob.obs_uv[plan.order], dtype=default_dtype(),
                         device=dev)
    if initial is None:
        initial = state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                                   prob.points, dev)
    cams, pts = initial
    n = 9 * prob.num_cameras
    S = torch.empty((n, n), dtype=default_dtype(), device=dev)

    err = error(plan, cams, pts, uv)
    history = [err]
    iter_times = []
    lam = params.lambda_initial
    lam_fail_ceiling = 0.0   # conservative policy: largest lambda that failed
    it = 0
    converged = False
    for it in range(1, params.max_iterations + 1):
        t0 = time.time()
        A_cam, A_pt, b = linearize(plan, cams, pts, uv)
        prev = err
        accepted = False
        lam_entry = lam
        while True:
            step = _schur_step(plan, A_cam, A_pt, b, lam,
                               params.diagonal_damping, S)
            ne = math.inf
            if step is not None:
                dc, dl = step
                nc, npts = bal_retract(cams, dc), pts + dl
                ne = error(plan, nc, npts, uv)
            if math.isfinite(ne) and ne < err:
                cams, pts, err = nc, npts, ne
                nxt = max(lam / params.lambda_factor,
                          params.lambda_lower_bound)
                if params.lambda_policy != "conservative":
                    lam = nxt
                elif lam == lam_entry and nxt > lam_fail_ceiling:
                    lam = nxt
                accepted = True
                break
            lam_fail_ceiling = max(lam_fail_ceiling, lam)
            lam *= params.lambda_factor
            if lam > params.lambda_upper_bound:
                break
        iter_times.append(time.time() - t0)
        if verbose:
            print(f"BA iter {it}: {prev:.6g} -> {err:.6g} lambda={lam:.3g} "
                  f"({iter_times[-1]:.3f}s)", flush=True)
        history.append(err)
        if target_error is not None and err <= target_error:
            converged = True
            break
        if not accepted:
            break
        if check_convergence(prev, err, params):
            converged = True
            break
    return dict(cams=cams, points=pts), dict(
        error=err, iterations=it, converged=converged, history=history,
        iter_times=iter_times, phases=["float64"] * len(iter_times))
