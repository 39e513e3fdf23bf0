"""Bundle adjustment by Schur-complement landmark elimination (torch).

Counterpart of gtsam_tpu/sfm/ba.py.  Landmarks are eliminated per track
with 3x3 algebra, the reduced camera system S = Hpp - Hpl Hll^-1 Hlp is
assembled dense (9M x 9M, camera-major), already Jacobi-equilibrated, and
factorized by Cholesky; the LM loop is host-driven and matches the JAX
package's (GTSAM LevenbergMarquardtOptimizer semantics).

Two precisions, as in the JAX package:
  - float64 (the default): Jacobians, S and the Cholesky in float64;
  - mixed (dtype=float32, mixed_precision=True): float32 Jacobians, every
    sum over them in float64 (exact Gram products), S stored and factorized
    in float32, and the step refined in float64 against the implicit Schur
    matvec (kernel 5), whose product needs no float64 S.  A stall switches
    the run to a float64 phase: float64 Jacobians and S, an f32 copy of S
    factorized, refined against S itself (gtsam_tpu/sfm/ba.py:453-529,
    :1359-1411, :1435-1438, :1546-1551).

On CUDA tensors the per-observation and per-point work runs in the
hand-written kernels of gtsam_torch/csrc (see ba_kernels.py); the dense
factorization and solve are linear/dense_blocked.py's (kernels 10 and 11,
and cuBLAS's trailing products).
"""

import dataclasses
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._kernels import row_strided
from ..config import default_dtype, resolve_device, working_dtype
from ..geometry.cameras import BalCamera, bal_retract
from ..geometry.se3 import SE3
from ..linear import dense_blocked
from ..optimize.optimizers import LMParams, check_convergence
from . import ba_kernels
from .bal import BalProblem

_ROW_ARRAYS = ("obs_cam", "obs_pt", "pt_ptr", "cam_ptr", "cam_obs")


@dataclasses.dataclass(frozen=True)
class BAStructure:
    """Static plan of one BA problem.

    Observations are sorted by point ("rows"); every per-point reduction is
    a run of the point CSR, every per-camera reduction a run of the camera
    CSR.  The reduced camera matrix is assembled from the directed pairs
    (a, b) of each point's rows, both orders and a == b included, grouped
    by the 9x9 cell (camera of a, camera of b) they add to: a cell CSR with
    the cells sorted by ca * M + cb and, inside a cell, the pairs in point
    order.  Tracks of any length, and tracks that see one camera twice, need
    no special case.

    `build` gives the row plan as numpy arrays, on the host; `to(device)`
    moves it as int32 tensors and builds the pair and cell plan there
    (`cell_*`, `diag_cell`, `pt_tile`, None until then).
    """

    num_cameras: int
    num_points: int
    order: object     # (K,) original observation index of each row
    obs_cam: object   # (K,) camera of each row
    obs_pt: object    # (K,) point of each row (non-decreasing)
    pt_ptr: object    # (N+1,) point CSR over rows
    cam_ptr: object   # (M+1,) camera CSR over cam_obs
    cam_obs: object   # (K,) rows grouped by camera
    num_pairs: int    # P = sum of squared track lengths
    pt_tile: object = None    # (T+1,) first point of each row tile, then N
    cell_ptr: object = None   # (U+1,) cell CSR over cell_a / cell_b
    cell_ca: object = None    # (U,) camera of the cell's block row
    cell_cb: object = None    # (U,) camera of the cell's block column
    cell_a: object = None     # (P,) first row of each pair, in cell order
    cell_b: object = None     # (P,) second row of each pair, in cell order
    diag_cell: object = None  # (M,) cell (c, c) of each camera, -1 if none

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
        P = int(np.sum(counts * counts))
        if max(len(oc), P) >= 2 ** 31:
            raise ValueError("problem too large for int32 plan indices")
        if M * M >= 2 ** 31:
            raise ValueError("too many cameras for int32 cell keys")
        return BAStructure(M, N, order, oc, op, pt_ptr, cam_ptr, cam_obs, P)

    def to(self, device) -> "BAStructure":
        """The plan on `device` (of a plan from `build`): row arrays as int32
        tensors, and the pair and cell plan built there."""
        dev = torch.device(device)
        rows = {f: torch.as_tensor(np.asarray(getattr(self, f),
                                              dtype=np.int32), device=dev)
                for f in _ROW_ARRAYS}
        return dataclasses.replace(self, **rows, **_device_plan(
            rows["pt_ptr"], rows["obs_cam"], self.num_cameras,
            self.num_pairs))


def _device_plan(pt_ptr, obs_cam, M, P):
    """Directed pairs of every point's rows, sorted by cell with a stable
    sort of the int32 keys obs_cam[a] * M + obs_cam[b] (so a cell keeps its
    pairs in point order), and the row tiles of kernel 2; on pt_ptr's
    device."""
    dev = pt_ptr.device
    N, K = pt_ptr.numel() - 1, obs_cam.numel()
    start = pt_ptr[:-1].long()
    counts = pt_ptr[1:].long() - start
    npairs = counts * counts
    owner = torch.repeat_interleave(torch.arange(N, device=dev), npairs,
                                    output_size=P)
    q = torch.arange(P, device=dev) - (torch.cumsum(npairs, 0) - npairs)[owner]
    ln = counts[owner]
    a = start[owner] + torch.div(q, ln, rounding_mode="floor")
    b = start[owner] + torch.remainder(q, ln)
    key, perm = torch.sort(obs_cam[a] * M + obs_cam[b], stable=True)
    cells, per_cell = torch.unique_consecutive(key, return_counts=True)
    cell_ca = torch.div(cells, M, rounding_mode="floor").int()
    cell_cb = torch.remainder(cells, M).int()
    diag = torch.nonzero(cell_ca == cell_cb)[:, 0]
    diag_cell = torch.full((M,), -1, dtype=torch.int32, device=dev)
    diag_cell[cell_ca[diag].long()] = diag.int()
    T = max(1, -(-K // ba_kernels.POINT_TILE_ROWS))
    bounds = torch.arange(T, dtype=torch.int32,
                          device=dev) * ba_kernels.POINT_TILE_ROWS
    pt_tile = torch.cat([
        torch.searchsorted(pt_ptr[:-1].contiguous(), bounds).int(),
        torch.full((1,), N, dtype=torch.int32, device=dev)])
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    return dict(pt_tile=pt_tile,
                cell_ptr=torch.cat([zero, torch.cumsum(per_cell, 0).int()]),
                cell_ca=cell_ca, cell_cb=cell_cb, cell_a=a[perm].int(),
                cell_b=b[perm].int(), diag_cell=diag_cell)


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


def linearize(plan: BAStructure, cams: BalCamera, points, uv,
              jac_dtype=torch.float64):
    """Whitened Jacobians A_cam (K,2,9), A_pt (K,2,3) (in jac_dtype) and
    b = -r (K,2) (float64) of the plan's rows; uv (K,2) is in row order.
    Matches gtsam_tpu.graph.factors.linearize of the BAL projection factor
    with unit noise (the batch built in gtsam_tpu/sfm/ba.py:1319), with
    out_dtype=jac_dtype and b_dtype=float64."""
    return ba_kernels.linearize(*_projection_args(plan, cams, points, uv),
                                jac_dtype)


def error(plan: BAStructure, cams: BalCamera, points, uv) -> float:
    """Half-chi2 0.5 * sum r^2 in float64, cheirality penalty included."""
    return float(ba_kernels.error(*_projection_args(plan, cams, points, uv)))


class Reduced(NamedTuple):
    """What `assemble` gives besides S: the reduced gradient g~ (M, 9), the
    scale s (9M,), the back-substitution's W, C, gl and, in the
    mixed-precision mode, the implicit matvec's WC and damped Hpp (M, 9, 9);
    all float64."""
    g: torch.Tensor
    s: torch.Tensor
    W: torch.Tensor
    C: torch.Tensor
    gl: torch.Tensor
    WC: torch.Tensor
    Hpp_d: Optional[torch.Tensor]


def assemble(plan: BAStructure, A_cam, A_pt, b, lam, diagonal_damping,
             S) -> Reduced:
    """Eliminate the landmarks and assemble the damped reduced camera system
    into S (9M x 9M, camera-major, overwritten; its rows may lie further
    apart, as _kernels.row_strided makes them), already Jacobi-equilibrated:
    S holds D^-1/2 S_red D^-1/2 with s = D^-1/2 = rsqrt(clamp(diag(S_red),
    1e-12)), the scaling of gtsam_tpu/sfm/ba.py _dense_spd_solve (:468-470).
    A_cam, A_pt and S are float64, or float32 (the mixed-precision mode:
    every sum in float64, each entry of S rounded once)."""
    W, WC, corr, C, gl = ba_kernels.point_eliminate(
        plan.pt_ptr, plan.pt_tile, A_cam, A_pt, b, lam, diagonal_damping)
    # One S buffer serves every try of a run (the JAX package builds a fresh
    # S each try).  The kernels write each touched cell once; the zero-fill
    # clears the rest, which the previous try's factorization filled in.
    S.zero_()
    g, s, *Hpp_d = ba_kernels.camera_assemble(
        plan.cam_ptr, plan.cam_obs, A_cam, b, corr, plan.cell_ptr,
        plan.diag_cell, plan.cell_a, plan.cell_b, WC, W, lam,
        diagonal_damping, S)
    ba_kernels.pair_assemble(plan.cell_ptr, plan.cell_ca, plan.cell_cb,
                             plan.cell_a, plan.cell_b, WC, W, s, S)
    return Reduced(g, s, W, C, gl, WC, Hpp_d[0] if Hpp_d else None)


def equilibrate(S):
    """Jacobi-equilibrate an arbitrary symmetric S in place; returns s with
    S now D^-1/2 S D^-1/2.  `assemble` gives S already equilibrated, so the
    BA path never calls this."""
    s = torch.diagonal(S).clamp(min=1e-12).rsqrt()
    S.mul_(s[:, None]).mul_(s[None, :])
    return s


# iterative-refinement passes of the mixed-precision solves: against the
# implicit matvec (float32 S) and against a float64 S (gtsam_tpu/sfm/ba.py
# :1260-1261, :1014)
REFINE_IMPLICIT = 3
REFINE_DENSE = 2


def _cholesky_in_place(S):
    """The blocked Cholesky factor (L, Dinv) of S, computed in S's own
    memory (linear/dense_blocked.py: kernel 10 and cuBLAS products on the
    card); None when the factorization fails.  The failure flag is read
    once per factorization."""
    L, Dinv, info = dense_blocked.blocked_cholesky(S)
    return (L, Dinv) if int(info) == 0 else None


def _cho_solve(factor, r):
    """S^-1 r from _cholesky_in_place's factor (kernel 11 on the card)."""
    return dense_blocked.blocked_cho_solve(*factor, r)


def _dense_spd_solve(S, rhs, s, mixed_precision=False, matvec=None,
                     S32=None):
    """Solve S_red x = rhs from the equilibrated S = D^-1/2 S_red D^-1/2 and
    s = D^-1/2 (gtsam_tpu/sfm/ba.py _dense_spd_solve, :453-529).  rhs, s
    and x are float64.  Returns None when the factorization fails.
      - float64 S, not mixed: Cholesky of S in place, x = s S^-1 (s rhs).
      - float32 S (the mixed mode's working phase): Cholesky of S in place,
        then x = s L^-T L^-1 (s rhs) refined REFINE_IMPLICIT times by
        x += s L^-T L^-1 (s (rhs - matvec(x))), the triangular solves in
        float32 and everything else in float64; matvec(x) = S_red x in
        float64 (kernel 5).
      - float64 S, mixed (the fallback phase): S is copied into the float32
        buffer S32 and that is factorized; the refinement (REFINE_DENSE
        passes) multiplies by S itself, which stays intact.
    S (or S32) is scratch, so no second n x n buffer is held beyond S32."""
    if S.dtype == torch.float64 and not mixed_precision:
        L = _cholesky_in_place(S)
        return None if L is None else _cho_solve(L, rhs * s) * s
    if S.dtype == torch.float32:
        L, passes = _cholesky_in_place(S), REFINE_IMPLICIT
    else:
        S32.copy_(S)            # each entry rounded once
        L, passes = _cholesky_in_place(S32), REFINE_DENSE

        def matvec(x):          # S_red x = D^1/2 S D^1/2 x
            return torch.mv(S, x / s) / s
    if L is None:
        return None

    def precond(r):
        return s * _cho_solve(L, (s * r).to(torch.float32)).to(torch.float64)

    x = precond(rhs)
    for _ in range(passes):
        x = x + precond(rhs - matvec(x))
    return x


def _schur_step(plan, A_cam, A_pt, b, lam, diagonal_damping, S,
                mixed_precision=False, S32=None):
    """(dc, dl) of one LM try, or None when the factorization fails.  The
    mode follows the dtypes as gtsam_tpu/sfm/ba.py:1077-1081 routes them:
    float64 A (and S) is the float64 path (mixed_precision: the fallback
    phase, which needs S32); float32 A (and S) with float64 b is the mixed
    mode's working phase.  dc is float64 and dl has A's dtype (the
    reference rounds dl to the working dtype, gtsam_tpu/sfm/ba.py:1035)."""
    if A_cam.dtype == torch.float32 and not (mixed_precision
                                             and b.dtype == torch.float64):
        raise ValueError("float32 Jacobians need mixed_precision=True and a "
                         "float64 b")
    red = assemble(plan, A_cam, A_pt, b, lam, diagonal_damping, S)
    matvec = None
    if A_cam.dtype == torch.float32:
        def matvec(x):
            return ba_kernels.schur_matvec(
                plan.pt_ptr, plan.pt_tile, plan.obs_cam, plan.obs_pt,
                plan.cam_ptr, plan.cam_obs, red.W, red.WC, red.Hpp_d,
                x.view(-1, 9)).view(-1)
    x = _dense_spd_solve(S, red.g.reshape(-1), red.s, mixed_precision,
                         matvec, S32)
    if x is None:
        return None
    dc = x.reshape(-1, 9)
    dl = ba_kernels.back_substitute(plan.pt_ptr, plan.pt_tile, plan.obs_cam,
                                    red.W, dc, red.C, red.gl)
    return dc, dl.to(A_cam.dtype)


def schur_solve(plan: BAStructure, A_cam, A_pt, b, lam,
                diagonal_damping=False, mixed_precision=False):
    """Solve the damped Gauss-Newton system by landmark elimination.

    A_cam (K,2,9), A_pt (K,2,3), b (K,2) in the plan's row order (a plan on
    the tensors' device).  float64 A: the float64 solve (with
    mixed_precision, an f32 factorization refined against the float64 S);
    float32 A with float64 b and mixed_precision: the mixed mode's working
    phase.  Returns (dc (M,9) float64, dl (N,3) of A's dtype) with dl in
    original point numbering and 0 for points without observations; both
    are NaN when the Cholesky factorization fails.
    """
    M, n = plan.num_cameras, 9 * plan.num_cameras
    dev = A_cam.device
    S = row_strided(n, A_cam.dtype, dev)
    S32 = None
    if mixed_precision and A_cam.dtype == torch.float64:
        S32 = row_strided(n, torch.float32, dev)
    step = _schur_step(plan, A_cam, A_pt, b, lam, diagonal_damping, S,
                       mixed_precision, S32)
    if step is None:
        nan = float("nan")
        return (torch.full((M, 9), nan, dtype=torch.float64, device=dev),
                torch.full((plan.num_points, 3), nan, dtype=A_cam.dtype,
                           device=dev))
    return step


def ba_optimize(prob: BalProblem, params: Optional[LMParams] = None,
                verbose: bool = False, target_error: Optional[float] = None,
                device=None, initial=None, dtype=None,
                mixed_precision: bool = False):
    """Full BAL bundle adjustment: LM with Schur elimination.

    Returns ({"cams": BalCamera, "points": (N,3)}, info) with info keys
    error, iterations, converged, history, iter_times, phases.
    target_error: stop as soon as the half-chi2 is at or below it.
    device: CUDA when None (raises without CUDA); "cpu" runs the plain
    versions of the kernels.  initial: optional (cams, points) state, as
    from state_from_numpy, in place of the problem's own.
    dtype: the working dtype of the Jacobians and S, float64 (the default)
    or float32.  mixed_precision: factorize in float32 and refine in
    float64 (gtsam_tpu/sfm/ba.py ba_optimize's two-phase schedule).  With
    dtype=float32 the run starts in the working phase (float32 Jacobians
    and S, the implicit matvec); when an iteration is not accepted or gains
    less than switch_tol = max(10 relative_error_tol, 1e-7) of the error, it
    switches to the float64 phase for good (lambda = min(lambda,
    lambda_initial); an iteration that was not accepted is tried again
    there).  info["phases"] names each iteration's phase.  The state and
    residuals are float64 throughout; float32 without mixed_precision is
    not supported.
    """
    params = params or LMParams()
    dt = working_dtype(dtype)
    if dt == torch.float32 and not mixed_precision:
        raise ValueError("float32 BA runs only with mixed_precision=True")
    hi = default_dtype()
    dev = resolve_device(device)
    plan = BAStructure.build(prob.obs_cam, prob.obs_pt, prob.num_cameras,
                             prob.num_points).to(dev)
    uv = torch.as_tensor(prob.obs_uv[plan.order], dtype=hi, device=dev)
    if initial is None:
        initial = state_from_numpy(prob.cam_R, prob.cam_t, prob.cam_calib,
                                   prob.points, dev)
    cams, pts = initial
    n = 9 * prob.num_cameras
    buffers = {}   # n x n scratch by dtype, allocated when a phase needs it

    def buffer(dtype):
        if dtype not in buffers:
            buffers[dtype] = row_strided(n, dtype, dev)
        return buffers[dtype]

    pdt = dt
    switch_tol = max(10.0 * params.relative_error_tol, 1e-7)
    err = error(plan, cams, pts, uv)
    history = [err]
    iter_times = []
    phases = []
    lam = params.lambda_initial
    lam_fail_ceiling = 0.0   # conservative policy: largest lambda that failed
    it = 0
    converged = False
    for it in range(1, params.max_iterations + 1):
        t0 = time.time()
        S = buffer(pdt)
        S32 = (buffer(torch.float32)
               if mixed_precision and pdt == torch.float64 else None)
        A_cam, A_pt, b = linearize(plan, cams, pts, uv, pdt)
        prev = err
        accepted = False
        lam_entry = lam
        while True:
            step = _schur_step(plan, A_cam, A_pt, b, lam,
                               params.diagonal_damping, S, mixed_precision,
                               S32)
            ne = math.inf
            if step is not None:
                dc, dl = step
                nc, npts = bal_retract(cams, dc), pts + dl.to(hi)
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
        phases.append(str(pdt).replace("torch.", ""))
        if verbose:
            print(f"BA iter {it} [{phases[-1]}]: {prev:.6g} -> {err:.6g} "
                  f"lambda={lam:.3g} ({iter_times[-1]:.3f}s)", flush=True)
        history.append(err)
        if target_error is not None and err <= target_error:
            converged = True
            break
        if pdt != hi and (not accepted or (prev - err) < switch_tol * prev):
            pdt = hi
            lam = min(lam, params.lambda_initial)
            if not accepted:
                continue   # try this iteration again in the float64 phase
        if not accepted:
            break
        if check_convergence(prev, err, params):
            converged = True
            break
    return dict(cams=cams, points=pts), dict(
        error=err, iterations=it, converged=converged, history=history,
        iter_times=iter_times, phases=phases)
