"""Wrappers of the hand-written CUDA kernels of the supernodal paths.

Kernels 6-9 (csrc/pg_between.cu, pg_pose2.cu, sn_factor.cu, sn_solve.cu,
sn_matvec.cu) port the device routines of the JAX package's pose-graph LM:
the SE3 and SE2 (Pose2) between/prior linearization with block-store
assembly (gtsam_tpu/graph/factors.py, linear/supernodal.py::system), the
level-batched supernodal factorization (supernodal.py::factorize), the
forward and backward substitution (_solve_padded: one launch per direction
over all levels, on the inverses of the fronts' diagonal tiles that the
factorization leaves) and the refinement matvec (matvec).  Kernels 17 and
18 (csrc/proj_factor.cu) linearize and evaluate the projection factors of
the graph-form bundle adjustment and of SE3 + Point3 SLAM into the same
buffers.  Every tensor is
float64 (int32 indices, bool masks), row-major and contiguous, in the
layout of
gtsam_torch/linear/supernodal.py: the block store is (B+1, d*d) with a
zero sentinel row B, vectors are (n, d) in the permuted (elimination)
order.  Each wrapper
  - on CPU tensors computes its plain PyTorch version (`*_plain`), which the
    CPU tests compare against the JAX package;
  - on CUDA tensors checks dtype, shape, contiguity and device, launches its
    kernel on the current stream and counts the launch.
It never falls back to the plain version on a CUDA tensor.  No kernel sums
with atomics: every sum runs in an order fixed by the plan (pg_error's
across its CTAs by N alone; its one atomic is a completion ticket), so two
runs on the same inputs give the same bits.

Kernel 7 takes two launches a level: the front kernel factors and inverts
the level's fronts (and leaves the inverses of their diagonal tiles for
kernel 8), and the Schur update forms the panel Lp = A L^-T as
(L^-1 A^T)^T, U = Lp Lp^T's block-lower triangle and the scatter into the
working store, over the whole card.  Kernels 7 and 8 take any front
widths: at the 2D graphs' store width d = 3 a front's W*d and R*d are
often odd, and the kernels move a pair of entries 16 bytes at a time where
it is 16-byte aligned and 8 where not (the store stays 3 wide).  A level
of narrow fronts (narrow_route: one 32 x 32 tile wide, panels of at most
64 rows; the graph-form BA's one-point fronts) takes kernel 7's narrow
route instead (csrc/sn_narrow.cu): a launch factors its fronts a warp
each, many a CTA, and sums their U blocks a row a (chunk, target); a
second sums each target's rows and subtracts once.
"""

from typing import NamedTuple

import numpy as np
import torch

from .. import _kernels
from .._kernels import (DBL, INT, P, Kernel, check, on_cpu, ptr,
                       segment_owner)
from ..base import losses
from ..geometry import se2, se3
from ..geometry.se3 import SE3

F64 = torch.float64
I32 = torch.int32
BOOL = torch.bool

# kernel 6's noise kinds; 'constrained' is a diagonal whose zeros mark the
# hard rows
NOISE_KINDS = {"unit": 0, "diagonal": 1, "gaussian": 2, "constrained": 3}

KERNELS = _kernels.table(
    Kernel("pg_linearize", "pg_between", "pg_linearize",
           "gtsam_tpu/graph/factors.py:147",
           [INT, INT, INT] + [P] * 5 + [INT, INT, P, DBL, INT, DBL, P, P,
                                        P]),
    Kernel("pg_assemble", "pg_between", "pg_assemble",
           "gtsam_tpu/linear/supernodal.py:320", [INT] * 3 + [P] * 11),
    Kernel("pg_error", "pg_between", "pg_error",
           "gtsam_tpu/graph/graph.py:108",
           [INT, INT] + [P] * 5 + [INT, INT, P, DBL, INT, DBL, DBL, P, P,
                                   P]),
    Kernel("pg2_linearize", "pg_pose2", "pg2_linearize",
           "gtsam_tpu/graph/factors.py:147",
           [INT, INT, INT] + [P] * 3 + [INT, INT, P, DBL, INT, DBL, P, P,
                                        P]),
    Kernel("pg2_error", "pg_pose2", "pg2_error",
           "gtsam_tpu/graph/graph.py:108",
           [INT, INT] + [P] * 3 + [INT, INT, P, DBL, INT, DBL, DBL, P, P,
                                   P]),
    Kernel("sn_front_factor", "sn_factor", "sn_front_factor",
           "gtsam_tpu/linear/supernodal.py:404",
           [INT] * 9 + [P] * 9 + [DBL, INT, DBL, DBL] + [P] * 7),
    Kernel("sn_pivot_check", "sn_factor", "sn_pivot_check",
           "gtsam_tpu/linear/supernodal.py:405", [INT, P, P]),
    Kernel("sn_schur_update", "sn_factor", "sn_schur_update",
           "gtsam_tpu/linear/supernodal.py:431", [INT] * 11 + [P] * 9),
    Kernel("sn_narrow_front", "sn_narrow", "sn_narrow_front",
           "gtsam_tpu/linear/supernodal.py:404",
           [INT] * 7 + [P] * 13 + [DBL, INT, DBL, DBL] + [P] * 6),
    Kernel("sn_narrow_scatter", "sn_narrow", "sn_narrow_scatter",
           "gtsam_tpu/linear/supernodal.py:441", [INT] * 2 + [P] * 5),
    Kernel("sn_forward", "sn_solve", "sn_forward",
           "gtsam_tpu/linear/supernodal.py:580", [INT] * 5 + [P] * 9),
    Kernel("sn_backward", "sn_solve", "sn_backward",
           "gtsam_tpu/linear/supernodal.py:593", [INT] * 5 + [P] * 6),
    Kernel("sn_matvec", "sn_matvec", "sn_matvec",
           "gtsam_tpu/linear/supernodal.py:456",
           [INT] * 2 + [P] * 10 + [DBL, INT, DBL, DBL, P]),
    Kernel("pg_jacobians", "pg_between", "pg_jacobians",
           "gtsam_tpu/linear/supernodal.py:769",
           [INT] * 4 + [P] * 5 + [INT, INT, P, INT, DBL, P]),
    Kernel("pg2_jacobians", "pg_pose2", "pg2_jacobians",
           "gtsam_tpu/linear/supernodal.py:769",
           [INT] * 4 + [P] * 3 + [INT, INT, P, INT, DBL, P]),
    Kernel("sn_front_qr", "sn_qr", "sn_front_qr",
           "gtsam_tpu/linear/supernodal.py:800",
           [INT] * 8 + [P] * 18 + [DBL, DBL] + [P] * 7),
    Kernel("proj_linearize", "proj_factor", "proj_linearize",
           "gtsam_tpu/graph/factors.py:147",
           [INT, INT] + [P] * 6 + [INT, INT, P, DBL, INT, DBL] + [P] * 9),
    Kernel("proj_jacobians", "proj_factor", "proj_jacobians",
           "gtsam_tpu/linear/supernodal.py:769",
           [INT] * 3 + [P] * 6 + [INT, INT, P, INT, DBL, P]),
    Kernel("proj_error", "proj_factor", "proj_error",
           "gtsam_tpu/graph/graph.py:108",
           [INT] + [P] * 6 + [INT, INT, P, DBL, INT, DBL, DBL, P, P, P]),
    Kernel("proj3_linearize", "proj_factor", "proj3_linearize",
           "gtsam_tpu/graph/factors.py:147",
           [INT, INT] + [P] * 7 + [INT, INT, P, DBL, INT, DBL] + [P] * 9),
    Kernel("proj3_jacobians", "proj_factor", "proj3_jacobians",
           "gtsam_tpu/linear/supernodal.py:769",
           [INT] * 3 + [P] * 7 + [INT, INT, P, INT, DBL, P]),
    Kernel("proj3_error", "proj_factor", "proj3_error",
           "gtsam_tpu/graph/graph.py:108",
           [INT] + [P] * 7 + [INT, INT, P, DBL, INT, DBL, DBL, P, P, P]),
)


def _tensors(*maybe):
    """The arguments that are not None (optional tensors)."""
    return tuple(t for t in maybe if t is not None)


def _width(dd):
    d = int(round(dd ** 0.5))
    if d * d != dd:
        raise ValueError(f"block width {dd} is not a square")
    return d


# -- kernel 6: SE3 and SE2 between / prior linearization, assembly, error -----


def _pair_slots(arity):
    return ((0, 0), (0, 1), (1, 1)) if arity == 2 else ((0, 0),)


def _residual_plain(R, t, rows, ZR, Zt):
    """r = Log(Z^-1 T_i^-1 T_j) (between) or Log(Z^-1 T_i) (prior), and the
    relative pose T_j^-1 T_i of a between factor (None for a prior)."""
    r0 = rows[:, 0].long()
    Ti = SE3(R[r0], t[r0])
    Z = SE3(ZR, Zt)
    if rows.shape[1] == 1:
        return se3.logmap(se3.between(Z, Ti)), None
    r1 = rows[:, 1].long()
    Tj = SE3(R[r1], t[r1])
    return (se3.logmap(se3.between(Z, se3.between(Ti, Tj))),
            se3.between(Tj, Ti))


def _residual2_plain(x, rows, Z):
    """_residual_plain of SE2 poses x (n, 3) and measurements Z (N, 3)."""
    Ti = x[rows[:, 0].long()]
    if rows.shape[1] == 1:
        return se2.logmap(se2.between(Z, Ti)), None
    Tj = x[rows[:, 1].long()]
    return (se2.logmap(se2.between(Z, se2.between(Ti, Tj))),
            se2.between(Tj, Ti))


def _whiten(kind, noise, r):
    if kind == "unit":
        return r
    if kind in ("diagonal", "constrained"):
        return r * noise
    return (noise @ r[..., None])[..., 0]


def _norm(wr):
    """||wr|| of each row, summed in index order as kernel 6 does."""
    return torch.sqrt(torch.sum(wr * wr, dim=-1))


def _whitened(r, J, kind, noise, loss, param):
    """(R_w J_s for each slot, -R_w r), both scaled by sqrt(w(||R_w r||))
    under a loss (a code of base/losses.py, 0: none)."""
    if kind == "unit":
        A = J
    elif kind in ("diagonal", "constrained"):
        A = tuple(Ji * noise[..., None] for Ji in J)
    else:
        A = tuple(noise @ Ji for Ji in J)
    wr = _whiten(kind, noise, r)
    if loss:
        sw = torch.sqrt(losses.from_code(loss, param).weight(_norm(wr)))
        A = tuple(Ai * sw[:, None, None] for Ai in A)
        wr = wr * sw[:, None]
    return A, -wr


def _jacobian_rows(A, out):
    """Whitened Jacobians A (a tuple over slots of (N, k, k)) into `out`
    (N, arity, rmax, d): slot s's k rows, zero past column k; rows k..rmax
    are left as they are."""
    k = A[0].shape[-1]
    d = out.shape[-1]
    for s, As in enumerate(A):
        out[:, s, :k] = torch.nn.functional.pad(As, (0, d - k))
    return out


def pg_jacobians_plain(R, t, rows, ZR, Zt, kind, noise, loss=0, param=0.0,
                       out=None):
    """Whitened Jacobians (A_0[, A_1]) (N, 6, 6) and b = -R_w r (N, 6) of
    SE3 between (arity 2) or prior (arity 1) factors, in closed form: with
    r = Log(Z^-1 T_i^-1 T_j), A_j = R_w Jr^-1(r) and
    A_i = -R_w Jr^-1(r) Ad(T_j^-1 T_i); a prior has A = R_w Jr^-1(r).
    `loss` (a code of base/losses.py, 0: none) with its parameter scales
    both by sqrt(w(||R_w r||)) after the whitening (IRLS).  With `out`
    (N, arity, rmax, d): the A rows written into it as pg_jacobians writes
    them, and `out` returned."""
    r, Tji = _residual_plain(R, t, rows, ZR, Zt)
    Jinv = se3.right_jacobian_inverse(r)
    J = (Jinv,) if Tji is None else (-(Jinv @ se3.adjoint(Tji)), Jinv)
    A, b = _whitened(r, J, kind, noise, loss, param)
    return (A, b) if out is None else _jacobian_rows(A, out)


def pg2_jacobians_plain(x, rows, Z, kind, noise, loss=0, param=0.0,
                        out=None):
    """pg_jacobians_plain of SE2 factors ((N, 3, 3) and (N, 3)), with SE(2)'s
    Jr^-1 and adjoint (geometry/se2.py), in the tangent order [vx, vy,
    w]."""
    r, P = _residual2_plain(x, rows, Z)
    Jinv = se2.right_jacobian_inverse(r)
    J = (Jinv,) if P is None else (-(Jinv @ se2.adjoint(P)), Jinv)
    A, b = _whitened(r, J, kind, noise, loss, param)
    return (A, b) if out is None else _jacobian_rows(A, out)


def _blocks_plain(A, b, sign, flip, H, gv):
    """What kernel 6's linearize writes for whitened (A, b): H and gv."""
    N, arity, d = gv.shape
    k = b.shape[1]
    H.zero_()
    gv.zero_()
    Hv = H.view(N, -1, d, d)
    for p, (s1, s2) in enumerate(_pair_slots(arity)):
        Hij = sign * torch.einsum("nri,nrj->nij", A[s1], A[s2])
        if s1 != s2:
            Hij = torch.where(flip[:, None, None], Hij.transpose(1, 2), Hij)
        Hv[:, p, :k, :k] = Hij
    for s in range(arity):
        gv[:, s, :k] = sign * torch.einsum("nrd,nr->nd", A[s], b)


def pg_linearize_plain(R, t, rows, ZR, Zt, kind, noise, sign, flip, H, gv,
                       loss=0, param=0.0):
    _blocks_plain(*pg_jacobians_plain(R, t, rows, ZR, Zt, kind, noise, loss,
                                      param), sign, flip, H, gv)


def pg2_linearize_plain(x, rows, Z, kind, noise, sign, flip, H, gv, loss=0,
                        param=0.0):
    _blocks_plain(*pg2_jacobians_plain(x, rows, Z, kind, noise, loss, param),
                  sign, flip, H, gv)


def _factor_specs(name, rows, kind, noise, loss, rdim, *specs):
    """Checks of the arguments of kernel 6's linearize and error (`specs`:
    the group's own, then more); returns (device, noise kind code, noise
    stride, noise pointer)."""
    if loss not in range(len(losses.CODES) + 1):
        raise ValueError(f"{name}: loss code {loss} is not one of kernel "
                         "6's")
    if loss and kind == "constrained":
        raise ValueError(f"{name}: a robust loss on constrained noise")
    N, arity = rows.shape
    if arity not in (1, 2):
        raise ValueError(f"{name}: rows must have 1 or 2 slots, got {arity}")
    if kind not in NOISE_KINDS:
        raise NotImplementedError(f"{name}: noise kind {kind!r}")
    specs = list(specs)
    if kind != "unit":
        M = noise.shape[0]
        if M not in (1, N):
            raise ValueError(f"{name}: noise must have 1 or {N} rows, got {M}")
        specs.append(("noise", noise, F64, (M, rdim, rdim)
                      if kind == "gaussian" else (M, rdim)))
    dev = check(name, *specs)
    if kind == "unit":
        return dev, 0, 0, 0
    stride = 0 if noise.shape[0] == 1 else noise[0].numel()
    return dev, NOISE_KINDS[kind], stride, ptr(noise)


def _se3_specs(name, R, t, rows, ZR, Zt, kind, noise, loss, *extra):
    Nv, N = R.shape[0], rows.shape[0]
    return _factor_specs(name, rows, kind, noise, loss, 6,
                         ("R", R, F64, (Nv, 3, 3)), ("t", t, F64, (Nv, 3)),
                         ("rows", rows, I32, tuple(rows.shape)),
                         ("ZR", ZR, F64, (N, 3, 3)), ("Zt", Zt, F64, (N, 3)),
                         *extra)


def _se2_specs(name, x, rows, Z, kind, noise, loss, *extra):
    return _factor_specs(name, rows, kind, noise, loss, 3,
                         ("x", x, F64, (x.shape[0], 3)),
                         ("rows", rows, I32, tuple(rows.shape)),
                         ("Z", Z, F64, (rows.shape[0], 3)), *extra)


def _out_specs(N, arity, d, flip, H, gv):
    return (("flip", flip, BOOL, (N,)),
            ("H", H, F64, (N, len(_pair_slots(arity)), d * d)),
            ("gv", gv, F64, (N, arity, d)))


# factors of a CTA of pg_linearize_kernel, a lane pair each (kLinFactors in
# csrc/pg_between.cu), and of pg2_linearize_kernel, a lane each (kP2Factors
# in csrc/pg_pose2.cu)
LINEARIZE_FACTORS = 16
LINEARIZE2_FACTORS = 32


def pg_linearize(R, t, rows, ZR, Zt, kind, noise, sign, flip, H, gv,
                 loss=0, param=0.0):
    """Kernel 6, linearize: for each SE3 between (arity 2) or prior (arity
    1) factor n, writes sign A_s1^T A_s2 of each slot pair (s1 <= s2; the
    (0, 1) block transposed where flip[n]) into H[n, pair] ((N, P, d*d), P
    = 3 or 1, zero outside the leading 6x6) and sign A_s^T b into
    gv[n, s] ((N, arity, d)).  R, t: the SE3 values; rows: (N, arity)
    int32 rows of the slots; ZR, Zt: the measurements; noise: None (unit),
    (1 or N, 6) inverse sigmas (diagonal, or constrained: its zeros the
    hard rows, which get weight 0) or (1 or N, 6, 6) square-root
    informations; loss: a code of base/losses.py (0: none) and its
    parameter, whose IRLS weight scales A and b.  On the card one launch
    of one-warp CTAs, LINEARIZE_FACTORS factors each, that stage their
    factors' blocks in shared memory and copy their spans of H and gv out
    with coalesced stores (d <= 12)."""
    args = (R, t, rows, ZR, Zt)
    if on_cpu(*args, *_tensors(noise), flip, H, gv):
        return pg_linearize_plain(*args, kind, noise, sign, flip, H, gv,
                                  loss, param)
    N, arity = rows.shape
    d = gv.shape[-1]
    dev, code, stride, nptr = _se3_specs(
        "pg_linearize", *args, kind, noise, loss,
        *_out_specs(N, arity, d, flip, H, gv))
    if d < 6:
        raise ValueError(f"pg_linearize: block width {d} < 6")
    KERNELS["pg_linearize"].launch(dev, N, arity, d, *map(ptr, args), code,
                                   stride, nptr, float(sign), int(loss),
                                   float(param), ptr(flip), ptr(H), ptr(gv))


def pg2_linearize(x, rows, Z, kind, noise, sign, flip, H, gv, loss=0,
                  param=0.0):
    """Kernel 6's Pose2 variant, linearize: pg_linearize for SE2 between or
    prior factors; x (n, 3) the SE2 values, Z (N, 3) the measurements,
    noise None, (1 or N, 3) or (1 or N, 3, 3); H and gv zero outside the
    leading 3x3 and 3 (3 <= d <= 12).  On the card one launch of one-warp
    CTAs, LINEARIZE2_FACTORS factors each, a lane a factor, that copy
    their spans of H and gv out with coalesced stores."""
    args = (x, rows, Z)
    if on_cpu(*args, *_tensors(noise), flip, H, gv):
        return pg2_linearize_plain(*args, kind, noise, sign, flip, H, gv,
                                   loss, param)
    N, arity = rows.shape
    d = gv.shape[-1]
    dev, code, stride, nptr = _se2_specs(
        "pg2_linearize", *args, kind, noise, loss,
        *_out_specs(N, arity, d, flip, H, gv))
    if d < 3:
        raise ValueError(f"pg2_linearize: block width {d} < 3")
    KERNELS["pg2_linearize"].launch(dev, N, arity, d, *map(ptr, args), code,
                                    stride, nptr, float(sign), int(loss),
                                    float(param), ptr(flip), ptr(H), ptr(gv))


def _jacobian_launch(name, spec, group_rdim, args, loss, param, out):
    dev, code, stride, nptr = spec
    N, arity, rmax, d = out.shape
    if d < group_rdim or rmax < group_rdim:
        raise ValueError(f"{name}: rows of {rmax} x {d} hold no "
                         f"{group_rdim} x {group_rdim} Jacobian")
    KERNELS[name].launch(dev, N, arity, d, rmax, *map(ptr, args), code,
                         stride, nptr, int(loss), float(param), ptr(out))
    return out


def pg_jacobians(R, t, rows, ZR, Zt, kind, noise, loss, param, out):
    """Kernel 6, Jacobian rows (the QR path's output mode of pg_linearize):
    each SE3 between or prior factor's whitened Jacobians A_s (6 x 6, under
    a loss scaled by sqrt(w), as pg_linearize scales them; no sign) into
    out[n, s, :6] ((N, arity, rmax, d), zero past column 6; rows 6..rmax
    are not written).  Arguments as pg_linearize's.  On the card one
    launch of pg_linearize's kernel in its Jacobian mode (a template flag:
    the Gram mode's code is unchanged)."""
    args = (R, t, rows, ZR, Zt)
    if on_cpu(*args, *_tensors(noise), out):
        return pg_jacobians_plain(*args, kind, noise, loss, param, out)
    N, arity = rows.shape
    spec = _se3_specs("pg_jacobians", *args, kind, noise, loss,
                      ("out", out, F64, (N, arity) + tuple(out.shape[2:])))
    return _jacobian_launch("pg_jacobians", spec, 6, args, loss, param, out)


def pg2_jacobians(x, rows, Z, kind, noise, loss, param, out):
    """Kernel 6's Pose2 variant, Jacobian rows: pg_jacobians of SE2 factors
    (3 x 3 Jacobians into out[n, s, :3], zero past column 3).  On the card
    one launch of pg2_linearize's kernel in its Jacobian mode."""
    args = (x, rows, Z)
    if on_cpu(*args, *_tensors(noise), out):
        return pg2_jacobians_plain(*args, kind, noise, loss, param, out)
    N, arity = rows.shape
    spec = _se2_specs("pg2_jacobians", *args, kind, noise, loss,
                      ("out", out, F64, (N, arity) + tuple(out.shape[2:])))
    return _jacobian_launch("pg2_jacobians", spec, 3, args, loss, param,
                            out)


def _error_plain(r, kind, noise, sign, loss, param, mu):
    wr = _whiten(kind, noise, r)
    if loss:
        return sign * torch.sum(losses.from_code(loss, param).loss(
            _norm(wr)))
    if kind == "constrained":
        v = torch.sum(wr * wr, dim=-1) + mu * torch.sum(
            torch.where(noise == 0, r, 0.0) ** 2, dim=-1)
        return sign * (0.5 * torch.sum(v))
    return sign * (0.5 * torch.sum(wr * wr))


def pg_error_plain(R, t, rows, ZR, Zt, kind, noise, sign, loss=0,
                   param=0.0, mu=1000.0):
    return _error_plain(_residual_plain(R, t, rows, ZR, Zt)[0], kind, noise,
                        sign, loss, param, mu)


def pg2_error_plain(x, rows, Z, kind, noise, sign, loss=0, param=0.0,
                    mu=1000.0):
    return _error_plain(_residual2_plain(x, rows, Z)[0], kind, noise, sign,
                        loss, param, mu)


# factors of a CTA of pg_error_kernel and pg2_error_kernel, one a thread
# (kErrorThreads in csrc/pg_between.cu and pg_pose2.cu): the launch writes
# one partial a CTA
ERROR_BLOCK = 32


def _error_launch(name, dev, N, arity, args, code, stride, nptr, sign, loss,
                  param, mu):
    ticket, part = _kernels.sum_scratch(dev, max(1, -(-N // ERROR_BLOCK)))
    out = torch.empty((), dtype=F64, device=dev)
    lead = (N,) if arity is None else (N, arity)
    KERNELS[name].launch(dev, *lead, *(0 if a is None else ptr(a)
                                       for a in args), code, stride, nptr,
                         float(sign), int(loss), float(param), float(mu),
                         ptr(part), ptr(ticket), ptr(out))
    return out


def pg_error(R, t, rows, ZR, Zt, kind, noise, sign, loss=0, param=0.0,
             mu=1000.0):
    """Kernel 6, error: sign * 0.5 * sum ||R_w r||^2 over the batch's SE3
    between or prior factors, a 0-d tensor; with a loss (a code of
    base/losses.py and its parameter) sign * sum rho(||R_w r||); under
    constrained noise plus sign * 0.5 mu r^2 on the hard rows.  On the
    card one launch over a grid of ceil(N / ERROR_BLOCK) CTAs, each
    writing its partial, the last to finish summing them in index order:
    the order of every addition is fixed by N alone."""
    args = (R, t, rows, ZR, Zt)
    if on_cpu(*args, *_tensors(noise)):
        return pg_error_plain(*args, kind, noise, sign, loss, param, mu)
    N, arity = rows.shape
    dev, code, stride, nptr = _se3_specs("pg_error", *args, kind, noise,
                                         loss)
    return _error_launch("pg_error", dev, N, arity, args, code, stride, nptr,
                         sign, loss, param, mu)


def pg2_error(x, rows, Z, kind, noise, sign, loss=0, param=0.0, mu=1000.0):
    """Kernel 6's Pose2 variant, error: pg_error for SE2 between or prior
    factors (x, Z as in pg2_linearize), one launch the same way."""
    args = (x, rows, Z)
    if on_cpu(*args, *_tensors(noise)):
        return pg2_error_plain(*args, kind, noise, sign, loss, param, mu)
    N, arity = rows.shape
    dev, code, stride, nptr = _se2_specs("pg2_error", *args, kind, noise,
                                         loss)
    return _error_launch("pg2_error", dev, N, arity, args, code, stride,
                         nptr, sign, loss, param, mu)


# -- kernels 17 and 18: projection factors (csrc/proj_factor.cu) -------------
#
# Two variants: the BalCamera group (BalCamera + Point3, the graph form's
# ProjectionBal batch: R, t, calib (nc, 3) of the cameras) and the
# GenericProjection group (SE3 + Point3 with a fixed Cal3_S2 K (5,) and an
# optional body-to-sensor extrinsic ext (12,): Rb row-major, then tb).
# Each has a Gram mode (proj*_linearize: H (N, 3, d*d), gv (N, 2, d)), a
# Jacobian mode (proj*_jacobians: the pool's rows) and an error
# (proj*_error).  The residual is projection - uv, the constant
# CHEIRALITY_PENALTY with zero Jacobians at z <= CHEIRALITY_EPS.

CHEIRALITY_EPS = 1e-8
CHEIRALITY_PENALTY = 1e3
# factors of a CTA of the Jacobian mode's proj_jacobians_kernel, a lane
# each (kFactors in csrc/proj_factor.cu)
PROJ_FACTORS = 32
# factors of a CTA of the Gram mode's proj_gram_kernel, a thread each
# (kChunk): a chunk of a batch's factors in plan order
PROJ_CHUNK = 256
# the kinds of a Gram-mode row: the slot pairs (0, 0), (0, 1), (1, 1) (rows
# of H), then the slots 0 and 1 (rows of gv)
GRAM_KINDS = 5
GRAM_SLOT0 = 3


class GramPlan(NamedTuple):
    """Kernel 17's Gram-mode plan of one projection batch of N factors
    (int32, numpy arrays on the host or tensors on the device).  Chunk c
    holds the factors order[c * PROJ_CHUNK:(c + 1) * PROJ_CHUNK], at
    positions 0.. in it; its rows are cptr[c]..cptr[c + 1], each of kind
    rkind[r] (0 camera-camera, 1 camera-point, 2 point-point: a row of H;
    3 camera, 4 point: a row of gv) summing the chunk's factors at
    positions mem[mptr[r]:mptr[r + 1]] (ascending) into row rout[r] of H or
    of gv.  A chunk's rows of H come first, and rout numbers the rows of H
    (and of gv) in row order, so a chunk's are consecutive rows: the kernel
    writes them as one span."""

    order: object
    cptr: object
    rkind: object
    mptr: object
    mem: object
    rout: object


def proj_gram_plan(cam, pt):
    """The Gram plan of factors with camera ids `cam` and point ids `pt`
    ((N,) ints: equal ids, one variable).  The factors are sorted by the
    first camera that sees their point, then by point (stable), so a
    point's factors share a chunk and a chunk holds few cameras, and cut
    into chunks of PROJ_CHUNK; each chunk has a row for each camera (kinds
    0 and 3), each (camera, point) pair (1) and each point (2 and 4) its
    factors name, rows in (kind, id) order, chunk after chunk.  Returns
    (GramPlan of numpy int32 arrays, rep (R,) int64: each row's first
    member, a factor of its target)."""
    cam = np.asarray(cam, dtype=np.int64)
    pt = np.asarray(pt, dtype=np.int64)
    N = cam.shape[0]
    npt = int(pt.max()) + 1 if N else 1
    first = np.full(npt, np.iinfo(np.int64).max)
    np.minimum.at(first, pt, cam)
    order = np.lexsort((pt, first[pt]))
    pos = np.empty(N, np.int64)
    pos[order] = np.arange(N)
    ch, loc = pos // PROJ_CHUNK, pos % PROJ_CHUNK
    pair = cam * npt + pt
    K = GRAM_KINDS
    ich, iloc = np.tile(ch, K), np.tile(loc, K)
    ikind = np.repeat(np.arange(K), N)
    ikey = np.concatenate([cam, pair, pt, cam, pt])
    o = np.lexsort((iloc, ikey, ikind, ich))
    sch, skind, skey = ich[o], ikind[o], ikey[o]
    new = np.ones(K * N, dtype=bool)
    new[1:] = ((sch[1:] != sch[:-1]) | (skind[1:] != skind[:-1])
               | (skey[1:] != skey[:-1]))
    start = np.flatnonzero(new)
    rkind = skind[start]
    hrow = rkind < GRAM_SLOT0
    rout = np.where(hrow, np.cumsum(hrow) - 1, np.cumsum(~hrow) - 1)
    nchunk = -(-N // PROJ_CHUNK)
    i32 = np.int32
    plan = GramPlan(
        order=order.astype(i32),
        cptr=np.searchsorted(sch[start], np.arange(nchunk + 1)).astype(i32),
        rkind=rkind.astype(i32),
        mptr=np.append(start, K * N).astype(i32),
        mem=iloc[o].astype(i32), rout=rout.astype(i32))
    return plan, np.tile(np.arange(N), K)[o][start]


def gram_rows(plan):
    """(rows of H, rows of gv) that `plan` writes."""
    nh = int((np.asarray(plan.rkind) < GRAM_SLOT0).sum())
    return nh, len(plan.rkind) - nh


def _zero_invalid(valid, *ts):
    return tuple(torch.where(valid.view((-1,) + (1,) * (t.dim() - 1)), t,
                             torch.zeros_like(t)) for t in ts)


def _proj_bal_plain(R, t, calib, pts, rows):
    """r + uv (the projection, before the measurement), the 2x9 and 2x3
    Jacobians (N, 2, 9), (N, 2, 3) and the valid mask of BalCamera
    factors, in csrc/projection.cuh's formulas (project_bal)."""
    c, p = rows[:, 0].long(), rows[:, 1].long()
    Rc = R[c]
    pc = torch.einsum("nji,nj->ni", Rc, pts[p] - t[c])
    valid = pc[:, 2] > CHEIRALITY_EPS
    z = torch.where(valid, pc[:, 2], torch.ones_like(pc[:, 2]))
    f, k1, k2 = calib[c, 0], calib[c, 1], calib[c, 2]
    x, y = pc[:, 0] / z, pc[:, 1] / z
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    g = f * radial
    proj = torch.stack([x * g, y * g], -1)
    dg = 2.0 * f * (k1 + 2.0 * k2 * r2)
    J00, J01, J11 = g + dg * x * x, dg * x * y, g + dg * y * y
    iz = 1.0 / z
    m = torch.stack([
        torch.stack([J00 * iz, J01 * iz, -(J00 * x + J01 * y) * iz], -1),
        torch.stack([J01 * iz, J11 * iz, -(J01 * x + J11 * y) * iz], -1)], 1)
    xy = torch.stack([x, y], -1)
    Jc = torch.cat([_rot_cols(m, pc), -m, torch.stack(
        [radial[:, None] * xy, (f * r2)[:, None] * xy,
         (f * r2 * r2)[:, None] * xy], -1)], -1)
    Jp = m @ Rc.transpose(-1, -2)
    return proj, Jc, Jp, valid


def _rot_cols(m, p):
    """m [p]x (N, 2, 3): the rotation columns of a projection Jacobian."""
    p = p[:, None, :]
    return torch.stack([m[..., 1] * p[..., 2] - m[..., 2] * p[..., 1],
                        m[..., 2] * p[..., 0] - m[..., 0] * p[..., 2],
                        m[..., 0] * p[..., 1] - m[..., 1] * p[..., 0]], -1)


def _proj_pinhole_plain(R, t, pts, rows, K, ext):
    """_proj_bal_plain of GenericProjection factors (project_pinhole): the
    2x6 pose and 2x3 point Jacobians."""
    c, p = rows[:, 0].long(), rows[:, 1].long()
    Rc = R[c]
    pb = torch.einsum("nji,nj->ni", Rc, pts[p] - t[c])
    pc = pb
    if ext is not None:
        Rb, tb = ext[:9].view(3, 3), ext[9:]
        pc = torch.einsum("ji,nj->ni", Rb, pb - tb)
    valid = pc[:, 2] > CHEIRALITY_EPS
    z = torch.where(valid, pc[:, 2], torch.ones_like(pc[:, 2]))
    fx, fy, s, u0, v0 = (K[i] for i in range(5))
    x, y = pc[:, 0] / z, pc[:, 1] / z
    proj = torch.stack([fx * x + s * y + u0, fy * y + v0], -1)
    iz = 1.0 / z
    zero = torch.zeros_like(iz)
    n = torch.stack([
        torch.stack([fx * iz, s * iz, -(fx * x + s * y) * iz], -1),
        torch.stack([zero, fy * iz, -(fy * y) * iz], -1)], 1)
    if ext is not None:
        n = n @ ext[:9].view(3, 3).T
    Jc = torch.cat([_rot_cols(n, pb), -n], -1)
    Jp = n @ Rc.transpose(-1, -2)
    return proj, Jc, Jp, valid


def _proj_plain(cams, pts, rows, uv):
    """(r, (Jc, Jp)) of either variant: cams (R, t, calib) or (R, t, K,
    ext)."""
    proj, Jc, Jp, valid = (_proj_bal_plain(*cams[:3], pts, rows)
                           if len(cams) == 3 else
                           _proj_pinhole_plain(cams[0], cams[1], pts, rows,
                                               *cams[2:]))
    r = torch.where(valid[:, None], proj - uv,
                    torch.full_like(proj, CHEIRALITY_PENALTY))
    return r, _zero_invalid(valid, Jc, Jp)


def _proj_jacobians_plain(cams, pts, rows, uv, kind, noise, loss, param,
                          out):
    r, J = _proj_plain(cams, pts, rows, uv)
    A, b = _whitened(r, J, kind, noise, loss, param)
    if out is None:
        return A, b
    d = out.shape[-1]
    for s, As in enumerate(A):
        out[:, s, :2] = torch.nn.functional.pad(As, (0, d - As.shape[-1]))
    return out


def _proj_linearize_plain(cams, pts, rows, uv, kind, noise, sign, plan,
                          flip, H, gv, loss, param):
    """The Gram mode's plain version: each factor's blocks and gradient
    rows (the per-factor products), then each row of the plan the sum
    of its members' (index_add_ in member order), the camera-point rows
    transposed where flip says so."""
    (Ac, Ap), b = _proj_jacobians_plain(cams, pts, rows, uv, kind, noise,
                                        loss, param, None)
    N = Ac.shape[0]
    d = gv.shape[-1]
    kc = Ac.shape[-1]
    pad = torch.nn.functional.pad
    blk = torch.stack([
        pad(sign * torch.einsum("nri,nrj->nij", Ac, Ac),
            (0, d - kc, 0, d - kc)),
        pad(sign * torch.einsum("nri,nrj->nij", Ac, Ap),
            (0, d - 3, 0, d - kc)),
        pad(sign * torch.einsum("nri,nrj->nij", Ap, Ap),
            (0, d - 3, 0, d - 3))], 1)
    grad = torch.stack([
        pad(sign * torch.einsum("nrd,nr->nd", Ac, b), (0, d - kc)),
        pad(sign * torch.einsum("nrd,nr->nd", Ap, b), (0, d - 3))], 1)
    kinds, rout = plan.rkind.long(), plan.rout.long()
    owner = segment_owner(plan.mptr)
    chunk = torch.searchsorted(plan.cptr[1:].long(), owner, right=True)
    fac = plan.order.long()[chunk * PROJ_CHUNK + plan.mem.long()]
    mk = kinds[owner]
    R = kinds.shape[0]
    hm = mk < GRAM_SLOT0
    vals = blk[fac[hm], mk[hm]]
    vals = torch.where(flip[owner[hm]][:, None, None], vals.mT, vals)
    hsum = torch.zeros((R, d * d), dtype=F64, device=H.device).index_add_(
        0, owner[hm], vals.reshape(-1, d * d))
    gsum = torch.zeros((R, d), dtype=F64, device=H.device).index_add_(
        0, owner[~hm], grad[fac[~hm], mk[~hm] - GRAM_SLOT0])
    hr = kinds < GRAM_SLOT0
    H[rout[hr]] = hsum[hr]
    gv[rout[~hr]] = gsum[~hr]


def proj_linearize_plain(R, t, calib, pts, rows, uv, kind, noise, sign,
                         plan, flip, H, gv, loss=0, param=0.0):
    _proj_linearize_plain((R, t, calib), pts, rows, uv, kind, noise, sign,
                          plan, flip, H, gv, loss, param)


def proj3_linearize_plain(R, t, pts, rows, uv, K, ext, kind, noise, sign,
                          plan, flip, H, gv, loss=0, param=0.0):
    _proj_linearize_plain((R, t, K, ext), pts, rows, uv, kind, noise, sign,
                          plan, flip, H, gv, loss, param)


def proj_jacobians_plain(R, t, calib, pts, rows, uv, kind, noise, loss=0,
                         param=0.0, out=None):
    """Whitened Jacobians (A_cam (N, 2, 9), A_pt (N, 2, 3)) and b = -R_w r
    (N, 2) of BalCamera projection factors; with `out` (N, 2, rmax, d) the
    rows written into it as proj_jacobians writes them, and `out`
    returned."""
    return _proj_jacobians_plain((R, t, calib), pts, rows, uv, kind, noise,
                                 loss, param, out)


def proj3_jacobians_plain(R, t, pts, rows, uv, K, ext, kind, noise, loss=0,
                          param=0.0, out=None):
    """proj_jacobians_plain of GenericProjection factors (A_pose (N, 2,
    6))."""
    return _proj_jacobians_plain((R, t, K, ext), pts, rows, uv, kind, noise,
                                 loss, param, out)


def proj_error_plain(R, t, calib, pts, rows, uv, kind, noise, sign, loss=0,
                     param=0.0, mu=1000.0):
    return _error_plain(_proj_plain((R, t, calib), pts, rows, uv)[0], kind,
                        noise, sign, loss, param, mu)


def proj3_error_plain(R, t, pts, rows, uv, K, ext, kind, noise, sign,
                      loss=0, param=0.0, mu=1000.0):
    return _error_plain(_proj_plain((R, t, K, ext), pts, rows, uv)[0], kind,
                        noise, sign, loss, param, mu)


def _proj_specs(name, cams, pts, rows, uv, kind, noise, loss, *extra):
    """Checks of kernel 17 and 18's arguments (cams: (R, t, calib) or (R,
    t, K, ext)); returns _factor_specs' (device, code, stride, pointer)."""
    if rows.dim() != 2 or rows.shape[1] != 2:
        raise ValueError(f"{name}: rows must be (N, 2), got "
                         f"{tuple(rows.shape)}")
    nc, N = cams[0].shape[0], rows.shape[0]
    specs = [("R", cams[0], F64, (nc, 3, 3)), ("t", cams[1], F64, (nc, 3))]
    if len(cams) == 3:
        specs.append(("calib", cams[2], F64, (nc, 3)))
    specs += [("pts", pts, F64, (pts.shape[0], 3)),
              ("rows", rows, I32, (N, 2)), ("uv", uv, F64, (N, 2))]
    if len(cams) == 4:
        specs.append(("K", cams[2], F64, (5,)))
        if cams[3] is not None:
            specs.append(("ext", cams[3], F64, (12,)))
    return _factor_specs(name, rows, kind, noise, loss, 2, *specs, *extra)


def _proj_ptrs(cams, pts, rows, uv):
    """The leading pointers of a C entry point of kernel 17 or 18: (R, t,
    calib, pts, rows, uv), or (R, t, pts, rows, uv, K, ext) with ext 0 when
    None."""
    cp = tuple(0 if c is None else ptr(c) for c in cams)
    mid = (ptr(pts), ptr(rows), ptr(uv))
    return cp + mid if len(cams) == 3 else cp[:2] + mid + cp[2:]


def _proj_linearize(name, cams, pts, rows, uv, kind, noise, sign, plan,
                    flip, H, gv, loss, param):
    N = rows.shape[0]
    nh, dd = H.shape
    ng, d = gv.shape
    nr = plan.rkind.shape[0]
    dev, code, stride, nptr = _proj_specs(
        name, cams, pts, rows, uv, kind, noise, loss,
        ("order", plan.order, I32, (N,)),
        ("cptr", plan.cptr, I32, (-(-N // PROJ_CHUNK) + 1,)),
        ("rkind", plan.rkind, I32, (nr,)),
        ("mptr", plan.mptr, I32, (nr + 1,)),
        ("mem", plan.mem, I32, (GRAM_KINDS * N,)),
        ("rout", plan.rout, I32, (nr,)), ("flip", flip, BOOL, (nr,)),
        ("H", H, F64, (nh, d * d)), ("gv", gv, F64, (ng, d)))
    kc = 9 if len(cams) == 3 else 6
    if not kc <= d <= 12:
        raise ValueError(f"{name}: block width {d} outside [{kc}, 12]")
    KERNELS[name].launch(dev, N, d, *_proj_ptrs(cams, pts, rows, uv), code,
                         stride, nptr, float(sign), int(loss), float(param),
                         *map(ptr, plan), ptr(flip), ptr(H), ptr(gv))


def proj_linearize(R, t, calib, pts, rows, uv, kind, noise, sign, plan,
                   flip, H, gv, loss=0, param=0.0):
    """Kernel 17, Gram mode: for the BalCamera projection factors (rows
    (N, 2) int32: each one's camera and point rows), the rows of `plan` (a
    GramPlan, proj_gram_plan's): each row of kind 0, 1 or 2 the sum over
    its members of sign A_c^T A_c, sign A_c^T A_p (transposed where
    flip[row]) or sign A_p^T A_p into H[rout] ((nh, d*d), zero outside its
    leading 9x9, 9x3 or 3x3), each of kind 3 or 4 the sum of sign A_c^T b
    or sign A_p^T b into gv[rout] ((ng, d)); R, t, calib: the cameras (nc,
    3, 3), (nc, 3), (nc, 3); pts (np, 3); uv (N, 2) the measurements; noise
    as pg_linearize's at 2 rows; 9 <= d <= 12.  On the card one launch, a
    CTA a chunk of PROJ_CHUNK factors in plan order, a thread a factor,
    whose warps then sum the chunk's rows in member order."""
    args = (R, t, calib, pts, rows, uv)
    if on_cpu(*args, *_tensors(noise), *plan, flip, H, gv):
        return proj_linearize_plain(*args, kind, noise, sign, plan, flip, H,
                                    gv, loss, param)
    _proj_linearize("proj_linearize", (R, t, calib), pts, rows, uv, kind,
                    noise, sign, plan, flip, H, gv, loss, param)


def proj3_linearize(R, t, pts, rows, uv, K, ext, kind, noise, sign, plan,
                    flip, H, gv, loss=0, param=0.0):
    """Kernel 17's GenericProjection variant, Gram mode: proj_linearize for
    SE3 + Point3 factors with the fixed K (5,) and extrinsic ext (12,) or
    None; 6 <= d <= 12."""
    args = (R, t, pts, rows, uv, K)
    if on_cpu(*args, *_tensors(ext, noise), *plan, flip, H, gv):
        return proj3_linearize_plain(R, t, pts, rows, uv, K, ext, kind,
                                     noise, sign, plan, flip, H, gv, loss,
                                     param)
    _proj_linearize("proj3_linearize", (R, t, K, ext), pts, rows, uv, kind,
                    noise, sign, plan, flip, H, gv, loss, param)


def _proj_jacobians(name, cams, pts, rows, uv, kind, noise, loss, param,
                    out):
    N = rows.shape[0]
    dev, code, stride, nptr = _proj_specs(
        name, cams, pts, rows, uv, kind, noise, loss,
        ("out", out, F64, (N, 2) + tuple(out.shape[2:])))
    _, _, rmax, d = out.shape
    kc = 9 if len(cams) == 3 else 6
    if not (kc <= d <= 12 and rmax >= 2):
        raise ValueError(f"{name}: rows of {rmax} x {d} hold no 2 x {kc} "
                         "Jacobian")
    KERNELS[name].launch(dev, N, d, rmax, *_proj_ptrs(cams, pts, rows, uv),
                         code, stride, nptr, int(loss), float(param),
                         ptr(out))
    return out


def proj_jacobians(R, t, calib, pts, rows, uv, kind, noise, loss, param,
                   out):
    """Kernel 17, Jacobian mode: each BalCamera projection factor's
    whitened (under a loss sqrt(w)-scaled) rows A_c (2 x 9) and A_p (2 x
    3) into out[n, 0, :2] and out[n, 1, :2] ((N, 2, rmax, d), zero past
    the slot's width; rows 2..rmax not written); no sign.  On the card one
    launch of proj_linearize's kernel in its Jacobian mode."""
    args = (R, t, calib, pts, rows, uv)
    if on_cpu(*args, *_tensors(noise), out):
        return proj_jacobians_plain(*args, kind, noise, loss, param, out)
    return _proj_jacobians("proj_jacobians", (R, t, calib), pts, rows, uv,
                           kind, noise, loss, param, out)


def proj3_jacobians(R, t, pts, rows, uv, K, ext, kind, noise, loss, param,
                    out):
    """Kernel 17's GenericProjection variant, Jacobian mode (A_pose 2 x
    6)."""
    args = (R, t, pts, rows, uv, K)
    if on_cpu(*args, *_tensors(ext, noise), out):
        return proj3_jacobians_plain(R, t, pts, rows, uv, K, ext, kind, noise,
                                     loss, param, out)
    return _proj_jacobians("proj3_jacobians", (R, t, K, ext), pts, rows, uv,
                           kind, noise, loss, param, out)


def proj_error(R, t, calib, pts, rows, uv, kind, noise, sign, loss=0,
               param=0.0, mu=1000.0):
    """Kernel 18: sign * 0.5 * sum ||R_w r||^2 over the BalCamera
    projection factors (a loss: sign * sum rho(||R_w r||); constrained
    noise: plus sign * 0.5 mu r^2 on the hard rows), a 0-d tensor.  On the
    card pg_error's design: ceil(N / ERROR_BLOCK) one-warp CTAs, a lane a
    factor, the last CTA summing the partials in index order."""
    args = (R, t, calib, pts, rows, uv)
    if on_cpu(*args, *_tensors(noise)):
        return proj_error_plain(*args, kind, noise, sign, loss, param, mu)
    dev, code, stride, nptr = _proj_specs("proj_error", (R, t, calib), pts,
                                          rows, uv, kind, noise, loss)
    return _error_launch("proj_error", dev, rows.shape[0], None, args, code,
                         stride, nptr, sign, loss, param, mu)


def proj3_error(R, t, pts, rows, uv, K, ext, kind, noise, sign, loss=0,
                param=0.0, mu=1000.0):
    """Kernel 18's GenericProjection variant."""
    args = (R, t, pts, rows, uv, K)
    if on_cpu(*args, *_tensors(ext, noise)):
        return proj3_error_plain(R, t, pts, rows, uv, K, ext, kind, noise,
                                 sign, loss, param, mu)
    dev, code, stride, nptr = _proj_specs("proj3_error", (R, t, K, ext), pts,
                                          rows, uv, kind, noise, loss)
    lead = (R, t, pts, rows, uv, K, ext)
    return _error_launch("proj3_error", dev, rows.shape[0], None, lead, code,
                         stride, nptr, sign, loss, param, mu)


# kernel 6's and kernel 17's wrappers by group, and their leading arguments
# for a batch
LINEARIZE = {"SE3": pg_linearize, "SE2": pg2_linearize,
             "BalCamera": proj_linearize,
             "GenericProjection": proj3_linearize}
JACOBIANS = {"SE3": pg_jacobians, "SE2": pg2_jacobians,
             "BalCamera": proj_jacobians,
             "GenericProjection": proj3_jacobians}
ERROR = {"SE3": pg_error, "SE2": pg2_error, "BalCamera": proj_error,
         "GenericProjection": proj3_error}


def group_args(group, arrays, rows, batch):
    """The leading arguments of a group's wrappers for a batch: the values,
    the batch's rows (N, arity) and its measurements (SE3: R, t, rows, ZR,
    Zt; SE2: x, rows, Z; BalCamera: R, t, calib, pts, rows, uv;
    GenericProjection: R, t, pts, rows, uv, K, ext, the last two the
    residual's own on the rows' device)."""
    if group == "SE3":
        return (arrays["SE3"].R, arrays["SE3"].t, rows, batch.measurements.R,
                batch.measurements.t)
    if group == "BalCamera":
        cam = arrays["BalCamera"]
        return (cam.pose.R, cam.pose.t, cam.calib, arrays["Point3"], rows,
                batch.measurements)
    if group == "GenericProjection":
        pose = arrays["SE3"]
        return (pose.R, pose.t, arrays["Point3"], rows, batch.measurements,
                *batch.residual_fn.kernel_args(rows.device))
    return (arrays[group], rows, batch.measurements)


def pg_assemble_plain(hc, gc, asm_src, asm_ptr, asm_blk, asm_diag, g_src,
                      g_ptr, pad_diag, nb, out=None):
    n, d = pad_diag.shape
    T = asm_blk.shape[0]
    blk = torch.zeros((T, hc.shape[1]), dtype=F64, device=hc.device
                      ).index_add_(0, segment_owner(asm_ptr),
                                   hc[asm_src.long()])
    rows = torch.nonzero(asm_diag >= 0)[:, 0]
    dg = torch.arange(d, device=hc.device) * (d + 1)
    blk[rows[:, None], dg[None, :]] += pad_diag[asm_diag[rows].long()]
    if out is None:
        out = torch.zeros((nb, hc.shape[1]), dtype=F64, device=hc.device)
    out[asm_blk.long()] = blk
    g = torch.zeros((n, d), dtype=F64, device=hc.device).index_add_(
        0, segment_owner(g_ptr), gc[g_src.long()])
    return out, g


def pg_assemble(hc, gc, asm_src, asm_ptr, asm_blk, asm_diag, g_src, g_ptr,
                pad_diag, nb, out=None):
    """Kernel 6, assemble, over H's own blocks T (asm_blk, (T,) store rows):
    out[asm_blk[i]] = the sum of hc[asm_src[k]] over k in
    [asm_ptr[i], asm_ptr[i+1]), in that order, plus the identity on the
    padded dimensions of the diagonal block of column asm_diag[i] (-1:
    none); g[v] = the sum of gc[g_src[k]] over v's range of g_ptr.  Returns
    the block store (nb, d*d) and g (n, d).  `out`: a store that is zero
    outside T, of which only T's rows are written; None: a new zeroed
    store.  On the card one launch, whose grid depends on T and n only."""
    args = (hc, gc, asm_src, asm_ptr, asm_blk, asm_diag, g_src, g_ptr,
            pad_diag)
    if on_cpu(*args, *_tensors(out)):
        return pg_assemble_plain(*args, nb, out)
    C, dd = hc.shape
    Cg, d = gc.shape
    T, n = asm_blk.shape[0], pad_diag.shape[0]
    specs = [("hc", hc, F64, (C, d * d)), ("gc", gc, F64, (Cg, d)),
             ("asm_src", asm_src, I32, (asm_src.shape[0],)),
             ("asm_ptr", asm_ptr, I32, (T + 1,)),
             ("asm_blk", asm_blk, I32, (T,)),
             ("asm_diag", asm_diag, I32, (T,)),
             ("g_src", g_src, I32, (g_src.shape[0],)),
             ("g_ptr", g_ptr, I32, (n + 1,)),
             ("pad_diag", pad_diag, F64, (n, d))]
    if out is not None:
        specs.append(("out", out, F64, (nb, dd)))
    dev = check("pg_assemble", *specs)
    if out is None:
        out = torch.zeros((nb, dd), dtype=F64, device=dev)
    g = torch.empty((n, d), dtype=F64, device=dev)
    KERNELS["pg_assemble"].launch(dev, T, n, d, *map(ptr, args), ptr(out),
                                  ptr(g))
    return out, g


# -- kernel 7: the level step of the supernodal factorization ---------------

# The column blocks of sn_front_factor's fronts (kNB in chol_tiles.cuh): its
# Dinv scratch holds a 128 x 128 inverse per block.  A CTA of the front
# kernel has FRONT_WARPS warps (kWarps), each of which gathers a block row
# of the front, or FRONT_PANEL_ROWS rows (kPanelRows) of a block column of
# its panel, at a time.
FRONT_BLOCK = 128
FRONT_WARPS = 8
FRONT_PANEL_ROWS = 256
_SMS = {}


def front_ctas(S, W, R, d, sms):
    """The front kernel's CTAs a front of a level of S fronts W blocks wide
    (R row blocks, d wide) on a card of `sms` SMs: the level's share of the
    SMs (one CTA an SM), at most the front's jobs (the row halves of its
    lower 128-column blocks, or the gathers' warp jobs, a block row of the
    front or FRONT_PANEL_ROWS rows of a block column of the panel,
    FRONT_WARPS a CTA, whichever are more), at least one; 1 wherever the
    level fills half the card (S >= sms / 2).  A plan property of each
    wide level (never a fallback); any count gives the same bits."""
    if 2 * S >= sms:
        return 1
    Wd = W * d
    nb = -(-Wd // FRONT_BLOCK)
    last = Wd - (nb - 1) * FRONT_BLOCK
    halves = nb * (nb + 1) - (nb if last <= FRONT_BLOCK // 2 else 0)
    chunks = max(1, -(-R * d // FRONT_PANEL_ROWS))
    jobs = max(halves, -(-W * chunks // FRONT_WARPS))
    return max(1, min(sms // max(S, 1), jobs))


def front_flags(W, d, ctas):
    """The ints of a front in the front kernel's flags (front_flags in
    csrc/sn_factor.cu): a flag a diagonal block (factored), two a lower
    block of L (its row halves solved), one a diagonal block (its second
    half updated), one a lower block of L^-1, one a CTA for the gathers
    and one for the end, and a first-bad record a diagonal block."""
    nb = -(-W * d // FRONT_BLOCK)
    return 3 * nb + 3 * (nb * (nb + 1) // 2) + 2 * ctas


def device_sms(device):
    """The SM count of a CUDA device (found once), 0 for another device."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _damp_entries(blocks, col_vars, valid, dbc, d, lam, diagonal_damping,
                  min_diag, max_diag):
    """The damping of each front diagonal entry (S, W*d): lam, or
    lam * clip(H_cc[k, k]) of the undamped store, on true dimensions
    only."""
    n = dbc.shape[0]
    cols = col_vars.long().repeat_interleave(d, dim=1).clamp(max=n - 1)
    if not diagonal_damping:
        return valid.to(F64) * lam
    k = torch.arange(cols.shape[1], device=blocks.device) % d
    dv = blocks[dbc.long()[cols], k * (d + 1)].clamp(min_diag, max_diag)
    return torch.where(valid, lam * dv, 0.0)


def _front_gather(work, blocks, diag_ids, diag_flip, diag_pad, valid_diag,
                  col_vars, dbc, panel_ids, lam, diagonal_damping, min_diag,
                  max_diag):
    """One level's dense fronts (S, W*d, W*d), damped, and panels (S, R*d,
    W*d; None without a row structure), gathered from the working store."""
    S, W, _ = diag_ids.shape
    d = _width(work.shape[1])
    G = work[diag_ids.long()].reshape(S, W, W, d, d)
    G = torch.where(diag_flip[..., None, None], G.transpose(-1, -2), G)
    front = G.permute(0, 1, 3, 2, 4).reshape(S, W * d, W * d)
    front.diagonal(dim1=1, dim2=2).add_(
        diag_pad + _damp_entries(blocks, col_vars, valid_diag, dbc, d, lam,
                                 diagonal_damping, min_diag, max_diag))
    if panel_ids is None:
        return front, None
    R = panel_ids.shape[1]
    Pb = work[panel_ids.long()].reshape(S, R, W, d, d)
    return front, Pb.permute(0, 1, 3, 2, 4).reshape(S, R * d, W * d)


def _finite(t):
    return t.masked_fill_(~torch.isfinite(t), 0.0)


def sn_front_factor_plain(work, blocks, diag_ids, diag_flip, diag_pad,
                          valid_diag, col_vars, dbc, panel_ids, lam,
                          diagonal_damping, rec, min_diag=1e-6,
                          max_diag=1e32, out=None):
    front, panel = _front_gather(work, blocks, diag_ids, diag_flip, diag_pad,
                                 valid_diag, col_vars, dbc, panel_ids, lam,
                                 diagonal_damping, min_diag, max_diag)
    S, Wd, _ = front.shape
    d = Wd // col_vars.shape[1]
    L, info = torch.linalg.cholesky_ex(front)
    # the first bad pivot of each front: a true dimension not finite or
    # not positive, or where cholesky_ex stopped
    piv = L.diagonal(dim1=1, dim2=2)
    idx = torch.arange(Wd, device=L.device)
    bad = ((valid_diag & (~torch.isfinite(piv) | (piv <= 0)))
           | (idx[None, :] == torch.where(info > 0, info - 1, Wd)[:, None]))
    first = bad.to(torch.int8).argmax(dim=1)
    col = torch.gather(col_vars, 1, (first // d)[:, None])[:, 0]
    rec.copy_(torch.where(bad.any(dim=1), col, -1))
    L = _finite(_as_colmajor(L))
    eye = torch.eye(Wd, dtype=F64, device=L.device).expand(S, Wd, Wd)
    Linv = _finite(_as_colmajor(torch.linalg.solve_triangular(L, eye,
                                                              upper=False)))
    At = None if panel is None else _finite(panel.mT.contiguous())
    bufs = (L.mT, Linv.mT, At, tile_inverses([L]))   # as the kernel writes
    if out is not None:
        bufs = tuple(t if o is None or t is None else o.copy_(t)
                     for o, t in zip(out, bufs))
    return bufs[0].mT, bufs[1].mT, bufs[2], bufs[3]


def even_pitch(n):
    """n rounded up to even: the row pitch of the front kernel's L^-T and
    At (front_buffers) and of the Schur update's U operand, so that every
    row starts 16-byte aligned."""
    return n + (n & 1)


def front_buffers(S, Wd, Rd, device):
    """New buffers of the front kernel's L^-T (S, Wd, Wd) and At (S, Wd,
    Rd; None where Rd = 0), as views of buffers at even row pitches
    (even_pitch), which the Schur update stages 16 bytes at a time; the
    front kernel writes At's columns past Rd zero."""
    ldx, lda = even_pitch(Wd), even_pitch(Rd)
    X = torch.empty((S, ldx, ldx), dtype=F64, device=device)
    At = torch.empty((S, Wd, lda), dtype=F64, device=device) if Rd else None
    return X[:, :Wd, :Wd], None if At is None else At[..., :Rd]


def _padded(t, cols, square):
    """(the buffer under t, its row pitch): t a (S, rows, cols) view that
    front_buffers made, of (S, pitch, pitch) where `square`, else (S,
    rows, pitch), pitch = even_pitch(cols) (for an even cols, a contiguous
    t).  Anything else is returned as it is, for the checks to refuse."""
    pitch = even_pitch(cols)
    if t.dim() != 3:
        return t, pitch
    shape = (t.shape[0], pitch if square else t.shape[1], pitch)
    strides = (shape[1] * pitch, pitch, 1)
    if t.stride() != strides:
        return t, pitch
    return t.as_strided(shape, strides), pitch


def sn_front_factor(work, blocks, diag_ids, diag_flip, diag_pad, valid_diag,
                    col_vars, dbc, panel_ids, lam, diagonal_damping, rec,
                    min_diag=1e-6, max_diag=1e32, out=None, ctas=None):
    """Kernel 7, fronts: one level's dense fronts (S, W*d, W*d) gathered
    from the working store `work` (diag_ids blocks, transposed where
    diag_flip), plus diag_pad and the damping (lam, or lam * clip(diag,
    min_diag, max_diag) of the undamped store `blocks`) on the
    true-dimension diagonal, factored: returns (L, L^-1, At, tiles), L and
    its inverse (S, W*d, W*d) column-major per front, the panels of
    panel_ids transposed, At (S, W*d, R*d) (None when the level has no row
    structure), non-finite entries zeroed, and the inverses of every
    front's 32 x 32 diagonal tiles of L, (S * ceil(W*d / 32), 32, 32)
    row-major in kernel 8's order (tile_inverses; on the card the diagonal
    tiles of the blocks' L_D^-1, the identity past the front's width).
    rec (S,) int32 receives each front's first bad pivot (a true dimension
    not finite or not positive) as its permuted column, or -1.  On the
    card one launch of `ctas` CTAs a front (default front_ctas, the plan's
    count), which share out the front's gathers and its 128-column blocks
    and pass each finished block on by a flag; any count gives the same
    bits (ctas=1: a CTA a front, no flags).  `out`: the buffers it writes
    whole, (L^T, L^-T, At, tiles) row-major, each None for a new one, L^-T
    and At as front_buffers makes them (views of buffers at even row
    pitches)."""
    args = (work, blocks, diag_ids, diag_flip, diag_pad, valid_diag,
            col_vars, dbc)
    if on_cpu(*args, rec, *_tensors(panel_ids)):
        return sn_front_factor_plain(*args, panel_ids, lam, diagonal_damping,
                                     rec, min_diag, max_diag, out)
    nb, dd = work.shape
    d = _width(dd)
    S, W, _ = diag_ids.shape
    R = 0 if panel_ids is None else panel_ids.shape[1]
    n = dbc.shape[0]
    Wd = W * d
    specs = [("work", work, F64, (nb, dd)), ("blocks", blocks, F64, (nb, dd)),
             ("diag_ids", diag_ids, I32, (S, W, W)),
             ("diag_flip", diag_flip, BOOL, (S, W, W)),
             ("diag_pad", diag_pad, F64, (S, Wd)),
             ("valid_diag", valid_diag, BOOL, (S, Wd)),
             ("col_vars", col_vars, I32, (S, W)), ("dbc", dbc, I32, (n,)),
             ("rec", rec, I32, (S,))]
    if R:
        specs.append(("panel_ids", panel_ids, I32, (S, R, W)))
    ldx, lda = even_pitch(Wd), even_pitch(R * d)
    shapes = ((S, Wd, Wd), (S, ldx, ldx), (S, Wd, lda) if R else None,
              (S * _ntiles(Wd), TILE, TILE))
    out = [None] * 4 if out is None else list(out)
    # L^-T and At checked by the buffers under them
    bufs = [out[0], out[1] if out[1] is None else _padded(out[1], Wd, True)[0],
            out[2] if out[2] is None else _padded(out[2], R * d, False)[0],
            out[3]]
    specs += [(f"out[{k}]", o, F64, shape)
              for k, (o, shape) in enumerate(zip(bufs, shapes))
              if o is not None and shape is not None]
    dev = check("sn_front_factor", *specs)
    if out[1] is None or (R and out[2] is None):
        fresh = front_buffers(S, Wd, R * d, dev)
        out[1:3] = [f if o is None else o for o, f in zip(out[1:3], fresh)]
    for k in (0, 3):
        if out[k] is None:
            out[k] = torch.empty(shapes[k], dtype=F64, device=dev)
    L, X, At, tiles = out
    Dinv = torch.empty((S, -(-Wd // FRONT_BLOCK), FRONT_BLOCK, FRONT_BLOCK),
                       dtype=F64, device=dev)
    if ctas is None:
        ctas = front_ctas(S, W, R, d, device_sms(dev))
    ctas = int(ctas)
    if ctas < 1 or (ctas > 1 and S * ctas > device_sms(dev)):
        raise ValueError(f"sn_front_factor: {ctas} CTAs a front of {S} do "
                         "not fit the card at once")
    flags, seq = _launch_flags("front", dev, S * front_flags(W, d, ctas))
    KERNELS["sn_front_factor"].launch(
        dev, S, W, R, d, n, ctas, seq, ldx, lda, *map(ptr, args),
        ptr(panel_ids) if R else 0, float(lam), int(bool(diagonal_damping)),
        float(min_diag), float(max_diag), ptr(L), ptr(X),
        ptr(At) if R else 0, ptr(Dinv), ptr(tiles), ptr(rec), ptr(flags))
    return L.mT, X.mT, At if R else None, tiles


def front_split_jobs(nb, ctas, last=FRONT_BLOCK):
    """The front kernel's jobs on a front of nb 128-column blocks (the last
    `last` wide) split over `ctas` CTAs, per CTA in the order it walks them
    (csrc/sn_factor.cu, sn_front_factor_kernel): the steps in order, each
    the diagonal block's factorization, the row halves of the solves below
    it and of the trailing updates column by column, then L^-1's blocks in
    row order.  Row half h of block (i, j) of L is CTA (2 tid(i, j) + h) %
    ctas's (a block of at most 64 rows has one half), a diagonal block's
    factorization and a block of L^-1 their first half's owner's.  A job is
    (kind, i, j, k, h, awaited flags, flag set): "factor" (block (k, k)),
    "solve" (half h of L_ik = A_ik L_kk^-T), "update" (half h of A_ij -=
    L_ik L_jk^T), "sum" (Y_ij = sum_{m=j}^{i-1} L_im X_mj) or "scale" (X_ij
    = -X_ii Y_ij; k and h None for the last two); a flag ("B", k) marks
    diagonal block k factored, ("S", i, k, h) half h of L_ik solved, ("U",
    j) diagonal block j's second half updated by its last step, ("X", i,
    j) block (i, j) of L^-1 composed.  The gathers and the end are
    barriers of all the front's CTAs, before the first job and after the
    last."""
    def halves(i):
        w = last if i == nb - 1 else FRONT_BLOCK
        return 2 if w > FRONT_BLOCK // 2 else 1

    def own(i, j, h):
        return (2 * (i * (i + 1) // 2 + j) + h) % ctas
    jobs = [[] for _ in range(ctas)]
    for k in range(nb):
        waits = (("U", k),) if k and halves(k) == 2 else ()
        jobs[own(k, k, 0)].append(("factor", k, k, k, 0, waits, ("B", k)))
        for i in range(k + 1, nb):
            for h in range(halves(i)):
                jobs[own(i, k, h)].append(("solve", i, k, k, h,
                                           (("B", k),), ("S", i, k, h)))
        for j in range(k + 1, nb):
            for i in range(j, nb):
                for h in range(halves(i)):
                    waits = (("S", i, k, h),) + tuple(
                        ("S", j, k, g) for g in range(halves(j)))
                    flag = ("U", j) if i == j and h == 1 and k == j - 1 \
                        else None
                    jobs[own(i, j, h)].append(("update", i, j, k, h, waits,
                                               flag))
    for i in range(1, nb):
        for j in range(i):
            waits = (tuple(("S", i, m, g) for m in range(j, i)
                           for g in range(halves(i))) + (("B", j),)
                     + tuple(("X", m, j) for m in range(j + 1, i)))
            jobs[own(i, j, 0)] += [
                ("sum", i, j, None, None, waits, None),
                ("scale", i, j, None, None, (("B", i),), ("X", i, j))]
    return jobs


def front_split_model(nb, ctas, seed=0, last=FRONT_BLOCK):
    """A sequential run of front_split_jobs(nb, ctas, last): while jobs
    remain, a CTA drawn at random (numpy, `seed`) among those whose next
    job's flags are all set runs that job and sets its flag.  Returns the
    log, [(cta, job)] in the order run; raises RuntimeError if no CTA can
    go on (the walk would stall the card)."""
    rng = np.random.default_rng(seed)
    jobs = front_split_jobs(nb, ctas, last)
    nxt = [0] * ctas
    flags, log = set(), []
    while any(n < len(q) for n, q in zip(nxt, jobs)):
        ready = [c for c in range(ctas) if nxt[c] < len(jobs[c])
                 and all(f in flags for f in jobs[c][nxt[c]][5])]
        if not ready:
            left = [q[n] for n, q in zip(nxt, jobs) if n < len(q)]
            raise RuntimeError(f"the split walk stalls: nb {nb}, ctas "
                               f"{ctas}, next jobs {left}")
        c = int(rng.choice(ready))
        job = jobs[c][nxt[c]]
        nxt[c] += 1
        if job[6] is not None:
            flags.add(job[6])
        log.append((c, job))
    return log


def sn_pivot_check_plain(rec, state):
    bad = rec >= 0
    first = bad.to(torch.int8).argmax()
    state[0] = torch.where(bad.any(), 0, 1)
    state[1] = torch.where(bad.any(), rec[first], -1)


def sn_pivot_check(rec, state):
    """Kernel 7, pivots: the first-bad records of every front of one
    factorization (sn_front_factor's rec, level after level; (N,) int32, -1
    where a front is sound) into state = (ok, badcol) (2,) int32: (1, -1),
    or (0, the first bad front's column), so the first bad pivot of the
    first bad level.  On the card one launch a factorization."""
    if on_cpu(rec, state):
        return sn_pivot_check_plain(rec, state)
    dev = check("sn_pivot_check", ("rec", rec, I32, (rec.shape[0],)),
                ("state", state, I32, (2,)))
    KERNELS["sn_pivot_check"].launch(dev, rec.shape[0], ptr(rec), ptr(state))


# The output tile of sn_schur_update_kernel's CTAs: UPDATE_TILE (kUT in
# sn_factor.cu; UPDATE_THREADS threads: 4 warps, a 32 x 32 quadrant each,
# two CTAs an SM).  (A 96-wide tile, a multiple of d = 3 and 6 so that no
# d x d block straddles two tiles, measured slower on every level of the
# sphere and the w10000 stand-in on an H100: scripts/port_update_probe.py
# "fitted".)  A product phase with fewer tiles than UPDATE_JOBS splits
# each tile's k range into at most UPDATE_MAX_CHUNKS chunks of at least
# UPDATE_MIN_CHUNK slabs of 32 rows, towards that many jobs, so that a
# level of one or two fronts keeps the card busy; the chunks' partial
# tiles are summed in chunk order.  (On an H100, splitting the wider
# levels too, at 512 or 1024 jobs, cost more in partial tiles than it
# saved: scripts/port_update_probe.py.)
UPDATE_TILE = 64
UPDATE_THREADS = 128
UPDATE_JOBS = 256
UPDATE_MIN_CHUNK = 2
UPDATE_MAX_CHUNKS = 8     # kMaxChunks
UPDATE_MAX_D = 12         # kMaxD: the widest block the scatter takes


class UpdateSplit(NamedTuple):
    """One sn_schur_update launch's work items, as the kernel counts them:
    the panel's output tiles and the slabs (and count) of their k-chunks,
    U's tiles on or next to the diagonal (nt <= mt + 1; those that hold no
    entry of U's block-lower triangle are skipped) and theirs, the
    scatter's CTAs of UPDATE_THREADS block rows (0 on the direct route),
    and the doubles of scratch it needs (U, none on the direct route; then
    the partial tiles of a split product; then U's operand Lp^T at `pitch`
    where that is not R*d); the row pitch of U's operand (even_pitch(R*d):
    every row 16-byte aligned) and the route (direct: a level of one front,
    whose U tiles subtract their blocks from the store themselves)."""
    panel_tiles: int
    panel_chunk: int
    panel_chunks: int
    u_tiles: int
    u_chunk: int
    u_chunks: int
    scatter_ctas: int
    scratch: int
    pitch: int
    direct: bool


def update_split(S, W, R, d, T, direct=False) -> UpdateSplit:
    tile = UPDATE_TILE
    Wd, Rd = W * d, R * d
    pitch = even_pitch(Rd)
    mtn, ntn = -(-Wd // tile), -(-Rd // tile)
    slabs = -(-Wd // 32)
    t1 = S * mtn * ntn
    t2 = S * sum(min(m + 2, ntn) for m in range(ntn))

    def chunk(tiles):
        nk = max(1, min(UPDATE_JOBS // tiles, -(-slabs // UPDATE_MIN_CHUNK),
                        UPDATE_MAX_CHUNKS))
        ck = -(-slabs // nk)
        return ck, -(-slabs // ck)
    (ck1, nk1), (ck2, nk2) = chunk(t1), chunk(t2)
    part = max(t1 * nk1 if nk1 > 1 else 0, t2 * nk2 if nk2 > 1 else 0)
    scratch = ((0 if direct else S * Rd * Rd) + part * tile * tile
               + (S * Wd * pitch if pitch != Rd else 0))
    return UpdateSplit(t1, ck1, nk1, t2, ck2, nk2,
                       0 if direct else -(-T * d // UPDATE_THREADS),
                       scratch, pitch, bool(direct))


class SchurPlan(NamedTuple):
    """One level's Schur update (schur_plan): work row tgt[i] takes the
    sum of the U blocks src[ptr[i]:ptr[i+1]] (flat (s, a, b) over (S, R,
    R), b <= a), in that order; uoff: each such block's first entry in U
    (S, R*d, R*d); S fronts of W column blocks and R row blocks of width d,
    on a store of nb rows; `split`: the launch's work (update_split);
    utgt: on the direct route (split.direct: one front, every target one
    block) the target row of U's block (a, b), (R, R) int32, -1 for none;
    else None."""
    src: torch.Tensor
    ptr: torch.Tensor
    tgt: torch.Tensor
    uoff: torch.Tensor
    S: int
    W: int
    R: int
    d: int
    nb: int
    split: UpdateSplit
    utgt: "torch.Tensor | None" = None


def schur_plan(src, ptr_, tgt, S, W, R, d, nb) -> SchurPlan:
    """A level's SchurPlan, checked once, where the solver moves to its
    device: dtypes, shapes, one device, and every index in range (one sync
    on the card), so that sn_schur_update checks only its other tensors.
    The route is direct where S = 1 and every target takes one block."""
    T = tgt.shape[0]
    specs = [("src", src, I32, (src.shape[0],)), ("ptr", ptr_, I32, (T + 1,)),
             ("tgt", tgt, I32, (T,))]
    if not on_cpu(src, ptr_, tgt):
        check("schur_plan", *specs)
    steps = ptr_[1:] - ptr_[:-1]
    if not (int(ptr_[0]) == 0 and int(ptr_[-1]) == src.shape[0]
            and bool((steps >= 0).all())
            and (src.numel() == 0 or (int(src.min()) >= 0
                                      and int(src.max()) < S * R * R))
            and (T == 0 or (int(tgt.min()) >= 0 and int(tgt.max()) < nb - 1
                            and bool((tgt[1:] > tgt[:-1]).all())))):
        raise ValueError("schur_plan: an index of the plan is out of range")
    Rd = R * d
    if S * Rd * Rd >= 2 ** 31:
        raise ValueError(f"schur_plan: U of {S} x {Rd} x {Rd} entries "
                         "outgrows the kernel's int32 offsets")
    if d > UPDATE_MAX_D:
        raise ValueError(f"schur_plan: blocks {d} wide; the kernel's "
                         f"scatter takes at most {UPDATE_MAX_D}")
    s, ab = src.long() // (R * R), src.long() % (R * R)
    uoff = ((s * Rd + ab // R * d) * Rd + ab % R * d).to(I32)
    direct = S == 1 and bool((steps == 1).all())
    utgt = None
    if direct:
        utgt = torch.full((R * R,), -1, dtype=I32, device=src.device)
        utgt[ab] = tgt[segment_owner(ptr_)]
        utgt = utgt.view(R, R)
    return SchurPlan(src, ptr_, tgt, uoff, int(S), int(W), int(R), int(d),
                     int(nb), update_split(S, W, R, d, T, direct), utgt)


def _u_blocks(Lp, S, R, d):
    """U = Lp Lp^T of every front as flat (s, a, b) blocks (S * R * R,
    d * d)."""
    return torch.bmm(Lp, Lp.mT).reshape(S, R, d, R, d).permute(
        0, 1, 3, 2, 4).reshape(-1, d * d)


def _schur_scatter_plain(Lp, src, ptr_, tgt, S, R, d, work):
    """work[tgt[i]] -= the sum of U's blocks src[ptr[i]:ptr[i+1]], in that
    order (the plain Schur scatter of one level)."""
    seg = torch.zeros((tgt.shape[0], d * d), dtype=F64,
                      device=work.device).index_add_(
        0, segment_owner(ptr_), _u_blocks(Lp, S, R, d)[src.long()])
    work[tgt.long()] -= seg


def sn_schur_update_plain(Linv, At, plan, work, U, out=None):
    LpT = _finite(torch.bmm(Linv, At))
    if out is not None:
        LpT = out.copy_(LpT)
    Lp = LpT.mT
    _schur_scatter_plain(Lp, plan.src, plan.ptr, plan.tgt, plan.S, plan.R,
                         plan.d, work)
    return Lp


def sn_schur_update(Linv, At, plan, work, U, out=None):
    """Kernel 7, Schur update of one level: the panel Lp = A L^-T of every
    front, as (L^-1 At)^T with non-finite entries zeroed, returned (S, R*d,
    W*d) column-major per front (what level_table keeps); then work[tgt[i]]
    -= the sum of the blocks (a, b) of U = Lp Lp^T that plan (a SchurPlan,
    checked once by schur_plan) lists for target i, in its order.  Linv:
    the front kernel's L^-1 (S, W*d, W*d), column-major per front, and At,
    its panels transposed (S, W*d, R*d), as the front kernel leaves them
    (front_buffers: at even pitches); U: a flat scratch of at least
    plan.split.scratch doubles, which the kernel fills with U's block-lower
    triangle (and a split product's partial tiles); `out`:
    the (S, W*d, R*d) buffer of Lp^T (default: a new one).  On the card one
    cooperative launch whose CTAs share out the level's output tiles."""
    if on_cpu(Linv, At, work, U, *_tensors(out)):
        return sn_schur_update_plain(Linv, At, plan, work, U, out)
    S, Wd, _ = Linv.shape
    R, d = plan.R, plan.d
    Rd = R * d
    # Linv and At as front_buffers lays them out (views of buffers at even
    # pitches; At's columns past Rd zero), checked by those buffers; Linv
    # in another layout is checked as it is, so that a device or dtype
    # fault is reported as such, and then refused
    X, ldx = _padded(Linv.mT, Wd, True)
    At_full, lda = _padded(At, Rd, False)
    specs = [("Linv", X if X.is_contiguous() else Linv, F64,
              (S, ldx, ldx) if X.is_contiguous() else (S, Wd, Wd)),
             ("At", At_full, F64, (S, Wd, lda)),
             ("work", work, F64, (plan.nb, d * d)),
             ("U", U, F64, (U.shape[0],))]
    if out is not None:
        specs.append(("out", out, F64, (S, Wd, Rd)))
    dev = check("sn_schur_update", *specs)
    if not X.is_contiguous():
        raise ValueError("sn_schur_update: Linv must be column-major per "
                         "front at an even pitch, as the front kernel "
                         "leaves it (front_buffers)")
    if S != plan.S or plan.src.device != dev:
        raise ValueError(f"sn_schur_update: the plan is for {plan.S} fronts "
                         f"on {plan.src.device}, not {S} on {dev}")
    if U.shape[0] < plan.split.scratch or Wd != plan.W * d:
        raise ValueError(f"sn_schur_update: U holds {U.shape[0]} doubles of "
                         f"{plan.split.scratch}, or Linv's width {Wd} is not "
                         f"the plan's")
    if out is None:
        out = torch.empty((S, Wd, Rd), dtype=F64, device=dev)
    sp = plan.split
    KERNELS["sn_schur_update"].launch(
        dev, S, plan.W, R, d, plan.tgt.shape[0], sp.panel_chunk,
        sp.u_chunk, ldx, lda, sp.pitch, int(sp.direct), ptr(X), ptr(At),
        ptr(plan.uoff), ptr(plan.ptr), ptr(plan.tgt),
        ptr(plan.utgt) if sp.direct else 0, ptr(out), ptr(U), ptr(work))
    return out.mT


# -- kernel 7's narrow route (csrc/sn_narrow.cu) ------------------------------

# A level takes the narrow route when its fronts fit one of kernel 8's 32 x
# 32 tiles (W*d <= NARROW_WD: kMaxWd) and its panels are at most
# NARROW_RD (kMaxRd) rows: then a CTA factors a chunk of up to
# NARROW_CHUNK fronts, a warp a front, NARROW_WARPS (kMaxWarps) at a time
# where their buffers fit NARROW_FRONT_BYTES of shared memory, and sums the
# chunk's U blocks into a row a (chunk, target) kept in NARROW_ROW_BYTES
# of it.
NARROW_WD = 32
NARROW_RD = 64
NARROW_CHUNK = 32
NARROW_WARPS = 8
NARROW_FRONT_BYTES = 96 * 1024
NARROW_ROW_BYTES = 96 * 1024


def narrow_route(W, R, d) -> bool:
    """The plan's route of a level of fronts W blocks wide with R row
    blocks, d wide: True for the narrow kernels, False for the wide
    ones."""
    return W * d <= NARROW_WD and R * d <= NARROW_RD


def narrow_pitch(Wd):
    """The row pitch of a front's buffers in the narrow kernel (odd)."""
    return Wd | 1


def narrow_warp_bytes(W, R, d):
    """Shared memory of a front in the narrow kernel: the front, L^-1 and
    the panel at narrow_pitch, and the chunk rows of its R(R+1)/2 blocks of
    U (int32, two a double)."""
    Wd, Rd, nblk = W * d, R * d, R * (R + 1) // 2
    return ((2 * Wd + Rd) * narrow_pitch(Wd) + (nblk + 1) // 2) * 8


def narrow_warps(W, R, d):
    """Fronts a CTA of the narrow kernel takes at once (its warps): as many
    of the warps' buffers (narrow_warp_bytes, NARROW_FRONT_BYTES in all) as
    fit, at most NARROW_WARPS."""
    return max(1, min(NARROW_WARPS,
                      NARROW_FRONT_BYTES // narrow_warp_bytes(W, R, d)))


class NarrowPlan(NamedTuple):
    """One narrow level's chunk plan (narrow_plan; int32 tensors on the
    solver's device).  Plan position p holds front order[p]: the fronts
    sorted by their first row variable, then front.  Chunk c takes the
    positions cptr[c]..cptr[c+1] and sums them into the rows
    rptr[c]..rptr[c+1] of the partial buffer, a row a (chunk, target) in
    target order; urow (S, R(R+1)/2): the chunk's row of each block (a, b),
    b <= a, of U at position p (-1: none).  Target i (tgt, the level's
    unique targets, ascending) takes the rows trow[tptr[i]:tptr[i+1]], in
    chunk order.  mem_row, mem_src: every block of U (flat (s, a, b) over
    (S, R, R)) beside its row, sorted by row then position (the model's
    order); src, ptr: the level's Schur plan (its sorted segment sum, which
    the plain scatter runs).  warps: the kernel's fronts at once; rows_max:
    the most rows of a chunk."""
    order: torch.Tensor
    cptr: torch.Tensor
    rptr: torch.Tensor
    urow: torch.Tensor
    tptr: torch.Tensor
    trow: torch.Tensor
    tgt: torch.Tensor
    mem_row: torch.Tensor
    mem_src: torch.Tensor
    src: torch.Tensor
    ptr: torch.Tensor
    S: int
    W: int
    R: int
    d: int
    nb: int
    nrows: int
    rows_max: int
    warps: int


def narrow_chunks(row0, tgt_blocks, rows_cap, chunk):
    """(order, cptr) of a narrow level's chunk plan: the fronts sorted by
    their first row variable row0 (S,), then front, cut into chunks of at
    most `chunk` fronts whose blocks (tgt_blocks (S, nblk): each block's
    target, -1 for none) reach at most rows_cap distinct targets; numpy."""
    S = row0.shape[0]
    order = np.argsort(row0, kind="stable")
    cuts = list(range(0, S, chunk)) + [S]
    tb = tgt_blocks[order]
    out = [0]
    for c0, c1 in zip(cuts[:-1], cuts[1:]):
        t = tb[c0:c1]
        if np.unique(t[t >= 0]).size <= rows_cap:
            out.append(c1)
            continue
        seen = set()     # a chunk over the cap: cut it front by front
        for p in range(c0, c1):
            new = seen | set(tb[p][tb[p] >= 0].tolist())
            if len(new) > rows_cap and seen:
                out.append(p)
                new = set(tb[p][tb[p] >= 0].tolist())
            seen = new
        out.append(c1)
    return order.astype(np.int32), np.asarray(out, dtype=np.int32)


def narrow_plan(lp, ptr_, d, nb, device) -> NarrowPlan:
    """The NarrowPlan of level plan lp (supernodal.py::_LevelPlan, narrow)
    with its Schur segments' CSR offsets ptr_ (None without a panel), on a
    store of nb rows; built on the host, checked, moved to `device`."""
    S, W, R = lp.S, lp.W, lp.R
    nblk = R * (R + 1) // 2
    tri = np.tril(np.ones((R, R), dtype=bool))
    tb = np.full((S, nblk), -1, np.int64)
    if R:
        src = lp.schur_src.astype(np.int64)
        full = np.full((S, R, R), -1, np.int64)
        full[src // (R * R), src % (R * R) // R, src % R] = \
            lp.schur_tgt[lp.schur_seg]
        tb = full[:, tri]
    row0 = (lp.row_vars[:, 0] if R else np.zeros(S)).astype(np.int64)
    cap = NARROW_ROW_BYTES // (d * d * 8)
    order, cptr = narrow_chunks(row0, tb, cap, NARROW_CHUNK)
    nchunk = len(cptr) - 1
    chunk_of = np.repeat(np.arange(nchunk), np.diff(cptr))
    # rows: the distinct (chunk, target) pairs in that order
    pos = np.repeat(np.arange(S), nblk)
    tpos = tb[order].reshape(-1)
    keep = tpos >= 0
    pc, pt = chunk_of[pos[keep]], tpos[keep]
    T = 0 if lp.schur_tgt is None else len(lp.schur_tgt)
    key = pc * (T + 1) + np.searchsorted(
        lp.schur_tgt if T else np.zeros(0), pt)
    rkey, rid = np.unique(key, return_inverse=True)
    rchunk, rtgt = rkey // (T + 1), rkey % (T + 1)
    rptr = np.searchsorted(rchunk, np.arange(nchunk + 1)).astype(np.int32)
    urow = np.full(S * nblk, -1, np.int64)
    urow[np.flatnonzero(keep)] = rid - rptr[pc]
    # members: every block of U beside its row, by row then position
    ab = np.flatnonzero(tri.reshape(-1))
    msrc = (order[pos[keep]].astype(np.int64) * R * R
            + np.tile(ab, S)[keep])
    mo = np.lexsort((pos[keep], rid))
    # each target's rows in chunk order
    to = np.lexsort((rchunk, rtgt))
    tptr = np.searchsorted(rtgt[to], np.arange(T + 1))
    rows = np.diff(rptr)
    i32 = torch.int32

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=i32,
                               device=device)
    empty = np.zeros(0, np.int32)
    plan = NarrowPlan(
        order=t(order), cptr=t(cptr), rptr=t(rptr),
        urow=t(urow.reshape(S, nblk)), tptr=t(tptr), trow=t(to),
        tgt=t(lp.schur_tgt if T else empty), mem_row=t(rid[mo]),
        mem_src=t(msrc[mo]), src=t(lp.schur_src if R else empty),
        ptr=t(ptr_ if R else np.zeros(1, np.int32)), S=int(S), W=int(W),
        R=int(R), d=int(d), nb=int(nb), nrows=int(len(rkey)),
        rows_max=int(rows.max()) if nchunk else 0,
        warps=narrow_warps(W, R, d))
    if not (narrow_route(W, R, d) and plan.rows_max <= max(cap, nblk)
            and (T == 0 or (int(lp.schur_tgt.max()) < nb - 1
                            and np.all(np.diff(tptr) > 0)))
            and len(msrc) == (0 if lp.schur_src is None
                              else len(lp.schur_src))):
        raise ValueError("narrow_plan: the level does not fit the narrow "
                         "route, or its plan is out of range")
    return plan


def narrow_chunk_plan_model(Lp, plan):
    """The chunk plan's sums, plainly: (part (nrows, d*d), each (chunk,
    target) row the sum of its blocks of U = Lp Lp^T in plan order; seg
    (T, d*d), each target's rows summed in chunk order)."""
    d = plan.d
    dev = Lp.device
    Ub = _u_blocks(Lp, plan.S, plan.R, d)
    part = torch.zeros((plan.nrows, d * d), dtype=F64,
                       device=dev).index_add_(
        0, plan.mem_row.long(), Ub[plan.mem_src.long()])
    seg = torch.zeros((plan.tgt.shape[0], d * d), dtype=F64,
                      device=dev).index_add_(
        0, segment_owner(plan.tptr), part[plan.trow.long()])
    return part, seg


def sn_narrow_front_plain(work, blocks, diag_ids, diag_flip, diag_pad,
                          valid_diag, col_vars, dbc, panel_ids, lam,
                          diagonal_damping, rec, plan, part, min_diag=1e-6,
                          max_diag=1e32, out=None):
    L, Linv, At, tiles = sn_front_factor_plain(
        work, blocks, diag_ids, diag_flip, diag_pad, valid_diag, col_vars,
        dbc, panel_ids, lam, diagonal_damping, rec, min_diag, max_diag)
    LpT = None if At is None else _finite(torch.bmm(Linv, At))
    bufs = (L.mT, Linv.mT, LpT, tiles)    # as the kernel writes them
    if out is not None:
        bufs = tuple(t if o is None or t is None else o.copy_(t)
                     for o, t in zip(out, bufs))
    Lp = None if LpT is None else bufs[2].mT
    if Lp is not None:
        part[:plan.nrows * plan.d ** 2] = narrow_chunk_plan_model(
            Lp, plan)[0].reshape(-1)
    return bufs[0].mT, bufs[1].mT, Lp, bufs[3]


def sn_narrow_front(work, blocks, diag_ids, diag_flip, diag_pad, valid_diag,
                    col_vars, dbc, panel_ids, lam, diagonal_damping, rec,
                    plan, part, min_diag=1e-6, max_diag=1e32, out=None):
    """Kernel 7n, fronts of a narrow level (narrow_route): what
    sn_front_factor computes on the level (L, L^-1, the tile inverses, a
    front's one 32 x 32 tile, and the records), and the panel Lp = A L^-T
    in place of At: returns (L, L^-1 (S, W*d, W*d), Lp (S, R*d, W*d; None
    without a row structure), each column-major per front, tiles (S, 32,
    32)); and into `part` (a flat scratch of at least plan.nrows * d * d
    doubles) the chunk plan's rows: each (chunk, target) row the sum of its
    blocks of U = Lp Lp^T in plan order (narrow_chunk_plan_model).  On the
    card one launch, a CTA a chunk of fronts and a warp a front; `out`:
    the buffers it writes whole, (L^T, L^-T, Lp^T, tiles) row-major, each
    None for a new one."""
    args = (work, blocks, diag_ids, diag_flip, diag_pad, valid_diag,
            col_vars, dbc)
    if on_cpu(*args, rec, part, *_tensors(panel_ids)):
        return sn_narrow_front_plain(*args, panel_ids, lam, diagonal_damping,
                                     rec, plan, part, min_diag, max_diag,
                                     out)
    nb, dd = work.shape
    d = _width(dd)
    S, W, _ = diag_ids.shape
    R = 0 if panel_ids is None else panel_ids.shape[1]
    n = dbc.shape[0]
    Wd, Rd = W * d, R * d
    specs = [("work", work, F64, (nb, dd)), ("blocks", blocks, F64, (nb, dd)),
             ("diag_ids", diag_ids, I32, (S, W, W)),
             ("diag_flip", diag_flip, BOOL, (S, W, W)),
             ("diag_pad", diag_pad, F64, (S, Wd)),
             ("valid_diag", valid_diag, BOOL, (S, Wd)),
             ("col_vars", col_vars, I32, (S, W)), ("dbc", dbc, I32, (n,)),
             ("rec", rec, I32, (S,)), ("part", part, F64, (part.shape[0],))]
    if R:
        specs.append(("panel_ids", panel_ids, I32, (S, R, W)))
    shapes = ((S, Wd, Wd), (S, Wd, Wd), (S, Wd, Rd) if R else None,
              (S, TILE, TILE))
    out = (None,) * 4 if out is None else tuple(out)
    specs += [(f"out[{k}]", o, F64, shape)
              for k, (o, shape) in enumerate(zip(out, shapes))
              if o is not None and shape is not None]
    dev = check("sn_narrow_front", *specs)
    if (S, W, R, d, nb) != (plan.S, plan.W, plan.R, plan.d, plan.nb) or \
            plan.order.device != dev or \
            part.shape[0] < plan.nrows * dd:
        raise ValueError(f"sn_narrow_front: the plan is for {plan.S} fronts "
                         f"(W {plan.W}, R {plan.R}, d {plan.d}, {plan.nb} "
                         f"store rows) on {plan.order.device}, or part holds "
                         f"fewer than {plan.nrows * dd} doubles")
    L, X, LpT, tiles = (
        None if shape is None else o if o is not None
        else torch.empty(shape, dtype=F64, device=dev)
        for o, shape in zip(out, shapes))
    KERNELS["sn_narrow_front"].launch(
        dev, plan.cptr.shape[0] - 1, W, R, d, n, plan.warps,
        plan.rows_max, *map(ptr, args), ptr(panel_ids) if R else 0,
        ptr(plan.order), ptr(plan.cptr), ptr(plan.rptr), ptr(plan.urow),
        float(lam), int(bool(diagonal_damping)), float(min_diag),
        float(max_diag), ptr(L), ptr(X), ptr(LpT) if R else 0, ptr(tiles),
        ptr(part), ptr(rec))
    return L.mT, X.mT, None if LpT is None else LpT.mT, tiles


def sn_narrow_scatter_plain(Lp, part, plan, work):
    _schur_scatter_plain(Lp, plan.src, plan.ptr, plan.tgt, plan.S, plan.R,
                         plan.d, work)


def sn_narrow_scatter(Lp, part, plan, work):
    """Kernel 7n, the Schur scatter of a narrow level: work[tgt[i]] -= the
    sum of the blocks of U = Lp Lp^T that target it (Lp: sn_narrow_front's
    panel, (S, R*d, W*d) column-major per front).  On the card one launch
    that sums each target's chunk rows of `part` (sn_narrow_front's) in
    chunk order, a thread an entry, and subtracts once; the plain version
    sums U's blocks in the level's Schur plan order, as
    sn_schur_update_plain does."""
    if on_cpu(Lp, part, work):
        return sn_narrow_scatter_plain(Lp, part, plan, work)
    S, R, d = plan.S, plan.R, plan.d
    Rd, Wd = R * d, plan.W * d
    dev = check("sn_narrow_scatter",
                ("Lp", Lp.mT if Lp.mT.is_contiguous() else Lp, F64,
                 (S, Wd, Rd) if Lp.mT.is_contiguous() else (S, Rd, Wd)),
                ("part", part, F64, (part.shape[0],)),
                ("work", work, F64, (plan.nb, d * d)))
    if plan.tgt.device != dev or part.shape[0] < plan.nrows * d * d:
        raise ValueError(f"sn_narrow_scatter: the plan lies on "
                         f"{plan.tgt.device}, or part holds fewer than "
                         f"{plan.nrows * d * d} doubles")
    KERNELS["sn_narrow_scatter"].launch(
        dev, plan.tgt.shape[0], d, ptr(plan.tptr), ptr(plan.trow),
        ptr(plan.tgt), ptr(part), ptr(work))


# -- kernel 8: forward and backward substitution -----------------------------

# The diagonal tiles of the blocked substitution (kTile in sn_solve.cu), the
# int64 fields of a level-table row (struct Level) and the most dynamic
# shared memory a block takes on the H100.
TILE = 32
LEVEL_FIELDS = 12
SHARED_BYTES = 232448
# CTAs of a thread-block cluster in kernel 8's solves (sn_solve.cu): a
# level's fronts each take as many of a cluster's CTAs as still lets all of
# them run at once.  scripts/port_level_time.py sets it to 1 (a CTA per
# front throughout) to time the split against; nothing else changes it.
_SOLVE_CLUSTER = 8
I64 = torch.int64


class Levels(NamedTuple):
    """A factorization as kernel 8 reads it (level_table): the level table,
    each level's L and P (column-major per front), and the totals over the
    levels that size the solves' buffers: diagonal tiles, y and c doubles,
    column and row slots, and the most Wd + Rd of a front."""
    table: torch.Tensor
    Ls: list
    Ps: list
    tiles: int
    n_y: int
    n_c: int
    n_slots: int
    n_rows: int
    front: int


def _ntiles(Wd):
    return -(-Wd // TILE)


def _as_colmajor(t):
    """t itself when stored column-major per batch entry (as cholesky_ex
    and solve_triangular leave their results), else a column-major copy."""
    return t if t.mT.is_contiguous() else t.mT.contiguous().mT


def level_table(Ls, Ps, d):
    """The Levels of one factorization.  The table is (nlev, LEVEL_FIELDS)
    int64 on the factor's device: per level S, W, R, W*d, R*d, the
    addresses of L (S, Wd, Wd) and P (S, Rd, Wd; 0 without a panel; both 0
    on the CPU, where the plain versions read the factor itself), and the
    level's offsets into the all-levels y (S*Wd doubles a level), c (S*Rd),
    tile inverses (S*ceil(Wd/32) tiles), column slots (S*W) and row slots
    (S*R).  Each factor is kept column-major per front (a copy where it was
    not): the table refers to those.  On the card this is where each factor
    is checked, once per factorization, and the table is copied from pinned
    memory without a host sync."""
    Ls = [_as_colmajor(L) for L in Ls]
    Ps = [None if P is None else _as_colmajor(P) for P in Ps]
    cpu = not Ls or on_cpu(*Ls, *_tensors(*Ps))
    rows, off, front = [], [0] * 5, 0
    for L, P in zip(Ls, Ps):
        S, Wd, _ = L.shape
        Rd = 0 if P is None else P.shape[1]
        W, R = Wd // d, Rd // d
        addr = (0, 0) if cpu else (ptr(L), 0 if P is None else ptr(P))
        rows.append([S, W, R, Wd, Rd, *addr] + off)
        for j, v in enumerate((S * Wd, S * Rd, S * _ntiles(Wd), S * W,
                               S * R)):
            off[j] += v
        front = max(front, Wd + Rd)
    table = torch.tensor(rows, dtype=I64).reshape(-1, LEVEL_FIELDS)
    n_y, n_c, tiles, n_slots, n_rows = off
    if not cpu:
        specs = []
        for k, (L, P) in enumerate(zip(Ls, Ps)):
            S, Wd, _ = L.shape
            specs.append((f"L[{k}]", L.mT, F64, (S, Wd, Wd)))
            if P is not None:
                specs.append((f"P[{k}]", P.mT, F64, (S, Wd, P.shape[1])))
        dev = check("level_table", *specs)
        if front * 8 > SHARED_BYTES:
            raise ValueError(f"level_table: a front of {front} rows exceeds "
                             "kernel 8's shared memory")
        table = table.pin_memory().to(dev, non_blocking=True)
    return Levels(table, Ls, Ps, tiles, n_y, n_c, n_slots, n_rows, front)


def _solve_lower(L, rhs, transpose):
    """L^-1 rhs, or L^-T rhs, batched over fronts: (S, Wd)."""
    if transpose:
        return torch.linalg.solve_triangular(L.mT, rhs[..., None],
                                             upper=True)[..., 0]
    return torch.linalg.solve_triangular(L, rhs[..., None],
                                         upper=False)[..., 0]


def diagonal_tiles(Ls):
    """Every front's 32 x 32 diagonal tiles of L, level after level, front
    after front, tile after tile: (tiles, 32, 32), the rows and columns past
    a front's last column set to the identity."""
    out = []
    for L in Ls:
        S, Wd, _ = L.shape
        nt = _ntiles(Wd)
        pad = nt * TILE - Wd
        Lp = torch.nn.functional.pad(L, (0, pad, 0, pad))
        Lp.diagonal(dim1=1, dim2=2)[:, Wd:] = 1.0
        i = torch.arange(nt, device=L.device)
        out.append(Lp.reshape(S, nt, TILE, nt, TILE)[:, i, :, i, :]
                   .transpose(0, 1).reshape(S * nt, TILE, TILE))
    return torch.cat(out) if out else torch.zeros((0, TILE, TILE), dtype=F64)


def tile_inverses(Ls):
    """The inverses of diagonal_tiles(Ls) (tiles, 32, 32): what the front
    kernel leaves for kernel 8, by a batched triangular solve."""
    tiles = diagonal_tiles(Ls)
    eye = torch.eye(TILE, dtype=F64, device=tiles.device)
    return torch.linalg.solve_triangular(tiles, eye.expand_as(tiles),
                                         upper=False).contiguous()


def sn_forward_plain(g, levels, Linv, cols, gat_ptr, gat_seg, gat_src, y, c):
    n, d = g.shape
    g_ext = torch.cat([g, torch.zeros((1, d), dtype=F64, device=g.device)])
    crows = c.view(-1, d)
    yo = co = q = 0
    for L, P in zip(levels.Ls, levels.Ps):
        S, Wd, _ = L.shape
        nq = S * (Wd // d)
        # the gather: each segment's c rows summed in order, then each
        # slot's segments in level order
        p = gat_ptr[q:q + nq + 1]
        e = gat_seg[int(p[0]):int(p[-1]) + 1]
        seg = torch.zeros((e.numel() - 1, d), dtype=F64,
                          device=g.device).index_add_(
            0, segment_owner(e - e[0]),
            crows[gat_src[int(e[0]):int(e[-1])].long()])
        acc = torch.zeros((nq, d), dtype=F64, device=g.device).index_add_(
            0, segment_owner(p - p[0]), seg)
        rhs = (g_ext[cols[q:q + nq].long()] - acc).reshape(S, Wd)
        yk = _solve_lower(L, rhs, False)
        y[yo:yo + S * Wd] = yk.reshape(-1)
        if P is not None:
            Rd = P.shape[1]
            c[co:co + S * Rd] = torch.einsum("sij,sj->si", P, yk).reshape(-1)
            co += S * Rd
        yo += S * Wd
        q += nq
    return y, c


def sn_forward(g, levels, Linv, cols, gat_ptr, gat_seg, gat_src, y, c):
    """Kernel 8, forward over every level: per front rhs = g at its columns
    (cols: every level's col_vars in level order, sentinel n reads 0) less
    the gathered c rows that target each column (gat_ptr over the slots of
    cols -> gat_seg -> gat_src, d-rows of c; each segment summed, then the
    segments in order), y = L^-1 rhs and c = P y, into y (every level's
    S x Wd) and c (every level's S x Rd) at the level table's offsets.
    levels: the factor's level_table; Linv: its tile inverses (the front
    kernel's tiles, level after level).  On the
    card one cooperative launch, whose wrapper checks only the flat tensors
    (level_table checked the factor)."""
    args = (g, Linv, cols, gat_ptr, gat_seg, gat_src, y, c)
    if on_cpu(levels.table, *args):
        return sn_forward_plain(g, levels, *args[1:])
    n, d = g.shape
    lv = levels
    dev = check("sn_forward", ("g", g, F64, (n, d)),
                ("table", lv.table, I64, (len(lv.Ls), LEVEL_FIELDS)),
                ("Linv", Linv, F64, (lv.tiles, TILE, TILE)),
                ("cols", cols, I32, (lv.n_slots,)),
                ("gat_ptr", gat_ptr, I32, (lv.n_slots + 1,)),
                ("gat_seg", gat_seg, I32, (gat_seg.shape[0],)),
                ("gat_src", gat_src, I32, (gat_src.shape[0],)),
                ("y", y, F64, (lv.n_y,)), ("c", c, F64, (lv.n_c,)))
    KERNELS["sn_forward"].launch(dev, len(lv.Ls), d, n, lv.front,
                                 _SOLVE_CLUSTER, ptr(lv.table),
                                 *map(ptr, args))
    return y, c


def sn_backward_plain(y, levels, Linv, cols, rows, x):
    n, d = x.shape
    x_ext = torch.zeros((n + 1, d), dtype=F64, device=x.device)
    offs, yo = [], 0
    q = r = 0
    for L, P in zip(levels.Ls, levels.Ps):
        S, Wd, _ = L.shape
        R = 0 if P is None else P.shape[1] // d
        offs.append((yo, q, r))
        yo, q, r = yo + S * Wd, q + S * (Wd // d), r + S * R
    for (yo, q, r), L, P in reversed(list(zip(offs, levels.Ls, levels.Ps))):
        S, Wd, _ = L.shape
        rhs = y[yo:yo + S * Wd].view(S, Wd)
        if P is not None:
            Rd = P.shape[1]
            xr = x_ext[rows[r:r + S * (Rd // d)].long()].reshape(S, Rd)
            rhs = rhs - torch.einsum("sij,si->sj", P, xr)
        xs = _solve_lower(L, rhs, True).reshape(-1, d)
        cv = cols[q:q + S * (Wd // d)]
        keep = cv < n
        x_ext[cv[keep].long()] = xs[keep]
    x.copy_(x_ext[:n])
    return x


def sn_backward(y, levels, Linv, cols, rows, x):
    """Kernel 8, backward over every level, top-down, into x (n, d), each
    variable written once: per front rhs = y - P^T x at its rows (rows:
    every level's row_vars in level order, sentinel n reads 0), x = L^-T rhs
    at its true columns (cols < n).  levels, Linv and cols as in
    sn_forward.  On the card one cooperative launch."""
    args = (y, Linv, cols, rows, x)
    if on_cpu(levels.table, *args):
        return sn_backward_plain(y, levels, *args[1:])
    n, d = x.shape
    lv = levels
    dev = check("sn_backward", ("y", y, F64, (lv.n_y,)),
                ("table", lv.table, I64, (len(lv.Ls), LEVEL_FIELDS)),
                ("Linv", Linv, F64, (lv.tiles, TILE, TILE)),
                ("cols", cols, I32, (lv.n_slots,)),
                ("rows", rows, I32, (lv.n_rows,)), ("x", x, F64, (n, d)))
    KERNELS["sn_backward"].launch(dev, len(lv.Ls), d, n, lv.front,
                                  _SOLVE_CLUSTER, ptr(lv.table),
                                  *map(ptr, args))
    return x


# -- kernel 9: the refinement matvec ---------------------------------------


def damp_vec(blocks, dbc, pad_diag, lam, diagonal_damping, min_diag=1e-6,
             max_diag=1e32):
    """(n, d) additive diagonal damping on the true dimensions: lam, or
    lam * clip(diag H) (supernodal.py::_damp_vec)."""
    n, d = pad_diag.shape
    true_dims = 1.0 - pad_diag
    if diagonal_damping:
        dv = blocks[dbc.long()][:, torch.arange(d, device=blocks.device)
                                * (d + 1)]
        return lam * dv.clamp(min_diag, max_diag) * true_dims
    return lam * true_dims


def sn_matvec_plain(blocks, x, row_ptr, row_blk, col_ptr, col_blk, block_row,
                    block_col, dbc, pad_diag, lam, diagonal_damping,
                    min_diag=1e-6, max_diag=1e32):
    n, d = x.shape
    B = blocks.shape[0] - 1
    rb, cb = row_blk.long(), col_blk.long()
    Bv = blocks[:B].reshape(B, d, d)
    t1 = torch.einsum("bij,bj->bi", Bv[rb], x[block_col.long()[rb]])
    y = torch.zeros((n, d), dtype=F64, device=x.device).index_add_(
        0, segment_owner(row_ptr), t1)
    if cb.numel():
        t2 = torch.einsum("bij,bi->bj", Bv[cb], x[block_row.long()[cb]])
        y = y + torch.zeros((n, d), dtype=F64, device=x.device).index_add_(
            0, segment_owner(col_ptr), t2)
    return y + damp_vec(blocks, dbc, pad_diag, lam, diagonal_damping,
                        min_diag, max_diag) * x


def sn_matvec(blocks, x, row_ptr, row_blk, col_ptr, col_blk, block_row,
              block_col, dbc, pad_diag, lam, diagonal_damping, min_diag=1e-6,
              max_diag=1e32):
    """Kernel 9: y = (H + damping) x on the block store, x and y (n, d) in
    the permuted layout.  Variable v sums B_k x[col_k] over its row blocks
    (row_blk[row_ptr[v]:row_ptr[v+1]]) and B_k^T x[row_k] over its
    off-diagonal column blocks (col_blk over col_ptr), then adds damp x.
    The CSRs list H's own blocks (the solver's, over T): the kernel reads
    those blocks and no other."""
    args = (blocks, x, row_ptr, row_blk, col_ptr, col_blk, block_row,
            block_col, dbc, pad_diag)
    if on_cpu(*args):
        return sn_matvec_plain(*args, lam, diagonal_damping, min_diag,
                               max_diag)
    nb, dd = blocks.shape
    n, d = x.shape
    dev = check("sn_matvec", ("blocks", blocks, F64, (nb, d * d)),
                ("x", x, F64, (n, d)), ("row_ptr", row_ptr, I32, (n + 1,)),
                ("row_blk", row_blk, I32, (row_blk.shape[0],)),
                ("col_ptr", col_ptr, I32, (n + 1,)),
                ("col_blk", col_blk, I32, (col_blk.shape[0],)),
                ("block_row", block_row, I32, (nb - 1,)),
                ("block_col", block_col, I32, (nb - 1,)),
                ("dbc", dbc, I32, (n,)), ("pad_diag", pad_diag, F64, (n, d)))
    y = torch.empty((n, d), dtype=F64, device=dev)
    KERNELS["sn_matvec"].launch(dev, n, d, *map(ptr, args), float(lam),
                                int(bool(diagonal_damping)), float(min_diag),
                                float(max_diag), ptr(y))
    return y


# -- kernel 12: the level step of the multifrontal QR ------------------------

# Kernel 12's panel width (csrc/sn_qr.cu's kNb): a front's column tiles,
# each a panel of the blocked Householder and a unit of the CTAs' shares.
QR_PANEL = 16
# A front's panel goes through L2 where it does not fit in shared memory,
# so rows are bounded only by int32 row indices (with room for the
# rounding of the leading dimension and the 16-row granules).
QR_MAX_ROWS = 1 << 24


class QRLevel(NamedTuple):
    """One level's fronts as kernel 12 gathers them (qr_level): S fronts of
    W column blocks and R row blocks of width d, the level's first front in
    the factorization's order (front0), each front's true rows m (S,) and
    its offset in the scratch foff (S,) int64 (column-major m x (W + R) d);
    row order: the factor rows, the children's rows, then the W d damping
    rows.  Factor slots (a slot is one factor's Jacobian of one variable):
    front s owns slots sptr[s]..sptr[s+1], slot q's rdim rows srows[q] from
    pool entry spool[q] at block position spos[q], from front row
    srow0[q].  Children: front s owns cptr[s]..cptr[s+1]; child q is front
    cfront[q] of the factorization (its R_sep at roff[cfront[q]] in the
    R_sep buffer, rld[cfront[q]] wide), with cr[q] row blocks that go to
    this front's block positions cmap[mptr[q]:mptr[q+1]], from front row
    crow0[q].  mmax: the most rows of a front; fsize: the doubles of the
    level's fronts in the scratch (each column-major with its leading
    dimension m rounded up to 16, qr_ld); qr_scratch_doubles adds kernel
    12's panel blocks after them."""
    S: int
    W: int
    R: int
    d: int
    front0: int
    mmax: int
    fsize: int
    m: torch.Tensor
    foff: torch.Tensor
    sptr: torch.Tensor
    spool: torch.Tensor
    spos: torch.Tensor
    srow0: torch.Tensor
    srows: torch.Tensor
    cptr: torch.Tensor
    crow0: torch.Tensor
    cr: torch.Tensor
    cfront: torch.Tensor
    mptr: torch.Tensor
    cmap: torch.Tensor


def qr_level(S, W, R, d, front0, m, sptr, spool, spos, srow0, srows, cptr,
             crow0, cr, cfront, mptr, cmap, device) -> QRLevel:
    """A level's QRLevel from host (numpy) arrays, checked once (every row
    and column an entry lands on lies in its front) and moved to
    `device`."""
    import numpy as np
    C = (W + R) * d
    m = np.asarray(m, np.int64)
    nslot = np.diff(sptr)
    srows, srow0 = np.asarray(srows), np.asarray(srow0)
    own = np.repeat(np.arange(S), nslot)
    ownc = np.repeat(np.arange(S), np.diff(cptr))
    ok = (len(m) == S and (m >= W * d).all()
          and (srow0 + srows <= m[own] - W * d).all()
          and (np.asarray(spos) < W + R).all()
          and (np.asarray(crow0) + np.asarray(cr) * d
               <= m[ownc] - W * d).all()
          and (np.asarray(cmap) < W + R).all())
    if not ok:
        raise ValueError("qr_level: an index of the plan is out of range")
    mmax = int(m.max()) if S else 0
    if mmax > QR_MAX_ROWS:
        raise ValueError(f"qr_level: a front of {mmax} rows exceeds kernel "
                         f"12's row indices ({QR_MAX_ROWS} rows)")
    foff = np.concatenate([[0], np.cumsum(qr_ld(m) * C)])
    if foff[-1] >= 2 ** 62:
        raise ValueError("qr_level: the level's fronts outgrow int64")

    def t(a, dtype=I32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)
    return QRLevel(int(S), int(W), int(R), int(d), int(front0), mmax,
                   int(foff[-1]), t(m), t(foff[:-1], torch.int64), t(sptr),
                   t(spool), t(spos), t(srow0), t(srows), t(cptr), t(crow0),
                   t(cr), t(cfront), t(mptr), t(cmap))


def qr_ld(m):
    """A front's leading dimension in kernel 12's scratch: its rows m
    rounded up to 16 doubles, so that no 128-byte line holds two columns
    (each column is one CTA's)."""
    return (m + 15) // 16 * 16


def qr_scratch_doubles(plan):
    """The scratch kernel 12 needs for a level: its fronts (plan.fsize),
    then each front's ceil(C / QR_PANEL) panel blocks (T, QR_PANEL x
    QR_PANEL, and the panel rows' flips)."""
    C = (plan.W + plan.R) * plan.d
    return plan.fsize + plan.S * -(-C // QR_PANEL) * (QR_PANEL + 1) \
        * QR_PANEL


def qr_ctas(S, C, sms):
    """Kernel 12's CTAs a front on a card of `sms` SMs: the level's share
    of the SMs, at most the front's column tiles, at least one."""
    return max(1, min(-(-C // QR_PANEL), sms // max(S, 1)))


# The flags of kernels 7 (the front kernel) and 12: per (kernel, device,
# stream) an int32 buffer, zeroed when it is made, and the number of its
# last launch, which only grows: a flag that holds a launch's number was
# set in that launch.
_FLAGS = {}


def _launch_flags(kind, device, n):
    """(flags, this launch's number) of kernel `kind` on `device`'s current
    stream, the buffer at least n ints."""
    key = (kind, device, _kernels.stream(device))
    fl = _FLAGS.get(key)
    if fl is None or fl[0].numel() < n:
        fl = _FLAGS[key] = [torch.zeros(max(n, 4096), dtype=I32,
                                        device=device), 0]
    if fl[1] == 2 ** 31 - 1:   # the numbers start again: no stale flag
        fl[0].zero_()
        fl[1] = 0
    fl[1] += 1
    return fl


def _qr_fronts(pool, plan, valid_diag, roff, rld, rsep, lam):
    """The level's fronts (S, max(mmax, C), C) as kernel 12 gathers them,
    zero rows appended (the plain version's padded batch)."""
    S, W, R, d = plan.S, plan.W, plan.R, plan.d
    Wd, C = W * d, (W + R) * d
    dev = pool.device
    M = max(plan.mmax, C)
    front = torch.zeros((S, M, C), dtype=F64, device=dev)
    own = segment_owner(plan.sptr)
    rmax = pool.shape[1]
    i = torch.arange(rmax, device=dev)
    q, r = torch.nonzero(i[None, :] < plan.srows.long()[:, None],
                         as_tuple=True)
    cols = plan.spos.long()[q, None] * d + torch.arange(d, device=dev)
    front[own[q, None], (plan.srow0.long()[q] + r)[:, None], cols] = \
        pool[plan.spool.long()[q], r]
    if plan.cr.numel():
        cptr, crow0, cr = (plan.cptr.tolist(), plan.crow0.tolist(),
                           plan.cr.tolist())
        cfront, mptr = plan.cfront.tolist(), plan.mptr.tolist()
        ro, ld = roff.tolist(), rld.tolist()
        for s in range(S):
            for k in range(cptr[s], cptr[s + 1]):
                f, n = cfront[k], cr[k] * d
                blk = rsep[ro[f]:ro[f] + ld[f] * ld[f]].view(ld[f], ld[f])
                c = (plan.cmap[mptr[k]:mptr[k + 1]].long()[:, None] * d
                     + torch.arange(d, device=dev)).reshape(-1)
                front[s, crow0[k]:crow0[k] + n, c] = torch.triu(
                    blk[:n, :n])
    t = torch.arange(Wd, device=dev)
    dval = torch.full(valid_diag.shape, float(lam) ** 0.5, dtype=F64,
                      device=dev).masked_fill_(~valid_diag, 1.0)
    front[torch.arange(S, device=dev)[:, None],
          plan.m.long()[:, None] - Wd + t[None, :], t[None, :]] = dval
    return front


def sn_front_qr_plain(pool, plan, valid_diag, col_vars, roff, rld, rsep, lam,
                      rec, tiles, pivot_tol=1e-10, scratch=None):
    S, W, R, d = plan.S, plan.W, plan.R, plan.d
    Wd, Rd = W * d, R * d
    front = _qr_fronts(pool, plan, valid_diag, roff, rld, rsep, lam)
    Rf = torch.linalg.qr(front, mode="r").R
    # the sign rule: R's diagonal non-negative, each row whose diagonal is
    # negative negated (R^T R is unchanged)
    sgn = torch.where(Rf.diagonal(dim1=1, dim2=2) < 0, -1.0, 1.0)
    Rf = Rf * sgn[..., None]
    piv = Rf.diagonal(dim1=1, dim2=2)[:, :Wd]
    bad = valid_diag & ~(torch.isfinite(piv) & (piv > pivot_tol))
    first = bad.to(torch.int8).argmax(dim=1)
    col = torch.gather(col_vars, 1, (first // d)[:, None])[:, 0]
    rec.copy_(torch.where(bad.any(dim=1), col, -1))
    Lt = _finite(torch.triu(Rf[:, :Wd, :Wd]).contiguous())
    Pt = _finite(Rf[:, :Wd, Wd:].contiguous()) if R else None
    if R:
        ro = roff[plan.front0:plan.front0 + S].tolist()
        for s in range(S):
            rsep[ro[s]:ro[s] + Rd * Rd].copy_(
                torch.triu(Rf[s, Wd:, Wd:]).reshape(-1))
    tiles.copy_(tile_inverses([Lt.mT]))
    return Lt, Pt


def sn_front_qr(pool, plan, valid_diag, col_vars, roff, rld, rsep, lam, rec,
                tiles, pivot_tol=1e-10, scratch=None, ctas=None):
    """Kernel 12: one level of the multifrontal QR of the whitened Jacobian
    (supernodal.py::factorize_qr).  Each front (plan, a QRLevel) is
    [its factors' rows of pool (P, rmax, d), the pool entries of kernel 6's
    Jacobian rows | its children's R_sep rows, read from rsep | sqrt(lam)
    on the true diagonal, 1 on the padding] over its [W d frontal | R d
    separator] columns, factored R = Q^T front with R's diagonal made
    non-negative (each row with a negative diagonal negated).  Returns (Lt,
    Pt): R's frontal block (S, W d, W d) and panel (S, W d, R d; None when
    R = 0), row-major, non-finite entries zeroed (L = Lt^T and the panel
    Lp = Pt^T, column-major per front, as level_table keeps them); writes
    each front's R_sep (R d x R d, upper triangular, row-major) at
    roff[front0 + s] of rsep, the inverses of L's 32 x 32 diagonal tiles
    into tiles (S * ceil(W d / 32), 32, 32) in kernel 8's order, and rec
    (S,) int32: each front's first true pivot |R_kk| not finite or <=
    pivot_tol, as its permuted column (col_vars), or -1.  On the card one
    launch in `scratch` (at least qr_scratch_doubles(plan) doubles; the
    fronts column-major): blocked Householder in panels of QR_PANEL
    columns, each panel's T by dlarft's recurrence and the later column
    tiles updated as A -= V (T^T (V^T A)) on the FP64 tensor cores; `ctas`
    CTAs a front (default qr_ctas: the level's share of the SMs), which
    share out the front's column tiles and pass each factored panel on by
    a flag, the owner of the next panel updating it first (look-ahead);
    any ctas gives the same bits.  The plain version is torch.linalg.qr of
    the same gather."""
    args = (pool, valid_diag, col_vars, roff, rld, rsep, rec, tiles)
    if on_cpu(*args, plan.m, *_tensors(scratch)):
        return sn_front_qr_plain(pool, plan, valid_diag, col_vars, roff,
                                 rld, rsep, lam, rec, tiles, pivot_tol)
    S, W, R, d = plan.S, plan.W, plan.R, plan.d
    Wd, Rd = W * d, R * d
    P, rmax, dp = pool.shape
    if scratch is None:
        raise ValueError("sn_front_qr: the kernel needs a scratch")
    dev = check("sn_front_qr", ("pool", pool, F64, (P, rmax, d)),
                ("valid_diag", valid_diag, BOOL, (S, Wd)),
                ("col_vars", col_vars, I32, (S, W)),
                ("roff", roff, I64, (roff.shape[0],)),
                ("rld", rld, I32, roff.shape),
                ("rsep", rsep, F64, (rsep.shape[0],)),
                ("rec", rec, I32, (S,)),
                ("tiles", tiles, F64, (S * _ntiles(Wd), TILE, TILE)),
                ("scratch", scratch, F64, (scratch.shape[0],)),
                ("m", plan.m, I32, (S,)))
    need = qr_scratch_doubles(plan)
    if scratch.numel() < need:
        raise ValueError(f"sn_front_qr: the scratch must hold {need} "
                         "doubles")
    ntile = -(-(Wd + Rd) // QR_PANEL)
    if ctas is None:
        ctas = qr_ctas(S, Wd + Rd, device_sms(dev))
    ctas = max(1, min(int(ctas), ntile))
    flags, seq = _launch_flags("qr", dev, S * ntile)
    Lt = torch.empty((S, Wd, Wd), dtype=F64, device=dev)
    Pt = torch.empty((S, Wd, Rd), dtype=F64, device=dev) if R else None
    KERNELS["sn_front_qr"].launch(
        dev, S, W, R, d, rmax, plan.front0, ctas, seq, ptr(pool),
        *map(ptr, (plan.sptr, plan.spool, plan.spos, plan.srow0, plan.srows,
                   plan.cptr, plan.crow0, plan.cr, plan.cfront, plan.mptr,
                   plan.cmap, plan.m, plan.foff, valid_diag, col_vars, roff,
                   rld)),
        float(lam) ** 0.5, float(pivot_tol), ptr(scratch), ptr(rsep),
        ptr(Lt), ptr(Pt) if R else 0, ptr(tiles), ptr(rec), ptr(flags))
    return Lt, Pt
