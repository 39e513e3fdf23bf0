"""Wrappers of the hand-written CUDA kernels of the blocked dense Cholesky.

Kernel 10 (csrc/dense_factor.cu) factors and inverts one 128-wide panel's
diagonal block; kernel 11 (csrc/dense_solve.cu) runs the panelled forward
and backward substitution with the stored inverses, one cooperative launch
per direction.  linear/dense_blocked.py drives them.  S (and L) is n x n,
row-major, float64 or float32 (the mixed-precision mode), its rows
contiguous and possibly further apart than n (_kernels.row_strided: the
kernels take the row stride); only its lower triangle is read or
written.  Dinv is (panels, 128, 128),
each panel's L_D^-1 row-major, zero above the diagonal and the identity
past the last panel's width; info is one int32, 0 until a pivot fails and
then the failing column + 1 (LAPACK's convention), never overwritten.
Each wrapper
  - on CPU tensors computes its plain PyTorch version (`*_plain`), which the
    CPU tests compare against the JAX package;
  - on CUDA tensors checks dtype, shape, contiguity and device, launches its
    kernel (the float32 variant for float32 tensors) on the current stream
    and counts the launch.
It never falls back to the plain version on a CUDA tensor.  The plain
versions also run on CUDA tensors when called directly, which is how the
kernels are checked on the card.
"""

import torch

from .. import _kernels
from .._kernels import INT, P, ROWS, Kernel, check, on_cpu, ptr

PANEL = 128
F64 = torch.float64
F32 = torch.float32
I32 = torch.int32

_DENSE = "gtsam_tpu/linear/dense_blocked.py"

# A kernel named "<name>_f32" is the float32 variant of "<name>": the same
# source and wrapper, float32 S, L, Dinv and vectors.
KERNELS = _kernels.table(
    Kernel("dense_factor_diag", "dense_factor", "factor_diag",
           f"{_DENSE}:83", [INT, INT, INT, P, P, P]),
    Kernel("dense_factor_diag_f32", "dense_factor", "factor_diag",
           f"{_DENSE}:83", [INT, INT, INT, P, P, P]),
    Kernel("dense_forward", "dense_solve", "solve_forward",
           f"{_DENSE}:121", [INT, INT, P, P, P, P, P]),
    Kernel("dense_forward_f32", "dense_solve", "solve_forward",
           f"{_DENSE}:121", [INT, INT, P, P, P, P, P]),
    Kernel("dense_backward", "dense_solve", "solve_backward",
           f"{_DENSE}:134", [INT, INT, P, P, P, P, P]),
    Kernel("dense_backward_f32", "dense_solve", "solve_backward",
           f"{_DENSE}:134", [INT, INT, P, P, P, P, P]),
)

# Kernel 11's output is also its channel between CTAs: each entry is
# published by one relaxed store, and the wrapper first fills the output
# with the word below (a NaN no arithmetic gives: the kernel stores every
# NaN as the canonical one), which a reader takes for "not written yet".
# csrc/dense_solve.cu's Word<T>::kPending holds the same words.
PENDING = {F64: (torch.int64, 0x7FF4DEAD5EED0001),
           F32: (torch.int32, 0x7FA5EED1)}

_SUFFIX = {F64: "", F32: "_f32"}


def panels(n):
    """The number of 128-wide panels of an n x n matrix."""
    return -(-n // PANEL)


def _variant(name, arg, t):
    """The kernel of `name` for tensors of t's dtype; raises for a dtype no
    variant takes."""
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: {arg} must be torch.float64 or "
                        f"torch.float32, got {t.dtype}")
    return name + _SUFFIX[t.dtype]


def _square(name, arg, t):
    if t.dim() != 2 or t.shape[0] != t.shape[1] or t.shape[0] == 0:
        raise ValueError(f"{name}: {arg} must have shape (n, n), got "
                         f"{tuple(t.shape)}")
    return t.shape[0]


# -- kernel 10: a panel's diagonal block, factored and inverted ------------


def factor_diag_plain(S, Dinv, info, k):
    n = S.shape[0]
    o = k * PANEL
    w = min(PANEL, n - o)
    blk = S[o:o + w, o:o + w]
    # D from its lower triangle alone, as the kernel reads it
    L, fail = torch.linalg.cholesky_ex(blk.tril() + blk.tril(-1).mT)
    Lp = torch.eye(PANEL, dtype=S.dtype, device=S.device)
    Lp[:w, :w] = L
    eye = torch.eye(PANEL, dtype=S.dtype, device=S.device)
    Dinv[k] = torch.linalg.solve_triangular(Lp, eye, upper=False)
    lower = torch.ones((w, w), dtype=torch.bool, device=S.device).tril()
    blk.copy_(torch.where(lower, L, blk))
    info.copy_(torch.where((info == 0) & (fail > 0), o + fail, info))
    return S, Dinv, info


def factor_diag(S, Dinv, info, k):
    """Kernel 10: the diagonal block D of panel k of S (n x n; columns and
    rows 128 k to 128 k + w, w = 128 or the last panel's width), already
    updated by the earlier panels, factored as D = L_D L_D^T into S's lower
    triangle there, and L_D^-1 into Dinv[k] (the identity past w); the first
    failing pivot goes to info.  On the card one launch of one CTA."""
    if on_cpu(S, Dinv, info):
        return factor_diag_plain(S, Dinv, info, k)
    name = _variant("dense_factor_diag", "S", S)
    n = _square(name, "S", S)
    if not 0 <= k < panels(n):
        raise ValueError(f"{name}: panel {k} out of range for n = {n}")
    dev = check(name, ("S", S, S.dtype, (n, n), ROWS),
                ("Dinv", Dinv, S.dtype, (panels(n), PANEL, PANEL)),
                ("info", info, I32, ()))
    KERNELS[name].launch(dev, n, S.stride(0), k, ptr(S), ptr(Dinv),
                         ptr(info))
    return S, Dinv, info


# -- kernel 11: the forward and backward substitution ------------------------


def solve_forward_plain(L, Dinv, b, y):
    n = L.shape[0]
    r = b.clone()
    for k in range(panels(n)):
        o = k * PANEL
        w = min(PANEL, n - o)
        y[o:o + w] = Dinv[k, :w, :w] @ r[o:o + w]
        r[o + w:] -= L[o + w:, o:o + w] @ y[o:o + w]
    return y


def solve_backward_plain(L, Dinv, y, x):
    n = L.shape[0]
    r = y.clone()
    for k in reversed(range(panels(n))):
        o = k * PANEL
        w = min(PANEL, n - o)
        x[o:o + w] = Dinv[k, :w, :w].mT @ r[o:o + w]
        r[:o] -= L[o:o + w, :o].mT @ x[o:o + w]
    return x


def _solve_specs(name, L, Dinv, u, v, stop):
    """Check kernel 11's arguments and fill its output with PENDING;
    returns (device, n)."""
    n = _square(name, "L", L)
    specs = [("L", L, L.dtype, (n, n), ROWS),
             ("Dinv", Dinv, L.dtype, (panels(n), PANEL, PANEL)),
             ("rhs", u, L.dtype, (n,)), ("out", v, L.dtype, (n,))]
    if stop is not None:
        specs.append(("stop", stop, I32, (stop.shape[0],)))
    dev = check(name, *specs)
    if u.data_ptr() == v.data_ptr():
        raise ValueError(f"{name}: rhs and out must not share memory")
    word, bits = PENDING[L.dtype]
    v.view(word).fill_(bits)
    return dev, n


def _stopped(stop):
    return stop is not None and bool(stop[0])


def solve_forward(L, Dinv, b, y, stop=None):
    """Kernel 11, forward: y = L^-1 b, from the factor's lower triangle and
    its panels' inverses (factor_diag).  On the card one cooperative launch
    (and the fill of y that marks its entries unwritten).  stop: an int32
    word (a CG loop's done word) where the launch returns at once when it
    is set, or None."""
    if on_cpu(L, Dinv, b, y, *([stop] if stop is not None else [])):
        return y if _stopped(stop) else solve_forward_plain(L, Dinv, b, y)
    name = _variant("dense_forward", "L", L)
    dev, n = _solve_specs(name, L, Dinv, b, y, stop)
    KERNELS[name].launch(dev, n, L.stride(0), ptr(L), ptr(Dinv), ptr(b),
                         ptr(y), ptr(stop) if stop is not None else 0)
    return y


def solve_backward(L, Dinv, y, x, stop=None):
    """Kernel 11, backward: x = L^-T y.  On the card one cooperative launch
    (and the fill of x that marks its entries unwritten); stop as
    solve_forward's."""
    if on_cpu(L, Dinv, y, x, *([stop] if stop is not None else [])):
        return x if _stopped(stop) else solve_backward_plain(L, Dinv, y, x)
    name = _variant("dense_backward", "L", L)
    dev, n = _solve_specs(name, L, Dinv, y, x, stop)
    KERNELS[name].launch(dev, n, L.stride(0), ptr(L), ptr(Dinv), ptr(y),
                         ptr(x), ptr(stop) if stop is not None else 0)
    return x
