"""Blocked dense Cholesky factorization and solve (torch).

Counterpart of gtsam_tpu/linear/dense_blocked.py (blocked_cholesky :41,
blocked_cho_solve :100): the same right-looking algorithm, with each
panel's diagonal factor inverted and the panel's strip formed as
C L_D^-T by one product (:79-92).  The JAX package's staged masked windows
(:57-76) exist to keep XLA's program small and are not carried over: the
loop here runs eagerly, panel by panel, on the exact trailing matrix.

  - The panel width is 128: kernel 10 (csrc/dense_factor.cu) factors and
    inverts a 128 x 128 diagonal block in one CTA's shared memory.
  - Panels are taken eight at a time (a super-panel of SUPER = 1024
    columns): inside it each panel updates the super-panel's columns to
    its right (rank 128), and the trailing matrix is then updated once, by
    all 1024 columns (rank 1024, where the H100's cuBLAS products run at
    about twice their rank-128 rate).
  - The trailing update touches the lower triangle only, one product per
    column group of GROUP columns on row-major views of S (no copies); the
    upper halves of the diagonal squares are the only work beyond n^3 / 3.
  - Look-ahead on the card: the next super-panel's columns are updated
    first, and it is factored on a high-priority side stream while the
    rest of the trailing matrix is updated, so that kernel 10's chain of
    launches runs beside the large products.  Every entry gets the same
    operations in the same order as without it.
  - The products are cuBLAS's, as the JAX package leaves them to XLA;
    float32 products run in full float32, never TF32 (the mixed mode's
    float64 refinement is sized for float32 rounding).
  - The solve is kernel 11 (csrc/dense_solve.cu), one cooperative launch a
    direction, with the stored L_D^-1.

The factor is left in S's own memory: its lower triangle is L, and its
strict upper triangle is scratch that nothing reads.  A failed
factorization (a pivot that is not positive and finite) is reported by a
device flag, read once per factorization by the caller, where the JAX
package returns NaN (jnp.linalg.cholesky); gtsam_torch/sfm/ba.py rejects
the LM try on it, as the JAX package rejects its NaN step.
"""

import torch

from . import dense_kernels
from .dense_kernels import PANEL, panels

# columns of a super-panel: the trailing matrix is updated by SUPER columns
# of L at once (8 panels), the panels inside it by 128.  On an H100 at
# n = 15,507 (scripts/port_dense_probe.py), float64 products on aligned
# rows ran at ~25 TFLOP/s at rank 128, ~46 at 512 and ~54 at 1024; the
# whole factorization took 35.5 ms at SUPER = 512 and 33.9 at 1024
# (float32: 40.5 and 38.4; scripts/port_dense_time.py).
SUPER = 1024
# columns of one trailing-update product: the diagonal squares' upper
# halves add 1.5 GROUP / n of the factorization's flops
GROUP = 1024


def blocked_cholesky(S):
    """Lower Cholesky factor of the symmetric positive definite S (n x n,
    float64 or float32, its rows contiguous and at any stride: allocate it
    with gtsam_torch._kernels.row_strided for 256-byte aligned rows, which
    cuBLAS's float64 products need for their full rate; its lower triangle
    is read), computed in S's own memory.  Returns (L, Dinv, info): L is S,
    whose lower triangle now holds the factor; Dinv (panels, 128, 128) the
    inverse of each panel's diagonal factor, for blocked_cho_solve; info a
    0-dim int32 tensor on S's device, 0 on success, else the first failing
    column + 1 (the factor is then meaningless).  No value is read back to
    the host."""
    if (S.dtype == torch.float32 and S.device.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("blocked_cholesky: float32 products must not run "
                           "in TF32 (torch.backends.cuda.matmul.allow_tf32)")
    n = S.shape[0]
    Dinv = torch.empty((panels(n), PANEL, PANEL), dtype=S.dtype,
                       device=S.device)
    info = torch.zeros((), dtype=torch.int32, device=S.device)
    X = torch.empty((max(n - PANEL, 0), PANEL), dtype=S.dtype,
                    device=S.device)
    side = _side_stream(S.device)
    ready = _on_side(side, lambda: _super_panel(S, Dinv, info, X, 0))
    for K0 in range(0, n, SUPER):
        E = min(K0 + SUPER, n)
        _wait(side, ready)              # the super-panel's L is final
        if E >= n:
            break
        # the next super-panel's columns first, so that it is factored on
        # the side stream while the rest of the trailing matrix is updated
        E2 = min(E + SUPER, n)
        _trailing(S, K0, E, E, E2)
        ready = _on_side(side, lambda: _super_panel(S, Dinv, info, X, E))
        _trailing(S, K0, E, E2, n)
    return S, Dinv, info


def _super_panel(S, Dinv, info, X, K0):
    """Factor the columns K0 .. K0 + SUPER of S, whose trailing updates by
    the earlier super-panels are done: per panel kernel 10, the strip below
    its diagonal block, and the super-panel's columns right of it."""
    n = S.shape[0]
    E = min(K0 + SUPER, n)
    for k in range(K0 // PANEL, panels(E)):
        dense_kernels.factor_diag(S, Dinv, info, k)
        r0 = (k + 1) * PANEL
        if r0 >= n:
            break
        # the strip below the diagonal block: L_k = C L_D^-T
        C = S[r0:, r0 - PANEL:r0]
        Xk = X[:n - r0]
        torch.mm(C, Dinv[k].mT, out=Xk)
        C.copy_(Xk)
        if r0 < E:
            S[r0:, r0:E].addmm_(Xk, Xk[:E - r0].mT, alpha=-1)


def _trailing(S, K0, E, c0, c1):
    """Columns c0 .. c1 (>= E) of the trailing lower triangle, less the
    product of the super-panel K0 .. E's L rows: a column group at a time,
    SUPER columns of L at once."""
    Lsp = S[E:, K0:E]
    for j0 in range(c0, c1, GROUP):
        j1 = min(j0 + GROUP, c1)
        S[j0:, j0:j1].addmm_(Lsp[j0 - E:], Lsp[j0 - E:j1 - E].mT, alpha=-1)


_SIDE = {}


def _side_stream(device):
    """A high-priority stream of a CUDA device beside its current one; None
    on the CPU, where everything runs in order."""
    if device.type != "cuda":
        return None
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device, priority=-1)
    return _SIDE[device]


def _on_side(side, work):
    """work() on the side stream, after everything the current stream has
    queued; returns the event that marks its end (None on the CPU)."""
    if side is None:
        work()
        return None
    side.wait_stream(torch.cuda.current_stream(side.device))
    with torch.cuda.stream(side):
        work()
        return side.record_event()


def _wait(side, event):
    """The current stream of the side stream's device waits for `event`
    (nothing to wait for on the CPU)."""
    if side is not None:
        torch.cuda.current_stream(side.device).wait_event(event)


def blocked_cho_solve(L, Dinv, b):
    """x with L L^T x = b, from blocked_cholesky's (L, Dinv); b (n,) of L's
    dtype and device."""
    y = dense_kernels.solve_forward(L, Dinv, b, torch.empty_like(b))
    return dense_kernels.solve_backward(L, Dinv, y, torch.empty_like(b))
