"""Wrappers of the hand-written CUDA kernels of the level-scheduled sparse
Cholesky and of preconditioned conjugate gradients.

Kernels 13 and 14 (csrc/sp_level.cu) port the device routines of
gtsam_tpu/linear/sparse.py: the factorization (factorize: each column's
blocks updated by its triples, the diagonal block's Cholesky with a pivot
record, the subdiagonal blocks' triangular solves, one launch over every
leading level; then the late triples and the dense root's matrix M) and
the forward and backward substitution (solve_factored), one launch a
direction over every level; in both the columns pass their results on by
flags.
Kernels 15 and 16 (csrc/pcg.cu) port gtsam_tpu/linear/pcg.py: the
matrix-free (J^T J + lam) v over the whitened Jacobian rows with p.Ap, the
block-Jacobi diagonal, the steps of the CG iteration, and the loop that
runs a group of those steps, or a whole block-Jacobi solve, in one
launch.

Layouts: the block store is (B, d*d) float64, block b's d x d entries
row-major (L_ij with i >= j lower-stored); vectors of the level solver are
(rows, d) in the permuted (elimination) order; the flat vectors of PCG are
in the canonical tangent layout.  Index arrays are int32 and 1-D: the
solver's job plan (linear/sparse.py) for kernel 13, a direction's job
arrays for kernel 14.  Each wrapper
  - on CPU tensors computes its plain PyTorch version (`*_plain`), which the
    CPU tests compare against the JAX package;
  - on CUDA tensors checks dtype, shape, contiguity and device, launches its
    kernel on the current stream and counts the launch.
It never falls back to the plain version on a CUDA tensor.  No kernel sums
with atomics: every sum runs in an order fixed by the plan (PCG's dot
products across fixed chunks of variables in chunk order, by the last CTA
found by a completion ticket or by every CTA of the loop), so two runs on
the same inputs give the same bits.

The CG loop's kernels and the level solves it runs take `stop`, the
solver's done word: a launch returns at once where it is set, so the host
reads it only every few iterations (linear/pcg.py).
"""

import torch

from .. import _kernels
from .._kernels import DBL, INT, P, ROWS, Kernel, check, on_cpu, ptr, \
    segment_owner

F64 = torch.float64
I32 = torch.int32

_SP = "gtsam_tpu/linear/sparse.py"
_PCG = "gtsam_tpu/linear/pcg.py"

KERNELS = _kernels.table(
    Kernel("sp_level_factor", "sp_level", "sp_level_factor", f"{_SP}:235",
           [INT] * 4 + [P] * 10 + [DBL] + [P] * 3),
    Kernel("sp_tail_assemble", "sp_level", "sp_tail_assemble", f"{_SP}:252",
           [INT] * 4 + [P] * 10 + [DBL, P]),
    Kernel("sp_level_forward", "sp_level", "sp_level_forward", f"{_SP}:278",
           [INT] * 5 + [P] * 13),
    Kernel("sp_level_backward", "sp_level", "sp_level_backward",
           f"{_SP}:302", [INT] * 4 + [P] * 13),
    Kernel("pcg_jacobi", "pcg", "pcg_jacobi", f"{_PCG}:57",
           [INT] * 3 + [P] * 5),
    Kernel("pcg_matvec", "pcg", "pcg_matvec", f"{_PCG}:87",
           [INT] * 3 + [P] * 9 + [DBL] + [P] * 5),
    Kernel("pcg_step", "pcg", "pcg_step", f"{_PCG}:130",
           [INT] * 4 + [P] * 10 + [DBL, DBL, INT, INT, INT] + [P] * 4),
    Kernel("pcg_loop", "pcg", "pcg_loop", f"{_PCG}:142",
           [INT] * 6 + [P] * 16 + [DBL, DBL, INT, INT, INT] + [P] * 3),
)

# the widest block (kMaxD in csrc/sp_level.cu and csrc/pcg.cu) and the most
# rows of a factor's whitened Jacobian (kMaxR in csrc/pcg.cu)
MAX_D = 12
MAX_R = 12
# kernel 16's phases (kInit ... in csrc/pcg.cu)
INIT, UPDATE, FINISH, DIRECTION = 0, 1, 2, 3
# pcg_loop's phase bits (kBitInit ... in csrc/pcg.cu): a group of phases,
# run in this order
G_INIT, G_MATVEC, G_UPDATE, G_FINISH, G_DIRECTION = 1, 2, 4, 8, 16
# the CG state: st (float64) gamma = r.z, p.Ap, r.r, tol^2 max(g.g, 1e-300),
# beta; ist (int32) done, the iteration count
GAMMA, PAP, RR, TOL2, BETA = 0, 1, 2, 3, 4
DONE, IT = 0, 1
ST_SIZE, IST_SIZE = 8, 4
# threads of a CTA of pcg_step, a variable each (kVarThreads), and the
# variables of a CTA of pcg_matvec, a warp each (kVarWarps)
VAR_THREADS = 128
VAR_WARPS = VAR_THREADS // 32


def _width(d, name):
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name}: block width {d} outside 1..{MAX_D}")
    return d


def _stopped(stop):
    """On the CPU: whether the done word is set (a plain version then does
    nothing, as its kernel returns at once)."""
    return stop is not None and bool(stop[DONE])


# -- kernel 13: a level of the factorization ---------------------------------


def _chol_(D):
    """In-place right-looking Cholesky of the batch D (m, d, d) (its lower
    triangle; the upper zeroed); returns the first bad pivot of each block
    (not finite or not positive), -1 where none, the order of the kernel's
    arithmetic."""
    m, d, _ = D.shape
    bad = torch.full((m,), -1, dtype=torch.long, device=D.device)
    for k in range(d):
        s = D[:, k, k].clone()
        new = (bad < 0) & ~((s > 0) & torch.isfinite(s))
        bad = torch.where(new, k, bad)
        piv = torch.sqrt(s)
        D[:, k, k] = piv
        D[:, k + 1:, k] /= piv[:, None]
        D[:, k + 1:, k + 1:] -= D[:, k + 1:, k, None] * D[:, None, k + 1:, k]
    return D.tril_(), bad


def _solve_rows(X, Lc):
    """X (m, d, d) <- X L^-T row by row (x L^T = a: forward substitution
    over the columns), Lc (m, d, d) each row block's L."""
    d = X.shape[-1]
    for c in range(d):
        X[:, :, c] /= Lc[:, None, c, c]
        X[:, :, c + 1:] -= X[:, :, c, None] * Lc[:, None, c + 1:, c]
    return X


def factor_level_plain(A, cols, cptr, cblk, tptr, tik, tjk, pad, lam, L,
                       rec):
    """One leading level of the factorization (its columns cols, their
    slices cptr, rec; the whole plan's cblk, tptr, tik, tjk), as a kernel
    13 launched a level at a time computes it: every block's triple sum,
    then the diagonal Cholesky and the subdiagonal solves."""
    d = pad.shape[1]
    J = cols.shape[0]
    e0, e1 = int(cptr[0]), int(cptr[J])
    blk = cblk[e0:e1].long()
    t0, t1 = int(tptr[e0]), int(tptr[e1])
    Lv = L.view(-1, d, d)
    prods = torch.bmm(Lv[tik[t0:t1].long()], Lv[tjk[t0:t1].long()].mT)
    own = segment_owner(tptr[e0:e1 + 1] - t0)
    acc = torch.zeros((e1 - e0, d, d), dtype=F64, device=A.device
                      ).index_add_(0, own, prods)
    val = A.view(-1, d, d)[blk].clone()
    first = (cptr[:J] - e0).long()
    val[first] += torch.diag_embed(lam * (1.0 - pad[cols.long()]))
    val -= acc
    D, bad = _chol_(val[first].clone())
    rec.copy_(torch.where(bad >= 0, cols, -1))
    col_of = segment_owner(cptr - e0)
    sub = torch.ones(e1 - e0, dtype=torch.bool, device=A.device)
    sub[first] = False
    X = _solve_rows(val[sub], D[col_of[sub]])
    Lv[blk[first]] = D
    Lv[blk[sub]] = X
    return L, rec


def sp_level_factor_plain(A, cols, cptr, cblk, tptr, tik, tjk, lptr, wptr,
                          wsrc, pad, lam, L, rec, flags, epoch):
    for j0, j1 in _levels(lptr):
        factor_level_plain(A, cols[j0:j1], cptr[j0:j1 + 1], cblk, tptr, tik,
                           tjk, pad, lam, L, rec[j0:j1])
    return L, rec


def sp_level_factor(A, cols, cptr, cblk, tptr, tik, tjk, lptr, wptr, wsrc,
                    pad, lam, L, rec, flags, epoch):
    """Kernel 13, every leading level of the factorization at once: the
    jobs q (column j = cols[q], J of them) in order, level by level (lptr:
    the levels' first jobs and the end; every source of a job in an
    earlier level).  Job q's blocks cblk[cptr[q]:cptr[q+1]] (the diagonal
    first) each become A_b (+ lam on the true dimensions of the diagonal:
    lam (1 - pad[j])) less the sum of L_ik L_jk^T over the block's triples
    tik/tjk[tptr[e]:tptr[e+1]] (in that order), read from the output store
    L of the earlier levels; then the diagonal block's Cholesky L_jj and
    the subdiagonal blocks' L_ij = A_ij L_jj^-T are written into L (B,
    d*d).  rec (J,) gets j where L_jj met a pivot that is not finite and
    positive, else -1.  A (B, d*d) is not written.  wptr, wsrc: the
    columns each job waits on (SparseCholeskySolver._factor_jobs).  flags
    (one int32 a column) and epoch (a new number every factorization,
    never 0): on the card each column's flag is set to epoch once its
    blocks are written, and a job reads a column once its flag holds it;
    the plain version (the level loop of factor_level_plain) ignores
    wptr, wsrc, flags and epoch.  On the card one cooperative launch, a
    CTA a job: the products of a round of its triples a thread an entry,
    from source blocks staged in shared memory, each block's products
    summed in triple order."""
    args = (A, cols, cptr, cblk, tptr, tik, tjk, lptr, wptr, wsrc, pad)
    if on_cpu(*args, L, rec, flags):
        return sp_level_factor_plain(*args, lam, L, rec, flags, epoch)
    B, dd = A.shape
    n, d = pad.shape
    J = cols.shape[0]
    dev = check("sp_level_factor", ("A", A, F64, (B, dd)),
                ("cols", cols, I32, (J,)), ("cptr", cptr, I32, (J + 1,)),
                ("cblk", cblk, I32, tuple(cblk.shape)),
                ("tptr", tptr, I32, (cblk.shape[0] + 1,)),
                ("tik", tik, I32, tuple(tik.shape)),
                ("tjk", tjk, I32, tik.shape),
                ("lptr", lptr, I32, (lptr.shape[0],)),
                ("wptr", wptr, I32, (J + 1,)),
                ("wsrc", wsrc, I32, tuple(wsrc.shape)),
                ("pad", pad, F64, (n, d)), ("L", L, F64, (B, d * d)),
                ("rec", rec, I32, (J,)), ("flags", flags, I32, (n,)))
    _width(d, "sp_level_factor")
    if dd != d * d or not 0 < epoch < 2 ** 31 or L.data_ptr() % 16:
        raise ValueError(f"sp_level_factor: A must have shape "
                         f"{(B, d * d)}, epoch in 1..2^31-1, L 16-byte "
                         "aligned")
    KERNELS["sp_level_factor"].launch(
        dev, J, d, n, int(epoch),
        *map(ptr, (cols, cptr, cblk, tptr, tik, tjk, wptr, wsrc, A, pad)),
        float(lam), ptr(L), ptr(rec), ptr(flags))
    return L, rec


def sp_tail_assemble_plain(A, L, tmap, tbid, tpos, lptr, lik, ljk, tcols,
                           pad, lam, M):
    d = pad.shape[1]
    T = tcols.shape[0]
    Lv = L.view(-1, d, d)
    prods = torch.bmm(Lv[lik.long()], Lv[ljk.long()].mT)
    acc = torch.zeros((tbid.shape[0], d, d), dtype=F64, device=A.device
                      ).index_add_(0, segment_owner(lptr), prods)
    val = A.view(-1, d, d)[tbid.long()].clone()
    e = tmap.view(T, T).long()
    r, c = torch.nonzero(e >= 0, as_tuple=True)
    diag = r == c
    val[e[r[diag], c[diag]]] += torch.diag_embed(
        lam * (1.0 - pad[tcols.long()[r[diag]]]))
    val -= acc
    full = torch.zeros((T, T, d, d), dtype=F64, device=A.device)
    full[r, c] = val[e[r, c]]
    strict = r != c
    full[c[strict], r[strict]] = val[e[r[strict], c[strict]]].mT
    M.copy_(full.permute(0, 2, 1, 3).reshape(T * d, T * d))
    return M


def sp_tail_assemble(A, L, tmap, tbid, tpos, lptr, lik, ljk, tcols, pad, lam,
                     M):
    """Kernel 13, the dense root: for every stored block of the tail
    (tbid[e] at tail block position (r, c), r >= c, tmap[r*T + c] = e, else
    -1; tpos[e] = r*T + c), A_b (+ lam (1 - pad) on its true diagonal when
    r == c) less the sum of L_ik L_jk^T over its late triples
    lik/ljk[lptr[e]:lptr[e+1]] (the leading columns' L, in L), written into
    M (T*d x T*d, rows contiguous at any stride) at block (r, c) and,
    transposed, at (c, r); M's other blocks are zeroed.  tcols (T,): the
    tail's columns.  On the card one launch: a warp a stored block, its
    triples' L blocks staged in shared memory a trip at a time, the block
    and its transpose stored a lane an entry along M's rows; the last CTAs
    zero the rest."""
    args = (A, L, tmap, tbid, tpos, lptr, lik, ljk, tcols, pad)
    if on_cpu(*args, M):
        return sp_tail_assemble_plain(*args, lam, M)
    B, dd = A.shape
    n, d = pad.shape
    T = tcols.shape[0]
    nb = tbid.shape[0]
    dev = check("sp_tail_assemble", ("A", A, F64, (B, dd)),
                ("L", L, F64, (B, dd)), ("tmap", tmap, I32, (T * T,)),
                ("tbid", tbid, I32, (nb,)), ("tpos", tpos, I32, (nb,)),
                ("lptr", lptr, I32, (nb + 1,)),
                ("lik", lik, I32, tuple(lik.shape)),
                ("ljk", ljk, I32, tuple(lik.shape)),
                ("tcols", tcols, I32, (T,)), ("pad", pad, F64, (n, d)),
                ("M", M, F64, (T * d, T * d), ROWS))
    _width(d, "sp_tail_assemble")
    if dd != d * d:
        raise ValueError(f"sp_tail_assemble: A must have shape "
                         f"{(B, d * d)}")
    KERNELS["sp_tail_assemble"].launch(
        dev, T, d, M.stride(0), nb,
        *map(ptr, (tmap, tbid, tpos, lptr, lik, ljk, tcols, A, L, pad)),
        float(lam), ptr(M))
    return M


# -- kernel 14: the forward and backward substitution -----------------------


def _forward_rows(acc, Ld):
    """acc (m, d) <- L^-1 acc for each row's lower-triangular L (m, d, d),
    column after column, as the kernel's lanes do."""
    d = acc.shape[1]
    for k in range(d):
        acc[:, k] /= Ld[:, k, k]
        acc[:, k + 1:] -= Ld[:, k + 1:, k] * acc[:, k, None]
    return acc


def _backward_rows(acc, Ld):
    """acc (m, d) <- L^-T acc, from the last component to the first."""
    d = acc.shape[1]
    for k in reversed(range(d)):
        acc[:, k] /= Ld[:, k, k]
        acc[:, :k] -= Ld[:, k, :k] * acc[:, k, None]
    return acc


def _gather_rhs(rhs, rhs_map, cols, d):
    if rhs_map is None:
        return rhs.view(-1, d)[cols.long()]
    idx = rhs_map.view(-1, d)[cols.long()].long()
    return torch.where(idx >= 0, rhs[idx.clamp(min=0)], 0.0)


def _levels(lptr):
    """The (first, past-last) job of each level of a level-pointer array."""
    p = lptr.tolist()
    return list(zip(p[:-1], p[1:]))


def _forward_level(L, rhs, rhs_map, Y, cols, orow, dbid, fptr, fbid, fsrc,
                   out, diag):
    """One level of the forward substitution (its jobs' slices; every
    source in an earlier level)."""
    d = Y.shape[1]
    J = cols.shape[0]
    f0, f1 = int(fptr[0]), int(fptr[J])
    Lv = L.view(-1, d, d)
    contrib = torch.einsum("bij,bj->bi", Lv[fbid[f0:f1].long()],
                           Y[fsrc[f0:f1].long()])
    acc = _gather_rhs(rhs, rhs_map, cols, d) - torch.zeros(
        (J, d), dtype=F64, device=L.device).index_add_(
            0, segment_owner(fptr - f0), contrib)
    if diag:
        acc = _forward_rows(acc, Lv[dbid.long()])
    out[orow.long()] = acc
    return out


def sp_level_forward_plain(L, rhs, rhs_map, Y, rt, cols, orow, dbid, fptr,
                           fbid, fsrc, lptr, ndiag, flags, epoch, stop=None):
    if _stopped(stop):
        return Y, rt
    for j0, j1 in _levels(lptr):
        diag = j1 <= ndiag
        _forward_level(L, rhs, rhs_map, Y, cols[j0:j1], orow[j0:j1],
                       dbid[j0:j1], fptr[j0:j1 + 1], fbid, fsrc,
                       Y if diag else rt, diag)
    return Y, rt


def sp_level_forward(L, rhs, rhs_map, Y, rt, cols, orow, dbid, fptr, fbid,
                     fsrc, lptr, ndiag, flags, epoch, stop=None):
    """Kernel 14, forward, every level at once: the jobs q (column j =
    cols[q]) in order, level by level (lptr: the levels' first jobs and the
    end; each job's sources in earlier levels): acc = the rhs at j
    (rhs[rhs_map[j*d + c]], 0 where the map is -1; rhs[j*d + c] with
    rhs_map None, rhs then the padded (n, d) g flat) less the sum of L_b y_k
    over the job's blocks fbid/fsrc[fptr[q]:fptr[q+1]] (y_k: row k of Y);
    the first ndiag jobs (whole levels: the leading ones) write y = L_jj^-1
    acc (L_jj: block dbid[q]) to Y[orow[q]], the rest (the dense root's
    right-hand side) acc to rt[orow[q]].  flags (one int32 a row of Y) and
    epoch (a new number every solve, never 0): on the card each row's flag
    is set to epoch once the row is written, and a job reads a row once its
    flag holds it; the plain version ignores both.  stop: the done word of
    a CG loop (the launch returns at once where it is set) or None.  On the
    card one launch, a warp a job."""
    args = (L, rhs, rhs_map, Y, rt, cols, orow, dbid, fptr, fbid, fsrc,
            lptr)
    extra = tuple(t for t in (rhs_map, stop) if t is not None)
    if on_cpu(L, rhs, Y, rt, cols, orow, dbid, fptr, fbid, fsrc, lptr, flags,
              *extra):
        return sp_level_forward_plain(*args, ndiag, flags, epoch, stop)
    B, dd = L.shape
    nY, d = Y.shape
    J = cols.shape[0]
    nf = fbid.shape[0]
    # without a map, rhs is the padded g: a row of d for each row of Y
    nrhs = tuple(rhs.shape) if rhs_map is not None else (nY * d,)
    specs = [("L", L, F64, (B, dd)), ("rhs", rhs, F64, nrhs),
             ("Y", Y, F64, (nY, d)), ("rt", rt, F64, (rt.shape[0], d)),
             ("cols", cols, I32, (J,)), ("orow", orow, I32, (J,)),
             ("dbid", dbid, I32, (J,)), ("fptr", fptr, I32, (J + 1,)),
             ("fbid", fbid, I32, (nf,)), ("fsrc", fsrc, I32, (nf,)),
             ("lptr", lptr, I32, (lptr.shape[0],)),
             ("flags", flags, I32, (nY,))]
    if rhs.dim() != 1 or (rhs_map is not None and (
            rhs_map.dim() != 1 or rhs_map.shape[0] % d)):
        raise ValueError("sp_level_forward: rhs and rhs_map must be vectors, "
                         "rhs_map of rows of d")
    if rhs_map is not None:
        specs.append(("rhs_map", rhs_map, I32, tuple(rhs_map.shape)))
    if stop is not None:
        specs.append(("stop", stop, I32, (stop.shape[0],)))
    dev = check("sp_level_forward", *specs)
    _width(d, "sp_level_forward")
    if dd != d * d or not 0 <= ndiag <= J or not 0 < epoch < 2 ** 31:
        raise ValueError(f"sp_level_forward: L must be (B, d*d), ndiag in "
                         f"0..{J}, epoch in 1..2^31-1")
    KERNELS["sp_level_forward"].launch(
        dev, J, int(ndiag), d, nY, int(epoch),
        *map(ptr, (cols, orow, dbid, fptr, fbid, fsrc, L, rhs)),
        ptr(rhs_map) if rhs_map is not None else 0, ptr(Y), ptr(rt),
        ptr(flags), ptr(stop) if stop is not None else 0)
    return Y, rt


def _backward_level(L, Y, U, out_map, cols, xrow, dbid, bptr, bbid, bsrc,
                    delta):
    """One level of the backward substitution (its jobs' slices; every
    source in an earlier level of the backward order, or the dense
    root's)."""
    d = Y.shape[1]
    J = cols.shape[0]
    b0, b1 = int(bptr[0]), int(bptr[J])
    Lv = L.view(-1, d, d)
    real = dbid >= 0
    contrib = torch.einsum("bij,bi->bj", Lv[bbid[b0:b1].long()],
                           U[bsrc[b0:b1].long()])
    acc = Y[cols.long()] - torch.zeros(
        (J, d), dtype=F64, device=L.device).index_add_(
            0, segment_owner(bptr - b0), contrib)
    x = _backward_rows(acc[real], Lv[dbid[real].long()])
    U[xrow[real].long()] = x
    vals = U[xrow.long()]
    idx = out_map.view(-1, d)[cols.long()].long()
    keep = idx >= 0
    delta[idx[keep]] = vals[keep]
    return U, delta


def sp_level_backward_plain(L, Y, U, out_map, cols, xrow, dbid, bptr, bbid,
                            bsrc, lptr, delta, flags, epoch, stop=None):
    if _stopped(stop):
        return U, delta
    for j0, j1 in _levels(lptr):
        _backward_level(L, Y, U, out_map, cols[j0:j1], xrow[j0:j1],
                        dbid[j0:j1], bptr[j0:j1 + 1], bbid, bsrc, delta)
    return U, delta


def sp_level_backward(L, Y, U, out_map, cols, xrow, dbid, bptr, bbid, bsrc,
                      lptr, delta, flags, epoch, stop=None):
    """Kernel 14, backward, every level at once: the jobs q (column j =
    cols[q]) in order, level by level (lptr as sp_level_forward's; the
    levels in reverse), each with a diagonal block (dbid[q] >= 0): x_j =
    L_jj^-T (y_j - the sum of L_b^T x_i over the job's blocks
    bbid/bsrc[bptr[q]:bptr[q+1]], x_i: row bsrc of U), written to U[xrow[q]]
    (a row below flags' length, as every source row that a job of this
    launch writes); a job with dbid -1 (a dense-root column, solved by
    kernel 11 into a row of U at or past flags' length) only copies.  Every
    job's x also goes to delta[out_map[j*d + c]] (the flat tangent layout;
    -1: a padded component).  flags, epoch, stop: as sp_level_forward's.
    On the card one launch, a warp a job."""
    args = (L, Y, U, out_map, cols, xrow, dbid, bptr, bbid, bsrc, lptr,
            delta)
    extra = (stop,) if stop is not None else ()
    if on_cpu(*args, flags, *extra):
        return sp_level_backward_plain(*args, flags, epoch, stop)
    B, dd = L.shape
    nY, d = Y.shape
    J = cols.shape[0]
    nb = bbid.shape[0]
    nflag = flags.shape[0]
    specs = [("L", L, F64, (B, dd)), ("Y", Y, F64, (nY, d)),
             ("U", U, F64, (U.shape[0], d)),
             ("out_map", out_map, I32, tuple(out_map.shape)),
             ("cols", cols, I32, (J,)), ("xrow", xrow, I32, (J,)),
             ("dbid", dbid, I32, (J,)), ("bptr", bptr, I32, (J + 1,)),
             ("bbid", bbid, I32, (nb,)), ("bsrc", bsrc, I32, (nb,)),
             ("lptr", lptr, I32, (lptr.shape[0],)),
             ("delta", delta, F64, tuple(delta.shape)),
             ("flags", flags, I32, (nflag,))]
    if stop is not None:
        specs.append(("stop", stop, I32, (stop.shape[0],)))
    dev = check("sp_level_backward", *specs)
    _width(d, "sp_level_backward")
    if dd != d * d or out_map.dim() != 1 or delta.dim() != 1 or \
            nflag > U.shape[0] or not 0 < epoch < 2 ** 31:
        raise ValueError("sp_level_backward: L must be (B, d*d), out_map and "
                         "delta vectors, flags no longer than U, epoch in "
                         "1..2^31-1")
    KERNELS["sp_level_backward"].launch(
        dev, J, d, nflag, int(epoch),
        *map(ptr, (cols, xrow, dbid, bptr, bbid, bsrc, L, Y, U, out_map,
                   delta, flags)),
        ptr(stop) if stop is not None else 0)
    return U, delta


# -- kernel 15: the block-Jacobi diagonal and the matrix-free matvec --------


def _slot_vec(v, var_off, var_dim, slot_var, dmax):
    """Each slot's variable's entries of the flat vector v, (Q, dmax), zero
    past its dimension."""
    k = torch.arange(dmax, device=v.device)
    sv = slot_var.long()
    idx = var_off.long()[sv, None] + k
    valid = k < var_dim.long()[sv, None]
    return torch.where(valid, v[torch.where(valid, idx, 0)], 0.0)


def pcg_jacobi_plain(pool, vptr, vslot, var_dim, diag):
    nv, dmax, _ = diag.shape
    A = pool[vslot.long()]
    AtA = torch.einsum("qri,qrj->qij", A, A)
    diag.zero_().index_add_(0, segment_owner(vptr), AtA)
    k = torch.arange(dmax, device=pool.device)
    pad = (k >= var_dim.long()[:, None]).to(F64)
    diag += torch.diag_embed(pad)
    return diag


def pcg_jacobi(pool, vptr, vslot, var_dim, diag):
    """Kernel 15, the block-Jacobi diagonal: diag[v] (nv, dmax, dmax) = the
    sum of A_q^T A_q over v's slots vslot[vptr[v]:vptr[v+1]] (A_q: the slot's
    whitened rows, pool (Q, rmax, dmax), zero past its rows and columns),
    plus the identity on the padded dimensions (past var_dim[v]).  On the
    card one launch, a thread an entry."""
    args = (pool, vptr, vslot, var_dim, diag)
    if on_cpu(*args):
        return pcg_jacobi_plain(*args)
    Q, rmax, dmax = pool.shape
    nv = var_dim.shape[0]
    dev = check("pcg_jacobi", ("pool", pool, F64, (Q, rmax, dmax)),
                ("vptr", vptr, I32, (nv + 1,)),
                ("vslot", vslot, I32, tuple(vslot.shape)),
                ("var_dim", var_dim, I32, (nv,)),
                ("diag", diag, F64, (nv, dmax, dmax)))
    if dmax > MAX_D or rmax > MAX_R:
        raise ValueError(f"pcg_jacobi: rows of {rmax} x {dmax} exceed "
                         f"{MAX_R} x {MAX_D}")
    KERNELS["pcg_jacobi"].launch(dev, nv, dmax, rmax,
                                 *map(ptr, (vptr, vslot, var_dim, pool,
                                            diag)))
    return diag


def pcg_matvec_plain(pool, p, vptr, vslot, slot_fac, fptr, slot_var,
                     var_off, var_dim, lam, Ap, st, ist):
    if _stopped(ist):
        return Ap
    Q, rmax, dmax = pool.shape
    nv = var_dim.shape[0]
    ps = _slot_vec(p, var_off, var_dim, slot_var, dmax)
    us = torch.einsum("qrd,qd->qr", pool, ps)
    u = torch.zeros((fptr.shape[0] - 1, rmax), dtype=F64, device=p.device
                    ).index_add_(0, segment_owner(fptr), us)
    w = torch.einsum("qrd,qr->qd", pool, u[slot_fac.long()])
    acc = torch.zeros((nv, dmax), dtype=F64, device=p.device).index_add_(
        0, segment_owner(vptr), w[vslot.long()])
    k = torch.arange(dmax, device=p.device)
    valid = k < var_dim.long()[:, None]
    idx = var_off.long()[:, None] + k
    Ap[idx[valid]] = lam * p[idx[valid]] + acc[valid]
    st[PAP] = torch.dot(p, Ap)
    return Ap


def pcg_matvec(pool, p, vptr, vslot, slot_fac, fptr, slot_var, var_off,
               var_dim, lam, Ap, st, ist):
    """Kernel 15, the matvec: Ap = (J^T J + lam) p over the whitened rows
    pool (Q, rmax, dmax; the slots of factor f: fptr[f]:fptr[f+1], slot q's
    variable slot_var[q] at var_off with var_dim entries in the flat
    vectors): for each variable v, lam p_v plus the sum over its slots
    vslot[vptr[v]:vptr[v+1]] of A_q^T u_f, u_f = the sum of A_s p over f's
    slots, f = slot_fac[q]; and st[PAP] = p.Ap.  Returns at once where
    ist[DONE] is set.  On the card one launch, a warp a variable, the
    partial dot products summed in CTA order by the last CTA."""
    args = (pool, p, vptr, vslot, slot_fac, fptr, slot_var, var_off,
            var_dim)
    if on_cpu(*args, Ap, st, ist):
        return pcg_matvec_plain(*args, lam, Ap, st, ist)
    Q, rmax, dmax = pool.shape
    D = p.shape[0]
    nv = var_dim.shape[0]
    dev = check("pcg_matvec", ("pool", pool, F64, (Q, rmax, dmax)),
                ("p", p, F64, (D,)), ("vptr", vptr, I32, (nv + 1,)),
                ("vslot", vslot, I32, (Q,)), ("slot_fac", slot_fac, I32, (Q,)),
                ("fptr", fptr, I32, tuple(fptr.shape)),
                ("slot_var", slot_var, I32, (Q,)),
                ("var_off", var_off, I32, (nv,)),
                ("var_dim", var_dim, I32, (nv,)), ("Ap", Ap, F64, (D,)),
                ("st", st, F64, (ST_SIZE,)), ("ist", ist, I32, (IST_SIZE,)))
    if dmax > MAX_D or rmax > MAX_R:
        raise ValueError(f"pcg_matvec: rows of {rmax} x {dmax} exceed "
                         f"{MAX_R} x {MAX_D}")
    ctas = max(1, -(-nv // VAR_WARPS))
    ticket, part = _kernels.sum_scratch(dev, ctas)
    KERNELS["pcg_matvec"].launch(
        dev, nv, dmax, rmax,
        *map(ptr, (vptr, vslot, slot_fac, fptr, slot_var, var_off, var_dim,
                   pool, p)), float(lam),
        *map(ptr, (Ap, part, ticket, st, ist)))
    return Ap


# -- kernel 16: the steps of the CG iteration --------------------------------


def _var_index(var_off, var_dim, dmax):
    k = torch.arange(dmax, device=var_off.device)
    valid = k < var_dim.long()[:, None]
    idx = torch.where(valid, var_off.long()[:, None] + k, 0)
    return idx, valid


def _apply_minv(Minv, r, idx, valid):
    rb = torch.where(valid, r[idx], 0.0)
    z = torch.zeros_like(r)
    z[idx[valid]] = torch.einsum("nij,nj->ni", Minv, rb)[valid]
    return z


def pcg_step_plain(phase, diag, Minv, g, x, r, z, p, Ap, var_off, var_dim,
                   lam, tol, max_it, jacobi, first, st, ist):
    dmax = diag.shape[1]
    idx, valid = _var_index(var_off, var_dim, dmax)
    if phase == INIT:
        if jacobi:
            eye = torch.eye(dmax, dtype=F64, device=g.device)
            # the true dimensions' block alone, as the kernel inverts it
            pad = ~(valid[:, :, None] & valid[:, None, :])
            Minv.copy_(torch.linalg.inv(torch.where(pad, eye, diag + lam
                                                    * eye)))
            Minv.masked_fill_(pad, 0.0)
        x.zero_()
        r.copy_(g)
        rr = torch.dot(r, r)
        if jacobi:
            z.copy_(_apply_minv(Minv, r, idx, valid))
            p.copy_(z)
            st[GAMMA] = torch.dot(r, z)
        else:
            p.zero_()
        st[RR] = rr
        st[TOL2] = tol * tol * torch.clamp(rr, min=1e-300)
        st[BETA] = 0.0
        ist[IT] = 0
        ist[DONE] = int(not bool(rr > st[TOL2]) or max_it <= 0)
        return
    if bool(ist[DONE]):
        return
    if phase == UPDATE:
        alpha = st[GAMMA] / torch.clamp(st[PAP], min=1e-300)
        x += alpha * p
        r -= alpha * Ap
        if jacobi:
            z.copy_(_apply_minv(Minv, r, idx, valid))
            rz = torch.dot(r, z)
            st[BETA] = rz / torch.clamp(st[GAMMA], min=1e-300)
            st[GAMMA] = rz
        st[RR] = torch.dot(r, r)
        ist[IT] += 1
        ist[DONE] = int(not bool(st[RR] > st[TOL2]) or int(ist[IT]) >= max_it)
    elif phase == FINISH:
        rz = torch.dot(r, z)
        st[BETA] = 0.0 if first else rz / torch.clamp(st[GAMMA], min=1e-300)
        st[GAMMA] = rz
    else:
        p.mul_(st[BETA]).add_(z)


def pcg_step(phase, diag, Minv, g, x, r, z, p, Ap, var_off, var_dim, lam,
             tol, max_it, jacobi, first, st, ist):
    """Kernel 16, a step of the CG loop of linear/pcg.py (flat vectors of D
    entries; nv variables at var_off, var_dim; the state st, ist):
      INIT:      Minv = (diag + lam I)^-1 on each variable's true block
                 (jacobi), x = 0, r = g, z = Minv r and p = z (jacobi; else
                 p = 0), gamma = r.z, r.r, tol2 = tol^2 max(r.r, 1e-300),
                 beta = 0, it = 0, done = not r.r > tol2 or max_it <= 0;
      UPDATE:    alpha = gamma / max(p.Ap, 1e-300), x += alpha p,
                 r -= alpha Ap, (jacobi) z = Minv r, beta = r.z /
                 max(gamma, 1e-300), gamma = r.z; it += 1, done = not
                 r.r > tol2 or it >= max_it;
      FINISH:    (a preconditioner outside, z given) beta = r.z /
                 max(gamma, 1e-300) (0 where `first`), gamma = r.z;
      DIRECTION: p = z + beta p.
    Every phase but INIT returns at once where ist[DONE] is set.  On the
    card one launch, a thread a variable (DIRECTION: an entry), the dot
    products' partials summed in CTA order by the last CTA."""
    args = (diag, Minv, g, x, r, z, p, Ap, var_off, var_dim, st, ist)
    if on_cpu(*args):
        return pcg_step_plain(phase, *args[:10], lam, tol, max_it, jacobi,
                              first, st, ist)
    nv, dmax, _ = diag.shape
    D = g.shape[0]
    vec = [(name, t, F64, (D,)) for name, t in
           (("g", g), ("x", x), ("r", r), ("z", z), ("p", p), ("Ap", Ap))]
    dev = check("pcg_step", ("diag", diag, F64, (nv, dmax, dmax)),
                ("Minv", Minv, F64, (nv, dmax, dmax)), *vec,
                ("var_off", var_off, I32, (nv,)),
                ("var_dim", var_dim, I32, (nv,)),
                ("st", st, F64, (ST_SIZE,)), ("ist", ist, I32, (IST_SIZE,)))
    if dmax > MAX_D or phase not in (INIT, UPDATE, FINISH, DIRECTION):
        raise ValueError(f"pcg_step: phase {phase}, block width {dmax}")
    ctas = max(1, -(-nv // VAR_THREADS))
    ticket, part = _kernels.sum_scratch(dev, 2 * ctas)
    KERNELS["pcg_step"].launch(
        dev, int(phase), nv, dmax, D,
        *map(ptr, (var_off, var_dim, diag, Minv, g, x, r, z, p, Ap)),
        float(lam), float(tol), int(max_it), int(bool(jacobi)),
        int(bool(first)), *map(ptr, (part, ticket, st, ist)))


def pcg_loop_plain(groups, loop, pool, diag, Minv, g, x, r, z, p, Ap, vptr,
                   vslot, slot_fac, fptr, slot_var, var_off, var_dim, lam,
                   tol, max_it, jacobi, first, st, ist):
    _loop_groups(groups, loop)
    mv = (vptr, vslot, slot_fac, fptr, slot_var, var_off, var_dim)

    def step(phase):
        pcg_step_plain(phase, diag, Minv, g, x, r, z, p, Ap, var_off, var_dim,
                       lam, tol, max_it, jacobi, first, st, ist)

    if groups & G_INIT:
        step(INIT)
    while not _stopped(ist):
        if groups & G_MATVEC:
            pcg_matvec_plain(pool, p, *mv, lam, Ap, st, ist)
        for bit, phase in ((G_UPDATE, UPDATE), (G_FINISH, FINISH),
                           (G_DIRECTION, DIRECTION)):
            if groups & bit:
                step(phase)
        if not loop:
            break


def _loop_groups(groups, loop):
    if not 0 < groups < 32 or (loop and not groups & G_UPDATE):
        raise ValueError(f"pcg_loop: phase bits {groups}; a loop needs "
                         "UPDATE")


def pcg_loop(groups, loop, pool, diag, Minv, g, x, r, z, p, Ap, vptr, vslot,
             slot_fac, fptr, slot_var, var_off, var_dim, lam, tol, max_it,
             jacobi, first, st, ist):
    """Kernel 16's loop: the phases of `groups` (G_INIT, G_MATVEC, G_UPDATE,
    G_FINISH, G_DIRECTION bits), in that order, each as pcg_step's phase
    (G_MATVEC: pcg_matvec's Ap = (J^T J + lam) p and p.Ap over the pool and
    its plan); with `loop`, all but INIT again and again until ist[DONE] is
    set (a block-Jacobi solve: INIT | MATVEC | UPDATE | DIRECTION).  Like
    the phases, the group returns at once where ist[DONE] is set (INIT
    aside), and a phase after UPDATE returns where UPDATE set it.  On the
    card one cooperative launch, its CTAs taking the phases' chunks (the
    matvec's 4 variables, the steps' 128) grid-stride, a grid sync after
    each phase; the chunks' partial dot products summed in chunk order by
    every CTA, so the group gives the bits of its phases' launches."""
    args = (pool, diag, Minv, g, x, r, z, p, Ap, vptr, vslot, slot_fac, fptr,
            slot_var, var_off, var_dim)
    if on_cpu(*args, st, ist):
        return pcg_loop_plain(groups, loop, *args, lam, tol, max_it, jacobi,
                              first, st, ist)
    _loop_groups(groups, loop)
    Q, rmax, dmax = pool.shape
    nv = var_dim.shape[0]
    D = g.shape[0]
    vec = [(name, t, F64, (D,)) for name, t in
           (("g", g), ("x", x), ("r", r), ("z", z), ("p", p), ("Ap", Ap))]
    dev = check("pcg_loop", ("pool", pool, F64, (Q, rmax, dmax)),
                ("diag", diag, F64, (nv, dmax, dmax)),
                ("Minv", Minv, F64, (nv, dmax, dmax)), *vec,
                ("vptr", vptr, I32, (nv + 1,)), ("vslot", vslot, I32, (Q,)),
                ("slot_fac", slot_fac, I32, (Q,)),
                ("fptr", fptr, I32, tuple(fptr.shape)),
                ("slot_var", slot_var, I32, (Q,)),
                ("var_off", var_off, I32, (nv,)),
                ("var_dim", var_dim, I32, (nv,)),
                ("st", st, F64, (ST_SIZE,)), ("ist", ist, I32, (IST_SIZE,)))
    if dmax > MAX_D or rmax > MAX_R:
        raise ValueError(f"pcg_loop: rows of {rmax} x {dmax} exceed "
                         f"{MAX_R} x {MAX_D}")
    _, part = _kernels.sum_scratch(
        dev, max(1, -(-nv // VAR_WARPS)) + 2 * max(1, -(-nv // VAR_THREADS)))
    KERNELS["pcg_loop"].launch(
        dev, int(groups), int(bool(loop)), nv, dmax, rmax, D,
        *map(ptr, (vptr, vslot, slot_fac, fptr, slot_var, var_off, var_dim,
                   pool, diag, Minv, g, x, r, z, p, Ap)),
        float(lam), float(tol), int(max_it), int(bool(jacobi)),
        int(bool(first)), *map(ptr, (part, st, ist)))
