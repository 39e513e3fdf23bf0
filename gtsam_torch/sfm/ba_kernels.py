"""Wrappers of the hand-written CUDA kernels of Schur bundle adjustment.

Each wrapper takes tensors in the layout of gtsam_torch/sfm/ba.py (float64,
int32 indices, row-major and contiguous, but for S, whose rows may lie
further apart than its width (_kernels.row_strided); in the
mixed-precision mode the Jacobians A_cam, A_pt and the reduced camera
matrix S are float32, and the wrapper launches the float32 variant of its
kernel) and
  - on CPU tensors computes its plain PyTorch version (`*_plain`), which the
    CPU tests compare against the JAX package;
  - on CUDA tensors checks dtype, shape, contiguity and device, launches its
    kernel from gtsam_torch/csrc on the current stream and counts the launch.
It never falls back from the kernel to the plain version on a CUDA tensor:
what the kernel does not take raises.  The plain versions also run on CUDA
tensors when called directly, which is how the kernels are checked on the
card.
"""

import torch

from .. import _kernels
from .._kernels import DBL as _DBL, INT as _INT, P as _P, Kernel
from .._kernels import ROWS as _ROWS
from .._kernels import check as _check, on_cpu as _on_cpu, ptr as _ptr
from .._kernels import segment_owner as _segment_owner
from ..geometry.cameras import CHEIRALITY_EPS
from ..geometry.so3 import hat
from .bal import CHEIRALITY_PENALTY

F64 = torch.float64
F32 = torch.float32
I32 = torch.int32


# A kernel named "<name>_f32" is the float32 variant of "<name>": the same
# source and wrapper, float32 Jacobians (and S), float64 arithmetic.
KERNELS = _kernels.table(
    Kernel("bal_linearize", "bal_linearize", "linearize",
           "gtsam_tpu/sfm/bal.py:182", [_INT] + [_P] * 10),
    Kernel("bal_linearize_f32", "bal_linearize", "linearize",
           "gtsam_tpu/graph/factors.py:147", [_INT] + [_P] * 10),
    Kernel("bal_error", "bal_linearize", "error",
           "gtsam_tpu/sfm/ba.py:1338", [_INT] + [_P] * 10),
    Kernel("ba_point_eliminate", "ba_point_eliminate", "point_eliminate",
           "gtsam_tpu/sfm/ba.py:1086",
           [_INT, _P, _P, _P, _P, _P, _DBL, _INT, _P, _P, _P, _P, _P]),
    Kernel("ba_point_eliminate_f32", "ba_point_eliminate", "point_eliminate",
           "gtsam_tpu/sfm/ba.py:804",
           [_INT, _P, _P, _P, _P, _P, _DBL, _INT, _P, _P, _P, _P, _P]),
    Kernel("ba_camera_assemble", "ba_schur_assemble", "camera_assemble",
           "gtsam_tpu/sfm/ba.py:1103",
           [_INT, _INT] + [_P] * 11 + [_DBL, _INT, _P, _P, _P]),
    Kernel("ba_camera_assemble_f32", "ba_schur_assemble", "camera_assemble",
           "gtsam_tpu/sfm/ba.py:846",
           [_INT, _INT] + [_P] * 11 + [_DBL, _INT, _P, _P, _P, _P]),
    Kernel("ba_pair_assemble", "ba_schur_assemble", "pair_assemble",
           "gtsam_tpu/sfm/ba.py:1142", [_INT, _INT, _INT] + [_P] * 9),
    Kernel("ba_pair_assemble_f32", "ba_schur_assemble", "pair_assemble",
           "gtsam_tpu/sfm/ba.py:954", [_INT, _INT, _INT] + [_P] * 9),
    Kernel("ba_back_substitute", "ba_back_substitute", "back_substitute",
           "gtsam_tpu/sfm/ba.py:1264", [_INT] + [_P] * 8),
    Kernel("ba_schur_matvec", "ba_schur_matvec", "schur_matvec",
           "gtsam_tpu/sfm/ba.py:1239", [_INT, _INT] + [_P] * 12),
)


_SUFFIX = {F64: "", F32: "_f32"}


def _variant(name, arg, dtype):
    """The kernel of `name` for Jacobians (or S) of `dtype`, named after
    argument `arg`; raises for a dtype no variant takes."""
    if dtype not in _SUFFIX:
        raise TypeError(f"{name}: {arg} must be torch.float64 or "
                        f"torch.float32, got {dtype}")
    return name + _SUFFIX[dtype]


def _cells(S, M):
    """S (9M x 9M, rows possibly apart) as its (M, 9, M, 9) cells, a view."""
    return S.unflatten(0, (M, 9)).unflatten(2, (M, 9))


def _check_aligned(name, arg, t):
    """The kernels load t with 16-byte vectors."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {arg} must be 16-byte aligned")


# -- kernel 1: linearization and half-chi2 -----------------------------------


def _projection_plain(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv,
                      jacobians):
    oc, op = obs_cam.long(), obs_pt.long()
    R, cal = cam_R[oc], calib[oc]
    pc = torch.einsum("kji,kj->ki", R, points[op] - cam_t[oc])
    z = pc[:, 2]
    valid = z > CHEIRALITY_EPS
    zs = torch.where(valid, z, torch.ones_like(z))
    x, y = pc[:, 0] / zs, pc[:, 1] / zs
    f, k1, k2 = cal[:, 0], cal[:, 1], cal[:, 2]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    g = f * radial
    r = torch.stack([x * g, y * g], dim=1) - uv
    r = torch.where(valid[:, None], r, torch.full_like(r, CHEIRALITY_PENALTY))
    if not jacobians:
        return r
    dg = 2.0 * f * (k1 + 2.0 * k2 * r2)
    J00, J01, J11 = g + dg * x * x, dg * x * y, g + dg * y * y
    iz = 1.0 / zs
    m = torch.stack([
        torch.stack([J00 * iz, J01 * iz, -(J00 * x + J01 * y) * iz], dim=1),
        torch.stack([J01 * iz, J11 * iz, -(J01 * x + J11 * y) * iz], dim=1),
    ], dim=1)                                                  # d pixel / d p_c
    xy = torch.stack([x, y], dim=1)[:, :, None]
    A_cam = torch.cat([m @ hat(pc), -m,
                       torch.cat([radial[:, None, None] * xy,
                                  (f * r2)[:, None, None] * xy,
                                  (f * r2 * r2)[:, None, None] * xy], dim=2)],
                      dim=2)
    A_pt = m @ R.transpose(-1, -2)
    keep = valid[:, None, None]
    A_cam = torch.where(keep, A_cam, torch.zeros_like(A_cam))
    A_pt = torch.where(keep, A_pt, torch.zeros_like(A_pt))
    return A_cam, A_pt, -r


def linearize_plain(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv,
                    jac_dtype=F64):
    A_cam, A_pt, b = _projection_plain(cam_R, cam_t, calib, points, obs_cam,
                                       obs_pt, uv, True)
    return A_cam.to(jac_dtype), A_pt.to(jac_dtype), b


def error_plain(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv):
    r = _projection_plain(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv,
                          False)
    return 0.5 * torch.sum(r * r)


def _projection_specs(name, cam_R, cam_t, calib, points, obs_cam, obs_pt, uv):
    M, N, K = cam_R.shape[0], points.shape[0], obs_cam.shape[0]
    return _check(name, ("cam_R", cam_R, F64, (M, 3, 3)),
                  ("cam_t", cam_t, F64, (M, 3)), ("calib", calib, F64, (M, 3)),
                  ("points", points, F64, (N, 3)),
                  ("obs_cam", obs_cam, I32, (K,)),
                  ("obs_pt", obs_pt, I32, (K,)), ("uv", uv, F64, (K, 2)))


def linearize(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv,
              jac_dtype=F64):
    """Whitened (unit noise) BAL linearization, one row per observation:
    A_cam (K,2,9), A_pt (K,2,3) in jac_dtype and b = -r (K,2) in float64.
    jac_dtype float32 is the mixed-precision mode: the Jacobians are
    computed in float64 and rounded once."""
    args = (cam_R, cam_t, calib, points, obs_cam, obs_pt, uv)
    name = _variant("bal_linearize", "jac_dtype", jac_dtype)
    if _on_cpu(*args):
        return linearize_plain(*args, jac_dtype)
    dev = _projection_specs(name, *args)
    K = obs_cam.shape[0]
    A_cam = torch.empty((K, 2, 9), dtype=jac_dtype, device=dev)
    A_pt = torch.empty((K, 2, 3), dtype=jac_dtype, device=dev)
    b = torch.empty((K, 2), dtype=F64, device=dev)
    KERNELS[name].launch(dev, K, *map(_ptr, args), _ptr(A_cam), _ptr(A_pt),
                         _ptr(b))
    return A_cam, A_pt, b


# Rows per warp tile of bal_linearize_kernel and per block of
# bal_error_kernel (kTileRows and kErrorBlock in csrc/bal_linearize.cu).
LINEARIZE_TILE_ROWS = 32
ERROR_BLOCK = 1024

def error(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv):
    """Half-chi2 0.5 * sum r^2 (with the cheirality penalty), a 0-d tensor.
    On the card: one launch, summed in an order fixed by K alone."""
    args = (cam_R, cam_t, calib, points, obs_cam, obs_pt, uv)
    if _on_cpu(*args):
        return error_plain(*args)
    dev = _projection_specs("bal_error", *args)
    K = obs_cam.shape[0]
    ticket, part = _kernels.sum_scratch(dev, max(1, -(-K // ERROR_BLOCK)))
    out = torch.empty((), dtype=F64, device=dev)
    KERNELS["bal_error"].launch(dev, K, *map(_ptr, args), _ptr(part),
                                _ptr(ticket), _ptr(out))
    return out


# -- kernel 2: landmark elimination ------------------------------------------


def _inv3x3(H):
    """Batched adjugate inverse, the expression order of _inv3x3_flat."""
    a, b, c = H[:, 0, 0], H[:, 0, 1], H[:, 0, 2]
    d, e, f = H[:, 1, 0], H[:, 1, 1], H[:, 1, 2]
    g, h, i = H[:, 2, 0], H[:, 2, 1], H[:, 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, Hc, I = d * h - e * g, b * g - a * h, a * e - b * d
    inv_det = 1.0 / (a * A + b * D + c * G)
    return (torch.stack([A, B, C, D, E, F, G, Hc, I], dim=1)
            * inv_det[:, None]).reshape(-1, 3, 3)


# Rows per tile of ba_point_eliminate: the plan's pt_tile gives each tile the
# points whose first row falls in it.  A tile's rows (with its last point's
# overhang) and points are staged in shared memory when they fit the
# kernel's buffers (kTileRows, kTilePts in csrc/ba_point_eliminate.cu), so
# tracks of up to 33 rows always take that path; a larger tile takes the
# kernel's cooperative branch.
POINT_TILE_ROWS = 96
POINT_TILE_STAGED = 128


def point_eliminate_plain(pt_ptr, pt_tile, A_cam, A_pt, b, lam,
                          diagonal_damping):
    A_cam, A_pt = A_cam.to(F64), A_pt.to(F64)   # products of floats: exact
    N = pt_ptr.numel() - 1
    seg = _segment_owner(pt_ptr)
    has = (pt_ptr[1:] > pt_ptr[:-1])
    Hll = torch.zeros((N, 3, 3), dtype=F64, device=A_pt.device).index_add_(
        0, seg, torch.einsum("kri,krj->kij", A_pt, A_pt))
    gl = torch.zeros((N, 3), dtype=F64, device=A_pt.device).index_add_(
        0, seg, torch.einsum("kri,kr->ki", A_pt, b))
    if diagonal_damping:
        lam_eff = (Hll[:, 0, 0] + Hll[:, 1, 1] + Hll[:, 2, 2]) / 3.0 * lam
    else:
        lam_eff = torch.full((N,), lam, dtype=F64, device=A_pt.device)
    eye = torch.eye(3, dtype=F64, device=A_pt.device)
    C = _inv3x3(Hll + lam_eff[:, None, None] * eye)
    C = torch.where(has[:, None, None], C, torch.zeros_like(C))
    gl = torch.where(has[:, None], gl, torch.zeros_like(gl))
    Cg = torch.einsum("nij,nj->ni", C, gl)
    W = torch.einsum("kri,krl->kil", A_cam, A_pt)
    WC = W @ C[seg]
    corr = torch.einsum("kil,kl->ki", W, Cg[seg])
    return W, WC, corr, C, gl


def point_eliminate(pt_ptr, pt_tile, A_cam, A_pt, b, lam, diagonal_damping):
    """Per point: Hll, gl, C = (Hll + lam_eff I)^-1; per observation:
    W = A_cam^T A_pt, WC = W C, corr = W C gl.  pt_tile: the plan's row
    tiles (the kernel's blocks; the plain version does not need them).
    A_cam and A_pt are float64, or both float32 (then the products run in
    float64).  Returns W (K,9,3), WC (K,9,3), corr (K,9), C (N,3,3),
    gl (N,3), all float64."""
    args = (pt_ptr, pt_tile, A_cam, A_pt, b)
    if _on_cpu(*args):
        return point_eliminate_plain(*args, lam, diagonal_damping)
    N, K = pt_ptr.shape[0] - 1, A_cam.shape[0]
    T = max(1, -(-K // POINT_TILE_ROWS))
    name = _variant("ba_point_eliminate", "A_cam", A_cam.dtype)
    dev = _check(name, ("pt_ptr", pt_ptr, I32, (N + 1,)),
                 ("pt_tile", pt_tile, I32, (T + 1,)),
                 ("A_cam", A_cam, A_cam.dtype, (K, 2, 9)),
                 ("A_pt", A_pt, A_cam.dtype, (K, 2, 3)),
                 ("b", b, F64, (K, 2)))
    W = torch.empty((K, 9, 3), dtype=F64, device=dev)
    WC = torch.empty((K, 9, 3), dtype=F64, device=dev)
    corr = torch.empty((K, 9), dtype=F64, device=dev)
    C = torch.empty((N, 3, 3), dtype=F64, device=dev)
    gl = torch.empty((N, 3), dtype=F64, device=dev)
    KERNELS[name].launch(
        dev, T, *map(_ptr, args), float(lam), int(bool(diagonal_damping)),
        _ptr(W), _ptr(WC), _ptr(corr), _ptr(C), _ptr(gl))
    return W, WC, corr, C, gl


# -- kernel 3: the equilibrated reduced camera system --------------------------


def _pair_blocks(cell_ptr, cell_a, cell_b, WC, W, cells):
    """sum WC_a W_b^T over the pairs of each cell in `cells` (bool (U,)):
    (number of such cells, 9, 9), in cell order."""
    of = _segment_owner(cell_ptr)
    keep = cells[of]
    idx = torch.cumsum(cells.long(), 0) - 1
    prods = WC[cell_a[keep].long()] @ W[cell_b[keep].long()].transpose(-1, -2)
    return torch.zeros((int(cells.sum()), 9, 9), dtype=F64,
                       device=WC.device).index_add_(0, idx[of[keep]], prods)


def camera_assemble_plain(cam_ptr, cam_obs, A_cam, b, corr, cell_ptr,
                          diag_cell, cell_a, cell_b, WC, W, lam,
                          diagonal_damping, S):
    M = cam_ptr.numel() - 1
    dev = A_cam.device
    cam_of = _segment_owner(cam_ptr)
    k = cam_obs.long()
    Ac = A_cam[k].to(F64)
    Hpp = torch.zeros((M, 9, 9), dtype=F64, device=dev).index_add_(
        0, cam_of, torch.einsum("kri,krj->kij", Ac, Ac))
    gp = torch.zeros((M, 9), dtype=F64, device=dev).index_add_(
        0, cam_of, torch.einsum("kri,kr->ki", Ac, b[k]))
    cr = torch.zeros((M, 9), dtype=F64, device=dev).index_add_(
        0, cam_of, corr[k])
    d = Hpp.diagonal(dim1=1, dim2=2)
    if diagonal_damping:
        d.mul_(1.0 + lam)
    else:
        d.add_(lam)
    Hpp_d = Hpp.clone() if A_cam.dtype == F32 else None
    has = diag_cell >= 0
    cells = torch.zeros(cell_ptr.numel() - 1, dtype=torch.bool, device=dev)
    cells[diag_cell[has].long()] = True
    # the diagonal cells in cell order are the cameras that have one, in order
    Hpp[has] -= _pair_blocks(cell_ptr, cell_a, cell_b, WC, W, cells)
    s = Hpp.diagonal(dim1=1, dim2=2).clamp(min=1e-12).rsqrt()        # (M, 9)
    ar = torch.arange(M, device=S.device)
    # float64 products, rounded once into a float32 S
    _cells(S, M)[ar, :, ar, :] = (
        Hpp * s[:, :, None] * s[:, None, :]).to(S.dtype)
    if Hpp_d is None:
        return gp - cr, s.reshape(-1)
    return gp - cr, s.reshape(-1), Hpp_d


def camera_assemble(cam_ptr, cam_obs, A_cam, b, corr, cell_ptr, diag_cell,
                    cell_a, cell_b, WC, W, lam, diagonal_damping, S):
    """Per camera c, the diagonal block of the reduced camera system:
    D_c = damped Hpp_c - sum WC_a W_b^T over the pairs of cell (c, c), and
    s_c = rsqrt(clamp(diag D_c, 1e-12)); stores D_c scaled by s_c s_c^T
    into S's diagonal block (S camera-major, (9M, 9M), of A_cam's dtype).
    Returns g~ = sum A_cam^T b - sum corr (M, 9) and s (9M,); with float32
    A_cam (the mixed-precision mode) also the damped Hpp (M, 9, 9) before
    its cell's pairs are taken off, for schur_matvec."""
    args = (cam_ptr, cam_obs, A_cam, b, corr, cell_ptr, diag_cell, cell_a,
            cell_b, WC, W)
    if _on_cpu(*args, S):
        return camera_assemble_plain(*args, lam, diagonal_damping, S)
    M, K = cam_ptr.shape[0] - 1, A_cam.shape[0]
    U, P = cell_ptr.shape[0] - 1, cell_a.shape[0]
    name = _variant("ba_camera_assemble", "A_cam", A_cam.dtype)
    dev = _check(name, ("cam_ptr", cam_ptr, I32, (M + 1,)),
                 ("cam_obs", cam_obs, I32, (K,)),
                 ("A_cam", A_cam, A_cam.dtype, (K, 2, 9)),
                 ("b", b, F64, (K, 2)), ("corr", corr, F64, (K, 9)),
                 ("cell_ptr", cell_ptr, I32, (U + 1,)),
                 ("diag_cell", diag_cell, I32, (M,)),
                 ("cell_a", cell_a, I32, (P,)), ("cell_b", cell_b, I32, (P,)),
                 ("WC", WC, F64, (K, 9, 3)), ("W", W, F64, (K, 9, 3)),
                 ("S", S, A_cam.dtype, (9 * M, 9 * M), _ROWS))
    g = torch.empty((M, 9), dtype=F64, device=dev)
    s = torch.empty((9 * M,), dtype=F64, device=dev)
    out = [_ptr(S), _ptr(s), _ptr(g)]
    Hpp_d = None
    if A_cam.dtype == F32:
        Hpp_d = torch.empty((M, 9, 9), dtype=F64, device=dev)
        out.append(_ptr(Hpp_d))
    KERNELS[name].launch(dev, M, S.stride(0), *map(_ptr, args), float(lam),
                         int(bool(diagonal_damping)), *out)
    return (g, s) if Hpp_d is None else (g, s, Hpp_d)


def pair_assemble_plain(cell_ptr, cell_ca, cell_cb, cell_a, cell_b, WC, W, s,
                        S):
    off = cell_ca != cell_cb
    blocks = _pair_blocks(cell_ptr, cell_a, cell_b, WC, W, off)
    ca, cb = cell_ca[off].long(), cell_cb[off].long()
    M = S.shape[0] // 9
    s9 = s.view(M, 9)
    _cells(S, M)[ca, :, cb, :] = (-blocks * s9[ca][:, :, None]
                                  * s9[cb][:, None, :]).to(S.dtype)


def pair_assemble(cell_ptr, cell_ca, cell_cb, cell_a, cell_b, WC, W, s, S):
    """Every off-diagonal cell (ca, cb) of the reduced camera system,
    -sum WC_a W_b^T over its pairs, scaled by s_ca s_cb^T and stored into S
    (in place; s from camera_assemble; S float64, or float32 with each entry
    rounded once)."""
    args = (cell_ptr, cell_ca, cell_cb, cell_a, cell_b, WC, W, s, S)
    if _on_cpu(*args):
        return pair_assemble_plain(*args)
    U, P, K = cell_ptr.shape[0] - 1, cell_a.shape[0], WC.shape[0]
    M = S.shape[0] // 9
    name = _variant("ba_pair_assemble", "S", S.dtype)
    dev = _check(name, ("cell_ptr", cell_ptr, I32, (U + 1,)),
                 ("cell_ca", cell_ca, I32, (U,)),
                 ("cell_cb", cell_cb, I32, (U,)),
                 ("cell_a", cell_a, I32, (P,)), ("cell_b", cell_b, I32, (P,)),
                 ("WC", WC, F64, (K, 9, 3)), ("W", W, F64, (K, 9, 3)),
                 ("s", s, F64, (9 * M,)),
                 ("S", S, S.dtype, (9 * M, 9 * M), _ROWS))
    KERNELS[name].launch(dev, U, M, S.stride(0), *map(_ptr, args))


# -- kernels 4 and 5: the point pass, back-substitution and Schur matvec -------


def _point_sums(pt_ptr, obs_cam, W, x):
    """u_p = sum over point p's rows of W_k^T x[cam_k]: (N, 3)."""
    N = pt_ptr.numel() - 1
    return torch.zeros((N, 3), dtype=F64, device=W.device).index_add_(
        0, _segment_owner(pt_ptr), torch.einsum("kil,ki->kl", W, x[obs_cam.long()]))


def back_substitute_plain(pt_ptr, pt_tile, obs_cam, W, dc, C, gl):
    u = _point_sums(pt_ptr, obs_cam, W, dc)
    return torch.einsum("nij,nj->ni", C, gl - u)


def back_substitute(pt_ptr, pt_tile, obs_cam, W, dc, C, gl):
    """dl_p = C_p (gl_p - sum_k W_k^T dc[cam_k]) per point: (N, 3).
    pt_tile: the plan's row tiles (the kernel's blocks)."""
    args = (pt_ptr, pt_tile, obs_cam, W, dc, C, gl)
    if _on_cpu(*args):
        return back_substitute_plain(*args)
    N, K, M = pt_ptr.shape[0] - 1, obs_cam.shape[0], dc.shape[0]
    T = max(1, -(-K // POINT_TILE_ROWS))
    dev = _check("ba_back_substitute", ("pt_ptr", pt_ptr, I32, (N + 1,)),
                 ("pt_tile", pt_tile, I32, (T + 1,)),
                 ("obs_cam", obs_cam, I32, (K,)), ("W", W, F64, (K, 9, 3)),
                 ("dc", dc, F64, (M, 9)), ("C", C, F64, (N, 3, 3)),
                 ("gl", gl, F64, (N, 3)))
    _check_aligned("ba_back_substitute", "W", W)
    dl = torch.empty((N, 3), dtype=F64, device=dev)
    KERNELS["ba_back_substitute"].launch(dev, T, *map(_ptr, args), _ptr(dl))
    return dl


def schur_matvec_plain(pt_ptr, pt_tile, obs_cam, obs_pt, cam_ptr, cam_obs, W,
                       WC, Hpp_d, x):
    M = x.shape[0]
    u = _point_sums(pt_ptr, obs_cam, W, x)
    v = torch.einsum("kil,kl->ki", WC, u[obs_pt.long()])
    return (torch.einsum("cij,cj->ci", Hpp_d, x)
            - torch.zeros((M, 9), dtype=F64, device=x.device).index_add_(
                0, obs_cam.long(), v))


def schur_matvec(pt_ptr, pt_tile, obs_cam, obs_pt, cam_ptr, cam_obs, W, WC,
                 Hpp_d, x):
    """The implicit reduced-camera-system product in float64,
    y = Hpp_d x - sum_k WC_k u_pt(k) with u_p = sum over p's rows of
    W_k^T x[cam_k]; x and y (M, 9) camera-major.  pt_ptr, pt_tile, obs_cam,
    obs_pt: the plan's point side (the point pass); cam_ptr, cam_obs: its
    camera CSR (the camera pass; the plain version does not need them)."""
    args = (pt_ptr, pt_tile, obs_cam, obs_pt, cam_ptr, cam_obs, W, WC, Hpp_d,
            x)
    if _on_cpu(*args):
        return schur_matvec_plain(*args)
    N, K, M = pt_ptr.shape[0] - 1, obs_cam.shape[0], x.shape[0]
    T = max(1, -(-K // POINT_TILE_ROWS))
    dev = _check("ba_schur_matvec", ("pt_ptr", pt_ptr, I32, (N + 1,)),
                 ("pt_tile", pt_tile, I32, (T + 1,)),
                 ("obs_cam", obs_cam, I32, (K,)),
                 ("obs_pt", obs_pt, I32, (K,)),
                 ("cam_ptr", cam_ptr, I32, (M + 1,)),
                 ("cam_obs", cam_obs, I32, (K,)), ("W", W, F64, (K, 9, 3)),
                 ("WC", WC, F64, (K, 9, 3)), ("Hpp_d", Hpp_d, F64, (M, 9, 9)),
                 ("x", x, F64, (M, 9)))
    _check_aligned("ba_schur_matvec", "W", W)
    u = torch.empty((N, 3), dtype=F64, device=dev)    # the point pass's out
    y = torch.empty((M, 9), dtype=F64, device=dev)
    KERNELS["ba_schur_matvec"].launch(dev, T, M, *map(_ptr, args), _ptr(u),
                                      _ptr(y))
    return y
