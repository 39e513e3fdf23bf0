"""Wrappers of the hand-written CUDA kernels of Schur bundle adjustment.

Each wrapper takes tensors in the layout of gtsam_torch/sfm/ba.py (float64,
int32 indices, row-major and contiguous) and
  - on CPU tensors computes its plain PyTorch version (`*_plain`), which the
    CPU tests compare against the JAX package;
  - on CUDA tensors checks dtype, shape, contiguity and device, launches its
    kernel from gtsam_torch/csrc on the current stream and counts the launch.
It never falls back from the kernel to the plain version on a CUDA tensor:
what the kernel does not take raises.  The plain versions also run on CUDA
tensors when called directly, which is how the kernels are checked on the
card.
"""

import ctypes

import torch

from .. import _build
from ..geometry.cameras import CHEIRALITY_EPS
from ..geometry.so3 import hat
from .bal import CHEIRALITY_PENALTY

F64 = torch.float64
I32 = torch.int32

_P = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double


class Kernel:
    """One C entry point of a csrc/ library and its launch count.

    `wrapper` names the function of this module that launches it (its plain
    version is `wrapper + "_plain"`); `replaces` is the JAX routine it ports,
    as file:line."""

    def __init__(self, name, source, wrapper, replaces, argtypes):
        self.name = name
        self.source = source
        self.wrapper = wrapper
        self.replaces = replaces
        self.argtypes = list(argtypes) + [_P]   # the stream comes last
        self.launches = 0
        self._fn = None

    def launch(self, device, *args):
        if self._fn is None:
            fn = getattr(_build.load(self.source), "gt_" + self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with CUDA "
                               f"error {err}")
        self.launches += 1


KERNELS = {k.name: k for k in (
    Kernel("bal_linearize", "bal_linearize", "linearize",
           "gtsam_tpu/sfm/bal.py:182", [_INT] + [_P] * 10),
    Kernel("bal_error", "bal_linearize", "error",
           "gtsam_tpu/sfm/ba.py:1338", [_INT] + [_P] * 8),
    Kernel("ba_point_eliminate", "ba_point_eliminate", "point_eliminate",
           "gtsam_tpu/sfm/ba.py:1086",
           [_INT, _P, _P, _P, _P, _DBL, _INT, _P, _P, _P, _P, _P]),
    Kernel("ba_camera_assemble", "ba_schur_assemble", "camera_assemble",
           "gtsam_tpu/sfm/ba.py:1103",
           [_INT, _P, _P, _P, _P, _P, _DBL, _INT, _P, _P]),
    Kernel("ba_pair_assemble", "ba_schur_assemble", "pair_assemble",
           "gtsam_tpu/sfm/ba.py:1142",
           [_INT, _INT, _P, _P, _P, _P, _P, _P, _P]),
    Kernel("ba_back_substitute", "ba_back_substitute", "back_substitute",
           "gtsam_tpu/sfm/ba.py:1264", [_INT, _P, _P, _P, _P, _P, _P, _P]),
)}


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(name, *specs):
    """specs: (arg name, tensor, dtype, shape).  Returns the common CUDA
    device; raises on anything the kernel does not take."""
    for arg, t, dtype, shape in specs:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    dev = specs[0][1].device
    for arg, t, _, _ in specs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device; {arg} is on {t.device}")
    return dev


def _seg(ptr):
    """Owner index of every element of a CSR with offsets `ptr`."""
    n = ptr.numel() - 1
    return torch.repeat_interleave(torch.arange(n, device=ptr.device),
                                   (ptr[1:] - ptr[:-1]).long())


def _ptr(t):
    return t.data_ptr()


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


def linearize_plain(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv):
    return _projection_plain(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv,
                             True)


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


def linearize(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv):
    """Whitened (unit noise) BAL linearization, one row per observation:
    A_cam (K,2,9), A_pt (K,2,3), b = -r (K,2)."""
    args = (cam_R, cam_t, calib, points, obs_cam, obs_pt, uv)
    if _on_cpu(*args):
        return linearize_plain(*args)
    dev = _projection_specs("bal_linearize", *args)
    K = obs_cam.shape[0]
    A_cam = torch.empty((K, 2, 9), dtype=F64, device=dev)
    A_pt = torch.empty((K, 2, 3), dtype=F64, device=dev)
    b = torch.empty((K, 2), dtype=F64, device=dev)
    KERNELS["bal_linearize"].launch(dev, K, *map(_ptr, args), _ptr(A_cam),
                                    _ptr(A_pt), _ptr(b))
    return A_cam, A_pt, b


ERROR_BLOCK = 256   # threads per block of bal_error_kernel (bal_linearize.cu)


def error(cam_R, cam_t, calib, points, obs_cam, obs_pt, uv):
    """Half-chi2 0.5 * sum r^2 (with the cheirality penalty), a 0-d tensor."""
    args = (cam_R, cam_t, calib, points, obs_cam, obs_pt, uv)
    if _on_cpu(*args):
        return error_plain(*args)
    dev = _projection_specs("bal_error", *args)
    K = obs_cam.shape[0]
    partial = torch.zeros(max(1, -(-K // ERROR_BLOCK)), dtype=F64, device=dev)
    KERNELS["bal_error"].launch(dev, K, *map(_ptr, args), _ptr(partial))
    return 0.5 * partial.sum()


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


def point_eliminate_plain(pt_ptr, A_cam, A_pt, b, lam, diagonal_damping):
    N = pt_ptr.numel() - 1
    seg = _seg(pt_ptr)
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


def point_eliminate(pt_ptr, A_cam, A_pt, b, lam, diagonal_damping):
    """Per point: Hll, gl, C = (Hll + lam_eff I)^-1; per observation:
    W = A_cam^T A_pt, WC = W C, corr = W C gl.
    Returns W (K,9,3), WC (K,9,3), corr (K,9), C (N,3,3), gl (N,3)."""
    args = (pt_ptr, A_cam, A_pt, b)
    if _on_cpu(*args):
        return point_eliminate_plain(*args, lam, diagonal_damping)
    N, K = pt_ptr.shape[0] - 1, A_cam.shape[0]
    dev = _check("ba_point_eliminate", ("pt_ptr", pt_ptr, I32, (N + 1,)),
                 ("A_cam", A_cam, F64, (K, 2, 9)),
                 ("A_pt", A_pt, F64, (K, 2, 3)), ("b", b, F64, (K, 2)))
    W = torch.empty((K, 9, 3), dtype=F64, device=dev)
    WC = torch.empty((K, 9, 3), dtype=F64, device=dev)
    corr = torch.empty((K, 9), dtype=F64, device=dev)
    C = torch.empty((N, 3, 3), dtype=F64, device=dev)
    gl = torch.empty((N, 3), dtype=F64, device=dev)
    KERNELS["ba_point_eliminate"].launch(
        dev, N, *map(_ptr, args), float(lam), int(bool(diagonal_damping)),
        _ptr(W), _ptr(WC), _ptr(corr), _ptr(C), _ptr(gl))
    return W, WC, corr, C, gl


# -- kernel 3: reduced camera system -----------------------------------------


def camera_assemble_plain(cam_ptr, cam_obs, A_cam, b, corr, lam,
                          diagonal_damping, S):
    M = cam_ptr.numel() - 1
    cam_of = _seg(cam_ptr)
    k = cam_obs.long()
    Ac = A_cam[k]
    Hpp = torch.zeros((M, 9, 9), dtype=F64, device=A_cam.device).index_add_(
        0, cam_of, torch.einsum("kri,krj->kij", Ac, Ac))
    gp = torch.zeros((M, 9), dtype=F64, device=A_cam.device).index_add_(
        0, cam_of, torch.einsum("kri,kr->ki", Ac, b[k]))
    cr = torch.zeros((M, 9), dtype=F64, device=A_cam.device).index_add_(
        0, cam_of, corr[k])
    d = Hpp.diagonal(dim1=1, dim2=2)
    if diagonal_damping:
        d.mul_(1.0 + lam)
    else:
        d.add_(lam)
    ar = torch.arange(M, device=S.device)
    S.view(M, 9, M, 9)[ar, :, ar, :] = Hpp
    return gp - cr


def camera_assemble(cam_ptr, cam_obs, A_cam, b, corr, lam, diagonal_damping,
                    S):
    """Per camera: the damped Hpp block, stored into S's diagonal block
    (S camera-major, (9M, 9M)), and g~ = sum A_cam^T b - sum corr (M, 9)."""
    args = (cam_ptr, cam_obs, A_cam, b, corr)
    if _on_cpu(*args, S):
        return camera_assemble_plain(*args, lam, diagonal_damping, S)
    M, K = cam_ptr.shape[0] - 1, A_cam.shape[0]
    dev = _check("ba_camera_assemble", ("cam_ptr", cam_ptr, I32, (M + 1,)),
                 ("cam_obs", cam_obs, I32, (K,)),
                 ("A_cam", A_cam, F64, (K, 2, 9)), ("b", b, F64, (K, 2)),
                 ("corr", corr, F64, (K, 9)),
                 ("S", S, F64, (9 * M, 9 * M)))
    g = torch.empty((M, 9), dtype=F64, device=dev)
    KERNELS["ba_camera_assemble"].launch(
        dev, M, *map(_ptr, args), float(lam), int(bool(diagonal_damping)),
        _ptr(S), _ptr(g))
    return g


def pair_assemble_plain(pair_ptr, pair_a, pair_b, obs_cam, WC, W, S):
    pa, pb, oc = pair_a.long(), pair_b.long(), obs_cam.long()
    blocks = WC[pa] @ W[pb].transpose(-1, -2)                  # (P, 9, 9)
    n = S.shape[0]
    i9 = torch.arange(9, device=S.device)
    rows = (9 * oc[pa])[:, None, None] + i9[None, :, None]
    cols = (9 * oc[pb])[:, None, None] + i9[None, None, :]
    S.view(-1).index_add_(0, (rows * n + cols).reshape(-1),
                          -blocks.reshape(-1))


def pair_assemble(pair_ptr, pair_a, pair_b, obs_cam, WC, W, S):
    """S[cam_a, cam_b] -= WC_a W_b^T over every directed pair (a, b) of
    observations of one point, in place."""
    args = (pair_ptr, pair_a, pair_b, obs_cam, WC, W, S)
    if _on_cpu(*args):
        return pair_assemble_plain(*args)
    N, P, K = pair_ptr.shape[0] - 1, pair_a.shape[0], obs_cam.shape[0]
    M = S.shape[0] // 9
    dev = _check("ba_pair_assemble", ("pair_ptr", pair_ptr, I32, (N + 1,)),
                 ("pair_a", pair_a, I32, (P,)), ("pair_b", pair_b, I32, (P,)),
                 ("obs_cam", obs_cam, I32, (K,)),
                 ("WC", WC, F64, (K, 9, 3)), ("W", W, F64, (K, 9, 3)),
                 ("S", S, F64, (9 * M, 9 * M)))
    KERNELS["ba_pair_assemble"].launch(dev, N, M, *map(_ptr, args))


# -- kernel 4: landmark back-substitution ------------------------------------


def back_substitute_plain(pt_ptr, obs_cam, W, dc, C, gl):
    N = pt_ptr.numel() - 1
    u = torch.zeros((N, 3), dtype=F64, device=W.device).index_add_(
        0, _seg(pt_ptr), torch.einsum("kil,ki->kl", W, dc[obs_cam.long()]))
    return torch.einsum("nij,nj->ni", C, gl - u)


def back_substitute(pt_ptr, obs_cam, W, dc, C, gl):
    """dl_p = C_p (gl_p - sum_k W_k^T dc[cam_k]) per point: (N, 3)."""
    args = (pt_ptr, obs_cam, W, dc, C, gl)
    if _on_cpu(*args):
        return back_substitute_plain(*args)
    N, K, M = pt_ptr.shape[0] - 1, obs_cam.shape[0], dc.shape[0]
    dev = _check("ba_back_substitute", ("pt_ptr", pt_ptr, I32, (N + 1,)),
                 ("obs_cam", obs_cam, I32, (K,)), ("W", W, F64, (K, 9, 3)),
                 ("dc", dc, F64, (M, 9)), ("C", C, F64, (N, 3, 3)),
                 ("gl", gl, F64, (N, 3)))
    dl = torch.empty((N, 3), dtype=F64, device=dev)
    KERNELS["ba_back_substitute"].launch(dev, N, *map(_ptr, args), _ptr(dl))
    return dl
