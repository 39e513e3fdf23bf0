"""SO(3) as batched 3x3 rotation matrices (torch).

Counterpart of gtsam_tpu/geometry/so3.py.  All functions broadcast over
leading dims; tangent vectors are axis-angle 3-vectors (GTSAM convention).
Small-angle branches use the double-`where` pattern, so values and
forward-mode derivatives stay NaN-free at theta == 0.
"""

import torch

_SMALL = 1e-10  # threshold on theta^2; Taylor error ~ theta^6 << f64 eps


def _small2(theta2):
    """Dtype-aware small-angle threshold on theta^2 (see the JAX module)."""
    return _SMALL if theta2.dtype == torch.float64 else 1e-3


def _taylor_coeffs(theta2):
    """A = sin(t)/t, B = (1-cos t)/t^2, C = (t - sin t)/t^3, AD-safe."""
    small = theta2 < _small2(theta2)
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - sin_t) / (safe * theta))
    return A, B, C


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w):
    """(...,3) -> (...,3,3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W):
    """(...,3,3) skew -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def expmap(w):
    """Rodrigues' formula: exp(hat(w)). (...,3) -> (...,3,3)."""
    A, B, _ = _taylor_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def to_quaternion(R):
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def q_from(pivot2, a, b, c, d):
        s = torch.sqrt(torch.clamp(pivot2, min=1e-30)) * 2.0
        return torch.stack([a / s, b / s, c / s, d / s], dim=-1)

    one = torch.ones_like(tr)
    q0 = q_from(1.0 + tr, (1.0 + tr) * one, m21 - m12, m02 - m20, m10 - m01)
    q1 = q_from(1.0 + m00 - m11 - m22, m21 - m12,
                (1.0 + m00 - m11 - m22) * one, m01 + m10, m02 + m20)
    q2 = q_from(1.0 - m00 + m11 - m22, m02 - m20, m01 + m10,
                (1.0 - m00 + m11 - m22) * one, m12 + m21)
    q3 = q_from(1.0 - m00 - m11 + m22, m10 - m01, m02 + m20, m12 + m21,
                (1.0 - m00 - m11 + m22) * one)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def logmap(R):
    """(...,3,3) -> (...,3) axis-angle, via the quaternion (stable at pi)."""
    q = to_quaternion(R)
    sign = torch.where(q[..., 0] < 0.0, -1.0, 1.0).to(R.dtype)
    qw = q[..., 0] * sign
    qv = q[..., 1:] * sign[..., None]
    nv2 = torch.sum(qv * qv, dim=-1)
    small = nv2 < _SMALL
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    theta = 2.0 * torch.atan2(nv, qw)
    scale = torch.where(small,
                        2.0 / torch.clamp(qw, min=1e-30) * (1.0 + nv2 / 3.0),
                        theta / nv)
    return qv * scale[..., None]


def right_jacobian(w):
    """J_r = I - B*W + C*W^2: d Log(Exp(w)^-1 Exp(w + dw)) / d dw at 0
    (reference SO3.h:74 ExpmapDerivative)."""
    _, B, C = _taylor_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) - B[..., None, None] * W + C[..., None, None] * (W @ W)


def left_jacobian(w):
    """J_l = I + B*W + C*W^2; also the 'V' matrix of the SE(3) exponential."""
    _, B, C = _taylor_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def left_jacobian_inverse(w):
    """V^-1 = I - W/2 + E * W^2 with E = (1 - A/(2B)) / theta^2 (AD-safe)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _taylor_coeffs(theta2)
    small = theta2 < _small2(theta2)
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    E = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    (1.0 - 0.5 * A / B) / safe)
    W = hat(w)
    return _eye_like(W) - 0.5 * W + E[..., None, None] * (W @ W)


def _rot(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def rx(t):
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    return _rot([[o, z, z], [z, c, -s], [z, s, c]])


def ry(t):
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    return _rot([[c, z, s], [z, o, z], [-s, z, c]])


def rz(t):
    c, s = torch.cos(t), torch.sin(t)
    z, o = torch.zeros_like(t), torch.ones_like(t)
    return _rot([[c, -s, z], [s, c, z], [z, z, o]])


def ypr(yaw, pitch, roll):
    """Rz(yaw) Ry(pitch) Rx(roll) (reference Rot3::Ypr)."""
    return rz(yaw) @ ry(pitch) @ rx(roll)


def from_quaternion(q):
    """(w, x, y, z) unit quaternion -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return _rot([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def inverse(R):
    return R.transpose(-1, -2)


def compose(R1, R2):
    return R1 @ R2


def between(R1, R2):
    """R1^-1 R2."""
    return inverse(R1) @ R2


def rotate(R, p):
    """R p: (...,3,3), (...,3) -> (...,3)."""
    return torch.einsum("...ij,...j->...i", R, p)


def unrotate(R, p):
    """R^T p."""
    return torch.einsum("...ji,...j->...i", R, p)


def retract(R, w):
    """Right retraction R Exp(w) (Rot3's Expmap retract)."""
    return R @ expmap(w)


def local(R1, R2):
    """Log(R1^-1 R2)."""
    return logmap(between(R1, R2))


def identity(dtype=torch.float64):
    return torch.eye(3, dtype=dtype)
