"""Distortion calibrations beyond Cal3_S2 and Cal3Bundler, batched.

Counterpart of gtsam_tpu/geometry/calibrations.py (reference
gtsam/geometry: Cal3DS2 radial-tangential, Cal3Unified omni,
Cal3_S2Stereo, Cal3Fisheye equidistant): (uncalibrate, calibrate) pairs
over normalized coordinates.  The calibrate functions invert the
distortion by a fixed number of fixed-point or Newton iterations.
"""

import torch


def _k(K, n):
    return tuple(K[..., i] for i in range(n))


def uncalibrate_ds2(K, p):
    """Cal3DS2: K = [fx, fy, s, u0, v0, k1, k2, p1, p2]; radial
    (1 + k1 r2 + k2 r4) and tangential distortion, then the affine map."""
    fx, fy, s, u0, v0, k1, k2, p1, p2 = _k(K, 9)
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    xd = g * x + dx
    yd = g * y + dy
    return torch.stack([fx * xd + s * yd + u0, fy * yd + v0], dim=-1)


def calibrate_ds2(K, pixel, iterations: int = 10):
    """Inverse distortion by fixed point (Cal3DS2_Base::calibrate)."""
    fx, fy, s, u0, v0 = _k(K, 5)
    v = (pixel[..., 1] - v0) / fy
    u = (pixel[..., 0] - u0 - s * v) / fx
    pd = torch.stack([u, v], dim=-1)
    p = pd
    k1, k2, p1, p2 = (K[..., i] for i in range(5, 9))
    for _ in range(iterations):
        x, y = p[..., 0], p[..., 1]
        r2 = x * x + y * y
        g = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        p = (pd - torch.stack([dx, dy], dim=-1)) / g[..., None]
    return p


def uncalibrate_unified(K, p):
    """Cal3Unified: K = [fx, fy, s, u0, v0, k1, k2, p1, p2, xi]; the
    mirror projection to the unit plane (Cal3Unified.cpp spaceToNPlane),
    then the Cal3DS2 model."""
    xi = K[..., 9]
    x, y = p[..., 0], p[..., 1]
    sq = 1.0 + xi * torch.sqrt(x * x + y * y + 1.0)
    m = torch.stack([x / sq, y / sq], dim=-1)
    return uncalibrate_ds2(K[..., :9], m)


def calibrate_unified(K, pixel, iterations: int = 10):
    """Pixel -> normalized: the DS2 inverse to the unit plane, then the
    closed-form nPlaneToSpace (Cal3Unified.cpp:118-121)."""
    xi = K[..., 9]
    m = calibrate_ds2(K[..., :9], pixel, iterations)
    x, y = m[..., 0], m[..., 1]
    xy2 = x * x + y * y
    sq_xy = (xi + torch.sqrt(1.0 + (1.0 - xi * xi) * xy2)) / (xy2 + 1.0)
    scale = sq_xy / (sq_xy - xi)
    return m * scale[..., None]


def uncalibrate_s2stereo(K, p):
    """Cal3_S2Stereo: K = [fx, fy, s, u0, v0, b]; its monocular part is
    Cal3_S2 (Cal3_S2Stereo.h:67); cameras.stereo_project takes b."""
    fx, fy, s, u0, v0 = _k(K, 5)
    u = fx * p[..., 0] + s * p[..., 1] + u0
    v = fy * p[..., 1] + v0
    return torch.stack([u, v], dim=-1)


def calibrate_s2stereo(K, pixel):
    fx, fy, s, u0, v0 = _k(K, 5)
    v = (pixel[..., 1] - v0) / fy
    u = (pixel[..., 0] - u0 - s * v) / fx
    return torch.stack([u, v], dim=-1)


def uncalibrate_fisheye(K, p):
    """Cal3Fisheye: K = [fx, fy, s, u0, v0, k1, k2, k3, k4]; the
    equidistant model td = t (1 + k1 t^2 + k2 t^4 + k3 t^6 + k4 t^8)."""
    fx, fy, s, u0, v0, k1, k2, k3, k4 = _k(K, 9)
    x, y = p[..., 0], p[..., 1]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    t = torch.arctan(r)
    t2 = t * t
    td = t * (1.0 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4)
    scale = torch.where(r2 < 1e-14, torch.ones_like(r2), td / r)
    xd, yd = scale * x, scale * y
    return torch.stack([fx * xd + s * yd + u0, fy * yd + v0], dim=-1)


def calibrate_fisheye(K, pixel, iterations: int = 10):
    """Pixel -> normalized: td(t) inverted by Newton iterations."""
    fx, fy, s, u0, v0 = _k(K, 5)
    v = (pixel[..., 1] - v0) / fy
    u = (pixel[..., 0] - u0 - s * v) / fx
    pd = torch.stack([u, v], dim=-1)
    rd = torch.linalg.norm(pd, dim=-1)
    k1, k2, k3, k4 = (K[..., i] for i in range(5, 9))
    t = rd
    for _ in range(iterations):
        t2 = t * t
        f = t * (1.0 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3
                 + k4 * t2 ** 4) - rd
        df = (1.0 + 3 * k1 * t2 + 5 * k2 * t2 ** 2 + 7 * k3 * t2 ** 3
              + 9 * k4 * t2 ** 4)
        t = t - f / df
    r = torch.tan(t)
    scale = torch.where(rd < 1e-12, torch.ones_like(rd),
                        r / torch.clamp(rd, min=1e-12))
    return pd * scale[..., None]
