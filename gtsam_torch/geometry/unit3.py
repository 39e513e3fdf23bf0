"""Unit3: directions on S^2 with a 2-dof tangent (torch).

Counterpart of gtsam_tpu/geometry/unit3.py (reference
gtsam/geometry/Unit3.{h,cpp}): unit 3-vectors; retract moves in the local
tangent basis B(p) (3x2).  All functions broadcast over leading dims.
"""

import torch


def _where(c, a, b):
    return torch.where(c, a, b)


def basis(p):
    """Orthonormal 3x2 basis of the tangent plane at p (Unit3::basis): the
    axis least aligned with p crossed with p, then p crossed with that."""
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=p.dtype, device=p.device)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=p.dtype, device=p.device)
    ax = _where(torch.abs(p[..., 0:1]) < 0.9, e1, e2)
    b1 = torch.linalg.cross(p, ax.expand_as(p))
    b1 = b1 / torch.linalg.norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(p, b1)
    return torch.stack([b1, b2], dim=-1)


def retract(p, xi):
    """Exponential-map retraction on the sphere."""
    v = torch.einsum("...ij,...j->...i", basis(p), xi)
    theta = torch.linalg.norm(v, dim=-1, keepdim=True)
    small = theta < 1e-12
    ts = _where(small, torch.ones_like(theta), theta)
    q = torch.cos(theta) * p + torch.sin(theta) * (v / ts)
    q = _where(small, p + v, q)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def local(p, q):
    """Inverse retraction: the coordinates of q in p's tangent basis."""
    c = torch.clamp(torch.sum(p * q, dim=-1), -1.0, 1.0)
    theta = torch.arccos(c)
    perp = q - c[..., None] * p
    n = torch.linalg.norm(perp, dim=-1, keepdim=True)
    small = n < 1e-12
    ns = _where(small, torch.ones_like(n), n)
    v = theta[..., None] * perp / ns
    v = _where(small, torch.zeros_like(v), v)
    return torch.einsum("...ji,...j->...i", basis(p), v)


def error_vector(p, q):
    """Signed 2D error B(p)^T q (Unit3.cpp errorVector)."""
    return torch.einsum("...ji,...j->...i", basis(p), q)


def identity(dtype=torch.float64):
    return torch.tensor([0.0, 0.0, 1.0], dtype=dtype)
