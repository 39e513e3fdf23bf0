"""Manifold type registry.

Counterpart of gtsam_tpu/graph/manifolds.py (reference traits<T>,
gtsam/base/Manifold.h:50): named manifold types, each with `retract` and
`local` on its tensor representation.  The port's functions broadcast over
leading dimensions, so they act on one element or on a stacked batch alike.
Ported types: SE3, SE2, SO3, the cameras BalCamera (9: [pose(6); f, k1,
k2]) and PinholeCameraS2 (11: [pose(6); Cal3_S2]), and vector spaces
("Point3", "Vec6", ..., "Vec<n>" on demand); any other name of the JAX
registry raises NotImplementedError.
"""

import dataclasses
from typing import Callable

import torch

from ..geometry import cameras, se2, se3, so3


@dataclasses.dataclass(frozen=True)
class ManifoldType:
    name: str
    dim: int                       # tangent dimension
    retract: Callable              # (x, delta:(..., dim)) -> x'
    local: Callable                # (x, y) -> delta:(..., dim)
    identity: Callable             # () -> example element


def _vector_manifold(name: str, d: int) -> ManifoldType:
    return ManifoldType(
        name=name, dim=d,
        retract=lambda x, delta: x + delta,
        local=lambda x, y: y - x,
        identity=lambda: torch.zeros(d, dtype=torch.float64))


MANIFOLDS: dict = {}

# types of the JAX registry that wait for their geometry to be ported
NOT_PORTED = ("Sim2", "Sim3", "Scalar", "NavState")


def register(m: ManifoldType) -> ManifoldType:
    MANIFOLDS[m.name] = m
    return m


def get(name: str) -> ManifoldType:
    if name in MANIFOLDS:
        return MANIFOLDS[name]
    if name.startswith("Vec") and name[3:].isdigit():
        return register(_vector_manifold(name, int(name[3:])))
    if name in NOT_PORTED:
        raise NotImplementedError(f"manifold type {name!r} is not ported yet")
    raise KeyError(name)


SE3 = register(ManifoldType("SE3", 6, se3.retract, se3.local, se3.identity))
SE2 = register(ManifoldType("SE2", 3, se2.retract, se2.local, se2.identity))
SO3 = register(ManifoldType("SO3", 3, so3.retract, so3.local, so3.identity))
POINT3 = register(_vector_manifold("Point3", 3))
POINT2 = register(_vector_manifold("Point2", 2))
VEC3 = register(_vector_manifold("Vec3", 3))
VEC6 = register(_vector_manifold("Vec6", 6))
BAL_CAMERA = register(ManifoldType(
    "BalCamera", 9, cameras.bal_retract, cameras.bal_local,
    cameras.bal_identity))
PINHOLE_S2 = register(ManifoldType(
    "PinholeCameraS2", 11, cameras.pinhole_s2_retract,
    cameras.pinhole_s2_local, cameras.pinhole_s2_identity))
