"""Values: typed, batched variable storage.

Counterpart of gtsam_tpu/graph/values.py (reference gtsam/nonlinear/Values.h):
one stacked representation per manifold type (SE3 as an SE3 of (N, 3, 3)
and (N, 3) tensors, a camera as a NamedTuple of a stacked SE3 and its
(N, k) calibration, a vector type as an (N, d) tensor), all on one device;
keys are host-side metadata.  The tangent layout is canonical: types in
sorted order, rows in order.
"""

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from ..config import resolve_device
from ..geometry.se3 import SE3
from . import manifolds


@dataclasses.dataclass
class Layout:
    """Canonical tangent-vector layout: types in sorted order, rows in
    order.  Caches the flat index tensors of each type by device."""

    total_dim: int
    offsets: Dict[str, np.ndarray]     # type -> (N_t,) start offset of each row
    type_order: tuple
    _index: dict = dataclasses.field(default_factory=dict, repr=False)

    def index(self, tname: str, device) -> torch.Tensor:
        """(N_t, dim) indices of type `tname`'s rows into a flat delta."""
        key = (tname, str(device))
        if key not in self._index:
            d = manifolds.get(tname).dim
            idx = self.offsets[tname][:, None] + np.arange(d)[None, :]
            self._index[key] = torch.as_tensor(idx, dtype=torch.long,
                                               device=device)
        return self._index[key]


def tree_map(fn, a):
    """`fn` applied to every tensor of one stacked element: a tensor, or a
    NamedTuple of them (SE3; a camera's pose and calibration), rebuilt with
    its own type."""
    if isinstance(a, tuple):
        return type(a)(*(tree_map(fn, x) for x in a))
    return fn(a)


def first_leaf(a):
    """The first tensor of a stacked element (its device and batch size)."""
    return first_leaf(a[0]) if isinstance(a, tuple) else a


def map_arrays(fn, arrays):
    """`fn` applied to every tensor of an arrays dict (SE3 and camera
    fields too)."""
    return {t: tree_map(fn, a) for t, a in arrays.items()}


def arrays_to(arrays, device):
    return map_arrays(lambda a: a.to(device), arrays)


def take_rows(a, rows):
    return tree_map(lambda x: x[rows], a)


# the port's element type of each manifold whose element is a NamedTuple
# (from_numpy rebuilds them from any tuples of arrays of the same layout,
# the JAX package's included)
def _element_types():
    from ..geometry.cameras import BalCamera, PinholeCameraS2
    return {"SE3": SE3, "BalCamera": (BalCamera, SE3),
            "PinholeCameraS2": (PinholeCameraS2, SE3)}


def element_from_numpy(tname, a, device=None):
    """One stacked element of manifold `tname` from numpy arrays (or
    anything np.asarray takes: a tuple of arrays in the element's field
    order, nested for a camera's pose), as float64 tensors on `device`
    (CUDA when None: config.resolve_device)."""
    dev = resolve_device(device)

    def f(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64,
                               device=dev)
    kind = _element_types().get(tname)
    if kind is None:
        return f(a)
    if kind is SE3:
        return SE3(f(a[0]), f(a[1]))
    cls, pose = kind
    return cls(pose(f(a[0][0]), f(a[0][1])), f(a[1]))


class Values:
    """arrays: type -> stacked element (leading dim N_t); keys: type ->
    (N_t,) int64."""

    def __init__(self, arrays: Dict[str, Any], keys: Dict[str, np.ndarray]):
        self.arrays = arrays
        self.keys = {t: np.asarray(k, dtype=np.int64) for t, k in keys.items()}
        self._index: Dict[int, tuple] = {}
        for t, ks in self.keys.items():
            for row, k in enumerate(ks):
                self._index[int(k)] = (t, row)
        self._layout = None

    @staticmethod
    def from_entries(entries):
        """entries: iterable of (key, type_name, element)."""
        per_type: Dict[str, list] = {}
        keys: Dict[str, list] = {}
        for key, tname, val in entries:
            per_type.setdefault(tname, []).append(val)
            keys.setdefault(tname, []).append(key)
        arrays = {t: _stack(vals) for t, vals in per_type.items()}
        return Values(arrays, {t: np.asarray(k) for t, k in keys.items()})

    @staticmethod
    def from_numpy(arrays, keys, device=None) -> "Values":
        """Values of numpy arrays (arrays: type -> one stacked element as
        element_from_numpy takes it, e.g. a JAX package's BalCamera of
        numpy-convertible leaves), as float64 tensors on `device` (CUDA
        when None)."""
        dev = resolve_device(device)
        return Values({t: element_from_numpy(t, a, dev)
                       for t, a in arrays.items()}, keys)

    def replace_arrays(self, arrays) -> "Values":
        out = Values.__new__(Values)
        out.arrays = arrays
        out.keys = self.keys
        out._index = self._index
        out._layout = self._layout
        return out

    def to(self, device) -> "Values":
        return self.replace_arrays(arrays_to(self.arrays, device))

    def __len__(self):
        return len(self._index)

    def __contains__(self, key):
        return int(key) in self._index

    def type_of(self, key) -> str:
        return self._index[int(key)][0]

    def row_of(self, key) -> int:
        return self._index[int(key)][1]

    def rows_of(self, tname: str, keys) -> np.ndarray:
        """Vectorized key -> row lookup for one type."""
        idx = self._index
        return np.asarray([idx[int(k)][1] for k in keys], dtype=np.int32)

    def at(self, key):
        t, row = self._index[int(key)]
        return take_rows(self.arrays[t], row)

    def layout(self) -> Layout:
        if self._layout is None:
            order = tuple(sorted(self.keys))
            offsets = {}
            base = 0
            for t in order:
                d = manifolds.get(t).dim
                n = len(self.keys[t])
                offsets[t] = base + np.arange(n, dtype=np.int32) * d
                base += n * d
            self._layout = Layout(base, offsets, order)
        return self._layout

    def retract(self, delta) -> "Values":
        """delta: flat (total_dim,) tangent vector in canonical layout."""
        return self.replace_arrays(retract_arrays(self.arrays, delta,
                                                  self.layout()))


def _stack(vals):
    """One stacked element of a list of single elements."""
    if isinstance(vals[0], tuple):
        return type(vals[0])(*(_stack([v[i] for v in vals])
                               for i in range(len(vals[0]))))
    return torch.stack([torch.as_tensor(v) for v in vals])


def vmapped_retract(m: manifolds.ManifoldType):
    """m.retract over stacked elements (the port's retractions broadcast;
    torch.func.vmap keeps the JAX package's per-element semantics)."""
    return torch.func.vmap(m.retract)


def vmapped_local(m: manifolds.ManifoldType):
    return torch.func.vmap(m.local)


def retract_arrays(arrays, delta, layout: Layout):
    """Retract the stacked arrays by the flat delta (canonical layout)."""
    return {t: manifolds.get(t).retract(arrays[t],
                                        delta[layout.index(t, delta.device)])
            for t in layout.type_order}
