"""Native (C) orderings and symbolic analysis, loaded with ctypes.

A copy of the C sources the JAX package ships (src/: approximate minimum
degree, multilevel nested dissection, the symbolic factor), built with
`gcc -O3 -shared` at first use into build/gtsam_torch_native/ under a name
that is a digest of the sources and flags.  Unlike the JAX package, which
falls back to Python orderings when its build fails, the port raises: a
fallback would change the ordering, and with it the supernodal level plan.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"
SOURCES = ("symbolic.c", "amd.c", "nd.c")
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / "build"
             / "gtsam_torch_native")
CFLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha1(" ".join(CFLAGS).encode())
    for name in SOURCES:
        h.update((SRC / name).read_bytes())
    return BUILD_DIR / f"libgtsam_native.{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library if it is not built yet; raises if gcc fails."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        cmd = ["gcc", *CFLAGS, "-o", str(tmp), *(str(SRC / n) for n in SOURCES)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"building the native orderings failed "
                               f"(exit {out.returncode}):\n{out.stderr}")
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(
                ctypes.c_int64)
            lib.symbolic_analyze.argtypes = [ctypes.c_int32, i64, i32, i32,
                                             i32, i64, i32, ctypes.c_int64]
            lib.symbolic_analyze.restype = ctypes.c_int64
            lib.count_triples.argtypes = [ctypes.c_int32, i64]
            lib.count_triples.restype = ctypes.c_int64
            lib.emit_triples.argtypes = [ctypes.c_int32, i64, i32, i64, i32,
                                         i32, i32, i32, i32, i32]
            lib.emit_triples.restype = ctypes.c_int64
            lib.amd_order.argtypes = [ctypes.c_int32, i64, i32, i32,
                                      ctypes.POINTER(ctypes.c_uint8)]
            lib.amd_order.restype = ctypes.c_int32
            lib.nd_order.argtypes = [ctypes.c_int32, i64, i32, i32,
                                     ctypes.c_int32]
            lib.nd_order.restype = ctypes.c_int32
            _lib = lib
        return _lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def symbolic_analyze(n, nbr_indptr, nbr):
    """(parent, level, struct_indptr, struct_rows) of the symbolic factor of
    the lower-triangular pattern (CSR by column)."""
    lib = get_lib()
    nbr_indptr = np.ascontiguousarray(nbr_indptr, dtype=np.int64)
    nbr = np.ascontiguousarray(nbr, dtype=np.int32)
    parent = np.empty(n, dtype=np.int32)
    level = np.empty(n, dtype=np.int32)
    struct_indptr = np.empty(n + 1, dtype=np.int64)
    cap = max(len(nbr) * 8 + 1024, 1 << 16)
    for _ in range(6):  # grow until it fits
        struct_rows = np.empty(cap, dtype=np.int32)
        total = lib.symbolic_analyze(
            ctypes.c_int32(n), _ptr(nbr_indptr, ctypes.c_int64),
            _ptr(nbr, ctypes.c_int32), _ptr(parent, ctypes.c_int32),
            _ptr(level, ctypes.c_int32), _ptr(struct_indptr, ctypes.c_int64),
            _ptr(struct_rows, ctypes.c_int32), ctypes.c_int64(cap))
        if total >= 0:
            return parent, level, struct_indptr, struct_rows[:total]
        cap *= 4
    raise RuntimeError("symbolic_analyze: the factor's structure does not fit")


def emit_triples(n, struct_indptr, struct_rows, sub_base, dblock,
                 level_of_col):
    """The update triples of the symbolic factor (target, ik, jk block ids
    and the target column's level), column k after column k, as the JAX
    package's emit_triples_native lists them."""
    lib = get_lib()
    struct_indptr = np.ascontiguousarray(struct_indptr, dtype=np.int64)
    struct_rows = np.ascontiguousarray(struct_rows, dtype=np.int32)
    sub_base = np.ascontiguousarray(sub_base, dtype=np.int64)
    dblock = np.ascontiguousarray(dblock, dtype=np.int32)
    level_of_col = np.ascontiguousarray(level_of_col, dtype=np.int32)
    total = lib.count_triples(ctypes.c_int32(n),
                              _ptr(struct_indptr, ctypes.c_int64))
    out = [np.empty(total, dtype=np.int32) for _ in range(4)]
    lib.emit_triples(
        ctypes.c_int32(n), _ptr(struct_indptr, ctypes.c_int64),
        _ptr(struct_rows, ctypes.c_int32), _ptr(sub_base, ctypes.c_int64),
        _ptr(dblock, ctypes.c_int32),
        *(_ptr(a, ctypes.c_int32) for a in out),
        _ptr(level_of_col, ctypes.c_int32))
    return tuple(out)


def amd_order(n, indptr, indices, constrained_last=None):
    """AMD fill-reducing ordering; constrained_last: optional bool mask of
    variables ordered last."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    cptr = None
    if constrained_last is not None:
        cmask = np.ascontiguousarray(constrained_last, dtype=np.uint8)
        cptr = _ptr(cmask, ctypes.c_uint8)
    rc = lib.amd_order(ctypes.c_int32(n), _ptr(indptr, ctypes.c_int64),
                       _ptr(indices, ctypes.c_int32),
                       _ptr(perm, ctypes.c_int32), cptr)
    if rc != 0:
        raise RuntimeError(f"amd_order failed ({rc})")
    return perm.astype(np.int64)


def nd_order(n, indptr, indices, leaf_size=32):
    """Multilevel nested dissection (METIS class)."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    perm = np.empty(n, dtype=np.int32)
    rc = lib.nd_order(ctypes.c_int32(n), _ptr(indptr, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int32),
                      _ptr(perm, ctypes.c_int32), ctypes.c_int32(leaf_size))
    if rc != 0:
        raise RuntimeError(f"nd_order failed ({rc})")
    return perm.astype(np.int64)
