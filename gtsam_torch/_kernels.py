"""Plumbing shared by the port's kernel tables.

A kernel table (sfm/ba_kernels.py, linear/supernodal_kernels.py) is a dict
of `Kernel`s made by `table(...)`, which also registers it here, so that
`launch_counts()` and `reset_launch_counts()` cover every kernel of the
port.  Each Kernel is one C entry point of a csrc/ library, loaded with
ctypes at its first launch (the library is built then if needed, never at
import), and counts its launches.
"""

import ctypes

import torch

from . import _build

P = ctypes.c_void_p
INT = ctypes.c_int
DBL = ctypes.c_double

TABLES = []
ROWS = "rows"      # check(): a matrix with a leading dimension of its own

# Row stride, in elements, of the port's dense n x n buffers (BA's S): n
# rounded up to it, so that every row starts on a 256-byte boundary (on an
# H100, cuBLAS's rank-512 DGEMM into S ran at 36 TFLOP/s at BA's odd row
# stride of 15,507 and 46 at 15,520: scripts/port_dense_probe.py).
ROW_ALIGN = 32


def row_strided(n, dtype, device):
    """An uninitialized n x n matrix whose rows are ROW_ALIGN-aligned: the
    first n columns of an (n, ld) buffer."""
    ld = -(-n // ROW_ALIGN) * ROW_ALIGN
    return torch.empty((n, ld), dtype=dtype, device=device)[:, :n]


class Kernel:
    """One C entry point of a csrc/ library and its launch count.

    `wrapper` names the function of its table's module that launches it
    (its plain version is `wrapper + "_plain"`); `replaces` is the JAX
    routine it ports, as file:line."""

    def __init__(self, name, source, wrapper, replaces, argtypes):
        self.name = name
        self.source = source
        self.wrapper = wrapper
        self.replaces = replaces
        self.argtypes = list(argtypes) + [P]   # the stream comes last
        self.launches = 0
        self._fn = None

    def launch(self, device, *args):
        if self._fn is None:
            fn = getattr(_build.load(self.source), "gt_" + self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args, stream(device))
        if err != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed with CUDA "
                               f"error {err}")
        self.launches += 1


def table(*kernels) -> dict:
    """{name: Kernel} of `kernels`, registered for the launch counts."""
    t = {k.name: k for k in kernels}
    TABLES.append(t)
    return t


def stream(device):
    """The handle of `device`'s current stream: what
    torch.cuda.current_stream(device).cuda_stream gives, without building a
    Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# The scratch of the kernels that finish a sum in their last CTA (bal_error,
# pg_error): per (device, stream), an int32 completion ticket and a float64
# buffer of the CTAs' partials.  The last CTA of a launch finds itself by
# the ticket and sets it back to 0, so launches in one stream's order share
# both and concurrent streams do not.
_SUM_SCRATCH = {}


def sum_scratch(device, n):
    """(ticket, partials) of `device`'s current stream: the zeroed int32
    ticket and a float64 buffer of at least n partials."""
    key = (device, stream(device))
    sc = _SUM_SCRATCH.get(key)
    if sc is None or sc[1].numel() < n:
        ticket = sc[0] if sc is not None else torch.zeros(
            (), dtype=torch.int32, device=device)
        sc = _SUM_SCRATCH[key] = (ticket, torch.empty(
            max(n, 1024), dtype=torch.float64, device=device))
    return sc


def reset_launch_counts():
    for t in TABLES:
        for k in t.values():
            k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for t in TABLES for name, k in t.items()}


def on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def check(name, *specs):
    """specs: (arg name, tensor, dtype, shape), or with a fifth entry
    ROWS for a matrix whose rows may lie apart (a view of the first columns
    of a wider buffer: unit column stride, row stride at least the width,
    read by the kernel with its own leading dimension).  Returns the common
    CUDA device; raises on anything the kernel does not take."""
    for arg, t, dtype, shape, *rows in specs:
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if rows and not (t.dim() == 2 and t.stride(1) == 1
                         and t.stride(0) >= t.shape[1]):
            raise ValueError(f"{name}: {arg} must be contiguous along its "
                             "rows")
        if not rows and not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    dev = specs[0][1].device
    for arg, t, *_ in specs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on one CUDA "
                             f"device; {arg} is on {t.device}")
    return dev


def ptr(t):
    return t.data_ptr()


def segment_owner(p):
    """Owner index of every element of a CSR with offsets `p`: the segment
    ids the plain versions' index_add_ sums over."""
    n = p.numel() - 1
    return torch.repeat_interleave(torch.arange(n, device=p.device),
                                   (p[1:] - p[:-1]).long())
