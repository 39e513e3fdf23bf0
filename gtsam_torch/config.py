"""Global configuration for gtsam_torch.

Counterpart of gtsam_tpu/config.py.  The state, residuals and every
reduction of the port are float64 (the H100 has native FP64, so the
two-float pairs the JAX package uses on a TPU are not carried over).  Bundle
adjustment may also run its Jacobians and reduced camera matrix S in
float32 (`ba_optimize(dtype=torch.float32, mixed_precision=True)`): the
JAX package's mixed-precision mode, an f32 factorization refined in float64.

Entry points run on the CUDA device unless the caller passes device="cpu";
they never fall back to the CPU on their own.
"""

import torch

DEFAULT_DTYPE = torch.float64
# dtypes of BA's Jacobians and reduced camera matrix (the working dtype)
WORKING_DTYPES = (torch.float64, torch.float32)


def default_dtype() -> torch.dtype:
    return DEFAULT_DTYPE


def working_dtype(dtype=None) -> torch.dtype:
    """`dtype` (float64 when None) if the port can run BA in it; raises
    otherwise."""
    dt = DEFAULT_DTYPE if dtype is None else dtype
    if dt not in WORKING_DTYPES:
        raise ValueError(f"working dtype must be one of {WORKING_DTYPES}, "
                         f"got {dt}")
    return dt


def resolve_device(device=None) -> torch.device:
    """`device` or, when None, the CUDA device.  Raises when the result is a
    CUDA device and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gtsam_torch runs on the CUDA device by default, and CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    return dev
