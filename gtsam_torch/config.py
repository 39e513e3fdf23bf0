"""Global configuration for gtsam_torch.

Counterpart of gtsam_tpu/config.py.  The port computes in float64 throughout:
the H100 has native FP64, so the f32 + two-float scheme the JAX package needs
on a TPU (where f64 is emulated) does not carry over.

Entry points run on the CUDA device unless the caller passes device="cpu";
they never fall back to the CPU on their own.
"""

import torch

DEFAULT_DTYPE = torch.float64


def default_dtype() -> torch.dtype:
    return DEFAULT_DTYPE


def resolve_device(device=None) -> torch.device:
    """`device` or, when None, the CUDA device.  Raises when the result is a
    CUDA device and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gtsam_torch runs on the CUDA device by default, and CUDA is not "
            "available; pass device='cpu' to run on the CPU")
    return dev
