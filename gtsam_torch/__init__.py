"""gtsam_torch — the PyTorch/CUDA port of gtsam_tpu for an NVIDIA H100.

The JAX package `gtsam_tpu` is the reference; this package imports neither
it nor JAX.  Modules keep the JAX names so each counterpart is easy to find.
The hot path of Schur bundle adjustment runs in hand-written CUDA kernels
(`csrc/`), each with a plain PyTorch version beside it (`sfm/ba_kernels.py`).
"""

from .config import default_dtype, resolve_device
from .linear.pcg import PCGSolver, SubgraphPCGSolver
from .optimize.optimizers import LMParams, OptimizerParams, check_convergence

__all__ = ["default_dtype", "resolve_device", "LMParams", "OptimizerParams",
           "check_convergence", "PCGSolver", "SubgraphPCGSolver"]
