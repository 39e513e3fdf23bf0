"""Optimizer parameters and the convergence test.

Counterpart of gtsam_tpu/optimize/optimizers.py (OptimizerParams, LMParams,
check_convergence); the optimizers themselves come with the graph core.
Semantics mirror the reference NonlinearOptimizer.cpp:182 checkConvergence
and LevenbergMarquardtOptimizer.cpp.
"""

import dataclasses


@dataclasses.dataclass
class OptimizerParams:
    max_iterations: int = 100
    relative_error_tol: float = 1e-5
    absolute_error_tol: float = 1e-5
    error_tol: float = 0.0
    verbose: bool = False


@dataclasses.dataclass
class LMParams(OptimizerParams):
    lambda_initial: float = 1e-5
    lambda_factor: float = 10.0
    lambda_upper_bound: float = 1e5
    lambda_lower_bound: float = 0.0
    diagonal_damping: bool = False
    min_diagonal: float = 1e-6
    max_diagonal: float = 1e32
    # "gtsam": always decrease lambda on accept (LevenbergMarquardtOptimizer);
    # "conservative": decrease only on a clean first-try accept and never
    # probe a lambda that already failed.
    lambda_policy: str = "gtsam"


def check_convergence(current: float, new: float, p: OptimizerParams) -> bool:
    """Reference NonlinearOptimizer.cpp:182 checkConvergence."""
    if new <= p.error_tol:
        return True
    delta = abs(current - new)
    return (delta <= p.absolute_error_tol
            or delta <= p.relative_error_tol * max(current, 1e-300))
