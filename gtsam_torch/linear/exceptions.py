"""Typed linear-solver failures.

Counterpart of gtsam_tpu/linear/exceptions.py (reference
gtsam/linear/linearExceptions.h, thrown from splitConditional,
gtsam/linear/JacobianFactor.cpp:838).
"""


class IndeterminantLinearSystemError(RuntimeError):
    """The linearized system is singular or indefinite at a variable.

    `var` is the internal variable id (position in the solver's canonical
    variable order); -1 when the offending variable could not be localized.
    """

    def __init__(self, var: int):
        self.var = var
        super().__init__(
            f"Indeterminant linear system detected at variable {var}: "
            "the factor graph is underconstrained (missing prior / "
            "disconnected variable) or the linearization is degenerate")
