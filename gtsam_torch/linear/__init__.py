"""Sparse and dense linear solvers and their kernels: the supernodal and
level-scheduled sparse Cholesky, PCG, the Kalman filters and the sparse
export (torch counterpart of gtsam_tpu.linear)."""
