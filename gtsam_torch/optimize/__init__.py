"""Optimizer parameters (torch counterpart of gtsam_tpu.optimize)."""
