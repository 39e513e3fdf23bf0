"""Optimizers (torch counterpart of gtsam_tpu.optimize)."""
