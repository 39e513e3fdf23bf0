"""Trajectory metrics (torch counterpart of gtsam_tpu.utils)."""
