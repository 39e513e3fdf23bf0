"""Pose-graph initialization (torch counterpart of gtsam_tpu.slam)."""
