"""Lie groups and cameras (torch counterparts of gtsam_tpu.geometry)."""
