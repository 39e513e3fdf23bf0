"""Bearing, range and bearing-range factors (torch counterpart of
gtsam_tpu.sam)."""
