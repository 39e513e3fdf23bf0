"""Noise models (torch counterpart of gtsam_tpu.base)."""
