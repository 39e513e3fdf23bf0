"""Orderings and supernodal symbolic analysis (torch counterpart of gtsam_tpu.inference)."""
