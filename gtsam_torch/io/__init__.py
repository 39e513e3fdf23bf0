"""Dataset input (torch counterpart of gtsam_tpu.io)."""
