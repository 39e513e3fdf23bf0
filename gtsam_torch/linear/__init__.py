"""The supernodal sparse Cholesky and its kernels (torch counterpart of gtsam_tpu.linear)."""
