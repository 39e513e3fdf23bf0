"""Manifolds, values, factor batches and graphs (torch counterpart of gtsam_tpu.graph)."""
