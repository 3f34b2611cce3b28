"""Port of fscl_tpu/models."""
