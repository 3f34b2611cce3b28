"""Port of fscl_tpu/ops."""
