"""Port of fscl_tpu/train."""
