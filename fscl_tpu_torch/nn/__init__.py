"""Port of fscl_tpu/nn."""
