"""Port of fscl_tpu/systems."""
