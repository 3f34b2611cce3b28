"""Port of fscl_tpu/data."""
