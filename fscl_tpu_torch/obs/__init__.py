"""Port of fscl_tpu/obs."""
