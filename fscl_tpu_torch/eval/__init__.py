"""Port of fscl_tpu/eval: DPDP segmentation (the rest waits for ROADMAP item 10)."""
