"""Port of fscl_tpu/dsp: audio IO, TextGrids, host and batched pitch, and the
preprocessing pipeline."""
