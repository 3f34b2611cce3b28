"""Port of fscl_tpu/dsp (the audio IO so far)."""
