"""Port of fscl_tpu/audio_out: vocoders, text -> wav and streaming."""
