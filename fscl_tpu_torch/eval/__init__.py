"""Port of fscl_tpu/eval: PER / FER metrics, DPDP decoding, the offline
evaluation drivers, few-shot task generation and the PR systems' zero-shot
transcription (`protonet_eval.py`)."""
