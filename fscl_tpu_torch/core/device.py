"""Device selection for the port's entry points, and the port's float32
precision on the card.

fscl_tpu computes float32 convolutions and products in full float32 (XLA
on the CPU). Torch's default on a CUDA device runs float32 cuDNN
convolutions in TF32 (`torch.backends.cudnn.allow_tf32` is True), which
keeps about three decimal digits: the PostNet, the variance predictors, the
HuBERT extractor, the vocoder's transposed convs and DIO's band filters
would all move. So `resolve_device` turns TF32 off for cuDNN and for cuBLAS
whenever it hands out a CUDA device, and every entry point that takes a
device goes through it. The attention and MRF stage kernels choose their own
split-TF32 routes; these flags do not reach them.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def use_f32_precision() -> None:
    """Full float32 for cuDNN convolutions and cuBLAS products."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`cuda` unless the caller names another device. Asking for CUDA on a
    machine without it raises: the port never carries on quietly on the
    CPU. A CUDA device comes with TF32 off (`use_f32_precision`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions on the CPU")
        use_f32_precision()
    return dev
