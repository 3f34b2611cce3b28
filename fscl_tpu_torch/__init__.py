"""fscl_tpu_torch: the PyTorch/CUDA port of fscl_tpu for NVIDIA Hopper.

The package mirrors `fscl_tpu`'s layout: each module sits at the same
relative path as the JAX module it ports, and is held to it by the
`tests/test_torch_*.py` parity tests. It imports torch, numpy and yaml,
never JAX or anything of `fscl_tpu`.

Entry points run on `cuda` unless the caller passes `device="cpu"`.
Kernels written for Hopper live under `csrc/` and are built with `nvcc` at
first use; on CPU tensors each op runs its plain PyTorch version instead.
"""
