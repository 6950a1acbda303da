"""flash_vstream_tpu_torch: the PyTorch and CUDA port of flash_vstream_tpu.

The JAX package stays the reference; this package mirrors its layout
(kernels/, models/, ops/, preprocess/, runtime/, weights/) and runs on one
NVIDIA Hopper card, with the TPU's Pallas kernels rewritten as CUDA C++
kernels under kernels/csrc/. It imports no JAX.
"""
