"""PyTorch/CUDA port of the NVFP4 QAD system, beside the JAX package.

The layout mirrors the JAX package module by module.  Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a hand-written CUDA kernel
for Hopper (``kernels/csrc``), built at first use.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
