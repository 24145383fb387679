"""Tensor ops of the port (counterpart of gofr_tpu.ops): plain PyTorch,
with the attention and KV-append entry points and the weight-only int8
product (``quant.qdot``) handing CUDA tensors to the hand-written kernels
in ``ops/cuda``."""
