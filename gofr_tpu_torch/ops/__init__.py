"""Tensor ops of the port (counterpart of gofr_tpu.ops): plain PyTorch,
with the attention and KV-append entry points handing CUDA tensors to the
hand-written kernels in ``ops/cuda``."""
