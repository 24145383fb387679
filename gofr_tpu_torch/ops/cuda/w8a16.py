"""The W8A16 linear: ``qdot`` on an int8 weight (port-only).

The JAX package computes ``ops.quant.qdot`` on a ``QTensor`` as XLA (no
Pallas), which fuses the int8→bf16 convert into the operand read, so the
weight crosses device memory as int8 (gofr_tpu/ops/quant.py:52). Eager
PyTorch would write a bf16 copy of every weight and read it back, so the
port's product is a kernel: ``csrc/w8a16.cu``, whose header note says
what bounds it (bytes at decode and verify, operations at prefill) and how
the design answers that. Its plain version is ``ops.quant.qdot_plain``;
``ops.quant.qdot`` chooses between the two by the activation's device.

``plan`` picks the tiling from the shapes alone (never from the data):
at most ``SMALL_M`` rows take the weight stream, split over K when too few
bands of output channels would fill the card; more rows take the tiles.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gofr_tpu_torch.ops import cuda

# Agreement with the plain version on the same inputs. Both sum the
# products in f32 (in different orders) and round twice to bf16, so an
# output differs only where its f32 sum lies next to a rounding boundary
# of bf16(acc); there it moves by one or two bf16 ulps of itself, under
# 2^-7 of its value. Limits: max |err| at most 1% of max |y|, the RMS of
# the difference at most 2e-3 of the output's RMS, and at most 1% of the
# outputs not bit-equal to the plain version's (a kernel that skips one of
# the two roundings changes about half of them by an ulp).
MAX_REL = 1e-2
RMS_REL = 2e-3
MISMATCH_SHARE = 1e-2

SMALL_M = 64          # rows served by the weight stream (8 token columns per mma)
CHUNK = 64            # k a warp of the stream takes per step
BAND = 64             # output channels per stream block (4 warps x 16)
X_PAD = 8             # bf16 of padding per staged X row
X_SMEM = 48 * 1024    # bytes of X a stream block stages at once
TARGET_BLOCKS = 2 * 132   # two blocks per SM of an H100
MIN_CHUNKS = 4        # chunks a split takes at least
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TAKES = ("w8a16 takes contiguous tensors on the card: bf16 x [..., K], int8 q [N, K] and "
          "f32 s [N], with K % 16 == 0")


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int) -> tuple[int, int, int]:
    """(splits, chunks per split, chunks staged at once) of a product of
    ``m`` rows, ``n`` output channels and depth ``k``; ``splits`` 0 means
    the tile kernel. The stream splits K until the bands of 64 channels
    times the splits reach two blocks per SM, while each split keeps at
    least ``MIN_CHUNKS`` chunks and the f32 partials of all splits (written
    and read once) stay within a quarter of the weight's bytes."""
    if m > SMALL_M:
        return 0, 0, 0
    rows = -(-m // 8) * 8
    chunks = -(-k // CHUNK)
    bands = -(-n // BAND)
    splits = max(1, min(-(-TARGET_BLOCKS // bands), chunks // MIN_CHUNKS, k // (32 * rows)))
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)
    stage = min(per_split, (X_SMEM // (2 * rows) - X_PAD) // CHUNK)
    return splits, per_split, stage


def w8a16(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [..., K] bf16, q [N, K] int8, s [N] f32 → [..., N] bf16:
    ``bf16(bf16(x @ q.T) * bf16(s))``. Launches the kernel, or raises."""
    n, k = q.shape
    x2 = x.reshape(-1, k) if x.shape[-1] == k else x
    cuda.require(x.is_cuda and q.is_cuda and s.is_cuda and x.dtype == torch.bfloat16
                 and q.dtype == torch.int8 and s.dtype == torch.float32 and x2.shape[-1] == k
                 and s.shape == (n,) and k % 16 == 0 and x2.is_contiguous() and q.is_contiguous()
                 and s.is_contiguous(), _TAKES)
    m = x2.shape[0]
    out = torch.empty(m, n, dtype=torch.bfloat16, device=x.device)
    if m and n:
        splits, per_split, stage = plan(m, n, k)
        partial = (torch.empty(splits, m, n, dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        fn = cuda.bind("gofr_w8a16", _ARGTYPES)
        rc = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(), m, n, k, splits, per_split, stage,
                cuda.stream_of(x))
        cuda.check(rc, "w8a16")
        w8a16.launches += 1
    return out if x.dim() == 2 else out.view(*x.shape[:-1], n)


w8a16.launches = 0
