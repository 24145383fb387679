"""The W8A16 linear: ``qdot`` on an int8 weight (port-only).

The JAX package computes ``ops.quant.qdot`` on a ``QTensor`` as XLA (no
Pallas), which fuses the int8 convert into the operand read, so the
weight crosses device memory as int8 (gofr_tpu/ops/quant.py:61). Eager
PyTorch would write a copy of every weight in the activation's type and
read it back, so the port's product is a kernel: ``csrc/w8a16.cu``, whose
header note says what bounds it (bytes at decode and verify, operations at
prefill) and how the design answers that. Its plain version is
``ops.quant.qdot_plain``; ``ops.quant.qdot`` chooses between the two by
the activation's device.

The activation is bf16 (entry point ``gofr_w8a16``, counted as
``w8a16``: ``bf16(bf16(x @ q.T) * bf16(s))``), or f32 under an f32 model
(``gofr_w8a16_f32``, counted as ``w8a16_f32``: ``(x @ q.T) * s`` in f32,
x split into three bf16 pieces against the exact bf16 weight codes).
``plan`` picks the tiling from the shapes and the activation's element
size alone (never from the data): at most ``SMALL_M`` rows take the
weight stream, split over K when too few bands of output channels would
fill the card; more rows take the tiles: for bf16 x the wgmma tiles fed
by TMA, at the token width that fills the card's SMs best (they also take
17 to 64 bf16 rows of a weight wide enough to fill the card by its channel
tiles alone); for f32 x the mma.sync tiles. TMA and the 16-byte copies
need x and q 16-byte aligned, which the launcher checks with the rest
before any pointer reaches C.
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
# The f32 build against the f32 plain version (cuBLAS's f32 product with
# TF32 off, then the f32 scale): both sum exact products of the whole f32 x
# in f32, in different orders, so an output moves by a few f32 ulps of the
# partial sums. Limits: max |err| at most 1e-4 of max |y| and the RMS of the
# difference at most 2e-5 of the output's RMS (kernels D and F's f32
# limits, taken relative to the output's scale), no mismatch share: in f32
# most outputs differ in their last bits.
F32 = cuda.Limits(MAX_ABS=1e-4, RMS_REL=2e-5)

SMALL_M = 64          # rows served by the weight stream (8 token columns per mma)
# ... except where the bf16 tiles beat it there: past STREAM_ROWS rows, on
# a weight whose 128-channel tiles alone fill TILE_FILL_BLOCKS of the SMs
# (Llama-3-8B's gate/up and head at a verify forward's 40 rows). Both
# forced at 8..64 rows (scripts/torch_kernel_variants.py, PERF.md): on
# gate/up (112 tiles) the tiles win from 8 rows, on the head (1002) from
# 24, not at 16; on wq/wo, wk/wv (32, 8) and down (32) they lose to 40
STREAM_ROWS = 16
TILE_FILL_BLOCKS = 99     # three quarters of the card's 132 SMs
CHUNK = 64            # k a warp of the stream takes per step
BAND = 64             # output channels per stream block (4 warps x 16)
X_PAD_BYTES = 16      # padding per staged X row
X_SMEM = 48 * 1024    # bytes of X a stream block stages at once
TARGET_BLOCKS = 2 * 132   # two blocks per SM of an H100
MIN_CHUNKS = 4        # chunks a split takes at least
# The bf16 tiles (csrc/w8a16.cu GTile): a block of 128 output channels x a
# token width, one block an SM of the card's 132.
TILE_CHANNELS = 128
TILE_WIDTHS = (256, 128, 64)   # the token widths the kernel takes, widest first
TILE_BLOCK_TOKENS = 32    # a block's fixed cost (its first loads, the epilogue) in tokens of width
SMS = 132
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_TAKES = ("w8a16 takes contiguous tensors on the card: bf16 or f32 x [..., K], int8 q [N, K] "
          "and f32 s [N], with K % 16 == 0")
_ALIGNED = "w8a16 takes x and q 16-byte aligned (a view of x at an offset may not be)"
# the C entry point of each build, by the activation's type
ENTRY = {torch.bfloat16: "gofr_w8a16", torch.float32: "gofr_w8a16_f32"}


def tiles(m: int, n: int, width: int) -> int:
    """Blocks of the bf16 tiles at a token width."""
    return -(-n // TILE_CHANNELS) * -(-m // width)


def tile_width(m: int, n: int) -> int:
    """The token width of the bf16 tiles: the least waves of blocks over the
    SMs times a block's cost (its width plus ``TILE_BLOCK_TOKENS``), the
    widest on a tie."""
    return min(TILE_WIDTHS,
               key=lambda w: -(-tiles(m, n, w) // SMS) * (w + TILE_BLOCK_TOKENS))


def stream_plan(m: int, n: int, k: int, itemsize: int = 2) -> tuple[int, int, int]:
    """(splits, chunks per split, chunks staged at once) of the weight
    stream at ``m`` <= ``SMALL_M`` rows: it splits K until the bands of 64
    channels times the splits reach two blocks per SM, while each split
    keeps at least ``MIN_CHUNKS`` chunks and the f32 partials of all splits
    (written and read once) stay within a quarter of the weight's bytes; a
    stage holds as many chunks of X as ``X_SMEM`` takes at that element
    size."""
    rows = -(-m // 8) * 8
    chunks = -(-k // CHUNK)
    bands = -(-n // BAND)
    splits = max(1, min(-(-TARGET_BLOCKS // bands), chunks // MIN_CHUNKS, k // (32 * rows)))
    per_split = -(-chunks // splits)
    splits = -(-chunks // per_split)
    stage = min(per_split, (X_SMEM // rows - X_PAD_BYTES) // (CHUNK * itemsize))
    return splits, per_split, stage


@functools.lru_cache(maxsize=256)
def plan(m: int, n: int, k: int, itemsize: int = 2) -> tuple[int, int, int]:
    """The launch plan of a product of ``m`` rows, ``n`` output channels
    and depth ``k`` on activations of ``itemsize`` bytes (2 bf16, 4 f32):
    (0, token width, 0) for the tiles (the bf16 tiles' ``tile_width``; 0
    for the f32 tiles, whose width is fixed), else the weight stream's
    ``stream_plan``. The tiles take more than ``SMALL_M`` rows, and bf16
    rows past ``STREAM_ROWS`` where the weight's 128-channel tiles number
    at least ``TILE_FILL_BLOCKS``: there the tiles, bound by the weight's
    bytes as the stream is, read them faster."""
    if m > SMALL_M or (itemsize == 2 and m > STREAM_ROWS
                       and -(-n // TILE_CHANNELS) >= TILE_FILL_BLOCKS):
        return 0, (tile_width(m, n) if itemsize == 2 else 0), 0
    return stream_plan(m, n, k, itemsize)


def w8a16(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [..., K] bf16 or f32, q [N, K] int8, s [N] f32 → [..., N] in x's
    type: ``bf16(bf16(x @ q.T) * bf16(s))`` for bf16 x, ``(x @ q.T) * s``
    in f32 for f32 x. Launches the kernel, or raises."""
    n, k = q.shape
    x2 = x.reshape(-1, k) if x.shape[-1] == k else x
    cuda.require(x.is_cuda and q.is_cuda and s.is_cuda and x.dtype in ENTRY
                 and q.dtype == torch.int8 and s.dtype == torch.float32 and x2.shape[-1] == k
                 and s.shape == (n,) and k % 16 == 0 and x2.is_contiguous() and q.is_contiguous()
                 and s.is_contiguous(), _TAKES)
    cuda.require(x2.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0, _ALIGNED)
    m = x2.shape[0]
    out = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m and n:
        splits, per_split, stage = plan(m, n, k, x.element_size())
        partial = (torch.empty(splits, m, n, dtype=torch.float32, device=x.device)
                   if splits > 1 else None)
        fn = cuda.bind(ENTRY[x.dtype], _ARGTYPES)
        rc = fn(x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(), m, n, k, splits, per_split, stage,
                cuda.stream_of(x))
        counted = _COUNTED[x.dtype]
        cuda.check(rc, counted.__name__)
        counted.launches += 1
    return out if x.dim() == 2 else out.view(*x.shape[:-1], n)


def w8a16_f32(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The f32-activation build under its own name: ``w8a16`` on an f32 x
    (any other type raises), counted as ``w8a16_f32``."""
    cuda.require(x.dtype == torch.float32, f"w8a16_f32 takes an f32 x, got {x.dtype}")
    return w8a16(x, q, s)


w8a16.launches = 0
w8a16_f32.launches = 0
_COUNTED = {torch.bfloat16: w8a16, torch.float32: w8a16_f32}
