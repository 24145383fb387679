"""Kernel F's split over the sequence, held against the JAX package.

Slot decode on the card cuts each slot into runs of ``split_rows``
positions, takes each run's (max, sum, unnormalised output) on its own and
merges the live runs (gofr_tpu_torch/csrc/paged_decode.cu). The merge's
arithmetic is repeated in PyTorch by
``gofr_tpu_torch.ops.attention.decode_attention_split_plain``; here it is
held against the JAX Pallas ``decode_attention`` (interpret mode, as
tests/test_pallas.py runs it) and against the port's own unsplit plain
version, on lengths at and one past the split boundaries, the empty slot,
the whole slot and past the slot. The host's choice of the split is a pure
function of the shapes, tested on its own.

Tolerances:
- f32 inputs: 1e-5 (only the order of the f32 sums differs);
- bf16 inputs: 1.6e-2 absolute, tests/test_torch_slot.py's: the split
  version keeps the scores in f32 like the Pallas kernel and rounds each
  run's probabilities to bf16 against that run's own max, which moves
  outputs of up to ~1 by at most one bf16 ulp (7.8e-3 in [1, 2)); the
  limit is two ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 1e-5
BF16_TOL = 1.6e-2
SMAX = 600  # not a multiple of the 64-row tile, past 2 x 256


def _port(a):
    from gofr_tpu_torch.models.llama import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a))


def _case(group, split_rows, dtype):
    """Lanes of length 0, one split, one past it, two splits, one past
    those, Smax and Smax + 5, over a [7, 2, SMAX, 16] slot cache."""
    rng = np.random.default_rng(split_rows + group)
    hkv, d = 2, 16
    lengths = np.array([0, split_rows, split_rows + 1, 2 * split_rows, 2 * split_rows + 1,
                        SMAX, SMAX + 5], np.int32)
    n = len(lengths)
    q = rng.standard_normal((n, hkv * group, d)).astype(np.float32)
    k, v = (rng.standard_normal((n, hkv, SMAX, d)).astype(np.float32) for _ in range(2))
    cast = (lambda a: jnp.asarray(a)) if dtype == "f32" else (lambda a: jnp.asarray(a).astype(jnp.bfloat16))
    return tuple(cast(a) for a in (q, k, v)), jnp.asarray(lengths)


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("split_rows", [64, 128, 256])
def test_split_and_merge_matches_pallas_and_the_unsplit_plain_version(split_rows, group, dtype):
    from gofr_tpu.ops.pallas.decode_attention import decode_attention as pallas_decode
    from gofr_tpu_torch.ops.attention import decode_attention_plain, decode_attention_split_plain

    (jq, jk, jv), jlen = _case(group, split_rows, dtype)
    q, k, v, lengths = (_port(a) for a in (jq, jk, jv, jlen))
    got = decode_attention_split_plain(q, k, v, lengths, split_rows)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.isfinite(got.float()).all()
    assert torch.all(got[0] == 0)  # the empty slot
    # a length past the slot attends to the whole slot, as at Smax
    whole = decode_attention_split_plain(q, k, v, lengths.clamp(max=SMAX), split_rows)
    torch.testing.assert_close(got[6], whole[6], rtol=0, atol=0)
    pallas = np.asarray(pallas_decode(jq, jk, jv, jlen, interpret=True)).astype(np.float32)
    plain = decode_attention_plain(q, k, v, lengths).float().numpy()
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    for want in (pallas, plain):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=F32_TOL if dtype == "f32" else 0)


@pytest.mark.quick
def test_split_plan_is_a_function_of_the_shapes():
    from gofr_tpu_torch.ops.cuda.decode_attention import SPLIT_BLOCKS, TILE, split_plan

    # the engine's slot cache (8 slots, Hkv 8, Smax 2176) and phase 3's (9 lanes)
    assert split_plan(8, 8, 2176) == (192, 12)
    assert split_plan(9, 8, 2176) == (192, 12)
    for n, hkv, smax in ((1, 8, 2176), (8, 8, 2176), (9, 8, 2176), (64, 8, 2176), (256, 8, 2176),
                         (4, 2, 40), (1, 1, 1), (3, 2, 300), (8, 8, 8192), (2, 8, 0)):
        split_rows, splits = split_plan(n, hkv, smax)
        assert split_rows % TILE == 0 and split_rows >= TILE
        assert splits >= 1 and splits * split_rows >= smax
        assert (splits - 1) * split_rows < max(smax, 1)  # no split lies wholly past the slot
        # at most one tile's worth of blocks over the target, unless one split per lane is it
        assert splits == 1 or n * hkv * splits <= SPLIT_BLOCKS + n * hkv
    # many lanes need no split: the grid is full without one
    assert split_plan(256, 8, 2176) == (2176, 1)
    # the choice never reads lengths: same shapes, same plan
    assert split_plan(9, 8, 2176) == split_plan(9, 8, 2176)
