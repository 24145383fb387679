"""Kernels D and E's split over the sequence, held against the JAX package.

Decode over the int8 and int4 pools on the card cuts the MaxP x page
positions of each slot's table row into runs of ``split_rows``, takes each
run's (max, sum, unnormalised output) on its own and merges the live runs
(gofr_tpu_torch/csrc/paged_decode_q.cu with split_merge.cuh). The
arithmetic is repeated in PyTorch by
``gofr_tpu_torch.ops.attention.paged_decode_attention_q_split_plain``; here
it is held against the JAX Pallas ``paged_decode_attention_q`` and ``_q4``
(interpret mode, as tests/test_torch_quant.py runs them) and against the
port's unsplit plain version. Pools hold rows quantized by the JAX
quantizers; tables list pages in scrambled order with OOB entries (== P,
read as page P-1); pages of 40 rows (not a multiple of the kernels' 64-row
tile) and of 128; lanes of length 0, on and one past the first two split
boundaries, MaxP x page, and past the table.

Tolerances:
- f32 q: 1e-5 against both (only the order of the f32 sums differs; the
  unsplit plain version rounds nothing at f32);
- bf16 q: 1.6e-2 absolute, tests/test_torch_quant.py's. Against Pallas,
  which also keeps scores and p * vs in f32, the outputs (up to ~2) differ
  by at most one bf16 ulp from the order of the sums (7.8e-3 in [1, 2));
  against the unsplit plain version, which rounds scores and p * vs to
  bf16 as the JAX XLA path does, by a few ulps of the small outputs. The
  limit is two ulps in [1, 2).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 1e-5
BF16_TOL = 1.6e-2
SPAN = 640      # MaxP x page: past 2 x 256 + 1, a multiple of neither 64-row tile nor 256
HKV, D = 2, 16


def _port(a):
    from gofr_tpu_torch.models.llama import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _case(bits, group, page, split_rows):
    """q (f32), K/V value planes and scales, table and lengths, as numpy:
    a pool of 2 x MaxP pages, tables drawn in scrambled order with
    repeats, an OOB entry inside two live lanes, the empty lane's row all
    OOB; lanes of length 0, r, r + 1, 2r, 2r + 1, MaxP x page and past it."""
    from gofr_tpu.ops import kvcache as jax_kv, quant as jax_quant

    rng = np.random.default_rng(1000 * bits + 10 * group + page)
    maxp = SPAN // page
    pool = 2 * maxp

    def plane():
        rows = jnp.asarray(rng.standard_normal((pool, HKV, page, D)).astype(np.float32))
        if bits == 8:
            vals, scales = jax_kv.quantize_row(rows)
        else:
            vals, scales = jax_quant.quantize_row_int4(rows)
            vals = jax_quant.pack_int4(vals)
        return np.asarray(vals), np.asarray(scales.astype(jnp.bfloat16))

    (kq, ks), (vq, vs) = plane(), plane()
    r = split_rows
    lengths = np.array([0, r, r + 1, 2 * r, 2 * r + 1, SPAN, SPAN + 5], np.int32)
    table = rng.integers(0, pool, (len(lengths), maxp)).astype(np.int32)
    table[0] = pool
    table[2, 1] = pool
    table[5, maxp - 1] = pool
    q = rng.standard_normal((len(lengths), HKV * group, D)).astype(np.float32)
    return q, kq, vq, ks, vs, table, lengths


@functools.lru_cache(maxsize=None)
def _pallas(bits, group, page, split_rows, dtype):
    """The Pallas kernel's output (f32 numpy) on ``_case``'s inputs."""
    from gofr_tpu.ops.pallas import paged_decode as pallas

    kernel = pallas.paged_decode_attention_q if bits == 8 else pallas.paged_decode_attention_q4
    q, *rest = _case(bits, group, page, split_rows)
    jq = jnp.asarray(q) if dtype == "f32" else jnp.asarray(q).astype(jnp.bfloat16)
    out = kernel(jq, *(jnp.asarray(a) for a in rest), interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.quick
@pytest.mark.parametrize("page", [40, 128])
@pytest.mark.parametrize("split_rows", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("bits", [8, 4])
def test_split_and_merge_matches_pallas_and_the_unsplit_plain_version(bits, group, split_rows, page):
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_q4_plain,
        paged_decode_attention_q_plain,
        paged_decode_attention_q_split_plain,
    )

    plain = paged_decode_attention_q_plain if bits == 8 else paged_decode_attention_q4_plain
    q, *pools, table, lengths = _case(bits, group, page, split_rows)
    pools, table, lengths = [_port(a) for a in pools], _port(table), _port(lengths)
    for dtype, tol in (("f32", F32_TOL), ("bf16", BF16_TOL)):
        tq = _port(q) if dtype == "f32" else _port(q).to(torch.bfloat16)
        got = paged_decode_attention_q_split_plain(tq, *pools, table, lengths, split_rows, bits=bits)
        assert got.shape == tq.shape and got.dtype == tq.dtype
        assert torch.isfinite(got.float()).all()
        assert torch.all(got[0] == 0)  # the empty slot
        # a length past the table attends to the whole table row, as at MaxP x page
        whole = paged_decode_attention_q_split_plain(tq, *pools, table, lengths.clamp(max=SPAN),
                                                     split_rows, bits=bits)
        torch.testing.assert_close(got[6], whole[6], rtol=0, atol=0)
        want_plain = plain(tq, *pools, table, lengths).float().numpy()
        for want in (_pallas(bits, group, page, split_rows, dtype), want_plain):
            np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                       rtol=F32_TOL if dtype == "f32" else 0)


@pytest.mark.quick
def test_split_plan_at_the_pool_shapes():
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan

    # a table row of 16 pages of 128: phase 3's 9 lanes and the engine's 8 slots
    assert split_plan(9, 8, 16 * 128) == (192, 11)
    assert split_plan(8, 8, 16 * 128) == (128, 16)
    # the profile's pool (17 pages a row) and the split tests' rows
    assert split_plan(8, 8, 17 * 128) == (192, 12)
    for n, hkv, span in ((7, HKV, SPAN), (3, 2, 256), (1, 8, 2048), (64, 8, 2048)):
        split_rows, splits = split_plan(n, hkv, span)
        assert split_rows % 64 == 0 and splits * split_rows >= span
        assert (splits - 1) * split_rows < span
