"""Kernel A's split over the sequence, held against the JAX package.

Decode over the bf16 page pool on the card cuts the MaxP x page positions
of each slot's table row into runs of ``split_rows``, takes each run's
(max, sum, unnormalised output) on its own and merges the live runs
(gofr_tpu_torch/csrc/paged_decode_q.cu with split_merge.cuh). The
arithmetic is repeated in PyTorch by
``gofr_tpu_torch.ops.attention.paged_decode_attention_split_plain``; here
it is held against the JAX Pallas ``paged_decode_attention`` (interpret
mode, as tests/test_torch_ops.py runs it) and against the port's unsplit
plain version. Tables list pages in scrambled order with repeats and OOB
entries (== P, read as page P-1); pages of 40 rows (not a multiple of the
kernel's 64-row tile) and of 128; lanes of length 0, on and one past the
first two split boundaries, MaxP x page, and past the table. The launcher
is checked on the CPU without a launch: its argument list against the C
entry point's, and the split it passes.

Tolerances:
- f32: 1e-5 against both (only the order of the f32 sums differs; at f32
  no one rounds the probabilities);
- bf16: 1.6e-2 absolute, tests/test_torch_split_decode.py's. Against
  Pallas, which also keeps the scores in f32, the split version rounds each
  run's probabilities to bf16 against that run's own max where Pallas
  rounds against the running max of each page; against the unsplit plain
  version, which rounds the scores to bf16 as the JAX XLA path does. Either
  moves outputs of up to ~2 by at most one bf16 ulp (7.8e-3 in [1, 2)); the
  limit is two ulps.
"""

import ctypes
import functools
import re

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
def _case(group, page, split_rows):
    """q, K/V pools, table and lengths (f32 numpy): a pool of 2 x MaxP
    pages, tables drawn in scrambled order with repeats, an OOB entry
    inside two live lanes, the empty lane's row all OOB; lanes of length 0,
    r, r + 1, 2r, 2r + 1, MaxP x page and past it."""
    rng = np.random.default_rng(100 * group + page + split_rows)
    maxp = SPAN // page
    pool = 2 * maxp
    k_pool, v_pool = (rng.standard_normal((pool, HKV, page, D)).astype(np.float32) for _ in range(2))
    r = split_rows
    lengths = np.array([0, r, r + 1, 2 * r, 2 * r + 1, SPAN, SPAN + 5], np.int32)
    table = rng.integers(0, pool, (len(lengths), maxp)).astype(np.int32)
    table[0] = pool
    table[2, 1] = pool
    table[5, maxp - 1] = pool
    table[4, 1] = table[4, 0]  # a page read twice in one lane
    q = rng.standard_normal((len(lengths), HKV * group, D)).astype(np.float32)
    return q, k_pool, v_pool, table, lengths


@functools.lru_cache(maxsize=None)
def _pallas(group, page, split_rows, dtype):
    """The Pallas kernel's output (f32 numpy) on ``_case``'s inputs."""
    from gofr_tpu.ops.pallas.paged_decode import paged_decode_attention

    q, k_pool, v_pool, table, lengths = _case(group, page, split_rows)
    cast = jnp.asarray if dtype == "f32" else (lambda a: jnp.asarray(a).astype(jnp.bfloat16))
    out = paged_decode_attention(cast(q), cast(k_pool), cast(v_pool), jnp.asarray(table),
                                 jnp.asarray(lengths), interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("page", [40, 128])
@pytest.mark.parametrize("split_rows", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_split_and_merge_matches_pallas_and_the_unsplit_plain_version(group, split_rows, page, dtype):
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_plain,
        paged_decode_attention_split_plain,
    )

    q, k_pool, v_pool, table, lengths = _case(group, page, split_rows)
    cast = _port if dtype == "f32" else (lambda a: _port(a).to(torch.bfloat16))
    tq, tk, tv = cast(q), cast(k_pool), cast(v_pool)
    table, lengths = _port(table), _port(lengths)
    got = paged_decode_attention_split_plain(tq, tk, tv, table, lengths, split_rows)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert torch.isfinite(got.float()).all()
    assert torch.all(got[0] == 0)  # the empty slot
    # a length past the table attends to the whole table row, as at MaxP x page
    whole = paged_decode_attention_split_plain(tq, tk, tv, table, lengths.clamp(max=SPAN), split_rows)
    torch.testing.assert_close(got[6], whole[6], rtol=0, atol=0)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    want_plain = paged_decode_attention_plain(tq, tk, tv, table, lengths).float().numpy()
    for want in (_pallas(group, page, split_rows, dtype), want_plain):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=F32_TOL if dtype == "f32" else 0)


@pytest.mark.quick
def test_launchers_declare_the_c_entry_points_arguments():
    """Each launcher's ctypes argument list has its C entry point's arity
    and types, read from the sources (a mismatch would pass pointers in the
    wrong slots on the card)."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import (
        decode_attention,
        flash_attention,
        kv_append,
        paged_decode,
        paged_decode_q,
    )

    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
               "float": ctypes.c_float}
    source = "".join(p.read_text() for p in cuda.sources())
    declared = {name: [c_types[" ".join(p.split()[:-1])] for p in params.split(",")]
                for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source)}
    assert declared == {
        "gofr_paged_decode": paged_decode._ARGTYPES,
        "gofr_paged_decode_q": paged_decode_q._ARGTYPES,
        "gofr_paged_decode_q4": paged_decode_q._ARGTYPES,
        "gofr_decode_attention": decode_attention._ARGTYPES,
        "gofr_flash_attention": flash_attention._ARGTYPES,
        "gofr_kv_append": kv_append._ARGTYPES,
        "gofr_kv_append_slot": kv_append._SLOT_ARGTYPES,
        "gofr_kv_append_q": kv_append._Q_ARGTYPES,
        "gofr_kv_append_q4": kv_append._Q_ARGTYPES,
        "gofr_kv_append_slot_q": kv_append._SLOT_Q_ARGTYPES,
    }


@pytest.mark.quick
def test_launcher_passes_the_split_plan_and_its_scratch(monkeypatch):
    """Kernel A's launcher at phase 3's shapes (9 lanes, Hq 32, Hkv 8, a
    table row of 16 pages of 128), its checks and the C call stubbed out:
    it passes split_plan's 192 rows x 11 splits and allocates N x Hq x
    splits x (D + 2) floats of scratch."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import paged_decode as mod
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan

    calls, allocated = [], []
    empty = torch.empty

    def spy_empty(*shape, **kw):
        allocated.append(shape)
        return empty(*shape, **kw)

    monkeypatch.setattr(cuda, "require", lambda cond, msg: None)
    monkeypatch.setattr(cuda, "bind", lambda name, argtypes: (
        calls.append((name, argtypes)), lambda *args: calls.append(args) or 0)[1])
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(mod.torch, "empty", spy_empty)
    monkeypatch.setattr(mod.paged_decode, "launches", 0)
    q = torch.zeros(9, 32, 128, dtype=torch.bfloat16)
    pool = torch.zeros(2, 8, 128, 128, dtype=torch.bfloat16)
    mod.paged_decode(q, pool, pool, torch.zeros(9, 16, dtype=torch.int32),
                     torch.zeros(9, dtype=torch.int32))
    (name, argtypes), args = calls
    assert name == "gofr_paged_decode" and len(args) == len(argtypes)
    n, hkv, group, _, page, maxp, split_rows, splits = args[7:15]
    assert (n, hkv, group, page, maxp) == (9, 8, 4, 128, 16)
    assert (split_rows, splits) == split_plan(9, 8, 16 * 128) == (192, 11)
    assert allocated == [(9 * 32 * 11 * (128 + 2),)]
    assert mod.paged_decode.launches == 1


@pytest.mark.cuda
def test_kernel_matches_the_split_plain_version_on_the_card():
    """Kernel A on split-boundary lanes through scrambled tables with
    repeats and OOB entries, pages of 16, 40 and 128, held to its launcher's
    limits against the split plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops.attention import paged_decode_attention_split_plain
    from gofr_tpu_torch.ops.cuda import paged_decode as mod
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    for page, maxp in ((16, 40), (40, 16), (128, 5)):
        pool, n = 2 * maxp, 7
        k_pool = torch.randn(pool, 8, page, 128, device=dev, generator=g).to(bf)
        v_pool = torch.randn(pool, 8, page, 128, device=dev, generator=g).to(bf)
        r, _ = split_plan(n, 8, maxp * page)
        lengths = torch.tensor([0, r, r + 1, 2 * r, 2 * r + 1, maxp * page, maxp * page + 5],
                               device=dev, dtype=torch.int32)
        table = torch.randint(0, pool, (n, maxp), device=dev, generator=g, dtype=torch.int32)
        table[0], table[2, 1], table[5, maxp - 1] = pool, pool, pool
        q = torch.randn(n, 32, 128, device=dev, generator=g).to(bf)
        got = mod.paged_decode(q, k_pool, v_pool, table, lengths)
        want = paged_decode_attention_split_plain(q, k_pool, v_pool, table, lengths, r)
        diff = got.float() - want.float()
        assert diff.abs().max().item() <= mod.MAX_ABS
        assert (diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()).item() <= mod.RMS_REL
        assert torch.all(got[0] == 0)
