"""Head dim 64 in the port's decode kernels and appends, held against the
JAX package.

GPT-2 (768 / 12 heads) and Llama ``one_b`` (2048 / 32 heads) run at head
dim 64. On the card, kernels A (paged decode), B (paged append), F (slot
decode) and G (slot append) are built at 64 as well as 128
(``csrc/paged_decode_q.cu``, ``paged_decode.cu``, ``kv_append.cu``); here
their split plain versions and appends, which repeat the kernels'
arithmetic in PyTorch, are held against the Pallas kernels at D 64
(interpret mode, as the JAX tests run them), and a Llama of head dim 64
serves the JAX paged engine's tokens. The launchers are checked without a
launch: the 64 call binds the ``_d64`` entry point and counts under the
``_d64`` name. The ``cuda``-marked tests hold each 64 build against its
plain version on the card. The quantized caches' kernels at 64 (D, E,
B-q, B-q4, G-q) and the card's refusals are held in
tests/test_torch_quantized_d64.py.

Tolerances:
- decode attention, f32: 1e-5 (only the order of the f32 sums differs);
- decode attention, bf16: 1.6e-2 absolute, tests/test_torch_split_decode
  _paged.py's: the split version rounds each run's probabilities to bf16
  against that run's own max, Pallas against the running max, which moves
  outputs of up to ~2 by at most one bf16 ulp (7.8e-3 in [1, 2)); the
  limit is two ulps;
- appends: bit for bit;
- greedy tokens: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 1e-5
BF16_TOL = 1.6e-2
D = 64
HKV = 2
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6]]


def _port(a):
    from gofr_tpu_torch.models.llama import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a))


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _cast_jax(dtype):
    return jnp.asarray if dtype == "f32" else (lambda a: jnp.asarray(a).astype(jnp.bfloat16))


def _cast_port(dtype):
    return _port if dtype == "f32" else (lambda a: _port(a).to(torch.bfloat16))


# -- decode attention at D 64: A's and F's split plain versions ---------------------------


@functools.lru_cache(maxsize=None)
def _paged_case(group, page, split_rows):
    """q, K/V pools of head dim 64, a scrambled table with repeats and OOB
    entries (== P), and ragged lengths: 0, on and one past the first two
    split boundaries, the whole table row, past it."""
    rng = np.random.default_rng(7000 + 100 * group + page + split_rows)
    span = 640
    maxp = span // page
    pool = 2 * maxp
    k_pool, v_pool = (rng.standard_normal((pool, HKV, page, D)).astype(np.float32) for _ in range(2))
    r = split_rows
    lengths = np.array([0, r, r + 1, 2 * r, 2 * r + 1, span, span + 5, 37], np.int32)
    table = rng.integers(0, pool, (len(lengths), maxp)).astype(np.int32)
    table[0] = pool
    table[2, 1] = pool
    table[4, 1] = table[4, 0]
    q = rng.standard_normal((len(lengths), HKV * group, D)).astype(np.float32)
    return q, k_pool, v_pool, table, lengths


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("page", [40, 128])
@pytest.mark.parametrize("split_rows", [64, 192])
@pytest.mark.parametrize("group", [1, 8])
def test_paged_decode_split_plain_at_d64_matches_pallas(group, split_rows, page, dtype):
    """Kernel A's arithmetic at D 64 (``one_b``: group 8, page 128) against
    the Pallas ``paged_decode_attention`` and the unsplit plain version."""
    from gofr_tpu.ops.pallas.paged_decode import paged_decode_attention as pallas_paged
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_plain,
        paged_decode_attention_split_plain,
    )

    q, k_pool, v_pool, table, lengths = _paged_case(group, page, split_rows)
    jc, pc = _cast_jax(dtype), _cast_port(dtype)
    want = np.asarray(pallas_paged(jc(q), jc(k_pool), jc(v_pool), jnp.asarray(table),
                                   jnp.asarray(lengths), interpret=True).astype(jnp.float32))
    tq, tk, tv, tt, tl = pc(q), pc(k_pool), pc(v_pool), _port(table), _port(lengths)
    got = paged_decode_attention_split_plain(tq, tk, tv, tt, tl, split_rows)
    assert got.shape == tq.shape and torch.all(got[0] == 0)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rtol = F32_TOL if dtype == "f32" else 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=rtol)
    plain = paged_decode_attention_plain(tq, tk, tv, tt, tl).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), plain, atol=tol, rtol=rtol)


@functools.lru_cache(maxsize=None)
def _slot_case(group, smax):
    """q and slot-cache layer slices [N, Hkv, Smax, 64]; lengths 0, short,
    on and past split boundaries, Smax and past it."""
    rng = np.random.default_rng(7100 + group + smax)
    k, v = (rng.standard_normal((7, HKV, smax, D)).astype(np.float32) for _ in range(2))
    lengths = np.array([0, 13, 64, 65, 129, smax, smax + 9], np.int32)
    q = rng.standard_normal((7, HKV * group, D)).astype(np.float32)
    return q, k, v, lengths


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("split_rows", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
def test_slot_decode_split_plain_at_d64_matches_pallas(group, split_rows, dtype):
    """Kernel F's arithmetic at D 64 (GPT-2: group 1) against the Pallas
    ``decode_attention`` and the unsplit plain version. A length past the
    slot is clamped to Smax by the split version, as by the kernel; Pallas
    and the unsplit version mask by position, which reads the same rows."""
    from gofr_tpu.ops.pallas.decode_attention import decode_attention as pallas_decode
    from gofr_tpu_torch.ops.attention import decode_attention_plain, decode_attention_split_plain

    smax = 200  # not a multiple of the 64-row tile
    q, k, v, lengths = _slot_case(group, smax)
    jc, pc = _cast_jax(dtype), _cast_port(dtype)
    want = np.asarray(pallas_decode(jc(q), jc(k), jc(v), jnp.asarray(lengths), block_kv=40,
                                    interpret=True).astype(jnp.float32))
    tq, tk, tv, tl = pc(q), pc(k), pc(v), _port(lengths)
    got = decode_attention_split_plain(tq, tk, tv, tl, split_rows)
    assert got.shape == tq.shape and torch.all(got[0] == 0)
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    rtol = F32_TOL if dtype == "f32" else 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=rtol)
    plain = decode_attention_plain(tq, tk, tv, tl).float().numpy()
    np.testing.assert_allclose(got.float().numpy(), plain, atol=tol, rtol=rtol)


# -- the appends at D 64, bit for bit ----------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_paged_append_at_d64_is_bit_exact_against_pallas(dtype):
    """B at D 64: a mid-page write, a page's first row, an OOB entry, a
    position past the table and a negative one (the port drops the last
    three, as the Pallas kernel does)."""
    from gofr_tpu.ops.pallas.kv_append import append_tokens_paged_inplace
    from gofr_tpu_torch.ops.paged import append_tokens_paged

    rng = np.random.default_rng(7200)
    pool, page, maxp = 12, 8, 4
    k_pool, v_pool = (rng.standard_normal((pool, HKV, page, D)).astype(np.float32) for _ in range(2))
    # page 0 is the TPU kernel's reserved sink: keep it out of every table
    table = rng.integers(1, pool, (5, maxp)).astype(np.int32)
    positions = np.array([17, 8, 12, 40, -1], np.int32)
    table[2, 1] = pool
    k_new, v_new = (rng.standard_normal((5, HKV, D)).astype(np.float32) for _ in range(2))
    jc, pc = _cast_jax(dtype), _cast_port(dtype)
    wk, wv = append_tokens_paged_inplace(jc(k_pool), jc(v_pool), jnp.asarray(table),
                                         jnp.asarray(positions), jc(k_new), jc(v_new),
                                         interpret=True)
    gk, gv = pc(k_pool), pc(v_pool)
    out = append_tokens_paged(gk, gv, _port(table), _port(positions), pc(k_new), pc(v_new))
    assert out[0] is gk and out[1] is gv
    np.testing.assert_array_equal(_bits(gk), _bits(wk))
    np.testing.assert_array_equal(_bits(gv), _bits(wv))
    assert not np.array_equal(_bits(gk), _bits(jc(k_pool)))


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slot_append_at_d64_is_bit_exact_against_pallas(dtype, monkeypatch):
    """G at D 64 inside the slot (mid-tile, first and last row, a tile
    boundary) against the Pallas kernel, and outside it (Smax, -1, past)
    against the select lowering, which drops them as the port does."""
    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu.ops.pallas.kv_append import append_tokens_inplace
    from gofr_tpu_torch.ops.kvcache import append_tokens

    monkeypatch.delenv("GOFR_KV_WRITE", raising=False)  # the select lowering
    rng = np.random.default_rng(7300)
    smax = 40
    k, v = (rng.standard_normal((4, HKV, smax, D)).astype(np.float32) for _ in range(2))
    k_new, v_new = (rng.standard_normal((4, HKV, D)).astype(np.float32) for _ in range(2))
    jc, pc = _cast_jax(dtype), _cast_port(dtype)
    for positions, jax_write in (
            (np.array([17, 0, smax - 1, 8], np.int32),
             lambda *a: append_tokens_inplace(*a, block_s=8, interpret=True)),
            (np.array([smax, -1, smax + 5, 3], np.int32), jax_kv.append_tokens)):
        wk, wv = jax_write(jc(k), jc(v), jnp.asarray(positions), jc(k_new), jc(v_new))
        gk, gv = pc(k), pc(v)
        append_tokens(gk, gv, _port(positions), pc(k_new), pc(v_new))
        np.testing.assert_array_equal(_bits(gk), _bits(wk))
        np.testing.assert_array_equal(_bits(gv), _bits(wv))


# -- a Llama of head dim 64 on the paged pool ------------------------------------------------


@pytest.fixture(scope="module")
def llama64():
    """``LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2)``:
    head dim 64, as ``one_b``; JAX weights (key 13) and the port's model."""
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2)
    params = llama.init(jcfg, jax.random.key(13))
    cfg = PortConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2)
    assert cfg.head_size == jcfg.head_size == 64
    return jcfg, params, params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["", "int8"])
def test_llama_d64_greedy_tokens_equal_the_jax_paged_engine(llama64, kind):
    """Greedy tokens of the port's paged engine at head dim 64 equal the
    JAX paged engine's, on the bf16-layout pool and (on the CPU, where the
    plain path serves it) the int8 pool."""
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = llama64
    knobs = dict(slots=4, max_len=64, max_prefill_batch=2, page_size=8, kv_quantize=kind)
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), kv_layout="paged", **knobs)
    try:
        want = [r.result(timeout=120) for r in [jeng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        jeng.stop()
    eng = GenerateEngine(model, device="cpu", **knobs)
    try:
        assert eng.kv_layout == "paged" and eng.cache.k.shape[-1] == 64
        got = [r.result(timeout=120) for r in [eng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        eng.stop()
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]


# -- the launchers: each 64 call binds its own entry point and count ------------------------


def _stub_launch(monkeypatch):
    """``cuda.require`` passing, ``bind`` recording the entry point, the
    stream 0; returns the list of bound names."""
    from gofr_tpu_torch.ops import cuda

    bound = []
    monkeypatch.setattr(cuda, "require", lambda cond, msg: None)
    monkeypatch.setattr(cuda, "bind", lambda name, argtypes: (bound.append(name),
                                                               lambda *args: 0)[1])
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    return bound


@pytest.mark.quick
@pytest.mark.parametrize("d", [128, 64])
def test_launchers_bind_and_count_each_head_dim_apart(d, monkeypatch):
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import decode_attention as slot_mod
    from gofr_tpu_torch.ops.cuda import kv_append as append_mod
    from gofr_tpu_torch.ops.cuda import paged_decode as paged_mod

    bound = _stub_launch(monkeypatch)
    for name in cuda.launch_counts():
        monkeypatch.setattr(cuda._wrappers()[name], "launches", 0)
    n, hq, hkv, page, maxp, smax = 3, 8, 2, 16, 4, 40
    bf = torch.bfloat16
    q = torch.zeros(n, hq, d, dtype=bf)
    pool = torch.zeros(10, hkv, page, d, dtype=bf)
    slot = torch.zeros(n, hkv, smax, d, dtype=bf)
    rows = torch.zeros(n, hkv, d, dtype=bf)
    table, lengths = torch.zeros(n, maxp, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    paged_mod.paged_decode(q, pool, pool, table, lengths)
    slot_mod.decode_attention(q, slot, slot, lengths)
    append_mod.kv_append(pool, pool, table, lengths, rows, rows)
    append_mod.kv_append_slot(slot, slot, lengths, rows, rows)
    suffix = "_d64" if d == 64 else ""
    assert bound == [f"gofr_paged_decode{suffix}", f"gofr_decode_attention{suffix}",
                     f"gofr_kv_append{suffix}", f"gofr_kv_append_slot{suffix}"]
    counts = cuda.launch_counts()
    launched = {name for name, c in counts.items() if c}
    assert launched == {f"paged_decode{suffix}", f"decode_attention{suffix}",
                        f"kv_append{suffix}", f"kv_append_slot{suffix}"}
    assert all(counts[name] == 1 for name in launched)


@pytest.mark.quick
def test_64_wrappers_refuse_other_head_dims_and_launchers_refuse_cpu_tensors():
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda.decode_attention import decode_attention_d64
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append_d64, kv_append_slot_d64
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode_d64

    cuda.reset_launch_counts()
    q128, pool128 = torch.zeros(2, 4, 128), torch.zeros(4, 2, 8, 128)
    table, lengths = torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="takes head_dim 64"):
        paged_decode_d64(q128, pool128, pool128, table, lengths)
    with pytest.raises(ValueError, match="takes head_dim 64"):
        decode_attention_d64(q128, pool128[:2], pool128[:2], lengths)
    with pytest.raises(ValueError, match="takes head_dim 64"):
        kv_append_d64(pool128, pool128, table, lengths, q128[:, :2], q128[:, :2])
    with pytest.raises(ValueError, match="takes head_dim 64"):
        kv_append_slot_d64(pool128[:2], pool128[:2], lengths, q128[:, :2], q128[:, :2])
    q64, pool64 = torch.zeros(2, 4, 64), torch.zeros(4, 2, 8, 64)
    with pytest.raises(ValueError, match="on the card"):
        paged_decode_d64(q64, pool64, pool64, table, lengths)
    with pytest.raises(ValueError, match="on the card"):
        decode_attention_d64(q64, pool64[:2], pool64[:2], lengths)
    with pytest.raises(ValueError, match="on the card"):
        kv_append_d64(pool64, pool64, table, lengths, q64[:, :2], q64[:, :2])
    assert set(cuda.launch_counts().values()) == {0}


# -- the 64 builds against their plain versions (on the card only) ---------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _within(got, want, module):
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt().clamp_min(1e-30)
    return bool(got.float().isfinite().all()) and diff.abs().max().item() <= module.MAX_ABS \
        and rel.item() <= module.RMS_REL


@pytest.mark.cuda
def test_d64_decode_builds_match_plain_on_the_card():
    """A at ``one_b``'s heads (Hq 32, Hkv 4, page 128) and F at GPT-2's (Hq =
    Hkv 12, Smax 1024) on ragged lengths of hundreds of keys (as each
    launcher's limits were set at: a lane of a few keys has outputs of
    order 1, where the plain version's bf16 scores move them by more), a
    lane past the slot and an empty slot; other head dims refused."""
    _needs_card()
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import decode_attention_plain, paged_decode_attention_plain
    from gofr_tpu_torch.ops.cuda import decode_attention as slot_mod
    from gofr_tpu_torch.ops.cuda import paged_decode as paged_mod

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(64)
    cuda.reset_launch_counts()
    pool, page = 60, 128
    k = torch.randn(pool, 4, page, 64, device=dev, generator=g).to(bf)
    v = torch.randn(pool, 4, page, 64, device=dev, generator=g).to(bf)
    table = torch.randperm(pool, device=dev, generator=g)[:5 * 12].to(torch.int32).view(5, 12)
    table[4] = pool
    lengths = torch.tensor([699, 1200, 1536, 300, 0], device=dev, dtype=torch.int32)
    q = torch.randn(5, 32, 64, device=dev, generator=g).to(bf)
    got = paged_mod.paged_decode(q, k, v, table, lengths)
    assert _within(got, paged_decode_attention_plain(q, k, v, table, lengths), paged_mod)
    assert torch.all(got[4] == 0)
    ks = torch.randn(5, 12, 1024, 64, device=dev, generator=g).to(bf)
    vs = torch.randn(5, 12, 1024, 64, device=dev, generator=g).to(bf)
    qs = torch.randn(5, 12, 64, device=dev, generator=g).to(bf)
    slens = torch.tensor([512, 1023, 1024, 1030, 0], device=dev, dtype=torch.int32)
    got = slot_mod.decode_attention(qs, ks, vs, slens)
    assert _within(got[:4], decode_attention_plain(qs, ks, vs, slens)[:4], slot_mod)
    assert torch.all(got[4] == 0)
    counts = cuda.launch_counts()
    assert counts["paged_decode_d64"] == counts["decode_attention_d64"] == 1
    assert counts["paged_decode"] == counts["decode_attention"] == 0
    with pytest.raises(ValueError, match="head_dim 128 or 64"):
        slot_mod.decode_attention(qs[..., :32].contiguous(), ks[..., :32].contiguous(),
                                  vs[..., :32].contiguous(), slens)


@pytest.mark.cuda
def test_d64_appends_match_plain_bit_for_bit_on_the_card():
    _needs_card()
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append, kv_append_slot
    from gofr_tpu_torch.ops.kvcache import append_tokens_plain
    from gofr_tpu_torch.ops.paged import append_tokens_paged_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(65)
    pool = torch.randn(20, 4, 16, 64, device=dev, generator=g).to(bf)
    table = torch.randperm(20, device=dev, generator=g)[:12].to(torch.int32).view(3, 4)
    table[2, 0] = 20
    positions = torch.tensor([17, 70, 3], device=dev, dtype=torch.int32)
    rows = torch.randn(3, 4, 64, device=dev, generator=g).to(bf)
    a, c = pool.clone(), pool.clone()
    kv_append(a, a.clone(), table, positions, rows, rows)
    append_tokens_paged_plain(c, c.clone(), table, positions, rows, rows)
    assert torch.equal(a.view(torch.int16), c.view(torch.int16)) and not torch.equal(a, pool)
    slot = torch.randn(3, 12, 100, 64, device=dev, generator=g).to(bf)
    srows = torch.randn(3, 12, 64, device=dev, generator=g).to(bf)
    spos = torch.tensor([99, 100, 0], device=dev, dtype=torch.int32)
    a, c = slot.clone(), slot.clone()
    kv_append_slot(a, a.clone(), spos, srows, srows)
    append_tokens_plain(c, c.clone(), spos, srows, srows)
    assert torch.equal(a.view(torch.int16), c.view(torch.int16)) and torch.equal(a[1], slot[1])
