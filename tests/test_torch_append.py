"""The per-step KV appends of every cache format, held against the JAX
package and, on a card, kernel against plain.

One CUDA template (gofr_tpu_torch/csrc/kv_append.cu) serves all five
appends: kernels B (bf16 pool) and G (bf16 slot cache), which replace the
Pallas appends, and B-q, B-q4, G-q, which quantize each row and append it
to the int8 pool, the packed int4 pool and the int8 slot cache, where the
JAX package runs XLA (gofr_tpu/ops/paged.py:344, :438, gofr_tpu/ops/
kvcache.py:132). Here, on the CPU:

- the plain quantized appends (``ops.paged.append_tokens_paged_q``,
  ``append_tokens_paged_q4``, ``ops.kvcache.append_tokens_q``), the
  kernels' references, against the JAX functions on rows a numpy generator
  draws across magnitudes, plus an all-zero row, rows whose max is a single
  element and rows of exact halves (round half to even);
- each launcher's ctypes argument list against its C entry point;
- the routing: a cache on the CPU, with or without ``kernels``, never
  reaches a launcher;
- ``Llama.decode_step`` hands the kernels int32 positions, lengths and
  table, converted once per step.

The ``cuda`` test holds the five kernels against their plain versions on a
card (``python -m pytest tests/test_torch_append.py -m cuda``).

Tolerance: exact equality of values and scales everywhere. The formats are
a contract between writer and reader, and the kernels copy 16-bit patterns
or quantize with IEEE division and round half to even, as the plain
versions do.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

D = 128
LAUNCHERS = ("kv_append", "kv_append_slot", "kv_append_q", "kv_append_q4", "kv_append_slot_q")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(a):
    """A JAX or numpy array as a torch tensor, bf16 by its bit pattern."""
    from gofr_tpu_torch.models.llama import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a))


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _edge_rows(seed: int, n: int, hkv: int, dtype: str):
    """[N, Hkv, D] rows of max |x| 1e-3..50 from a numpy generator; lane 0
    head 0 all zero; lane 1 one element per head holding the max (in the
    first half on even heads, the second on odd), the rest tiny; lane 2
    exact halves against a scale of 1 (max 127 on head 0, 7 on head 1), so
    q = x / s lands on .5 and rounds to even."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, hkv, D)) * rng.uniform(1e-3, 50.0, (n, hkv, 1))).astype(np.float32)
    x[0, 0] = 0.0
    x[1] *= 1e-3
    for h in range(hkv):
        x[1, h, (h * 37) % (D // 2) + (D // 2) * (h % 2)] = (1.0 + h) * (-1.0) ** h
    halves = np.array([2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 6.5, -6.5], np.float32)
    x[2, 0] = np.resize(halves, D)
    x[2, 0, 0] = 127.0
    x[2, 1] = np.resize(halves[:6], D)
    x[2, 1, 0] = 7.0
    x = jnp.asarray(x)
    return x if dtype == "f32" else x.astype(jnp.bfloat16)


def _pool_plane(seed: int, bits: int, pool: int, hkv: int, page: int):
    """A quantized pool plane and its bf16 scales, as the JAX writes leave
    them."""
    from gofr_tpu.ops import kvcache as jax_kv, quant as jax_quant

    rows = jnp.asarray(np.random.default_rng(seed).standard_normal((pool, hkv, page, D)),
                       jnp.float32)
    if bits == 8:
        vals, scales = jax_kv.quantize_row(rows)
    else:
        vals, scales = jax_quant.quantize_row_int4(rows)
        vals = jax_quant.pack_int4(vals)
    return np.asarray(vals), np.asarray(scales.astype(jnp.bfloat16))


# -- the plain quantized appends against JAX --------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_pool_appends_are_bit_exact_against_jax_on_edge_rows(bits, dtype):
    """16 lanes of 4 KV heads into distinct rows of a shuffled pool (page
    8): mid-page, at page boundaries, and two lanes through an OOB entry
    (== P), which both drop."""
    from gofr_tpu.ops import paged as jax_paged
    from gofr_tpu_torch.ops import paged

    jax_append, append = ((jax_paged.append_tokens_paged_q, paged.append_tokens_paged_q) if bits == 8
                          else (jax_paged.append_tokens_paged_q4, paged.append_tokens_paged_q4))
    n, hkv, page, maxp, pool = 16, 4, 8, 3, 48
    vals, scales = _pool_plane(bits, bits, pool, hkv, page)
    rng = np.random.default_rng(40 + bits)
    table = rng.permutation(pool).astype(np.int32).reshape(n, maxp)
    positions = rng.integers(0, maxp * page, n).astype(np.int32)
    positions[:3] = [0, page - 1, page]
    table[5, positions[5] // page] = table[9, positions[9] // page] = pool
    new = _edge_rows(50 + bits, n, hkv, dtype)
    wq, ws = jax_append(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(table),
                        jnp.asarray(positions), new)
    gq, gs = _t(vals.copy()), _port(scales)
    append(gq, gs, _t(table), _t(positions), _port(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert not np.array_equal(gq.numpy(), vals)


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_slot_append_is_bit_exact_against_jax_on_edge_rows(dtype):
    """16 lanes of the int8 slot cache (Smax 40): live positions, and lanes
    at -1, at Smax and past it, which both drop."""
    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu_torch.ops.kvcache import append_tokens_q

    n, hkv, smax = 16, 4, 40
    rng = np.random.default_rng(60)
    cq = rng.integers(-127, 128, (n, hkv, smax, D)).astype(np.int8)
    cs = jnp.asarray(rng.uniform(0.01, 1.0, (n, hkv, smax)).astype(np.float32)).astype(jnp.bfloat16)
    positions = rng.integers(0, smax, n).astype(np.int32)
    positions[3], positions[7], positions[11] = -1, smax, smax + 5
    new = _edge_rows(61, n, hkv, dtype)
    wq, ws = jax_kv.append_tokens_q(jnp.asarray(cq), cs, jnp.asarray(positions), new)
    gq, gs = _t(cq.copy()), _port(cs)
    append_tokens_q(gq, gs, _t(positions), _port(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    for lane in (3, 7, 11):
        np.testing.assert_array_equal(gq[lane].numpy(), cq[lane])


@pytest.mark.parametrize("bits", [8, 4])
def test_plain_appends_store_the_edge_rows_codes_and_scales(bits):
    """What the kernels are checked against on the card's edge lanes: an
    all-zero row stores codes 0 and the scale bf16(1e-8 / qmax), a row whose
    max is one element stores +-qmax there, and exact halves round to even."""
    from gofr_tpu_torch.ops.kvcache import quantize_row
    from gofr_tpu_torch.ops.quant import quantize_row_int4

    qmax, quantize = (127, quantize_row) if bits == 8 else (7, quantize_row_int4)
    q, s = quantize(_port(_edge_rows(70, 3, 2, "bf16")))
    assert torch.all(q[0, 0] == 0)
    assert s[0, 0].to(torch.bfloat16).view(torch.int16) == (torch.tensor(1e-8) / qmax).to(
        torch.bfloat16).view(torch.int16)
    assert torch.all(q[1].abs().amax(dim=-1) == qmax)
    head = 0 if bits == 8 else 1
    assert q[2, head, 0] == qmax and s[2, head] == 1.0
    assert q[2, head, 1:6].tolist() == [4, -2, 0, 0, 2]  # 3.5, -2.5, -0.5, 0.5, 1.5


# -- the launchers, without a card ---------------------------------------------


@pytest.mark.quick
def test_append_launchers_declare_the_c_entry_points_arguments(monkeypatch):
    """Each append launcher's ctypes argument list matches its C entry
    point in csrc/kv_append.cu (arity and types), and a call with the checks
    and the C call stubbed out passes that many arguments, N, Hkv and D=128
    among them (a mismatch would pass pointers in the wrong slots)."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import kv_append as mod

    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}
    source = (cuda.CSRC / "kv_append.cu").read_text()
    declared = {name: [c_types[" ".join(p.split()[:-1])] for p in params.split(",")]
                for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source)}
    assert declared == {"gofr_kv_append": mod._ARGTYPES, "gofr_kv_append_slot": mod._SLOT_ARGTYPES,
                        "gofr_kv_append_q": mod._Q_ARGTYPES, "gofr_kv_append_q4": mod._Q_ARGTYPES,
                        "gofr_kv_append_slot_q": mod._SLOT_Q_ARGTYPES}

    calls = []
    monkeypatch.setattr(cuda, "require", lambda cond, msg: None)
    monkeypatch.setattr(cuda, "bind", lambda name, argtypes: (
        calls.append((name, argtypes)), lambda *args: calls.append(args) or 0)[1])
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    for name in LAUNCHERS:
        monkeypatch.setattr(getattr(mod, name), "launches", 0)
    n, hkv, page, pool, maxp, smax = 3, 2, 16, 5, 4, 40
    rows = torch.zeros(n, hkv, D, dtype=torch.bfloat16)
    table, positions = torch.zeros(n, maxp, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    bf_pool, bf_slot = torch.zeros(pool, hkv, page, D, dtype=torch.bfloat16), torch.zeros(
        n, hkv, smax, D, dtype=torch.bfloat16)
    q_pool = (torch.zeros(pool, hkv, page, D, dtype=torch.int8),) * 2 + (
        torch.zeros(pool, hkv, page, dtype=torch.bfloat16),) * 2
    q4_pool = (torch.zeros(pool, hkv, page, D // 2, dtype=torch.uint8),) * 2 + q_pool[2:]
    q_slot = (torch.zeros(n, hkv, smax, D, dtype=torch.int8),) * 2 + (
        torch.zeros(n, hkv, smax, dtype=torch.bfloat16),) * 2
    mod.kv_append(bf_pool, bf_pool, table, positions, rows, rows)
    mod.kv_append_slot(bf_slot, bf_slot, positions, rows, rows)
    mod.kv_append_q(*q_pool, table, positions, rows, rows)
    mod.kv_append_q4(*q4_pool, table, positions, rows, rows)
    mod.kv_append_slot_q(*q_slot, positions, rows, rows)
    made = [(calls[i], calls[i + 1]) for i in range(0, len(calls), 2)]
    assert [name for (name, _), _ in made] == ["gofr_kv_append", "gofr_kv_append_slot",
                                               "gofr_kv_append_q", "gofr_kv_append_q4",
                                               "gofr_kv_append_slot_q"]
    ints = {"gofr_kv_append": (n, maxp, pool, hkv, page, D), "gofr_kv_append_slot": (n, hkv, smax, D),
            "gofr_kv_append_q": (n, maxp, pool, hkv, page, D),
            "gofr_kv_append_q4": (n, maxp, pool, hkv, page, D),
            "gofr_kv_append_slot_q": (n, hkv, smax, D)}
    for (name, argtypes), args in made:
        assert len(args) == len(argtypes) == len(declared[name])
        assert tuple(args[-1 - len(ints[name]):-1]) == ints[name]
    assert all(getattr(mod, name).launches == 1 for name in LAUNCHERS)


@pytest.mark.quick
def test_append_launchers_refuse_cpu_tensors():
    """Each append launcher raises on tensors off the card, before any
    pointer reaches C, and counts nothing."""
    import inspect

    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import kv_append as mod

    cuda.reset_launch_counts()
    for name in LAUNCHERS:
        fn = getattr(mod, name)
        with pytest.raises(ValueError, match="on the card"):
            fn(*[torch.zeros(2, 2, 2, 2)] * len(inspect.signature(fn).parameters))
    assert set(cuda.launch_counts().values()) == {0}


@pytest.mark.quick
@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("cache_kind", ["paged", "paged_int8", "paged_int4", "slot", "slot_int8"])
def test_cpu_caches_never_reach_the_append_launchers(cache_kind, kernels, monkeypatch):
    """With every append launcher made to raise, a cache on the CPU appends
    through its plain version, with ``kernels`` or without, writes what that
    version writes, and no launch is counted."""
    from gofr_tpu_torch.ops import cuda, kvcache, paged
    from gofr_tpu_torch.ops.cuda import kv_append as mod

    cuda.reset_launch_counts()

    def refuse(*args, **kw):
        raise AssertionError("a CPU cache reached an append launcher")

    refuse.launches = 0
    refusing = staticmethod(refuse)
    for name in LAUNCHERS:
        monkeypatch.setattr(mod, name, refuse)
    for module, names in ((paged, ("kv_append", "kv_append_q", "kv_append_q4")),
                          (kvcache, ("kv_append_slot", "kv_append_slot_q"))):
        for name in names:
            monkeypatch.setattr(module, name, refuse)
    monkeypatch.setattr(paged.QPagedKVCache, "append_kernel", refusing)
    monkeypatch.setattr(paged.Q4PagedKVCache, "append_kernel", refusing)

    layout, _, quant = cache_kind.partition("_")
    n, hkv, rows_or_pages, row_len = 4, 2, 6, 8
    if layout == "paged":
        cls = {"": paged.PagedKVCache, "int8": paged.QPagedKVCache, "int4": paged.Q4PagedKVCache}[quant]
        cache = cls.create(2, rows_or_pages, row_len, hkv, D)
        table = _t(np.array([[0, 1], [2, 6], [3, 4], [6, 6]], np.int32))
    else:
        cls = kvcache.SlotKVCache if not quant else kvcache.QSlotKVCache
        cache = cls.create(2, n, row_len, hkv, D)
        table = None
    positions = _t(np.array([3, 9, 8, 0], np.int32))
    rng = np.random.default_rng(80)
    k_new, v_new = (_t(rng.standard_normal((n, hkv, D)).astype(np.float32)).to(torch.bfloat16)
                    for _ in range(2))
    want = type(cache)(**{f: t.clone() for f, t in vars(cache).items()})
    want.append(1, table, positions, k_new, v_new, kernels=False)
    cache.append(1, table, positions, k_new, v_new, kernels=kernels)
    for f, got in vars(cache).items():
        np.testing.assert_array_equal(_bits(got), _bits(getattr(want, f)))
    assert not torch.equal(cache.k[1], torch.zeros_like(cache.k[1]))
    assert set(cuda.launch_counts().values()) == {0}


@pytest.mark.quick
@pytest.mark.parametrize("layout", ["paged", "slot"])
def test_decode_step_hands_the_kernels_int32_indices(layout, monkeypatch):
    """``Llama.decode_step`` given int64 positions (and an int64 table), as
    the engine hands them, passes int32 positions, lengths and table to the
    cache's append and its decode attention: converted once per step, so no
    launcher casts them per layer."""
    from gofr_tpu_torch.models.llama import Llama, LlamaConfig, init
    from gofr_tpu_torch.ops import attention

    cfg = LlamaConfig.tiny()
    model = init(cfg, torch.Generator().manual_seed(0), "cpu")
    seen = []
    if layout == "paged":
        cache, table = model.make_paged_cache(8, 8), torch.arange(8, dtype=torch.int64).view(2, 4)
    else:
        cache, table = model.make_cache(2, 32), None
    kind = type(cache)
    entry, plain = attention.DECODE_ATTENTION[kind]

    def spy_attention(q, *planes_and_lengths):
        seen.append(("attention", [t.dtype for t in planes_and_lengths[2:]]))
        return plain(q, *planes_and_lengths)

    real_append = kind.append

    def spy_append(self, layer, table, positions, k_new, v_new, *, kernels=True):
        seen.append(("append", positions.dtype, None if table is None else table.dtype))
        return real_append(self, layer, table, positions, k_new, v_new, kernels=kernels)

    monkeypatch.setitem(attention.DECODE_ATTENTION, kind, (spy_attention, plain))
    monkeypatch.setattr(kind, "append", spy_append)
    positions = torch.tensor([5, 17], dtype=torch.int64)
    logits, _ = Llama.decode_step(model, torch.tensor([1, 2]), positions, cache, table)
    assert logits.shape == (2, cfg.vocab_size)
    i32 = torch.int32
    assert seen.count(("append", i32, i32 if layout == "paged" else None)) == cfg.num_layers
    want_attention = [i32, i32] if layout == "paged" else [i32]
    assert seen.count(("attention", want_attention)) == cfg.num_layers
    assert len(seen) == 2 * cfg.num_layers


# -- the kernels against their plain versions (on the card only) ---------------------


@pytest.mark.cuda
def test_append_kernels_match_plain_bit_for_bit_on_the_card():
    """B, B-q, B-q4 through a shuffled table (page 16) and G, G-q on a slot
    cache of Smax 40, on edge lanes: -1, past the table, an OOB and a
    negative entry, at and past Smax, an all-zero row, a row whose max is one
    element, exact halves. Values and scales bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops.cuda import kv_append as mod
    from gofr_tpu_torch.ops.kvcache import append_tokens_plain, append_tokens_q
    from gofr_tpu_torch.ops.paged import (
        append_tokens_paged_plain,
        append_tokens_paged_q,
        append_tokens_paged_q4,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(5)
    n, hkv, page, maxp, pool, smax = 9, 8, 16, 4, 40, 40
    rows = [_port(_edge_rows(90 + i, n, hkv, "bf16")).to(dev) for i in range(2)]
    # distinct pages for every lane; lane 1 at -1, lane 2 through an OOB
    # entry, lane 3 through a negative one, lane 4 past the table (lane 5's
    # first entry is a live page)
    table = torch.randperm(pool, device=dev, generator=g).to(torch.int32)[:n * maxp].view(n, maxp)
    positions = torch.tensor([3, -1, 17, 5, maxp * page, 33, 0, 9, 60], device=dev, dtype=torch.int32)
    table[2, 1], table[3, 0] = pool, -1
    slot_pos = torch.tensor([0, -1, smax, smax + 3, 39, 17, 8, 1, 20], device=dev, dtype=torch.int32)

    def same(a, b):
        return all(torch.equal(x.view(torch.int16), y.view(torch.int16)) if x.dtype == bf
                   else torch.equal(x, y) for x, y in zip(a, b))

    cases = [
        (mod.kv_append, (torch.randn(pool, hkv, page, D, device=dev, generator=g).to(bf),) * 2,
         (table, positions), lambda p, idx: append_tokens_paged_plain(*p, *idx, *rows)),
        (mod.kv_append_slot, (torch.randn(n, hkv, smax, D, device=dev, generator=g).to(bf),) * 2,
         (slot_pos,), lambda p, idx: append_tokens_plain(*p, *idx, *rows)),
    ]
    for launch, plain, width, dtype, shape in (
            (mod.kv_append_q, append_tokens_paged_q, D, torch.int8, (pool, hkv, page)),
            (mod.kv_append_q4, append_tokens_paged_q4, D // 2, torch.uint8, (pool, hkv, page)),
            (mod.kv_append_slot_q, append_tokens_q, D, torch.int8, (n, hkv, smax))):
        vals = torch.randint(0, 100, (*shape, width), device=dev, generator=g).to(dtype)
        scales = torch.rand(shape, device=dev, generator=g).to(bf)
        idx = (slot_pos,) if launch is mod.kv_append_slot_q else (table, positions)
        cases.append((launch, (vals, vals, scales, scales), idx,
                      lambda p, idx, plain=plain: [plain(p[i], p[i + 2], *idx, rows[i]) for i in (0, 1)]))
    for launch, planes, idx, plain in cases:
        got = [t.clone() for t in planes]
        want = [t.clone() for t in planes]
        launch(*got, *idx, *rows)
        plain(want, idx)
        differ = [int((a != b).sum()) for a, b in zip(got, want)]
        assert same(got, want), f"{launch.__name__}: elements that differ per plane {differ}"
        assert not torch.equal(got[0], planes[0]), launch.__name__


@pytest.mark.quick
def test_ieee_div_is_the_ieee_quotient():
    """The plain quantizers' scale, max|x| / 127 or / 7, is the IEEE f32
    quotient (numpy's), on the CPU and, where there is one, on the card,
    whose division by a Python number would multiply by the reciprocal."""
    from gofr_tpu_torch.ops.kvcache import ieee_div

    a = np.random.default_rng(7).uniform(1e-8, 60.0, 200_000).astype(np.float32)
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for dev in devices:
        for b in (127.0, 7.0):
            got = ieee_div(_t(a).to(dev), b).cpu().numpy()
            np.testing.assert_array_equal(got.view(np.uint32), (a / np.float32(b)).view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_quantizers_agree_bit_for_bit_on_the_card_and_the_cpu(bits, dtype):
    """The kernels' reference end to end: ``quantize_row`` (int8) and
    ``quantize_row_int4`` on the card give the CPU's codes and f32 scales
    bit for bit, on the edge rows (an all-zero row, rows whose max is one
    element, exact halves) and 4096 more rows of max |x| 1e-3..50."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops.kvcache import quantize_row
    from gofr_tpu_torch.ops.quant import quantize_row_int4

    quantize = quantize_row if bits == 8 else quantize_row_int4
    rows = _port(_edge_rows(100 + bits, 512, 8, dtype))
    want_q, want_s = quantize(rows)
    got_q, got_s = (t.cpu() for t in quantize(rows.to("cuda")))
    np.testing.assert_array_equal(got_q.numpy(), want_q.numpy())
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32), want_s.numpy().view(np.uint32))
    assert torch.all(want_q[0, 0] == 0) and torch.all(want_q[1].abs().amax(dim=-1) == 2 ** (bits - 1) - 1)


@pytest.mark.cuda
def test_launchers_refuse_what_they_would_once_have_converted_on_the_card():
    """On the card the launchers convert nothing: int64 positions or
    lengths, as the engine hands them to ``Llama.decode_step``, are refused
    by the appends and by decode attention (A, F) before any launch, and a
    row that is not 8-byte aligned by the append's C entry point; nothing
    is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import decode_attention, kv_append, paged_decode

    dev, bf = torch.device("cuda"), torch.bfloat16
    n, hkv, page, maxp, pool, smax = 3, 2, 16, 4, 12, 40
    pool_kv = torch.zeros(pool, hkv, page, D, dtype=bf, device=dev)
    slot_kv = torch.zeros(n, hkv, smax, D, dtype=bf, device=dev)
    rows = torch.zeros(n, hkv, D, dtype=bf, device=dev)
    table = torch.arange(n * maxp, dtype=torch.int32, device=dev).view(n, maxp) % pool
    pos = torch.tensor([3, 20, 0], dtype=torch.int32, device=dev)
    q = torch.zeros(n, 4 * hkv, D, dtype=bf, device=dev)
    cuda.reset_launch_counts()
    for call in (lambda: kv_append.kv_append(pool_kv, pool_kv, table, pos.long(), rows, rows),
                 lambda: kv_append.kv_append(pool_kv, pool_kv, table.long(), pos, rows, rows),
                 lambda: kv_append.kv_append_slot(slot_kv, slot_kv, pos.long(), rows, rows),
                 lambda: paged_decode.paged_decode(q, pool_kv, pool_kv, table, pos.long()),
                 lambda: decode_attention.decode_attention(q, slot_kv, slot_kv, pos.long())):
        with pytest.raises(ValueError, match="int32"):
            call()
    shifted = torch.zeros(rows.numel() + 1, dtype=bf, device=dev)[1:].view(rows.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 8 != 0
    with pytest.raises(RuntimeError, match="misaligned"):
        kv_append.kv_append(pool_kv, pool_kv, table, pos, shifted, rows)
    assert set(cuda.launch_counts().values()) == {0}
