"""The quantized caches at head dim 64, held against the JAX package, and
the card's refusal of what it has no kernel for.

Llama ``one_b`` (2048 / 32 heads) runs at head dim 64. On the card, kernels
D (int8 pool decode) and E (packed int4 pool decode) and the quantizing
appends B-q, B-q4 and G-q are built at 64 as well as 128
(``csrc/paged_decode_q.cu``, ``csrc/kv_append.cu``); here their split plain
versions and plain appends, which repeat the kernels' arithmetic in
PyTorch, are held against the Pallas kernels (interpret mode, as
tests/test_torch_split_decode_q.py runs them) and the JAX appends at D 64,
and a Llama of head dim 64 serves the JAX engine's greedy tokens on the
int4 pool and the int8 slot cache. The launchers are checked without a
launch: a 64 call binds the ``_d64`` entry point and counts under the
``_d64`` name. ``refuse_unbuilt_kernels`` is checked with the device
patched to ``cuda``: a model in a dtype other than bf16 and f32, or a
model at a head dim other than 128 and 64, raises before any weight is
drawn; an f32 model passes on every cache and with int8 weights (every
kernel has an f32 build). The
``cuda``-marked tests hold each 64 build against its plain version on the
card (``python -m pytest tests/test_torch_quantized_d64.py -m cuda``).

Tolerances:
- decode attention, f32 q: 1e-5 (only the order of the f32 sums differs);
- decode attention, bf16 q: 1.6e-2 absolute, tests/test_torch_split_decode
  _q.py's: Pallas keeps scores and p * vs in f32 as the split version
  does, so the outputs (up to ~2) differ by at most one bf16 ulp from the
  order of the sums (7.8e-3 in [1, 2)); the unsplit plain version rounds
  scores and p * vs to bf16 as the JAX XLA path does, which moves the
  small outputs by a few of their ulps. The limit is two ulps in [1, 2);
- appends: bit for bit, values and scales;
- greedy tokens: exact;
- on the card, the launchers' own limits (``MAX_ABS``, ``RMS_REL``) and
  bit equality for the appends.
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
SPAN = 640      # MaxP x page: past 2 x 192 + 1, a multiple of neither 64-row tile nor 256
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6]]


def _port(a):
    from gofr_tpu_torch.models.llama import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _quantized(rows, bits: int):
    """Values and bf16 scales of ``rows`` as the JAX quantizers store them
    (int8, or packed int4)."""
    from gofr_tpu.ops import kvcache as jax_kv, quant as jax_quant

    if bits == 8:
        vals, scales = jax_kv.quantize_row(jnp.asarray(rows))
    else:
        vals, scales = jax_quant.quantize_row_int4(jnp.asarray(rows))
        vals = jax_quant.pack_int4(vals)
    return np.asarray(vals), np.asarray(scales.astype(jnp.bfloat16))


# -- kernels D and E at D 64: their split plain versions ------------------------------------


@functools.lru_cache(maxsize=None)
def _case(bits, group, page, split_rows):
    """q (f32), K/V value planes and scales, table and lengths, as numpy: a
    pool of 2 x MaxP pages of head dim 64 quantized by the JAX quantizers,
    tables drawn in scrambled order with repeats, OOB entries (== P) inside
    two live lanes and the empty lane's whole row; lanes of length 0, on
    and one past the first two split boundaries, the whole table row, past
    it, and a short one."""
    rng = np.random.default_rng(8000 + 100 * bits + 10 * group + page + split_rows)
    maxp = SPAN // page
    pool = 2 * maxp
    (kq, ks), (vq, vs) = (_quantized(rng.standard_normal((pool, HKV, page, D)).astype(np.float32),
                                     bits) for _ in range(2))
    r = split_rows
    lengths = np.array([0, r, r + 1, 2 * r, 2 * r + 1, SPAN, SPAN + 5, 37], np.int32)
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
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("page", [40, 128])
@pytest.mark.parametrize("split_rows", [64, 192])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_split_plain_at_d64_matches_pallas(bits, group, split_rows, page, dtype):
    """Kernel D's (``bits`` 8) and E's (4) arithmetic at D 64 (``one_b``:
    group 8, page 128) against the Pallas ``paged_decode_attention_q`` /
    ``_q4`` and the unsplit plain version."""
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_q4_plain,
        paged_decode_attention_q_plain,
        paged_decode_attention_q_split_plain,
    )

    plain = paged_decode_attention_q_plain if bits == 8 else paged_decode_attention_q4_plain
    q, *pools, table, lengths = _case(bits, group, page, split_rows)
    pools, table, lengths = [_port(a) for a in pools], _port(table), _port(lengths)
    assert pools[0].shape[-1] == (D if bits == 8 else D // 2)
    tq = _port(q) if dtype == "f32" else _port(q).to(torch.bfloat16)
    got = paged_decode_attention_q_split_plain(tq, *pools, table, lengths, split_rows, bits=bits)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    assert torch.isfinite(got.float()).all() and torch.all(got[0] == 0)
    # a length past the table attends to the whole table row
    whole = paged_decode_attention_q_split_plain(tq, *pools, table, lengths.clamp(max=SPAN),
                                                 split_rows, bits=bits)
    torch.testing.assert_close(got[6], whole[6], rtol=0, atol=0)
    tol, rtol = (F32_TOL, F32_TOL) if dtype == "f32" else (BF16_TOL, 0)
    for want in (_pallas(bits, group, page, split_rows, dtype),
                 plain(tq, *pools, table, lengths).float().numpy()):
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=rtol)


# -- the quantizing appends at D 64, bit for bit ------------------------------------------


def _rows(seed: int, n: int, dtype: str):
    """[N, Hkv, 64] rows of max |x| 1e-3..50; lane 0 head 0 all zero; lane
    1 one element per head holding the max, in the first half on head 0
    and the second on head 1 (the half a quantizer over half the row would
    miss); lane 2 exact halves against a scale of 1 (round half to
    even)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, HKV, D)) * rng.uniform(1e-3, 50.0, (n, HKV, 1))).astype(np.float32)
    x[0, 0] = 0.0
    x[1] *= 1e-3
    x[1, 0, 21], x[1, 1, 32 + 13] = 1.0, -2.0
    halves = np.array([2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 6.5, -6.5], np.float32)
    x[2, 0] = np.resize(halves, D)
    x[2, 0, 0] = 127.0
    x[2, 1] = np.resize(halves[:6], D)
    x[2, 1, 0] = 7.0
    x = jnp.asarray(x)
    return x if dtype == "f32" else x.astype(jnp.bfloat16)


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_pool_appends_at_d64_are_bit_exact_against_jax(bits, dtype):
    """B-q's and B-q4's plain versions at D 64: 12 lanes into a shuffled
    pool (page 8), mid-page and at page boundaries, against JAX's
    ``append_tokens_paged_q`` / ``_q4``; a lane through an OOB entry (== P)
    drops in both. JAX's XLA append writes a negative position and one past
    the table onto the table row's last page; the port drops both, as the
    Pallas append does (ROADMAP.md Queue C), so those two lanes go to JAX
    through an all-OOB table row, which JAX drops too."""
    from gofr_tpu.ops import paged as jax_paged
    from gofr_tpu_torch.ops import paged

    jax_append, append = ((jax_paged.append_tokens_paged_q, paged.append_tokens_paged_q) if bits == 8
                          else (jax_paged.append_tokens_paged_q4, paged.append_tokens_paged_q4))
    n, page, maxp, pool = 12, 8, 3, 36
    rng = np.random.default_rng(8100 + bits)
    vals, scales = _quantized(rng.standard_normal((pool, HKV, page, D)).astype(np.float32), bits)
    table = rng.permutation(pool).astype(np.int32).reshape(n, maxp)
    positions = rng.integers(0, maxp * page, n).astype(np.int32)
    positions[:3] = [0, page - 1, page]
    table[5, positions[5] // page] = pool               # an OOB entry: both drop
    positions[7], positions[9] = -1, maxp * page        # the port's drop rule
    jax_table = table.copy()
    jax_table[[7, 9]] = pool
    new = _rows(8200 + bits, n, dtype)
    wq, ws = jax_append(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(jax_table),
                        jnp.asarray(np.where(positions < 0, 0, positions)), new)
    gq, gs = _t(vals.copy()), _port(scales)
    append(gq, gs, _t(table), _t(positions), _port(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert not np.array_equal(gq.numpy(), vals)
    # the JAX XLA append itself on the past-the-table lane: a write the port drops
    xq, _ = jax_append(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(table[9:10]),
                       jnp.asarray(positions[9:10]), new[9:10])
    assert not np.array_equal(np.asarray(xq), vals)


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slot_append_at_d64_is_bit_exact_against_jax(dtype):
    """G-q's plain version at D 64 (Smax 40) against JAX's
    ``append_tokens_q``: live positions at 0, mid and Smax - 1, and lanes at
    -1, at Smax and past it, which both drop."""
    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu_torch.ops.kvcache import append_tokens_q

    n, smax = 12, 40
    rng = np.random.default_rng(8300)
    cq = rng.integers(-127, 128, (n, HKV, smax, D)).astype(np.int8)
    cs = jnp.asarray(rng.uniform(0.01, 1.0, (n, HKV, smax)).astype(np.float32)).astype(jnp.bfloat16)
    positions = rng.integers(0, smax, n).astype(np.int32)
    positions[:2] = [0, smax - 1]
    positions[3], positions[7], positions[11] = -1, smax, smax + 5
    new = _rows(8301, n, dtype)
    wq, ws = jax_kv.append_tokens_q(jnp.asarray(cq), cs, jnp.asarray(positions), new)
    gq, gs = _t(cq.copy()), _port(cs)
    append_tokens_q(gq, gs, _t(positions), _port(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    for lane in (3, 7, 11):
        np.testing.assert_array_equal(gq[lane].numpy(), cq[lane])


@pytest.mark.quick
@pytest.mark.parametrize("bits", [8, 4])
def test_the_d64_edge_rows_store_their_codes_and_scales(bits):
    """What the kernels are held to on the card's edge lanes, at D 64: an
    all-zero row stores codes 0 and the scale bf16(1e-8 / qmax), a row
    whose max is one element stores +-qmax there, in either half of the
    row, and exact halves round to even; the packed row's byte j holds
    elements j and j + 32."""
    from gofr_tpu_torch.ops.kvcache import quantize_row
    from gofr_tpu_torch.ops.quant import pack_int4, quantize_row_int4, unpack_int4

    qmax, quantize = (127, quantize_row) if bits == 8 else (7, quantize_row_int4)
    q, s = quantize(_port(_rows(8400, 3, "bf16")))
    assert torch.all(q[0, 0] == 0)
    assert s[0, 0].to(torch.bfloat16).view(torch.int16) == (torch.tensor(1e-8) / qmax).to(
        torch.bfloat16).view(torch.int16)
    assert q[1, 0, 21] == qmax and q[1, 1, 32 + 13] == -qmax
    head = 0 if bits == 8 else 1
    assert q[2, head, 0] == qmax and s[2, head] == 1.0
    assert q[2, head, 1:6].tolist() == [4, -2, 0, 0, 2]  # 3.5, -2.5, -0.5, 0.5, 1.5
    if bits == 4:
        packed = pack_int4(q)
        assert packed.shape[-1] == D // 2
        assert torch.equal(packed[1, 1, 13] >> 4, torch.tensor(8 - 7, dtype=torch.uint8))
        assert torch.equal(unpack_int4(packed), q)


# -- Llama at head dim 64 on the int4 pool and the int8 slot cache ---------------------------


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
    assert cfg.head_size == jcfg.head_size == D
    return jcfg, params, params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.quick
@pytest.mark.parametrize("layout,kind", [("paged", "int4"), ("slot", "int8")])
def test_llama_d64_greedy_tokens_equal_the_jax_engine_on_quantized_caches(llama64, layout, kind):
    """Greedy tokens of the port's engine at head dim 64 equal the JAX
    engine's on the packed int4 pool and on the int8 slot cache (on the CPU,
    where the plain path serves them; the int8 pool is held in
    tests/test_torch_head_dim64.py)."""
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = llama64
    knobs = dict(slots=4, max_len=64, max_prefill_batch=2, kv_quantize=kind, kv_layout=layout)
    if layout == "paged":
        knobs["page_size"] = 8
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), **knobs)
    try:
        want = [r.result(timeout=120) for r in [jeng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        jeng.stop()
    eng = GenerateEngine(model, device="cpu", **knobs)
    try:
        assert eng.kv_layout == layout and eng.kv_quantize == kind
        assert eng.cache.k.shape[-1] == (D // 2 if kind == "int4" else D)
        got = [r.result(timeout=120) for r in [eng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        eng.stop()
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]


# -- the launchers, without a launch -------------------------------------------------------


def _on_the_card(monkeypatch):
    """Every tensor reads as on the card, ``bind`` records the entry point
    and the arguments of the call it returns, the stream is 0; the
    launchers' own checks stay. Returns the list of (entry, args)."""
    from gofr_tpu_torch.ops import cuda

    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(cuda, "bind", lambda name, argtypes: (
        lambda *args: calls.append((name, args)) or 0))
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    for fn in cuda._wrappers().values():
        monkeypatch.setattr(fn, "launches", 0)
    return calls


def _launch_all(d: int) -> None:
    """Each quantized-cache launcher once at head dim ``d``."""
    from gofr_tpu_torch.ops.cuda import kv_append as append_mod
    from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4

    n, hq, hkv, page, maxp, pool, smax = 3, 8, 2, 16, 4, 10, 40
    bf = torch.bfloat16
    q, rows = torch.zeros(n, hq, d, dtype=bf), torch.zeros(n, hkv, d, dtype=bf)
    scales = torch.zeros(pool, hkv, page, dtype=bf)
    q8 = torch.zeros(pool, hkv, page, d, dtype=torch.int8)
    q4 = torch.zeros(pool, hkv, page, d // 2, dtype=torch.uint8)
    slot8, slot_s = torch.zeros(n, hkv, smax, d, dtype=torch.int8), torch.zeros(n, hkv, smax, dtype=bf)
    table, lengths = torch.zeros(n, maxp, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    paged_decode_q(q, q8, q8, scales, scales, table, lengths)
    paged_decode_q4(q, q4, q4, scales, scales, table, lengths)
    append_mod.kv_append_q(q8, q8, scales, scales, table, lengths, rows, rows)
    append_mod.kv_append_q4(q4, q4, scales, scales, table, lengths, rows, rows)
    append_mod.kv_append_slot_q(slot8, slot8, slot_s, slot_s, lengths, rows, rows)


QUANTIZED = ("paged_decode_q", "paged_decode_q4", "kv_append_q", "kv_append_q4", "kv_append_slot_q")


@pytest.mark.quick
@pytest.mark.parametrize("d", [128, 64])
def test_quantized_launchers_bind_and_count_each_head_dim_apart(d, monkeypatch):
    """A 64 call of each of the five launchers binds its ``_d64`` entry
    point and counts under its ``_d64`` name, passing D 64 to the appends;
    a 128 call binds and counts the 128 build alone."""
    from gofr_tpu_torch.ops import cuda

    calls = _on_the_card(monkeypatch)
    _launch_all(d)
    suffix = "_d64" if d == 64 else ""
    assert [name for name, _ in calls] == [f"gofr_{k}{suffix}" for k in QUANTIZED]
    counts = cuda.launch_counts()
    assert {k for k, c in counts.items() if c} == {f"{k}{suffix}" for k in QUANTIZED}
    assert all(counts[f"{k}{suffix}"] == 1 for k in QUANTIZED)
    # the appends hand their C entry point the head dim, just before the stream
    assert [args[-2] for _, args in calls[2:]] == [d, d, d]


@pytest.mark.quick
def test_quantized_launchers_refuse_other_head_dims(monkeypatch):
    """A head dim of 32 raises before any entry point is bound; the ``_d64``
    wrappers raise at 128; a tensor off the card raises."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import kv_append as append_mod
    from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q, paged_decode_q_d64
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4_d64

    with pytest.raises(ValueError, match="on the card"):
        paged_decode_q_d64(torch.zeros(2, 4, 64, dtype=torch.bfloat16),
                           *(torch.zeros(4, 2, 8, 64, dtype=torch.int8),) * 2,
                           *(torch.zeros(4, 2, 8, dtype=torch.bfloat16),) * 2,
                           torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32))
    calls = _on_the_card(monkeypatch)
    with pytest.raises(ValueError, match="128 or 64"):
        _launch_all(32)
    bf = torch.bfloat16
    q, s = torch.zeros(2, 4, 32, dtype=bf), torch.zeros(4, 2, 8, dtype=bf)
    table, lengths = torch.zeros(2, 2, dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    for launch in (lambda: append_mod.kv_append_q4(*(torch.zeros(4, 2, 8, 16, dtype=torch.uint8),) * 2,
                                                   s, s, table, lengths,
                                                   *(torch.zeros(2, 2, 32, dtype=bf),) * 2),
                   lambda: append_mod.kv_append_slot_q(*(torch.zeros(2, 2, 8, 32, dtype=torch.int8),) * 2,
                                                       *(torch.zeros(2, 2, 8, dtype=bf),) * 2, lengths,
                                                       *(torch.zeros(2, 2, 32, dtype=bf),) * 2),
                   lambda: paged_decode_q(q, *(torch.zeros(4, 2, 8, 32, dtype=torch.int8),) * 2, s, s,
                                          table, lengths)):
        with pytest.raises(ValueError, match="128 or 64"):
            launch()
    q128, p128 = torch.zeros(2, 4, 128, dtype=bf), torch.zeros(4, 2, 8, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="takes head_dim 64"):
        paged_decode_q_d64(q128, p128, p128, s, s, table, lengths)
    with pytest.raises(ValueError, match="takes head_dim 64"):
        paged_decode_q4_d64(q128, p128[..., :64].view(torch.uint8), p128[..., :64].view(torch.uint8),
                            s, s, table, lengths)
    rows128 = torch.zeros(2, 2, 128, dtype=bf)
    for wrapper, planes in ((append_mod.kv_append_q_d64, (p128, p128, s, s, table)),
                            (append_mod.kv_append_q4_d64, (p128[..., :64].view(torch.uint8),) * 2
                             + (s, s, table))):
        with pytest.raises(ValueError, match="takes head_dim 64"):
            wrapper(*planes, lengths, rows128, rows128)
    with pytest.raises(ValueError, match="takes head_dim 64"):
        append_mod.kv_append_slot_q_d64(torch.zeros(2, 2, 8, 128, dtype=torch.int8),
                                        torch.zeros(2, 2, 8, 128, dtype=torch.int8),
                                        torch.zeros(2, 2, 8, dtype=bf), torch.zeros(2, 2, 8, dtype=bf),
                                        lengths, rows128, rows128)
    assert not calls and set(cuda.launch_counts().values()) == {0}


@pytest.mark.quick
@pytest.mark.parametrize("op", ["paged_decode_q", "paged_decode_q4"])
def test_the_64_builds_take_the_plan_the_autotuner_pinned(op, monkeypatch):
    """The tuner pins plans by op (``paged_decode_q``, ``paged_decode_q4``)
    at a shape key that carries the head dim: a 64 launch inside the
    decision scope at its own shape takes the pinned rows and counts under
    the ``_d64`` name; the same launch at another shape keeps the rule's."""
    from gofr_tpu_torch.ops import autotune, cuda
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan
    from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4

    calls = _on_the_card(monkeypatch)
    n, hq, hkv, page, maxp, pool = 4, 32, 4, 128, 16, 64
    bf = torch.bfloat16
    per_byte, launch = (1, paged_decode_q) if op == "paged_decode_q" else (2, paged_decode_q4)
    plane = torch.zeros(pool, hkv, page, D // per_byte,
                        dtype=torch.int8 if per_byte == 1 else torch.uint8)
    s = torch.zeros(pool, hkv, page, dtype=bf)
    q = torch.zeros(n, hq, D, dtype=bf)
    table, lengths = torch.zeros(n, maxp, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    rule = split_plan(n, hkv, maxp * page)[0]
    pinned = 512 if rule != 512 else 256
    key = autotune.shape_key(n, hq, hkv, D, page, maxp, pool)
    with autotune.decision_scope({op: autotune.plan_name(pinned)}, {op: key},
                                 {op: "int8/bfloat16" if per_byte == 1 else "int4/bfloat16"}):
        launch(q, plane, plane, s, s, table, lengths)
        launch(q, plane[:-1].contiguous(), plane[:-1].contiguous(), s[:-1].contiguous(),
               s[:-1].contiguous(), table, lengths)
    # split_rows follows the 9 pointers and n, hkv, group, pool, page, maxp
    assert [args[15] for _, args in calls] == [pinned, rule]
    assert cuda.launch_counts()[f"{op}_d64"] == 2 and cuda.launch_counts()[op] == 0


# -- the card's refusal of what it has no kernel for ------------------------------------------


class _Drawn(Exception):
    """Raised where the weights would be drawn: the refusal let it through."""


@pytest.fixture
def on_the_card(monkeypatch):
    """``build_engine`` and the engines resolve the device to ``cuda``, and
    drawing weights raises ``_Drawn``."""
    from gofr_tpu_torch.gpu import engine

    monkeypatch.setattr(engine, "resolve_device", lambda device=None: torch.device("cuda"))

    def draw(*args, **kw):
        raise _Drawn()

    monkeypatch.setattr(engine, "_model", draw)
    return engine


def _configs():
    from gofr_tpu_torch.models import GPT2Config, LlamaConfig

    bf = torch.bfloat16
    d64 = {"hidden_size": 256, "num_heads": 4, "num_kv_heads": 2}
    return {"gpt2_small_f32": GPT2Config.small(), "llama_tiny_f32": LlamaConfig.tiny(**d64),
            "llama_d32": LlamaConfig.tiny(hidden_size=128, dtype=bf),
            "llama_d16": LlamaConfig.tiny(dtype=bf),
            "llama_d64": LlamaConfig.tiny(**d64, dtype=bf),
            "llama_d128": LlamaConfig.tiny(head_dim=128, dtype=bf),
            "gpt2_small_bf16": GPT2Config.small(dtype=bf),
            "gpt2_small_fp16": GPT2Config.small(dtype=torch.float16),
            "llama_d128_f32": LlamaConfig.tiny(head_dim=128)}


# the caches (layout, kv_quantize) and weight quantization each family asks
# for; an f32 model passes the refusal on every one of them (every kernel
# has an f32 build) and goes on to the weight draw (GPT-2's int8 slot cache
# and paged layout, which the family lacks, are refused after it, by the
# engine, as in bf16)
_ALL_CACHES = {"gpt2": [("paged", "", ""), ("slot", "", "")],
               "llama": [("paged", "", ""), ("paged", "int8", ""), ("paged", "int4", ""),
                         ("slot", "", ""), ("slot", "int8", "")]}
_F32_ASKED = {"gpt2": [("slot", "int8", ""), ("slot", "", "int8"), ("paged", "", "")],
              "llama": [*_ALL_CACHES["llama"], ("slot", "", "int8"), ("paged", "", "int8")]}


@pytest.mark.quick
@pytest.mark.parametrize("name,match", [("gpt2_small_f32", None),
                                        ("llama_tiny_f32", None),
                                        ("llama_d32", "head dim 32"),
                                        ("llama_d16", "head dim 16"),
                                        ("gpt2_small_fp16", "take bf16, and f32")])
def test_unbuilt_models_are_refused_on_the_card_before_any_weight(on_the_card, name, match):
    """A head dim other than 128 and 64, and a dtype other than bf16 and
    f32 (fp16), is refused on every cache before a weight is drawn; an f32
    generate model (its config's default dtype: GPT-2 small, the tiny Llama
    at head dim 64) on every cache it asks for, the int4 pool and the int8
    slot cache among them, and with int8 weights, is refused on none: each
    goes on to the weight draw (``match`` None). The CPU refuses none of
    them."""
    from gofr_tpu_torch.models import GPT2Config

    cfg = _configs()[name]
    family = "gpt2" if isinstance(cfg, GPT2Config) else "llama"
    if isinstance(cfg, GPT2Config):
        assert cfg.head_size == D
    if match is None:
        assert cfg.dtype == torch.float32
        for layout, kind, quantize in _F32_ASKED[family]:
            with pytest.raises(_Drawn):
                on_the_card.build_engine(cfg, kv_quantize=kind, kv_layout=layout,
                                         quantize=quantize)
        on_the_card.refuse_unbuilt_kernels(cfg, torch.device("cuda"))
    else:
        for layout, kind, quantize in _ALL_CACHES[family]:
            with pytest.raises(ValueError, match=match):
                on_the_card.build_engine(cfg, kv_quantize=kind, kv_layout=layout,
                                         quantize=quantize)
    on_the_card.refuse_unbuilt_kernels(cfg, torch.device("cpu"))


@pytest.mark.quick
@pytest.mark.parametrize("name", ["gpt2_small_f32", "llama_tiny_f32", "llama_d128_f32"])
def test_f32_models_on_the_slot_cache_pass_the_refusal(on_the_card, name):
    """An f32 model at head dim 64 or 128 on the slot cache with no KV or
    weight quantization passes (C, F and G have f32 builds, the model's own
    dtype is served): the build goes on to draw the weights; so does its
    layout's default for GPT-2 (the slot cache)."""
    cfg = _configs()[name]
    assert cfg.dtype == torch.float32
    with pytest.raises(_Drawn):
        on_the_card.build_engine(cfg, kv_layout="slot")
    if name == "gpt2_small_f32":
        with pytest.raises(_Drawn):
            on_the_card.build_engine(cfg)
    on_the_card.refuse_unbuilt_kernels(cfg, torch.device("cuda"))


@pytest.mark.quick
@pytest.mark.parametrize("name", ["llama_d64", "llama_d128", "gpt2_small_bf16"])
def test_bf16_models_at_built_head_dims_pass_the_refusal(on_the_card, name):
    """bf16 at head dim 64 and 128 passes on every cache it has, the int8
    and int4 pools and the int8 slot cache at 64 among them: the build
    goes on to draw the weights."""
    from gofr_tpu_torch.models import GPT2Config

    cfg = _configs()[name]
    kinds = [("slot", "")] if isinstance(cfg, GPT2Config) else [
        ("paged", ""), ("paged", "int8"), ("paged", "int4"), ("slot", ""), ("slot", "int8")]
    for layout, kind in kinds:
        with pytest.raises(_Drawn):
            on_the_card.build_engine(cfg, kv_quantize=kind, kv_layout=layout)
    on_the_card.refuse_unbuilt_kernels(cfg, torch.device("cuda"))


@pytest.mark.quick
def test_the_model_spec_route_refuses_f32_before_any_weight(on_the_card):
    """``build_engine(ModelSpec(...), container)``, the App's route: GPT-2
    asked for in f32 goes on to draw on its default layout, the slot cache,
    with ``ENGINE_QUANTIZE=int8`` (W8A16's f32 build) and with an int8 slot
    cache (which the engine, built after the draw, refuses, as in bf16:
    the family has none); Llama one_b in f32 goes on to draw on its default
    layout, the pool (A and B's f32 builds), on the int8 pool, on the int4
    pool (E and B-q4's f32 builds) and on the slot cache;
    ``ModelSpec("gpt2")`` takes the spec's default dtype, bf16, and goes on
    to draw; so does bf16 Llama one_b on the int4 pool."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.models import LlamaConfig, ModelSpec

    c = new_mock_container()
    f32 = torch.float32
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("gpt2", dtype=f32), c)
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("gpt2", dtype=f32), new_mock_container(
            {"ENGINE_QUANTIZE": "int8"}))
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("gpt2", dtype=f32), c, kv_quantize="int8")
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("llama", LlamaConfig.one_b(), dtype=f32), c)
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("llama", LlamaConfig.one_b(), dtype=f32), c,
                                 kv_quantize="int8")
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("llama", LlamaConfig.one_b(), dtype=f32), c,
                                 kv_quantize="int4")
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("llama", LlamaConfig.one_b(), dtype=f32), c,
                                 kv_layout="slot")
    assert ModelSpec("gpt2").dtype == torch.bfloat16
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("gpt2"), c)
    with pytest.raises(_Drawn):
        on_the_card.build_engine(ModelSpec("llama", LlamaConfig.one_b()), c, kv_quantize="int4")


@pytest.mark.quick
def test_the_engine_refuses_an_f32_model_or_draft_before_its_cache(on_the_card, llama64):
    """``GenerateEngine`` itself refuses a model (or a speculative draft)
    the card has no kernel for before it makes a pool: an fp16 draft, a
    draft at head dim 16; the f32 model on an int8 pool, on an int4 pool,
    on its default layout (the pool), on the slot cache and with int8
    weights (``QLinear`` in it), a bf16 model at head dim 64 with an int8
    pool and a bf16 target with the f32 draft pass the refusal (every
    kernel has an f32 build) and meet the next check (the model lives on
    the CPU, or on meta)."""
    from gofr_tpu_torch.models.llama import LlamaConfig
    from gofr_tpu_torch.ops.quant import quantize_tree

    _, _, model = llama64
    assert model.cfg.dtype == torch.float32
    with pytest.raises(ValueError, match="model lives on cpu"):
        on_the_card.GenerateEngine(model, device="cuda", kv_quantize="int8")
    with pytest.raises(ValueError, match="model lives on cpu"):
        on_the_card.GenerateEngine(model, device="cuda")
    with pytest.raises(ValueError, match="model lives on cpu"):
        on_the_card.GenerateEngine(model, device="cuda", kv_quantize="int4")
    with pytest.raises(ValueError, match="model lives on cpu"):
        on_the_card.GenerateEngine(quantize_tree(model), device="cuda", kv_layout="slot")
    with pytest.raises(ValueError, match="model lives on cpu"):
        on_the_card.GenerateEngine(model, device="cuda", kv_layout="slot")
    bf16 = type(model)(LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                                        dtype=torch.bfloat16), "meta")
    with pytest.raises(ValueError, match="model lives on meta"):
        on_the_card.GenerateEngine(bf16, device="cuda", kv_quantize="int8")
    with pytest.raises(ValueError, match="model lives on meta"):
        on_the_card.GenerateEngine(bf16, device="cuda", kv_layout="slot", spec_tokens=2,
                                   spec_draft=(model.cfg, model))
    fp16 = type(model)(LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2,
                                        dtype=torch.float16), "meta")
    with pytest.raises(ValueError, match="take bf16, and f32"):
        on_the_card.GenerateEngine(bf16, device="cuda", kv_layout="slot", spec_tokens=2,
                                   spec_draft=(fp16.cfg, fp16))
    with pytest.raises(ValueError, match="head dim 16"):
        on_the_card.build_engine(bf16.cfg, spec_draft=(LlamaConfig.tiny(), None),
                                 spec_tokens=2, kv_layout="slot")


# -- the 64 builds against their plain versions (on the card only) --------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _within(got, want, module):
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt().clamp_min(1e-30)
    return bool(got.float().isfinite().all()) and diff.abs().max().item() <= module.MAX_ABS \
        and rel.item() <= module.RMS_REL


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_d64_quantized_decode_builds_match_plain_on_the_card(bits):
    """D64 and E64 at ``one_b``'s heads (Hq 32, Hkv 4, page 128) on ragged
    lengths of hundreds of keys and an empty slot, pools written by the
    port's quantizing prompt write; split edges against the split plain
    version; nothing but the 64 build launches."""
    _needs_card()
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_q4_plain,
        paged_decode_attention_q_plain,
        paged_decode_attention_q_split_plain,
    )
    from gofr_tpu_torch.ops.cuda import decode_attention as slot_mod
    from gofr_tpu_torch.ops.cuda import paged_decode_q, paged_decode_q4
    from gofr_tpu_torch.ops.paged import (
        Q4PagedKVCache,
        QPagedKVCache,
        write_prompts_paged_q,
        write_prompts_paged_q4,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(640 + bits)
    mod, cls, write, plain = ((paged_decode_q, QPagedKVCache, write_prompts_paged_q,
                               paged_decode_attention_q_plain) if bits == 8 else
                              (paged_decode_q4, Q4PagedKVCache, write_prompts_paged_q4,
                               paged_decode_attention_q4_plain))
    launch = mod.paged_decode_q if bits == 8 else mod.paged_decode_q4
    n, pool, page, maxp = 5, 60, 128, 12
    cache = cls.create(1, pool, page, 4, 64, device=dev)
    table = torch.randperm(pool, device=dev, generator=g)[:n * maxp].to(torch.int32).view(n, maxp)
    table[4] = pool
    for plane in ("k", "v"):
        rows = torch.randn(n, maxp * page, 4, 64, device=dev, generator=g).to(bf)
        write(getattr(cache, plane)[0], getattr(cache, plane + "s")[0], table, rows)
    args = (cache.k[0], cache.v[0], cache.ks[0], cache.vs[0])
    lengths = torch.tensor([699, 1200, 1536, 300, 0], device=dev, dtype=torch.int32)
    q = torch.randn(n, 32, 64, device=dev, generator=g).to(bf)
    cuda.reset_launch_counts()
    got = launch(q, *args, table, lengths)
    assert _within(got, plain(q, *args, table, lengths), mod)
    assert torch.all(got[4] == 0)
    r, _ = slot_mod.split_plan(n, 4, maxp * page)
    edges = torch.tensor([r, r + 1, 2 * r, maxp * page, 0], device=dev, dtype=torch.int32)
    got = launch(q, *args, table, edges)
    assert _within(got, paged_decode_attention_q_split_plain(q, *args, table, edges, r, bits=bits),
                   mod)
    name = "paged_decode_q" if bits == 8 else "paged_decode_q4"
    assert {k: v for k, v in cuda.launch_counts().items() if v} == {f"{name}_d64": 2}


@pytest.mark.cuda
def test_d64_quantizing_appends_match_plain_bit_for_bit_on_the_card():
    """B-q64, B-q4-64 and G-q64 against their plain versions, values and
    scales, on edge lanes: -1, past the table, an OOB entry, past Smax."""
    _needs_card()
    from gofr_tpu_torch.ops.cuda import kv_append as mod
    from gofr_tpu_torch.ops.kvcache import append_tokens_q
    from gofr_tpu_torch.ops.paged import append_tokens_paged_q, append_tokens_paged_q4

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(66)
    n, hkv, page, pool, maxp, smax = 6, 4, 16, 40, 4, 100
    table = torch.randperm(pool, device=dev, generator=g)[:n * maxp].to(torch.int32).view(n, maxp)
    positions = torch.tensor([17, -1, maxp * page, 33, 5, 63], device=dev, dtype=torch.int32)
    table[3, 2] = pool
    rows = [torch.randn(n, hkv, 64, device=dev, generator=g).mul(7).to(bf) for _ in range(2)]
    for launch, plain, width, dtype in ((mod.kv_append_q, append_tokens_paged_q, 64, torch.int8),
                                        (mod.kv_append_q4, append_tokens_paged_q4, 32, torch.uint8)):
        vals = [torch.randint(0, 100, (pool, hkv, page, width), device=dev, generator=g).to(dtype)
                for _ in range(2)]
        scales = [torch.rand(pool, hkv, page, device=dev, generator=g).to(bf) for _ in range(2)]
        got = [t.clone() for t in vals + scales]
        want = [t.clone() for t in got]
        launch(*got, table, positions, *rows)
        for i in range(2):
            plain(want[i], want[2 + i], table, positions, rows[i])
        assert all(torch.equal(a.view(torch.int16) if a.dtype == bf else a,
                               b.view(torch.int16) if b.dtype == bf else b)
                   for a, b in zip(got, want))
        assert not torch.equal(got[0], vals[0])
    spos = torch.tensor([99, smax, 0, -1, smax + 3, 50], device=dev, dtype=torch.int32)
    vals = [torch.randint(-127, 128, (n, hkv, smax, 64), device=dev, generator=g).to(torch.int8)
            for _ in range(2)]
    scales = [torch.rand(n, hkv, smax, device=dev, generator=g).to(bf) for _ in range(2)]
    got = [t.clone() for t in vals + scales]
    want = [t.clone() for t in got]
    mod.kv_append_slot_q(*got, spos, *rows)
    for i in range(2):
        append_tokens_q(want[i], want[2 + i], spos, rows[i])
    assert all(torch.equal(a.view(torch.int16) if a.dtype == bf else a,
                           b.view(torch.int16) if b.dtype == bf else b) for a, b in zip(got, want))
    assert torch.equal(got[0][1], vals[0][1]) and torch.equal(got[0][3], vals[0][3])
