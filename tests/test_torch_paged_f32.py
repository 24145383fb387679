"""Kernels A, B, D and B-q on f32 inputs, held against the JAX package.

The JAX package serves an f32 Llama (``LlamaConfig.tiny``'s own dtype) on
its default layout, the paged pool, whose dtype is the model's
(``gofr_tpu/models/llama.py:591``), and on the int8 pool. Its Pallas decode
kernels take any float dtype: ``_paged_decode_kernel`` writes its output
in ``o_ref.dtype`` and ``softmax_block_update`` casts P to ``v.dtype``
(unrounded at f32); ``_paged_decode_q_kernel`` takes ``k.astype(q.dtype)``
against an f32 q with f32 accumulation. On the card kernel A has f32
builds (``csrc/paged_decode.cu``, ``PoolRows``), B f32 rows on the pool
(``F32Rows x PoolAddr``), D an f32-q build (``csrc/paged_decode_q.cu``, q
split into three bf16 pieces) and B-q an f32-row build, at head dims 128
and 64. Here their plain versions, which the launchers take for a tensor
on the CPU and which ``chip_smoke.py`` holds each build against on the
card, are held at f32 against the Pallas kernels in interpret mode (as
tests/test_pallas.py runs them) and against JAX's XLA append; an f32 Llama
at head dims 64 and 128 on both pools against the JAX engine. The
launchers are checked without a launch (an f32 call binds its f32 entry
point and counts under its ``_f32`` name; fp16 is refused), and so are the
autotuner's pins: A's
carry the pool's dtype, D's the query's (``int8/float32``), so a pin of
one build never steers another. The ``cuda``-marked tests hold each new
build against its plain version on the card (``python -m pytest
tests/test_torch_paged_f32.py -m cuda --noconftest``: they import no JAX).

Tolerances:
- decode attention, f32, against Pallas: 1e-5 absolute (only the order of
  the f32 sums differs; outputs are of order 1);
- appends: bit for bit (B against the Pallas append, B-q against JAX's
  ``append_tokens_paged_q``, as tests/test_torch_quant.py holds bf16 and
  f32 rows at head dim 16);
- greedy tokens: exact; logits of the model on the pools: 1e-4, as
  tests/test_torch_llama.py;
- on the card, the launchers' f32 limits (``F32``: 1e-4 on any element,
  2e-5 on the RMS ratio), B and B-q bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
PAGE, MAXP = 32, 6          # 192 positions a table row; an f32 tile is 32 rows
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    """Bit pattern of an array or tensor (bf16 tensors by their int16 view)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _pool_case(seed, d, group, hkv=2):
    """q, table and lengths over a pool of 2 x MaxP pages: lengths 0, on and
    one past a page edge, on and one past a 64-row split, the whole table
    row and past it (clamped), and 17; tables in scrambled order with
    repeats, OOB entries (== P) inside two live lanes, the empty lane's row
    all OOB."""
    rng = np.random.default_rng(seed)
    pool, span = 2 * MAXP, MAXP * PAGE
    lengths = np.array([0, PAGE, PAGE + 1, 64, 65, span, span + 5, 17], np.int32)
    table = rng.integers(0, pool, (len(lengths), MAXP)).astype(np.int32)
    table[0] = pool
    table[2, 1] = pool           # inside lane 2's second page: never read
    table[5, MAXP - 1] = pool    # lane 5's last page: read as page P - 1
    table[4, 1] = table[4, 0]
    q = rng.standard_normal((len(lengths), hkv * group, d)).astype(np.float32)
    return rng, pool, q, table, lengths


# -- A: the plain and split plain versions at f32 against Pallas ---------------------


@pytest.mark.quick
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_plain_and_split_at_f32_match_pallas(d, group):
    """Kernel A's plain version and its split form (the f32 build's split
    and merge, P unrounded) against the Pallas ``paged_decode_attention``
    in f32; the empty slot is 0 and a length past the table reads as the
    whole table row."""
    import jax.numpy as jnp

    from gofr_tpu.ops.pallas.paged_decode import paged_decode_attention as pallas_paged
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_plain,
        paged_decode_attention_split_plain,
    )

    rng, pool, q, table, lengths = _pool_case(7 * d + group, d, group)
    k_pool, v_pool = (rng.standard_normal((pool, 2, PAGE, d)).astype(np.float32) for _ in range(2))
    want = np.asarray(pallas_paged(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                                   jnp.asarray(table), jnp.asarray(lengths), interpret=True))
    args = (_t(q), _t(k_pool), _t(v_pool), _t(table))
    clamped = _t(np.minimum(lengths, MAXP * PAGE))
    for attend in (paged_decode_attention_plain,
                   *(lambda *a, r=r: paged_decode_attention_split_plain(*a, r) for r in (64, 128))):
        got = attend(*args, _t(lengths))
        assert got.dtype == torch.float32 and torch.all(got[0] == 0)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
        torch.testing.assert_close(got, attend(*args, clamped), rtol=0, atol=0)


# -- D: an f32 q over the int8 pool ------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_q_plain_and_split_with_an_f32_q_match_pallas(d, group):
    """Kernel D's plain version and its split form with an f32 q (q.k and
    p * vs in f32, the f32-q build's arithmetic) against the Pallas
    ``paged_decode_attention_q`` with the same f32 q, over int8 pages and
    bf16 scales."""
    import jax.numpy as jnp

    from gofr_tpu.ops.pallas.paged_decode import paged_decode_attention_q as pallas_paged_q
    from gofr_tpu_torch.models.llama import tensor_from_numpy
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_q_plain,
        paged_decode_attention_q_split_plain,
    )

    rng, pool, q, table, lengths = _pool_case(11 * d + group, d, group)
    kq, vq = (rng.integers(-127, 128, (pool, 2, PAGE, d)).astype(np.int8) for _ in range(2))
    ks, vs = (jnp.asarray(rng.uniform(0.005, 0.05, (pool, 2, PAGE)).astype(np.float32))
              .astype(jnp.bfloat16) for _ in range(2))
    want = np.asarray(pallas_paged_q(jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), ks, vs,
                                     jnp.asarray(table), jnp.asarray(lengths), interpret=True))
    assert want.dtype == np.float32
    args = (_t(q), _t(kq), _t(vq), tensor_from_numpy(np.asarray(ks)),
            tensor_from_numpy(np.asarray(vs)), _t(table), _t(lengths))
    for got in (paged_decode_attention_q_plain(*args),
                *(paged_decode_attention_q_split_plain(*args, rows, bits=8) for rows in (64, 128))):
        assert got.dtype == torch.float32 and torch.all(got[0] == 0)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


# -- B and B-q: the appends on f32 rows, bit for bit -------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("d", [64, 128])
def test_f32_pool_append_is_bit_exact_against_pallas_and_drops_past_the_table(d):
    """B on the f32 pool against the Pallas ``append_tokens_paged_inplace``
    (interpret mode): a mid-page write, the last row of a page and the
    first of the next, an OOB entry, a position past the table and a
    negative one (the last three dropped by both)."""
    import jax.numpy as jnp

    from gofr_tpu.ops.pallas.kv_append import append_tokens_paged_inplace
    from gofr_tpu_torch.ops.paged import append_tokens_paged

    rng = np.random.default_rng(5 * d)
    pool, n = 16, 6
    k_pool, v_pool = (rng.standard_normal((pool, 2, PAGE, d)).astype(np.float32) for _ in range(2))
    # page 0 is the TPU kernel's reserved sink: it stays out of every table
    table = (rng.permutation(pool - 1)[: n * 2] + 1).reshape(n, 2).astype(np.int32)
    table[3, 1] = pool
    positions = np.array([17, PAGE - 1, PAGE, PAGE + 3, 2 * PAGE, -1], np.int32)
    k_new, v_new = (rng.standard_normal((n, 2, d)).astype(np.float32) for _ in range(2))
    wk, wv = append_tokens_paged_inplace(*(jnp.asarray(a) for a in (k_pool, v_pool, table,
                                                                    positions, k_new, v_new)),
                                         interpret=True)
    gk, gv = _t(k_pool.copy()), _t(v_pool.copy())
    append_tokens_paged(gk, gv, _t(table), _t(positions), _t(k_new), _t(v_new))
    np.testing.assert_array_equal(gk.numpy().view(np.uint32), np.asarray(wk).view(np.uint32))
    np.testing.assert_array_equal(gv.numpy().view(np.uint32), np.asarray(wv).view(np.uint32))
    assert not np.array_equal(gk.numpy(), k_pool)


@pytest.mark.quick
@pytest.mark.parametrize("d", [64, 128])
def test_int8_pool_append_of_f32_rows_is_bit_exact_against_jax(d):
    """B-q's plain version on f32 rows (rows of widely different magnitudes,
    one all zero) against JAX's ``append_tokens_paged_q``, values and bf16
    scales bit for bit, at the positions both write (JAX's XLA append
    clamps a position past the table where the port drops it: Queue C)."""
    import jax.numpy as jnp

    from gofr_tpu.ops import kvcache as jax_kv, paged as jax_paged
    from gofr_tpu_torch.models.llama import tensor_from_numpy
    from gofr_tpu_torch.ops.paged import append_tokens_paged_q

    rng = np.random.default_rng(9 * d)
    pool, n = 12, 4
    rows = rng.standard_normal((pool, 2, PAGE, d)).astype(np.float32)
    vals, scales = jax_kv.quantize_row(jnp.asarray(rows))
    vals, scales = np.asarray(vals), np.asarray(scales.astype(jnp.bfloat16))
    table = rng.permutation(pool)[: n * 3].reshape(n, 3).astype(np.int32)
    table[2, 2] = pool
    positions = np.array([40, 0, 95, PAGE], np.int32)
    new = (rng.standard_normal((n, 2, d)) * rng.uniform(1e-3, 50.0, (n, 2, 1))).astype(np.float32)
    new[1] = 0.0
    wq, ws = jax_paged.append_tokens_paged_q(jnp.asarray(vals), jnp.asarray(scales),
                                             jnp.asarray(table), jnp.asarray(positions),
                                             jnp.asarray(new))
    gq, gs = _t(vals.copy()), tensor_from_numpy(scales)
    append_tokens_paged_q(gq, gs, _t(table), _t(positions), _t(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert not np.array_equal(gq.numpy(), vals)


# -- the launchers, without a card -------------------------------------------------------


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """Every tensor claims to lie on the card; ``cuda.bind`` records the
    entry point, its argument types' count and the C call's arguments, and
    the call returns 0."""
    from gofr_tpu_torch.ops import cuda

    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(cuda, "bind", lambda name, argtypes: (
        lambda *args: calls.append((name, len(argtypes), args)) or 0))
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    cuda.reset_launch_counts()
    yield calls
    cuda.reset_launch_counts()


def _pools(d, dtype, n=3, hkv=2, pool=5):
    """Planes, table and positions of a small pool of ``dtype`` (int8 with
    bf16 scales when ``dtype`` is int8)."""
    planes = torch.zeros(pool, hkv, PAGE, d, dtype=dtype)
    scales = torch.zeros(pool, hkv, PAGE, dtype=torch.bfloat16)
    table, positions = torch.zeros(n, 4, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    return planes, scales, table, positions


@pytest.mark.quick
@pytest.mark.parametrize("d", [128, 64])
def test_the_f32_pool_launchers_bind_their_builds_and_count_apart(as_if_on_the_card, d):
    """A, B, D and B-q on f32 inputs bind the f32 entry points and count
    under the ``_f32`` names (``_d64_f32`` at 64); the same calls in bf16
    bind the bf16 builds; fp16 is refused by A, D and B, an f32 pool with
    pages that are not a multiple of 32 by A, and an fp16 q by E and fp16
    rows by B-q4 and G-q (whose f32 builds tests/test_torch_quantized_f32.py
    holds), all before any pointer reaches C."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append, kv_append_q, kv_append_q4, kv_append_slot_q
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode, paged_decode_f32
    from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q, paged_decode_q_f32
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4

    calls = as_if_on_the_card
    sfx = "_d64" if d == 64 else ""
    n, hq = 3, 4
    for dtype, name in ((torch.float32, "_f32"), (torch.bfloat16, "")):
        pool, _, table, pos = _pools(d, dtype)
        q, rows = torch.zeros(n, hq, d, dtype=dtype), torch.zeros(n, 2, d, dtype=dtype)
        paged_decode(q, pool, pool, table, pos)
        kv_append(pool, pool, table, pos, rows, rows)
        qpool, scales, _, _ = _pools(d, torch.int8)
        paged_decode_q(q, qpool, qpool, scales, scales, table, pos)
        kv_append_q(qpool, qpool, scales, scales, table, pos, rows, rows)
        counts = cuda.launch_counts()
        for kernel in ("paged_decode", "kv_append", "paged_decode_q", "kv_append_q"):
            assert counts[kernel + sfx + name] == 1, kernel + sfx + name
    assert sum(cuda.launch_counts().values()) == 8
    assert [c[0] for c in calls[:4]] == [f"gofr_paged_decode{sfx}_f32", f"gofr_kv_append{sfx}_f32",
                                         f"gofr_paged_decode_q{sfx}_f32",
                                         f"gofr_kv_append_q{sfx}_f32"]
    assert [c[0] for c in calls[4:]] == [f"gofr_paged_decode{sfx}", f"gofr_kv_append{sfx}",
                                         f"gofr_paged_decode_q{sfx}", f"gofr_kv_append_q{sfx}"]
    assert all(n_types == len(args) for _, n_types, args in calls)
    # the named f32 wrappers refuse other types; fp16 everywhere
    half, _, table, pos = _pools(d, torch.float16)
    qh = torch.zeros(n, hq, d, dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        paged_decode(qh, half, half, table, pos)
    with pytest.raises(ValueError, match="f32"):
        paged_decode_f32(qh.to(torch.bfloat16), half.to(torch.bfloat16), half.to(torch.bfloat16),
                         table, pos)
    qpool, scales, _, _ = _pools(d, torch.int8)
    with pytest.raises(ValueError, match="bfloat16 or float32 q"):
        paged_decode_q(qh, qpool, qpool, scales, scales, table, pos)
    with pytest.raises(ValueError, match="f32"):
        paged_decode_q_f32(qh.to(torch.bfloat16), qpool, qpool, scales, scales, table, pos)
    # an f32 pool of pages of 40: a 32-row f32 tile would straddle a page
    odd = torch.zeros(5, 2, 40, d)
    with pytest.raises(ValueError, match="multiple of 32"):
        paged_decode(torch.zeros(n, hq, d), odd, odd, table, pos)
    # fp16 on E's q, B-q4's and G-q's rows
    q16, rows16 = torch.zeros(n, hq, d, dtype=torch.float16), torch.zeros(n, 2, d,
                                                                          dtype=torch.float16)
    q4pool = torch.zeros(5, 2, PAGE, d // 2, dtype=torch.uint8)
    with pytest.raises(ValueError, match="bfloat16 or float32 q"):
        paged_decode_q4(q16, q4pool, q4pool, scales, scales, table, pos)
    with pytest.raises(ValueError, match="bf16 or f32 rows"):
        kv_append_q4(q4pool, q4pool, scales, scales, table, pos, rows16, rows16)
    slot = torch.zeros(n, 2, 64, d, dtype=torch.int8)
    slot_s = torch.zeros(n, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or f32 rows"):
        kv_append_slot_q(slot, slot, slot_s, slot_s, pos, rows16, rows16)
    assert sum(cuda.launch_counts().values()) == 8


# -- the autotuner's pins: A's carry the pool's dtype, D's the query's ----------------------


@pytest.mark.quick
@pytest.mark.parametrize("op", ["paged_decode", "paged_decode_q"])
def test_a_pin_of_one_build_never_steers_another(as_if_on_the_card, op):
    """A pin decided at A's f32 pool dims (``float32``) or at D's f32-q dims
    (``int8/float32``) is not returned for the same shapes at the other
    dtype, nor the other way round; each dtype's own launch takes it and
    the other keeps the rule's plan."""
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
    from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q, pin_dtype

    calls = as_if_on_the_card
    n, hq, hkv, d, maxp, pool = 3, 4, 2, 64, 16, 40
    shape = autotune.shape_key(n, hq, hkv, d, PAGE, maxp, pool)
    rule = split_plan(n, hkv, maxp * PAGE)[0]
    pinned = 256 if rule != 256 else 128
    table, lengths = torch.zeros(n, maxp, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    scales = torch.zeros(pool, hkv, PAGE, dtype=torch.bfloat16)

    def launch(dtype) -> int:
        """The split_rows a launch at ``dtype`` passes (after the 7 (A) or 9
        (D) pointers and n, hkv, group, pool, page, maxp)."""
        q = torch.zeros(n, hq, d, dtype=dtype)
        if op == "paged_decode":
            planes = torch.zeros(pool, hkv, PAGE, d, dtype=dtype)
            paged_decode(q, planes, planes, table, lengths)
            return calls[-1][2][13]
        planes = torch.zeros(pool, hkv, PAGE, d, dtype=torch.int8)
        paged_decode_q(q, planes, planes, scales, scales, table, lengths)
        return calls[-1][2][15]

    name = {dt: (autotune.dtype_name(dt) if op == "paged_decode" else pin_dtype("int8", dt))
            for dt in (torch.float32, torch.bfloat16)}
    for decided, other in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
        with autotune.decision_scope({op: autotune.plan_name(pinned)}, {op: shape},
                                     {op: name[decided]}):
            assert autotune.pinned_plan(op, autotune.pin_dims(shape, name[decided])) == pinned
            assert autotune.pinned_plan(op, autotune.pin_dims(shape, name[other])) is None
            assert (launch(decided), launch(other)) == (pinned, rule)
        assert (launch(decided), launch(other)) == (rule, rule)


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["", "int8"])
def test_an_f32_engine_tunes_its_pool_and_pins_at_its_dtype(monkeypatch, tmp_path, kind):
    """Warmup on the f32 pool (A) or on the int8 pool under an f32 model (D)
    times the plans at the f32 build's limits, records ``float32`` or
    ``int8/float32`` and pins at it: inside the engine's scope the f32
    launch takes the pin, a bf16 launch of the same shapes keeps the
    rule's plan."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.ops import attention as A
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates, split_scratch

    monkeypatch.delenv("GOFR_AUTOTUNE", raising=False)
    monkeypatch.setenv("GOFR_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "enabled", lambda device=None: True)
    eng = build_engine("tiny", device="cpu", seed=0, slots=2, max_len=64, page_size=PAGE,
                       kv_quantize=kind)
    assert eng.cfg.dtype == torch.float32 and eng.kv_layout == "paged"
    op = "paged_decode_q" if kind else "paged_decode"
    if kind:
        eng._autotune_launch = lambda op_, rows, skey, q, planes, lengths: (
            A.paged_decode_attention_q_split_plain(q, *planes, lengths, rows, bits=8))
    else:
        eng._autotune_launch = lambda op_, rows, skey, q, planes, lengths: (
            A.paged_decode_attention_split_plain(q, *planes, lengths, rows))
    span = eng.pages_per_slot * eng.page_size
    plans = split_candidates(2, eng.cfg.num_kv_heads, span)
    assert len(plans) >= 2
    times = iter([2e-3, 1e-3, 3e-3, 4e-3, 5e-3])
    eng._autotune_timer = lambda fn: (fn(), next(times))[1]
    try:
        eng.warmup()
    finally:
        eng.stop()
    dtype = f"{kind}/float32" if kind else "float32"
    rec = eng.autotune_report()["decisions"][op]
    assert rec["kv_dtype"] == dtype and eng._autotune_kv_dtypes == {op: dtype}
    assert eng._autotune_pins == {op: f"rows{plans[1]}"}
    cfg, n = eng.cfg, eng.num_slots
    dims = (n, cfg.num_heads, cfg.num_kv_heads, cfg.head_size, eng.page_size, eng.pages_per_slot,
            eng.total_pages)
    with eng._decision_scope():
        for dt, want in ((torch.float32, plans[1]), (torch.bfloat16, plans[0])):
            name = autotune.dtype_name(dt)
            q = torch.zeros(n, cfg.num_heads, cfg.head_size, dtype=dt)
            assert split_scratch(q, cfg.num_kv_heads, span, op,
                                 (*dims, f"{kind}/{name}" if kind else name))[0] == want


# -- the card's refusal: f32 on the pool and on the int8 pool passes --------------------


class _Drawn(Exception):
    """Raised where the weights would be drawn: the refusal let it through."""


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["", "int8"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_f32_on_the_paged_pool_reaches_the_weight_draw(monkeypatch, kind, head_dim):
    """On the card an f32 Llama at head dims 64 and 128 on ``kv_layout=
    "paged"`` with ``kv_quantize`` "" (A and B's f32 builds) or "int8" (D's
    f32-q build, B-q's f32 rows) passes ``refuse_unbuilt_kernels`` and goes
    on to draw its weights, by ``build_engine`` and by the ``ModelSpec``
    route; so does it on the int4 pool (E and B-q4's f32 builds) and with
    int8 weights (W8A16's f32 build)."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu import engine
    from gofr_tpu_torch.models import LlamaConfig, ModelSpec

    monkeypatch.setattr(engine, "resolve_device", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(engine, "_model", lambda *a, **kw: (_ for _ in ()).throw(_Drawn()))
    cfg = (LlamaConfig.tiny(hidden_size=256, num_heads=4, num_kv_heads=2) if head_dim == 64
           else LlamaConfig.tiny(head_dim=128))
    assert cfg.dtype == torch.float32 and cfg.head_size == head_dim
    with pytest.raises(_Drawn):
        engine.build_engine(cfg, kv_layout="paged", kv_quantize=kind)
    with pytest.raises(_Drawn):
        engine.build_engine(ModelSpec("llama", cfg, dtype=torch.float32), new_mock_container(),
                            kv_quantize=kind)
    engine.refuse_unbuilt_kernels(cfg, torch.device("cuda"))
    for quant, weights in (("int4", ""), (kind, "int8")):
        with pytest.raises(_Drawn):
            engine.build_engine(cfg, kv_layout="paged", kv_quantize=quant, quantize=weights)


# -- the slice as a whole: an f32 Llama on the f32 pool and the int8 pool --------------------


_MODELS = {}


def _llama(head_dim):
    """A 2-layer f32 Llama at ``head_dim`` (64: 256 wide with 4 heads of 64;
    128: the tiny widths with heads of 128), JAX weights from a key and the
    port's model on them."""
    if head_dim not in _MODELS:
        import jax

        from gofr_tpu.models import LlamaConfig, llama
        from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
        from gofr_tpu_torch.models.llama import params_from_jax

        kw = (dict(hidden_size=256, num_heads=4, num_kv_heads=2) if head_dim == 64
              else dict(head_dim=128))
        jcfg, cfg = LlamaConfig.tiny(**kw), PortConfig.tiny(**kw)
        assert jcfg.head_size == cfg.head_size == head_dim and cfg.num_layers == 2
        params = llama.init(jcfg, jax.random.key(23 + head_dim))
        _MODELS[head_dim] = (jcfg, params,
                             params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu"))
    return _MODELS[head_dim]


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["", "int8"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_f32_llama_on_the_pools_serves_the_jax_engine_s_tokens(head_dim, kind):
    """Greedy tokens of the port's engine on the f32 pool (A and B's f32
    builds on the card) and on the int8 pool under f32 (D's f32-q build and
    B-q's f32 rows), pages of 32, equal the JAX paged engine's on the same
    f32 weights."""
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = _llama(head_dim)
    knobs = dict(slots=4, max_len=64, max_prefill_batch=2, page_size=PAGE, kv_quantize=kind)
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), kv_layout="paged", **knobs)
    try:
        want = [r.result(timeout=120)["tokens"]
                for r in [jeng.submit(p, max_new_tokens=6) for p in PROMPTS]]
    finally:
        jeng.stop()
    eng = GenerateEngine(model, device="cpu", **knobs)
    try:
        assert eng.kv_layout == "paged" and eng.cache.k.dtype == (torch.int8 if kind
                                                                  else torch.float32)
        got = [r.result(timeout=120)["tokens"]
               for r in [eng.submit(p, max_new_tokens=6) for p in PROMPTS]]
    finally:
        eng.stop()
    assert got == want


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["", "int8"])
@pytest.mark.parametrize("head_dim", [64, 128])
def test_f32_llama_logits_on_the_pools_match_jax(head_dim, kind):
    """The model's logits through ``prefill_paged`` (a whole prompt, then a
    chunk at an offset) and three ``decode_step_paged`` steps on the f32
    pool and the int8 pool agree with the JAX model's on the same pool
    within 1e-4. On the int8 pool the JAX model runs op by op
    (``jax.disable_jit``): under jit XLA turns the row quantizer's division
    into a multiply by the reciprocal inside the prefill's fake-quantized
    K/V, which flips a code at head dim 128 here and moves the logits by
    2.0e-4; the port divides in IEEE arithmetic, as JAX does op by op
    (ROADMAP Queue C)."""
    import contextlib

    import jax
    import jax.numpy as jnp

    from gofr_tpu.models import llama

    jcfg, params, model = _llama(head_dim)
    suffix = "_q" if kind else ""
    rng = np.random.default_rng(head_dim)
    first = rng.integers(0, jcfg.vocab_size, (2, 9))
    second = rng.integers(0, jcfg.vocab_size, (2, 7))
    len1, len2 = np.array([9, 5], np.int32), np.array([7, 4], np.int32)
    table = np.full((2, 2), 8, np.int32)
    table[0], table[1, 0] = [3, 6], 1
    jcache = getattr(llama, "make_paged_cache" + suffix)(jcfg, 8, page_size=PAGE)
    cache = getattr(model, "make_paged_cache" + suffix)(8, page_size=PAGE)
    assert cache.k.dtype == (torch.int8 if kind else torch.float32)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)

    with jax.disable_jit() if kind else contextlib.nullcontext():
        want, jcache = llama.prefill_paged(jcfg, params, jnp.asarray(first), jnp.asarray(len1),
                                           jcache, jnp.asarray(table))
        got, cache = model.prefill_paged(_t(first), _t(len1), cache, _t(table))
        close(got, want)
        want, jcache = llama.prefill_paged(jcfg, params, jnp.asarray(second), jnp.asarray(len2),
                                           jcache, jnp.asarray(table), jnp.asarray(len1))
        got, cache = model.prefill_paged(_t(second), _t(len2), cache, _t(table), _t(len1))
        close(got, want)
        positions = len1 + len2
        for _ in range(3):
            step = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
            want, jcache = llama.decode_step_paged(jcfg, params, jnp.asarray(step),
                                                   jnp.asarray(positions), jcache,
                                                   jnp.asarray(table))
            got, cache = model.decode_step_paged(_t(step), _t(positions), cache, _t(table))
            close(got, want)
            positions = positions + 1


# -- the f32 builds against their plain versions (on the card only) -------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _within(got, want, limits):
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt().clamp_min(1e-30)
    return bool(got.isfinite().all()) and diff.abs().max().item() <= limits.MAX_ABS \
        and rel.item() <= limits.RMS_REL


def _card_case(d):
    """``_pool_case`` at a page of 128 (the engine's), on the card, with f32
    pools, int8 pools and bf16 scales."""
    rng, pool, q, table, lengths = _pool_case(51 + d, d, 4)
    lengths = np.minimum(lengths * 4, MAXP * 128 + 5).astype(np.int32)
    dev = "cuda"
    shape = (pool, 2, 128, d)
    k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
            for _ in range(2))
    kq, vq = (torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8)).to(dev)
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.05, shape[:-1]).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    return (_t(q).to(dev), k, v, kq, vq, ks, vs, _t(table).to(dev), _t(lengths).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_f32_paged_decodes_match_plain_on_the_card(d):
    """A's f32 build and D's f32-q build within their ``F32`` limits of the
    plain versions, f32 out, the empty slot 0; one launch each, counted
    under its own name."""
    _needs_card()
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import paged_decode_attention_plain, paged_decode_attention_q_plain
    from gofr_tpu_torch.ops.cuda import paged_decode as a_mod
    from gofr_tpu_torch.ops.cuda import paged_decode_q as d_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.reset_launch_counts()
    q, k, v, kq, vq, ks, vs, table, lengths = _card_case(d)
    got = a_mod.paged_decode(q, k, v, table, lengths)
    assert got.dtype == torch.float32 and torch.all(got[0] == 0)
    assert _within(got, paged_decode_attention_plain(q, k, v, table, lengths), a_mod.F32)
    got = d_mod.paged_decode_q(q, kq, vq, ks, vs, table, lengths)
    assert got.dtype == torch.float32 and torch.all(got[0] == 0)
    assert _within(got, paged_decode_attention_q_plain(q, kq, vq, ks, vs, table, lengths),
                   d_mod.F32)
    torch.cuda.synchronize()
    sfx = "_d64" if d == 64 else ""
    counts = cuda.launch_counts()
    assert counts[f"paged_decode{sfx}_f32"] == counts[f"paged_decode_q{sfx}_f32"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_f32_pool_appends_match_plain_on_the_card(d):
    """B's f32 build and B-q's f32-row build bit for bit against the plain
    appends, a position past the table and a negative one dropped."""
    _needs_card()
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append, kv_append_q
    from gofr_tpu_torch.ops.paged import append_tokens_paged_plain, append_tokens_paged_q

    _, k, v, kq, vq, ks, vs, table, lengths = _card_case(d)
    n = table.shape[0]
    rows = torch.randn(n, 2, d, device="cuda", generator=torch.Generator("cuda").manual_seed(6)) * 7
    pos = lengths.clamp(max=MAXP * 128 - 1)
    pos[1], pos[2] = -1, MAXP * 128
    got_k, got_v, want_k, want_v = k.clone(), v.clone(), k.clone(), v.clone()
    kv_append(got_k, got_v, table, pos, rows, rows)
    append_tokens_paged_plain(want_k, want_v, table, pos, rows, rows)
    assert torch.equal(got_k.view(torch.int32), want_k.view(torch.int32))
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    got = [t.clone() for t in (kq, vq, ks, vs)]
    want = [t.clone() for t in (kq, vq, ks, vs)]
    kv_append_q(*got, table, pos, rows, rows)
    append_tokens_paged_q(want[0], want[2], table, pos, rows)
    append_tokens_paged_q(want[1], want[3], table, pos, rows)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int8) if a.dtype == torch.int8 else a.view(torch.int16),
                           b.view(torch.int8) if b.dtype == torch.int8 else b.view(torch.int16))
               for a, b in zip(got, want))
