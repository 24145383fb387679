"""Kernels E, B-q4, G-q and W8A16 on f32 inputs, held against the JAX package.

The JAX package serves its configs in their own dtype (f32 for
``LlamaConfig.tiny`` and ``GPT2Config``) on every cache and with int8
weights: the Pallas ``paged_decode_attention_q4`` takes the int4 K as
``q.dtype`` against an f32 q (gofr_tpu/ops/pallas/paged_decode.py:291),
the quantizing appends of the int4 pool and the int8 slot cache quantize
f32 rows (XLA), and ``qdot`` multiplies an f32 x by the int8 weight
converted to f32, then by the f32 scale. On the card E has f32-q builds
(``csrc/paged_decode_q.cu``, q split into three bf16 pieces), B-q4 and G-q
f32-row builds (``csrc/kv_append.cu``) and W8A16 an f32-activation build
(``csrc/w8a16.cu``), at head dims 128 and 64 (W8A16 at any K % 16 == 0).
Here their plain versions, which the launchers take for a tensor on the
CPU and which ``chip_smoke.py`` holds each build against on the card, are
held at f32 against the Pallas kernel in interpret mode (as
tests/test_pallas.py runs it) and against JAX's XLA appends and ``qdot``;
f32 Llamas at head dims 64 and 128 on the int4 pool, on the int8 slot
cache and with int8 weights, and f32 GPT-2 with int8 weights, against the
JAX model and engine. The launchers are checked without a launch (an f32
call binds its f32 entry point and counts under its ``_f32`` name, W8A16's
plan sized at 4-byte elements), and so is the autotuner's pin for E at
``int4/float32``. The ``cuda``-marked tests hold each new build against
its plain version on the card (``python -m pytest
tests/test_torch_quantized_f32.py -m cuda --noconftest``: they import no
JAX).

Tolerances:
- decode attention, f32 q, against Pallas: 1e-5 (only the order of the f32
  sums differs; outputs are of order 1);
- appends: bit for bit, values and bf16 scales;
- ``qdot_plain`` against JAX's ``qdot`` in f32: 1e-5 of the output's
  largest magnitude (both sum exact products in f32, in other orders);
- logits: 1e-4, as tests/test_torch_llama.py; greedy tokens: exact. On
  the int4 pool and the int8 slot cache the JAX model runs op by op
  (``jax.disable_jit``): under jit XLA turns the quantizers' divisions
  (``/ 7``, ``/ 127``) into multiplies by the reciprocal, which flips
  codes (ROADMAP Queue C); the port divides in IEEE arithmetic, as JAX
  does op by op;
- on the card, the launchers' f32 limits (``F32``: 1e-4 on any element and
  2e-5 on the RMS ratio; W8A16's relative to the output's largest
  magnitude), B-q4 and G-q bit for bit.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 1e-5
LOGIT_TOL = 1e-4
PAGE, MAXP = 32, 6
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6]]
# (kv_layout, kv_quantize, quantize) of the f32 Llama's new paths
PATHS = {"int4_pool": ("paged", "int4", ""), "int8_slot": ("slot", "int8", ""),
         "int8_weights": ("paged", "", "int8")}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(a):
    from gofr_tpu_torch.models.llama import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a))


def _bits(a):
    """Bit pattern of an array or tensor (bf16 tensors by their int16 view)."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _rows(rng, n, hkv, d):
    """f32 rows of widely different magnitudes (1e-3 .. 50): lane 1 all
    zero (codes 0, scale bf16(1e-8 / qmax)), lane 2 a row whose max is one
    element (its code reaches +-qmax)."""
    new = (rng.standard_normal((n, hkv, d)) * rng.uniform(1e-3, 50.0, (n, hkv, 1))).astype(np.float32)
    new[1] = 0.0
    new[2] *= 1e-3
    new[2, :, d // 2 + 3] = 4.0
    return new


# -- E: an f32 q over the packed int4 pool ----------------------------------------------------


def _q4_case(seed, d, group, hkv=2):
    """q (f32), packed int4 K/V pages of random nibbles with bf16 scales,
    table and lengths over a pool of 2 x MaxP pages: lengths 0, on and one
    past a page edge, on and one past a 64-row split, the whole table row
    and past it, and 17; tables in scrambled order with repeats, OOB
    entries (== P) inside two live lanes, the empty lane's row all OOB."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    pool, span = 2 * MAXP, MAXP * PAGE
    lengths = np.array([0, PAGE, PAGE + 1, 64, 65, span, span + 5, 17], np.int32)
    table = rng.integers(0, pool, (len(lengths), MAXP)).astype(np.int32)
    table[0] = pool
    table[2, 1] = pool
    table[5, MAXP - 1] = pool
    table[4, 1] = table[4, 0]
    q = rng.standard_normal((len(lengths), hkv * group, d)).astype(np.float32)
    kq, vq = (rng.integers(0, 256, (pool, hkv, PAGE, d // 2)).astype(np.uint8) for _ in range(2))
    ks, vs = (np.asarray(jnp.asarray(rng.uniform(0.005, 0.05, (pool, hkv, PAGE)).astype(np.float32))
                         .astype(jnp.bfloat16)) for _ in range(2))
    return q, kq, vq, ks, vs, table, lengths


@pytest.mark.quick
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_decode_q4_plain_and_split_with_an_f32_q_match_pallas(d, group):
    """Kernel E's plain version and its split form with an f32 q (q.k and
    p * vs in f32, the f32-q build's arithmetic) against the Pallas
    ``paged_decode_attention_q4`` with the same f32 q, which returns f32;
    the empty slot is 0."""
    import jax.numpy as jnp

    from gofr_tpu.ops.pallas.paged_decode import paged_decode_attention_q4 as pallas_q4
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_q4_plain,
        paged_decode_attention_q_split_plain,
    )

    case = _q4_case(13 * d + group, d, group)
    want = np.asarray(pallas_q4(*(jnp.asarray(a) for a in case), interpret=True))
    assert want.dtype == np.float32
    args = [_port(a) for a in case]
    assert args[0].dtype == torch.float32 and args[3].dtype == torch.bfloat16
    for got in (paged_decode_attention_q4_plain(*args),
                *(paged_decode_attention_q_split_plain(*args, rows, bits=4) for rows in (64, 128))):
        assert got.dtype == torch.float32 and torch.all(got[0] == 0)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


# -- B-q4 and G-q: the quantizing appends on f32 rows, bit for bit ---------------------------


@pytest.mark.quick
@pytest.mark.parametrize("d", [64, 128])
def test_int4_pool_append_of_f32_rows_is_bit_exact_against_jax(d):
    """B-q4's plain version on f32 rows against JAX's
    ``append_tokens_paged_q4``: packed values and bf16 scales bit for bit,
    an all-zero row stored as codes 0 (bytes 0x88) and a single-max row
    reaching +-7, at the positions both write (JAX's XLA append clamps a
    position past the table where the port drops it: Queue C)."""
    import jax.numpy as jnp

    from gofr_tpu.ops import paged as jax_paged
    from gofr_tpu.ops import quant as jax_quant
    from gofr_tpu_torch.ops.paged import append_tokens_paged_q4
    from gofr_tpu_torch.ops.quant import unpack_int4

    rng = np.random.default_rng(17 * d)
    pool, n, hkv = 12, 4, 2
    vals, scales = jax_quant.quantize_row_int4(jnp.asarray(
        rng.standard_normal((pool, hkv, PAGE, d)).astype(np.float32)))
    vals = np.asarray(jax_quant.pack_int4(vals))
    scales = np.asarray(scales.astype(jnp.bfloat16))
    table = rng.permutation(pool)[: n * 3].reshape(n, 3).astype(np.int32)
    table[3, 2] = pool
    positions = np.array([40, 0, 70, 95], np.int32)  # lane 3 through an OOB entry: dropped
    new = _rows(rng, n, hkv, d)
    wq, ws = jax_paged.append_tokens_paged_q4(jnp.asarray(vals), jnp.asarray(scales),
                                              jnp.asarray(table), jnp.asarray(positions),
                                              jnp.asarray(new))
    gq, gs = _t(vals.copy()), _port(scales)
    append_tokens_paged_q4(gq, gs, _t(table), _t(positions), _t(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert torch.all(unpack_int4(gq[int(table[1, 0]), :, 0]) == 0)
    assert torch.all(unpack_int4(gq[int(table[2, 2]), :, 70 % PAGE]).abs().amax(-1) == 7)


@pytest.mark.quick
@pytest.mark.parametrize("d", [64, 128])
def test_int8_slot_append_of_f32_rows_is_bit_exact_against_jax(d):
    """G-q's plain version on f32 rows against JAX's ``append_tokens_q``,
    values and bf16 scales bit for bit; a position at Smax and a negative
    one are dropped by both."""
    import jax.numpy as jnp

    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu_torch.ops.kvcache import append_tokens_q

    rng = np.random.default_rng(19 * d)
    n, hkv, smax = 5, 2, 48
    vals, scales = jax_kv.quantize_row(jnp.asarray(
        rng.standard_normal((n, hkv, smax, d)).astype(np.float32)))
    vals, scales = np.asarray(vals), np.asarray(scales.astype(jnp.bfloat16))
    positions = np.array([7, 0, 31, smax, -1], np.int32)
    new = _rows(rng, n, hkv, d)
    wq, ws = jax_kv.append_tokens_q(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(positions),
                                    jnp.asarray(new))
    gq, gs = _t(vals.copy()), _port(scales)
    append_tokens_q(gq, gs, _t(positions), _t(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert torch.all(gq[1, :, 0] == 0) and torch.all(gq[2, :, 31].abs().amax(-1) == 127)
    np.testing.assert_array_equal(gq.numpy()[3:], vals[3:])


# -- W8A16: qdot_plain in f32 --------------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("shape", [(128, 48), (768, 2304), (256, 1000)], ids=str)
def test_qdot_plain_in_f32_matches_jax_qdot(shape):
    """``qdot_plain`` on an f32 x and a ``QTensor`` (the f32 build's plain
    version: ``F.linear(x, q.float()) * s``) against JAX's ``qdot`` on the
    same int8 weight (JAX's ``quantize`` of the same f32 weight, eager),
    within 1e-5 of the output's largest magnitude; the result is f32."""
    import jax.numpy as jnp

    from gofr_tpu.ops.quant import qdot as jax_qdot
    from gofr_tpu.ops.quant import quantize as jax_quantize
    from gofr_tpu_torch.ops.quant import qdot, qdot_plain, quantize

    k, n = shape
    rng = np.random.default_rng(k + n)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    w[:, 1] = 0.0
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    want = np.asarray(jax_qdot(jnp.asarray(x), jax_quantize(jnp.asarray(w))))
    wq = quantize(_t(w).T)
    got = qdot_plain(_t(x), wq)
    assert got.dtype == torch.float32 and got.shape == (3, 5, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert torch.equal(qdot(_t(x), wq), got)  # the CPU takes the plain version


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


@pytest.mark.quick
@pytest.mark.parametrize("d", [128, 64])
def test_the_f32_builds_bind_their_entry_points_and_count_apart(as_if_on_the_card, d):
    """E with an f32 q, B-q4 and G-q on f32 rows bind the f32 entry points
    and count under the ``_f32`` names (``_d64_f32`` at 64); the same calls
    in bf16 bind the bf16 builds; the named f32 wrappers refuse bf16; all
    before any pointer reaches C."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda.kv_append import (
        kv_append_q4,
        kv_append_q4_f32,
        kv_append_slot_q,
        kv_append_slot_q_f32,
    )
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4, paged_decode_q4_f32

    calls = as_if_on_the_card
    sfx = "_d64" if d == 64 else ""
    n, hq, hkv, pool = 3, 4, 2, 5
    q4pool = torch.zeros(pool, hkv, PAGE, d // 2, dtype=torch.uint8)
    scales = torch.zeros(pool, hkv, PAGE, dtype=torch.bfloat16)
    slot = torch.zeros(n, hkv, 64, d, dtype=torch.int8)
    slot_s = torch.zeros(n, hkv, 64, dtype=torch.bfloat16)
    table, pos = torch.zeros(n, 4, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    for dtype, name in ((torch.float32, "_f32"), (torch.bfloat16, "")):
        q, rows = torch.zeros(n, hq, d, dtype=dtype), torch.zeros(n, hkv, d, dtype=dtype)
        out = paged_decode_q4(q, q4pool, q4pool, scales, scales, table, pos)
        assert out.dtype == dtype
        kv_append_q4(q4pool, q4pool, scales, scales, table, pos, rows, rows)
        kv_append_slot_q(slot, slot, slot_s, slot_s, pos, rows, rows)
        counts = cuda.launch_counts()
        for kernel in ("paged_decode_q4", "kv_append_q4", "kv_append_slot_q"):
            assert counts[kernel + sfx + name] == 1, kernel + sfx + name
    assert sum(cuda.launch_counts().values()) == 6
    assert [c[0] for c in calls] == [f"gofr_paged_decode_q4{sfx}_f32", f"gofr_kv_append_q4{sfx}_f32",
                                     f"gofr_kv_append_slot_q{sfx}_f32", f"gofr_paged_decode_q4{sfx}",
                                     f"gofr_kv_append_q4{sfx}", f"gofr_kv_append_slot_q{sfx}"]
    assert all(n_types == len(args) for _, n_types, args in calls)
    qb, rb = torch.zeros(n, hq, d, dtype=torch.bfloat16), torch.zeros(n, hkv, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32 q"):
        paged_decode_q4_f32(qb, q4pool, q4pool, scales, scales, table, pos)
    with pytest.raises(ValueError, match="f32 rows"):
        kv_append_q4_f32(q4pool, q4pool, scales, scales, table, pos, rb, rb)
    with pytest.raises(ValueError, match="f32 rows"):
        kv_append_slot_q_f32(slot, slot, slot_s, slot_s, pos, rb, rb)
    assert sum(cuda.launch_counts().values()) == 6


@pytest.mark.quick
@pytest.mark.parametrize("m,n,k", [(8, 1024, 4096), (40, 14336, 64), (300, 96, 32)])
def test_w8a16_routes_an_f32_x_to_its_f32_build(as_if_on_the_card, m, n, k):
    """An f32 x binds ``gofr_w8a16_f32`` with the plan sized at 4-byte
    elements (a stage of X holds half the chunks of a bf16 one where the
    split is long enough), allocates f32 out and, when K is split, an f32
    scratch, and counts under ``w8a16_f32``; a bf16 x of the same shapes
    binds ``gofr_w8a16`` at the bf16 plan; ``w8a16_f32`` refuses bf16."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import w8a16 as mod

    calls = as_if_on_the_card
    q, s = torch.zeros(n, k, dtype=torch.int8), torch.zeros(n)
    for dtype in (torch.float32, torch.bfloat16):
        out = mod.w8a16(torch.zeros(2, m, k, dtype=dtype), q, s)
        assert out.shape == (2, m, n) and out.dtype == dtype
    (name32, n32, args32), (name16, _, args16) = calls
    assert (name32, name16) == ("gofr_w8a16_f32", "gofr_w8a16") and n32 == len(args32)
    assert args32[5:11] == (2 * m, n, k, *mod.plan(2 * m, n, k, 4))
    assert args16[5:11] == (2 * m, n, k, *mod.plan(2 * m, n, k, 2))
    assert (args32[4] is None) == (mod.plan(2 * m, n, k, 4)[0] <= 1)
    if 2 * m <= mod.SMALL_M:
        splits, per_split, stage = mod.plan(2 * m, n, k, 4)
        rows = -(-2 * m // 8) * 8
        assert 1 <= stage <= per_split and rows * (stage * mod.CHUNK * 4 + mod.X_PAD_BYTES) <= mod.X_SMEM
        assert stage <= mod.plan(2 * m, n, k, 2)[2]
    assert cuda.launch_counts()["w8a16_f32"] == cuda.launch_counts()["w8a16"] == 1
    with pytest.raises(ValueError, match="f32 x"):
        mod.w8a16_f32(torch.zeros(m, k, dtype=torch.bfloat16), q, s)


@pytest.mark.quick
def test_an_int4_pin_at_float32_never_steers_the_bf16_build(as_if_on_the_card):
    """A plan pinned for E at ``int4/float32`` is taken by the f32-q launch
    and not returned for the same shapes at ``int4/bfloat16``, nor the
    other way round; without a pin both take the rule's plan."""
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan
    from gofr_tpu_torch.ops.cuda.paged_decode_q import pin_dtype
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4

    calls = as_if_on_the_card
    op, n, hq, hkv, d, maxp, pool = "paged_decode_q4", 3, 4, 2, 64, 16, 40
    shape = autotune.shape_key(n, hq, hkv, d, PAGE, maxp, pool)
    rule = split_plan(n, hkv, maxp * PAGE)[0]
    pinned = 256 if rule != 256 else 128
    table, lengths = torch.zeros(n, maxp, dtype=torch.int32), torch.ones(n, dtype=torch.int32)
    planes = torch.zeros(pool, hkv, PAGE, d // 2, dtype=torch.uint8)
    scales = torch.zeros(pool, hkv, PAGE, dtype=torch.bfloat16)

    def launch(dtype) -> int:
        """The split_rows the launch passes (after the 9 pointers and n,
        hkv, group, pool, page, maxp)."""
        paged_decode_q4(torch.zeros(n, hq, d, dtype=dtype), planes, planes, scales, scales, table,
                        lengths)
        return calls[-1][2][15]

    name = {dt: pin_dtype("int4", dt) for dt in (torch.float32, torch.bfloat16)}
    assert name == {torch.float32: "int4/float32", torch.bfloat16: "int4/bfloat16"}
    for decided, other in ((torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)):
        with autotune.decision_scope({op: autotune.plan_name(pinned)}, {op: shape},
                                     {op: name[decided]}):
            assert autotune.pinned_plan(op, autotune.pin_dims(shape, name[decided])) == pinned
            assert autotune.pinned_plan(op, autotune.pin_dims(shape, name[other])) is None
            assert (launch(decided), launch(other)) == (pinned, rule)
        assert (launch(decided), launch(other)) == (rule, rule)


# -- the slice as a whole: f32 models on the int4 pool, the int8 slot cache, int8 weights ------


_MODELS = {}


def _llama(head_dim):
    """A 2-layer f32 Llama at ``head_dim`` (64: 256 wide with 4 heads of 64;
    128: the tiny widths with heads of 128), JAX weights from a key, their
    JAX int8 tree (``quantize_tree`` run eagerly) and the port's model on
    the raw weights."""
    if head_dim not in _MODELS:
        import jax

        from gofr_tpu.models import LlamaConfig, llama
        from gofr_tpu.ops.quant import quantize_tree
        from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
        from gofr_tpu_torch.models.llama import params_from_jax

        kw = (dict(hidden_size=256, num_heads=4, num_kv_heads=2) if head_dim == 64
              else dict(head_dim=128))
        jcfg, cfg = LlamaConfig.tiny(**kw), PortConfig.tiny(**kw)
        assert jcfg.head_size == cfg.head_size == head_dim and cfg.num_layers == 2
        assert cfg.dtype == torch.float32
        params = llama.init(jcfg, jax.random.key(31 + head_dim))
        _MODELS[head_dim] = (jcfg, params, quantize_tree(params),
                             params_from_jax(cfg, jax.tree.map(np.asarray, params), device="cpu"))
    return _MODELS[head_dim]


@pytest.mark.quick
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("head_dim", [64, 128])
def test_f32_llama_serves_the_jax_engine_s_tokens(head_dim, path):
    """Greedy tokens of the port's engine on the f32 Llama in its own dtype
    on the int4 pool (E's f32-q build and B-q4's f32 rows on the card), on
    the int8 slot cache (G-q's f32 rows) and with int8 weights on the f32
    pool (W8A16's f32 build; the port quantizes the raw weights itself,
    ``quantize="int8"``, the JAX engine is handed its eager int8 tree)
    equal the JAX engine's."""
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import build_engine

    import jax

    jcfg, params, qparams, model = _llama(head_dim)
    layout, kind, weights = PATHS[path]
    knobs = dict(slots=4, max_len=64, max_prefill_batch=2, kv_layout=layout, kv_quantize=kind)
    if layout == "paged":
        knobs["page_size"] = PAGE
    jeng = JaxEngine(llama, jcfg, qparams if weights else params, new_mock_container(), **knobs)
    try:
        want = [r.result(timeout=120)["tokens"]
                for r in [jeng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        jeng.stop()
    eng = build_engine(model.cfg, params=jax.tree.map(np.asarray, params), device="cpu",
                       quantize=weights, **knobs)
    try:
        assert eng.cfg.dtype == torch.float32 and eng.kv_quantize == kind
        assert (type(eng.model.blocks[0].wq).__name__ == "QLinear") == bool(weights)
        got = [r.result(timeout=120)["tokens"]
               for r in [eng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        eng.stop()
    assert got == want


@pytest.mark.quick
@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("head_dim", [64, 128])
def test_f32_llama_logits_match_jax(head_dim, path):
    """The f32 model's logits through a whole-prompt prefill, a chunk at an
    offset and three decode steps agree with the JAX model's within 1e-4:
    on the int4 pool (``prefill_paged`` / ``decode_step_paged``) and on the
    int8 slot cache (``prefill`` / ``decode_step``), JAX op by op
    (``jax.disable_jit``, see the tolerances above); with int8 weights on
    the f32 pool, the port's ``quantize_tree`` of the raw weights (bit for
    bit JAX's eager tree) against JAX's model on that tree."""
    import jax
    import jax.numpy as jnp

    from gofr_tpu.models import llama
    from gofr_tpu_torch.ops.quant import quantize_tree

    jcfg, params, qparams, model = _llama(head_dim)
    layout, kind, weights = PATHS[path]
    jparams = qparams if weights else params
    if weights:
        model = quantize_tree(model)
    rng = np.random.default_rng(head_dim + len(path))
    first = rng.integers(0, jcfg.vocab_size, (2, 9))
    second = rng.integers(0, jcfg.vocab_size, (2, 7))
    len1, len2 = np.array([9, 5], np.int32), np.array([7, 4], np.int32)
    if layout == "paged":
        rows = np.full((2, 2), 8, np.int32)
        rows[0], rows[1, 0] = [3, 6], 1
        suffix = "_q4" if kind else ""
        jcache = getattr(llama, "make_paged_cache" + suffix)(jcfg, 8, page_size=PAGE)
        cache = getattr(model, "make_paged_cache" + suffix)(8, page_size=PAGE)
        jprefill, jdecode = llama.prefill_paged, llama.decode_step_paged
        table = rows
    else:
        rows = np.array([2, 0], np.int32)
        jcache, cache = llama.make_cache_q(jcfg, 3, 48), model.make_cache_q(3, 48)
        jprefill, table = llama.prefill, None
        jdecode = lambda cfg, p, tok, pos, c, _table: llama.decode_step(cfg, p, tok, pos, c)  # noqa: E731
    assert cache.k.dtype == {"int4": torch.uint8, "int8": torch.int8, "": torch.float32}[kind]

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)

    with jax.disable_jit() if kind else contextlib.nullcontext():
        want, jcache = jprefill(jcfg, jparams, jnp.asarray(first), jnp.asarray(len1), jcache,
                                jnp.asarray(rows))
        got, cache = model.prefill(_t(first), _t(len1), cache, _t(rows))
        close(got, want)
        want, jcache = jprefill(jcfg, jparams, jnp.asarray(second), jnp.asarray(len2), jcache,
                                jnp.asarray(rows), jnp.asarray(len1))
        got, cache = model.prefill(_t(second), _t(len2), cache, _t(rows), _t(len1))
        close(got, want)
        positions = len1 + len2
        if layout == "paged":  # the two lanes' table rows
            step = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        else:  # every slot, the idle one at 0
            step = np.zeros(3, np.int32)
            step[rows] = np.asarray(jnp.argmax(want, -1))
            positions = _slot_positions(rows, positions, 3)
        for _ in range(3):
            want, jcache = jdecode(jcfg, jparams, jnp.asarray(step), jnp.asarray(positions), jcache,
                                   None if table is None else jnp.asarray(table))
            got, cache = model.decode_step(_t(step), _t(positions), cache,
                                           None if table is None else _t(table))
            close(got, want)
            step = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
            positions = positions + 1


def _slot_positions(rows, positions, slots):
    """Per-slot positions of a decode step over every slot: the prompts'
    slots at their lengths, an idle slot at 0."""
    out = np.zeros(slots, np.int32)
    out[rows] = positions
    return out


@pytest.fixture(scope="module")
def gpt2_tiny():
    """JAX's tiny GPT-2 (f32, key 5) with numpy-drawn biases, its eager int8
    tree, and the port's model on the raw weights."""
    import jax
    import jax.numpy as jnp

    from gofr_tpu.models import gpt2
    from gofr_tpu.ops.quant import quantize_tree
    from gofr_tpu_torch.models.gpt2 import GPT2Config, params_from_jax

    jcfg = gpt2.GPT2Config.tiny()
    tree = jax.tree.map(np.asarray, gpt2.init(jcfg, jax.random.key(5)))
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv", "bo", "b_fc", "b_proj"):
        shape = tree["blocks"][name].shape
        tree["blocks"][name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    cfg = GPT2Config.tiny()
    assert cfg.dtype == torch.float32
    return jcfg, params, quantize_tree(params), tree, params_from_jax(cfg, tree, device="cpu")


@pytest.mark.quick
def test_f32_gpt2_with_int8_weights_matches_jax(gpt2_tiny):
    """GPT-2 in its own f32 with int8 weights (W8A16's f32 build on the
    card; the tied head stays the f32 embedding): the port's
    ``quantize_tree`` of the raw weights against JAX's model on its eager
    int8 tree, logits of a prefill and three decode steps on the slot cache
    within 1e-4, and the port's engine (``quantize="int8"``) serves the JAX
    engine's greedy tokens on the same int8 tree."""
    import jax.numpy as jnp

    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import gpt2
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.ops.quant import quantize_tree

    jcfg, _, qparams, tree, model = gpt2_tiny
    qmodel = quantize_tree(model)
    assert type(qmodel.blocks[0].w_fc).__name__ == "QLinear" and qmodel.wte.dtype == torch.float32
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 10))
    lengths, slots = np.array([10, 6], np.int32), np.array([2, 0], np.int32)
    jcache, cache = gpt2.make_cache(jcfg, 3, 32), qmodel.make_cache(3, 32)
    want, jcache = gpt2.prefill(jcfg, qparams, jnp.asarray(tokens), jnp.asarray(lengths), jcache,
                                jnp.asarray(slots))
    got, cache = qmodel.prefill(_t(tokens), _t(lengths), cache, _t(slots))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    positions = _slot_positions(slots, lengths, 3)
    step = np.zeros(3, np.int32)
    step[slots] = np.asarray(jnp.argmax(want, -1))
    for _ in range(3):
        want, jcache = gpt2.decode_step(jcfg, qparams, jnp.asarray(step), jnp.asarray(positions),
                                        jcache)
        got, cache = qmodel.decode_step(_t(step), _t(positions), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)
        step = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        positions = positions + 1
    knobs = dict(slots=2, max_len=48, max_prefill_batch=2)
    jeng = JaxEngine(gpt2, jcfg, qparams, jax_container(), **knobs)
    try:
        want = [r.result(timeout=120)["tokens"] for r in [jeng.submit(p, max_new_tokens=6)
                                                          for p in PROMPTS[:3]]]
    finally:
        jeng.stop()
    eng = build_engine(model.cfg, params=tree, device="cpu", quantize="int8", **knobs)
    try:
        got = [r.result(timeout=120)["tokens"] for r in [eng.submit(p, max_new_tokens=6)
                                                         for p in PROMPTS[:3]]]
    finally:
        eng.stop()
    assert got == want


# -- the f32 builds against their plain versions (on the card only) -------------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _within(got, want, limits, relative=False):
    diff = got.float() - want.float()
    top = want.float().abs().max().clamp_min(1e-30) if relative else 1.0
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt().clamp_min(1e-30)
    return bool(got.isfinite().all()) and (diff.abs().max() / top).item() <= limits.MAX_ABS \
        and rel.item() <= limits.RMS_REL


def _card_q4_case(d):
    """An f32 q and an int4 pool of page 128 on the card, lanes of 0 ..
    past the table row."""
    rng = np.random.default_rng(61 + d)
    pool, maxp, n, hkv, group = 24, 12, 8, 4, 8
    lengths = np.array([0, 128, 129, 700, 1536, 1541, 77, 1024], np.int32)
    table = rng.permutation(pool)[: n * maxp // 4].repeat(4)[: n * maxp].reshape(n, maxp)
    table = table.astype(np.int32)
    table[0] = pool
    dev = "cuda"
    q = torch.from_numpy(rng.standard_normal((n, hkv * group, d)).astype(np.float32)).to(dev)
    kq, vq = (torch.from_numpy(rng.integers(0, 256, (pool, hkv, 128, d // 2)).astype(np.uint8))
              .to(dev) for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.05, (pool, hkv, 128)).astype(np.float32))
              .to(dev, torch.bfloat16) for _ in range(2))
    return q, kq, vq, ks, vs, _t(table).to(dev), _t(lengths).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_f32_q4_decode_matches_plain_on_the_card(d):
    """E's f32-q build within its ``F32`` limits of the plain version, f32
    out, the empty slot 0, one launch counted under its own name; with a
    plan pinned at ``int4/float32`` it takes the pin and agrees with the
    split plain version at that plan, while a bf16 q of the same shapes
    keeps the rule's plan."""
    _needs_card()
    from gofr_tpu_torch.ops import autotune, cuda
    from gofr_tpu_torch.ops.attention import (
        paged_decode_attention_q4_plain,
        paged_decode_attention_q_split_plain,
    )
    from gofr_tpu_torch.ops.cuda import paged_decode_q4 as e_mod
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates, split_plan, split_scratch

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.reset_launch_counts()
    args = _card_q4_case(d)
    q, kq, table = args[0], args[1], args[5]
    got = e_mod.paged_decode_q4(*args)
    assert got.dtype == torch.float32 and torch.all(got[0] == 0)
    assert _within(got, paged_decode_attention_q4_plain(*args), e_mod.F32)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["paged_decode_q4" + ("_d64" if d == 64 else "") + "_f32"] == 1
    n, hq, _ = q.shape
    pool, hkv, page, _ = kq.shape
    span = table.shape[1] * page
    rule = split_plan(n, hkv, span)[0]
    pinned = next(r for r in split_candidates(n, hkv, span) if r != rule)
    key = autotune.shape_key(n, hq, hkv, d, page, table.shape[1], pool)
    dims = (n, hq, hkv, d, page, table.shape[1], pool)
    with autotune.decision_scope({"paged_decode_q4": autotune.plan_name(pinned)},
                                 {"paged_decode_q4": key}, {"paged_decode_q4": "int4/float32"}):
        assert split_scratch(q, hkv, span, "paged_decode_q4", (*dims, "int4/float32"))[0] == pinned
        assert split_scratch(q.bfloat16(), hkv, span, "paged_decode_q4",
                             (*dims, "int4/bfloat16"))[0] == rule
        got = e_mod.paged_decode_q4(*args)
    assert _within(got, paged_decode_attention_q_split_plain(*args, pinned, bits=4), e_mod.F32)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_f32_quantizing_appends_match_plain_on_the_card(d):
    """B-q4's and G-q's f32-row builds bit for bit against the plain
    appends, values and scales; a position past the table (B-q4) or at
    Smax (G-q) and a negative one dropped."""
    _needs_card()
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append_q4, kv_append_slot_q
    from gofr_tpu_torch.ops.kvcache import append_tokens_q
    from gofr_tpu_torch.ops.paged import append_tokens_paged_q4

    _, kq, vq, ks, vs, table, lengths = _card_q4_case(d)
    n, hkv = table.shape[0], kq.shape[1]
    rows = _t(_rows(np.random.default_rng(d), n, hkv, d)).cuda()
    pos = lengths.clamp(max=table.shape[1] * 128 - 1)
    pos[1], pos[2] = -1, table.shape[1] * 128

    def same(got, want):
        return all(torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                               b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
                   for a, b in zip(got, want))

    got = [t.clone() for t in (kq, vq, ks, vs)]
    want = [t.clone() for t in (kq, vq, ks, vs)]
    kv_append_q4(*got, table, pos, rows, rows)
    append_tokens_paged_q4(want[0], want[2], table, pos, rows)
    append_tokens_paged_q4(want[1], want[3], table, pos, rows)
    torch.cuda.synchronize()
    assert same(got, want) and not torch.equal(got[0], kq)
    smax = 64
    slot = [torch.zeros(n, hkv, smax, d, dtype=torch.int8, device="cuda") for _ in range(2)]
    slot += [torch.zeros(n, hkv, smax, dtype=torch.bfloat16, device="cuda") for _ in range(2)]
    spos = lengths % smax
    spos[1], spos[2] = -1, smax
    got, want = [t.clone() for t in slot], [t.clone() for t in slot]
    kv_append_slot_q(*got, spos, rows, rows)
    append_tokens_q(want[0], want[2], spos, rows)
    append_tokens_q(want[1], want[3], spos, rows)
    torch.cuda.synchronize()
    assert same(got, want) and got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 40, 300])
def test_w8a16_f32_matches_plain_on_the_card(m):
    """W8A16's f32 build (the stream at 8 and 40 rows, the tiles at 300)
    within its ``F32`` limits of ``qdot_plain`` on an f32 x (cuBLAS f32
    with TF32 off), relative to the output's largest magnitude."""
    _needs_card()
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import w8a16 as mod
    from gofr_tpu_torch.ops.quant import qdot_plain, quantize

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(m)
    for n, k in ((1024, 4096), (4096, 1024), (1000, 4112)):
        w = quantize(torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5)
        x = torch.randn(m, k, device="cuda", generator=gen)
        got = mod.w8a16(x, w.q, w.s)
        assert got.dtype == torch.float32
        assert _within(got, qdot_plain(x, w), mod.F32, relative=True), (n, k)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["w8a16_f32"] == 3 and cuda.launch_counts()["w8a16"] == 0
