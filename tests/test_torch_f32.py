"""Kernels C, F and G on f32 inputs, held against the JAX package.

The JAX package's GPT-2, BERT and ViT configs default to f32, and its
Pallas kernels take any float dtype (the flash and decode kernels write
their output in ``q.dtype``; ``common.py:57`` casts P to ``v.dtype``, so at
f32 P is not rounded). On the card, kernel C (``csrc/flash_attention.cu``),
F (``csrc/paged_decode.cu``) and G (``csrc/kv_append.cu``) have f32 builds
at head dims 128 and 64; here their plain versions, which the launchers
take for a tensor on the CPU and which ``chip_smoke.py`` holds each f32
build against on the card, are held at f32 against the Pallas kernels in
interpret mode (as tests/test_pallas.py runs them): the causal, ragged,
chunked and encoder forms of ``mha_attention_plain`` with GQA and MHA,
``decode_attention_plain`` and its split form, and the slot append. The
launchers are checked without a launch: an f32 call binds the f32 entry
point and counts under the ``_f32`` name, an fp16 call is refused. The
autotuner's pins carry the cache dtype, so a pin an f32 engine decides
never steers a bf16 launch of the same shapes. The ``cuda``-marked tests
hold each f32 build against its plain version on the card (``python -m
pytest tests/test_torch_f32.py -m cuda --noconftest``: they import no
JAX, and ``--noconftest`` keeps the harness's JAX set-up out too).

Tolerances:
- attention, f32 against Pallas: 1e-5 absolute (only the order of the
  f32 sums differs; outputs are of order 1);
- appends: bit for bit;
- greedy tokens: exact;
- on the card, the launchers' f32 limits (``F32``: 1e-4 on any element,
  2e-5 on the RMS ratio) and bit equality for G.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 1e-5
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


# the prefill attention forms C serves: a whole causal prompt, ragged
# lengths with offsets and a fully masked row, a chunk of queries at
# per-row offsets against the cached keys, and an encoder's padded keys
_FLASH_CASES = {
    "causal": dict(sq=40, skv=40, kw=lambda b: dict(causal=True)),
    "ragged": dict(sq=40, skv=40, kw=lambda b: dict(
        causal=True, q_offset=np.array([0, 7, 0], np.int32)[:b],
        kv_lengths=np.array([40, 23, 0], np.int32)[:b])),
    "chunk": dict(sq=24, skv=72, kw=lambda b: dict(
        causal=True, q_offset=np.array([48, 17, 0], np.int32)[:b],
        kv_lengths=np.array([72, 41, 24], np.int32)[:b])),
    "encoder": dict(sq=33, skv=33, kw=lambda b: dict(
        causal=False, kv_lengths=np.array([33, 9, 1], np.int32)[:b])),
}


@pytest.mark.quick
@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_plain_at_f32_matches_pallas(case, hq, hkv, d):
    """Kernel C's plain version in f32 against the Pallas flash kernel in
    f32 (interpret mode) on the prefill forms C serves, GQA and MHA, head
    dims 64 and 128; the output stays f32 and a fully masked row is 0."""
    import jax.numpy as jnp

    from gofr_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
    from gofr_tpu_torch.ops.attention import mha_attention, mha_attention_plain

    spec = _FLASH_CASES[case]
    b = 3
    q, k, v = _qkv(100 * d + 10 * hq + sorted(_FLASH_CASES).index(case), b, spec["sq"], spec["skv"],
                   hq, hkv, d)
    kw = spec["kw"](b)
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                                   **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
                                      for n, x in kw.items()}))
    pkw = {n: (_t(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    got = mha_attention_plain(_t(q), _t(k), _t(v), **pkw)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    # the router takes the plain version for a CPU tensor, counting nothing
    np.testing.assert_array_equal(mha_attention(_t(q), _t(k), _t(v), **pkw).numpy(), got.numpy())
    if case == "ragged":
        assert np.all(got.numpy()[2] == 0)


def _slot_case(seed, n, hq, hkv, d, smax):
    """q and a slot cache of ``smax`` positions, with lengths 0, on and one
    past a 64-row tile, the whole slot and past it (clamped)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, hq, d)).astype(np.float32)
    k, v = (rng.standard_normal((n, hkv, smax, d)).astype(np.float32) for _ in range(2))
    lengths = np.array([0, 64, 65, 128, 129, smax, smax + 5, 37][:n], np.int32)
    return q, k, v, lengths


@pytest.mark.quick
@pytest.mark.parametrize("split_rows", [64, 128])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_slot_decode_plain_and_split_at_f32_match_pallas(split_rows, group, d):
    """Kernel F's plain version and its split form (the kernel's split and
    merge, P unrounded at f32) against the Pallas ``decode_attention`` in
    f32; an empty slot is 0."""
    import jax.numpy as jnp

    from gofr_tpu.ops.pallas.decode_attention import decode_attention as pallas_decode
    from gofr_tpu_torch.ops.attention import decode_attention_plain, decode_attention_split_plain

    smax = 200  # not a multiple of the 64-row tile
    q, k, v, lengths = _slot_case(11 * group + d + split_rows, 8, 2 * group, 2, d, smax)
    want = np.asarray(pallas_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    jnp.asarray(lengths), block_kv=40, interpret=True))
    plain = decode_attention_plain(_t(q), _t(k), _t(v), _t(lengths))
    split = decode_attention_split_plain(_t(q), _t(k), _t(v), _t(lengths), split_rows)
    for got in (plain, split):
        assert got.dtype == torch.float32 and torch.all(got[0] == 0)
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.quick
@pytest.mark.parametrize("d", [64, 128])
def test_slot_append_at_f32_is_bit_exact_against_pallas(d, monkeypatch):
    """G in f32 inside the slot against the Pallas kernel, and outside it
    (Smax, -1, past) against the select lowering, which drops them as the
    port does."""
    import jax.numpy as jnp

    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu.ops.pallas.kv_append import append_tokens_inplace
    from gofr_tpu_torch.ops.kvcache import append_tokens

    monkeypatch.delenv("GOFR_KV_WRITE", raising=False)  # the select lowering
    rng = np.random.default_rng(7400 + d)
    smax = 40
    k, v = (rng.standard_normal((4, 2, smax, d)).astype(np.float32) for _ in range(2))
    k_new, v_new = (rng.standard_normal((4, 2, d)).astype(np.float32) for _ in range(2))
    for positions, jax_write in (
            (np.array([17, 0, smax - 1, 8], np.int32),
             lambda *a: append_tokens_inplace(*a, block_s=8, interpret=True)),
            (np.array([smax, -1, smax + 5, 3], np.int32), jax_kv.append_tokens)):
        wk, wv = jax_write(*(jnp.asarray(a) for a in (k, v, positions, k_new, v_new)))
        gk, gv = _t(k.copy()), _t(v.copy())
        append_tokens(gk, gv, _t(positions), _t(k_new), _t(v_new))
        np.testing.assert_array_equal(gk.numpy().view(np.uint32), np.asarray(wk).view(np.uint32))
        np.testing.assert_array_equal(gv.numpy().view(np.uint32), np.asarray(wv).view(np.uint32))


# -- the launchers, without a card -----------------------------------------------------


@pytest.fixture
def as_if_on_the_card(monkeypatch):
    """Every tensor claims to lie on the card; ``cuda.bind`` records the
    entry point and the C call, which returns 0."""
    from gofr_tpu_torch.ops import cuda

    calls = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(cuda, "bind", lambda name, argtypes: (
        lambda *args: calls.append((name, len(argtypes), len(args))) or 0))
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    cuda.reset_launch_counts()
    yield calls
    cuda.reset_launch_counts()


@pytest.mark.quick
@pytest.mark.parametrize("d", [128, 64])
def test_f32_launchers_bind_their_builds_and_count_apart(as_if_on_the_card, d):
    """C, F and G on f32 tensors bind the f32 entry points and count under
    the ``_f32`` names (``_d64_f32`` at 64); the same calls in bf16 bind
    the bf16 builds; fp16 is refused by C and F, and the paged append B,
    which takes f32 pools too, refuses f32 pools with bf16 rows and pools
    of 8-byte elements, before any pointer reaches C."""
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda.decode_attention import decode_attention, decode_attention_f32
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention, flash_attention_f32
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append, kv_append_slot, kv_append_slot_f32

    calls = as_if_on_the_card
    sfx = "_d64" if d == 64 else ""
    n, hq, hkv, smax = 3, 4, 2, 64
    lengths = torch.ones(n, dtype=torch.int32)
    for dtype, name in ((torch.float32, "_f32"), (torch.bfloat16, "")):
        q, k, v = (torch.zeros(2, 8, h, d, dtype=dtype) for h in (hq, hkv, hkv))
        flash_attention(q, k, v)
        qd, cache = torch.zeros(n, hq, d, dtype=dtype), torch.zeros(n, hkv, smax, d, dtype=dtype)
        decode_attention(qd, cache, cache, lengths)
        rows = torch.zeros(n, hkv, d, dtype=dtype)
        kv_append_slot(cache, cache, lengths, rows, rows)
        counts = cuda.launch_counts()
        for kernel in ("flash_attention", "decode_attention", "kv_append_slot"):
            assert counts[kernel + sfx + name] == 1, kernel + sfx + name
    assert sum(cuda.launch_counts().values()) == 6
    f32_entries = [c[0] for c in calls[:3]]
    assert f32_entries == [f"gofr_flash_attention{sfx}_f32" if d == 64 else
                           "gofr_flash_attention_f32", f"gofr_decode_attention{sfx}_f32",
                           f"gofr_kv_append_slot{sfx}_f32"]
    assert all(n_types == n_args for _, n_types, n_args in calls)
    # the named f32 wrappers refuse other types; fp16 and f32 pools are refused
    half = torch.zeros(2, 8, hq, d, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32"):
        flash_attention_f32(*(t.to(torch.bfloat16) for t in (half, half, half)))
    with pytest.raises(ValueError, match="bf16 or f32"):
        flash_attention(half, half, half)
    qh, ch = torch.zeros(n, hq, d, dtype=torch.float16), torch.zeros(n, hkv, smax, d,
                                                                     dtype=torch.float16)
    with pytest.raises(ValueError, match="bf16 or f32"):
        decode_attention(qh, ch, ch, lengths)
    with pytest.raises(ValueError, match="f32"):
        decode_attention_f32(qh.to(torch.bfloat16), ch.to(torch.bfloat16), ch.to(torch.bfloat16),
                             lengths)
    bf_cache = torch.zeros(n, hkv, smax, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="f32"):
        kv_append_slot_f32(bf_cache, bf_cache, lengths, bf_cache[:, :, 0], bf_cache[:, :, 0])
    pool, table = torch.zeros(5, hkv, 16, d), torch.zeros(n, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-bit or f32 pools"):
        kv_append(pool, pool, table, lengths, pool[:n, :, 0].to(torch.bfloat16),
                  pool[:n, :, 0].to(torch.bfloat16))
    wide = pool.to(torch.float64)
    with pytest.raises(ValueError, match="16-bit or f32 pools"):
        kv_append(wide, wide, table, lengths, wide[:n, :, 0].contiguous(),
                  wide[:n, :, 0].contiguous())
    assert sum(cuda.launch_counts().values()) == 6


# -- the autotuner's pins carry the cache dtype ----------------------------------------


@pytest.mark.quick
def test_an_f32_pin_never_steers_a_bf16_launch():
    """A pin decided at f32 dims is not returned for the same shapes at
    bf16, nor the other way round; each dtype's own launch takes it."""
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan, split_scratch

    n, hq, hkv, d, smax = 9, 12, 12, 64, 1024
    shape = autotune.shape_key(n, hq, hkv, d, smax)
    rule = split_plan(n, hkv, smax)
    pinned = 512 if rule[0] != 512 else 256
    dims = {dt: (n, hq, hkv, d, smax, dt) for dt in ("float32", "bfloat16")}
    for decided, other in (("float32", "bfloat16"), ("bfloat16", "float32")):
        with autotune.decision_scope({"decode": f"rows{pinned}"}, {"decode": shape},
                                     {"decode": decided}):
            assert autotune.pinned_plan("decode", dims[decided]) == pinned
            assert autotune.pinned_plan("decode", dims[other]) is None
            for dt, want in ((decided, pinned), (other, rule[0])):
                q = torch.zeros(n, hq, d, dtype=getattr(torch, dt))
                assert split_scratch(q, hkv, smax, "decode", dims[dt])[0] == want


@pytest.mark.quick
def test_an_f32_engine_tunes_f32_and_pins_at_its_dtype(monkeypatch, tmp_path):
    """Warmup on an f32 slot cache times F's plans at the f32 build's
    limits, records ``float32`` and pins at that dtype: inside the engine's
    scope the f32 launch takes the pin, a bf16 launch of the same shapes
    keeps the rule."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.ops import attention as A
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates, split_scratch

    monkeypatch.delenv("GOFR_AUTOTUNE", raising=False)
    monkeypatch.setenv("GOFR_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "enabled", lambda device=None: True)
    eng = build_engine("tiny", device="cpu", seed=0, slots=2, max_len=64, kv_layout="slot")
    assert eng.cfg.dtype == torch.float32
    eng._autotune_launch = lambda op, rows, skey, q, planes, lengths: (
        A.decode_attention_split_plain(q, *planes, lengths, rows))
    plans = split_candidates(2, eng.cfg.num_kv_heads, eng.cache_len)
    times = iter([2e-3, 1e-3, 3e-3, 4e-3, 5e-3])
    eng._autotune_timer = lambda fn: (fn(), next(times))[1]
    try:
        eng.warmup()
    finally:
        eng.stop()
    rec = eng.autotune_report()["decisions"]["decode"]
    assert rec["kv_dtype"] == "float32" and eng._autotune_kv_dtypes == {"decode": "float32"}
    winner = plans[1]
    assert eng._autotune_pins == {"decode": f"rows{winner}"}
    cfg, n = eng.cfg, eng.num_slots
    shape = (n, cfg.num_heads, cfg.num_kv_heads, cfg.head_size, eng.cache_len)
    with eng._decision_scope():
        for dt, want in (("float32", winner), ("bfloat16", plans[0])):
            q = torch.zeros(n, cfg.num_heads, cfg.head_size, dtype=getattr(torch, dt))
            assert split_scratch(q, cfg.num_kv_heads, eng.cache_len, "decode",
                                 (*shape, dt))[0] == want


# -- the slice as a whole: GPT-2 in f32 from a ModelSpec ---------------------------------


@pytest.mark.quick
def test_gpt2_in_f32_from_a_model_spec_serves_the_jax_engine_s_tokens():
    """``build_engine(ModelSpec("gpt2", dtype=torch.float32), container)``,
    the App's route to the f32 path: the family's slot cache in f32 (C, F and
    G's f32 builds on the card, their plain versions here), and the JAX
    engine's greedy tokens on the same f32 weights."""
    import dataclasses

    import jax

    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import gpt2
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.gpt2 import GPT2Config
    from gofr_tpu_torch.ops.kvcache import SlotKVCache

    jcfg = gpt2.GPT2Config.tiny()
    params = gpt2.init(jcfg, jax.random.key(22))
    tree = jax.tree.map(np.asarray, params)
    knobs = dict(slots=4, max_len=64, max_prefill_batch=2)
    jeng = JaxEngine(gpt2, jcfg, params, jax_container(), **knobs)
    try:
        want = [r.result(timeout=120)["tokens"]
                for r in [jeng.submit(p, max_new_tokens=6) for p in PROMPTS]]
    finally:
        jeng.stop()
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    spec = ModelSpec("gpt2", GPT2Config(**fields), weights=tree, dtype=torch.float32)
    eng = build_engine(spec, new_mock_container(), device="cpu", **knobs)
    try:
        assert type(eng.cache) is SlotKVCache and eng.cache.k.dtype == torch.float32
        got = [r.result(timeout=120)["tokens"]
               for r in [eng.submit(p, max_new_tokens=6) for p in PROMPTS]]
    finally:
        eng.stop()
    assert got == want


# -- the f32 builds against their plain versions (on the card only) --------------------


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _within(got, want, limits):
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt().clamp_min(1e-30)
    return bool(got.isfinite().all()) and diff.abs().max().item() <= limits.MAX_ABS \
        and rel.item() <= limits.RMS_REL


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_f32_flash_matches_plain_on_the_card(d):
    """C's f32 build, in f32 out, within ``F32`` of the plain version on the
    calls its body must cut right: causal, ragged with offsets and a fully
    masked row (0), an encoder's padded keys, ViT's 197 positions, BERT-style
    lengths (a bucket of 64, padded rows of length 1), a chunk of 80 queries
    at offsets against 208 keys (Sq not a multiple of the 64-row tile); one
    launch each, counted under its own name."""
    _needs_card()
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import mha_attention_plain
    from gofr_tpu_torch.ops.cuda import flash_attention as mod

    def cuda_i32(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.reset_launch_counts()
    q, k, v = (_t(a).cuda() for a in _qkv(31 + d, 3, 200, 200, 8, 2, d))
    lens, offs = cuda_i32([200, 131, 0]), cuda_i32([0, 40, 0])
    vit = tuple(_t(a).cuda() for a in _qkv(32 + d, 2, 197, 197, 4, 4, d))
    bert = tuple(_t(a).cuda() for a in _qkv(33 + d, 8, 64, 64, 4, 4, d))
    chunk = tuple(_t(a).cuda() for a in _qkv(34 + d, 2, 80, 208, 8, 2, d))
    calls = [((q, k, v), dict(causal=True)),
             ((q, k, v), dict(causal=True, q_offset=offs, kv_lengths=lens)),
             ((q, k, v), dict(causal=False, kv_lengths=lens)),
             (vit, dict(causal=False)),
             (bert, dict(causal=False, kv_lengths=cuda_i32([64, 9, 1, 33, 64, 1, 1, 50]))),
             (chunk, dict(causal=True, q_offset=cuda_i32([128, 65]), kv_lengths=cuda_i32([208, 145])))]
    for args, kw in calls:
        got = mod.flash_attention(*args, **kw)
        assert got.dtype == torch.float32
        assert _within(got, mha_attention_plain(*args, **kw), mod.F32)
    got = mod.flash_attention(q, k, v, causal=True, q_offset=offs, kv_lengths=lens)
    assert torch.all(got[2] == 0)
    torch.cuda.synchronize()
    assert cuda.launch_counts()["flash_attention" + ("_d64" if d == 64 else "") + "_f32"] == len(calls) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64])
def test_f32_slot_decode_and_append_match_plain_on_the_card(d):
    """F's f32 build (split and unsplit) within ``F32`` of the plain
    version, and G's f32 build bit for bit against the plain append."""
    _needs_card()
    from gofr_tpu_torch.ops.attention import decode_attention_plain
    from gofr_tpu_torch.ops.cuda import decode_attention as mod
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append_slot
    from gofr_tpu_torch.ops.kvcache import append_tokens_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, lengths = (_t(a).cuda() for a in _slot_case(41 + d, 8, 8, 2, d, 1024))
    got = mod.decode_attention(q, k, v, lengths)
    assert got.dtype == torch.float32 and torch.all(got[0] == 0)
    assert _within(got, decode_attention_plain(q, k, v, lengths), mod.F32)
    rows = torch.randn(8, 2, d, device="cuda", generator=torch.Generator("cuda").manual_seed(4))
    pos = lengths.clamp(max=1023)
    pos[1] = -1
    got_k, got_v, want_k, want_v = k.clone(), v.clone(), k.clone(), v.clone()
    kv_append_slot(got_k, got_v, pos, rows, rows)
    append_tokens_plain(want_k, want_v, pos, rows, rows)
    torch.cuda.synchronize()
    assert torch.equal(got_k.view(torch.int32), want_k.view(torch.int32))
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
