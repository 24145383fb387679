"""The port's slot KV layout held against the JAX package.

Inputs come from a numpy seed and go through both the JAX function and its
port (gofr_tpu_torch.ops.{kvcache,attention}, the model and the engine with
``kv_layout="slot"``). The Pallas kernels run under the interpreter, as
tests/test_pallas.py runs them; on the CPU the port's kernel wrappers take
their plain versions because the tensors lie on the CPU.

Tolerances:
- cache writes and appends, values and scales: exact equality (the cache
  is a contract between writer and reader);
- decode attention, f32 inputs: 2e-5, the JAX test's own (the frameworks
  sum in different orders);
- decode attention, bf16 inputs: against the XLA path exact (the plain
  version mirrors it op for op, bf16 roundings included); against the
  Pallas kernel 1.6e-2 absolute: the plain version rounds the scores to
  bf16 where the kernel keeps them in f32, which moves outputs of up to
  1.1 by one bf16 ulp (7.8e-3 in [1, 2)); the limit is two ulps;
- model logits on the f32 tiny config: 1e-4, as tests/test_torch_llama.py;
- greedy tokens: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 2e-5
BF16_TOL = 1.6e-2
LOGIT_TOL = 1e-4
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6]]
SMAX = 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(a):
    """A JAX or numpy array as a torch tensor, bf16 by its bit pattern."""
    from gofr_tpu_torch.models.llama import tensor_from_numpy

    return tensor_from_numpy(np.asarray(a))


def _bits(a):
    """Bit pattern of an array or tensor, for exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint8)
    return np.asarray(a).view(np.uint8)


def _cast(a, dtype):
    a = jnp.asarray(a)
    return a if dtype == "f32" else a.astype(jnp.bfloat16)


def _slot_case(seed, n=4, hkv=2, smax=SMAX, d=16):
    """Per-layer slot caches [N, Hkv, Smax, D] and new rows [N, Hkv, D]."""
    rng = np.random.default_rng(seed)
    k, v = (rng.standard_normal((n, hkv, smax, d)).astype(np.float32) for _ in range(2))
    k_new, v_new = (rng.standard_normal((n, hkv, d)).astype(np.float32) for _ in range(2))
    return k, v, k_new, v_new


# -- decode attention -----------------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("group", [1, 4, 8])
def test_decode_attention_matches_pallas_kernel_and_xla_path(group, dtype):
    from gofr_tpu.ops import attention as jax_attention
    from gofr_tpu.ops.pallas.decode_attention import decode_attention as pallas_decode
    from gofr_tpu_torch.ops.attention import decode_attention

    k, v, _, _ = _slot_case(0)
    q = np.random.default_rng(1).standard_normal((4, 2 * group, 16)).astype(np.float32)
    # ragged: a live prefix, an empty slot, the whole slot, past the slot
    lengths = np.array([17, 0, SMAX, SMAX + 3], np.int32)
    jq, jk, jv = (_cast(a, dtype) for a in (q, k, v))
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(lengths), interpret=True)
    xla = jax_attention.decode_attention(jq, jk, jv, jnp.asarray(lengths), backend="xla")
    got = decode_attention(_port(jq), _port(jk), _port(jv), _t(lengths))
    assert got.shape == (4, 2 * group, 16) and np.isfinite(got.float().numpy()).all()
    assert torch.all(got[1] == 0)  # the empty slot
    # a length past the slot attends to the whole slot
    torch.testing.assert_close(got[3], decode_attention(
        _port(jq), _port(jk), _port(jv), _t(np.full(4, SMAX, np.int32)))[3], rtol=0, atol=0)
    if dtype == "f32":
        for want in (pallas, xla):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(xla))
        np.testing.assert_allclose(got.float().numpy(), np.asarray(pallas).astype(np.float32),
                                   atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_q_matches_jax(dtype):
    from gofr_tpu.ops import attention as jax_attention, kvcache as jax_kv
    from gofr_tpu_torch.ops.attention import decode_attention_q

    k, v, _, _ = _slot_case(2)
    (kq, ks), (vq, vs) = (jax_kv.quantize_row(jnp.asarray(a)) for a in (k, v))
    ks, vs = ks.astype(jnp.bfloat16), vs.astype(jnp.bfloat16)
    q = _cast(np.random.default_rng(3).standard_normal((4, 8, 16)).astype(np.float32), dtype)
    lengths = jnp.asarray(np.array([17, 0, SMAX, SMAX + 3], np.int32))
    want = jax_attention.decode_attention_q(q, kq, vq, ks, vs, lengths)
    got = decode_attention_q(*(_port(a) for a in (q, kq, vq, ks, vs, lengths)))
    assert torch.all(got[1] == 0)
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))


# -- appends and writes, bit for bit ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_append_tokens_matches_pallas_inplace_and_drops_like_select(dtype, monkeypatch):
    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu.ops.pallas.kv_append import append_tokens_inplace
    from gofr_tpu_torch.ops.kvcache import append_tokens

    monkeypatch.delenv("GOFR_KV_WRITE", raising=False)  # the select lowering
    k, v, k_new, v_new = (_cast(a, dtype) for a in _slot_case(4))
    # in range: mid-tile, first row, last row, a tile boundary
    positions = jnp.asarray(np.array([17, 0, SMAX - 1, 8], np.int32))
    wk, wv = append_tokens_inplace(k, v, positions, k_new, v_new, block_s=8, interpret=True)
    gk, gv = _port(k), _port(v)
    out = append_tokens(gk, gv, _port(positions), _port(k_new), _port(v_new))
    assert out[0] is gk and out[1] is gv  # written in place
    np.testing.assert_array_equal(_bits(gk), _bits(wk))
    np.testing.assert_array_equal(_bits(gv), _bits(wv))
    assert not np.array_equal(_bits(gk), _bits(k))
    # outside the slot: the select lowering drops Smax, past it and -1; so
    # does the port. The Pallas kernel drops pos >= Smax but writes -1 into
    # the slot's last row (ROADMAP Queue C); the port follows the select rule.
    outside = jnp.asarray(np.array([SMAX, -1, SMAX + 5, 3], np.int32))
    sk, sv = jax_kv.append_tokens(k, v, outside, k_new, v_new)
    gk, gv = _port(k), _port(v)
    append_tokens(gk, gv, _port(outside), _port(k_new), _port(v_new))
    np.testing.assert_array_equal(_bits(gk), _bits(sk))
    np.testing.assert_array_equal(_bits(gv), _bits(sv))
    np.testing.assert_array_equal(_bits(gk[:3]), _bits(k[:3]))
    pk, _ = append_tokens_inplace(k, v, outside, k_new, v_new, block_s=8, interpret=True)
    diverge = np.argwhere(np.asarray(pk) != np.asarray(sk))
    assert tuple(diverge[0]) == (1, 0, SMAX - 1, 0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_append_tokens_q_matches_jax_and_drops_outside_the_slot(dtype):
    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu_torch.ops.kvcache import append_tokens_q

    k, _, k_new, _ = _slot_case(5)
    cq, cs = jax_kv.quantize_row(jnp.asarray(k))
    cs = cs.astype(jnp.bfloat16)
    new = _cast(k_new, dtype)
    for positions in ([17, 0, SMAX - 1, 8], [SMAX, -1, 3, SMAX + 2]):
        pos = jnp.asarray(np.array(positions, np.int32))
        wq, ws = jax_kv.append_tokens_q(cq, cs, pos, new)
        gq, gs = _port(cq), _port(cs)
        append_tokens_q(gq, gs, _port(pos), _port(new))
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(_bits(gs), _bits(ws))
        assert not np.array_equal(gq.numpy(), np.asarray(cq))


@pytest.mark.quick
@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("kind", ["", "int8"])
def test_write_prompts_match_jax_and_drop_outside_the_cache(kind, chunked):
    from gofr_tpu.ops import kvcache as jax_kv
    from gofr_tpu_torch.ops import kvcache

    rng = np.random.default_rng(6)
    k, v, _, _ = _slot_case(7, n=3, smax=24)
    new_k, new_v = (rng.standard_normal((4, 6, 2, 16)).astype(np.float32) for _ in range(2))
    # row 1 names a slot past the cache; with offsets, row 2 runs past Smax
    slots = np.array([2, 3, 0, 1], np.int32)
    offsets = np.array([5, 0, 20, 7], np.int32) if chunked else None
    jo = None if offsets is None else jnp.asarray(offsets)
    to = None if offsets is None else _t(offsets)
    if kind == "":
        jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
        wk, wv = jax_kv.write_prompts(jk, jv, jnp.asarray(slots), jnp.asarray(new_k),
                                      jnp.asarray(new_v), jo)
        before, gk, gv = _port(jk), _port(jk), _port(jv)
        out = kvcache.write_prompts(gk, gv, _t(slots), _t(new_k), _t(new_v), to)
        assert out[0] is gk and out[1] is gv
        pairs = ((gk, wk), (gv, wv))
    else:
        cq, cs = jax_kv.quantize_row(jnp.asarray(k))
        cs = cs.astype(jnp.bfloat16)
        wq, ws = jax_kv.write_prompts_q(cq, cs, jnp.asarray(slots), jnp.asarray(new_k), jo)
        before, gq, gs = _port(cq), _port(cq), _port(cs)
        out = kvcache.write_prompts_q(gq, gs, _t(slots), _t(new_k), to)
        assert out[0] is gq and out[1] is gs
        pairs = ((gq, wq), (gs, ws))
    for got, want in pairs:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.array_equal(_bits(pairs[0][0]), _bits(before))


@pytest.mark.quick
def test_slot_caches_shapes_and_bytes_per_position():
    from gofr_tpu_torch.ops.kvcache import QSlotKVCache, SlotKVCache
    from gofr_tpu_torch.ops.paged import kv_plane_bytes_per_position

    c = SlotKVCache.create(2, 3, 24, 2, 16, dtype=torch.float32)
    cq = QSlotKVCache.create(2, 3, 24, 2, 16)
    assert c.k.shape == (2, 3, 2, 24, 16) and c.k.dtype == torch.float32
    assert cq.k.dtype == torch.int8 and cq.ks.shape == (2, 3, 2, 24) and cq.vs.dtype == torch.bfloat16
    assert (cq.num_layers, cq.num_slots, cq.max_len) == (2, 3, 24)
    # full-width Llama-3-8B: 131,072 B (bf16) and 66,560 B (int8) per position,
    # as on the paged pool; 8 slots x 2176 positions as the engine sizes them
    for cls, kind, per in ((SlotKVCache, "bf16", 131072), (QSlotKVCache, "int8", 66560)):
        one = cls.create(32, 1, 1, 8, 128)
        assert sum(t.nbytes for t in vars(one).values()) == per
        assert kv_plane_bytes_per_position(32, 8, 128, kind) == per
    assert 131072 * 8 * 2176 == 2_281_701_376 and 66560 * 8 * 2176 == 1_158_676_480


# -- the model on slot caches -------------------------------------------------------------


def _port_cfg(jcfg):
    from gofr_tpu_torch.models.llama import LlamaConfig

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return LlamaConfig(**fields, dtype=torch.float32)


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(11))
    model = params_from_jax(_port_cfg(jcfg), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _caches(jcfg, model, kind, slots=3, max_len=32):
    from gofr_tpu.models import llama

    if kind == "int8":
        return llama.make_cache_q(jcfg, slots, max_len), model.make_cache_q(slots, max_len)
    return llama.make_cache(jcfg, slots, max_len), model.make_cache(slots, max_len)


def _same_cache(cache, jcache, kind):
    if kind == "int8":
        # scales agree to a bf16 ulp (each comes from activations that agree
        # to 1e-4); almost every int8 code is equal
        np.testing.assert_allclose(cache.ks.float().numpy(),
                                   np.asarray(jcache.ks).astype(np.float32), rtol=1e-2, atol=1e-6)
        assert np.mean(cache.k.numpy() == np.asarray(jcache.k)) > 0.99
    else:
        _close(cache.k, jcache.k)
        _close(cache.v, jcache.v)


@pytest.mark.parametrize("kind", ["", "int8"])
def test_prefill_then_four_decode_steps_match_jax(tiny, kind):
    from gofr_tpu.models import llama

    jcfg, params, model = tiny
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 10))
    lengths = np.array([10, 6], np.int32)
    slots = np.array([2, 0], np.int32)
    jcache, cache = _caches(jcfg, model, kind)
    want, jcache = llama.prefill(jcfg, params, jnp.asarray(tokens), jnp.asarray(lengths),
                                 jcache, jnp.asarray(slots))
    got, cache = model.prefill(_t(tokens), _t(lengths), cache, _t(slots))
    _close(got, want)
    _same_cache(cache, jcache, kind)
    # every slot decodes: slot 1 holds nothing and sits at the slot's end,
    # as the engine parks an idle lane, so its writes drop
    positions = np.array([6, 32, 10], np.int32)
    step = np.zeros(3, np.int32)
    step[slots] = np.asarray(jnp.argmax(want, -1))
    for _ in range(4):
        want, jcache = llama.decode_step(jcfg, params, jnp.asarray(step), jnp.asarray(positions),
                                         jcache)
        got, cache = model.decode_step(_t(step), _t(positions), cache)
        _close(got, want)
        np.testing.assert_array_equal(got.argmax(-1).numpy()[[0, 2]],
                                      np.asarray(jnp.argmax(want, -1))[[0, 2]])
        step = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        positions = positions + 1
    _same_cache(cache, jcache, kind)


@pytest.mark.parametrize("kind", ["", "int8"])
def test_chunked_prefill_with_offsets_matches_jax(tiny, kind):
    from gofr_tpu.models import llama

    jcfg, params, model = tiny
    rng = np.random.default_rng(9)
    first = rng.integers(0, jcfg.vocab_size, (2, 9))
    second = rng.integers(0, jcfg.vocab_size, (2, 7))
    len1, len2 = np.array([9, 5], np.int32), np.array([7, 4], np.int32)
    slots = np.array([1, 2], np.int32)
    jcache, cache = _caches(jcfg, model, kind)
    _, jcache = llama.prefill(jcfg, params, jnp.asarray(first), jnp.asarray(len1), jcache,
                              jnp.asarray(slots))
    want, jcache = llama.prefill(jcfg, params, jnp.asarray(second), jnp.asarray(len2), jcache,
                                 jnp.asarray(slots), jnp.asarray(len1))
    model.prefill(_t(first), _t(len1), cache, _t(slots))
    got, cache = model.prefill(_t(second), _t(len2), cache, _t(slots), _t(len1))
    _close(got, want)
    _same_cache(cache, jcache, kind)


# -- the engine on the slot layout -----------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["", "int8"])
def test_greedy_tokens_equal_the_jax_slot_engine(tiny, kind):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.ops.kvcache import QSlotKVCache, SlotKVCache

    jcfg, params, model = tiny
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, kv_layout="slot", kv_quantize=kind)
    try:
        want = [r.result(timeout=120) for r in [jeng.submit(p, max_new_tokens=7) for p in PROMPTS]]
        jax_cache_len = jeng._cache_len
    finally:
        jeng.stop()
    eng = GenerateEngine(model, device="cpu", slots=4, max_len=64, max_prefill_batch=2,
                         kv_layout="slot", kv_quantize=kind)
    try:
        assert type(eng.cache) is (QSlotKVCache if kind else SlotKVCache)
        assert eng.cache_len == jax_cache_len == eng.cache.max_len
        got = [r.result(timeout=120) for r in [eng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        eng.stop()
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["finish_reason"] for g in got] == ["length"] * len(PROMPTS)


@pytest.mark.quick
def test_engine_layout_rules_and_slot_reuse(tiny):
    from gofr_tpu_torch.gpu.engine import GenerateEngine, build_engine
    from gofr_tpu_torch.ops.paged import PagedKVCache

    _, _, model = tiny
    with pytest.raises(ValueError, match="kv_quantize='int4' needs kv_layout='paged'"):
        build_engine("tiny", device="cpu", kv_layout="slot", kv_quantize="int4")
    with pytest.raises(ValueError, match="kv_layout 'ring': use 'slot' or 'paged'"):
        build_engine("tiny", device="cpu", kv_layout="ring")
    eng = build_engine("tiny", device="cpu", page_size=8, slots=2, max_len=32)
    try:
        assert eng.kv_layout == "paged" and type(eng.cache) is PagedKVCache
    finally:
        eng.stop()
    # one slot serves every request in turn; the slot layout has no pages
    wide = GenerateEngine(model, device="cpu", slots=4, max_len=64, kv_layout="slot")
    one = GenerateEngine(model, device="cpu", slots=1, max_len=64, kv_layout="slot")
    try:
        want = [wide.generate(p, max_new_tokens=5, timeout=60)["tokens"] for p in PROMPTS[:3]]
        got = [r.result(timeout=120)["tokens"]
               for r in [one.submit(p, max_new_tokens=5) for p in PROMPTS[:3]]]
        assert got == want
        assert one.slots == [None]
        with pytest.raises(RuntimeError, match="no pages"):
            one.free_pages()
    finally:
        wide.stop()
        one.stop()


# -- the CPU/card choice ----------------------------------------------------------------------


@pytest.mark.quick
def test_wrappers_take_the_plain_path_on_cpu_and_launchers_refuse_it():
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import decode_attention
    from gofr_tpu_torch.ops.cuda.decode_attention import decode_attention as launch_decode
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append_slot
    from gofr_tpu_torch.ops.kvcache import append_tokens

    cuda.reset_launch_counts()
    k, v, k_new, v_new = (_t(a) for a in _slot_case(10))
    q, lengths = _t(np.ones((4, 4, 16), np.float32)), _t(np.array([3, 0, 40, 9], np.int32))
    assert decode_attention(q, k, v, lengths).shape == (4, 4, 16)
    append_tokens(k, v, lengths, k_new, v_new)
    with pytest.raises(ValueError, match="on the card"):
        launch_decode(q, k, v, lengths)
    with pytest.raises(ValueError, match="on the card"):
        kv_append_slot(k, v, lengths, k_new, v_new)
    counts = cuda.launch_counts()
    assert {"decode_attention", "kv_append_slot"} <= set(counts)
    assert set(counts.values()) == {0}


# -- the CUDA kernels against their plain versions (on the card only) -----------------------


@pytest.mark.cuda
def test_slot_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops.attention import decode_attention_plain
    from gofr_tpu_torch.ops.cuda import decode_attention as mod
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append_slot
    from gofr_tpu_torch.ops.kvcache import append_tokens_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    # Smax not a multiple of the 64-row tile; lengths of hundreds, an empty
    # slot and one past the slot
    k = torch.randn(4, 2, 300, 128, device=dev, generator=g).to(bf)
    v = torch.randn(4, 2, 300, 128, device=dev, generator=g).to(bf)
    q = torch.randn(4, 8, 128, device=dev, generator=g).to(bf)
    lengths = torch.tensor([305, 230, 0, 150], device=dev, dtype=torch.int32)
    got, want = mod.decode_attention(q, k, v, lengths), decode_attention_plain(q, k, v, lengths)
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()
    assert diff.abs().max().item() <= mod.MAX_ABS and rel.item() <= mod.RMS_REL
    assert torch.all(got[2] == 0)
    kn = torch.randn(4, 2, 128, device=dev, generator=g).to(bf)
    positions = torch.tensor([300, 17, -1, 299], device=dev, dtype=torch.int32)
    a, b = k.clone(), v.clone()
    kv_append_slot(a, b, positions, kn, kn)
    c, d = k.clone(), v.clone()
    append_tokens_plain(c, d, positions, kn, kn)
    assert torch.equal(a.view(torch.int16), c.view(torch.int16))
    assert torch.equal(b.view(torch.int16), d.view(torch.int16))
    assert torch.equal(a[0], k[0]) and torch.equal(a[2], k[2]) and not torch.equal(a[1], k[1])


@pytest.mark.cuda
def test_split_slot_decode_matches_plain_at_split_boundaries():
    """Kernel F split over the sequence at the engine's shapes: lanes on and
    one past the first split boundaries, the whole slot, the empty slot and
    a lane past the slot, held against the split's plain version (f32
    scores, as the kernel) and the ragged long lanes against the unsplit one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops.attention import decode_attention_plain, decode_attention_split_plain
    from gofr_tpu_torch.ops.cuda import decode_attention as mod

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(2)
    n, smax = 9, 2176
    k = torch.randn(n, 8, smax, 128, device=dev, generator=g).to(bf)
    v = torch.randn(n, 8, smax, 128, device=dev, generator=g).to(bf)
    q = torch.randn(n, 32, 128, device=dev, generator=g).to(bf)
    r, splits = mod.split_plan(n, 8, smax)
    assert splits > 1
    edges = torch.tensor([r, r + 1, 2 * r, 2 * r + 1, smax, 0, smax + 5, 3 * r, 3 * r + 1],
                         device=dev, dtype=torch.int32)
    got = mod.decode_attention(q, k, v, edges)
    want = decode_attention_split_plain(q, k, v, edges, r)
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()
    assert diff.abs().max().item() <= mod.MAX_ABS and rel.item() <= mod.RMS_REL
    assert torch.all(got[5] == 0)
    long = torch.tensor([699, 1591, 1200, 2000, 1000, 0, 1500, 800, 1300], device=dev,
                        dtype=torch.int32)
    got, want = mod.decode_attention(q, k, v, long), decode_attention_plain(q, k, v, long)
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()
    assert diff.abs().max().item() <= mod.MAX_ABS and rel.item() <= mod.RMS_REL
