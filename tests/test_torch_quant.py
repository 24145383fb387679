"""The port's int8 and int4 paged pools held against the JAX package.

Inputs come from a numpy seed and go through both the JAX function and its
port (gofr_tpu_torch.ops.{kvcache,quant,paged,attention}, the model and the
engine). The Pallas kernels run as tests/test_pallas.py runs them, under
the interpreter; on the CPU the port's kernel wrappers take their plain
versions because the tensors lie on the CPU.

Tolerances:
- quantizers, pool bytes and scale planes: exact equality (the formats are
  a contract between writer and reader);
- decode attention, f32 inputs: 1e-5 (the two frameworks sum in different
  orders);
- decode attention, bf16 inputs, against the Pallas kernel: 1.6e-2
  absolute. The plain version rounds the scores and p * vs to bf16 as the
  JAX XLA path does; the Pallas kernel keeps both in f32. On outputs of up
  to 2.2 the two differ by at most 7.8e-3 (one bf16 ulp in [1, 2)); the
  limit is two such ulps. Against the XLA path itself: exact;
- model logits on the f32 tiny config: 1e-4, as tests/test_torch_llama.py;
- greedy engine tokens: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

F32_TOL = 1e-5
BF16_TOL = 1.6e-2
LOGIT_TOL = 1e-4
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6]]


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
    a = np.asarray(a)
    return a.view(np.uint8)


def _rows(seed, shape, dtype):
    """Rows of widely different magnitudes, one all-zero row."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(1e-3, 50.0, shape[:-1] + (1,))
    x[(0,) * (len(shape) - 1)] = 0.0
    x = jnp.asarray(x.astype(np.float32))
    return x if dtype == "f32" else x.astype(jnp.bfloat16)


# -- (a) the row formats, bit for bit --------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fn", ["quantize_row", "quantize_row_int4", "fake_quant_row",
                                "fake_quant_row_int4"])
def test_row_quantizers_are_bit_exact_against_jax(fn, dtype):
    from gofr_tpu.ops import kvcache as jax_kv, quant as jax_quant
    from gofr_tpu_torch.ops import kvcache, quant

    jax_fn = getattr(jax_kv, fn, None) or getattr(jax_quant, fn)
    port_fn = getattr(kvcache, fn, None) or getattr(quant, fn)
    x = _rows(0, (5, 7, 3, 16), dtype)
    want, got = jax_fn(x), port_fn(_port(x))
    if fn.startswith("quantize"):
        assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(_bits(got[1]), _bits(want[1]))
    else:
        assert str(got.dtype).endswith("float32" if dtype == "f32" else "bfloat16")
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_pack_and_unpack_int4_are_bit_exact_against_jax(dtype):
    from gofr_tpu.ops import quant as jax_quant
    from gofr_tpu_torch.ops.quant import pack_int4, unpack_int4

    q, _ = jax_quant.quantize_row_int4(_rows(1, (4, 6, 2, 16), dtype))
    # every nibble code, the unused -8 included
    codes = np.arange(-8, 8, dtype=np.int8)
    q = np.concatenate([np.asarray(q).reshape(-1, 16), np.stack([codes, codes[::-1]])])
    packed = pack_int4(_t(q))
    assert packed.dtype == torch.uint8 and packed.shape == (q.shape[0], 8)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jax_quant.pack_int4(jnp.asarray(q))))
    # split-half: byte j holds element j (low nibble) and j + D/2 (high)
    assert packed[-2, 0].item() == ((-8 + 8) | ((0 + 8) << 4))
    np.testing.assert_array_equal(unpack_int4(packed).numpy(), q)
    np.testing.assert_array_equal(unpack_int4(packed).numpy(),
                                  np.asarray(jax_quant.unpack_int4(jnp.asarray(packed.numpy()))))


# -- (b) pool writes and appends, bit for bit --------------------------------------


def _pool_case(seed, bits, pool=12, hkv=2, page=8, d=16, n=4, maxp=4):
    """A quantized pool plane with its scales (rows of normal values
    quantized by the JAX functions), ragged lengths (one empty slot) and a
    table with OOB (== P) entries."""
    from gofr_tpu.ops import kvcache as jax_kv, quant as jax_quant

    rng = np.random.default_rng(seed)
    rows = jnp.asarray(rng.standard_normal((pool, hkv, page, d)).astype(np.float32))
    if bits == 8:
        vals, scales = jax_kv.quantize_row(rows)
    else:
        vals, scales = jax_quant.quantize_row_int4(rows)
        vals = jax_quant.pack_int4(vals)
    vals, scales = np.asarray(vals), np.asarray(scales.astype(jnp.bfloat16))
    table = np.full((n, maxp), pool, np.int32)
    lengths = np.array([29, 0, 8, 13], np.int32)[:n]
    perm = rng.permutation(pool)
    used = 0
    for i, ln in enumerate(lengths):
        need = -(-int(ln) // page)
        table[i, :need] = perm[used:used + need]
        used += need
    return vals, scales, table, lengths


def _jax_write_fns(bits):
    from gofr_tpu.ops import paged as jax_paged
    from gofr_tpu_torch.ops import paged

    if bits == 8:
        return (jax_paged.write_prompts_paged_q, jax_paged.append_tokens_paged_q,
                jax_paged.gather_kv_q, paged.write_prompts_paged_q, paged.append_tokens_paged_q,
                paged.gather_kv_q)
    return (jax_paged.write_prompts_paged_q4, jax_paged.append_tokens_paged_q4,
            jax_paged.gather_kv_q4, paged.write_prompts_paged_q4, paged.append_tokens_paged_q4,
            paged.gather_kv_q4)


@pytest.mark.quick
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("chunked", [False, True])
def test_write_prompts_and_gather_are_bit_exact_against_jax(bits, chunked):
    jax_write, _, jax_gather, write, _, gather = _jax_write_fns(bits)
    vals, scales, table, _ = _pool_case(10 + bits, bits)
    new = np.random.default_rng(11).standard_normal((4, 6, 2, 16)).astype(np.float32)
    offsets = np.array([5, 0, 2, 7], np.int32) if chunked else None
    # row 1's table is all OOB (== P): its rows must drop
    wq, ws = jax_write(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(table),
                       jnp.asarray(new), None if offsets is None else jnp.asarray(offsets))
    gq, gs = _t(vals.copy()), _port(scales)
    out = write(gq, gs, _t(table), _t(new), None if offsets is None else _t(offsets))
    assert out[0] is gq and out[1] is gs  # written in place
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert not np.array_equal(gq.numpy(), vals)
    jq, js = jax_gather(wq, ws, jnp.asarray(table))
    tq, ts = gather(gq, gs, _t(table))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


@pytest.mark.parametrize("bits", [8, 4])
def test_append_tokens_is_bit_exact_against_jax_and_drops_past_the_table(bits):
    _, jax_append, _, _, append, _ = _jax_write_fns(bits)
    vals, scales, table, _ = _pool_case(20 + bits, bits)
    rng = np.random.default_rng(21)
    new = rng.standard_normal((4, 2, 16)).astype(np.float32)
    # a mid-page write, a slot whose entries are all OOB, a page boundary,
    # an OOB entry inside a live row
    positions = np.array([17, 3, 8, 9], np.int32)
    table[3, 1] = vals.shape[0]
    wq, ws = jax_append(jnp.asarray(vals), jnp.asarray(scales), jnp.asarray(table),
                        jnp.asarray(positions), jnp.asarray(new))
    gq, gs = _t(vals.copy()), _port(scales)
    append(gq, gs, _t(table), _t(positions), _t(new))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(_bits(gs), _bits(ws))
    assert not np.array_equal(gq.numpy(), vals)
    # JAX's XLA append clamps a position past the table onto the slot's last
    # page (paged.py:_locate); the port drops it, as the Pallas append
    # kernel does (ROADMAP Queue C). So this case is the port's alone.
    before_q, before_s = gq.clone(), gs.clone()
    append(gq, gs, _t(table), _t(np.array([32, 40, -1, 99], np.int32)), _t(new))
    assert torch.equal(gq, before_q) and torch.equal(gs.view(torch.int16), before_s.view(torch.int16))


@pytest.mark.quick
def test_pool_shapes_bytes_and_odd_head_dim():
    from gofr_tpu.ops import paged as jax_paged
    from gofr_tpu_torch.ops.paged import Q4PagedKVCache, QPagedKVCache, kv_plane_bytes_per_position

    c8 = QPagedKVCache.create(2, 5, 8, 3, 16)
    c4 = Q4PagedKVCache.create(2, 5, 8, 3, 16)
    assert c8.k.dtype == torch.int8 and c8.k.shape == (2, 5, 3, 8, 16)
    assert c4.k.dtype == torch.uint8 and c4.v.shape == (2, 5, 3, 8, 8)
    assert c4.ks.dtype == torch.bfloat16 and c4.vs.shape == (2, 5, 3, 8)
    assert (c4.num_layers, c4.num_pages, c4.page_size) == (2, 5, 8)
    with pytest.raises(ValueError, match="even head_dim"):
        Q4PagedKVCache.create(2, 5, 8, 3, 15)
    for kind in ("bf16", "int8", "int4"):
        assert kv_plane_bytes_per_position(32, 8, 128, kind) == \
            jax_paged.kv_plane_bytes_per_position(32, 8, 128, kind)
    # the full-width Llama-3-8B pool: 66,560 B (int8) and 33,792 B (int4) per position
    assert kv_plane_bytes_per_position(32, 8, 128, "int8") == 66560
    assert kv_plane_bytes_per_position(32, 8, 128, "int4") == 33792


# -- (c) decode attention against the Pallas kernels (interpret mode) ------------------


def _decode_case(bits, g, dtype):
    vals_k, ks, table, lengths = _pool_case(30 + bits, bits)
    vals_v, vs, _, _ = _pool_case(31 + bits, bits)
    q = np.random.default_rng(32).standard_normal((4, 2 * g, 16)).astype(np.float32)
    q = jnp.asarray(q) if dtype == "f32" else jnp.asarray(q).astype(jnp.bfloat16)
    return q, vals_k, vals_v, ks, vs, table, lengths


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_paged_decode_matches_pallas_kernel(bits, g, dtype):
    from gofr_tpu.ops.pallas import paged_decode as pallas
    from gofr_tpu_torch.ops import attention

    kernel = pallas.paged_decode_attention_q if bits == 8 else pallas.paged_decode_attention_q4
    port = (attention.paged_decode_attention_q if bits == 8
            else attention.paged_decode_attention_q4)
    q, kq, vq, ks, vs, table, lengths = _decode_case(bits, g, dtype)
    want = np.asarray(kernel(q, *(jnp.asarray(a) for a in (kq, vq, ks, vs, table, lengths)),
                             interpret=True)).astype(np.float32)
    got = port(_port(q), *(_port(a) for a in (kq, vq, ks, vs, table, lengths))).float().numpy()
    assert np.isfinite(got).all()
    assert np.all(got[1] == 0.0)  # the empty slot
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_paged_decode_plain_matches_jax_xla_path(bits):
    """The plain version mirrors the JAX XLA path (gather, then
    ``decode_attention_q``) op for op, bf16 roundings included."""
    from gofr_tpu.ops import attention as jax_attention
    from gofr_tpu_torch.ops import attention

    jax_fn = (jax_attention.paged_decode_attention_q if bits == 8
              else jax_attention.paged_decode_attention_q4)
    port = (attention.paged_decode_attention_q_plain if bits == 8
            else attention.paged_decode_attention_q4_plain)
    q, kq, vq, ks, vs, table, lengths = _decode_case(bits, 4, "bf16")
    want = jax_fn(q, *(jnp.asarray(a) for a in (kq, vq, ks, vs, table, lengths)), backend="xla")
    got = port(_port(q), *(_port(a) for a in (kq, vq, ks, vs, table, lengths)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


# -- (d) the model on quantized pools ------------------------------------------------


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


def _tables(n_pages=16):
    table = np.full((2, 4), n_pages, np.int32)
    table[0, :3] = [3, 9, 4]
    table[1, :2] = [12, 0]
    return table


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_prefill_whole_and_chunked_then_decode_match_jax(tiny, kind):
    from gofr_tpu.models import llama

    jcfg, params, model = tiny
    suffix = "_q" if kind == "int8" else "_q4"
    rng = np.random.default_rng(1)
    first = rng.integers(0, jcfg.vocab_size, (2, 9))
    second = rng.integers(0, jcfg.vocab_size, (2, 7))
    len1, len2 = np.array([9, 5], np.int32), np.array([7, 4], np.int32)
    table = _tables()
    jcache = getattr(llama, "make_paged_cache" + suffix)(jcfg, 16, page_size=8)
    cache = getattr(model, "make_paged_cache" + suffix)(16, page_size=8)
    # whole prompts, then a chunk at offsets len1
    want, jcache = llama.prefill_paged(jcfg, params, jnp.asarray(first), jnp.asarray(len1),
                                       jcache, jnp.asarray(table))
    got, cache = model.prefill_paged(_t(first), _t(len1), cache, _t(table))
    _close(got, want)
    want, jcache = llama.prefill_paged(jcfg, params, jnp.asarray(second), jnp.asarray(len2),
                                       jcache, jnp.asarray(table), jnp.asarray(len1))
    got, cache = model.prefill_paged(_t(second), _t(len2), cache, _t(table), _t(len1))
    _close(got, want)
    positions = len1 + len2
    for _ in range(3):
        step = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        want, jcache = llama.decode_step_paged(jcfg, params, jnp.asarray(step),
                                               jnp.asarray(positions), jcache, jnp.asarray(table))
        got, cache = model.decode_step_paged(_t(step), _t(positions), cache, _t(table))
        _close(got, want)
        positions = positions + 1
    assert cache.k.dtype == (torch.int8 if kind == "int8" else torch.uint8)
    # the scale planes agree to a bf16 ulp (each scale comes from activations
    # that agree to 1e-4); most int8/int4 codes are equal
    np.testing.assert_allclose(cache.ks.float().numpy(), np.asarray(jcache.ks).astype(np.float32),
                               rtol=1e-2, atol=1e-6)
    assert np.mean(cache.k.numpy() == np.asarray(jcache.k)) > 0.99


# -- (e) the engine on quantized pools -------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_greedy_tokens_equal_the_jax_paged_engine(tiny, kind):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model = tiny
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, kv_layout="paged", page_size=8, kv_quantize=kind)
    try:
        want = [r.result(timeout=120) for r in [jeng.submit(p, max_new_tokens=7) for p in PROMPTS]]
    finally:
        jeng.stop()
    eng = GenerateEngine(model, device="cpu", slots=4, max_len=64, max_prefill_batch=2,
                         page_size=8, kv_quantize=kind)
    try:
        got = [r.result(timeout=120) for r in [eng.submit(p, max_new_tokens=7) for p in PROMPTS]]
        assert eng.free_pages() == eng.total_pages
    finally:
        eng.stop()
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["finish_reason"] for g in got] == ["length"] * len(PROMPTS)


@pytest.mark.quick
def test_engine_rejects_an_unknown_kv_quantize_and_builds_each_pool():
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.ops.paged import PagedKVCache, Q4PagedKVCache, QPagedKVCache

    with pytest.raises(ValueError, match="use '', 'int8' or 'int4'"):
        build_engine("tiny", device="cpu", kv_quantize="fp8")
    for kind, cls in (("", PagedKVCache), ("int8", QPagedKVCache), ("int4", Q4PagedKVCache)):
        eng = build_engine("tiny", device="cpu", page_size=8, slots=2, max_len=32, kv_quantize=kind)
        try:
            assert type(eng.cache) is cls
            out = eng.generate([1, 2, 3], max_new_tokens=3, timeout=60)
            assert out["finish_reason"] == "length" and len(out["tokens"]) == 3
        finally:
            eng.stop()


# -- (f) the CPU/card choice -----------------------------------------------------------


@pytest.mark.quick
def test_wrappers_take_the_plain_path_on_cpu_and_launchers_refuse_it():
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import paged_decode_attention_q, paged_decode_attention_q4
    from gofr_tpu_torch.ops.cuda.paged_decode_q import paged_decode_q
    from gofr_tpu_torch.ops.cuda.paged_decode_q4 import paged_decode_q4

    cuda.reset_launch_counts()
    for bits, wrapper, launcher in ((8, paged_decode_attention_q, paged_decode_q),
                                    (4, paged_decode_attention_q4, paged_decode_q4)):
        args = [_port(a) for a in _decode_case(bits, 2, "bf16")]
        assert wrapper(*args).shape == args[0].shape
        with pytest.raises(ValueError, match="on the card"):
            launcher(*args)
    assert set(cuda.launch_counts().values()) == {0}
    assert {"paged_decode_q", "paged_decode_q4"} <= set(cuda.launch_counts())


# -- the CUDA kernels against their plain versions (on the card only) ---------------


def _card_pool(bits, g, seed):
    """A quantized pool on the card written from random bf16 K/V by the
    port's own write, lengths of hundreds (one empty slot), OOB entries."""
    from gofr_tpu_torch.ops.paged import (
        Q4PagedKVCache,
        QPagedKVCache,
        write_prompts_paged_q,
        write_prompts_paged_q4,
    )

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    cls, write = ((QPagedKVCache, write_prompts_paged_q) if bits == 8
                  else (Q4PagedKVCache, write_prompts_paged_q4))
    cache = cls.create(1, 40, 16, 2, 128, device=dev)
    perm = torch.randperm(40, device=dev, generator=gen).to(torch.int32)
    table = torch.full((3, 16), 40, device=dev, dtype=torch.int32)
    table[0, :15], table[1, :10] = perm[:15], perm[15:25]
    lengths = torch.tensor([230, 150, 0], device=dev, dtype=torch.int32)
    for plane, scales in ((cache.k[0], cache.ks[0]), (cache.v[0], cache.vs[0])):
        write(plane, scales, table, torch.randn(3, 256, 2, 128, device=dev, generator=gen).to(bf))
    q = torch.randn(3, 2 * g, 128, device=dev, generator=gen).to(bf)
    return q, cache.k[0], cache.v[0], cache.ks[0], cache.vs[0], table, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_decode_kernels_match_plain_on_the_card(bits):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops import attention
    from gofr_tpu_torch.ops.cuda import paged_decode_q as mod8
    from gofr_tpu_torch.ops.cuda import paged_decode_q4 as mod4

    mod = mod8 if bits == 8 else mod4
    launch = mod8.paged_decode_q if bits == 8 else mod4.paged_decode_q4
    plain = (attention.paged_decode_attention_q_plain if bits == 8
             else attention.paged_decode_attention_q4_plain)
    for g in (1, 4):
        args = _card_pool(bits, g, seed=g)
        got, want = launch(*args), plain(*args)
        diff = got.float() - want.float()
        rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()
        assert diff.abs().max().item() <= mod.MAX_ABS and rel.item() <= mod.RMS_REL
        assert torch.all(got[2] == 0)
    q, kq, vq, ks, vs, table, lengths = args
    with pytest.raises(ValueError, match="pools"):  # the other format's dtype
        launch(q, kq.view(torch.uint8 if bits == 8 else torch.int8),
               vq.view(torch.uint8 if bits == 8 else torch.int8), ks, vs, table, lengths)
    with pytest.raises(ValueError):  # f32 q
        launch(q.float(), kq, vq, ks, vs, table, lengths)
