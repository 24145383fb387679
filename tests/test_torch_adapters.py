"""The port's adapter plane (gofr_tpu_torch.{ops.lora,adapters} and the
engine's multi-LoRA serving) held against the JAX package.

Tolerances:
- ``lora_logits_delta``: within 1e-5 of the JAX function on [N, E] and
  [N, T, E] (both f32); a base lane's delta is exactly 0.0;
- ``random_adapter``: bit-equal to the JAX arrays for the same seed; the
  pool's slots, after uploads of padded ranks, bit-equal to the JAX pool's;
  ``slots_for_budget`` and ``digest``: equal;
- model entry points with a mixed ``sel`` on the f32 tiny config: logits
  within 1e-4 of JAX's, on all five caches, as the other model tests;
- engine tokens: greedy, exact against the JAX engine with the same
  adapters and submissions (and accept totals, per adapter, against the
  JAX spec engine at pipeline depth 1, the synchronous engine the port
  is). Every paged engine test ends with the pool audit
  ``check_page_refs``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

DELTA_TOL = 1e-5
LOGIT_TOL = 1e-4
PAGE = 8
BUCKETS = [8, 16]
N_NEW = 10
G = 4
RANK = 8
# prompts that chunk (past 16), share a two-page prefix, or neither
PREFIX = [(7 * i + 3) % 256 for i in range(2 * PAGE)]
TAILS = [[11, 12, 13, 14], list(range(40, 61)), [5] * 9, list(range(90, 103)),
         [200, 17, 33], list(range(120, 138)), [1, 2], list(range(150, 165))]
OTHERS = [[9, 8, 7], list(range(60, 90)), [42] * 12]
PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4, 6, 8, 10, 12]]
CACHES = [("paged", ""), ("paged", "int8"), ("paged", "int4"), ("slot", ""), ("slot", "int8")]
CACHE_IDS = ["bf16", "int8", "int4", "slot_bf16", "slot_int8"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def _specs(module, n=3, embed=64, vocab=256):
    """The JAX tests' adapters (tests/test_adapters.py ``adapters_for``):
    ranks 2, 4, 6, ... from seeds 10, 11, ..., built by ``module``'s
    ``random_adapter``."""
    return [module.random_adapter(f"ad{i}", embed, vocab, rank=2 + 2 * i, seed=10 + i)
            for i in range(n)]


def _pools(slots=4, rank=RANK, n=3):
    """A JAX and a port pool of ``slots`` slots holding the same ``n``
    adapters, acquired in the same order."""
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    jpool = jad.AdapterPool(slots, 64, 256, rank)
    pool = pad.AdapterPool(slots, 64, 256, rank, device="cpu")
    for jspec, spec in zip(_specs(jad, n), _specs(pad, n)):
        assert jpool.acquire(jspec) == pool.acquire(spec)
    return jpool, pool


# -- the delta, the specs and the pool ----------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("shape", [(5,), (3, 4)], ids=["decode", "verify"])
def test_lora_logits_delta_equals_jax_and_base_lanes_get_exact_zeros(shape):
    from gofr_tpu.ops.lora import lora_logits_delta as jax_delta
    from gofr_tpu_torch.ops.lora import lora_logits_delta

    jpool, pool = _pools()
    n = shape[0]
    sel = np.array([0, 1, 2, 3, 0][:n], np.int32)
    x = np.random.default_rng(0).standard_normal(shape + (64,)).astype(np.float32)
    want = np.asarray(jax_delta(jnp.asarray(x), (jnp.asarray(sel), jpool.a, jpool.b, jpool.scale)))
    got = lora_logits_delta(_t(x), (_t(sel).long(), pool.a, pool.b, pool.scale))
    assert got.shape == shape + (256,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=DELTA_TOL, rtol=DELTA_TOL)
    base = sel == 0
    assert (got.numpy()[base] == 0.0).all()
    assert np.abs(got.numpy()[~base]).max() > 0.1  # the adapters do move the logits


@pytest.mark.quick
@pytest.mark.parametrize("rank,seed", [(1, 0), (4, 3), (16, 12345)])
def test_random_adapter_draws_the_jax_arrays(rank, seed):
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    want = jad.random_adapter("x", 48, 96, rank=rank, seed=seed, scale=0.5, max_concurrency=2)
    got = pad.random_adapter("x", 48, 96, rank=rank, seed=seed, scale=0.5, max_concurrency=2)
    assert got.a.dtype == got.b.dtype == np.float32
    np.testing.assert_array_equal(got.a, want.a)
    np.testing.assert_array_equal(got.b, want.b)
    assert (got.rank, got.nbytes, got.scale, got.max_concurrency) == (
        want.rank, want.nbytes, want.scale, want.max_concurrency)


@pytest.mark.parametrize("pool_mb,embed,vocab,rank", [(1.0, 64, 256, 16), (0.01, 64, 256, 16),
                                                      (40.0, 4096, 128256, 16),
                                                      (256.0, 2048, 32000, 8)])
def test_slots_for_budget_equals_jax(pool_mb, embed, vocab, rank):
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    assert (pad.AdapterPool.slots_for_budget(pool_mb, embed, vocab, rank)
            == jad.AdapterPool.slots_for_budget(pool_mb, embed, vocab, rank))


def test_registry_register_get_unregister_digest_equal_jax():
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    regs = {}
    for mod in (jad, pad):
        reg = mod.AdapterRegistry()
        for spec in _specs(mod):
            reg.register(spec)
        assert reg.names() == ["ad0", "ad1", "ad2"]
        assert reg.get("ad1").rank == 4
        with pytest.raises(KeyError, match="unknown adapter"):
            reg.get("nope")
        regs[mod] = reg
    assert regs[pad].digest() == regs[jad].digest()
    assert regs[pad].stats() == regs[jad].stats()
    for reg in regs.values():
        reg.unregister("ad1")
    assert regs[pad].digest() == regs[jad].digest() != pad.AdapterRegistry().digest()
    assert regs[pad].names() == ["ad0", "ad2"]


def test_host_budget_never_evicts():
    from gofr_tpu_torch.adapters import AdapterRegistry, random_adapter

    reg = AdapterRegistry(host_budget_mb=0.01)  # 10 KiB
    reg.register(random_adapter("a", 64, 256, rank=4))  # 5 KiB
    with pytest.raises(ValueError, match="overflow"):
        reg.register(random_adapter("b", 64, 256, rank=8))
    assert reg.names() == ["a"]  # nothing was dropped to make room


def test_per_adapter_concurrency_cap_raises_the_port_s_429():
    from gofr_tpu_torch.adapters import AdapterRegistry, random_adapter
    from gofr_tpu_torch.http.errors import TooManyRequests

    reg = AdapterRegistry()
    reg.register(random_adapter("a", 64, 256, max_concurrency=2))
    reg.admit("a")
    reg.admit("a")
    with pytest.raises(TooManyRequests) as e:
        reg.admit("a")
    assert e.value.status_code == 429 and e.value.retry_after == 1.0
    reg.release("a")
    reg.admit("a")
    assert reg.stats()["inflight"] == {"a": 2}


def test_pool_is_refcounted_lru_as_jax_s():
    """The same acquire / release sequence gives the same slots, evictions
    and stats in both pools; a full pool returns None."""
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    ops = ["a0", "a1", "r1", "a2", "a0", "r2", "r0", "r0", "a1", "a2", "a3", "r1", "a3"]
    got = {}
    for mod in (jad, pad):
        specs = {f"a{i}": mod.random_adapter(f"s{i}", 8, 16, rank=2, seed=i) for i in range(4)}
        pool = (mod.AdapterPool(3, 8, 16, 4) if mod is jad
                else mod.AdapterPool(3, 8, 16, 4, device="cpu"))
        trace, held = [], {}
        for op in ops:
            if op[0] == "a":
                slot = pool.acquire(specs[op])
                trace.append(slot)
                if slot is not None:
                    held[op[1]] = slot
            else:
                pool.release(held[op[1]])
        got[mod] = (trace, pool.stats() | {"pool_bytes": 0})
    assert got[pad] == got[jad]
    assert None in got[pad][0] and got[pad][1]["evictions"] >= 1


def test_padded_uploads_equal_the_jax_pool_bit_for_bit():
    jpool, pool = _pools()
    np.testing.assert_array_equal(pool.a.numpy(), np.asarray(jpool.a))
    np.testing.assert_array_equal(pool.b.numpy(), np.asarray(jpool.b))
    np.testing.assert_array_equal(pool.scale.numpy(), np.asarray(jpool.scale))
    from gofr_tpu_torch.adapters import random_adapter

    assert (pool.a[0] == 0).all() and (pool.b[0] == 0).all() and pool.scale[0] == 0
    for slot in (1, 2, 3):  # ranks 2, 4, 6 in a pool of rank 8
        assert (pool.a[slot, :, 2 * slot:] == 0).all() and (pool.b[slot, 2 * slot:] == 0).all()
    pool.release(1)
    with pytest.raises(ValueError, match="exceeds the pool rank"):
        pool.acquire(random_adapter("big", 64, 256, rank=RANK + 1))


@pytest.mark.cuda
def test_an_upload_makes_no_host_sync_and_lands_bit_for_bit_on_the_card():
    """A rank-8 adapter into a rank-16 pool on the card, inside
    ``set_sync_debug_mode("error")``: the slot read back holds the spec's
    factors bit for bit in its first 8 columns of ``a`` and rows of ``b``,
    exact zeros past them, and the spec's scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.adapters import AdapterPool, random_adapter

    spec = random_adapter("ad", 4096, 32000, rank=8, scale=0.75, seed=3)
    pool = AdapterPool(3, 4096, 32000, 16, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slot = pool.acquire(spec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    a, b, scale = pool.a[slot].cpu(), pool.b[slot].cpu(), pool.scale.cpu()
    assert slot == 1
    np.testing.assert_array_equal(a[:, :8].numpy(), spec.a)
    np.testing.assert_array_equal(b[:8].numpy(), spec.b)
    assert (a[:, 8:] == 0).all() and (b[8:] == 0).all()
    assert scale.tolist() == [0.0, 0.75, 0.0]


# -- the model's entry points --------------------------------------------------------------


def _jax_cache(llama, jcfg, kv_layout, kv_quantize, rows):
    make = {("paged", ""): llama.make_paged_cache, ("paged", "int8"): llama.make_paged_cache_q,
            ("paged", "int4"): llama.make_paged_cache_q4, ("slot", ""): llama.make_cache,
            ("slot", "int8"): llama.make_cache_q}[kv_layout, kv_quantize]
    return make(jcfg, rows, PAGE if kv_layout == "paged" else 32)


@pytest.mark.quick
@pytest.mark.parametrize("kv_layout,kv_quantize", CACHES, ids=CACHE_IDS)
def test_entry_points_with_a_mixed_sel_equal_jax(tiny, kv_layout, kv_quantize):
    """Three lanes on adapters 2, base and 1: a whole-prompt prefill, a
    chunk of 3 at each lane's offset, a decode step and a verify forward of
    3 tokens, each with the adapters, give JAX's logits; the base lane's
    equal the same calls' without adapters exactly."""
    from gofr_tpu.models import llama
    from gofr_tpu_torch.gpu.engine import make_pool

    jcfg, params, model = tiny
    jpool, pool = _pools()
    sel = np.array([2, 0, 1], np.int32)
    jad = (jnp.asarray(sel), jpool.a, jpool.b, jpool.scale)
    ad = (_t(sel).long(), pool.a, pool.b, pool.scale)
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, 256, (3, 6)).astype(np.int32)
    lengths = np.array([6, 4, 5], np.int32)
    chunk = rng.integers(0, 256, (3, 3)).astype(np.int32)
    step = rng.integers(0, 256, (3,)).astype(np.int32)
    seq = rng.integers(0, 256, (3, 3)).astype(np.int32)
    if kv_layout == "paged":
        table = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]], np.int32)
        rows, jrows, jtab = table, jnp.asarray(table), (jnp.asarray(table),)
        jcache = _jax_cache(llama, jcfg, kv_layout, kv_quantize, 9)
        caches = [make_pool(model, kv_quantize, 9, PAGE) for _ in range(2)]
        prefill, decode, verify = llama.prefill_paged, llama.decode_step_paged, llama.verify_step_paged
    else:
        table = None
        rows, jrows, jtab = np.arange(3, dtype=np.int32), jnp.arange(3, dtype=jnp.int32), ()
        jcache = _jax_cache(llama, jcfg, kv_layout, kv_quantize, 3)
        caches = [make_pool(model, kv_quantize, 3, 32, "slot") for _ in range(2)]
        prefill, decode, verify = llama.prefill, llama.decode_step, llama.verify_step
    tab = None if table is None else _t(table)
    offsets = lengths.copy()
    calls = [
        ("prefill", lambda c: prefill(jcfg, params, jnp.asarray(prompts), jnp.asarray(lengths), c,
                                      jrows, adapters=jad),
         lambda c, a: model.prefill(_t(prompts), _t(lengths).long(), c, _t(rows), adapters=a)),
        ("chunk", lambda c: prefill(jcfg, params, jnp.asarray(chunk), jnp.full((3,), 3), c, jrows,
                                    jnp.asarray(offsets), adapters=jad),
         lambda c, a: model.prefill(_t(chunk), torch.full((3,), 3), c, _t(rows), _t(offsets),
                                    adapters=a)),
        ("decode", lambda c: decode(jcfg, params, jnp.asarray(step), jnp.asarray(offsets + 3), c,
                                    *jtab, adapters=jad),
         lambda c, a: model.decode_step(_t(step), _t(offsets + 3), c, tab, adapters=a)),
        ("verify", lambda c: verify(jcfg, params, jnp.asarray(seq), jnp.asarray(offsets + 4), c,
                                    *jtab, adapters=jad),
         lambda c, a: model.verify_step(_t(seq), _t(offsets + 4), c, tab, adapters=a)),
    ]
    for name, jcall, call in calls:
        want, jcache = jcall(jcache)
        got, _ = call(caches[0], ad)
        base, _ = call(caches[1], None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL,
                                   err_msg=name)
        assert torch.equal(got[1], base[1]), name
        assert not torch.allclose(got[0], base[0], atol=1e-3), name


# -- the engine -------------------------------------------------------------------------


def _jax_engine(tiny, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine

    jcfg, params, _ = tiny
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    return JaxEngine(llama, jcfg, params, new_mock_container(), decode_pipeline=1, **kw)


def _port_engine(tiny, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    # depth 1, as the JAX engine it is held against
    kw.setdefault("pipeline_depth", 1)
    return GenerateEngine(tiny[2], device="cpu", **kw)


def _serve(eng, module, jobs, warm=None, n_new=N_NEW):
    """Register ``module``'s adapters, serve ``warm`` = (prompt, adapter)
    alone, then ``jobs`` at once; returns the results in order."""
    if module is not None:
        for spec in _specs(module):
            eng.register_adapter(spec)
    first = [] if warm is None else [eng.generate(warm[0], max_new_tokens=n_new, timeout=300,
                                                  adapter_id=warm[1])]
    reqs = [eng.submit(p, max_new_tokens=n_new, adapter_id=a) for p, a in jobs]
    return first + [r.result(timeout=300) for r in reqs]


def _both(tiny, jobs, warm=None, **kw):
    """(JAX results, port results, the port engine's counters and spec
    totals, JAX's spec totals) of the same traffic; the port engine's pool
    audit passes after it."""
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    jeng = _jax_engine(tiny, **kw)
    try:
        want = _serve(jeng, jad, jobs, warm)
        want_totals = jeng.spec_accept_totals()
    finally:
        jeng.stop()
    eng = _port_engine(tiny, **kw)
    try:
        got = _serve(eng, pad, jobs, warm)
        eng.check_page_refs()
        stats = eng.adapter_stats()
        state = dict(eng.counters), eng.spec_accept_totals(), stats
    finally:
        eng.stop()
    return want, got, state, want_totals


def _mixed_jobs(prompts):
    names = [None, "ad0", "ad1", "ad2"]
    return [(p, names[i % 4]) for i, p in enumerate(prompts)]


@pytest.mark.parametrize("kv_layout,kv_quantize", CACHES, ids=CACHE_IDS)
def test_a_mixed_batch_equals_the_jax_engine_on_every_cache(tiny, kv_layout, kv_quantize):
    """Base and three adapters in turn, behind 4 slots and a pool of 4
    adapter slots: prompts chunk (past the 16 bucket); on the paged layout
    a warm request on adapter 0 leaves a two-page prefix that base and
    adapter requests hit, and a pool of 13 pages of 8 forces preemption.
    Greedy tokens equal the JAX engine's, and every adapter reference is
    gone at the end."""
    warm = (PREFIX + [77, 78, 79], "ad0")
    kw = dict(kv_layout=kv_layout, kv_quantize=kv_quantize, prefill_buckets=BUCKETS,
              adapter_slots=4, adapter_rank=RANK)
    if kv_layout == "paged":
        kw.update(page_size=PAGE, total_pages=13)
        prompts = [PREFIX + t for t in TAILS] + OTHERS
    else:
        prompts = [PREFIX + t for t in TAILS[:4]] + OTHERS
    jobs = _mixed_jobs(prompts)
    want, got, (counters, _, stats), _ = _both(tiny, jobs, warm, **kw)
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert all(o["finish_reason"] == "length" and len(o["tokens"]) == N_NEW for o in got)
    assert counters["prefill_chunks_at_offset"] >= 1
    assert stats["pool"]["referenced"] == 0 and stats["pool"]["resident"] == 3
    assert stats["registry"]["inflight"] == {}
    if kv_layout == "paged":
        assert counters["preemptions"] >= 1
        hits = [o["prefix_hit_tokens"] for o in got[1:]]
        # the pages ad0's warm request left serve base and adapter requests alike
        assert hits[0] >= 2 * PAGE and hits[1] >= 2 * PAGE


@pytest.mark.parametrize("kv_layout,draft", [("paged", False), ("slot", False), ("slot", True)],
                         ids=["paged_lookup", "slot_lookup", "slot_draft"])
def test_speculative_rounds_with_adapters_equal_the_jax_spec_engine(tiny, kv_layout, draft):
    """``spec_tokens=4`` with base and adapter lanes in one round (the
    verify takes the adapters, a draft model runs base weights): greedy
    tokens and the accept totals by adapter equal the JAX spec engine's,
    under chunked prompts, and on the paged layout prefix hits and forced
    preemption."""
    from gofr_tpu.models import llama

    jcfg, params, model = tiny
    warm = (PREFIX + [77, 78, 79], "ad1")
    kw = dict(kv_layout=kv_layout, prefill_buckets=BUCKETS, spec_tokens=G, adapter_slots=4,
              adapter_rank=RANK)
    if kv_layout == "paged":
        kw.update(page_size=PAGE, total_pages=20)
        prompts = [PREFIX + t for t in TAILS] + OTHERS
    else:
        prompts = [PREFIX + t for t in TAILS[:4]] + OTHERS
    jobs = _mixed_jobs(prompts)
    jkw, pkw = dict(kw), dict(kw)
    if draft:
        jkw["spec_draft"] = (llama, jcfg, params)
        pkw["spec_draft"] = (model.cfg, model)
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    jeng = _jax_engine(tiny, **jkw)
    try:
        want = [o["tokens"] for o in _serve(jeng, jad, jobs, warm, n_new=12)]
        want_totals = jeng.spec_accept_totals()
    finally:
        jeng.stop()
    eng = _port_engine(tiny, **pkw)
    try:
        got = _serve(eng, pad, jobs, warm, n_new=12)
        eng.check_page_refs()
        totals, counters = eng.spec_accept_totals(), dict(eng.counters)
    finally:
        eng.stop()
    assert [o["tokens"] for o in got] == want
    assert totals == want_totals and set(totals) == {"base", "ad0", "ad1", "ad2"}
    assert sum(v[1] for v in totals.values()) == counters["spec_proposed"]
    assert sum(v[0] for v in totals.values()) == counters["spec_accepted"]
    if kv_layout == "paged":
        assert counters["preemptions"] >= 1 and counters["prefix_hit_tokens"] >= 2 * PAGE


@pytest.mark.quick
@pytest.mark.parametrize("kw", [dict(kv_layout="slot"), dict(kv_layout="paged", page_size=8),
                                dict(kv_layout="slot", spec_tokens=2, decode_chunk=2),
                                dict(kv_layout="paged", page_size=8, spec_tokens=2,
                                     decode_chunk=2)],
                         ids=["slot", "paged", "slot-spec", "paged-spec"])
def test_base_requests_on_the_plane_equal_an_engine_without_it(tiny, kw):
    """``adapter_id=None`` through an engine with the plane, after an
    adapter request has run, gives the tokens of an engine without it (and
    of the JAX engine without it)."""
    import gofr_tpu_torch.adapters as pad

    plain = _port_engine(tiny, **kw)
    try:
        want = [plain.generate(p, max_new_tokens=8, timeout=300)["tokens"] for p in PROMPTS]
    finally:
        plain.stop()
    jeng = _jax_engine(tiny, **kw)
    try:
        jwant = [jeng.generate(p, max_new_tokens=8, timeout=300)["tokens"] for p in PROMPTS]
    finally:
        jeng.stop()
    eng = _port_engine(tiny, adapter_slots=3, adapter_rank=RANK, **kw)
    try:
        eng.register_adapter(_specs(pad, 1)[0])
        eng.generate(PROMPTS[0], max_new_tokens=4, timeout=300, adapter_id="ad0")
        got = [eng.generate(p, max_new_tokens=8, timeout=300, adapter_id=None)["tokens"]
               for p in PROMPTS]
    finally:
        eng.stop()
    assert got == want == jwant


@pytest.mark.parametrize("kv_layout", ["slot", "paged"])
def test_a_mixed_batch_equals_each_adapter_served_alone(tiny, kv_layout):
    """Three adapters co-batched: each request's tokens equal the same
    request on an engine holding only its adapter, and the adapters give
    different tokens on the same prompt."""
    import gofr_tpu_torch.adapters as pad

    specs = _specs(pad)
    jobs = [(p, specs[i % 3].name) for i, p in enumerate(PROMPTS * 2)]
    kw = dict(kv_layout=kv_layout, page_size=PAGE)
    alone = {}
    eng = _port_engine(tiny, adapter_slots=2, adapter_rank=RANK, **kw)
    try:
        for spec in specs:
            eng.register_adapter(spec)
            for p, name in jobs:
                if name == spec.name:
                    alone[tuple(p), name] = eng.generate(p, max_new_tokens=8, timeout=300,
                                                         adapter_id=name)["tokens"]
            eng.unregister_adapter(spec.name)
    finally:
        eng.stop()
    eng = _port_engine(tiny, adapter_slots=4, adapter_rank=RANK, **kw)
    try:
        got = _serve(eng, pad, jobs, n_new=8)
        eng.check_page_refs()
    finally:
        eng.stop()
    for (p, name), out in zip(jobs, got):
        assert out["tokens"] == alone[tuple(p), name], (p, name)
    first = {name: out["tokens"] for (p, name), out in zip(jobs, got) if p == PROMPTS[0]}
    assert len(set(map(tuple, first.values()))) > 1


def test_an_exhausted_adapter_pool_requeues_and_equals_jax(tiny):
    """A pool of 3 (the base and two adapters) behind 3 adapters and 9
    requests: the third adapter's requests wait for a slot, every request
    ends with "length", the pool evicts, and the tokens equal the JAX
    engine's."""
    jobs = [(PROMPTS[i % 4], f"ad{i % 3}") for i in range(9)]
    want, got, (_, _, stats), _ = _both(tiny, jobs, adapter_slots=3, adapter_rank=RANK,
                                        page_size=PAGE)
    assert [o["tokens"] for o in got] == [o["tokens"] for o in want]
    assert all(o["finish_reason"] == "length" for o in got)
    assert stats["pool"]["evictions"] >= 1 and stats["pool"]["referenced"] == 0


def test_page_refs_hold_after_adapter_churn(tiny):
    """Five adapters through a pool of 3 on a paged engine of 4 slots: the
    adapter pool churns while pages come and go; the page audit passes and
    no adapter reference is left."""
    import gofr_tpu_torch.adapters as pad

    specs = _specs(pad, 5)
    eng = _port_engine(tiny, adapter_slots=3, adapter_rank=12, page_size=PAGE)
    try:
        for spec in specs:
            eng.register_adapter(spec)
        reqs = [eng.submit(PROMPTS[i % 4], max_new_tokens=5, adapter_id=specs[i % 5].name)
                for i in range(15)]
        assert all(r.result(timeout=300)["finish_reason"] == "length" for r in reqs)
        stats = eng.adapter_stats()
        eng.check_page_refs()
        pool = eng.page_pool_stats()
    finally:
        eng.stop()
    assert stats["pool"]["evictions"] >= 1 and stats["pool"]["referenced"] == 0
    assert pool["slot_pages"] == 0


@pytest.mark.quick
def test_submit_refuses_unknown_adapters_a_missing_plane_and_a_full_cap(tiny):
    from gofr_tpu_torch.adapters import random_adapter
    from gofr_tpu_torch.http.errors import TooManyRequests

    eng = _port_engine(tiny, adapter_slots=2, adapter_rank=4)
    plain = _port_engine(tiny)
    try:
        with pytest.raises(ValueError, match="unknown adapter"):
            eng.generate(PROMPTS[0], max_new_tokens=4, adapter_id="nope")
        with pytest.raises(ValueError, match="adapter plane"):
            plain.generate(PROMPTS[0], max_new_tokens=4, adapter_id="x")
        with pytest.raises(RuntimeError, match="adapter plane"):
            plain.register_adapter(random_adapter("x", 64, 256))
        with pytest.raises(ValueError, match="rank"):
            eng.register_adapter(random_adapter("big", 64, 256, rank=8))
        eng.register_adapter(random_adapter("capped", 64, 256, rank=4, max_concurrency=1))
        first = eng.submit(PROMPTS[0], max_new_tokens=20, adapter_id="capped")
        with pytest.raises(TooManyRequests):
            eng.submit(PROMPTS[1], max_new_tokens=4, adapter_id="capped")
        assert first.result(timeout=300)["finish_reason"] == "length"
        # the share came back with the completion, whatever its outcome
        assert eng.generate(PROMPTS[1], max_new_tokens=4, timeout=300,
                            adapter_id="capped")["finish_reason"] == "length"
        assert eng.adapter_stats()["registry"]["inflight"] == {}
        assert plain.adapter_stats() == {"enabled": False, "weights_epoch": 0}
        assert plain.adapters_digest() == ""
    finally:
        eng.stop()
        plain.stop()


def test_adapter_pool_mb_derives_the_slots(tiny):
    per = 4 * (64 * 16 + 16 * 256)
    eng = _port_engine(tiny, adapter_pool_mb=per * 4 / (1 << 20))
    try:
        assert eng.adapter_stats()["pool"]["slots"] == 4
    finally:
        eng.stop()


@pytest.mark.parametrize("knobs", [
    dict(adapter_slots=1),
    dict(adapter_slots=-3),
    dict(adapter_slots=4, adapter_rank=0),
    dict(adapter_pool_mb=1.0, adapter_rank=-1),
])
def test_out_of_range_adapter_knobs_clamp_as_the_jax_engine(tiny, knobs):
    """Any non-zero slot count turns the plane on with at least 2 pool
    slots, and the rank is at least 1, the one derived from a pool budget
    too (engine.py:1465, 1491): the port's pool has the JAX engine's slots
    and rank for the same knobs, and serves."""
    jeng = _jax_engine(tiny, **knobs)
    try:
        want = jeng.adapter_stats()["pool"]
    finally:
        jeng.stop()
    eng = _port_engine(tiny, **knobs)
    try:
        got = eng.adapter_stats()["pool"]
        assert eng.generate(PROMPTS[0], max_new_tokens=2, timeout=300)["finish_reason"] == "length"
    finally:
        eng.stop()
    assert (got["slots"], got["rank"]) == (want["slots"], want["rank"])
    assert got["slots"] >= 2 and got["rank"] >= 1


def test_a_replaced_adapter_waits_for_its_lanes_and_a_vanished_one_fails(tiny):
    """Replacing an adapter a live lane references raises; once idle it is
    replaced and the next request uploads it anew. A request whose adapter
    is unregistered before its admission fails with ValueError."""
    from gofr_tpu_torch.adapters import random_adapter

    eng = _port_engine(tiny, adapter_slots=3, adapter_rank=4)
    try:
        eng.register_adapter(random_adapter("a", 64, 256, rank=4, seed=1))
        with eng._state_lock:  # hold admission while the lane is bound by hand
            req = eng.submit(PROMPTS[0], max_new_tokens=4, adapter_id="a")
            slot = eng._acquire_adapter(req)
            with pytest.raises(ValueError, match="in-flight"):
                eng.adapters.register(random_adapter("a", 64, 256, rank=4, seed=2),
                                      pool=eng._adapter_pool)
            eng._adapter_pool.release(slot[1])
        assert req.result(timeout=300)["finish_reason"] == "length"
        eng.register_adapter(random_adapter("a", 64, 256, rank=4, seed=2))
        with eng._state_lock:
            late = eng.submit(PROMPTS[1], max_new_tokens=4, adapter_id="a")
            eng.adapters.unregister("a", pool=eng._adapter_pool)
        with pytest.raises(ValueError, match="unknown adapter"):
            late.result(timeout=300)
        assert eng.adapter_stats()["pool"]["referenced"] == 0
    finally:
        eng.stop()
