"""The prefix cache's host tier on the port (gofr_tpu_torch.gpu.prefix,
``ops.paged.gather_page`` / ``swap_in_pages``, the spills and swap-ins of
gpu/{engine,executor}.py) held against the JAX package
(gofr_tpu/tpu/prefix.py:140-470, ops/paged.py:593-617,
tests/test_prefix_host.py).

Exact throughout: the cache's choices (pages retained, chains and their
tiers, pages spilled, host pages dropped, bytes held) equal the JAX
cache's on the same seeded sequence of operations; a page gathered and
swapped back is bit for bit the JAX functions' on the bf16, int8 and int4
pools; greedy tokens after a spill and a swap-in equal the JAX engine's
with its host tier on, and the port's own with the cache off. Engine tests
end with the pool audit ``check_page_refs``, which covers both tiers.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PAGE = 8


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


# -- the cache ------------------------------------------------------------------------


def _chain(cache, toks):
    return [(k, n.page_id, n.pending) for k, n in cache.lookup_tiered(toks)]


@pytest.mark.quick
@pytest.mark.parametrize("seed", range(4))
def test_tiered_cache_operations_equal_the_jax_cache(seed):
    """One seeded sequence of insert, tiered lookup, spill and commit,
    eviction, promote, settle, host insert and clear on both caches under a
    budget of a few pages: the same returns, chains (keys, tiers, pending),
    sizes and bytes after every step."""
    from gofr_tpu.tpu.prefix import PrefixCache as RefCache
    from gofr_tpu_torch.gpu.prefix import PrefixCache

    rng = np.random.default_rng(seed)
    page, nbytes = 4, 100
    stems = [rng.integers(0, 50, size=int(rng.integers(1, 4)) * page) for _ in range(4)]
    ref, port = RefCache(page, host_budget_bytes=5 * nbytes), PrefixCache(page, 5 * nbytes)
    next_page, promoted = 0, []
    for step in range(400):
        toks = np.concatenate([stems[int(rng.integers(0, 4))],
                               rng.integers(0, 3, size=int(rng.integers(0, 3 * page)))])
        op = rng.choice(["insert", "lookup", "spill", "evict", "promote", "settle", "host"],
                        p=[0.3, 0.2, 0.2, 0.05, 0.1, 0.1, 0.05])
        if op == "insert":
            n = len(toks) // page
            pages = list(range(next_page, next_page + n))
            next_page += n
            assert port.insert(toks.astype(np.int64), pages) == ref.insert(toks, pages)
        elif op == "lookup":
            assert _chain(port, toks.astype(np.int64)) == _chain(ref, toks)
        elif op == "spill":
            picked = port.spill_lru()
            assert picked == ref.spill_lru()
            if picked is not None:
                payload = (f"page {picked[1]}",)
                assert port.commit_spill(picked[0], payload, nbytes) == ref.commit_spill(
                    picked[0], payload, nbytes)
        elif op == "evict":
            assert port.evict_lru() == ref.evict_lru()
        elif op == "promote":
            host = [k for k, n, _ in _chain(ref, toks) if n < 0]
            _chain(port, toks.astype(np.int64))
            if host:
                port.promote(host[0], next_page)
                ref.promote(host[0], next_page)
                promoted.append(host[0])
                next_page += 1
        elif op == "settle" and promoted:
            key = promoted.pop(0)
            port.settle(key)
            ref.settle(key)
        elif op == "host":
            payloads = [(f"import {step}.{i}",) for i in range(len(toks) // page)]
            assert port.insert_host(toks.astype(np.int64), payloads, nbytes) == ref.insert_host(
                toks, payloads, nbytes)
        assert (len(port), port.host_pages, port.host_bytes) == (
            len(ref), ref.host_pages, ref.host_bytes)
        assert sorted(port.pages()) == sorted(n.page_id for n in ref._nodes.values()
                                              if n.page_id >= 0)
    assert sorted(port.clear()) == sorted(ref.clear())
    assert (len(port), port.host_pages, port.host_bytes) == (0, 0, 0)


@pytest.mark.quick
def test_the_jax_unit_scenarios_hold_on_the_port():
    """tests/test_prefix_host.py:30-112 on the port's cache: a spill then a
    tiered lookup then a promote (pending until settled), the budget
    dropping LRU host leaves, a budget below one page, an insert promoting
    a host node for free, int32 and int64 keys alike, and clear."""
    from gofr_tpu_torch.gpu.prefix import PrefixCache

    c = PrefixCache(4, host_budget_bytes=1 << 20)
    toks = np.arange(8)
    c.insert(toks, [1, 2])
    key2, p2 = c.spill_lru()
    assert p2 == 2 and c.commit_spill(key2, ("payload2",), 100) == 0
    assert (len(c), c.host_pages, c.host_bytes) == (1, 1, 100)
    assert c.lookup(toks) == [1] and [n.page_id for _, n in c.lookup_tiered(toks)] == [1, -1]
    key1, p1 = c.spill_lru()
    assert p1 == 1
    c.commit_spill(key1, ("payload1",), 100)
    c.promote(key2, 7)
    assert [n.page_id for _, n in c.lookup_tiered(toks)] == [-1, 7]
    assert c.spill_lru() is None  # pending until settled
    c.settle(key2)
    assert c.spill_lru()[1] == 7

    c = PrefixCache(4, host_budget_bytes=200)
    for v in (1, 2, 3):
        c.insert(np.full(4, v), [v])
    dropped = 0
    for want in (1, 2, 3):
        key, p = c.spill_lru()
        assert p == want
        dropped += c.commit_spill(key, (f"pl{want}",), 100)
    assert dropped == 1 and (c.host_pages, c.host_bytes) == (2, 200)
    assert c.lookup_tiered(np.full(4, 1)) == []

    c = PrefixCache(4, host_budget_bytes=50)
    c.insert(np.arange(4), [9])
    key, _ = c.spill_lru()
    assert c.commit_spill(key, ("x",), 100) == 1 and (len(c), c.host_pages) == (0, 0)

    c = PrefixCache(4, host_budget_bytes=1 << 20)
    c.insert(np.arange(4), [1])
    key, _ = c.spill_lru()
    c.commit_spill(key, ("pl",), 100)
    assert c.insert(np.arange(4), [5]) == [5] and c.lookup(np.arange(4)) == [5]
    assert (c.host_pages, c.host_bytes) == (0, 0)
    assert c.lookup(np.arange(4, dtype=np.int32)) == [5]
    key, _ = c.spill_lru()
    c.commit_spill(key, ("pl",), 100)
    c.insert(np.arange(8, 16), [3, 4])
    assert sorted(c.clear()) == [3, 4] and (len(c), c.host_pages, c.host_bytes) == (0, 0, 0)


# -- the page moves -------------------------------------------------------------------


def _pools(kind):
    """A random pool of each format, the port's and the JAX one, equal."""
    from gofr_tpu.ops import paged as ref
    from gofr_tpu_torch.ops import paged

    rng = np.random.default_rng(5)
    L, P, H, S, D = 2, 6, 2, PAGE, 16
    if kind == "bf16":
        planes = [rng.standard_normal((L, P, H, S, D)).astype(np.float32) for _ in range(2)]
        jpool = ref.PagedKVCache(*(jnp.asarray(p, jnp.bfloat16) for p in planes))
        pool = paged.PagedKVCache(*(torch.from_numpy(p).to(torch.bfloat16) for p in planes))
        return jpool, pool
    width, vals = (D, np.int8) if kind == "int8" else (D // 2, np.uint8)
    lo, hi = (-127, 128) if kind == "int8" else (0, 256)
    q = [rng.integers(lo, hi, size=(L, P, H, S, width)).astype(vals) for _ in range(2)]
    sc = [rng.standard_normal((L, P, H, S)).astype(np.float32) for _ in range(2)]
    jcls = ref.QPagedKVCache if kind == "int8" else ref.Q4PagedKVCache
    cls = paged.QPagedKVCache if kind == "int8" else paged.Q4PagedKVCache
    jpool = jcls(*(jnp.asarray(x) for x in q), *(jnp.asarray(s, jnp.bfloat16) for s in sc))
    pool = cls(*(torch.from_numpy(x) for x in q), *(torch.from_numpy(s).to(torch.bfloat16)
                                                    for s in sc))
    return jpool, pool


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _to_jax(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_gather_page_and_swap_in_pages_are_bit_exact_against_jax(kind):
    """Every plane of a page out (``gather_page``), and pages back in with
    the padded upload the JAX engine ships (ids padded with P, which drops,
    and a repeated drop target), on each pool format: bit for bit the JAX
    functions' results, values and scales."""
    from gofr_tpu.ops import paged as ref
    from gofr_tpu_torch.ops import paged

    jpool, pool = _pools(kind)
    for p in (0, 3, 5):
        got = paged.gather_page(pool, p)
        want = jax.tree.leaves(ref.gather_page(jpool, jnp.int32(p)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(_bits(g), _jbits(w))
    # payload: pages 1 and 4 of a second pool, into pages 5, 0 and past the pool
    jsrc, src = _pools(kind)
    src_planes = [torch.flip(t, dims=[1]).contiguous() for t in paged.page_planes(src)]
    ids = np.array([5, 0, 6, 6], np.int32)
    payload = [t[:, :4] for t in src_planes]
    jpayload = jax.tree.unflatten(jax.tree.structure(jpool), [_to_jax(t) for t in payload])
    want, _ = ref.swap_in_pages(jpool, jnp.asarray(ids), jpayload)
    paged.swap_in_pages(pool, torch.from_numpy(ids.astype(np.int64)), payload)
    for g, w in zip(paged.page_planes(pool), jax.tree.leaves(want)):
        assert np.array_equal(_bits(g), _jbits(w))


# -- the engine -----------------------------------------------------------------------


def _pressure(r):
    return [(r * 37 + 13 * i) % 180 + 2 for i in range(18)]


PROMPT = [(11 * i) % 190 + 1 for i in range(20)]  # two full pages of 8


def _port(tiny, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    kw.setdefault("prefix_host_mb", 8.0)
    return GenerateEngine(tiny[2], device="cpu", slots=4, max_len=64, max_prefill_batch=2,
                          page_size=PAGE, total_pages=12, **kw)


def _jax(tiny, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine

    jcfg, params, _ = tiny
    kw.setdefault("prefix_host_mb", 8.0)
    return JaxEngine(llama, jcfg, params, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, kv_layout="paged", page_size=PAGE, total_pages=12, **kw)


def _spill_then_hit(eng):
    """The prompt cold, five distinct prompts whose pressure spills its
    pages, then the prompt again: its tokens each time."""
    out = [eng.generate(PROMPT, max_new_tokens=6, timeout=300)["tokens"]]
    out += [eng.generate(_pressure(r), max_new_tokens=4, timeout=300)["tokens"]
            for r in range(5)]
    warm = eng.generate(PROMPT, max_new_tokens=6, timeout=300)
    return out + [warm["tokens"]], warm


def _tier_total(jeng, name, tier):
    m = jeng.metrics.get(name)
    return sum(v for ls, v in m._values.items() if dict(ls).get("tier", "") == tier) if m else 0


@pytest.mark.quick
@pytest.mark.parametrize("kv_quantize", ["", "int8", "int4"], ids=["bf16", "int8", "int4"])
def test_a_spill_then_a_swap_in_is_token_exact_against_the_jax_engine(tiny, kv_quantize):
    """Pool pressure spills the prompt's two pages to the host tier; the
    prompt again swaps them back in: tokens equal the JAX engine's with its
    host tier on, and the port's with the cache off; both pages are served
    from the host tier, as many pages spilled and swapped as the JAX
    engine's, and the host tier's bytes are whole pages."""
    jeng = _jax(tiny, kv_quantize=kv_quantize)
    try:
        want, _ = _spill_then_hit(jeng)
        jhost = _tier_total(jeng, "app_tpu_prefix_hit_tokens", "host")
        jswapped = sum(jeng.metrics.get("app_tpu_prefix_swapin_pages_total")._values.values())
        jhost_pages = jeng._prefix.host_pages
    finally:
        jeng.stop()
    off = _port(tiny, kv_quantize=kv_quantize, prefix_cache=False)
    try:
        cold, _ = _spill_then_hit(off)
    finally:
        off.stop()
    eng = _port(tiny, kv_quantize=kv_quantize)
    try:
        got, warm = _spill_then_hit(eng)
        eng.check_page_refs()
        c, host_pages = dict(eng.counters), eng._prefix.host_pages
        host_bytes, page_bytes = eng._prefix.host_bytes, eng._page_bytes
    finally:
        eng.stop()
    assert got == want == cold
    assert warm["prefix_host_tokens"] == c["prefix_host_hit_tokens"] == jhost == 2 * PAGE
    assert c["prefix_swapin_pages"] == jswapped == 2
    assert c["prefix_swapin_bytes"] == 2 * page_bytes
    assert host_pages == jhost_pages and host_bytes == host_pages * page_bytes
    assert c["prefix_spilled_pages"] >= 2


def test_a_zero_host_budget_is_the_single_tier_cache(tiny):
    """``prefix_host_mb=0`` (the default): pressure evicts, nothing is
    spilled or swapped, and the tokens equal the JAX engine's without the
    tier."""
    jeng = _jax(tiny, prefix_host_mb=0.0)
    try:
        want, _ = _spill_then_hit(jeng)
    finally:
        jeng.stop()
    eng = _port(tiny, prefix_host_mb=0.0)
    try:
        got, warm = _spill_then_hit(eng)
        eng.check_page_refs()
    finally:
        eng.stop()
    assert got == want
    assert eng._prefix.host_budget == 0 and eng._prefix.host_pages == 0
    assert eng.counters["prefix_evicted_pages"] > 0 and eng.counters["prefix_spilled_pages"] == 0
    assert eng.counters["prefix_swapin_pages"] == 0 and warm["prefix_host_tokens"] == 0


def test_a_budget_below_one_page_leaves_the_tier_off(tiny):
    eng = _port(tiny, prefix_host_mb=1e-4)
    try:
        assert eng._prefix.host_budget == 0
    finally:
        eng.stop()


def test_concurrent_slots_share_a_chain_in_the_middle_of_a_swap_in(tiny):
    """One spilled chain feeds six concurrent prompts
    (test_prefix_host.py:228): the first hit swaps the pages in, the others
    share them; tokens equal the port's with the cache off, and the pool
    and both tiers audit clean."""
    shared = [(5 * i) % 120 + 1 for i in range(16)]
    prompts = [shared + [i + 1, 2 * i + 1, (3 * i) % 90 + 1] for i in range(6)]
    off = _port(tiny, prefix_cache=False)
    try:
        want = [off.generate(p, max_new_tokens=5, timeout=300)["tokens"] for p in prompts]
    finally:
        off.stop()
    eng = _port(tiny)
    results = [None] * len(prompts)

    def worker(i):
        results[i] = eng.generate(prompts[i], max_new_tokens=5, timeout=300)

    try:
        eng.generate(shared + [7], max_new_tokens=1, timeout=300)
        for r in range(5):
            eng.generate(_pressure(r), max_new_tokens=4, timeout=300)
        assert eng._prefix.host_pages > 0
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert [r["tokens"] for r in results] == want
        assert eng.counters["prefix_host_hit_tokens"] >= 2 * PAGE
        eng.check_page_refs()
        assert eng.page_pool_stats()["slot_pages"] == 0
    finally:
        eng.stop()


def test_a_cancel_racing_an_in_flight_swap_in_leaves_the_pool_consistent(tiny):
    """A request cancelled as it is submitted races its swap-in's dispatch
    and fold (test_prefix_host.py:262): whichever wins, the pool and tiers
    audit clean and the prompt served next is exact."""
    off = _port(tiny, prefix_cache=False)
    try:
        want = off.generate(PROMPT, max_new_tokens=6, timeout=300)["tokens"]
    finally:
        off.stop()
    eng = _port(tiny)
    try:
        eng.generate(PROMPT, max_new_tokens=4, timeout=300)
        for r in range(5):
            eng.generate(_pressure(r), max_new_tokens=4, timeout=300)
        assert eng._prefix.host_pages > 0
        req = eng.submit(PROMPT, max_new_tokens=6)
        req.cancel()
        try:
            req.result(300)
        except RuntimeError:
            pass  # cancelled in time: a RequestCancelled
        assert eng.generate(PROMPT, max_new_tokens=6, timeout=300)["tokens"] == want
        eng.check_page_refs()
        assert eng.page_pool_stats()["slot_pages"] == 0
    finally:
        eng.stop()


@pytest.mark.quick
def test_the_host_tier_knob_is_plumbed_through_build_engine():
    """``ENGINE_PREFIX_HOST_MB`` reaches the cache's budget in bytes, as
    the JAX ``build_engine`` puts it (test_prefix_host.py:297), and the
    keyword wins over it."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    spec = ModelSpec("llama", LlamaConfig.tiny(), dtype=torch.float32)
    for kw, want in (({}, 2 << 20), ({"prefix_host_mb": 3.0}, 3 << 20)):
        eng = build_engine(spec, new_mock_container({"ENGINE_PREFIX_HOST_MB": "2"}),
                           device="cpu", slots=2, max_len=32, page_size=8, **kw)
        try:
            assert eng._prefix.host_budget == want
        finally:
            eng.stop()
