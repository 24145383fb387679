"""The port's prefix cache, device tier (gofr_tpu_torch.gpu.prefix and its
use in gpu/engine.py), held against gofr_tpu/tpu/prefix.py and the JAX
engine.

Exact throughout: chain keys are digests, the cache's choices (pages
retained, hit chains, the LRU page evicted) are the reference's on the same
seeded sequence of operations, and greedy tokens equal the JAX engine's and
the port's own run without the cache. Engine tests end with the pool audit
``check_page_refs``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PAGE = 8
SYSTEM = [(5 * i + 1) % 256 for i in range(3 * PAGE)]


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(3))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


@pytest.mark.quick
@pytest.mark.parametrize("seed", range(3))
def test_chain_keys_equal_the_jax_package(seed):
    from gofr_tpu.tpu import prefix as ref
    from gofr_tpu_torch.gpu import prefix

    rng = np.random.default_rng(seed)
    for page in (1, 4, 16, 128):
        toks = rng.integers(0, 128256, size=int(rng.integers(0, 5 * page))).tolist()
        want = ref.chain_keys(np.asarray(toks, np.int32), page)
        # the port's prompts are int64 (lists, arrays, tensors): cast, not reinterpreted
        for given in (toks, np.asarray(toks, np.int64), torch.tensor(toks, dtype=torch.long)):
            assert prefix.chain_keys(given, page) == want
    assert prefix.chain_key(12345, b"\x01\x02") == ref.chain_key(12345, b"\x01\x02")


@pytest.mark.parametrize("seed", range(4))
def test_prefix_cache_operations_equal_the_jax_cache(seed):
    """One seeded sequence of insert / lookup / evict_lru on both caches
    (the JAX one with its host tier off): the same pages retained, the same
    hits and keys, the same page evicted, the same size."""
    from gofr_tpu.tpu.prefix import PrefixCache as RefCache
    from gofr_tpu_torch.gpu.prefix import PrefixCache

    rng = np.random.default_rng(seed)
    page = 4
    stems = [rng.integers(0, 50, size=int(rng.integers(1, 4)) * page) for _ in range(4)]
    ref, port = RefCache(page), PrefixCache(page)
    next_page = 0
    for _ in range(300):
        toks = np.concatenate([stems[int(rng.integers(0, 4))],
                               rng.integers(0, 3, size=int(rng.integers(0, 3 * page)))])
        op = rng.choice(["insert", "lookup", "evict"], p=[0.45, 0.35, 0.2])
        if op == "insert":
            n = len(toks) // page
            pages = list(range(next_page, next_page + n))
            next_page += n
            assert port.insert(toks.astype(np.int64), pages) == ref.insert(toks, pages)
        elif op == "lookup" and rng.random() < 0.5:
            chain, want = port.lookup_tiered(toks.astype(np.int64)), ref.lookup_tiered(toks)
            assert [k for k, _ in chain] == [k for k, _ in want]
            assert [n.page_id for _, n in chain] == [n.page_id for _, n in want]
        elif op == "lookup":
            assert port.lookup(toks.astype(np.int64)) == ref.lookup(toks)
        else:
            assert port.evict_lru() == ref.evict_lru()
        assert len(port) == len(ref)
        assert sorted(port.pages()) == sorted(n.page_id for n in ref._nodes.values())
    assert sorted(port.clear()) == sorted(ref.clear()) and len(port) == 0


def _engine(tiny, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    return GenerateEngine(tiny[2], device="cpu", slots=4, max_len=64, max_prefill_batch=2,
                          page_size=PAGE, prefill_buckets=[8, 16, 32], **kw)


PROMPTS = [SYSTEM + [1, 2, 3], SYSTEM + list(range(30, 40)), SYSTEM + [9] * 6, SYSTEM[:20]]


@pytest.mark.quick
def test_a_shared_prompt_is_prefilled_once_and_tokens_equal_the_jax_engine(tiny):
    """The first request leaves its three full prompt pages in the cache;
    each later one (served one at a time) starts with them in its table
    (a hit capped below its length) and prefills only its tail on the
    chunked path. Tokens equal the JAX engine's and the port's without the
    cache."""
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine

    jcfg, params, _ = tiny
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, kv_layout="paged", page_size=PAGE,
                     prefill_buckets=[8, 16, 32], prefix_cache=True)
    try:
        want = [jeng.generate(p, max_new_tokens=8)["tokens"] for p in PROMPTS]
    finally:
        jeng.stop()
    runs = {}
    for cached in (True, False):
        eng = _engine(tiny, prefix_cache=cached)
        try:
            runs[cached] = [eng.generate(p, max_new_tokens=8) for p in PROMPTS]
            eng.check_page_refs()
            stats = eng.page_pool_stats()
        finally:
            eng.stop()
        if cached:
            assert eng.counters["prefix_hit_tokens"] == 3 * 3 * PAGE - PAGE
            assert eng.counters["prefix_lookups"] == len(PROMPTS)
            assert stats["prefix_pages"] == 4  # the system prompt's 3 pages and one tail page
        else:
            assert eng.counters["prefix_hit_tokens"] == 0 and stats["prefix_pages"] == 0
    assert [o["tokens"] for o in runs[True]] == want == [o["tokens"] for o in runs[False]]
    # the first request misses; the 2nd and 3rd hit 3 pages, the 4th (20
    # tokens) 2, capped at (20 - 1) // 8
    assert [o["prefix_hit_tokens"] for o in runs[True]] == [0, 24, 24, 16]


def test_pool_pressure_evicts_lru_leaves_before_it_preempts(tiny):
    """Distinct prompts through a pool that cannot keep them all cached: the
    cache gives up its least-recently-used leaves (pages no slot holds), no
    request is preempted, tokens match the run without the cache, and the
    audit passes after every request."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, size=int(n)).tolist() for n in rng.integers(17, 40, size=8)]
    runs = {}
    for cached in (True, False):
        eng = _engine(tiny, prefix_cache=cached, total_pages=12)
        try:
            runs[cached] = []
            for p in prompts:
                runs[cached].append(eng.generate(p, max_new_tokens=6)["tokens"])
                eng.check_page_refs()
        finally:
            eng.stop()
        assert eng.counters["preemptions"] == 0
        if cached:
            assert eng.counters["prefix_evicted_pages"] >= 1
    assert runs[True] == runs[False]


def test_the_cache_holds_no_page_on_the_slot_layout(tiny):
    eng = _engine(tiny, kv_layout="slot")
    try:
        out = eng.generate(PROMPTS[0], max_new_tokens=4)
        assert out["prefix_hit_tokens"] == 0 and eng.page_pool_stats() is None
        eng.check_page_refs()
    finally:
        eng.stop()
