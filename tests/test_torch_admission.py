"""The port's admission (gofr_tpu_torch.gpu.{planner,engine}) held against the
JAX engine: the EDF prefill planner, chunked prefill, pages on demand with
preemption by recompute, and the sync-free prompt writes of the pool.

Tolerances: the planner and the bucket ladder are exact (the same choices);
greedy engine tokens are exact, on the f32 tiny config, under chunking,
prefix hits and forced preemption; the pool's prompt writes are bit for bit
those of the boolean-mask writes they replace. Every engine test ends with
the pool audit ``check_page_refs``.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PAGE = 8
BUCKETS = [8, 16]
# a shared prefix of two pages and prompts that chunk (past 16 tokens)
PREFIX = [(7 * i + 3) % 256 for i in range(2 * PAGE)]
TAILS = [[11, 12, 13, 14], list(range(40, 61)), [5] * 9, list(range(90, 103)),
         [200, 17, 33], list(range(120, 138)), [1, 2], list(range(150, 165))]
OTHERS = [[9, 8, 7], list(range(60, 90)), [42] * 12]
N_NEW = 12


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def _serve(eng, warm, prompts):
    """One warm request served alone, then ``prompts`` at once."""
    first = eng.generate(warm, max_new_tokens=N_NEW, timeout=300)
    reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
    return [first] + [r.result(timeout=300) for r in reqs]


def _jax_tokens(tiny, warm, prompts, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine

    jcfg, params, _ = tiny
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, prefill_buckets=BUCKETS, **kw)
    try:
        return [o["tokens"] for o in _serve(jeng, warm, prompts)]
    finally:
        jeng.stop()


def _port_engine(tiny, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    return GenerateEngine(tiny[2], device="cpu", slots=4, max_len=64, max_prefill_batch=2,
                          prefill_buckets=BUCKETS, **kw)


# -- the planner -------------------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("seed", range(6))
def test_plan_prefill_equals_the_reference_planner(seed):
    from gofr_tpu.native import _plan_prefill_py
    from gofr_tpu_torch.gpu.planner import plan_prefill

    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(0, 12))
        buckets = sorted({int(b) for b in rng.integers(4, 300, size=int(rng.integers(1, 5)))})
        lens = rng.integers(1, 340, size=n).tolist()
        now = 1_000_000
        deadlines = [int(d) if rng.random() < 0.6 else 0
                     for d in rng.integers(now - 5_000, now + 5_000, size=n)]
        free, cap = int(rng.integers(0, 6)), int(rng.integers(0, 6))
        want = _plan_prefill_py(lens, deadlines, now, free, cap, buckets)
        got = plan_prefill(lens, deadlines, now, free, cap, buckets)
        assert (got.chosen, got.expired, got.len_bucket, got.batch_bucket) == (
            want.chosen, want.expired, want.len_bucket, want.batch_bucket)


def test_bucket_ladder_equals_the_engine_s():
    from gofr_tpu.tpu.engine import _pow2_buckets, next_bucket
    from gofr_tpu_torch.gpu import planner

    for lo, hi in ((16, 2048), (16, 64), (8, 100), (16, 16)):
        assert planner.pow2_buckets(lo, hi) == _pow2_buckets(lo, hi)
    ladder = _pow2_buckets(16, 100)
    for n in range(1, 101):
        assert planner.next_bucket(n, ladder) == next_bucket(n, ladder)
    with pytest.raises(ValueError, match="exceeds"):
        planner.next_bucket(101, ladder)


# -- the engine against the JAX engine ------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("kv_quantize", ["", "int8", "int4"], ids=["bf16", "int8", "int4"])
def test_greedy_tokens_equal_the_jax_engine_under_chunks_hits_and_preemption(tiny, kv_quantize):
    """A pool of 13 pages of 8 (one request can need 9) behind 4 slots:
    prompts of up to 34 tokens chunk in 16s, eight share a two-page prefix
    that a warm request leaves in the prefix cache, and the burst forces
    preemption."""
    warm = PREFIX + [77, 78, 79]
    prompts = [PREFIX + t for t in TAILS] + OTHERS
    want = _jax_tokens(tiny, warm, prompts, kv_layout="paged", page_size=PAGE, total_pages=13,
                       prefix_cache=True, kv_quantize=kv_quantize)
    eng = _port_engine(tiny, page_size=PAGE, total_pages=13, kv_quantize=kv_quantize)
    try:
        got = _serve(eng, warm, prompts)
        eng.check_page_refs()
        stats = eng.page_pool_stats()
    finally:
        eng.stop()
    assert [o["tokens"] for o in got] == want
    assert all(o["finish_reason"] == "length" and len(o["tokens"]) == N_NEW for o in got)
    assert eng.counters["preemptions"] >= 1
    assert eng.counters["prefix_hit_tokens"] >= 2 * PAGE
    assert eng.counters["prefill_chunks_at_offset"] >= 1
    assert sum(o["preemptions"] for o in got) == eng.counters["preemptions"]
    assert stats["slot_pages"] == 0 and stats["free_pages"] + stats["prefix_pages"] == 13


@pytest.mark.parametrize("kv_quantize", ["", "int8"], ids=["bf16", "int8"])
def test_greedy_tokens_equal_the_jax_engine_with_chunked_prompts_on_the_slot_layout(
        tiny, kv_quantize):
    warm = PREFIX + [77, 78, 79]
    prompts = [PREFIX + t for t in TAILS[:4]] + OTHERS
    want = _jax_tokens(tiny, warm, prompts, kv_layout="slot", kv_quantize=kv_quantize)
    eng = _port_engine(tiny, kv_layout="slot", kv_quantize=kv_quantize)
    try:
        got = _serve(eng, warm, prompts)
        eng.check_page_refs()
    finally:
        eng.stop()
    assert [o["tokens"] for o in got] == want
    assert eng.counters["prefill_chunks_at_offset"] >= 1
    assert eng.counters["preemptions"] == 0 and eng.page_pool_stats() is None


def test_preemption_keeps_greedy_tokens_and_frees_every_share(tiny):
    """The same burst on a pool just big enough for one request, and on the
    default pool (no pressure): the tokens agree, each request reports its
    preemptions, and the audit passes."""
    prompts = [PREFIX + t for t in TAILS[:5]]
    results = {}
    for pages in (9, None):
        eng = _port_engine(tiny, page_size=PAGE, total_pages=pages)
        try:
            reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in prompts]
            results[pages] = [r.result(timeout=300) for r in reqs]
            eng.check_page_refs()
        finally:
            eng.stop()
        if pages:
            assert eng.counters["preemptions"] >= 1
        else:
            assert eng.counters["preemptions"] == 0
    assert ([o["tokens"] for o in results[9]] == [o["tokens"] for o in results[None]])
    assert sum(o["preemptions"] for o in results[9]) >= 1


def test_a_chunked_prompt_beside_decoding_lanes_leaves_them_exact(tiny):
    """Decode keeps stepping while a long prompt prefills in chunks; the
    prefilling lane's row goes out OOB, so no decode write lands in its
    pages, and every request matches its run alone."""
    long_prompt = list(range(3, 60))
    short = [[5, 6, 7], [8, 9]]
    eng = _port_engine(tiny, page_size=PAGE, prefix_cache=False)
    try:
        alone = [eng.generate(p, max_new_tokens=N_NEW)["tokens"] for p in [long_prompt] + short]
        reqs = [eng.submit(p, max_new_tokens=N_NEW) for p in short + [long_prompt]]
        together = [r.result(timeout=300)["tokens"] for r in reqs]
        eng.check_page_refs()
    finally:
        eng.stop()
    assert together == alone[1:] + alone[:1]
    assert eng.counters["prefill_chunks"] >= 2 * 4  # 57 tokens in chunks of 16, twice


def test_expired_and_cancelled_requests_fail_and_release_their_pages(tiny):
    from gofr_tpu_torch.gpu.engine import RequestCancelled, RequestTimeout

    eng = _port_engine(tiny, page_size=PAGE, total_pages=9)
    try:
        hog = eng.submit(PREFIX + TAILS[1], max_new_tokens=20)
        late = eng.submit(PREFIX + TAILS[3], max_new_tokens=20, timeout=1e-4)
        gone = eng.submit(PREFIX + TAILS[5], max_new_tokens=20)
        gone.cancel()
        with pytest.raises(RequestTimeout):
            late.result(timeout=60)
        with pytest.raises(RequestCancelled):
            gone.result(timeout=60)
        assert hog.result(timeout=300)["finish_reason"] == "length"
        eng.check_page_refs()
    finally:
        eng.stop()


def test_the_audit_catches_a_leaked_share(tiny):
    eng = _port_engine(tiny, page_size=PAGE)
    try:
        eng.generate(PREFIX + [1, 2, 3], max_new_tokens=3)
        eng.check_page_refs()
        with eng._state_lock:
            eng._page_refs[eng._free_pages[0]] += 1
        with pytest.raises(AssertionError, match="refcounts"):
            eng.check_page_refs()
    finally:
        eng.stop()


# -- the sync-free prompt writes -----------------------------------------------------


def _mask_write(layer, pages, new, offsets):
    """The boolean-mask prompt write the pool used before: keep the rows
    whose page is a pool page and index-put them."""
    pool, page = layer.shape[0], layer.shape[2]
    b, s = new.shape[:2]
    pos = torch.arange(s)[None, :].expand(b, s) + offsets[:, None]
    logical = torch.clamp(pos // page, 0, pages.shape[1] - 1)
    pp = torch.gather(pages.long(), 1, logical)
    keep = pp < pool
    layer[pp[keep], :, (pos % page)[keep]] = new[keep].to(layer.dtype)


def _write_case(seed):
    """A pool of 6 pages of 4 and three rows of 7 positions at offsets 0, 3
    and 5: an OOB entry in a row's middle and at its end, and a dropped row
    whose clamped location (page 5, the last) a kept row writes."""
    rng = np.random.default_rng(seed)
    pages = torch.tensor([[2, 6, 0], [5, 1, 6], [6, 6, 6]], dtype=torch.int32)
    offsets = torch.tensor([0, 3, 5])
    new = torch.from_numpy(rng.standard_normal((3, 7, 2, 8)).astype(np.float32))
    return pages, offsets, new


@pytest.mark.quick
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pool_prompt_writes_equal_the_boolean_mask_writes_bit_for_bit(fmt, seed):
    from gofr_tpu_torch.ops import paged
    from gofr_tpu_torch.ops.kvcache import quantize_row
    from gofr_tpu_torch.ops.quant import pack_int4, quantize_row_int4

    pages, offsets, new = _write_case(seed)
    for offs in (offsets, None):
        mask_offs = offsets if offs is not None else torch.zeros(3, dtype=torch.long)
        if fmt == "bf16":
            base = torch.randn(6, 2, 4, 8).to(torch.bfloat16)
            got_k, got_v, want_k, want_v = (base.clone() for _ in range(4))
            paged.write_prompts_paged(got_k, got_v, pages, new, -new, offs)
            _mask_write(want_k, pages, new, mask_offs)
            _mask_write(want_v, pages, -new, mask_offs)
            pairs = ((got_k, want_k), (got_v, want_v))
        else:
            width, dtype = (8, torch.int8) if fmt == "int8" else (4, torch.uint8)
            values = torch.randint(0, 100, (6, 2, 4, width)).to(dtype)
            scales = torch.randn(6, 2, 4).to(torch.bfloat16)
            got_q, got_s, want_q, want_s = values.clone(), scales.clone(), values.clone(), scales.clone()
            write = paged.write_prompts_paged_q if fmt == "int8" else paged.write_prompts_paged_q4
            write(got_q, got_s, pages, new, offs)
            if fmt == "int8":
                q, sc = quantize_row(new)
            else:
                q, sc = quantize_row_int4(new)
                q = pack_int4(q)
            _mask_write(want_q, pages, q, mask_offs)
            _mask_write(want_s, pages, sc, mask_offs)
            pairs = ((got_q, want_q), (got_s, want_s))
        for got, want in pairs:
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        assert not torch.equal(pairs[0][0], base if fmt == "bf16" else values)


@pytest.mark.cuda
def test_pool_prompt_writes_make_no_host_sync_on_the_card():
    """The three formats' prompt writes, with OOB rows and offsets, inside
    ``set_sync_debug_mode("error")`` on the card, and equal there to the
    same writes on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops import paged

    pages, offsets, new = _write_case(0)
    dev = [t.cuda() for t in (pages, offsets, new)]
    pools = {"bf16": lambda: (torch.zeros(6, 2, 4, 8, dtype=torch.bfloat16),) * 2,
             "int8": lambda: (torch.zeros(6, 2, 4, 8, dtype=torch.int8),
                              torch.zeros(6, 2, 4, dtype=torch.bfloat16)),
             "int4": lambda: (torch.zeros(6, 2, 4, 4, dtype=torch.uint8),
                              torch.zeros(6, 2, 4, dtype=torch.bfloat16))}
    writes = {"bf16": lambda a, b, p, x, o: paged.write_prompts_paged(a, b, p, x, -x, o),
              "int8": paged.write_prompts_paged_q, "int4": paged.write_prompts_paged_q4}
    for fmt, make in pools.items():
        cpu = [t.clone() for t in make()]
        card = [t.clone().cuda() for t in cpu]
        writes[fmt](*cpu, pages, new, offsets)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            writes[fmt](*card, *dev[:1], dev[2], dev[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for a, b in zip(cpu, card):
            assert torch.equal(a.view(torch.uint8), b.cpu().view(torch.uint8)), fmt
