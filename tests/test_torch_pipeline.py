"""The port's in-flight queue (gofr_tpu_torch.gpu.{executor,decode,engine})
held against the JAX engine at its default pipeline depth 2
(gofr_tpu/tpu/{executor,decode,engine}.py, tests/test_async_pipeline.py,
tests/test_spec_pipeline.py).

Tolerances: greedy tokens are exact, against the JAX engine at depth 2 on
all five caches, with and without speculation, under chunked prompts,
prefix hits and forced preemption; speculative accept totals are exact
against the JAX engine's at depth 2 (the two loops make the same
dispatches and folds in the same order). The queue's behaviour is held by
recording dispatches and folds: a decode chunk goes out while an older
prefill or chunk is in flight, the queue never holds more than the depth,
depth 1 folds every call before the next phase. Every paged engine test
ends with the pool audit ``check_page_refs``.
"""

import collections
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PAGE = 8
BUCKETS = [8, 16]
N_NEW = 12
G = 4
# prompts that chunk (past 16), share a two-page prefix, or neither
PREFIX = [(7 * i + 3) % 256 for i in range(2 * PAGE)]
TAILS = [[11, 12, 13, 14], list(range(40, 61)), [5] * 9, list(range(90, 103)),
         [200, 17, 33], list(range(120, 138)), [1, 2], list(range(150, 165))]
OTHERS = [[9, 8, 7], list(range(60, 90)), [42] * 12]
CACHES = [("paged", ""), ("paged", "int8"), ("paged", "int4"), ("slot", ""), ("slot", "int8")]
CACHE_IDS = ["bf16", "int8", "int4", "slot_bf16", "slot_int8"]


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def _serve(eng, warm, prompts, n_new=N_NEW):
    """One warm request served alone, then ``prompts`` at once."""
    first = eng.generate(warm, max_new_tokens=n_new, timeout=300)
    reqs = [eng.submit(p, max_new_tokens=n_new) for p in prompts]
    return [first] + [r.result(timeout=300) for r in reqs]


def _jax_engine(tiny, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine

    jcfg, params, _ = tiny
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    return JaxEngine(llama, jcfg, params, new_mock_container(), decode_pipeline=2, **kw)


def _port_engine(tiny, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    return GenerateEngine(tiny[2], device="cpu", **kw)


def _jax_serve(tiny, warm, prompts, **kw):
    """(tokens, accept totals, over-claimed pages given back) of the JAX
    engine at depth 2."""
    jeng = _jax_engine(tiny, **kw)
    try:
        tokens = [o["tokens"] for o in _serve(jeng, warm, prompts)]
        trimmed = jeng.metrics.get("app_tpu_spec_pages_trimmed_total")
        return (tokens, jeng.spec_accept_totals(),
                sum(trimmed._values.values()) if trimmed is not None else 0)
    finally:
        jeng.stop()


def _cache_kw(kv_layout, kv_quantize, total_pages):
    """The engine knobs and the burst of one cache: on the pool a small
    pool that preempts and the prefix-sharing prompts, on the slot cache
    fewer prompts (no prefix cache there)."""
    kw = dict(kv_layout=kv_layout, kv_quantize=kv_quantize, prefill_buckets=BUCKETS)
    prompts = [PREFIX + t for t in TAILS] + OTHERS
    if kv_layout == "paged":
        kw.update(page_size=PAGE, total_pages=total_pages)
    else:
        prompts = [PREFIX + t for t in TAILS[:4]] + OTHERS
    return kw, prompts


# -- parity with the JAX engine at depth 2 -------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("kv_layout,kv_quantize", CACHES, ids=CACHE_IDS)
def test_greedy_tokens_equal_the_jax_engine_at_depth_2(tiny, kv_layout, kv_quantize):
    """No speculation: prompts of up to 34 tokens chunk in 16s; on the pool
    (13 pages of 8, one request can need 9) eight share a two-page prefix a
    warm request leaves cached, and the burst preempts. Both engines run at
    depth 2, and the port's queue reaches it."""
    warm = PREFIX + [77, 78, 79]
    kw, prompts = _cache_kw(kv_layout, kv_quantize, 13)
    want, _, _ = _jax_serve(tiny, warm, prompts, **kw)
    eng = _port_engine(tiny, **kw)
    assert eng.pipeline_depth == 2
    try:
        got = _serve(eng, warm, prompts)
        eng.check_page_refs()
        counters, stats = dict(eng.counters), eng.pipeline_stats()
    finally:
        eng.stop()
    assert [o["tokens"] for o in got] == want
    assert all(o["finish_reason"] == "length" and len(o["tokens"]) == N_NEW for o in got)
    assert counters["prefill_chunks_at_offset"] >= 1
    assert stats["dq_carried_max"] == 1 and stats["dq_max"] >= 2
    assert stats["folds"] == sum(stats["dispatched"].values())
    if kv_layout == "paged":
        assert counters["preemptions"] >= 1 and counters["prefix_hit_tokens"] >= 2 * PAGE


SPEC_CASES = {"lookup_paged": dict(kv_layout="paged"), "lookup_slot": dict(kv_layout="slot"),
              "draft_slot": dict(kv_layout="slot", draft=True)}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_spec_tokens_and_accept_totals_equal_the_jax_engine_at_depth_2(tiny, case):
    """``spec_tokens=4``: prompt lookup on the pool (20 pages of 8, a
    request can need 14: preemption, prefix hits) and on the slot cache,
    and a draft model (the target itself) on the slot cache, all under
    chunked prompts. Tokens, accept totals and the over-claimed pages given
    back equal the JAX engine's at depth 2, and the tokens the port's
    plain engine's."""
    from gofr_tpu.models import llama

    c = SPEC_CASES[case]
    warm = PREFIX + [77, 78, 79]
    kw, prompts = _cache_kw(c["kv_layout"], "", 20)
    jkw, pkw = dict(kw), dict(kw)
    if c.get("draft"):
        jcfg, params, model = tiny
        jkw["spec_draft"] = (llama, jcfg, params)
        pkw["spec_draft"] = (model.cfg, model)
    want, want_totals, want_trimmed = _jax_serve(tiny, warm, prompts, spec_tokens=G, **jkw)
    plain = _port_engine(tiny, **kw)
    try:
        plain_tokens = [o["tokens"] for o in _serve(plain, warm, prompts)]
    finally:
        plain.stop()
    eng = _port_engine(tiny, spec_tokens=G, **pkw)
    try:
        got = _serve(eng, warm, prompts)
        eng.check_page_refs()
        totals, counters = eng.spec_accept_totals(), dict(eng.counters)
    finally:
        eng.stop()
    assert [o["tokens"] for o in got] == want == plain_tokens
    assert totals == want_totals and totals["base"][1] > 0
    assert counters["spec_proposed"] == counters["spec_accepted"] + counters["spec_rejected"]
    assert counters["spec_pages_trimmed"] == want_trimmed
    if c["kv_layout"] == "paged":
        assert counters["preemptions"] >= 1 and counters["prefix_hit_tokens"] >= 2 * PAGE
        assert want_trimmed >= 1


# -- the queue's behaviour (cf. tests/test_async_pipeline.py, test_spec_pipeline.py) ----


class _SpyDeque(collections.deque):
    """An ``_dq`` that records, at each dispatch, the entry's kind and how
    many entries were already in flight."""

    def __init__(self):
        super().__init__()
        self.events = []

    def append(self, entry):
        self.events.append((entry.kind, len(self)))
        super().append(entry)


def _spy(eng):
    spy = _SpyDeque()
    spy.extend(eng._dq)
    eng._dq = spy
    return spy


def _record(monkeypatch, eng):
    """Dispatches and folds of prefills, chunks and decode chunks, in the
    order the device thread makes them."""
    from gofr_tpu_torch.gpu import decode, executor

    events = []

    def dispatching(name, fn):
        def wrapped(*a, **kw):
            out = fn(*a, **kw)
            if out is None or out:
                events.append(name)
            return out
        return wrapped

    monkeypatch.setattr(executor, "dispatch_prefill",
                        dispatching("prefill_dispatch", executor.dispatch_prefill))
    monkeypatch.setattr(executor, "dispatch_chunk",
                        dispatching("chunk_dispatch", executor.dispatch_chunk))
    monkeypatch.setattr(decode, "dispatch_decode",
                        dispatching("decode_dispatch", decode.dispatch_decode))
    for name in ("_fold_prefill", "_fold_chunk"):
        setattr(eng, name, dispatching(name[1:], getattr(eng, name)))
    return events


def _overlapped(events, dispatch, fold):
    """Whether a decode dispatch sits between some ``dispatch`` and the
    next ``fold``."""
    for i, ev in enumerate(events):
        if ev == dispatch and fold in events[i + 1:]:
            j = events.index(fold, i + 1)
            if "decode_dispatch" in events[i + 1:j]:
                return True
    return False


def _decoding(eng, req, timeout=60):
    deadline = time.monotonic() + timeout
    while not any(s is not None and s.request is req and s.generated for s in eng.slots):
        assert time.monotonic() < deadline, "the decoder never started"
        time.sleep(0.002)


@pytest.mark.quick
@pytest.mark.parametrize("path", ["prefill", "chunk"])
def test_a_decode_chunk_is_dispatched_between_a_prefill_and_its_fold(tiny, monkeypatch, path):
    """While a prefill (a batched one, or a chunk of a long prompt) is in
    flight, the loop dispatches a decode chunk for the lane already
    decoding before it folds the prefill (test_async_pipeline.py:143,
    :167); the tokens equal a depth-1 engine's."""
    prompt = [5, 3, 9] if path == "prefill" else [(7 * i) % 190 + 1 for i in range(21)]
    ref = _port_engine(tiny, prefill_buckets=[8], pipeline_depth=1)
    try:
        want = ref.generate(prompt, max_new_tokens=4, timeout=300)["tokens"]
    finally:
        ref.stop()
    eng = _port_engine(tiny, prefill_buckets=[8], decode_chunk=1)
    events = _record(monkeypatch, eng)
    try:
        dec = eng.submit([3, 1, 4], max_new_tokens=48)
        _decoding(eng, dec)
        assert eng.generate(prompt, max_new_tokens=4, timeout=300)["tokens"] == want
        dec.result(300)
        eng.check_page_refs()
    finally:
        eng.stop()
    assert f"{path}_dispatch" in events
    assert _overlapped(events, f"{path}_dispatch", f"fold_{path}"), events


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_a_turn_carries_depth_minus_one_calls_and_tokens_stay_exact(tiny, depth):
    """Five prompts at depth 1..4 (test_async_pipeline.py:252): the tokens
    of each depth equal depth 1's; a turn leaves at most depth - 1 calls in
    flight, and does leave that many; at depth 1 every call is dispatched
    into an empty queue."""
    prompts = [[i + 2, (3 * i) % 190 + 1] for i in range(5)]
    outs = {}
    for d in sorted({1, depth}):
        eng = _port_engine(tiny, pipeline_depth=d, decode_chunk=2)
        spy = _spy(eng)
        try:
            reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
            outs[d] = [r.result(timeout=300)["tokens"] for r in reqs]
            eng.check_page_refs()
        finally:
            eng.stop()
        assert eng.pipeline_stats()["dq_carried_max"] == d - 1
        if d == 1:
            assert max(n for _, n in spy.events) == 0
    assert outs[depth] == outs[1]


@pytest.mark.quick
def test_stop_in_the_middle_of_mixed_traffic_frees_every_slot_and_page(tiny):
    """Stopping with long prompts chunking, lanes decoding and calls in
    flight: every request ends (a result or the engine's error), the queue
    and carries are gone, and no slot or page is left held."""
    from gofr_tpu_torch.gpu.engine import EngineClosed

    eng = _port_engine(tiny, slots=3, prefill_buckets=[8], page_size=PAGE, total_pages=9)
    prompts = [[(5 * i + j) % 200 + 1 for j in range(3 + 9 * (i % 3))] for i in range(8)]
    reqs = [eng.submit(p, max_new_tokens=30) for p in prompts]
    _decoding(eng, reqs[0])
    eng.stop()
    for r in reqs:
        out, err = r.outcome()
        assert err is None or isinstance(err, EngineClosed), err
    assert not eng._dq and eng._prev_last is None and eng._spec_carry is None
    assert all(s is None for s in eng.slots)
    eng.check_page_refs()
    assert eng.page_pool_stats()["slot_pages"] == 0


def test_a_crash_settles_the_calls_in_flight_and_fails_every_request(tiny, monkeypatch):
    """A fold that raises kills the loop when no restart is left
    (``max_restarts=0``; a restart is tests/test_torch_lifecycle.py's):
    the queue and the carries are dropped, every request fails with the
    error, and health reads DOWN."""
    from gofr_tpu_torch.gpu import decode

    def broken(*_):
        raise RuntimeError("fold fault")

    eng = _port_engine(tiny, page_size=PAGE, max_restarts=0)
    monkeypatch.setattr(decode, "_fold_plain", broken)
    with eng._state_lock:  # all three queued before the loop admits any
        reqs = [eng.submit([i + 1, 2, 3], max_new_tokens=20) for i in range(3)]
    for r in reqs:
        with pytest.raises(RuntimeError, match="fold fault"):
            r.result(timeout=300)
    eng._thread.join(timeout=30)
    assert not eng._thread.is_alive()
    assert not eng._dq and eng._prev_last is None
    assert eng.health_check()["status"] == "DOWN"
    eng.check_page_refs()
    eng.stop()


@pytest.mark.parametrize("kv_layout", ["paged", "slot"])
def test_adopt_weights_with_calls_in_flight_completes_every_request(tiny, kv_layout):
    """Weights adopted while four requests decode at depth 2: the loop
    folds its calls in flight before it preempts, every request ends with
    all its tokens, and a request after the swap equals a new engine's on
    the new weights."""
    from gofr_tpu.models import llama

    new = jax.tree.map(np.asarray, llama.init(tiny[0], jax.random.key(8)))
    kw = dict(kv_layout=kv_layout, page_size=PAGE, decode_chunk=2)
    eng = _port_engine(tiny, **kw)
    in_flight = []
    apply = eng._apply_pending_weights
    eng._apply_pending_weights = lambda: (in_flight.append(len(eng._dq)), apply())
    try:
        reqs = [eng.submit([i + 2, 7, (3 * i) % 50 + 1], max_new_tokens=24) for i in range(4)]
        _decoding(eng, reqs[-1])
        assert eng.adopt_weights(new, timeout_s=300) == 1
        outs = [r.result(timeout=300) for r in reqs]
        after = eng.generate([9, 4, 1], max_new_tokens=8, timeout=300)["tokens"]
        eng.check_page_refs()
    finally:
        eng.stop()
    assert in_flight and in_flight[0] >= 1  # the swap found a call in flight
    assert all(o["finish_reason"] == "length" and len(o["tokens"]) == 24 for o in outs)
    assert sum(o["preemptions"] for o in outs) >= 1
    fresh = _port_engine(tiny, **kw)
    try:
        fresh.adopt_weights(new)
        assert fresh.generate([9, 4, 1], max_new_tokens=8, timeout=300)["tokens"] == after
    finally:
        fresh.stop()


# -- speculative rounds on the queue (tests/test_spec_pipeline.py) -----------------------


def _spec_engine(tiny, **kw):
    kw.setdefault("decode_chunk", 2)
    kw.setdefault("spec_tokens", 2)
    kw.setdefault("page_size", PAGE)
    return _port_engine(tiny, **kw)


@pytest.mark.quick
@pytest.mark.parametrize("depth", [1, 2])
def test_spec_rounds_ride_the_queue_at_depth_2_and_not_at_depth_1(tiny, depth):
    """At depth 2 some round is dispatched while an older call is in
    flight (test_spec_pipeline.py:88); at depth 1 every round finds the
    queue empty (:122). Tokens equal the plain engine's."""
    prompts = [[i + 1, (3 * i) % 200 + 1, (5 * i) % 150 + 1] for i in range(4)]
    plain = _port_engine(tiny, page_size=PAGE)
    try:
        want = [plain.generate(p, max_new_tokens=12, timeout=300)["tokens"] for p in prompts]
    finally:
        plain.stop()
    eng = _spec_engine(tiny, pipeline_depth=depth)
    spy = _spy(eng)
    try:
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        assert [r.result(timeout=300)["tokens"] for r in reqs] == want
        eng.check_page_refs()
    finally:
        eng.stop()
    depths = [n for kind, n in spy.events if kind == "spec"]
    assert depths
    assert (max(depths) >= 1) if depth == 2 else (max(depths) == 0), spy.events


def test_a_cancel_mid_round_releases_the_over_claimed_pages(tiny):
    """A request cancelled while its rounds, and their worst-case pages,
    are in flight (test_spec_pipeline.py:138): it ends with its error, a
    survivor stays exact, and once idle no slot holds a page."""
    from gofr_tpu_torch.gpu.engine import RequestCancelled

    plain = _port_engine(tiny, page_size=PAGE)
    try:
        want = plain.generate([5, 3, 9, 2], max_new_tokens=12, timeout=300)["tokens"]
    finally:
        plain.stop()
    eng = _spec_engine(tiny)
    try:
        victim = eng.submit([9, 9, 9], max_new_tokens=40)
        survivor = eng.submit([5, 3, 9, 2], max_new_tokens=12)
        _decoding(eng, victim)
        victim.cancel()
        assert survivor.result(timeout=300)["tokens"] == want
        with pytest.raises(RequestCancelled):
            victim.result(timeout=60)
        eng.check_page_refs()
        assert eng.page_pool_stats()["slot_pages"] == 0
    finally:
        eng.stop()


def test_the_over_claim_is_trimmed_to_the_actual_position_at_the_fold(tiny):
    """After a request ends no page is left beyond what it needed
    (test_spec_pipeline.py:164): without the prefix cache every page is
    free again, and the over-claimed ones were given back by folds."""
    eng = _spec_engine(tiny, prefix_cache=False)
    try:
        eng.generate([7, 1, 4], max_new_tokens=9, timeout=300)
        eng.check_page_refs()
        assert int(eng._page_refs.sum()) == 0 and eng.free_pages() == eng.total_pages
    finally:
        eng.stop()


def test_a_tight_pool_preempts_under_pipelined_spec_without_divergence(tiny):
    """The worst-case claims of four lanes exceed a 14-page pool
    (test_spec_pipeline.py:188): preemption, speculation and the queue
    interleave with tokens equal to the plain engine's and no page left
    held."""
    prompts = [[i + 1, (3 * i) % 200 + 1, (5 * i) % 150 + 1] for i in range(4)]
    plain = _port_engine(tiny, page_size=PAGE)
    try:
        want = [plain.generate(p, max_new_tokens=12, timeout=300)["tokens"] for p in prompts]
    finally:
        plain.stop()
    eng = _spec_engine(tiny, total_pages=14)
    results = [None] * 4
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, eng.generate(prompts[i], max_new_tokens=12, timeout=300))) for i in range(4)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert [r["tokens"] for r in results] == want
        eng.check_page_refs()
        assert eng.page_pool_stats()["slot_pages"] == 0
    finally:
        eng.stop()


# -- the readback on the card -----------------------------------------------------------


@pytest.mark.cuda
def test_the_pinned_readback_equals_a_blocking_copy_on_the_card():
    """``executor.Readback`` (a non-blocking copy into pinned memory and an
    event) and ``executor.to_device`` (pinned staging, a non-blocking
    upload) against ``.cpu()`` and a blocking upload, bit for bit, the
    dispatch half inside ``set_sync_debug_mode("error")``; a younger call
    queued behind the readback does not change what it reads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.gpu.executor import Readback, to_device

    dev = torch.device("cuda")
    host = np.arange(4096, dtype=np.int64).reshape(8, 512)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = to_device(host, dev)
        out = (t * 3 + 1).to(torch.int32)
        rb = Readback(dev, out, t[:, :7])
        out.add_(5)  # queued after the copy: must not show in the readback
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = [h.numpy() for h in rb.wait()]
    assert rb.host[0].is_pinned() and rb.host[1].is_pinned()
    assert np.array_equal(got[0], (host * 3 + 1).astype(np.int32))
    assert np.array_equal(got[1], host[:, :7])
    assert np.array_equal(out.cpu().numpy(), (host * 3 + 6).astype(np.int32))
    assert np.array_equal(t.cpu().numpy(), torch.from_numpy(host).to(dev).cpu().numpy())
