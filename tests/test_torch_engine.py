"""The port's continuous-batching engine (gofr_tpu_torch.gpu.engine) held
against the JAX paged engine.

Greedy tokens are an exact contract: the port's ``GenerateEngine`` on the
CPU and ``gofr_tpu.tpu.engine.GenerateEngine`` with the paged layout, on the
same weights and prompts (mixed lengths, served concurrently), must emit the
same ids. Sampled tokens come from different generators in the two
frameworks, so sampling is held to its distribution (tests/test_torch_ops.py)
and to reproducibility from the seed here.
"""

import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6]]


@pytest.fixture(scope="module")
def weights():
    from gofr_tpu.models import LlamaConfig, llama

    jcfg = LlamaConfig.tiny()
    return jcfg, llama.init(jcfg, jax.random.key(7))


def _port_engine(weights, **kw):
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig

    jcfg, params = weights
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    return build_engine(LlamaConfig.tiny(), params=jax.tree.map(np.asarray, params),
                        device="cpu", page_size=8, **kw)


def _submit_all(eng, prompts, n_new, **kw):
    reqs = [eng.submit(p, max_new_tokens=n_new, **kw) for p in prompts]
    return [r.result(timeout=120) for r in reqs]


@pytest.mark.quick
def test_greedy_tokens_equal_the_jax_paged_engine(weights):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine

    jcfg, params = weights
    jeng = JaxEngine(llama, jcfg, params, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, kv_layout="paged", page_size=8)
    try:
        want = _submit_all(jeng, PROMPTS, 7)
    finally:
        jeng.stop()
    eng = _port_engine(weights)
    try:
        got = _submit_all(eng, PROMPTS, 7)
    finally:
        eng.stop()
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    assert [g["finish_reason"] for g in got] == ["length"] * len(PROMPTS)


def test_concurrent_callers_match_sequential_and_free_every_page(weights):
    eng = _port_engine(weights, decode_chunk=3)
    try:
        seq = [eng.generate(p, max_new_tokens=5, timeout=60)["tokens"] for p in PROMPTS]
        results = [None] * 10

        def worker(i):
            results[i] = eng.generate(PROMPTS[i % len(PROMPTS)], max_new_tokens=5, timeout=120)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert [r["tokens"] for r in results] == [seq[i % len(PROMPTS)] for i in range(10)]
        # every page is free but those the prefix cache keeps
        stats = eng.page_pool_stats()
        assert stats["slot_pages"] == 0
        assert eng.free_pages() + stats["prefix_pages"] == eng.total_pages
        eng.check_page_refs()
    finally:
        eng.stop()


def test_eos_stops_and_errors_are_per_request(weights):
    eng = _port_engine(weights)
    try:
        full = eng.generate([11, 22, 33], max_new_tokens=6)["tokens"]
        out = eng.generate([11, 22, 33], max_new_tokens=6, eos_token_id=full[2])
        assert out["finish_reason"] == "stop" and out["tokens"] == full[:2]
        with pytest.raises(ValueError, match="max_len"):
            eng.generate(list(range(1, 70)), max_new_tokens=2)
        with pytest.raises(ValueError, match="outside"):
            eng.generate([999], max_new_tokens=2)
        # the engine keeps serving after rejected requests
        assert eng.generate([11, 22, 33], max_new_tokens=6)["tokens"] == full
    finally:
        eng.stop()


def test_sampling_is_reproducible_from_the_seed(weights):
    outs = []
    for _ in range(2):
        eng = _port_engine(weights, seed=9)
        try:
            outs.append(_submit_all(eng, PROMPTS[:2], 6, temperature=1.0))
        finally:
            eng.stop()
    assert [o["tokens"] for o in outs[0]] == [o["tokens"] for o in outs[1]]
    assert all(0 <= t < 256 for o in outs[0] for t in o["tokens"])


def test_cancel_and_stop(weights):
    from gofr_tpu_torch.gpu.engine import EngineClosed, RequestCancelled

    eng = _port_engine(weights, slots=1)
    try:
        req = eng.submit([1, 2, 3], max_new_tokens=40)
        req.cancel()
        with pytest.raises(RequestCancelled):
            req.result(timeout=60)
        assert eng.generate([1, 2, 3], max_new_tokens=2)["finish_reason"] == "length"
    finally:
        eng.stop()
    with pytest.raises(EngineClosed):
        eng.submit([1])
