"""Live weight adoption on the port (``GenerateEngine.adopt_weights``) held
against the JAX engine's (gofr_tpu/tpu/engine.py ``adopt_weights``).

Tolerances: greedy tokens, exact, on the f32 tiny config: after a swap
they equal an engine built on the new weights and the JAX engine after
the same swap; swapping back restores the old tokens exactly. Requests in
flight during a swap all complete, by recompute on the new weights. Every
paged engine test ends with the pool audit ``check_page_refs``.
"""

import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PAGE = 8
PROMPTS = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5], [2, 4, 6, 8, 10, 12]]


@pytest.fixture(scope="module")
def trees():
    """The JAX tiny config and two weight trees (keys 7 and 99), each as
    numpy arrays."""
    from gofr_tpu.models import LlamaConfig, llama

    jcfg = LlamaConfig.tiny()
    return (jcfg, llama.init(jcfg, jax.random.key(7)), llama.init(jcfg, jax.random.key(99)))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _engine(tree, **kw):
    from gofr_tpu_torch.gpu.engine import build_engine

    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    return build_engine("tiny", params=_np(tree), device="cpu", **kw)


def _tokens(eng, prompt=PROMPTS[0], n=8):
    return eng.generate(prompt, max_new_tokens=n, timeout=300)["tokens"]


@pytest.mark.quick
@pytest.mark.parametrize("kv_layout", ["paged", "slot"])
def test_a_swap_is_real_reversible_and_equals_the_new_weights(trees, kv_layout):
    """After ``adopt_weights`` the engine's tokens are those of an engine
    built on the new weights and of the JAX engine after the same swap;
    swapping back restores the old tokens; ``weights_epoch`` counts the
    swaps. A numpy tree and a ``Llama`` adopt alike."""
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax

    jcfg, p1, p2 = trees
    kw = dict(kv_layout=kv_layout, page_size=PAGE)
    fresh = _engine(p2, **kw)
    try:
        want_new = [_tokens(fresh, p) for p in PROMPTS]
    finally:
        fresh.stop()
    jeng = JaxEngine(llama, jcfg, p1, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, **kw)
    try:
        jeng.adopt_weights(p2)
        jax_new = [_tokens(jeng, p) for p in PROMPTS]
    finally:
        jeng.stop()
    eng = _engine(p1, **kw)
    try:
        old = [_tokens(eng, p) for p in PROMPTS]
        assert eng.adopt_weights(_np(p2)) == 1 and eng.weights_epoch == 1
        swapped = [_tokens(eng, p) for p in PROMPTS]
        eng.check_page_refs()
        assert eng.adopt_weights(params_from_jax(LlamaConfig.tiny(), _np(p1), "cpu")) == 2
        back = [_tokens(eng, p) for p in PROMPTS]
        assert eng.adapter_stats() == {"enabled": False, "weights_epoch": 2}
    finally:
        eng.stop()
    assert swapped == want_new == jax_new
    assert swapped != old
    assert back == old


def test_a_mismatched_tree_raises_and_leaves_the_weights(trees):
    """Another depth, a missing leaf, another dtype, another config's
    ``Llama``: each raises ValueError naming ``adopt_weights``, and the
    engine goes on serving its weights."""
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models import llama as port_llama

    jcfg, p1, _ = trees
    eng = _engine(p1, page_size=PAGE)
    try:
        before = _tokens(eng)
        one_layer = _np(llama.init(LlamaConfig.tiny(num_layers=1), jax.random.key(0)))
        missing = _np(p1)
        del missing["final_norm"]
        wrong_dtype = jax.tree.map(lambda a: a.astype(np.float16), _np(p1))
        other = port_llama.init(port_llama.LlamaConfig.tiny(hidden_size=32),
                                torch.Generator().manual_seed(0), "cpu")
        for bad in (one_layer, missing, wrong_dtype, other, {"t": _np(p1), "d": _np(p1)}):
            with pytest.raises(ValueError, match="adopt_weights"):
                eng.adopt_weights(bad)
        assert eng.weights_epoch == 0 and _tokens(eng) == before
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_layout", ["paged", "slot"])
def test_requests_in_flight_complete_on_the_new_weights(trees, kv_layout):
    """Four requests decoding when the swap lands: every one completes with
    its full length, preempted once and recomputed on the new weights; the
    prefix cache and the pages are reset, and the audit passes."""
    jcfg, p1, p2 = trees
    kw = dict(kv_layout=kv_layout, page_size=PAGE, decode_chunk=2)
    eng = _engine(p1, **kw)
    try:
        reqs = [eng.submit(p, max_new_tokens=40) for p in PROMPTS]
        while not all(s is not None and s.generated for s in eng.slots):
            time.sleep(0.001)
        assert eng.adopt_weights(_np(p2), timeout_s=60.0) == 1
        outs = [r.result(timeout=300) for r in reqs]
        eng.check_page_refs()
        counters = dict(eng.counters)
        pool = eng.page_pool_stats()
    finally:
        eng.stop()
    assert all(o["finish_reason"] == "length" and len(o["tokens"]) == 40 for o in outs)
    assert [o["preemptions"] for o in outs] == [1] * 4 and counters["preemptions"] == 4
    if kv_layout == "paged":
        assert pool["slot_pages"] == 0


def test_a_swap_under_live_traffic_drops_nothing(trees):
    """Three callers keep the engine busy while the weights change: no
    request fails, every answer is a full-length generation, and one swap
    happened."""
    jcfg, p1, p2 = trees
    eng = _engine(p1, page_size=PAGE, adapter_slots=3, adapter_rank=8)
    results, errors = [], []
    stop = threading.Event()

    def feeder():
        i = 0
        while not stop.is_set():
            try:
                results.append(eng.generate(PROMPTS[i % 4], max_new_tokens=6, timeout=60.0))
            except Exception as e:  # noqa: BLE001 - the drill counts every failure
                errors.append(e)
            i += 1

    threads = [threading.Thread(target=feeder) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.3)
        assert eng.adopt_weights(_np(p2), timeout_s=60.0) == 1
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
        eng.check_page_refs()
    finally:
        stop.set()
        eng.stop()
    assert not errors, errors
    assert results and all(len(r["tokens"]) == 6 and r["finish_reason"] == "length"
                           for r in results)
    assert eng.weights_epoch == 1


def test_a_draft_engine_keeps_its_draft_unless_given_one(trees):
    """On a draft engine the target alone is adopted with the live draft
    kept (the JAX engine grafts it in); ``{"t": ..., "d": ...}`` replaces
    both. Greedy tokens are the target's either way."""
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax

    jcfg, p1, p2 = trees
    cfg = LlamaConfig.tiny()
    kw = dict(kv_layout="slot", spec_tokens=4)
    fresh = _engine(p2, **kw)
    try:
        want = _tokens(fresh)
    finally:
        fresh.stop()
    draft = params_from_jax(cfg, _np(p1), "cpu")
    eng = _engine(p1, spec_draft=(cfg, draft), **kw)
    try:
        kept = draft.embed.clone()
        eng.adopt_weights(_np(p2))
        assert torch.equal(draft.embed, kept)
        assert _tokens(eng) == want
        eng.adopt_weights({"t": _np(p2), "d": _np(p2)})
        assert torch.equal(draft.embed, eng.model.embed)
        # a self-draft now: every proposal is the target's choice
        accepted = eng.counters["spec_accepted"]
        assert _tokens(eng) == want and eng.counters["spec_accepted"] > accepted
        assert eng.weights_epoch == 2
    finally:
        eng.stop()


def test_a_stopped_engine_adopts_inline(trees):
    jcfg, p1, p2 = trees
    eng = _engine(p1, page_size=PAGE)
    eng.stop()
    assert eng.adopt_weights(_np(p2)) == 1
    fresh = _engine(p2, page_size=PAGE)
    try:
        for (name, p), (_, q) in zip(eng.model.named_parameters(),
                                     fresh.model.named_parameters()):
            assert torch.equal(p, q), name
    finally:
        fresh.stop()
