"""The port's speculative decoding held against the JAX package: the
acceptance test (``ops.sampling.speculative_sample``), the verify forward
(``Llama.verify_step``) on all five caches, and the engine's spec rounds
with prompt lookup (both layouts) and with a draft model (slot layout).

Tolerances:
- ``speculative_sample`` on greedy rows: exact, outputs and accept counts
  (both reduce to argmax matches); on sampled rows the draws are not JAX's,
  so the first emitted token's marginal over 20,000 draws is held to the
  target distribution: the L1 distance of the frequencies from it under
  0.05, the limit of the JAX package's own tests (tests/test_spec_decode.
  py:460; the expected distance at this count is ~0.02), and no mass
  outside a top-k set;
- verify logits on the f32 tiny config: 1e-4 against JAX, as the other
  model tests; 2e-4 against T sequential decode steps, the JAX test's own
  (the two paths sum in different orders);
- greedy engine tokens: exact, against the JAX spec engine and against
  the port's plain engine; accept totals: exact, against the JAX engine at
  pipeline depth 1 (the port's engine is synchronous), under chunked
  prompts, prefix hits and forced preemption. Every paged engine test ends
  with the pool audit ``check_page_refs``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

V = 11            # the marginal tests' vocabulary (tests/test_spec_decode.py)
DRAWS = 20000
L1_LIMIT = 0.05
LOGIT_TOL = 1e-4
SEQ_TOL = 2e-4
G = 4             # spec_tokens of the engine tests
PAGE = 8
BUCKETS = [8, 16]
N_NEW = 12
# prompts that chunk (past 16), share a two-page prefix, or neither
PREFIX = [(7 * i + 3) % 256 for i in range(2 * PAGE)]
TAILS = [[11, 12, 13, 14], list(range(40, 61)), [5] * 9, list(range(90, 103)),
         [200, 17, 33], list(range(120, 138)), [1, 2], list(range(150, 165))]
OTHERS = [[9, 8, 7], list(range(60, 90)), [42] * 12]
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


# -- speculative_sample ----------------------------------------------------------------


def _logits_case(seed, n=6, g=3, vocab=50):
    """Target and draft logits and drafts: lanes 0-2 follow the target's
    argmax chain for 3, 1 and 0 drafts (then a wrong token), lanes 3-5 are
    random."""
    rng = np.random.default_rng(seed)
    p = (rng.standard_normal((n, g + 1, vocab)) * 2).astype(np.float32)
    q = (rng.standard_normal((n, g, vocab)) * 2).astype(np.float32)
    best = p.argmax(-1)
    drafts = rng.integers(0, vocab, (n, g)).astype(np.int32)
    for lane, follow in enumerate((3, 1, 0)):
        drafts[lane, :follow] = best[lane, :follow]
        if follow < g:
            drafts[lane, follow] = (best[lane, follow] + 1) % vocab
    # a draft model's greedy proposals are its argmax
    q_drafts = q.argmax(-1).astype(np.int32)
    q_drafts[0] = best[0, :g]
    q[0, np.arange(g), best[0, :g]] += 50.0
    return p, q, drafts, q_drafts


@pytest.mark.quick
@pytest.mark.parametrize("proposer", ["lookup", "draft"])
def test_speculative_sample_equals_jax_on_greedy_rows(proposer):
    """Greedy rows (temperature 0), alone and beside sampled rows: outputs
    and accept counts equal the JAX function's."""
    from gofr_tpu.tpu.programs import speculative_sample as jax_spec
    from gofr_tpu_torch.ops.sampling import speculative_sample

    p, q, drafts, q_drafts = _logits_case(0)
    if proposer == "draft":
        drafts = q_drafts
    else:
        q = None
    greedy = [0, 1, 2, 4]
    for temps in (np.zeros(6, np.float32), np.array([0, 0, 0, 0.7, 0, 1.3], np.float32)):
        want_out, want_acc = jax_spec(jax.random.key(1), jnp.asarray(p), jnp.asarray(drafts),
                                      jnp.asarray(temps), None if q is None else jnp.asarray(q))
        out, acc = speculative_sample(_t(p), _t(drafts), _t(temps),
                                      torch.Generator().manual_seed(1),
                                      None if q is None else _t(q))
        assert out.dtype == acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy()[greedy], np.asarray(want_acc)[greedy])
        np.testing.assert_array_equal(out.numpy()[greedy], np.asarray(want_out)[greedy])
    # the cases it covers: lane 0 accepts all 3 drafts (the bonus follows);
    # lookup lanes 1 and 2 are rejected at drafts 1 and 0
    want = [3, 1, 0] if proposer == "lookup" else [3]
    assert acc.numpy()[:len(want)].tolist() == want


def _first_token_frequencies(p_logits, drafts, temps, q_logits=None, **kw):
    """Frequencies of lane 0's first emitted token over ``DRAWS`` draws: the
    lane repeated ``DRAWS`` times in one call, one seeded generator."""
    from gofr_tpu_torch.ops.sampling import speculative_sample

    rep = (DRAWS, 1, 1)
    out, _ = speculative_sample(
        _t(np.tile(p_logits, rep)), _t(np.tile(drafts, (DRAWS, 1))),
        torch.full((DRAWS,), float(temps)), torch.Generator().manual_seed(0),
        None if q_logits is None else _t(np.tile(q_logits, rep)), **kw)
    return np.bincount(out[:, 0].numpy(), minlength=V) / DRAWS


def _softmax(x):
    e = np.exp(x - x.max())
    return e / e.sum()


def test_lookup_proposal_marginal_matches_target():
    p_logits = np.asarray(jax.random.normal(jax.random.key(3), (1, 3, V))) * 2.0
    drafts = np.array([[4, 7]], np.int32)
    got = _first_token_frequencies(p_logits, drafts, 1.0)
    want = _softmax(p_logits[0, 0])
    assert np.abs(got - want).sum() < L1_LIMIT, (got, want)


def test_draft_model_proposal_marginal_matches_target():
    """Proposals SAMPLED from q, as the draft model's steps draw them: the
    emitted token is distributed as the target even though q is far from
    it."""
    from gofr_tpu_torch.ops.sampling import sample_token, speculative_sample

    p_logits = np.asarray(jax.random.normal(jax.random.key(5), (1, 3, V))) * 2.0
    q_logits = np.asarray(jax.random.normal(jax.random.key(6), (1, 2, V))) * 2.0
    gen = torch.Generator().manual_seed(0)
    q_rep = _t(np.tile(q_logits, (DRAWS, 1, 1)))
    temps = torch.full((DRAWS,), 0.7)
    drafts = torch.stack([sample_token(q_rep[:, j], gen, temperature=temps) for j in range(2)], 1)
    out, _ = speculative_sample(_t(np.tile(p_logits, (DRAWS, 1, 1))), drafts, temps, gen, q_rep)
    got = np.bincount(out[:, 0].numpy(), minlength=V) / DRAWS
    want = _softmax(p_logits[0, 0] / 0.7)
    assert np.abs(got - want).sum() < L1_LIMIT, (got, want)


@pytest.mark.parametrize("top_k,top_p", [(3, 1.0), (0, 0.7)])
def test_truncated_marginal_matches_truncated_target(top_k, top_p):
    """With top_k or top_p the emitted marginal is the TRUNCATED target,
    the distribution plain truncated sampling serves, with no mass outside
    the kept set."""
    from gofr_tpu.ops.sampling import truncate_logits

    p_logits = np.asarray(jax.random.normal(jax.random.key(12), (1, 3, V))) * 2.0
    drafts = np.array([[4, 7]], np.int32)
    got = _first_token_frequencies(p_logits, drafts, 0.9, top_k=top_k, top_p=top_p)
    want = np.asarray(jax.nn.softmax(truncate_logits(jnp.asarray(p_logits[0, 0]) / 0.9,
                                                     top_k=top_k, top_p=top_p)))
    assert np.abs(got - want).sum() < L1_LIMIT, (got, want)
    assert (got[want < 1e-6] == 0).all(), "mass outside the truncated set"


# -- verify_step ------------------------------------------------------------------------


def _jax_cache(llama, jcfg, kv_layout, kv_quantize, rows):
    make = {("paged", ""): llama.make_paged_cache, ("paged", "int8"): llama.make_paged_cache_q,
            ("paged", "int4"): llama.make_paged_cache_q4, ("slot", ""): llama.make_cache,
            ("slot", "int8"): llama.make_cache_q}[kv_layout, kv_quantize]
    return make(jcfg, rows, PAGE if kv_layout == "paged" else 32)


@pytest.mark.quick
@pytest.mark.parametrize("kv_layout,kv_quantize", CACHES, ids=CACHE_IDS)
def test_verify_step_equals_jax_and_sequential_decode(tiny, kv_layout, kv_quantize):
    """Two lanes prefill prompts of 6 and 4 tokens; then one verify forward
    of 4 tokens at their positions, with a third lane idle (positions past
    the slot, or an all-OOB table row), equals JAX's ``verify_step`` /
    ``verify_step_paged`` logits and leaves the same cache; and each row's
    logits equal those of 4 sequential ``decode_step`` steps on a copy."""
    import copy

    from gofr_tpu.models import llama
    from gofr_tpu_torch.gpu.engine import make_pool

    jcfg, params, model = tiny
    t = 4
    prompts = np.array([[5, 3, 9, 11, 2, 8], [7, 1, 4, 6, 0, 0], [0] * 6], np.int32)
    lengths = np.array([6, 4, 1], np.int32)
    seq = np.array([[13, 40, 41, 42], [99, 98, 97, 96], [1, 2, 3, 4]], np.int32)
    if kv_layout == "paged":
        table = np.array([[0, 1, 2, 3], [4, 5, 6, 7], [8] * 4], np.int32)  # lane 2 all OOB
        positions = np.array([6, 4, 0], np.int32)
        rows, jrows = table, jnp.asarray(table)
        jcache = _jax_cache(llama, jcfg, kv_layout, kv_quantize, 8)
        cache = make_pool(model, kv_quantize, 8, PAGE)
    else:
        table = None
        positions = np.array([6, 4, 32], np.int32)  # lane 2 past its slot
        rows, jrows = np.arange(3, dtype=np.int32), jnp.arange(3, dtype=jnp.int32)
        jcache = _jax_cache(llama, jcfg, kv_layout, kv_quantize, 3)
        cache = make_pool(model, kv_quantize, 3, 32, "slot")
    pf = llama.prefill_paged if kv_layout == "paged" else llama.prefill
    _, jcache = pf(jcfg, params, jnp.asarray(prompts), jnp.asarray(lengths), jcache, jrows)
    model.prefill(_t(prompts).long(), _t(lengths).long(), cache, _t(rows))
    stepped = copy.deepcopy(cache)
    if kv_layout == "paged":
        want, jcache = llama.verify_step_paged(jcfg, params, jnp.asarray(seq), jnp.asarray(positions),
                                               jcache, jnp.asarray(table))
    else:
        want, jcache = llama.verify_step(jcfg, params, jnp.asarray(seq), jnp.asarray(positions), jcache)
    tab = None if table is None else _t(table)
    got, cache = model.verify_step(_t(seq), _t(positions), cache, tab)
    assert got.shape == (3, t, jcfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    for name, plane in vars(cache).items():
        want_plane = np.asarray(getattr(jcache, name))
        if plane.is_floating_point() and name in ("k", "v"):
            np.testing.assert_allclose(plane.numpy(), want_plane, atol=LOGIT_TOL, err_msg=name)
        elif plane.is_floating_point():
            # scales agree to a bf16 ulp; most quantized codes are equal
            np.testing.assert_allclose(plane.float().numpy(), want_plane.astype(np.float32),
                                       rtol=1e-2, atol=1e-6, err_msg=name)
        else:
            assert np.mean(plane.numpy() == want_plane) > 0.99, name
    for j in range(t):
        step, _ = model.decode_step(_t(seq[:, j]), _t(positions + j), stepped, tab)
        np.testing.assert_allclose(got[:2, j].numpy(), step[:2].numpy(), atol=SEQ_TOL, rtol=SEQ_TOL)


# -- the engine ---------------------------------------------------------------------------


def _serve(eng, warm, prompts, n_new=N_NEW, **kw):
    first = eng.generate(warm, max_new_tokens=n_new, timeout=300, **kw)
    reqs = [eng.submit(p, max_new_tokens=n_new, **kw) for p in prompts]
    return [first] + [r.result(timeout=300) for r in reqs]


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


def _jax_serve(tiny, warm, prompts, **kw):
    """(tokens, accept totals, over-claimed pages given back) of the JAX
    engine."""
    jeng = _jax_engine(tiny, **kw)
    try:
        tokens = [o["tokens"] for o in _serve(jeng, warm, prompts)]
        trimmed = jeng.metrics.get("app_tpu_spec_pages_trimmed_total")
        return (tokens, jeng.spec_accept_totals(),
                sum(trimmed._values.values()) if trimmed is not None else 0)
    finally:
        jeng.stop()


@pytest.mark.parametrize("kv_layout,kv_quantize", CACHES, ids=CACHE_IDS)
def test_greedy_tokens_and_accept_totals_equal_the_jax_spec_engine(tiny, kv_layout, kv_quantize):
    """``spec_tokens=4`` under chunked prompts (past the 16 bucket), and on
    the paged layout prefix hits (a warm request leaves a two-page prefix
    that eight prompts share) and a pool of 20 pages of 8 behind 4 slots (a
    request can need 14), which forces preemption: tokens equal the JAX spec
    engine's and the port's plain engine's, accept totals the JAX
    engine's, and surplus pages go back after rounds as many as the JAX
    engine gives back."""
    warm = PREFIX + [77, 78, 79]
    prompts = [PREFIX + t for t in TAILS] + OTHERS
    kw = dict(kv_layout=kv_layout, kv_quantize=kv_quantize, prefill_buckets=BUCKETS)
    if kv_layout == "paged":
        kw.update(page_size=PAGE, total_pages=20)
    else:
        prompts = [PREFIX + t for t in TAILS[:4]] + OTHERS
    want, want_totals, want_trimmed = _jax_serve(tiny, warm, prompts, spec_tokens=G, **kw)
    plain = _port_engine(tiny, **kw)
    try:
        plain_tokens = [o["tokens"] for o in _serve(plain, warm, prompts)]
    finally:
        plain.stop()
    eng = _port_engine(tiny, spec_tokens=G, **kw)
    try:
        got = _serve(eng, warm, prompts)
        eng.check_page_refs()
        totals, counters = eng.spec_accept_totals(), dict(eng.counters)
    finally:
        eng.stop()
    assert [o["tokens"] for o in got] == want == plain_tokens
    assert all(o["finish_reason"] == "length" and len(o["tokens"]) == N_NEW for o in got)
    assert totals == want_totals and totals["base"][1] > 0
    assert counters["spec_proposed"] == counters["spec_accepted"] + counters["spec_rejected"]
    assert counters["prefill_chunks_at_offset"] >= 1
    if kv_layout == "paged":
        assert counters["preemptions"] >= 1
        assert counters["prefix_hit_tokens"] >= 2 * PAGE
        assert counters["spec_pages_trimmed"] == want_trimmed >= 1
        stats = eng.page_pool_stats()
        assert stats["slot_pages"] == 0 and stats["free_pages"] + stats["prefix_pages"] == 20


@pytest.mark.quick
def test_a_prefix_hit_keeps_the_previous_occupant_s_history(tiny):
    """The JAX engine seeds the history only over the chunks it prefills, so
    after a prefix hit the hit's columns keep what the slot's previous
    occupant wrote there, and the lookup can match it: that moves
    acceptance, never tokens. The port mirrors it: its history rows equal
    the JAX engine's, column for column."""
    first = list(range(30, 60))
    shared = PREFIX + [1, 2, 3]
    other = list(range(100, 120))
    hit = PREFIX + [4, 5, 6, 7]
    kw = dict(kv_layout="paged", page_size=PAGE, prefill_buckets=BUCKETS, spec_tokens=G)
    jeng, eng = _jax_engine(tiny, **kw), _port_engine(tiny, **kw)
    try:
        for e in (jeng, eng):
            for p in (first, shared, other, hit):
                e.generate(p, max_new_tokens=5, timeout=300)
        jhist = np.asarray(jeng.cache[1])
        hist = eng._aux[:, :-1].numpy()
        assert eng.spec_accept_totals() == jeng.spec_accept_totals()
    finally:
        jeng.stop()
        eng.stop()
    assert eng.counters["prefix_hit_tokens"] == 2 * PAGE
    np.testing.assert_array_equal(hist, jhist)
    # slot 0 served all four in turn: the hit's two pages of history are the
    # third request's tokens, not the prefix it was served from the cache
    assert hist[0, :2 * PAGE].tolist() == other[:2 * PAGE] != PREFIX


def test_eos_mid_round_and_a_cyclic_output_that_accepts(tiny):
    """Greedy decode of the random tiny model falls into a cycle, which the
    lookup proposes and the verify accepts; an EOS inside a round ends the
    request there with the tokens before it."""
    want = _port_engine(tiny)
    try:
        ref = want.generate([5, 3, 9], max_new_tokens=40, timeout=300)["tokens"]
    finally:
        want.stop()
    for kv_layout in ("paged", "slot"):
        eng = _port_engine(tiny, kv_layout=kv_layout, page_size=PAGE, spec_tokens=G)
        try:
            assert eng.generate([5, 3, 9], max_new_tokens=40, timeout=300)["tokens"] == ref
            assert eng.counters["spec_accepted"] > 0
            stop = eng.generate([5, 3, 9], max_new_tokens=20, timeout=300, eos_token_id=ref[5])
            assert stop["finish_reason"] == "stop" and stop["tokens"] == ref[:5]
            eng.check_page_refs()
        finally:
            eng.stop()


@pytest.mark.parametrize("kw", [{}, {"kv_layout": "slot"}, {"top_k": 5}, {"top_p": 0.9},
                                {"kv_layout": "slot", "top_k": 5}],
                         ids=["paged", "slot", "top_k", "top_p", "slot_top_k"])
def test_sampled_requests_are_served(tiny, kw):
    """A sampled request with top_k / top_p goes through the acceptance
    test's sampled path beside greedy ones, which stay exact."""
    plain = _port_engine(tiny, page_size=PAGE)
    try:
        ref = plain.generate([5, 3, 9], max_new_tokens=6, timeout=300)["tokens"]
    finally:
        plain.stop()
    eng = _port_engine(tiny, page_size=PAGE, spec_tokens=G, seed=3, **kw)
    try:
        sampled = eng.submit([5, 3, 9], max_new_tokens=12, temperature=0.8)
        greedy = eng.submit([5, 3, 9], max_new_tokens=6)
        out = sampled.result(timeout=300)
        assert len(out["tokens"]) == 12 and all(0 <= t < 256 for t in out["tokens"])
        assert greedy.result(timeout=300)["tokens"] == ref
        eng.check_page_refs()
    finally:
        eng.stop()


# -- draft-model speculation ----------------------------------------------------------------


def _draft(tiny, key=None):
    """(cfg, model): the target itself, or the tiny config with the JAX
    weights of ``key``."""
    from gofr_tpu.models import llama
    from gofr_tpu_torch.models.llama import params_from_jax

    model = tiny[2]
    if key is not None:
        params = llama.init(tiny[0], jax.random.key(key))
        model = params_from_jax(model.cfg, jax.tree.map(np.asarray, params), device="cpu")
    return model.cfg, model


@pytest.mark.quick
def test_self_draft_accepts_every_proposal_and_equals_jax(tiny):
    """With the target as its own draft every greedy proposal is the
    target's choice: each round accepts all g, so only the rounds a chunk
    runs past the request's end go unaccepted; tokens and totals equal the
    JAX engine's with the same draft."""
    from gofr_tpu.models import llama

    jcfg, params, _ = tiny
    prompt = [5, 3, 9, 2]
    kw = dict(kv_layout="slot", spec_tokens=G)
    jeng = _jax_engine(tiny, spec_draft=(llama, jcfg, params), **kw)
    try:
        want = jeng.generate(prompt, max_new_tokens=10, timeout=300)["tokens"]
        want_totals = jeng.spec_accept_totals()
    finally:
        jeng.stop()
    eng = _port_engine(tiny, spec_draft=_draft(tiny), **kw)
    try:
        out = eng.generate(prompt, max_new_tokens=10, timeout=300)
        c = dict(eng.counters)
    finally:
        eng.stop()
    assert out["tokens"] == want
    assert eng.spec_accept_totals() == want_totals
    # 10 tokens: the first from prefill, then two rounds of g + 1
    assert c["spec_accepted"] == 2 * G and c["spec_proposed"] == 8 * G


def test_random_draft_is_token_exact_and_chunked_prefill_seeds_the_draft(tiny):
    """A random draft proposes near garbage, which the verify rejects: the
    tokens stay the plain engine's. A prompt past the largest bucket
    prefills in chunks, and the draft's cache is filled chunk by chunk: a
    self-draft then still accepts every proposal."""
    prompts = [[i + 2, (5 * i) % 170 + 1, (9 * i) % 110 + 1] for i in range(5)]
    long = [(7 * i) % 150 + 1 for i in range(13)]
    plain = _port_engine(tiny, kv_layout="slot")
    try:
        want = [plain.generate(p, max_new_tokens=9, timeout=300)["tokens"] for p in prompts]
        want_long = plain.generate(long, max_new_tokens=10, timeout=300)["tokens"]
    finally:
        plain.stop()
    eng = _port_engine(tiny, kv_layout="slot", spec_tokens=G, spec_draft=_draft(tiny, key=99))
    try:
        reqs = [eng.submit(p, max_new_tokens=9) for p in prompts]
        assert [r.result(timeout=300)["tokens"] for r in reqs] == want
    finally:
        eng.stop()
    eng = _port_engine(tiny, kv_layout="slot", spec_tokens=G, spec_draft=_draft(tiny),
                       prefill_buckets=[8], max_prefill_batch=1)
    try:
        assert eng.generate(long, max_new_tokens=10, timeout=300)["tokens"] == want_long
        assert eng.counters["prefill_chunks"] == 2
        assert eng.counters["spec_accepted"] == 2 * G
    finally:
        eng.stop()


def test_draft_is_refused_on_the_paged_layout_and_without_spec_tokens(tiny):
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig

    with pytest.raises(ValueError, match="requires spec_tokens"):
        _port_engine(tiny, kv_layout="slot", spec_draft=_draft(tiny))
    with pytest.raises(ValueError, match="slot-layout only"):
        _port_engine(tiny, kv_layout="paged", spec_tokens=G, spec_draft=_draft(tiny))
    with pytest.raises(ValueError, match="vocabulary"):
        build_engine("tiny", params=tiny[2], device="cpu", kv_layout="slot", max_len=64,
                     spec_tokens=G, spec_draft=(LlamaConfig.tiny(vocab_size=300), None))
    with pytest.raises(ValueError, match="cache length"):
        build_engine("tiny", params=tiny[2], device="cpu", kv_layout="slot", max_len=64,
                     spec_tokens=G, spec_draft=(LlamaConfig.tiny(max_seq_len=64), None))
