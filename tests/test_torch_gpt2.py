"""The port's GPT-2 family (gofr_tpu_torch.models.gpt2) and the engine's
other generate family, held against the JAX package (gofr_tpu/models/
gpt2.py, its GenerateEngine and build_engine).

Weights come from ``gofr_tpu.models.gpt2.init`` at the tiny config (f32),
with the biases and LayerNorm shifts drawn from a numpy seed so every
bias site is exercised, and cross over with ``params_from_jax``. JAX runs
on the CPU, and the port's kernel wrappers take their plain versions
because the tensors lie on the CPU.

Tolerances: logits within 1e-4 (the frameworks sum in different orders);
greedy tokens exactly equal; a refusal is the JAX engine's, the same
exception type and message stem.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

LOGIT_TOL = 1e-4
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6]]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


def _port_cfg(jcfg):
    from gofr_tpu_torch.models.gpt2 import GPT2Config

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return GPT2Config(**fields, dtype=torch.float32)


@pytest.fixture(scope="module")
def tiny():
    """JAX's tiny GPT-2 (key 5) with numpy-drawn biases and LayerNorm
    shifts, its numpy tree, and the port's model on those weights."""
    from gofr_tpu.models import gpt2
    from gofr_tpu_torch.models.gpt2 import params_from_jax

    jcfg = gpt2.GPT2Config.tiny()
    tree = jax.tree.map(np.asarray, gpt2.init(jcfg, jax.random.key(5)))
    rng = np.random.default_rng(5)
    for name in ("bq", "bk", "bv", "bo", "b_fc", "b_proj", "ln1_b", "ln2_b"):
        shape = tree["blocks"][name].shape
        tree["blocks"][name] = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    tree["lnf_b"] = (rng.standard_normal(tree["lnf_b"].shape) * 0.05).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    return jcfg, params, tree, params_from_jax(_port_cfg(jcfg), tree, device="cpu")


# -- the model's entry points --------------------------------------------------------


@pytest.mark.quick
def test_forward_matches_jax_and_holds_each_weight_once(tiny):
    from gofr_tpu.models import gpt2

    jcfg, params, _, model = tiny
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 11))
    lengths = np.array([11, 6, 1], np.int32)
    _close(model.forward(_t(tokens), _t(lengths)),
           gpt2.forward(jcfg, params, jnp.asarray(tokens), jnp.asarray(lengths)))
    # the tied head is the embedding itself: the state holds every JAX leaf once
    assert sum(t.numel() for t in model.state_dict().values()) == sum(
        x.size for x in jax.tree.leaves(params))
    assert "lm_head.weight" not in model.state_dict()


def _caches(jcfg, model, slots=3, max_len=32):
    from gofr_tpu.models import gpt2

    return gpt2.make_cache(jcfg, slots, max_len), model.make_cache(slots, max_len)


@pytest.mark.parametrize("chunked", [False, True])
def test_prefill_matches_jax_with_and_without_offsets(tiny, chunked):
    from gofr_tpu.models import gpt2

    jcfg, params, _, model = tiny
    rng = np.random.default_rng(2)
    first = rng.integers(0, jcfg.vocab_size, (2, 9))
    second = rng.integers(0, jcfg.vocab_size, (2, 7))
    len1, len2 = np.array([9, 5], np.int32), np.array([7, 4], np.int32)
    slots = np.array([2, 0], np.int32)
    jcache, cache = _caches(jcfg, model)
    want, jcache = gpt2.prefill(jcfg, params, jnp.asarray(first), jnp.asarray(len1), jcache,
                                jnp.asarray(slots))
    got, cache = model.prefill(_t(first), _t(len1), cache, _t(slots))
    _close(got, want)
    if chunked:
        want, jcache = gpt2.prefill(jcfg, params, jnp.asarray(second), jnp.asarray(len2), jcache,
                                    jnp.asarray(slots), jnp.asarray(len1))
        got, cache = model.prefill(_t(second), _t(len2), cache, _t(slots), _t(len1))
        _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


def test_verify_and_decode_steps_match_jax(tiny):
    """Four decode steps with an idle lane parked at the slot's end (its
    position past ``max_seq_len``: the position embedding clamps, the
    writes drop), then a verify forward of 4 tokens a lane."""
    from gofr_tpu.models import gpt2

    jcfg, params, _, model = tiny
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 10))
    lengths = np.array([10, 6], np.int32)
    slots = np.array([2, 0], np.int32)
    smax = jcfg.max_seq_len
    jcache, cache = _caches(jcfg, model, max_len=smax)
    want, jcache = gpt2.prefill(jcfg, params, jnp.asarray(tokens), jnp.asarray(lengths), jcache,
                                jnp.asarray(slots))
    model.prefill(_t(tokens), _t(lengths), cache, _t(slots))
    positions = np.array([6, smax + 3, 10], np.int32)
    step = np.zeros(3, np.int32)
    step[slots] = np.asarray(jnp.argmax(want, -1))
    for _ in range(4):
        want, jcache = gpt2.decode_step(jcfg, params, jnp.asarray(step), jnp.asarray(positions),
                                        jcache)
        got, cache = model.decode_step(_t(step), _t(positions), cache)
        _close(got, want)
        step = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        positions = positions + 1
    _close(cache.k, jcache.k)
    seq = rng.integers(0, jcfg.vocab_size, (3, 4))
    vpos = np.array([10, 0, 14], np.int32)
    want, jcache = gpt2.verify_step(jcfg, params, jnp.asarray(seq), jnp.asarray(vpos), jcache)
    got, cache = model.verify_step(_t(seq), _t(vpos), cache)
    _close(got, want)
    _close(cache.v, jcache.v)


# -- the engine: whole-prompt, chunked, speculative, int8 ------------------------------------


def _jax_engine(jcfg, params, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import gpt2
    from gofr_tpu.tpu.engine import GenerateEngine

    return GenerateEngine(gpt2, jcfg, params, new_mock_container(), **kw)


def _serve(eng, prompts, n_new):
    try:
        return [r.result(timeout=120)["tokens"] for r in [eng.submit(p, max_new_tokens=n_new)
                                                          for p in prompts]]
    finally:
        eng.stop()


@pytest.mark.quick
def test_greedy_tokens_equal_the_jax_engine(tiny):
    """The family's default layout is the slot cache, as JAX's: the same
    cache length and tokens; the report names the family."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.ops.kvcache import SlotKVCache

    jcfg, params, tree, _ = tiny
    knobs = dict(slots=4, max_len=64, max_prefill_batch=2)
    jeng = _jax_engine(jcfg, params, **knobs)
    jax_len = jeng._cache_len
    want = _serve(jeng, PROMPTS, 7)
    eng = build_engine(_port_cfg(jcfg), params=tree, device="cpu", **knobs)
    assert eng.kv_layout == "slot" and type(eng.cache) is SlotKVCache
    assert eng.cache_len == jax_len
    assert eng.replay_config()["family"] == "gpt2"
    assert _serve(eng, PROMPTS, 7) == want


def test_chunked_prompt_tokens_equal_the_jax_engine(tiny):
    """tests/test_engine.py's chunked GPT-2 case: a 19-token prompt in
    chunks of 8 beside short prompts, each against the JAX engine."""
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, _, model = tiny
    long_prompt = [(3 * i) % 200 + 1 for i in range(19)]
    prompts = [long_prompt, [5, 3, 9], [7] * 6]
    knobs = dict(slots=2, max_len=64, max_prefill_batch=2, prefill_buckets=[8])
    want = _serve(_jax_engine(jcfg, params, **knobs), prompts, 5)
    eng = GenerateEngine(model, device="cpu", **knobs)
    assert _serve(eng, prompts, 5) == want
    assert eng.counters["prefill_chunks_at_offset"] >= 2


def test_speculative_gpt2_draft_tokens_equal_the_jax_engine(tiny):
    """tests/test_spec_decode.py's GPT-2 self-draft: the tokens and the
    accepted total equal the JAX engine's (both at pipeline depth 1), and
    equal plain greedy decode."""
    from gofr_tpu.models import gpt2
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, _, model = tiny
    knobs = dict(slots=2, max_len=64, max_prefill_batch=1, decode_chunk=4, spec_tokens=3)
    jeng = _jax_engine(jcfg, params, spec_draft=(gpt2, jcfg, params), decode_pipeline=1, **knobs)
    try:
        want = jeng.generate([5, 3, 9], max_new_tokens=12, timeout=300)
        jax_accepted = jeng.spec_accept_totals()
    finally:
        jeng.stop()
    eng = GenerateEngine(model, device="cpu", spec_draft=(model.cfg, model), pipeline_depth=1,
                         **knobs)
    try:
        got = eng.generate([5, 3, 9], max_new_tokens=12, timeout=300)
        accepted = eng.spec_accept_totals()
    finally:
        eng.stop()
    assert got["tokens"] == want["tokens"]
    assert accepted["base"][0] > 0 and accepted == {k: tuple(v) for k, v in jax_accepted.items()}
    plain = _serve(GenerateEngine(model, device="cpu", slots=2, max_len=64), [[5, 3, 9]], 12)
    assert plain == [got["tokens"]]


@pytest.mark.quick
def test_int8_engine_tokens_equal_the_jax_engine(tiny):
    """tests/test_models.py's ``build_engine(ModelSpec("gpt2"), quantize=
    "int8")``: JAX's random weights of seed 5 quantized under jit, the
    port's from the same tree; the head stays the f32 embedding."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import GPT2Config, ModelSpec as JaxSpec, gpt2
    from gofr_tpu.tpu.engine import build_engine as jax_build
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec

    cfg = GPT2Config.tiny()
    knobs = dict(slots=2, max_len=48, max_prefill_batch=2)
    jeng = jax_build(JaxSpec(family="gpt2", task="generate", config=cfg), jax_container(),
                     seed=5, quantize="int8", **knobs)
    want = _serve(jeng, PROMPTS[:3], 5)
    tree = jax.tree.map(np.asarray, gpt2.init(cfg, jax.random.key(5)))
    eng = build_engine(ModelSpec("gpt2", _port_cfg(cfg), weights=tree, dtype=torch.float32),
                       new_mock_container(), device="cpu", quantize="int8", **knobs)
    assert type(eng.model.blocks[0].w_fc).__name__ == "QLinear"
    assert eng.model.wte.dtype == torch.float32
    assert _serve(eng, PROMPTS[:3], 5) == want


# -- refusals, each against JAX's verdict -----------------------------------------------------


def _without(module, name):
    """A stand-in for a family module without ``name``."""
    ns = types.SimpleNamespace(**{k: getattr(module, k) for k in dir(module)
                                  if not k.startswith("__") and k != name})
    ns.__name__ = module.__name__
    return ns


def _missing(self):
    raise AttributeError("verify_step")


REFUSALS = {
    "paged layout": (dict(kv_layout="paged"), "has no paged-cache support"),
    "int8 slot cache": (dict(kv_quantize="int8"), "has no int8 KV support"),
    "adapters": (dict(adapter_slots=2), "does not support per-lane adapters"),
    "spec without verify_step": (dict(spec_tokens=2), "has no verify_step"),
}


@pytest.mark.quick
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_engine_refuses_what_the_family_lacks_as_jax_does(tiny, case):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import gpt2
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.models.gpt2 import GPT2

    jcfg, params, _, model = tiny
    kw, stem = REFUSALS[case]
    family = gpt2
    if case == "spec without verify_step":
        family = _without(gpt2, "verify_step")
        model = type("NoVerify", (GPT2,), {"verify_step": property(_missing),
                                           "__module__": GPT2.__module__})(model.cfg, "cpu")
    with pytest.raises(ValueError, match=stem):
        JaxEngine(family, jcfg, params, new_mock_container(), slots=2, max_len=32, **kw)
    with pytest.raises(ValueError, match=stem):
        GenerateEngine(model, device="cpu", slots=2, max_len=32, **kw)


@pytest.mark.parametrize("source", ["keyword", "config"])
def test_quantize_refused_by_a_keyword_and_warned_by_config_without_quantizable(tiny, source,
                                                                                monkeypatch):
    """A family without ``QUANTIZABLE``: ``quantize="int8"`` raises,
    ``ENGINE_QUANTIZE=int8`` only warns and serves unquantized, as JAX's
    build_engine (engine.py:4084-4109)."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import ModelSpec as JaxSpec, gpt2 as jax_gpt2
    from gofr_tpu.tpu.engine import build_engine as jax_build
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec, gpt2

    jcfg, _, tree, _ = tiny
    monkeypatch.setattr(jax_gpt2, "QUANTIZABLE", False)
    monkeypatch.setattr(gpt2, "QUANTIZABLE", False)
    kw = dict(quantize="int8") if source == "keyword" else {}
    config = {} if source == "keyword" else {"ENGINE_QUANTIZE": "int8"}
    knobs = dict(slots=2, max_len=32, **kw)
    jspec = JaxSpec(family="gpt2", task="generate", config=jcfg)
    spec = ModelSpec("gpt2", _port_cfg(jcfg), weights=tree, dtype=torch.float32)
    if source == "keyword":
        with pytest.raises(ValueError, match="does not support weight-only quantization"):
            jax_build(jspec, jax_container(config), **knobs)
        with pytest.raises(ValueError, match="does not support weight-only quantization"):
            build_engine(spec, new_mock_container(config), device="cpu", **knobs)
        return
    jax_build(jspec, jax_container(config), **knobs).stop()
    container = new_mock_container(config)
    warned = []
    container.logger.warn = lambda msg, *a, **k: warned.append(msg)
    eng = build_engine(spec, container, device="cpu", **knobs)
    try:
        assert type(eng.model.blocks[0].wq).__name__ == "Linear"
        assert any("ENGINE_QUANTIZE=int8 ignored" in m for m in warned)
    finally:
        eng.stop()


# -- the quality plane and adoption ------------------------------------------------------------


@pytest.mark.quick
def test_quality_rows_equal_the_jax_forward_rows(tiny):
    """The port's teacher-forced rows of a GPT-2 request equal JAX's
    ``forward`` over the same padded bucket, rows [len(prompt) - 1, + T).
    JAX's own ``teacher_forced_rows`` cannot score GPT-2: it passes the
    hooks to a ``forward`` that does not take them (TypeError)."""
    from gofr_tpu.metrics import quality as jq
    from gofr_tpu.models import gpt2
    from gofr_tpu_torch.metrics import quality as pq

    jcfg, params, _, model = tiny
    prompt, emitted = [5, 3, 9, 11], [20, 21, 22]
    got = pq.teacher_forced_rows(model, prompt, emitted)
    seq = prompt + emitted
    bucket = 8
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :len(seq)] = seq
    logits = gpt2.forward(jcfg, params, jnp.asarray(padded), jnp.asarray([len(seq)], jnp.int32))
    want = np.asarray(logits[0, len(prompt) - 1:len(prompt) - 1 + len(emitted)])
    assert got.shape == want.shape
    _close(got, want)
    with pytest.raises(TypeError):
        jq.teacher_forced_rows(gpt2, jcfg, params, prompt, emitted)


def test_adopt_weights_takes_a_gpt2_tree(tiny):
    """``adopt_weights`` with a JAX GPT-2 tree: the engine then serves the
    tokens of an engine built on it."""
    from gofr_tpu.models import gpt2
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.models.gpt2 import params_from_jax

    jcfg, _, _, model = tiny
    new = jax.tree.map(np.asarray, gpt2.init(jcfg, jax.random.key(6)))
    fresh = GenerateEngine(params_from_jax(model.cfg, new, "cpu"), device="cpu", slots=2,
                           max_len=32)
    want = _serve(fresh, PROMPTS[:2], 5)
    served = GenerateEngine(params_from_jax(model.cfg, jax.tree.map(np.asarray, gpt2.init(
        jcfg, jax.random.key(5))), "cpu"), device="cpu", slots=2, max_len=32)
    try:
        assert served.adopt_weights(new, timeout_s=60) == 1
    except BaseException:
        served.stop()
        raise
    assert _serve(served, PROMPTS[:2], 5) == want
    with pytest.raises(ValueError, match="GPT2"):
        fresh.adopt_weights({"wte": np.zeros(1)})


# -- GPT-2 on the card: the 64 builds of F and G -------------------------------------------------


@pytest.mark.cuda
def test_gpt2_decode_on_the_card_runs_f64_and_g64_and_agrees_with_plain():
    """A 2-layer GPT-2 of full width (768, 12 heads of 64) in bf16: prefill
    and decode steps with the kernels launch C, F and G's 64 builds, and
    their logits agree with the plain path's within 5% of its range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.models.gpt2 import GPT2Config, init
    from gofr_tpu_torch.ops import cuda

    cfg = GPT2Config.small(num_layers=2, dtype=torch.bfloat16)
    model = init(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda")
    lengths = torch.tensor([40, 23], device="cuda")
    slots = torch.arange(2, device="cuda")
    runs = {}
    cuda.reset_launch_counts()
    for kernels in (True, False):
        cache = model.make_cache(2, 128)
        logits, _ = model.prefill(tokens, lengths, cache, slots, kernels=kernels)
        step = logits.argmax(-1)
        positions = lengths.clone()
        for _ in range(3):
            logits, _ = model.decode_step(step, positions, cache, kernels=kernels)
            positions = positions + 1
        runs[kernels] = logits.float()
    counts = cuda.launch_counts()
    assert counts["decode_attention_d64"] == counts["kv_append_slot_d64"] == 3 * 2
    assert counts["flash_attention_d64"] == 2
    assert counts["decode_attention"] == counts["kv_append_slot"] == 0
    span = (runs[False].max() - runs[False].min()).item()
    assert (runs[True] - runs[False]).abs().max().item() <= 5e-2 * span
