"""The port's streaming ``generate(stream=True)`` held against the JAX
engine's, in plain decode and in speculative rounds.

Tolerances: exact everywhere. A stream is the tokens as they are decoded,
or the text pieces the incremental detokenizer makes of them: the pieces
equal the JAX engine's piece for piece (greedy tokens are exact on the f32
tiny config), and joined they equal the result's text.
"""

import queue
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

TEXT = "héllo ✓"   # multi-byte UTF-8: the byte tokenizer splits its characters
N_NEW = 24


@pytest.fixture(scope="module")
def text_model():
    """Tiny f32 weights over a vocabulary of 300, which covers the byte
    tokenizer's 259 ids (tests/test_tokenizer.py)."""
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny(vocab_size=300)
    params = llama.init(jcfg, jax.random.key(11))
    model = params_from_jax(PortConfig.tiny(vocab_size=300), jax.tree.map(np.asarray, params),
                            device="cpu")
    return jcfg, params, model


def _port_engine(text_model, tokenizer=True, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine
    from gofr_tpu_torch.utils.tokenizer import ByteTokenizer

    kw = {"slots": 4, "max_len": 64, "max_prefill_batch": 2, **kw}
    return GenerateEngine(text_model[2], device="cpu",
                          tokenizer=ByteTokenizer() if tokenizer else None, **kw)


def _jax_engine(text_model, tokenizer=True, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu.utils import ByteTokenizer

    jcfg, params, _ = text_model
    return JaxEngine(llama, jcfg, params, new_mock_container(), slots=4, max_len=64,
                     max_prefill_batch=2, tokenizer=ByteTokenizer() if tokenizer else None, **kw)


def _streams(eng, prompts):
    """Each prompt streamed alone, then generated whole: (the streams'
    items, the results)."""
    items = [list(eng.generate(p, max_new_tokens=N_NEW, timeout=300, stream=True))
             for p in prompts]
    return items, [eng.generate(p, max_new_tokens=N_NEW, timeout=300) for p in prompts]


MODES = {"plain": {}, "spec_paged": {"spec_tokens": 3, "decode_chunk": 4},
         "spec_slot": {"spec_tokens": 3, "decode_chunk": 4, "kv_layout": "slot"}}


@pytest.mark.quick
@pytest.mark.parametrize("mode", list(MODES))
def test_text_pieces_equal_the_jax_engine_s_and_join_to_the_text(text_model, mode):
    """A multi-byte prompt through the byte tokenizer, and a prompt of ids
    whose output holds bytes that are not UTF-8: the pieces are strings,
    hold back a split character, equal the JAX engine's, and join to the
    result's text."""
    from gofr_tpu_torch.utils.tokenizer import ByteTokenizer

    prompts = [TEXT, [200, 180, 9, 77]]
    jeng = _jax_engine(text_model, **MODES[mode])
    try:
        want = _streams(jeng, prompts)[0]
    finally:
        jeng.stop()
    eng = _port_engine(text_model, **MODES[mode])
    try:
        pieces, outs = _streams(eng, prompts)
    finally:
        eng.stop()
    assert pieces == want
    for p, out in zip(pieces, outs):
        assert all(isinstance(x, str) and x for x in p)
        assert "".join(p) == out["text"] == ByteTokenizer().decode(out["tokens"])
    if mode != "plain":
        assert eng.counters["spec_proposed"] > 0


@pytest.mark.parametrize("mode", ["plain", "spec_paged"])
def test_ids_stream_without_a_tokenizer_and_eos_is_not_streamed(text_model, mode):
    eng = _port_engine(text_model, tokenizer=False, **MODES[mode])
    try:
        full = eng.generate([5, 9, 2], max_new_tokens=12, timeout=300)["tokens"]
        assert list(eng.generate([5, 9, 2], max_new_tokens=12, timeout=300, stream=True)) == full
        eos = full[6]
        cut = full[:full.index(eos)]
        streamed = list(eng.generate([5, 9, 2], max_new_tokens=12, timeout=300, stream=True,
                                     eos_token_id=eos))
        assert streamed == cut and all(isinstance(t, int) for t in streamed)
    finally:
        eng.stop()


@pytest.mark.parametrize("mode", list(MODES))
def test_a_stream_equals_its_own_result(text_model, mode):
    """The ids a stream yields are the tokens of that same request's
    result, and its pieces joined are that result's text."""
    for tokenizer in (False, True):
        eng = _port_engine(text_model, tokenizer=tokenizer, **MODES[mode])
        try:
            it = eng.generate([5, 9, 2, 5, 9], max_new_tokens=N_NEW, timeout=300, stream=True)
            items = list(it)
            out = it.result()
        finally:
            eng.stop()
        if tokenizer:
            assert "".join(items) == out["text"]
        else:
            assert items == out["tokens"] and len(items) == N_NEW


def test_a_split_character_is_held_until_it_completes(text_model):
    """Driven through ``_emit`` on a fabricated slot (model outputs are
    random): the first byte of "é" puts nothing on the stream, the second
    puts "é"."""
    from gofr_tpu_torch.gpu.engine import Request, _Slot
    from gofr_tpu_torch.utils.tokenizer import ByteTokenizer

    eng = _port_engine(text_model)
    tok = ByteTokenizer()
    try:
        req = Request([1], {"max_new_tokens": 8, "temperature": 0.0}, None, stream=True)
        slot = _Slot(req, np.array([1]), 64, None, 0)
        first, second = tok.encode("é")
        eng._emit(slot, first)
        with pytest.raises(queue.Empty):
            req.stream_q.get_nowait()
        eng._emit(slot, second)
        assert req.stream_q.get_nowait() == "é"
        eng._emit(slot, tok.encode("x")[0])
        assert req.stream_q.get_nowait() == "x"
    finally:
        eng.stop()


@pytest.mark.parametrize("mode", ["plain", "spec_slot"])
def test_cancel_mid_stream_frees_the_slot(text_model, mode):
    from gofr_tpu_torch.gpu.engine import RequestCancelled

    eng = _port_engine(text_model, tokenizer=False, slots=1, **{**MODES[mode], "decode_chunk": 1})
    try:
        it = eng.generate([1, 2, 3, 4, 5], max_new_tokens=50, timeout=120, stream=True)
        assert isinstance(next(it), int)
        it.cancel()
        with pytest.raises(RequestCancelled):
            for _ in it:
                pass
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(s is not None for s in eng.slots):
            time.sleep(0.02)
        assert all(s is None for s in eng.slots), "cancel left the slot taken"
        # the slot serves the next request
        assert len(eng.generate([7, 8], max_new_tokens=3, timeout=120)["tokens"]) == 3
    finally:
        eng.stop()


def test_a_per_token_timeout_raises_and_frees_the_slot(text_model):
    from gofr_tpu_torch.gpu.engine import RequestTimeout

    eng = _port_engine(text_model, tokenizer=False, slots=1)
    try:
        it = eng.generate([1, 2, 3], max_new_tokens=40, timeout=1e-4, stream=True)
        with pytest.raises(RequestTimeout):
            list(it)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and any(s is not None for s in eng.slots):
            time.sleep(0.02)
        assert all(s is None for s in eng.slots)
        assert len(eng.generate([7, 8], max_new_tokens=3, timeout=120)["tokens"]) == 3
    finally:
        eng.stop()
