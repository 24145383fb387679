"""The port's weight-only int8 (gofr_tpu_torch.ops.quant ``QTensor`` /
``quantize`` / ``qdot`` / ``quantize_tree`` / ``quantized_bytes``, the
Llama's ``QLinear`` sites, ``build_engine(quantize="int8")``) held against
the JAX package's (gofr_tpu/ops/quant.py, ``build_engine(quantize=
"int8")``).

Inputs come from numpy seeds, the tiny Llama's weights from
``gofr_tpu.models.llama.init``; JAX runs on the CPU. Tolerances:
``quantize`` is bit-exact (int8 codes and f32 scales); ``qdot`` within
1e-4 in f32 (the two frameworks sum in different orders) and within one
bf16 ulp of the output's largest magnitude in bf16 (two roundings to
bf16 that a different f32 sum can move by an ulp); the tiny int8 Llama's
f32 logits within 1e-4 of JAX's; greedy tokens equal, exactly. The W8A16
kernel itself runs only on a card (``cuda`` marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

CACHES = [("paged", ""), ("paged", "int8"), ("paged", "int4"), ("slot", ""), ("slot", "int8")]
CACHE_IDS = ["bf16", "int8", "int4", "slot_bf16", "slot_int8"]
PROMPTS = [[5, 3, 9], list(range(1, 14)), [42, 17], [7] * 20, [200, 100, 50, 25, 12, 6],
           list(range(30, 70))]
N_NEW = 7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny config, its weights (key 7) and their JAX int8 tree."""
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu.ops.quant import quantize_tree

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    return jcfg, params, jax.jit(quantize_tree)(params)


def _weight(seed, shape, dtype):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.05
    w[1] = 0.0  # an all-zero output channel: scale 1e-8, codes 0
    w[2, 3] = 0.9  # a channel whose max is one element: its code reaches 127
    return jnp.asarray(w).astype(dtype)


# -- quantize / qdot ---------------------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_is_bit_exact_against_jax(dtype):
    """JAX quantizes [in, out] over axis -2; the port [out, in] over the
    last axis: the same codes, and the same scales bit for bit."""
    from gofr_tpu.ops.quant import quantize as jax_quantize
    from gofr_tpu_torch.models.llama import tensor_from_numpy
    from gofr_tpu_torch.ops.quant import quantize

    w = _weight(0, (96, 40), dtype)
    want = jax_quantize(w)
    got = quantize(tensor_from_numpy(np.asarray(w)).T)
    assert got.q.dtype == torch.int8 and got.s.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q).T)
    np.testing.assert_array_equal(got.s.numpy().view(np.uint32),
                                  np.asarray(want.s)[0].view(np.uint32))
    assert got.q[2].abs().max().item() == 127 and not got.q[:, 1].any()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_qdot_equals_jax(dtype):
    from gofr_tpu.ops.quant import qdot as jax_qdot
    from gofr_tpu.ops.quant import quantize as jax_quantize
    from gofr_tpu_torch.models.llama import tensor_from_numpy
    from gofr_tpu_torch.ops.quant import QTensor, qdot, quantize

    w = _weight(1, (128, 48), dtype)
    x = jnp.asarray(np.random.default_rng(2).standard_normal((3, 5, 128)).astype(np.float32)
                    ).astype(dtype)
    want = np.asarray(jax_qdot(x, jax_quantize(w)).astype(jnp.float32))
    xt = tensor_from_numpy(np.asarray(x))
    wq = quantize(tensor_from_numpy(np.asarray(w)).T)
    got = qdot(xt, wq)
    assert got.dtype == xt.dtype and got.shape == (3, 5, 48)
    got = got.float().numpy()
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp
    # a plain weight is F.linear
    wt = tensor_from_numpy(np.asarray(w)).T
    assert torch.equal(qdot(xt, wt), torch.nn.functional.linear(xt, wt))
    assert isinstance(wq, QTensor) and wq.q.shape == (48, 128) and wq.s.shape == (48,)


# -- the tree ----------------------------------------------------------------------------


@pytest.mark.quick
def test_quantize_tree_leaves_its_input_and_counts_the_jax_bytes(tiny):
    from gofr_tpu.ops.quant import quantized_bytes as jax_bytes
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax
    from gofr_tpu_torch.ops.quant import QLinear, quantize_tree, quantized_bytes

    _, params, qparams = tiny
    model = params_from_jax(LlamaConfig.tiny(), _np(params), device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qmodel = quantize_tree(model)
    # the input is untouched: same modules, same tensors, same values
    assert all(isinstance(b.wq, torch.nn.Linear) for b in model.blocks)
    assert isinstance(model.lm_head, torch.nn.Linear)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    for blk in qmodel.blocks:
        assert all(isinstance(getattr(blk, n), QLinear)
                   for n in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
    assert isinstance(qmodel.lm_head, QLinear)
    # the embedding and norms are shared, not copied
    assert qmodel.embed is model.embed and qmodel.blocks[0].attn_norm is model.blocks[0].attn_norm
    assert quantized_bytes(qmodel) == jax_bytes(qparams)
    assert quantized_bytes(model) == jax_bytes(params)


def test_a_tied_head_stays_the_embedding():
    from gofr_tpu_torch.models.llama import LlamaConfig, init
    from gofr_tpu_torch.ops.quant import QLinear, quantize_tree

    model = init(LlamaConfig.tiny(tie_embeddings=True), torch.Generator().manual_seed(1), "cpu")
    qmodel = quantize_tree(model)
    assert qmodel.lm_head is None and qmodel.embed is model.embed
    assert isinstance(qmodel.blocks[1].w_down, QLinear)
    tokens = torch.tensor([[3, 1, 4, 1, 5]])
    assert qmodel.forward(tokens).shape == (1, 5, 256)


def test_llama3_8b_holds_8561882112_bytes_in_int8():
    """The slice's figure, from the shapes alone (meta tensors): int8 block
    weights and head, f32 scales, the bf16 embedding and norms; bf16 is
    16,060,522,496 B."""
    from gofr_tpu_torch.models.llama import Llama, LlamaConfig
    from gofr_tpu_torch.ops.quant import quantize_tree, quantized_bytes

    model = Llama(LlamaConfig.llama3_8b(), "meta")
    assert quantized_bytes(model) == 16_060_522_496
    assert quantized_bytes(quantize_tree(model)) == 8_561_882_112


@pytest.mark.quick
def test_params_from_jax_carries_the_jax_int8_tree_bit_for_bit(tiny):
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax
    from gofr_tpu_torch.ops.quant import QLinear

    _, _, qparams = tiny
    model = params_from_jax(LlamaConfig.tiny(), _np(qparams), device="cpu")
    blocks = qparams["blocks"]
    for layer, blk in enumerate(model.blocks):
        for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            lin = getattr(blk, name)
            assert isinstance(lin, QLinear)
            np.testing.assert_array_equal(lin.q.numpy(), np.asarray(blocks[name].q[layer]).T)
            np.testing.assert_array_equal(lin.s.numpy().view(np.uint32),
                                          np.asarray(blocks[name].s[layer, 0]).view(np.uint32))
            assert lin.q.is_contiguous()
    np.testing.assert_array_equal(model.lm_head.q.numpy(), np.asarray(qparams["lm_head"].q).T)
    np.testing.assert_array_equal(model.embed.numpy(), np.asarray(qparams["embed"]))


def test_the_port_quantizing_equals_the_jax_tree(tiny):
    """The port's ``quantize_tree`` of the raw weights holds the same codes
    and scales as ``params_from_jax`` of JAX's ``quantize_tree`` run
    eagerly. (Under ``jax.jit``, as ``build_engine`` runs it, XLA turns the
    division by 127 into a multiply by its reciprocal, and a few scales
    move by an ulp; the port divides, on either device.)"""
    from gofr_tpu.ops.quant import quantize_tree as jax_quantize_tree
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax
    from gofr_tpu_torch.ops.quant import quantize_tree

    _, params, _ = tiny
    mine = quantize_tree(params_from_jax(LlamaConfig.tiny(), _np(params), device="cpu"))
    theirs = params_from_jax(LlamaConfig.tiny(), _np(jax_quantize_tree(params)), device="cpu")
    a, b = mine.state_dict(), theirs.state_dict()
    assert set(a) == set(b)
    assert all(torch.equal(a[k].view(torch.int32) if a[k].dtype == torch.float32 else a[k],
                           b[k].view(torch.int32) if b[k].dtype == torch.float32 else b[k])
               for k in a)


def test_int8_logits_equal_the_jax_qdot_model(tiny):
    from gofr_tpu.models import llama
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax

    jcfg, _, qparams = tiny
    tokens = np.random.default_rng(3).integers(0, 256, (2, 12)).astype(np.int32)
    want = np.asarray(llama.forward(jcfg, qparams, jnp.asarray(tokens)))
    model = params_from_jax(LlamaConfig.tiny(), _np(qparams), device="cpu")
    got = model.forward(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


# -- the engine --------------------------------------------------------------------------


def _jax_engine(tiny, params=None, **kw):
    from gofr_tpu.container import new_mock_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine

    jcfg, _, qparams = tiny
    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    return JaxEngine(llama, jcfg, qparams if params is None else params, new_mock_container(),
                     **kw)


def _port_engine(params, **kw):
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig

    kw.setdefault("slots", 4)
    kw.setdefault("max_len", 64)
    kw.setdefault("max_prefill_batch", 2)
    return build_engine(LlamaConfig.tiny(), params=_np(params), device="cpu", **kw)


def _serve(eng, prompts=PROMPTS, jobs=None, n_new=N_NEW):
    jobs = jobs or [(p, None) for p in prompts]
    reqs = [eng.submit(p, max_new_tokens=n_new, adapter_id=a) for p, a in jobs]
    return [r.result(timeout=300)["tokens"] for r in reqs]


def _run(eng, **kw):
    try:
        return _serve(eng, **kw)
    finally:
        eng.stop()


@pytest.mark.parametrize("kv_layout,kv_quantize", CACHES, ids=CACHE_IDS)
def test_int8_greedy_tokens_equal_the_jax_engine_on_every_cache(tiny, kv_layout, kv_quantize):
    """The JAX engine on its int8 tree against the port started from that
    tree, and the port quantizing the raw weights itself (``quantize=
    "int8"``): the same greedy tokens, prompts up to 40 tokens (chunked
    past the 32 bucket) served at once."""
    _, params, qparams = tiny
    kw = dict(kv_layout=kv_layout, kv_quantize=kv_quantize)
    if kv_layout == "paged":
        kw["page_size"] = 8
    want = _run(_jax_engine(tiny, **kw))
    eng = _port_engine(qparams, **kw)
    assert type(eng.model.blocks[0].wq).__name__ == "QLinear"
    assert _run(eng) == want
    assert _run(_port_engine(params, quantize="int8", **kw)) == want


@pytest.mark.parametrize("kv_layout,draft", [("paged", False), ("slot", True)],
                         ids=["paged_lookup", "slot_draft"])
def test_int8_speculative_tokens_equal_the_jax_engine(tiny, kv_layout, draft):
    """``spec_tokens=2``: prompt lookup on the pool, and on the slot cache a
    draft model (the raw f32 weights, never quantized) proposing for the
    int8 target. Both engines at depth 1."""
    from gofr_tpu.models import llama
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax
    from gofr_tpu_torch.ops.quant import QLinear

    jcfg, params, qparams = tiny
    kw = dict(kv_layout=kv_layout, spec_tokens=2)
    if kv_layout == "paged":
        kw["page_size"] = 8
    jkw = dict(kw, spec_draft=(llama, jcfg, params)) if draft else kw
    want = _run(_jax_engine(tiny, decode_pipeline=1, **jkw))
    pkw = dict(kw, pipeline_depth=1)
    if draft:
        pkw["spec_draft"] = (LlamaConfig.tiny(), params_from_jax(LlamaConfig.tiny(), _np(params),
                                                                 device="cpu"))
    eng = _port_engine(params, quantize="int8", **pkw)
    assert isinstance(eng.model.blocks[0].wq, QLinear)
    if draft:
        # the draft stays in its dtype
        assert isinstance(eng._aux.model.blocks[0].wq, torch.nn.Linear)
        assert isinstance(eng._aux.model.lm_head, torch.nn.Linear)
    assert _run(eng) == want


def test_int8_tokens_with_adapters_mixed_equal_the_jax_engine(tiny):
    """Base and three adapters in turn on the int8 target (the delta at the
    head, after the int8 head product)."""
    import gofr_tpu.adapters as jad
    import gofr_tpu_torch.adapters as pad

    kw = dict(page_size=8, adapter_slots=4, adapter_rank=8)
    names = [None, "ad0", "ad1", "ad2"]
    jobs = [(p, names[i % 4]) for i, p in enumerate(PROMPTS)]

    def specs(module):
        return [module.random_adapter(f"ad{i}", 64, 256, rank=2 + 2 * i, seed=10 + i)
                for i in range(3)]

    results = []
    for module, eng in ((jad, _jax_engine(tiny, **kw)),
                        (pad, _port_engine(tiny[1], quantize="int8", **kw))):
        for spec in specs(module):
            eng.register_adapter(spec)
        results.append(_run(eng, jobs=jobs))
    assert results[1] == results[0]
    # the adapters move the tokens
    assert results[1] != _run(_port_engine(tiny[1], quantize="int8", page_size=8))


@pytest.mark.parametrize("form", ["tree", "llama"])
def test_adopting_raw_bf16_weights_into_an_int8_engine_equals_an_int8_build(form):
    """A bf16 engine serving int8 adopts a raw bf16 tree (numpy, as JAX
    hands it) or a bf16 ``Llama``: it quantizes them first, copies the
    codes and scales in place, and then serves what an int8 engine built on
    the new weights serves."""
    from gofr_tpu.models import LlamaConfig as JaxConfig
    from gofr_tpu.models import llama
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import LlamaConfig, params_from_jax

    cfg = LlamaConfig.tiny(dtype=torch.bfloat16)
    jcfg = JaxConfig.tiny(dtype=jnp.bfloat16)
    old, new = (_np(llama.init(jcfg, jax.random.key(k))) for k in (7, 99))
    kw = dict(device="cpu", slots=4, max_len=64, page_size=8, quantize="int8")
    eng = build_engine(cfg, params=old, **kw)
    try:
        q_ptr = eng.model.blocks[0].wq.q.data_ptr()
        before = _serve(eng)
        replacement = new if form == "tree" else params_from_jax(cfg, new, device="cpu")
        assert eng.adopt_weights(replacement) == 1
        assert eng.model.blocks[0].wq.q.data_ptr() == q_ptr
        after = _serve(eng)
    finally:
        eng.stop()
    want = _run(build_engine(cfg, params=new, **kw))
    assert after == want and after != before
    if form == "llama":
        # the replacement itself stays bf16
        assert isinstance(replacement.blocks[0].wq, torch.nn.Linear)


def test_adoption_into_an_int8_engine_equals_the_jax_engine_s(tiny):
    """A raw tree adopted by an int8 engine: the JAX engine quantizes it on
    its checkpoint path (``_prepare_weights``; its in-memory
    ``adopt_weights`` takes only a tree of the serving structure), the port
    inside ``adopt_weights``. The same tokens after the swap, and the port
    takes the JAX int8 tree of the same weights as it is."""
    from gofr_tpu.models import llama

    jcfg, _, _ = tiny
    new = _np(llama.init(jcfg, jax.random.key(99)))
    jeng = _jax_engine(tiny, kv_layout="paged", page_size=8)
    try:
        _serve(jeng, prompts=PROMPTS[:2])
        jeng.adopt_weights(jeng._prepare_weights(new))
        want = _serve(jeng)
        jax_int8_tree = _np(jeng.params)
    finally:
        jeng.stop()
    for replacement in (new, jax_int8_tree):
        eng = _port_engine(tiny[2], page_size=8)
        try:
            _serve(eng, prompts=PROMPTS[:2])
            eng.adopt_weights(replacement)
            assert _serve(eng) == want
        finally:
            eng.stop()


def test_an_unknown_quantize_mode_raises():
    from gofr_tpu_torch.gpu.engine import build_engine

    with pytest.raises(ValueError, match="only 'int8' is supported"):
        build_engine("tiny", device="cpu", quantize="fp4")


# -- the kernel's launcher (on the CPU) -------------------------------------------------


@pytest.mark.quick
def test_the_plan_gives_the_blocks_the_kernel_source_states():
    """``plan`` at Llama-3-8B's decode shapes (M = 8): the bands of 64
    channels times the splits are the block counts ``csrc/w8a16.cu``
    states; more than 64 rows take the tiles; a split never stages more X
    than 48 KB and covers every chunk of K."""
    from gofr_tpu_torch.ops.cuda import w8a16 as mod

    blocks = {(4096, 4096): 320, (1024, 4096): 256, (14336, 4096): 448, (4096, 14336): 320,
              (128256, 4096): 2004}
    for (n, k), want in blocks.items():
        splits, per_split, stage = mod.plan(8, n, k)
        assert -(-n // mod.BAND) * splits == want
    assert mod.plan(65, 4096, 4096) == (0, 0, 0) and mod.plan(2048, 128256, 4096) == (0, 0, 0)
    for m in (1, 8, 40, 64):
        for n, k in [(1000, 4112), (64, 16), *blocks]:
            splits, per_split, stage = mod.plan(m, n, k)
            chunks = -(-k // mod.CHUNK)
            assert (splits - 1) * per_split < chunks <= splits * per_split
            assert 1 <= stage <= per_split
            assert -(-m // 8) * 8 * (stage * mod.CHUNK + mod.X_PAD) * 2 <= mod.X_SMEM


@pytest.mark.quick
def test_the_launcher_declares_the_c_entry_point_s_arguments(monkeypatch):
    """The ctypes argument list matches ``gofr_w8a16`` in csrc/w8a16.cu, and
    a call with the checks and the C call stubbed passes the plan's ints
    (a scratch of f32 [splits, M, N] when K is split) and counts one
    launch."""
    import ctypes
    import re

    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import w8a16 as mod

    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int}
    source = (cuda.CSRC / "w8a16.cu").read_text()
    (name, params), = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source)
    assert name == "gofr_w8a16"
    assert [c_types[" ".join(p.split()[:-1])] for p in params.split(",")] == mod._ARGTYPES
    calls = []
    monkeypatch.setattr(cuda, "require", lambda cond, msg: None)
    monkeypatch.setattr(cuda, "bind", lambda name, argtypes: lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(mod.w8a16, "launches", 0)
    for m, n, k in ((8, 1024, 4096), (8, 14336, 64), (300, 96, 32)):
        x = torch.zeros(1, m, k, dtype=torch.bfloat16)
        out = mod.w8a16(x, torch.zeros(n, k, dtype=torch.int8), torch.zeros(n))
        assert out.shape == (1, m, n) and out.dtype == torch.bfloat16
        args = calls[-1]
        assert len(args) == len(mod._ARGTYPES)
        assert args[5:11] == (m, n, k, *mod.plan(m, n, k))
        # the f32 scratch goes with a split alone
        assert (args[4] is None) == (mod.plan(m, n, k)[0] <= 1)
    assert mod.w8a16.launches == 3


@pytest.mark.quick
def test_the_launcher_refuses_cpu_tensors_and_qdot_routes_by_device():
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda.w8a16 import w8a16
    from gofr_tpu_torch.ops.quant import qdot, quantize

    cuda.reset_launch_counts()
    w = quantize(torch.randn(32, 48))
    x = torch.randn(3, 48).to(torch.bfloat16)
    with pytest.raises(ValueError, match="on the card"):
        w8a16(x, w.q, w.s)
    assert qdot(x, w).shape == (3, 32)  # the CPU takes the plain version
    assert cuda.launch_counts()["w8a16"] == 0


# -- the kernel (on the card only) --------------------------------------------------------


@pytest.mark.cuda
def test_w8a16_matches_qdot_plain_at_every_launcher_branch_on_the_card():
    """The weight stream without a split and with one, the tiles, a ragged
    N and a K tail of 16, each against ``qdot_plain`` on the same bf16
    inputs within the launcher's limits; ``quantize`` on the card bit for
    bit as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops.cuda import w8a16 as mod

    gen = torch.Generator().manual_seed(5)
    cases = {"stream": (8, 14336, 4096), "stream_split": (8, 1024, 4096),
             "stream_40": (40, 4096, 4096), "tiles": (300, 1024, 4096),
             "ragged_n": (5, 1000, 4096), "tiles_ragged": (129, 1000, 1040),
             "k_tail": (8, 256, 4112)}
    assert mod.plan(*cases["stream"])[0] == 2 and mod.plan(*cases["stream_split"])[0] > 1
    assert mod.plan(*cases["tiles"])[0] == 0
    # the plain version's reference: cuBLAS reduces split-K sums in f32
    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        _check_cases(cases, gen)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced


def _check_cases(cases, gen):
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda import w8a16 as mod
    from gofr_tpu_torch.ops.quant import qdot, qdot_plain, quantize

    for name, (m, n, k) in cases.items():
        w = torch.randn(n, k, generator=gen) * k ** -0.5
        wq = quantize(w)
        wq_card = quantize(w.cuda())
        assert torch.equal(wq_card.q.cpu(), wq.q), name
        assert torch.equal(wq_card.s.cpu().view(torch.int32), wq.s.view(torch.int32)), name
        x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
        cuda.reset_launch_counts()
        got = qdot(x, wq_card)
        assert cuda.launch_counts()["w8a16"] == 1, name
        want = qdot_plain(x, wq_card)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        assert diff.max().item() <= mod.MAX_REL * want.float().abs().max().item(), name
        assert (got != want).float().mean().item() <= mod.MISMATCH_SHARE, name
