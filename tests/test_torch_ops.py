"""The PyTorch port's ops (gofr_tpu_torch.ops) held against the JAX package.

Inputs come from a numpy seed and go through both the JAX function and its
port. The Pallas kernels run as tests/test_pallas.py runs them, under the
interpreter (``interpret=True``); on the CPU the port's kernel wrappers take
their plain PyTorch versions because the tensors lie on the CPU. Tests of
the CUDA kernels themselves carry the ``cuda`` marker and skip without a
card.

Tolerances: f32 attention and norms are held to 2e-5 (the two frameworks
sum in different orders); pool writes and sampling masks are held to exact
equality.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
ATOL = 2e-5
_KERNELS = ("paged_decode", "paged_decode_d64", "kv_append", "kv_append_d64", "flash_attention",
            "flash_attention_d64", "flash_attention_f32", "flash_attention_d64_f32",
            "paged_decode_q", "paged_decode_q_d64", "paged_decode_q4",
            "paged_decode_q4_d64", "decode_attention", "decode_attention_d64",
            "decode_attention_f32", "decode_attention_d64_f32", "kv_append_slot",
            "kv_append_slot_d64", "kv_append_slot_f32", "kv_append_slot_d64_f32", "kv_append_q",
            "kv_append_q_d64", "kv_append_q4", "kv_append_q4_d64", "kv_append_slot_q",
            "kv_append_slot_q_d64", "paged_decode_f32", "paged_decode_d64_f32", "kv_append_f32",
            "kv_append_d64_f32", "paged_decode_q_f32", "paged_decode_q_d64_f32", "kv_append_q_f32",
            "kv_append_q_d64_f32", "paged_decode_q4_f32", "paged_decode_q4_d64_f32",
            "kv_append_q4_f32", "kv_append_q4_d64_f32", "kv_append_slot_q_f32",
            "kv_append_slot_q_d64_f32", "w8a16", "w8a16_f32")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# -- import discipline -----------------------------------------------------------


def _port_files():
    """The port's package, its example and the card-side script."""
    files = (sorted((REPO / "gofr_tpu_torch").rglob("*.py"))
             + sorted((REPO / "examples" / "serving-llm-torch").rglob("*.py"))
             + [REPO / "chip_smoke.py"])
    assert len(files) > 10 and REPO / "examples" / "serving-llm-torch" / "main.py" in files
    return files


@pytest.mark.quick
def test_port_imports_nothing_of_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import\s+(jax|gofr_tpu)\b|from\s+(jax|gofr_tpu)[\s.])", re.M)
    offenders = [str(p.relative_to(REPO)) for p in _port_files() if bad.search(p.read_text())]
    assert not offenders, f"port files importing jax / gofr_tpu: {offenders}"


@pytest.mark.quick
def test_port_imports_no_http_library_outside_the_stdlib():
    """The port depends on no HTTP library outside the standard library:
    it serves on asyncio's streams (http/server.py), and chip_smoke.py's
    client is http.client. aiohttp and httpx are not forbidden for want of
    them on the card, where both import; the port simply needs neither."""
    bad = re.compile(r"^\s*(import\s+(aiohttp|httpx)\b|from\s+(aiohttp|httpx)[\s.])", re.M)
    offenders = [str(p.relative_to(REPO)) for p in _port_files() if bad.search(p.read_text())]
    assert not offenders, f"port files importing aiohttp / httpx: {offenders}"


@pytest.mark.quick
def test_entry_points_raise_without_a_card_unless_cpu_is_asked():
    from gofr_tpu_torch.gpu.device import resolve_device
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models.llama import Llama, LlamaConfig

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert resolve_device("cpu").type == "cpu"
    from gofr_tpu_torch.app import new_testing
    from gofr_tpu_torch.models import ModelSpec

    spec = ModelSpec("llama", LlamaConfig.tiny(), dtype=torch.float32)
    for call in (resolve_device, lambda: Llama(LlamaConfig.tiny()),
                 lambda: build_engine("tiny"),
                 lambda: new_testing().serve_model("lm", spec)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.quick
def test_build_commands_target_sm90a_one_nvcc_per_source():
    from gofr_tpu_torch.ops import cuda

    cmds = cuda.compile_commands()
    names = {p.name for p in cuda.sources()}
    assert {"paged_decode.cu", "kv_append.cu", "flash_attention.cu", "paged_decode_q.cu"} <= names
    assert len(cmds) == len(names) + 1  # one compile per source, then the link
    for cmd in cmds:
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmds[-1][-1].startswith(str(cuda.LIBRARY))
    assert (cuda.CSRC / "online_softmax.cuh").exists()


# -- leaf ops --------------------------------------------------------------------


@pytest.mark.quick
def test_rms_norm_matches_jax():
    from gofr_tpu.ops.norms import rms_norm as jax_rms
    from gofr_tpu_torch.ops.norms import rms_norm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = np.asarray(jax_rms(jnp.asarray(x), jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(rms_norm(_t(x), _t(w), 1e-5).numpy(), want, atol=ATOL, rtol=ATOL)


def test_rope_matches_jax():
    from gofr_tpu.ops.rope import apply_rope as jax_apply, rope_table as jax_table
    from gofr_tpu_torch.ops.rope import apply_rope, rope_table

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 100, (2, 7))
    jc, js = jax_table(128, 32, theta=5e5)
    tc, ts = rope_table(128, 32, theta=5e5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    want = np.asarray(jax_apply(jnp.asarray(x), jnp.asarray(pos), jc, js))
    np.testing.assert_allclose(apply_rope(_t(x), _t(pos), tc, ts).numpy(), want,
                               atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (10, 0.5), (0, 0.0)])
def test_truncate_logits_mask_equals_jax(top_k, top_p):
    from gofr_tpu.ops.sampling import truncate_logits as jax_trunc
    from gofr_tpu_torch.ops.sampling import NEG_INF, truncate_logits

    logits = np.random.default_rng(2).standard_normal((6, 50)).astype(np.float32) * 3
    want = np.asarray(jax_trunc(jnp.asarray(logits), top_k, top_p)) <= NEG_INF / 2
    got = truncate_logits(_t(logits), top_k, top_p).numpy() <= NEG_INF / 2
    np.testing.assert_array_equal(got, want)


def test_sample_token_greedy_rows_and_distribution():
    from gofr_tpu_torch.ops.sampling import sample_token

    rng = np.random.default_rng(3)
    base = rng.standard_normal(8).astype(np.float32)
    n = 8000
    logits = _t(np.tile(base, (n, 1)))
    temps = torch.ones(n)
    temps[:10] = 0.0
    gen = torch.Generator().manual_seed(0)
    out = sample_token(logits, gen, temperature=temps).numpy()
    assert (out[:10] == base.argmax()).all()
    freq = np.bincount(out[10:], minlength=8) / (n - 10)
    p = np.exp(base - base.max())
    p /= p.sum()
    # 8000 draws: each frequency within ~5 standard errors of its probability
    assert np.all(np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / (n - 10)) + 1e-3)
    # top_k=1 is greedy whatever the temperature
    assert (sample_token(logits[:20], gen, temperature=2.0, top_k=1).numpy() == base.argmax()).all()


# -- attention vs the Pallas kernels (interpret mode) --------------------------------


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)))


@pytest.mark.parametrize("case", ["causal", "q_offset", "kv_lengths", "fully_masked", "gqa"])
def test_mha_attention_matches_pallas_flash(case):
    from gofr_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
    from gofr_tpu_torch.ops.attention import mha_attention

    b, sq, skv, hq, hkv, d = 2, 24, 40, 4, 4, 16
    if case == "gqa":
        hq, hkv = 8, 2
    q, k, v = _qkv(10, b, sq, skv, hq, hkv, d)
    kw_np = {}
    if case == "q_offset":
        kw_np = {"q_offset": np.array([16, 3], np.int32), "kv_lengths": np.array([40, 27], np.int32)}
    elif case == "kv_lengths":
        kw_np = {"kv_lengths": np.array([40, 9], np.int32)}
    elif case == "fully_masked":
        kw_np = {"kv_lengths": np.array([0, 13], np.int32)}
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                   interpret=True, **{a: jnp.asarray(x) for a, x in kw_np.items()}))
    got = mha_attention(_t(q), _t(k), _t(v), causal=True,
                        **{a: _t(x) for a, x in kw_np.items()}).numpy()
    assert not np.isnan(got).any()
    if case == "fully_masked":
        assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def _pool_case(seed, pool=12, hkv=2, page=8, d=16, n=4, maxp=4):
    """A pool, ragged lengths (one empty slot) and tables with OOB entries."""
    rng = np.random.default_rng(seed)
    k_pool = rng.standard_normal((pool, hkv, page, d)).astype(np.float32)
    v_pool = rng.standard_normal((pool, hkv, page, d)).astype(np.float32)
    table = np.full((n, maxp), pool, np.int32)  # OOB == pool size
    lengths = np.array([29, 0, 8, 13], np.int32)[:n]
    perm = rng.permutation(pool)
    used = 0
    for i, ln in enumerate(lengths):
        need = -(-int(ln) // page)
        table[i, :need] = perm[used:used + need]
        used += need
    return k_pool, v_pool, table, lengths


@pytest.mark.parametrize("hq", [2, 8])
def test_paged_decode_matches_pallas_kernel(hq):
    from gofr_tpu.ops.pallas.paged_decode import paged_decode_attention as pallas_paged
    from gofr_tpu_torch.ops.attention import paged_decode_attention

    k_pool, v_pool, table, lengths = _pool_case(20)
    q = np.random.default_rng(21).standard_normal((4, hq, 16)).astype(np.float32)
    want = np.asarray(pallas_paged(jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
                                   jnp.asarray(table), jnp.asarray(lengths), interpret=True))
    got = paged_decode_attention(_t(q), _t(k_pool), _t(v_pool), _t(table), _t(lengths)).numpy()
    assert np.all(got[1] == 0.0)  # the empty slot
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


def test_append_tokens_paged_matches_pallas_inplace_bytes():
    from gofr_tpu.ops.pallas.kv_append import append_tokens_paged_inplace
    from gofr_tpu_torch.ops.paged import append_tokens_paged

    k_pool, v_pool, table, _ = _pool_case(30)
    rng = np.random.default_rng(31)
    # a mid-page write, an OOB table entry, a position past the table, a
    # negative position
    positions = np.array([17, 9, 40, -1], np.int32)
    table[1, 1] = k_pool.shape[0]
    k_new = rng.standard_normal((4, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((4, 2, 16)).astype(np.float32)
    # page 0 is the TPU kernel's reserved sink: keep it out of every table
    table = np.where(table == 0, k_pool.shape[0], table)
    wk, wv = append_tokens_paged_inplace(
        jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(k_new), jnp.asarray(v_new), interpret=True)
    gk, gv = _t(k_pool.copy()), _t(v_pool.copy())
    append_tokens_paged(gk, gv, _t(table), _t(positions), _t(k_new), _t(v_new))
    np.testing.assert_array_equal(gk.numpy().view(np.uint32), np.asarray(wk).view(np.uint32))
    np.testing.assert_array_equal(gv.numpy().view(np.uint32), np.asarray(wv).view(np.uint32))
    assert not np.array_equal(gk.numpy(), k_pool)  # the valid write landed


@pytest.mark.parametrize("chunked", [False, True])
def test_write_prompts_and_gather_match_jax(chunked):
    from gofr_tpu.ops.paged import gather_kv as jax_gather, write_prompts_paged as jax_write
    from gofr_tpu_torch.ops.paged import gather_kv, write_prompts_paged

    k_pool, v_pool, table, _ = _pool_case(40)
    rng = np.random.default_rng(41)
    k_new = rng.standard_normal((4, 6, 2, 16)).astype(np.float32)
    v_new = rng.standard_normal((4, 6, 2, 16)).astype(np.float32)
    offsets = np.array([5, 0, 2, 7], np.int32) if chunked else None
    jo = None if offsets is None else jnp.asarray(offsets)
    wk, wv = jax_write(jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(table),
                       jnp.asarray(k_new), jnp.asarray(v_new), jo)
    gk, gv = _t(k_pool.copy()), _t(v_pool.copy())
    write_prompts_paged(gk, gv, _t(table), _t(k_new), _t(v_new),
                        None if offsets is None else _t(offsets))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    jk, _ = jax_gather(wk, wv, jnp.asarray(table))
    tk, _ = gather_kv(gk, gv, _t(table))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


@pytest.mark.quick
def test_wrappers_take_the_plain_path_on_cpu_without_counting():
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import mha_attention, paged_decode_attention
    from gofr_tpu_torch.ops.paged import append_tokens_paged

    cuda.reset_launch_counts()
    q, k, v = (_t(a) for a in _qkv(50, 1, 4, 4, 2, 2, 8))
    mha_attention(q, k, v)
    k_pool, v_pool, table, lengths = (_t(a) for a in _pool_case(51))
    paged_decode_attention(_t(np.ones((4, 2, 16), np.float32)), k_pool, v_pool, table, lengths)
    append_tokens_paged(k_pool, v_pool, table, lengths, k_pool[:4, :, 0], v_pool[:4, :, 0])
    assert cuda.launch_counts() == dict.fromkeys(_KERNELS, 0)


@pytest.mark.quick
def test_kernel_launchers_refuse_cpu_tensors():
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode

    cuda.reset_launch_counts()
    q, k, v = (_t(a) for a in _qkv(52, 1, 4, 4, 2, 2, 8))
    k_pool, v_pool, table, lengths = (_t(a) for a in _pool_case(53))
    calls = (lambda: flash_attention(q, k, v),
             lambda: paged_decode(_t(np.ones((4, 2, 16), np.float32)), k_pool, v_pool, table, lengths),
             lambda: kv_append(k_pool, v_pool, table, lengths, k_pool[:4, :, 0], v_pool[:4, :, 0]))
    for call in calls:
        with pytest.raises(ValueError, match="on the card"):
            call()
    assert cuda.launch_counts() == dict.fromkeys(_KERNELS, 0)


def _within(got, want, module):
    """The limits each kernel's launcher module states against its plain
    version: ``MAX_ABS`` on any element, ``RMS_REL`` on the RMS of the
    difference over the RMS of the output."""
    diff = got.float() - want.float()
    rel = diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()
    return diff.abs().max().item() <= module.MAX_ABS and rel.item() <= module.RMS_REL


# -- the CUDA kernels against their plain versions (on the card only) ---------------


@pytest.mark.cuda
def test_cuda_kernels_match_plain_on_the_card():
    _needs_card()
    from gofr_tpu_torch.ops.attention import (
        mha_attention_plain,
        paged_decode_attention_plain,
    )
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod
    from gofr_tpu_torch.ops.cuda import paged_decode as decode_mod
    from gofr_tpu_torch.ops.cuda.flash_attention import flash_attention
    from gofr_tpu_torch.ops.cuda.kv_append import kv_append
    from gofr_tpu_torch.ops.cuda.paged_decode import paged_decode
    from gofr_tpu_torch.ops.paged import append_tokens_paged_plain

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 100, 8, 128, device=dev, generator=g).to(bf)
    k = torch.randn(2, 100, 2, 128, device=dev, generator=g).to(bf)
    v = torch.randn(2, 100, 2, 128, device=dev, generator=g).to(bf)
    lens = torch.tensor([100, 37], device=dev)
    got = flash_attention(q, k, v, kv_lengths=lens)
    want = mha_attention_plain(q, k, v, kv_lengths=lens)
    assert _within(got, want, flash_mod)
    # live lengths of hundreds, as the limits were set at; OOB entries == 40
    pool = torch.randn(40, 2, 16, 128, device=dev, generator=g).to(bf)
    vpool = torch.randn(40, 2, 16, 128, device=dev, generator=g).to(bf)
    perm = torch.randperm(40, device=dev, generator=g).to(torch.int32)
    table = torch.full((3, 16), 40, device=dev, dtype=torch.int32)
    table[0, :15], table[1, :10] = perm[:15], perm[15:25]
    lengths = torch.tensor([230, 150, 0], device=dev, dtype=torch.int32)
    qd = torch.randn(3, 8, 128, device=dev, generator=g).to(bf)
    got = paged_decode(qd, pool, vpool, table, lengths)
    want = paged_decode_attention_plain(qd, pool, vpool, table, lengths)
    assert _within(got, want, decode_mod)
    assert torch.all(got[2] == 0)
    kn = torch.randn(3, 2, 128, device=dev, generator=g).to(bf)
    a, b = pool.clone(), vpool.clone()
    kv_append(a, b, table, lengths, kn, kn)
    c, d = pool.clone(), vpool.clone()
    append_tokens_paged_plain(c, d, table, lengths, kn, kn)
    assert torch.equal(a.view(torch.int16), c.view(torch.int16))
    assert torch.equal(b.view(torch.int16), d.view(torch.int16))


@pytest.mark.cuda
def test_flash_kernel_matches_plain_at_long_ragged_and_chunked_prefill():
    """The tensor-core flash kernel at the longest prefill the engine pads to
    (4 x 1024, causal, full and ragged with offsets) and on a chunked-prefill
    call: a chunk of 200 queries (not a multiple of the 64-row tile) after
    cached offsets, keys up to offset + chunk length (models/llama.py)."""
    _needs_card()
    from gofr_tpu_torch.ops.attention import mha_attention_plain
    from gofr_tpu_torch.ops.cuda import flash_attention as flash_mod

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(4, 1024, 32, 128, device=dev, generator=g).to(bf)
    k = torch.randn(4, 1024, 8, 128, device=dev, generator=g).to(bf)
    v = torch.randn(4, 1024, 8, 128, device=dev, generator=g).to(bf)
    offs = torch.tensor([0, 40, 0, 0], device=dev, dtype=torch.int32)
    lens = torch.tensor([1024, 700, 129, 0], device=dev, dtype=torch.int32)
    chunk_offs = torch.tensor([512, 300, 0, 824], device=dev, dtype=torch.int32)
    chunk_lens = chunk_offs + torch.tensor([200, 131, 77, 200], device=dev, dtype=torch.int32)
    for qq, kw in ((q, {}), (q, {"q_offset": offs, "kv_lengths": lens}),
                   (q[:, :200].contiguous(), {"q_offset": chunk_offs, "kv_lengths": chunk_lens})):
        got = flash_mod.flash_attention(qq, k, v, causal=True, **kw)
        assert _within(got, mha_attention_plain(qq, k, v, causal=True, **kw), flash_mod)
        if "kv_lengths" in kw and qq is q:
            assert torch.all(got[3] == 0)  # kv_length 0: every row fully masked
