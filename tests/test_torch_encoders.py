"""The port's encoder path (gofr_tpu_torch.ops.norms.layer_norm, kernel C's
plain version at head dim 64, models.bert, models.vit) held against the
JAX package on the CPU.

Inputs come from a numpy seed; the port's models hold the JAX models' own
weights (``params_from_jax`` of the JAX ``init`` tree). The Pallas flash
kernel runs under the interpreter, as tests/test_pallas.py runs it.

Tolerances: f32 throughout, 1e-4 absolute and relative (the parity
contract: the two frameworks sum in different orders); LayerNorm in bf16
is held to one bf16 ulp of its output. The card-only case (kernel C's
64 build against its plain version) carries the ``cuda`` marker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def bert_pair():
    """(JAX config, JAX params, the port's Bert on those weights)."""
    from gofr_tpu.models import BertConfig as JaxBertConfig, bert as jbert
    from gofr_tpu_torch.models import bert
    from gofr_tpu_torch.models.bert import BertConfig

    jcfg = JaxBertConfig.tiny()
    params = jbert.init(jcfg, jax.random.key(3))
    model = bert.params_from_jax(BertConfig.tiny(), jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, model


@pytest.fixture(scope="module")
def vit_pair():
    from gofr_tpu.models import ViTConfig as JaxViTConfig, vit as jvit
    from gofr_tpu_torch.models import vit
    from gofr_tpu_torch.models.vit import ViTConfig

    jcfg = JaxViTConfig.tiny()
    params = jvit.init(jcfg, jax.random.key(4))
    model = vit.params_from_jax(ViTConfig.tiny(), jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, model


@pytest.mark.quick
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_layer_norm_matches_jax(dtype):
    from gofr_tpu.ops.norms import layer_norm as jax_layer_norm
    from gofr_tpu_torch.ops.norms import layer_norm

    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 7, 48)) * 4 + 1.5).astype(np.float32)
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_layer_norm(jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
                                     1e-12).astype(jnp.float32))
    got = layer_norm(_t(x).to(tdt), _t(w).to(tdt), _t(b).to(tdt), 1e-12)
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    else:
        # one bf16 ulp of the output (2^-8 relative, 2^-7 below 1 in magnitude)
        np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -7, rtol=2 ** -7)


def _qkv(seed, b, s, h, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))


# BERT's call (keys padded by lengths, a padded batch row of length 1),
# ViT's (197 positions, no lengths: partial last tiles) and GPT-2's causal
# call with offsets, each at head dim 64
CASES = {
    "bert": dict(b=3, s=64, h=2, causal=False, kv_lengths=[64, 9, 1]),
    "vit": dict(b=2, s=197, h=2, causal=False),
    "gpt2_causal": dict(b=2, s=40, h=2, causal=True, q_offset=[0, 5], kv_lengths=[40, 31]),
}


@pytest.mark.quick
@pytest.mark.parametrize("case", list(CASES))
def test_mha_attention_at_head_dim_64_matches_pallas_flash(case):
    from gofr_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash
    from gofr_tpu_torch.ops.attention import mha_attention, mha_attention_plain

    c = dict(CASES[case])
    b, s, h, causal = c.pop("b"), c.pop("s"), c.pop("h"), c.pop("causal")
    q, k, v = _qkv(20 + len(case), b, s, h)
    kw = {name: np.asarray(val, np.int32) for name, val in c.items()}
    want = np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                                   interpret=True, **{n: jnp.asarray(x) for n, x in kw.items()}))
    for attend in (mha_attention, mha_attention_plain):  # the router takes the plain on the CPU
        got = attend(_t(q), _t(k), _t(v), causal=causal, **{n: _t(x) for n, x in kw.items()})
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.quick
def test_bert_encode_and_embed_pooled_match_jax(bert_pair):
    """Ragged rows padded to one bucket (a padded row of length 1, a full
    row, a row of 3), and token types given: hidden states and pooled
    embeddings as JAX computes them, the embeddings of unit norm."""
    from gofr_tpu.models import bert as jbert

    jcfg, params, model = bert_pair
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    lengths = np.array([16, 3, 1, 11], np.int32)
    types = rng.integers(0, 2, (4, 16)).astype(np.int32)
    want_h = np.asarray(jbert.encode(jcfg, params, jnp.asarray(tokens), jnp.asarray(lengths),
                                     jnp.asarray(types)))
    got_h = model.encode(_t(tokens).long(), _t(lengths), _t(types).long())
    np.testing.assert_allclose(got_h.numpy(), want_h, atol=TOL, rtol=TOL)
    want = np.asarray(jbert.embed_pooled(jcfg, params, jnp.asarray(tokens), jnp.asarray(lengths)))
    got = model.embed_pooled(_t(tokens).long(), _t(lengths))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)
    # the plain path on request is the same computation on the CPU
    torch.testing.assert_close(model.embed_pooled(_t(tokens).long(), _t(lengths), kernels=False),
                               got, atol=0, rtol=0)


@pytest.mark.quick
@pytest.mark.parametrize("num_classes", [10, 0])
def test_vit_patchify_and_forward_match_jax(num_classes):
    """Patches in the JAX order; logits in f32 (or the CLS embedding when
    the config has no head), on the JAX model's weights."""
    from gofr_tpu.models import ViTConfig as JaxViTConfig, vit as jvit
    from gofr_tpu_torch.models import vit
    from gofr_tpu_torch.models.vit import ViTConfig

    jcfg = JaxViTConfig.tiny(num_classes=num_classes)
    params = jvit.init(jcfg, jax.random.key(6))
    cfg = ViTConfig.tiny(num_classes=num_classes)
    model = vit.params_from_jax(cfg, jax.tree.map(np.asarray, params), "cpu")
    images = np.random.default_rng(7).standard_normal((3, 32, 32, 3)).astype(np.float32)
    np.testing.assert_array_equal(vit.patchify(cfg, _t(images)).numpy(),
                                  np.asarray(jvit.patchify(jcfg, jnp.asarray(images))))
    want = np.asarray(jvit.forward(jcfg, params, jnp.asarray(images)))
    got = model(_t(images))
    assert got.dtype == torch.float32 and got.shape == (3, num_classes or cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.quick
@pytest.mark.parametrize("family", ["bert", "vit"])
def test_init_draws_the_jax_tree_s_shapes_at_its_scales(family):
    """Random weights fill every tensor of the JAX tree (transposed where
    it is a linear), biases and the CLS token zero, norms one."""
    from gofr_tpu.models import get_family as jax_family
    from gofr_tpu_torch.models import get_family

    fam, jfam = get_family(family), jax_family(family)
    cfg = fam.CONFIG.tiny()
    jparams = jax.tree.map(np.asarray, jfam.init(jfam.__dict__[type(cfg).__name__].tiny(),
                                                 jax.random.key(0)))
    model = fam.init(cfg, torch.Generator().manual_seed(0), "cpu")
    ref = fam.params_from_jax(cfg, jparams, "cpu")
    for (name, got), (_, want) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert got.shape == want.shape, name
        if name.endswith(".bias") or name == "cls_token" or name.endswith("_b"):
            assert torch.all(got == 0), name
        elif name.endswith("_w"):
            assert torch.all(got == 1), name
        else:
            assert 0.3 < got.std().item() / want.std().item() < 3, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_c_at_head_dim_64_matches_its_plain_version(case):
    """Kernel C's 64 build on the card, bf16, against the plain version
    within its launcher's limits; its launches count under
    ``flash_attention_d64``, not ``flash_attention``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gofr_tpu_torch.ops import cuda
    from gofr_tpu_torch.ops.attention import mha_attention_plain
    from gofr_tpu_torch.ops.cuda import flash_attention as mod

    c = dict(CASES[case])
    b, s, h, causal = c.pop("b"), c.pop("s"), c.pop("h"), c.pop("causal")
    q, k, v = (_t(a).cuda().bfloat16() for a in _qkv(30, b, s, h))
    kw = {n: torch.tensor(x, dtype=torch.int32, device="cuda") for n, x in c.items()}
    cuda.reset_launch_counts()
    got = mod.flash_attention(q, k, v, causal=causal, **kw)
    want = mha_attention_plain(q, k, v, causal=causal, **kw)
    diff = (got.float() - want.float())
    assert diff.abs().max().item() <= mod.MAX_ABS
    assert (diff.pow(2).mean().sqrt() / want.float().pow(2).mean().sqrt()).item() <= mod.RMS_REL
    counts = cuda.launch_counts()
    assert counts["flash_attention_d64"] == 1 and counts["flash_attention"] == 0
