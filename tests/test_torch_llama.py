"""The port's Llama (gofr_tpu_torch.models.llama) held against the JAX model.

The JAX parameter tree is made with ``gofr_tpu.models.llama.init`` and
carried across with ``params_from_jax``; the same numpy-seeded tokens go
through both. On ``LlamaConfig.tiny()`` (f32) logits and pools are held to
1e-4: the two frameworks sum the same products in different orders, and
that difference grows through the layers. The bf16 flagship shape of
``__graft_entry__._flagship_cfg`` is held to 2% of the logits' range:
the frameworks round to bf16 at different points, which moves individual
logits by a few bf16 ulps after four layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

TOL = 1e-4


def _port_cfg(jcfg, dtype):
    from gofr_tpu_torch.models.llama import LlamaConfig

    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return LlamaConfig(**fields, dtype=dtype)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(11))
    model = params_from_jax(_port_cfg(jcfg, torch.float32), _np_tree(params), device="cpu")
    return jcfg, params, model


def _tables(n_pages=16, page=8):
    # row 0 owns pages 3, 9, 4; row 1 owns pages 12, 0; the rest are OOB
    table = np.full((2, 4), n_pages, np.int32)
    table[0, :3] = [3, 9, 4]
    table[1, :2] = [12, 0]
    return table


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.quick
def test_forward_matches_jax(tiny):
    from gofr_tpu.models import llama

    jcfg, params, model = tiny
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 12))
    lengths = np.array([12, 7])
    want = llama.forward(jcfg, params, jnp.asarray(tokens), jnp.asarray(lengths))
    got = model(torch.from_numpy(tokens), torch.from_numpy(lengths))
    _close(got.numpy()[0], want[0])
    _close(got.numpy()[1, :7], want[1, :7])


def test_prefill_then_decode_match_jax_logits_and_pools(tiny):
    from gofr_tpu.models import llama

    jcfg, params, model = tiny
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 10))
    lengths = np.array([10, 6], np.int32)
    table = _tables()
    jcache = llama.make_paged_cache(jcfg, 16, page_size=8)
    want, jcache = llama.prefill_paged(jcfg, params, jnp.asarray(tokens), jnp.asarray(lengths),
                                       jcache, jnp.asarray(table))
    cache = model.make_paged_cache(16, page_size=8)
    got, cache = model.prefill_paged(torch.from_numpy(tokens), torch.from_numpy(lengths),
                                     cache, torch.from_numpy(table))
    _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)

    step_tokens = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
    want, jcache = llama.decode_step_paged(jcfg, params, jnp.asarray(step_tokens),
                                           jnp.asarray(lengths), jcache, jnp.asarray(table))
    got, cache = model.decode_step_paged(torch.from_numpy(step_tokens), torch.from_numpy(lengths),
                                         cache, torch.from_numpy(table))
    _close(got, want)
    _close(cache.k, jcache.k)
    _close(cache.v, jcache.v)


def test_chunked_prefill_with_offsets_matches_jax(tiny):
    from gofr_tpu.models import llama

    jcfg, params, model = tiny
    rng = np.random.default_rng(2)
    first = rng.integers(0, jcfg.vocab_size, (2, 9))
    second = rng.integers(0, jcfg.vocab_size, (2, 7))
    table = _tables()
    len1, len2 = np.array([9, 5], np.int32), np.array([7, 4], np.int32)
    jcache = llama.make_paged_cache(jcfg, 16, page_size=8)
    _, jcache = llama.prefill_paged(jcfg, params, jnp.asarray(first), jnp.asarray(len1),
                                    jcache, jnp.asarray(table))
    want, jcache = llama.prefill_paged(jcfg, params, jnp.asarray(second), jnp.asarray(len2),
                                       jcache, jnp.asarray(table), jnp.asarray(len1))
    cache = model.make_paged_cache(16, page_size=8)
    model.prefill_paged(torch.from_numpy(first), torch.from_numpy(len1), cache,
                        torch.from_numpy(table))
    got, cache = model.prefill_paged(torch.from_numpy(second), torch.from_numpy(len2), cache,
                                     torch.from_numpy(table), torch.from_numpy(len1))
    _close(got, want)
    _close(cache.k, jcache.k)


def test_bf16_flagship_shape_forward_matches_jax():
    import __graft_entry__
    from gofr_tpu.models import llama
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = __graft_entry__._flagship_cfg()
    params = llama.init(jcfg, jax.random.key(5))
    model = params_from_jax(_port_cfg(jcfg, torch.bfloat16), _np_tree(params), device="cpu")
    assert model.embed.dtype == torch.bfloat16
    # weights crossed bit for bit
    np.testing.assert_array_equal(model.embed.view(torch.int16).numpy(),
                                  np.asarray(params["embed"]).view(np.int16))
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 32))
    want = np.asarray(llama.forward(jcfg, params, jnp.asarray(tokens)))
    got = model(torch.from_numpy(tokens)).numpy()
    assert np.isfinite(got).all()
    span = want.max() - want.min()
    assert np.abs(got - want).max() < 0.02 * span


@pytest.mark.quick
def test_random_init_is_seeded_and_scaled():
    from gofr_tpu_torch.models.llama import LlamaConfig, init

    cfg = LlamaConfig.tiny()
    a = init(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = init(cfg, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a.blocks[1].wq.weight, b.blocks[1].wq.weight)
    std = a.blocks[0].w_down.weight.float().std().item()
    assert 0.5 * cfg.intermediate_size ** -0.5 < std < 1.1 * cfg.intermediate_size ** -0.5
    assert torch.all(a.final_norm == 1)
