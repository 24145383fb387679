"""Kernel C's f32 body (``csrc/flash_attention_f32.cu``) emulated tile by
tile, held against the JAX package's Pallas flash kernel in f32.

The body cannot run here (no card, no nvcc), so its arithmetic is written
out in torch: tiles of 64 queries by 64 keys, the 3xTF32 split of every
operand (hi what the tensor cores read of an f32 word, ``HI_RULES``; lo =
x - hi, of which the tensor cores read the truncation in turn), S = Q.lo
K.hi + Q.hi K.lo + Q.hi K.hi, the online softmax per tile in base 2 with
the kernel's masks (an edge tile alone, the safe-max rule, the 1e-20
clamp), and P.V through the fragment pairing the body uses:
P's A fragments take k index c from key 2c of each group of 8 and c + 4
from key 2c + 1 (S's accumulator layout), so Vt stores each group's keys in
``vt_column``'s order. Each product is exact in f64 and each sum is rounded
to f32 once, as the tensor cores' f32 accumulation does to within a few
ulps. The emulation is held to the launcher's ``F32`` limits (1e-4 on any
element, 2e-5 on the RMS ratio) against the Pallas kernel in interpret mode
(as tests/test_torch_f32.py runs it) on the prefill forms C serves, at head
dims 128 and 64, GQA 4 and MHA; and the same emulation with the lo terms
dropped, or with Vt's keys in their natural order, fails them, so the
limits bite on what the body could get wrong.

    python -m pytest tests/test_torch_flash_f32_tiles.py   # ~20 s on a CPU

``scripts/torch_flash_f32_probe.py`` reads, on the card, how the tensor
cores read a raw f32 word (the hi rule) and holds the body against this
emulation and an f64 reference.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

BQ = BK = 64  # the body's tiles: 64 query rows (wgmma's M) by 64 keys
LOG2E = float(np.float32(1.4426950408889634))  # the body's scores are in base 2
NEG_INF = -1e30
F32 = (1e-4, 2e-5)  # the launcher's limits: max abs, RMS ratio

# S's accumulator gives lane column c (lane % 4) of a group of 8 keys the
# keys 2c + e % 2 in its element e (rows by e // 2); tf32's A fragment
# wants, in register r, k index c + 4 (r // 2) (rows by r % 2); the body
# feeds register r from accumulator element FRAG_ELEMENT[r].
FRAG_ELEMENT = (0, 2, 1, 3)


def a_key_of_k() -> list[int]:
    """The key of its group that P's A fragment carries at each k index."""
    keys = [None] * 8
    for c in range(4):
        for r, e in enumerate(FRAG_ELEMENT):
            assert e // 2 == r % 2  # the register and the element hold the same row
            keys[c + 4 * (r // 2)] = 2 * c + e % 2
    return keys


def vt_column(r: int) -> int:
    """The body's column in Vt of key r of a tile (flash_attention_f32.cu's
    ``transpose_v`` writes key 8 (g / 2) + g % 2 + 2j at column 4g + j)."""
    return (r & ~7) | ((r & 7) >> 1) | ((r & 1) << 2)


def vt_key_of_column(column=vt_column) -> list[int]:
    """The key Vt's column k of a group of 8 holds."""
    keys = [None] * 8
    for r in range(8):
        keys[column(r)] = r
    return keys


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """The tf32 value the tensor cores read of a raw f32 word: its low 13
    bits dropped."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: to nearest, ties away from zero (finite x)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


HI_RULES = {"trunc": tf32_trunc, "rna": tf32_rna}


def split(x: torch.Tensor, hi_rule: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of f32 x as the tensor cores read them, in f64: hi = the
    rule's tf32, lo = x - hi (exact in f32), truncated to tf32."""
    hi = HI_RULES[hi_rule](x)
    return hi.double(), tf32_trunc(x - hi).double()


def per_batch(value, b: int, fill: int) -> torch.Tensor:
    if value is None:
        value = fill
    return torch.as_tensor(value, dtype=torch.int64).expand(b).clone()


def flash_f32_tiles(q, k, v, *, causal=True, q_offset=0, kv_lengths=None, scale=None,
                    hi_rule="trunc", lo_terms=True, vt_column_of=vt_column):
    """The f32 body's arithmetic on q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D] f32
    (any device) → [B, Sq, Hq, D] f32. ``lo_terms=False`` keeps hi.hi alone
    (one pass of TF32); ``vt_column_of`` is the transpose's key order."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    scale = scale if scale is not None else d ** -0.5
    off = per_batch(q_offset, b, 0).to(dev)
    kl = per_batch(kv_lengths, b, skv).to(dev).clamp(0, skv)
    sq_p, skv_p = -(-sq // BQ) * BQ, -(-skv // BK) * BK
    # head-major, GQA by h / group, rows past S zero (the TMA maps' fill)
    qh = torch.zeros(b, hq, sq_p, d, dtype=torch.float32, device=dev)
    qh[:, :, :sq] = q.transpose(1, 2)
    kh, vh = (torch.zeros(b, hq, skv_p, d, dtype=torch.float32, device=dev) for _ in range(2))
    kh[:, :, :skv] = k.transpose(1, 2).repeat_interleave(g, dim=1)
    vh[:, :, :skv] = v.transpose(1, 2).repeat_interleave(g, dim=1)
    q_hi, q_lo = split(qh, hi_rule)
    k_hi, k_lo = split(kh, hi_rule)
    v_hi, v_lo = split(vh, hi_rule)
    a_key = torch.tensor(a_key_of_k(), device=dev)
    vt_key = torch.tensor(vt_key_of_column(vt_column_of), device=dev)
    out = torch.zeros(b, hq, sq_p, d, dtype=torch.float32, device=dev)
    for q0 in range(0, sq_p, BQ):
        kv_end = (torch.minimum(kl, off + q0 + BQ) if causal else kl).clamp(min=0)
        n_tiles = (kv_end + BK - 1) // BK
        pos = (off[:, None] + q0 + torch.arange(BQ, device=dev)[None, :])[:, None, :, None]
        m = torch.full((b, hq, BQ, 1), NEG_INF, dtype=torch.float32, device=dev)
        lsum = torch.zeros(b, hq, BQ, 1, dtype=torch.float32, device=dev)
        o = torch.zeros(b, hq, BQ, d, dtype=torch.float32, device=dev)
        rows = slice(q0, q0 + BQ)
        for t in range(int(n_tiles.max().item()) if b else 0):
            k0 = t * BK
            keys = slice(k0, k0 + BK)
            s = q_hi[:, :, rows] @ k_hi[:, :, keys].transpose(-1, -2)
            if lo_terms:
                s = (q_lo[:, :, rows] @ k_hi[:, :, keys].transpose(-1, -2)
                     + q_hi[:, :, rows] @ k_lo[:, :, keys].transpose(-1, -2) + s)
            x = s.float() * (scale * LOG2E)
            kv = (k0 + torch.arange(BK, device=dev))[None, None, None, :]
            edge = ((k0 + BK > kl) | (causal & (k0 + BK - 1 > off + q0)))[:, None, None, None]
            live = (kv < kl[:, None, None, None]) & ((not causal) | (pos >= kv))
            x = torch.where(edge & ~live, torch.full_like(x, NEG_INF), x)
            m_next = torch.maximum(m, x.amax(-1, keepdim=True))
            safe = torch.where(m_next > NEG_INF * 0.5, m_next, torch.zeros_like(m_next))
            alpha = torch.exp2(m - safe)
            p = torch.exp2(x - safe)
            # P's columns in the A fragments' key order against Vt's columns
            groups = torch.arange(0, BK, 8, device=dev)[:, None]
            p_cols = (groups + a_key[None, :]).flatten()
            v_rows = (groups + vt_key[None, :]).flatten() + k0
            p_hi, p_lo = split(p[..., p_cols].contiguous(), hi_rule)
            pv = p_hi @ v_hi[:, :, v_rows]
            if lo_terms:
                pv = p_lo @ v_hi[:, :, v_rows] + p_hi @ v_lo[:, :, v_rows] + pv
            active = (t < n_tiles)[:, None, None, None]
            o = torch.where(active, (o * alpha).double().add(pv).float(), o)
            lsum = torch.where(active, lsum * alpha + p.sum(-1, keepdim=True), lsum)
            m = torch.where(active, m_next, m)
        out[:, :, rows] = o / lsum.clamp(min=1e-20)
    return out[:, :, :sq].transpose(1, 2).contiguous()


def errors(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(max abs error, RMS of the error over the RMS of ``want``)."""
    diff = got.astype(np.float64) - want.astype(np.float64)
    return float(np.abs(diff).max()), float(np.sqrt((diff ** 2).mean() / max((want.astype(
        np.float64) ** 2).mean(), 1e-60)))


def _qkv(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32),
            rng.standard_normal((b, skv, hkv, d)).astype(np.float32))


# the prefill forms C serves, with the body's edges: a causal prompt; ragged
# lengths with offsets and a fully masked row; a chunk of queries at
# offsets against cached keys (Sq not a multiple of 64); an encoder's
# padded keys (BERT-style lengths); ViT's 197 positions
_CASES = {
    "causal": dict(b=2, sq=130, skv=130, kw=dict(causal=True)),
    "ragged_offsets": dict(b=3, sq=100, skv=100, kw=dict(
        causal=True, q_offset=np.array([0, 37, 0], np.int32),
        kv_lengths=np.array([100, 71, 0], np.int32))),
    "chunk_at_offset": dict(b=2, sq=80, skv=208, kw=dict(
        causal=True, q_offset=np.array([128, 65], np.int32),
        kv_lengths=np.array([208, 145], np.int32))),
    "encoder_lengths": dict(b=4, sq=64, skv=64, kw=dict(
        causal=False, kv_lengths=np.array([64, 9, 1, 33], np.int32))),
    "vit_197": dict(b=2, sq=197, skv=197, kw=dict(causal=False)),
}


def _pallas(q, k, v, kw):
    import jax.numpy as jnp

    from gofr_tpu.ops.pallas.flash_attention import flash_attention as pallas_flash

    return np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                                   **{n: (jnp.asarray(x) if isinstance(x, np.ndarray) else x)
                                      for n, x in kw.items()}))


def _case(case, hq, hkv, d):
    spec = _CASES[case]
    q, k, v = _qkv(1000 * d + 10 * hq + sorted(_CASES).index(case), spec["b"], spec["sq"],
                   spec["skv"], hq, hkv, d)
    kw = spec["kw"]
    tkw = {n: (torch.from_numpy(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    return q, k, v, kw, tkw


@pytest.mark.quick
@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("hq,hkv", [(4, 1), (4, 4)])
@pytest.mark.parametrize("d", [128, 64])
def test_f32_body_emulation_matches_pallas(case, hq, hkv, d):
    """The body's tiles, split, key order and online softmax, in f32 out,
    within ``F32`` of the Pallas kernel in f32 on C's prefill forms, GQA 4
    and MHA; a fully masked row is 0."""
    q, k, v, kw, tkw = _case(case, hq, hkv, d)
    want = _pallas(q, k, v, kw)
    got = flash_f32_tiles(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **tkw)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err, rel = errors(got.numpy(), want)
    assert err <= F32[0] and rel <= F32[1], (err, rel)
    if case == "ragged_offsets":
        assert np.all(got.numpy()[2] == 0)


@pytest.mark.quick
@pytest.mark.parametrize("hi_rule", sorted(HI_RULES))
def test_either_hi_rule_holds_and_dropping_lo_fails(hi_rule):
    """Both split rules (the raw word's truncation and rna) keep the body
    within ``F32``; one pass of TF32 (the lo terms dropped) does not, so
    the limits catch a dropped lo product."""
    q, k, v, kw, tkw = _case("causal", 4, 1, 128)
    want = _pallas(q, k, v, kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    err, rel = errors(flash_f32_tiles(tq, tk, tv, hi_rule=hi_rule, **tkw).numpy(), want)
    assert err <= F32[0] and rel <= F32[1], (err, rel)
    err, rel = errors(flash_f32_tiles(tq, tk, tv, hi_rule=hi_rule, lo_terms=False, **tkw).numpy(),
                      want)
    assert err > F32[0] and rel > F32[1], (err, rel)


@pytest.mark.quick
def test_vt_key_order_pairs_each_key_with_its_value():
    """The fragment pairing: P's A fragment carries key 2c at k index c and
    2c + 1 at c + 4, and Vt's column order (0, 2, 4, 6, 1, 3, 5, 7) puts
    each key's value under it; Vt in the natural key order pairs keys with
    the wrong values and fails ``F32``."""
    assert a_key_of_k() == [0, 2, 4, 6, 1, 3, 5, 7] == vt_key_of_column()
    assert sorted(vt_column(r) for r in range(64)) == list(range(64))
    q, k, v, kw, tkw = _case("vit_197", 4, 4, 64)
    want = _pallas(q, k, v, kw)
    got = flash_f32_tiles(*(torch.from_numpy(a) for a in (q, k, v)), vt_column_of=lambda r: r,
                          **tkw)
    err, rel = errors(got.numpy(), want)
    assert err > F32[0] and rel > F32[1], (err, rel)


@pytest.mark.quick
def test_rows_past_s_read_as_zeros_not_the_next_batch_row():
    """The 4-D maps' zero fill: a row's keys past its length never reach its
    output, even where the next batch row's data (there a 2-D map over B.S
    rows would read) is NaN, and a row with no live key is 0, not NaN."""
    q, k, v, _, _ = _case("vit_197", 4, 1, 128)
    k[1, :64] = np.nan
    v[1, :64] = np.nan
    lengths = torch.tensor([197, 0], dtype=torch.int32)
    got = flash_f32_tiles(*(torch.from_numpy(a) for a in (q, k, v)), causal=False,
                          kv_lengths=lengths).numpy()
    want = _pallas(q[:1], k[:1], v[:1], dict(causal=False))
    err, rel = errors(got[:1], want)
    assert err <= F32[0] and rel <= F32[1], (err, rel)
    assert np.all(got[1] == 0)
