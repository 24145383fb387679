"""Token sampling (counterpart of gofr_tpu/ops/sampling.py:17,40 and the
speculative acceptance test of gofr_tpu/tpu/programs.py:76).

Randomness comes from an explicit ``torch.Generator`` on the logits' device,
so a run is reproducible from its seed. The draws are not JAX's threefry
bits: the two are held to the same distribution, not the same tokens.

Nothing here makes the host wait on the card: no boolean-mask index, no
``.item()``, no ``nonzero``; a draw of one sample a row by
``torch.multinomial`` waits on nothing either (``chip_smoke.py`` phase 6
samples through it under ``torch.cuda.set_sync_debug_mode("error")``).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def truncate_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Mask (to NEG_INF) everything outside the top_k / nucleus top_p set
    along the last axis. The top-1 is always kept, so top_p=0 is greedy."""
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.softmax(sorted_logits, dim=-1).cumsum(dim=-1)
        # keep tokens while the cumulative probability BEFORE them is < top_p
        keep = torch.roll(cum, 1, dims=-1) < top_p
        keep[..., 0] = True
        inf = torch.full_like(sorted_logits, float("inf"))
        cutoff = torch.where(keep, sorted_logits, inf).min(dim=-1, keepdim=True).values
        logits = torch.where(logits < cutoff, torch.full_like(logits, NEG_INF), logits)
    return logits


def sample_token(logits: torch.Tensor, generator: torch.Generator | None, *,
                 temperature: torch.Tensor | float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, do_sample: bool = True) -> torch.Tensor:
    """Next tokens from ``logits`` [B, V] → [B] int32. ``temperature`` is a
    scalar or per-row [B]; rows with temperature <= 0 are greedy, so greedy
    and sampled requests share one step."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if not do_sample:
        return greedy
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    scaled = logits.float() / torch.clamp(temp[:, None] if temp.ndim == 1 else temp, min=1e-6)
    probs = torch.softmax(truncate_logits(scaled, top_k, top_p), dim=-1)
    sampled = torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


def _one_hot(index: torch.Tensor, vocab: int) -> torch.Tensor:
    """f32 one-hot rows of ``index`` (a compare, which checks nothing on
    the host, unlike ``F.one_hot``)."""
    return (torch.arange(vocab, device=index.device) == index[..., None]).float()


def _truncated_probs(logits: torch.Tensor, temp: torch.Tensor, greedy_rows: torch.Tensor,
                     top_k: int, top_p: float) -> torch.Tensor:
    """The distribution a row samples from: softmax of the truncated,
    tempered logits, or the one-hot of the argmax on a greedy row."""
    p = torch.softmax(truncate_logits(logits.float() / temp, top_k, top_p), dim=-1)
    return torch.where(greedy_rows, _one_hot(logits.argmax(dim=-1), logits.shape[-1]), p)


def speculative_sample(p_logits: torch.Tensor, drafts: torch.Tensor, temps: torch.Tensor,
                       generator: torch.Generator | None, q_logits: torch.Tensor | None = None,
                       top_k: int = 0, top_p: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """One verify step's acceptance test (programs.py:76, the Leviathan /
    Chen rejection scheme): draft j is accepted with probability
    min(1, p_j(d_j) / q_j(d_j)) while the prefix holds; then the correction
    is drawn from norm((p - q)+) at the first rejection, or the bonus token
    from p_g when every draft holds. Each emitted token is distributed as a
    plain sampled decode at its position; a row with temperature <= 0
    reduces to greedy (p is the one-hot of the argmax, so a draft is
    accepted when it is the argmax, and the correction is the argmax).

    ``p_logits`` [n, g+1, V] are the target's logits after the input token
    and each draft; ``drafts`` [n, g]; ``temps`` [n]; ``q_logits`` [n, g, V]
    the draft model's logits, or None for deterministic proposals (prompt
    lookup: q is the one-hot of the proposal, so the test is u < p(d) and the
    residual is p with the rejected token zeroed). ``top_k`` / ``top_p``
    truncate p and q with ``truncate_logits``, the mask plain sampling
    applies.

    Returns (out [n, g+1] int32, acc [n] int32): ``out[:, :acc]`` are the
    accepted drafts and ``out[:, acc]`` the correction or bonus; entries
    past ``acc`` are garbage the caller discards."""
    n, gp1, vocab = p_logits.shape
    g = gp1 - 1
    drafts = drafts.long()
    out = torch.cat([drafts, drafts.new_zeros((n, 1))], dim=1).to(torch.int32)
    temps = temps.float()
    greedy_rows = (temps <= 0)[:, None, None]
    temp = torch.clamp(temps, min=1e-6)[:, None, None]
    p = _truncated_probs(p_logits, temp, greedy_rows, top_k, top_p)
    if q_logits is None:
        q = None
        q_d = torch.ones((n, g), dtype=torch.float32, device=p.device)
    else:
        q = _truncated_probs(q_logits, temp, greedy_rows, top_k, top_p)
        q_d = q.gather(-1, drafts[..., None])[..., 0]
    p_d = p[:, :g].gather(-1, drafts[..., None])[..., 0]
    u = torch.rand((n, g), generator=generator, device=p.device)
    acc = (u * q_d < p_d).int().cumprod(dim=1).sum(dim=1)  # leading accepted drafts, 0..g
    at = acc.long()
    p_sel = p.gather(1, at[:, None, None].expand(n, 1, vocab))[:, 0]
    if q is None:
        d_at = drafts.gather(1, at.clamp(max=g - 1)[:, None])[:, 0]
        q_sel = torch.where((at < g)[:, None], _one_hot(d_at, vocab), 0.0)
    else:
        q_pad = torch.cat([q, q.new_zeros((n, 1, vocab))], dim=1)
        q_sel = q_pad.gather(1, at[:, None, None].expand(n, 1, vocab))[:, 0]
    resid = torch.clamp(p_sel - q_sel, min=0.0)
    # a zero residual means the rejection had probability zero: drawing
    # from p there is the same distribution
    resid = torch.where(resid.sum(dim=-1, keepdim=True) > 0, resid, p_sel)
    corr = torch.multinomial(resid, 1, generator=generator).to(torch.int32)
    return out.scatter_(1, at[:, None], corr), acc.to(torch.int32)
