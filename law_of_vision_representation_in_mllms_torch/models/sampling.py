"""Temperature / nucleus (top-p) token sampling (counterpart of the JAX
package's `models/sampling.py`).

HF's warper chain (`TemperatureLogitsWarper` then `TopPLogitsWarper`,
min_tokens_to_keep=1): logits are divided by the temperature, the
vocabulary is sorted by probability, and a token is kept iff the cumulative
probability BEFORE it is <= top_p, so the top token always survives. The
draw over the kept set is Gumbel-max: an argmax over logits plus Gumbel
noise. `temperature <= 0` gives the plain argmax, row for row.
`sample_rows` takes a temperature and a top_p per row, as tensors (the
inflight engine's slots, greedy and sampled in one captured step).

The noise comes from an explicit `torch.Generator` on the logits' device, or
is handed in as a tensor (`noise`), so that a test can give both packages the
same draws: the two frameworks' generators give different numbers from one
seed.
"""

from __future__ import annotations

from typing import Optional

import torch


def top_p_mask(sorted_probs, top_p):
    """Keep-mask over DESCENDING-sorted probabilities: token i survives iff
    the cumulative mass strictly before it is <= top_p."""
    exclusive_cum = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    return exclusive_cum <= top_p


def gumbel_noise(shape, generator: torch.Generator, device):
    """Standard Gumbel draws in fp32: -log(E) with E ~ Exp(1)."""
    e = torch.empty(shape, dtype=torch.float32, device=device)
    return e.exponential_(generator=generator).log_().neg_()


def _nucleus_draw(scaled, top_p, noise):
    """Gumbel-max draw over the nucleus of fp32 `scaled` logits [..., V];
    `noise` in the order of the sorted vocabulary."""
    # stable, as `jnp.argsort`: equal logits keep their vocabulary order
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, order)
    keep = top_p_mask(torch.softmax(sorted_logits, dim=-1), top_p)
    sorted_logits = sorted_logits.masked_fill(~keep, float("-inf"))
    pick = (sorted_logits + noise).argmax(dim=-1, keepdim=True)
    return torch.gather(order, -1, pick)[..., 0]


def sample_token(logits, generator: Optional[torch.Generator],
                 temperature: float, top_p: float = 1.0, *,
                 noise: Optional[torch.Tensor] = None):
    """Next-token ids from `[..., V]` logits. `noise` (fp32, the logits'
    shape, in the order of the sorted vocabulary, as the JAX function draws
    it) replaces the generator's draws. `temperature <= 0` returns the
    argmax."""
    greedy = logits.argmax(dim=-1)
    t = float(temperature)
    if t <= 0:
        return greedy
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return _nucleus_draw(logits.float() / max(t, 1e-6), top_p, noise)


def sample_rows(logits, temperature, top_p, noise):
    """Row-wise `sample_token` (the JAX function with a traced temperature,
    one row at a time): logits [B, V]; temperature and top_p [B] tensors;
    noise [B, V] fp32 in the order of each row's sorted vocabulary. A row
    with `temperature <= 0` gets its exact argmax, so one program serves
    greedy and sampled rows together; nothing here is a host value."""
    greedy = logits.argmax(dim=-1)
    scaled = logits.float() / temperature.clamp_min(1e-6)[:, None]
    sampled = _nucleus_draw(scaled, top_p[:, None], noise)
    return torch.where(temperature > 0, sampled, greedy)
