"""Temperature / nucleus (top-p) token sampling (counterpart of the JAX
package's `models/sampling.py`).

HF's warper chain (`TemperatureLogitsWarper` then `TopPLogitsWarper`,
min_tokens_to_keep=1): logits are divided by the temperature, the
vocabulary is sorted by probability, and a token is kept iff the cumulative
probability BEFORE it is <= top_p, so the top token always survives. The
draw over the kept set is Gumbel-max: an argmax over logits plus Gumbel
noise. `temperature <= 0` gives the plain argmax, row for row.

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
    scaled = logits.float() / max(t, 1e-6)
    # stable, as `jnp.argsort`: equal logits keep their vocabulary order
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, order)
    keep = top_p_mask(torch.softmax(sorted_logits, dim=-1), top_p)
    sorted_logits = sorted_logits.masked_fill(~keep, float("-inf"))
    if noise is None:
        noise = gumbel_noise(sorted_logits.shape, generator, logits.device)
    pick = (sorted_logits + noise).argmax(dim=-1, keepdim=True)
    return torch.gather(order, -1, pick)[..., 0]
