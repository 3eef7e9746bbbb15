"""Plain attention: the reference the attention kernels are held against.

Counterpart of the JAX package's `ops/attention.py` `mha` and `causal_mask`.
Layout [B, S, H, D] as there; fp32 logits and softmax, probabilities cast to
the input dtype before P·V.
"""

from __future__ import annotations

import torch


def mha(q, k, v, *, bias=None, mask=None):
    """Multi-head attention.

    q: [B, Sq, H, D]; k, v: [B, Skv, H, D] (the caller repeats kv heads for
    GQA); bias broadcastable to [B, H, Sq, Skv], added to the scaled logits
    in fp32 (ALiBi); mask broadcastable to [B, H, Sq, Skv] bool, False ->
    -1e30. Returns [B, Sq, H, D] in q.dtype.
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(
            -1e30, dtype=torch.float32, device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def causal_mask(sq: int, skv: int, device=None):
    """Lower-triangular mask aligned to the *end* of the kv sequence."""
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(skv, device=device)[None, :]
    return (j - (skv - sq)) <= i
