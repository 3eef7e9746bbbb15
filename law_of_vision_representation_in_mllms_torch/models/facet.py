"""ViT facets (the part of the JAX package's `models/facet.py` that the
visual-token pruning reads; its descriptor and saliency-map facets come with
GeoAware, ROADMAP queue 1 item 8).

`cls_scores_from_qk` is the CLS -> patch attention of one block from its q
and k projections: one CLS-row softmax in fp32 (O(S) memory, not the S x S
attention), the mean over heads, the CLS column dropped. It is the
`prune_score="saliency"` score of `models.llava.encode_images`; the tower's
own attention stays on kernel 1.
"""

from __future__ import annotations

import torch

from .vit import ViTEncoder


def cls_scores_from_qk(q, k, head_dim: int):
    """q, k [B, S, H, Dh] -> CLS -> patch attention [B, S - 1] in fp32."""
    q, k = q.float(), k.float()
    logits = torch.einsum("bhd,bkhd->bhk", q[:, 0], k)
    logits = logits / torch.sqrt(torch.tensor(float(head_dim)))
    return torch.softmax(logits, dim=-1).mean(dim=1)[:, 1:]


def cls_attention_scores(encoder: ViTEncoder, pixel_values, *, layer: int):
    """CLS -> patch attention [B, S - 1] of block `layer` (0-based) of
    `encoder`, which runs its first `layer + 1` blocks."""
    cfg = encoder.cfg
    if not cfg.use_class_token:
        raise ValueError("cls attention scores need a CLS token")
    _, q, k = encoder(pixel_values, num_blocks=layer + 1, return_qk=True)
    return cls_scores_from_qk(q, k, cfg.head_dim)
