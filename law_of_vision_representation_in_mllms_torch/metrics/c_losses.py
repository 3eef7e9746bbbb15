"""Training losses for supervised correspondence (counterpart of the JAX
package's `metrics/c_losses.py`; `C_score/utils/utils_losses.py`).

- `clip_loss`: symmetric cross-entropy over matched keypoint descriptors
  (`cal_clip_loss` :79-90);
- `dense_epe_loss`: correlation -> soft-argmax displacement against the
  ground-truth keypoint flow (`get_corr_map_loss` :6-17);
- `self_contrastive_loss`: neighbours similar, random non-neighbours
  dissimilar (`self_contrastive_loss` :19-72), vectorised. Its random pixel
  pairs come from a `torch.Generator` (the JAX function splits a PRNG key,
  so the two packages draw different pairs from one seed), or are handed in
  as `pairs` (a test gives it the JAX draws).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .aggregation import soft_argmax_displacement
from .c_score import similarity


def clip_loss(desc1, desc2, logit_scale):
    """desc1 / desc2: [N, C] matched (keypoint) descriptor pairs."""
    logits_12 = logit_scale.exp() * desc1 @ desc2.T
    labels = torch.arange(desc1.shape[0], device=desc1.device)
    return (F.cross_entropy(logits_12, labels)
            + F.cross_entropy(logits_12.T, labels)) / 2


def dense_epe_loss(desc1, desc2, kp_patch_idx, gt_flow, num_patches: int,
                   *, window: int = 0):
    """desc1 / desc2 [P, C] normalized; kp_patch_idx [K]; gt_flow [K, 2]
    (x, y displacement in patch units)."""
    sim = similarity(desc1, desc2)
    disp = soft_argmax_displacement(sim, num_patches, window=window)
    pred = disp[kp_patch_idx]
    return torch.linalg.vector_norm(pred - gt_flow, dim=-1).mean()


def self_contrastive_loss(feat_map, generator: Optional[torch.Generator]
                          = None, *, lambda_factor: float = 0.1,
                          pairs: Optional[Tuple] = None):
    """feat_map: [B, H, W, C]. Local term: raise the dot products with the
    8 neighbours; global term: lower those of random non-neighbour pairs,
    `pairs` = (src, dst) [H * W, 2] (row, col) draws, else drawn from
    `generator` on the map's device."""
    b, h, w, c = feat_map.shape
    ii = torch.arange(h, device=feat_map.device)[:, None]
    jj = torch.arange(w, device=feat_map.device)[None, :]
    local = 0.0
    for di, dj in ((0, 1), (1, 0), (1, 1), (1, -1), (0, -1), (-1, 0),
                   (-1, -1), (-1, 1)):
        shifted = torch.roll(feat_map, (di, dj), dims=(1, 2))
        dot = (feat_map * shifted).sum(dim=-1)              # [B, H, W]
        valid = torch.ones((h, w), dtype=torch.bool, device=dot.device)
        if di > 0:
            valid = valid & (ii >= di)
        if di < 0:
            valid = valid & (ii < h + di)
        if dj > 0:
            valid = valid & (jj >= dj)
        if dj < 0:
            valid = valid & (jj < w + dj)
        local = local - torch.where(valid, dot, 0.0).mean()

    n = h * w
    if pairs is None:
        hi = torch.tensor([h, w], device=feat_map.device)

        def draw():
            u = torch.rand((n, 2), generator=generator,
                           device=feat_map.device)
            return (u * hi).long().clamp_max(hi - 1)
        pairs = (draw(), draw())
    src, dst = (torch.as_tensor(p, device=feat_map.device).long()
                for p in pairs)
    non_neighbor = ((src - dst).abs() > 1).any(dim=-1)
    f1 = feat_map[:, src[:, 0], src[:, 1]]                  # [B, n, C]
    f2 = feat_map[:, dst[:, 0], dst[:, 1]]
    dots = (f1 * f2).sum(dim=-1)                            # [B, n]
    glob = torch.where(non_neighbor[None], dots, 0.0).sum() / b
    return local + lambda_factor * glob
