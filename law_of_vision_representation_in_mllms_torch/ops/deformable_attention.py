"""Multi-scale deformable attention, MSDeformAttn (counterpart of the JAX
package's `ops/deformable_attention.py`).

The reference's one first-party native op is Mask2Former's MSDeformAttn
CUDA kernel (`ms_deform_attn_cuda.cu`), used by the vendored Mask2Former /
ODISE mask branch of GeoAware-SC, not on the C-score path. The JAX file has
no Pallas kernel (a batched bilinear gather and a weighted sum), and no
module of either package calls it; here it is `F.grid_sample` (bilinear,
zero padding, `align_corners=False`), the reference's own PyTorch fallback
(`ms_deform_attn_core_pytorch`).

Semantics: for each query, head, level and point, sample the level's value
map bilinearly at a normalized location and sum with the attention
weights; samples outside the map are zero.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def bilinear_sample(value, loc_x, loc_y):
    """Zero-padded bilinear sampling of value [H, W, C] at ABSOLUTE pixel
    coordinates loc_x / loc_y [...] (align_corners=False: position p
    samples around index p - 0.5). Returns [..., C]."""
    h, w, c = value.shape
    shape = loc_x.shape
    grid = torch.stack([2 * loc_x.reshape(-1).float() / w - 1,
                        2 * loc_y.reshape(-1).float() / h - 1], dim=-1)
    out = F.grid_sample(value.permute(2, 0, 1)[None].float(),
                        grid[None, None], mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[0, :, 0].T.reshape(*shape, c)


def ms_deform_attn(value, spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations, attention_weights):
    """value: [B, sum(H_l * W_l), M, C_v] flattened multi-level value maps;
    sampling_locations: [B, Q, M, L, P, 2] normalized (x, y) in [0, 1];
    attention_weights: [B, Q, M, L, P] (softmaxed over L * P).
    Returns [B, Q, M * C_v]."""
    b, _, m, cv = value.shape
    _, q, _, _, p, _ = sampling_locations.shape
    levels = value.split([h * w for h, w in spatial_shapes], dim=1)
    out = value.new_zeros((b, m, cv, q), dtype=torch.float32)
    for li, (h, w) in enumerate(spatial_shapes):
        v = levels[li].reshape(b, h, w, m, cv).permute(0, 3, 4, 1, 2)
        v = v.reshape(b * m, cv, h, w).float()
        grid = 2 * sampling_locations[:, :, :, li].float() - 1   # [B,Q,M,P,2]
        grid = grid.permute(0, 2, 1, 3, 4).reshape(b * m, q, p, 2)
        sampled = F.grid_sample(v, grid, mode="bilinear",
                                padding_mode="zeros", align_corners=False)
        wgt = attention_weights[:, :, :, li].permute(0, 2, 1, 3).float()
        out = out + (sampled.reshape(b, m, cv, q, p)
                     * wgt[:, :, None]).sum(dim=-1)
    return out.permute(0, 3, 1, 2).reshape(b, q, m * cv)
