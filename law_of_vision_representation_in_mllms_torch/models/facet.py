"""ViT facet descriptors, the GeoAware-SC `ViTExtractor` (counterpart of the
JAX package's `models/facet.py`).

The reference (`C_score/model_utils/extractor_dino.py`) reads "facets"
(query / key / value / token) of one transformer block through forward
hooks, optionally log-binned into multi-scale descriptors. Here the block
hands them back: `ViTEncoder(..., return_qkv=True)` gives the last run
block's q, k and v projections [B, S, H, Dh] (the JAX block's sown
`facet_q`, `facet_k`, `facet_v`), and the token facet is that block's
output. The tower's attention runs kernel 1 (kernel 2 under
`attn_impl="flash"`) on the card; the `attn` facet's probabilities are
formed plainly from q and k in fp32, as the JAX block sows them.

Descriptor layout (`extractor_dino.py:316-341 extract_descriptors`): facet
tensors B x h x t x d are permuted to B x t x d x h and flattened, so the
channels are d-major over heads; the CLS token is dropped unless
`include_cls`. `_log_bin` (:268-314) is average pools (count_include_pad=
False) and edge-clamped shifts, vectorised.

`cls_scores_from_qk` is the CLS -> patch attention of one block: one
CLS-row softmax in fp32 (O(S) memory, not the S x S attention), the mean
over heads, the CLS column dropped; the `prune_score="saliency"` score of
`models.llava.encode_images`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .vit import ViTConfig, ViTEncoder

FACETS = ("query", "key", "value", "token")


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
    _, q, k, _ = encoder(pixel_values, num_blocks=layer + 1, return_qkv=True)
    return cls_scores_from_qk(q, k, cfg.head_dim)


def attention_maps(encoder: ViTEncoder, pixel_values, *, layer: int):
    """The 'attn' facet: softmax attention probabilities [B, h, t, t] of
    block `layer` in fp32 (`extractor_dino.py:233-234`, the attn_drop
    hook)."""
    _, q, k, _ = encoder(pixel_values, num_blocks=layer + 1, return_qkv=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / torch.sqrt(torch.tensor(float(encoder.cfg.head_dim)))
    return torch.softmax(logits, dim=-1)


def extract_saliency_maps(encoder: ViTEncoder, pixel_values, *,
                          layer: int | None = None,
                          head_idxs=(0, 2, 4, 5)):
    """CLS -> patch attention saliency, min-max normalized to [0, 1] per
    image: [B, t - 1] (`extractor_dino.py:342-356`; the reference fixes
    dino_vits8's last layer and heads [0, 2, 4, 5], both knobs here)."""
    cfg = encoder.cfg
    if not cfg.use_class_token:
        raise ValueError("saliency maps need a CLS token")
    if any(h >= cfg.num_heads for h in head_idxs):
        raise ValueError(f"head_idxs {tuple(head_idxs)} out of range for "
                         f"{cfg.num_heads} heads")
    if layer is None:
        layer = cfg.num_layers - 1
    probs = attention_maps(encoder, pixel_values, layer=layer)
    sal = probs[:, list(head_idxs), 0, 1:].mean(dim=1)         # [B, t-1]
    lo = sal.min(dim=1, keepdim=True).values
    hi = sal.max(dim=1, keepdim=True).values
    return (sal - lo) / (hi - lo)


def facet_descriptors(encoder: ViTEncoder, pixel_values, *, layer: int,
                      facet: str = "token", log_bin: bool = False,
                      include_cls: bool = False):
    """Per-patch descriptors of block `layer` (0-based, like the
    reference's `layer=11` for ViT-B): [B, 1, t, d']. `facet='token'`
    reads the block's output, q / k / v its pre-attention projections."""
    if facet not in FACETS:
        raise ValueError(f"facet must be one of {FACETS}, got {facet!r}")
    cfg = encoder.cfg
    if facet == "token":
        x = encoder(pixel_values, num_blocks=layer + 1)[:, None]
    else:
        out = encoder(pixel_values, num_blocks=layer + 1, return_qkv=True)
        x = out[1 + ("query", "key", "value").index(facet)].transpose(1, 2)
    if cfg.use_class_token and not include_cls:
        x = x[:, :, 1:]
    b, h, t, d = x.shape
    if log_bin:
        if include_cls:
            raise ValueError("log_bin with include_cls is unsupported "
                             "(matches extractor_dino.py:333-334)")
        return _log_bin(x, grid_hw=_grid_hw(cfg, pixel_values.shape))
    # B x h x t x d -> B x t x d x h -> B x 1 x t x (d * h): d-major
    return x.permute(0, 2, 3, 1).reshape(b, t, d * h)[:, None]


def _grid_hw(cfg: ViTConfig, img_shape) -> Tuple[int, int]:
    p, st = cfg.patch_size, cfg.stride_
    return (1 + (img_shape[1] - p) // st, 1 + (img_shape[2] - p) // st)


def _avg_pool_cic(x, win: int):
    """Average pool, stride 1, pad win // 2, count_include_pad=False, of
    x [B, gh, gw, C] (`torch.nn.AvgPool2d(win, 1, win // 2,
    count_include_pad=False)`, `extractor_dino.py:283-287`)."""
    if win == 1:
        return x
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), win, stride=1, padding=win // 2,
                     count_include_pad=False)
    return y.permute(0, 2, 3, 1)


def _log_bin(x, grid_hw: Tuple[int, int], hierarchy: int = 2):
    """Log-binned descriptor (`extractor_dino.py:268-314`) of x [B, h, t, d]
    (CLS dropped): at each location the 1 + 8 * hierarchy bins of the 3 x 3
    neighbourhood of win-3^k average-pooled maps at offsets that grow
    geometrically, edge-clamped. Returns [B, 1, t, d * h * (1 + 8 *
    hierarchy)]."""
    b, h, t, d = x.shape
    gh, gw = grid_hw
    fmap = x.permute(0, 2, 3, 1).reshape(b, gh, gw, d * h)
    parts = []
    for k in range(hierarchy):
        win = 3 ** k
        pooled = _avg_pool_cic(fmap, win)
        for dy in (-win, 0, win):
            for dx in (-win, 0, win):
                if k != 0 and dy == 0 and dx == 0:
                    continue
                iy = (torch.arange(gh, device=x.device) + dy).clamp(0, gh - 1)
                ix = (torch.arange(gw, device=x.device) + dx).clamp(0, gw - 1)
                parts.append(pooled[:, iy][:, :, ix])
    out = torch.cat(parts, dim=-1)
    return out.reshape(b, t, -1)[:, None]
