"""Static-shape image-token splice (counterpart of the JAX package's
`models/splice.py`; replaces the reference's per-sample Python loop,
`llava_arch.py:293-478`).

  out_len = text_len + num_patches - 1   (one image token per sample)

For output position j with image position p (per sample):
  j <  p              -> text token j
  p <= j < p+P        -> image patch j-p
  j >= p+P            -> text token j-P+1

Labels over the image span become IGNORE_INDEX; a text-only row keeps its
text and masks the trailing slots. Right-padded text stays right-padded:
the image is spliced before the pad, which the flash prefill relies on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200


class Spliced(NamedTuple):
    positions_map: torch.Tensor  # [B, L_out] gather index into text
    is_image: torch.Tensor       # [B, L_out] bool
    image_index: torch.Tensor    # [B, L_out] index into patches (clamped)
    attn_mask: torch.Tensor      # [B, L_out] bool validity
    labels: torch.Tensor         # [B, L_out] int
    positions: torch.Tensor      # [B, L_out] RoPE positions


def find_image_positions(input_ids):
    """Index of the first IMAGE_TOKEN_INDEX per row; rows without one get
    text_len."""
    is_img = input_ids == IMAGE_TOKEN_INDEX
    any_img = is_img.any(dim=1)
    first = is_img.to(torch.int32).argmax(dim=1)    # first maximal index
    return torch.where(any_img, first,
                       torch.full_like(first, input_ids.shape[1])), any_img


def splice_plan(input_ids, labels, text_mask, num_patches: int,
                image_valid=None) -> Spliced:
    """input_ids/labels [B, L] (one -200 image slot per row), text_mask
    [B, L] bool, num_patches P, optional image_valid [B, P] bool. Returns a
    Spliced of [B, L + P - 1] tensors."""
    b, l = input_ids.shape
    p = num_patches
    l_out = l + p - 1
    img_pos, has_img = find_image_positions(input_ids)
    img_pos = img_pos[:, None]
    has_img = has_img[:, None]

    j = torch.arange(l_out, device=input_ids.device)[None, :]
    before = j < img_pos
    in_img = (j >= img_pos) & (j < img_pos + p) & has_img
    text_idx = torch.where(before, j, j - p + 1).clamp(0, l - 1)

    text_valid = torch.gather(text_mask, 1, text_idx)
    dup_tail = (~has_img) & (j >= l)
    img_idx = (j - img_pos).clamp(0, p - 1)
    if image_valid is not None:
        img_ok = torch.gather(image_valid, 1, img_idx)
    else:
        img_ok = torch.ones_like(in_img)
    out_valid = torch.where(in_img, img_ok, text_valid & ~dup_tail)

    lbl = torch.gather(labels, 1, text_idx)
    lbl = torch.where(in_img | ~out_valid,
                      torch.full_like(lbl, IGNORE_INDEX), lbl)

    positions = (torch.cumsum(out_valid.to(torch.int32), dim=1) - 1
                 ).clamp_min(0)
    return Spliced(positions_map=text_idx, is_image=in_img,
                   image_index=img_idx, attn_mask=out_valid, labels=lbl,
                   positions=positions)


def splice_embeds(plan: Spliced, text_embeds, image_feats):
    """text_embeds [B, L, D], image_feats [B, P, D] -> [B, L_out, D]."""
    d = text_embeds.shape[-1]
    gathered_text = torch.gather(
        text_embeds, 1, plan.positions_map[..., None].expand(-1, -1, d))
    gathered_img = torch.gather(
        image_feats.to(text_embeds.dtype), 1,
        plan.image_index[..., None].expand(-1, -1, d))
    return torch.where(plan.is_image[..., None], gathered_img, gathered_text)
