"""AnyRes (multi-crop) image handling (a copy of the JAX package's
`models/anyres.py`: numpy on the host, no framework).

Reference: the anyres branch of `prepare_inputs_labels_for_multimodal`
(`llava_arch.py:311-351`), `get_anyres_image_grid_shape` /
`select_best_resolution` (`llava/mm_utils.py:12-50`) and `unpad_image`
(`llava_arch.py:200-227`): an image is split into a base view plus a grid of
crops; per-crop features are reassembled spatially, unpadded back to the
original aspect ratio, and flattened.

The crop grid is static (a configured resolution set) and unpadding is a
per-token validity mask over the padded grid: token counts stay fixed and
`models.splice.splice_plan(..., image_valid=...)` keeps masked tokens out of
attention. As in the JAX package, no entry point calls these yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def select_best_resolution(orig_size: Tuple[int, int],
                           possible: Sequence[Tuple[int, int]]
                           ) -> Tuple[int, int]:
    """Pick the candidate (w, h) maximizing effective resolution then
    minimizing waste (`mm_utils.py select_best_resolution`)."""
    ow, oh = orig_size
    best, best_eff, best_waste = None, -1, None
    for (w, h) in possible:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        eff = min(dw * dh, ow * oh)
        waste = w * h - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (w, h), eff, waste
    return best


def get_anyres_image_grid_shape(orig_size: Tuple[int, int],
                                grid_pinpoints: Sequence[Tuple[int, int]],
                                patch_size: int) -> Tuple[int, int]:
    """(cols, rows) of crops for the chosen resolution
    (`mm_utils.py get_anyres_image_grid_shape`)."""
    w, h = select_best_resolution(orig_size, grid_pinpoints)
    return w // patch_size, h // patch_size


def unpad_valid_mask(grid_hw: Tuple[int, int], feat_grid: int,
                     original_size: Tuple[int, int]) -> np.ndarray:
    """Validity mask over the assembled crop-feature grid.

    grid_hw: (cols, rows) of crops; feat_grid: per-crop feature grid side
    (e.g. 24 for CLIP-336); original_size: (w, h) of the source image.
    Returns bool [rows*feat_grid, cols*feat_grid] marking tokens that
    survive the reference's `unpad_image` crop (`llava_arch.py:200-227`).
    """
    cols, rows = grid_hw
    gh, gw = rows * feat_grid, cols * feat_grid
    ow, oh = original_size
    canvas_ratio = gw / gh
    orig_ratio = ow / oh
    mask = np.zeros((gh, gw), bool)
    if orig_ratio > canvas_ratio:
        # width-bound: vertical padding was added
        new_h = int(round(gw / orig_ratio))
        top = (gh - new_h) // 2
        mask[top:top + new_h, :] = True
    else:
        new_w = int(round(gh * orig_ratio))
        left = (gw - new_w) // 2
        mask[:, left:left + new_w] = True
    return mask


def assemble_anyres_tokens(base_feats: np.ndarray, crop_feats: np.ndarray,
                           grid_hw: Tuple[int, int],
                           original_size: Tuple[int, int],
                           feat_grid: int):
    """Assemble [base tokens; spatial crop tokens] with a validity mask.

    base_feats: [P, D] (the resized-whole-image view);
    crop_feats: [n_crops, P, D] in row-major crop order.
    Returns (tokens [P + rows*cols*P, D], valid mask of the same length).
    """
    cols, rows = grid_hw
    p, d = base_feats.shape
    g = feat_grid
    # [rows, cols, g, g, D] -> [rows*g, cols*g, D]
    grid = crop_feats.reshape(rows, cols, g, g, d)
    grid = grid.transpose(0, 2, 1, 3, 4).reshape(rows * g, cols * g, d)
    vmask = unpad_valid_mask(grid_hw, g, original_size)
    tokens = np.concatenate([base_feats, grid.reshape(-1, d)], axis=0)
    valid = np.concatenate([np.ones(p, bool), vmask.reshape(-1)])
    return tokens, valid
