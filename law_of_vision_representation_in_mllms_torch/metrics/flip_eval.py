"""Adaptive-flip evaluation primitives (counterpart of the JAX package's
`metrics/flip_eval.py`; the ADAPT_FLIP path of `C_score/pck_train.py:
108-124`, `utils_geoware.py:151-279`, `utils_correspondence.py:54-73`).

The flip-augmented C-score evaluation predicts correspondences from the
source image and from its horizontal mirror, then keeps the mirror's
predictions when its descriptors lie globally closer to the target
(mutual-NN distance). Keypoint symmetry groups rotate under mirroring (the
permute tables are in `metrics/data/geoware_annotations.json`). All but
`mutual_nn_distance` (a torch function on the descriptors' device, its
product in true fp32) are numpy copies of the JAX functions.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .c_score import _ieee_fp32


def permute_indices(flip_list: Sequence[Union[int, List[int]]],
                    vis: Optional[Sequence[bool]] = None) -> List[int]:
    """Index permutation for mirrored keypoints: each symmetry group cycles
    by one (left <-> right), when all its members are visible
    (`utils_geoware.py:151-190`)."""
    flat = [i for item in flip_list
            for i in (item if isinstance(item, list) else [item])]
    indices = list(range(max(flat) + 1))
    for item in flip_list:
        if isinstance(item, list):
            if vis is None or all(vis[i] for i in item):
                for i in range(len(item)):
                    indices[item[i]] = item[(i + 1) % len(item)]
    return indices


def flip_keypoints(keypoints: np.ndarray, img_size: int,
                   permute_list: Optional[Sequence[int]] = None
                   ) -> np.ndarray:
    """Mirror the x coordinates and apply the symmetry permutation
    (`utils_geoware.py:199-204`)."""
    out = np.array(keypoints, copy=True)
    out[:, 0] = img_size - out[:, 0]
    if permute_list is not None:
        out = out[list(permute_list)]
    return out


def mutual_nn_distance(desc1, desc2):
    """Mean distance over mutual nearest neighbours
    (`utils_correspondence.py get_distance_mutual_nn:54-73`), the flip-vs-
    original criterion. desc1 / desc2: [P, C]; a 0-d fp32 tensor."""
    d1, d2 = desc1.float(), desc2.float()
    n1 = (d1 * d1).sum(dim=1, keepdim=True)
    n2 = (d2 * d2).sum(dim=1, keepdim=True)
    with _ieee_fp32(d1.device):
        dist2 = n1 + n2.T - 2 * (d1 @ d2.T)
    dist = dist2.clamp_min(0.0).sqrt()
    nn12 = dist.argmin(dim=1)
    nn21 = dist.argmin(dim=0)
    mutual = nn21[nn12] == torch.arange(d1.shape[0], device=d1.device)
    mins = dist.min(dim=1).values
    return torch.where(mutual, mins, 0.0).sum() / mutual.sum().clamp_min(1)


def select_flip_predictions(kps_pred, kps_pred_flip, kps1, kps2,
                            flip_dist: float, orig_dist: float,
                            vis: np.ndarray, permute_list, anno_size: int
                            ) -> np.ndarray:
    """`optimized_kps_1_to_2` (`utils_geoware.py:269-279`): when the mirror
    is globally closer, replace the predictions of the keypoints that stay
    mutually visible after the flip permutation."""
    kps1_vis = kps1 * vis[:, None]
    kps1_flip = flip_keypoints(kps1_vis, anno_size,
                               permute_indices(permute_list, None))
    vis_flip = (kps1_flip[:, 2] * kps2[:, 2] * kps1[:, 2]) > 0
    out = np.array(kps_pred, copy=True)
    if flip_dist < orig_dist:
        out[vis_flip] = kps_pred_flip[vis_flip]
    return out
