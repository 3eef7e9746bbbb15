"""GeoAware-SC extras: co-PCA SD + DINO fusion and the pose-awareness test
(counterpart of the JAX package's `metrics/geoware_extras.py`).

- `co_pca`: joint PCA over a source / target pair's multi-scale SD
  features (`C_score/utils/utils_correspondence.py:144-224`), an exact SVD
  in fp32 (`torch.linalg.svd`) instead of `torch.pca_lowrank`'s randomized
  sketch. A component's sign is the SVD's choice, and two SVDs may choose
  differently; both images share one projection, so every distance the
  protocol reads is the same;
- `fuse_descriptors`: L2-normalize the SD and DINO descriptors and concat
  (`pose_awareness_test.py:117-131`);
- `masked_nn_mean_distance`: over the masked source patches, the mean L2
  distance to the nearest target patch (`pose_awareness_test.py:196-207`),
  one |src| x |tgt| distance matrix by |a - b|^2 = |a|^2 + |b|^2 - 2ab;
- `pose_awareness_eval`: the 12-template pose protocol
  (`pose_awareness_test.py:246-296`).

The products run in true fp32 whatever the process's TF32 setting
(`metrics.c_score._ieee_fp32`): a TF32 product would move the nearest
neighbours. The upsampling resizes are bilinear with half-pixel centres
(`align_corners=False`), which is `jax.image.resize` when it upsamples.
`resize_mask_nearest`, `classify_pose` and `pose_awareness_eval` are numpy
on the host, copies of the JAX functions.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .c_score import _ieee_fp32

# SD co-PCA target dims for (s5, s4, s3) (pose_awareness_test.py:27)
PCA_DIMS = (256, 256, 256)
# NN-distance grid resolution (pose_awareness_test.py:39)
RESOLUTION = 128


def _reduce_pair(a, b, dim: int):
    """Joint PCA of two [t, C] feature sets to [t, dim] each."""
    x = torch.cat([a, b], dim=0).float()
    x = x - x.mean(dim=0, keepdim=True)
    with _ieee_fp32(x.device):
        _, _, vh = torch.linalg.svd(x, full_matrices=False)
        r = x @ vh[:dim].T
    return r[: a.shape[0]], r[a.shape[0]:]


def _upsample(x, h: int, w: int):
    """NHWC bilinear resize (half-pixel centres, no antialias)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def co_pca(feats1: Dict, feats2: Dict, dims: Sequence[int] = PCA_DIMS
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse a pair's multi-scale SD features into one descriptor grid each.

    feats*: {"s3": [1, H3, W3, C3], "s4": [1, H4, W4, C4], "s5": ...}
    (NHWC; H3 = 2 * H4 = 4 * H5). Returns two [1, H3, W3, sum(dims)] grids,
    channels (s3-reduced, s4-reduced, s5-reduced) as
    `utils_correspondence.py:203-224` gathers them."""
    red1, red2 = {}, {}
    for name, dim in zip(("s5", "s4", "s3"), dims):
        f1, f2 = feats1[name], feats2[name]
        _, h1, w1, c = f1.shape
        _, h2, w2, _ = f2.shape
        # the effective dim caps at the SVD's rank (tiny models: C < dim)
        r1, r2 = _reduce_pair(f1.reshape(-1, c), f2.reshape(-1, c), dim)
        red1[name] = r1.reshape(1, h1, w1, r1.shape[-1])
        red2[name] = r2.reshape(1, h2, w2, r2.shape[-1])

    def _gather(red):
        s4h, s4w = red["s4"].shape[1:3]
        s3h, s3w = red["s3"].shape[1:3]
        # s5 -> s4's resolution, concat with s4; then all -> s3's
        s45 = torch.cat([red["s4"], _upsample(red["s5"], s4h, s4w)], dim=-1)
        return torch.cat([red["s3"], _upsample(s45, s3h, s3w)], dim=-1)

    return _gather(red1), _gather(red2)


def grid_to_descriptors(grid):
    """[1, H, W, C] feature grid -> [1, 1, H * W, C] descriptors."""
    _, h, w, c = grid.shape
    return grid.reshape(1, 1, h * w, c)


def fuse_descriptors(sd_desc, dino_desc):
    """L2-normalize each descriptor set and concat on the channel axis
    (`pose_awareness_test.py:117-131`, the dist='l2' branch)."""
    def _norm(x):
        x = x.float()
        return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.cat([_norm(sd_desc), _norm(dino_desc)], dim=-1)


def _upsample_grid(desc, grid: int, res: int):
    """[1, 1, grid * grid, C] descriptors -> [res * res, C], bilinear."""
    c = desc.shape[-1]
    g = _upsample(desc.reshape(1, grid, grid, c), res, res)
    return g.reshape(res * res, c)


def resize_mask_nearest(mask: np.ndarray, res: int) -> np.ndarray:
    """[H, W] {0, 1} mask -> [res, res] by nearest (F.interpolate
    'nearest')."""
    h, w = mask.shape
    # torch 'nearest' picks floor(i * h / res) (asymmetric, not half-pixel)
    iy = np.minimum((np.arange(res) * h // res), h - 1)
    ix = np.minimum((np.arange(res) * w // res), w - 1)
    return mask[iy][:, ix]


def masked_nn_mean_distance(src_desc, tgt_desc, src_mask, *, grid: int,
                            res: int = RESOLUTION):
    """Mean over the masked source patches of the least L2 distance to any
    target patch (`pose_awareness_test.py:181-209 process_images`), a 0-d
    fp32 tensor. src_desc / tgt_desc [1, 1, grid * grid, C]; src_mask
    [res, res] {0, 1}."""
    a = _upsample_grid(src_desc.float(), grid, res)
    b = _upsample_grid(tgt_desc.float(), grid, res)
    m = torch.as_tensor(src_mask, device=a.device).reshape(-1).float()
    a2 = (a * a).sum(dim=-1, keepdim=True)
    b2 = (b * b).sum(dim=-1)
    with _ieee_fp32(a.device):
        d2 = a2 + b2[None, :] - 2.0 * (a @ b.T)
    dmin = d2.min(dim=-1).values.clamp_min(0.0).sqrt()
    return (dmin * m).sum() / m.sum().clamp_min(1.0)


# -------------------------------------------------------------------------
# Pose-awareness protocol (pose_awareness_test.py:246-296)
# -------------------------------------------------------------------------

# template index groups a pose: 12 sorted templates = 4 poses x 3 sets
POSE_INDICES = {"back": [0, 4, 8], "front": [1, 5, 9],
                "left": [2, 6, 10], "right": [3, 7, 11]}
POSE_LETTERS = ("b", "f", "l", "r")


def classify_pose(distances: np.ndarray) -> Tuple[str, str, str]:
    """distances: [12] mean NN distances to the sorted pose templates.

    Returns (bf_indicator, lr_indicator, four_way_letter) as
    `pose_awareness_test.py:266-274`: the majority of the back-vs-front /
    left-vs-right comparisons over the 3 template sets, and a 4-way
    argmin-bincount vote."""
    d = np.asarray(distances, dtype=np.float64)
    pd = {k: d[idx] for k, idx in POSE_INDICES.items()}
    bf = (pd["back"] - pd["front"] > 0).sum() > 1
    lr = (pd["left"] - pd["right"] > 0).sum() > 1
    bf_ind = "f" if bf else "b"
    lr_ind = "r" if lr else "l"
    votes = np.bincount(np.argmin(d.reshape(3, 4), axis=-1), minlength=4)
    four = POSE_LETTERS[int(np.argmax(votes))]
    return bf_ind, lr_ind, four


def pose_awareness_eval(distance_rows: Sequence[Sequence[float]],
                        gt_poses: Sequence[str]) -> Dict[str, float]:
    """The accuracies (`pose_awareness_test.py:276-296`). distance_rows: a
    target's 12 template distances (sorted template order) each; gt_poses:
    a target's 'b' / 'f' / 'l' / 'r' each."""
    correct = {"2": 0, "4": 0, "2_lr": 0, "2_fb": 0, "4_lr": 0, "4_fb": 0}
    views = {"lr": 0, "bf": 0}
    for row, pose in zip(distance_rows, gt_poses):
        bf_ind, lr_ind, four = classify_pose(row)
        correct["2"] += pose in (bf_ind, lr_ind)
        correct["4"] += pose == four
        if pose in ("b", "f"):
            views["bf"] += 1
            correct["2_fb"] += bf_ind == pose
            correct["4_fb"] += four == pose
        elif pose in ("l", "r"):
            views["lr"] += 1
            correct["2_lr"] += lr_ind == pose
            correct["4_lr"] += four == pose
    n = max(len(gt_poses), 1)
    out = {"correct_2": correct["2"] / n, "correct_4": correct["4"] / n,
           "n": len(gt_poses)}
    if views["lr"]:
        out["correct_2_lr"] = correct["2_lr"] / views["lr"]
        out["correct_4_lr"] = correct["4_lr"] / views["lr"]
    if views["bf"]:
        out["correct_2_fb"] = correct["2_fb"] / views["bf"]
        out["correct_4_fb"] = correct["4_fb"] / views["bf"]
    return out
