"""C score: dense semantic correspondence (SPair-71k PCK); counterpart of
the JAX package's `metrics/c_score.py`.

Zero-shot reference path (`C_score/pck_train.py:57-245` with
`DummyAggregationNetwork`, `configs/eval_zero_shot_spair.yaml`): per image
pair, L2-normalize patch descriptors (norm + 1e-10, `pck_train.py:24-29`),
similarity matrix desc1 @ desc2.T (N²xN²), then window-soft-argmax flow
(`utils_correspondence.py:297-338`):

1. per source patch, argmax over targets (the first of equal values); keep an
   (2w+1)² window around it (border-clamped rectangle), ZEROING the rest
   (`get_flow`): the zeros contribute exp(0/beta)=1 to the softmax
   denominator, so they are not masked to -inf;
2. temperature softmax (beta=0.02) over targets, marginalize to x / y and
   take the expectation over a [-1, 1] grid (`soft_argmax`), un-normalize to
   patch coords ((v+1)(N-1)/2);
3. keypoint -> patch index (floor(N/ANNO * coord)), look up the flow, map
   back to pixels at patch centers (x*stride + stride//2);
4. PCK@{0.10,0.05,0.01}: ||pred-gt|| < alpha * max(bbox_w, bbox_h), both
   per-keypoint and per-image aggregates, plus the geo-aware subset.

The similarity is one `torch.matmul` in true fp32 whatever the process's
TF32 setting (the JAX package asks for `Precision.HIGHEST`): the argmax of
step 1 is discontinuous, and a TF32 product can move a window by a patch.
Everything else is elementwise passes and reductions over [..., S, T];
`compute_pck_batch` runs the pairs in chunks of at most `CHUNK_BYTES` of
similarity, so that the [n, P, P] matrices and their softmax fit on the
device. Pairs are independent: the chunking changes no result.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-10
# fp32 similarity bytes a chunk of pairs in `compute_pck_batch` (its
# softmax and masks take a few times as much again)
CHUNK_BYTES = 1 << 30


@contextlib.contextmanager
def _ieee_fp32(device: torch.device):
    """cuBLAS fp32 products without TF32 inside the block, restored after."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def normalize_feats(feats):
    """[..., P, C] row L2 normalization, reference eps convention."""
    n = torch.linalg.vector_norm(feats.float(), dim=-1, keepdim=True)
    return feats / (n + EPS)


def similarity(desc1, desc2):
    """[..., P, C] x2 -> [..., P, P] cosine similarity (descs normalized),
    in true fp32."""
    with _ieee_fp32(desc1.device):
        return torch.matmul(desc1.float(), desc2.float().transpose(-1, -2))


def _grid_xy(num_patches: int, device):
    t = torch.arange(num_patches * num_patches, device=device)
    return t % num_patches, t // num_patches


def window_mask(sim, num_patches: int, window: int):
    """Zero out sim outside a (2w+1)² window around each source's argmax."""
    n = num_patches
    amax = sim.argmax(dim=-1)                            # [..., S]
    ax, ay = amax % n, amax // n
    tx, ty = _grid_xy(n, sim.device)                     # [T]
    inx = (tx - ax[..., None]).abs() <= window
    iny = (ty - ay[..., None]).abs() <= window
    return sim * (inx & iny)


def gaussian_kernel_mask(sim, num_patches: int, sigma: float):
    """`apply_gaussian_kernel` (`utils_correspondence.py:281-296`):
    multiply sim by a gaussian centered at the argmax."""
    n = num_patches
    amax = sim.argmax(dim=-1)
    ax = (amax % n).float()
    ay = (amax // n).float()
    tx, ty = (v.float() for v in _grid_xy(n, sim.device))
    g = torch.exp(-((tx - ax[..., None]) ** 2 + (ty - ay[..., None]) ** 2)
                  / (2 * sigma ** 2))
    return sim * g


def soft_argmax_flow(sim, num_patches: int, *, window: int = 0,
                     beta: float = 0.02):
    """sim: [..., S, T] -> flow [..., S, 2] (x, y) in patch coordinates.

    window > 0: hard window then soft-argmax (SOFT_EVAL_WINDOW);
    window < 0: gaussian kernel with sigma=-window;
    window == 0: plain soft-argmax.
    """
    n = num_patches
    if window > 0:
        sim = window_mask(sim, n, window)
    elif window < 0:
        sim = gaussian_kernel_mask(sim, n, -window)
    probs = torch.softmax(sim.float() / beta, dim=-1)
    probs = probs.reshape(*probs.shape[:-1], n, n)       # [..., S, ty, tx]
    # the grid from the host, so every device sums the same values
    lin = torch.from_numpy(np.linspace(-1.0, 1.0, n, dtype=np.float32)
                           ).to(sim.device)
    gx = (probs.sum(dim=-2) * lin).sum(dim=-1)           # [..., S]
    gy = (probs.sum(dim=-1) * lin).sum(dim=-1)
    # unnormalize to patch coords ((v+1)(N-1)/2, `get_flow`->
    # `unnormalise_and_convert_mapping_to_flow`)
    fx = (gx + 1.0) * (n - 1) / 2.0
    fy = (gy + 1.0) * (n - 1) / 2.0
    return torch.stack([fx, fy], dim=-1)


def kpts_to_patch_idx(kps, num_patches: int, anno_size: int):
    """[..., K, 2] (x, y) pixel keypoints -> flat patch index
    (`utils_correspondence.py:384-389`); truncation toward zero."""
    scale = num_patches / anno_size
    px = (kps[..., 0] * scale).to(torch.int32).clamp(0, num_patches - 1)
    py = (kps[..., 1] * scale).to(torch.int32).clamp(0, num_patches - 1)
    return (num_patches * py + px).long()


def _rows(x, idx):
    """x [..., S, W], idx [..., K] -> x's rows idx: [..., K, W]."""
    return torch.gather(x, -2, idx[..., None].expand(
        *idx.shape, x.shape[-1]))


def transfer_keypoints(sim, kps1, num_patches: int, anno_size: int, *,
                       soft_eval: bool = True, window: int = 5,
                       beta: float = 0.02):
    """Predicted (x, y) pixel positions in image 2 for image-1 keypoints
    (`calculate_keypoint_transformation`, `utils_correspondence.py:345-382`).

    sim: [S, T] or [B, S, T]; kps1: [K, 2] / [B, K, 2] (x, y).
    """
    n = num_patches
    stride = anno_size / n
    idx = kpts_to_patch_idx(kps1, n, anno_size)          # [..., K]
    if soft_eval:
        flow = soft_argmax_flow(sim, n, window=window, beta=beta)
        fk = _rows(flow, idx)
        nx = fk[..., 0].clamp(0, n - 1)
        ny = fk[..., 1].clamp(0, n - 1)
    else:
        nn_idx = _rows(sim, idx).argmax(dim=-1)
        nx = (nn_idx % n).float()
        ny = (nn_idx // n).float()
    # anno_stride // 2 is a *python float* floor-div in the reference
    x = nx * stride + (stride // 2)
    y = ny * stride + (stride // 2)
    return torch.stack([x, y], dim=-1)


class PCKResult(NamedTuple):
    per_kpt: torch.Tensor      # [len(alphas)] keypoint-weighted PCK
    per_img: torch.Tensor      # [len(alphas)] image-averaged PCK
    n_kpts: torch.Tensor       # total visible keypoints
    correct: torch.Tensor      # [len(alphas), B, K] per-kpt correctness


def pck(pred, gt, vis, thresholds, alphas=(0.10, 0.05, 0.01)):
    """PCK over a padded batch of pairs.

    pred/gt: [B, K, 2]; vis: [B, K] bool; thresholds: [B] (alpha multiplies
    the per-pair bbox threshold, `pck_train.py:210-229`).
    """
    alphas = torch.tensor(alphas, dtype=torch.float32, device=pred.device)
    err = torch.linalg.vector_norm((pred - gt).float(), dim=-1)     # [B, K]
    thr = alphas[:, None, None] * thresholds.float()[None, :, None]  # [A,B,1]
    correct = (err[None] < thr) & vis[None]                          # [A,B,K]
    n = vis.sum().clamp(min=1)
    per_kpt = correct.sum(dim=(1, 2)) / n
    nk = vis.sum(dim=1).clamp(min=1)                                 # [B]
    img_has = vis.any(dim=1)                                         # [B]
    per_img_each = correct.sum(dim=2) / nk[None]                     # [A,B]
    n_img = img_has.sum().clamp(min=1)
    per_img = torch.where(img_has[None], per_img_each,
                          torch.zeros_like(per_img_each)).sum(dim=1) / n_img
    return PCKResult(per_kpt=per_kpt, per_img=per_img, n_kpts=vis.sum(),
                     correct=correct)


def compute_pck_batch(desc1, desc2, kps1, kps2, vis, thresholds, *,
                      num_patches: int, anno_size: int,
                      soft_eval: bool = True, window: int = 5):
    """End-to-end batched C-score evaluation step, on the tensors' device.

    desc1/desc2: [B, P, C] raw (unnormalized) patch descriptors;
    kps1/kps2: [B, K, 2] (x, y) pixel keypoints in the anno_size canvas;
    vis: [B, K] mutual visibility; thresholds: [B] bbox thresholds.
    Returns (PCKResult, pred [B, K, 2]).
    """
    b, p = desc1.shape[0], desc1.shape[1]
    step = max(1, min(b, CHUNK_BYTES // (4 * p * desc2.shape[1])))
    preds = []
    for s in range(0, b, step):
        d1 = normalize_feats(desc1[s:s + step])
        d2 = normalize_feats(desc2[s:s + step])
        preds.append(transfer_keypoints(
            similarity(d1, d2), kps1[s:s + step], num_patches, anno_size,
            soft_eval=soft_eval, window=window))
    pred = torch.cat(preds) if preds else kps1.new_zeros(kps1.shape)
    return pck(pred, kps2, vis, thresholds), pred


def concat_two_features(desc_a, desc_b):
    """pck_train_two.py: channel-concat two reps after per-rep
    normalization (`pck_train_two.py:24-34`)."""
    return torch.cat([normalize_feats(desc_a), normalize_feats(desc_b)],
                     dim=-1)


def resize_feature_grid(tokens, out_grid: int):
    """Resample token feature maps to a new square grid.

    The reference's trained-eval pipeline pre-resizes SD feature maps to the
    60x60 evaluation grid (`C_score/preprocess_map.py`, NUM_PATCHES=60 in
    the trained configs) with bilinear interpolation. tokens: [..., P, C]
    row-major square grids -> [..., out_grid**2, C]. Bilinear with
    antialiasing, as `jax.image.resize` does when it shrinks a grid.
    """
    *lead, p, c = tokens.shape
    g = int(round(p ** 0.5))
    grid = tokens.reshape(-1, g, g, c).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(out_grid, out_grid), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).reshape(*lead, out_grid * out_grid, c)
