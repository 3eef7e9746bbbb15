"""GeoAware-SC preprocessing and pose-awareness runners (counterpart of the
JAX package's `pipeline/geoware.py`).

- `preprocess_maps` (`C_score/preprocess_map.py:20-69`): per image (and
  its horizontal flip), the multi-scale SD feature dict and the DINOv2
  descriptors, saved next to each other (`<stem>_sd[_flip].npz`,
  `<stem>_dino[_flip].npy`, the JAX layout: either package reads the
  other's files);
- `run_pose_awareness` (`C_score/pose_awareness_test.py`): each target
  image's pose (back / front / left / right) by its mean masked-NN
  descriptor distance to 12 pose templates, on co-PCA-fused SD + DINO
  features.

On the card the SD UNet's attentions run kernel 2 (SD1.5 at 960 px: 26
launches a forward through up block 2) and DINOv2's kernel 1; co-PCA, the
distances and the pose vote are plain PyTorch and numpy.

Instance masks: the reference derives them with ODISE panoptic inference
(out of scope, as in the JAX package). `mask_dir` holds per-image
`<stem>_mask.npy` / `.png` exports (`sam-masks` writes the PNGs); without
one the mask is all ones.

The default deterministic mode takes the VAE posterior's mean and no
noise. `stochastic` (the reference's behaviour) draws from a
`torch.Generator` seeded per image and flip with the number the JAX
function folds into its key ((process_index + j * process_count) * 2 +
flip); the two frameworks' generators give other numbers.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.image_processing import IMAGENET_MEAN, IMAGENET_STD
from ..metrics.geoware_extras import (PCA_DIMS, RESOLUTION, co_pca,
                                      fuse_descriptors, grid_to_descriptors,
                                      masked_nn_mean_distance,
                                      pose_awareness_eval,
                                      resize_mask_nearest)
from ..models.facet import facet_descriptors
from ..models.featurizer import (FeaturizerConfig, FeaturizerParams,
                                 extract_multiscale_features)
from ..models.vit import ViTEncoder

# preprocess_map.py:54 / pose_awareness_test.py:28-37 defaults
REAL_SIZE = 960       # SD input side
DINO_SIZE = 840       # DINOv2 input side (60 x 60 grid at patch 14)
DINO_LAYER = 11
DINO_FACET = "token"


def load_square(img, target: int, *, flip: bool = False,
                edge: bool = False) -> np.ndarray:
    """PIL image -> [target, target, 3] uint8: aspect-preserving LANCZOS
    resize (long side = target) and centred zero- or edge-padding
    (`C_score/utils/utils_correspondence.py:75-110 resize`)."""
    from PIL import Image
    img = img.convert("RGB")
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    w, h = img.size
    if h <= w:
        nh = int(np.around(target * h / w))
        img = img.resize((target, nh), Image.Resampling.LANCZOS)
    else:
        nw = int(np.around(target * w / h))
        img = img.resize((nw, target), Image.Resampling.LANCZOS)
    arr = np.asarray(img, np.uint8)
    ph, pw = target - arr.shape[0], target - arr.shape[1]
    pads = ((ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2), (0, 0))
    return np.pad(arr, pads, mode="edge" if edge else "constant")


def _sd_pixels(arr_u8: np.ndarray) -> np.ndarray:
    return (arr_u8.astype(np.float32) / 255.0 - 0.5) * 2.0


def _dino_pixels(arr_u8: np.ndarray) -> np.ndarray:
    x = arr_u8.astype(np.float32) / 255.0
    return ((x - np.asarray(IMAGENET_MEAN, np.float32))
            / np.asarray(IMAGENET_STD, np.float32))


def make_geoware_extractors(sd_params: FeaturizerParams,
                            sd_cfg: FeaturizerConfig, dino: ViTEncoder, *,
                            layer: int = DINO_LAYER,
                            facet: str = DINO_FACET,
                            deterministic: bool = True, ensemble: int = 1):
    """(sd_fn(px [1, H, W, 3], generator=None) -> {s3, s4, s5},
    dino_fn(px) -> [1, 1, t, d]) on the modules' device.

    `ensemble` averages the SD maps over that many noise draws
    (preprocess_map.py:29-36 NUM_ENSEMBLE), drawn one after the other from
    `generator`; deterministic draws none, so it is forced to 1."""
    if deterministic:
        ensemble = 1

    @torch.no_grad()
    def sd_fn(px, generator: Optional[torch.Generator] = None):
        acc = None
        for _ in range(ensemble):
            got = extract_multiscale_features(
                sd_params, sd_cfg, px, generator,
                deterministic=deterministic)
            got = {k: v.float() for k, v in got.items()}
            acc = got if acc is None else {k: acc[k] + got[k] for k in acc}
        return {k: v / ensemble for k, v in acc.items()}

    @torch.no_grad()
    def dino_fn(px):
        return facet_descriptors(dino, px, layer=layer, facet=facet)
    return sd_fn, dino_fn


def preprocess_maps(image_paths: Sequence[str], out_dir: str, sd_fn, dino_fn,
                    *, device, real_size: int = REAL_SIZE,
                    dino_size: int = DINO_SIZE, flips: bool = True,
                    process_index: int = 0,
                    process_count: int = 1) -> List[str]:
    """Per image (and flip): `<stem>_sd[_flip].npz` (s3 / s4 / s5 NHWC,
    fp32) and `<stem>_dino[_flip].npy` ([1, 1, t, d] fp32) under
    `out_dir`; this process takes every `process_count`-th image from
    `process_index`. Returns the files written."""
    from PIL import Image
    paths = list(image_paths)
    # outputs are keyed by basename stem (the reference's flat per-image
    # layout): two paths with one stem would clobber each other
    stems = {}
    for p in paths:
        s = os.path.splitext(os.path.basename(p))[0]
        if s in stems and stems[s] != p:
            raise ValueError(
                f"duplicate image stem '{s}': {stems[s]} vs {p} — outputs "
                "are keyed by basename; run per-directory or rename")
        stems[s] = p
    device = torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    written = []
    variants = [False, True] if flips else [False]
    for j, p in enumerate(paths[process_index::process_count]):
        with Image.open(p) as img:
            img = img.convert("RGB")
        stem = os.path.splitext(os.path.basename(p))[0]
        for flip in variants:
            suffix = "_flip" if flip else ""
            sd_px = _sd_pixels(load_square(img, real_size, flip=flip))
            # the JAX function's fold-in number for this image and flip;
            # deterministic mode draws nothing from it
            gen = torch.Generator(device=device).manual_seed(
                (process_index + j * process_count) * 2 + flip)
            feats = sd_fn(torch.from_numpy(sd_px[None]).to(device), gen)
            sd_out = os.path.join(out_dir, f"{stem}_sd{suffix}.npz")
            np.savez(sd_out, **{k: v.float().cpu().numpy()
                                for k, v in feats.items()})
            dn_px = _dino_pixels(load_square(img, dino_size, flip=flip))
            desc = dino_fn(torch.from_numpy(dn_px[None]).to(device))
            dn_out = os.path.join(out_dir, f"{stem}_dino{suffix}.npy")
            np.save(dn_out, desc.float().cpu().numpy())
            written += [sd_out, dn_out]
    return written


def panoptic_to_binary_mask(seg_map: np.ndarray, segments_info: List[Dict],
                            classes: Sequence[str],
                            category) -> np.ndarray:
    """ODISE panoptic output -> the reference's binary category mask
    (`C_score/model_utils/extractor_sd.py:249-286 get_mask`).

    seg_map: [H, W] int panoptic ids; segments_info: {"id", "category_id"}
    dicts; classes: category_id -> name. Matching is by substring after the
    reference's Pascal -> COCO renames; no match, or a matched area under
    6 pixels, gives all ones, as in the reference."""
    convert = {"aeroplane": "airplane", "motorbike": "motorcycle",
               "pottedplant": "potted plant", "tvmonitor": "tv"}
    if isinstance(category, list):
        cats = [convert.get(c, c) for c in category]
    else:
        cats = [convert.get(category, category)]
    target_ids = []
    for item in segments_info:
        name = classes[item["category_id"]]
        if any(c in name for c in cats):
            target_ids.append(item["id"])
    seg = np.asarray(seg_map)
    m = np.zeros(seg.shape, np.float32)
    for i in target_ids:
        m += (seg == i).astype(np.float32)
    if not target_ids or m.sum() < 6:
        m = np.ones(seg.shape, np.float32)
    return m


def _load_mask(mask_dir: Optional[str], stem: str, res: int) -> np.ndarray:
    if mask_dir:
        for ext in ("npy", "png"):
            p = os.path.join(mask_dir, f"{stem}_mask.{ext}")
            if os.path.exists(p):
                if ext == "npy":
                    m = np.load(p)
                else:
                    from PIL import Image
                    m = np.asarray(Image.open(p).convert("L"))
                m = (np.asarray(m) > 0).astype(np.float32)
                return resize_mask_nearest(m, res)
    return np.ones((res, res), np.float32)


def pair_distance(src_feats: Dict, src_dino, tgt_feats: Dict, tgt_dino,
                  src_mask: np.ndarray, *, res: int = RESOLUTION,
                  dims: Sequence[int] = PCA_DIMS) -> float:
    """The fused-descriptor mean masked-NN distance of one (src, tgt) pair:
    src is the pose query whose masked patches are matched INTO tgt (the
    template), `pose_awareness_test.py:169-209`. Runs on the tensors'
    device."""
    sd_s, sd_t = co_pca(src_feats, tgt_feats, dims)
    grid = sd_s.shape[1]
    d_s = fuse_descriptors(grid_to_descriptors(sd_s), src_dino)
    d_t = fuse_descriptors(grid_to_descriptors(sd_t), tgt_dino)
    return float(masked_nn_mean_distance(d_s, d_t, src_mask, grid=grid,
                                         res=res))


def _load_cached(feat_dir: str, stem: str, device):
    with np.load(os.path.join(feat_dir, f"{stem}_sd.npz")) as sd:
        feats = {k: torch.from_numpy(sd[k]).to(device) for k in sd.files}
    dino = np.load(os.path.join(feat_dir, f"{stem}_dino.npy"))
    return feats, torch.from_numpy(dino).to(device)


def run_pose_awareness(template_dir: str, target_dir: str, labels_path: str,
                       feat_dir: str, *, device,
                       mask_dir: Optional[str] = None,
                       res: int = RESOLUTION,
                       out_path: Optional[str] = None) -> Dict[str, float]:
    """The protocol over cached features (`preprocess_maps` of both image
    sets first; flips not needed), on `device`.

    labels_path: JSON {image filename: 'b' | 'f' | 'l' | 'r'} (the
    reference hard-codes this table for SPair categories)."""
    device = torch.device(device)
    with open(labels_path) as f:
        labels = json.load(f)
    tmpl = sorted(glob.glob(os.path.join(template_dir, "*.png"))
                  + glob.glob(os.path.join(template_dir, "*.jpg")))
    if len(tmpl) != 12:
        raise ValueError(f"need 12 sorted pose templates, found {len(tmpl)}")
    targets = sorted(p for p in glob.glob(os.path.join(target_dir, "*"))
                     if os.path.basename(p) in labels)

    t_feats = [_load_cached(feat_dir,
                            os.path.splitext(os.path.basename(p))[0], device)
               for p in tmpl]
    rows, poses = [], []
    for p in targets:
        stem = os.path.splitext(os.path.basename(p))[0]
        feats, dino = _load_cached(feat_dir, stem, device)
        mask = torch.from_numpy(_load_mask(mask_dir, stem, res)).to(device)
        rows.append([pair_distance(feats, dino, tf, td, mask, res=res)
                     for tf, td in t_feats])
        poses.append(labels[os.path.basename(p)])

    results = pose_awareness_eval(rows, poses)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"results": results, "rows": rows,
                       "targets": [os.path.basename(p) for p in targets]},
                      f, indent=1)
    return results
