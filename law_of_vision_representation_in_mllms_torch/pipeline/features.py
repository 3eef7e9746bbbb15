"""Offline per-image feature extraction (counterpart of the JAX package's
`pipeline/features.py`).

Replaces BOTH reference extractors with one batched driver:
- `llava/feature/extract.py` (DDP/NCCL loop saving per-image tower outputs
  for feature-cached training),
- `C_score/extract_feature.py` (per-image SPair feature dump).

Images are batched (the reference runs batch 1 per GPU) and the tail batch
is padded, so every tower call has the same shape; the tower's attention is
kernel 1 or kernel 2 on the card (`models/vit.attention_route`), its plain
version on the CPU. Features land as fp32 `.npy` next to a manifest.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Sequence

import numpy as np
import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..data.image_processing import ImageProcessorConfig, preprocess_image
from ..models.vit import ViTConfig, ViTTower


def make_vit_extractor(cfg: ViTConfig, state_or_tower, *,
                       select_layer: int = -2,
                       select_feature: str = "patch",
                       precision: Precision = DEFAULT_PRECISION, device):
    """A callable from pixels [B, H, W, 3] (numpy or tensor, normalized for
    the tower) to features [B, P, C] on `device` in the compute dtype.

    `state_or_tower` is a `ViTTower` (e.g. `LlavaParams.towers[0]`) or its
    state dict. A tower built with this `cfg`, `select_layer`,
    `select_feature` and `precision` on `device` is used as it is;
    otherwise a tower of its own is built with them and given those weights
    (blocks the selected layer does not need are left out)."""
    device = torch.empty(0, device=device).device      # "cuda" -> "cuda:0"
    if _fits(state_or_tower, cfg, select_layer, select_feature, precision,
             device):
        tower = state_or_tower
    else:
        tower = ViTTower(cfg, select_layer, select_feature, precision,
                         device=device)
        state = (state_or_tower.state_dict()
                 if isinstance(state_or_tower, nn.Module)
                 else state_or_tower)
        own = tower.state_dict()
        tower.load_state_dict({k: v for k, v in state.items() if k in own})
    tower.eval()

    def fn(pixels):
        with torch.inference_mode():
            return tower(torch.as_tensor(pixels).to(device))
    return fn


def make_diffusion_extractor(tower_params, entry, config_overrides=None, *,
                             device):
    """A callable from pixels [B, H, W, 3] in [-1, 1] to the diffusion
    tower's tokens [B, P, C] on `device`: `tower_params` (the entry's
    `FeaturizerParams`) through `make_diffusion_apply`, deterministic."""
    from ..models.tower_runtime import make_diffusion_apply
    apply = make_diffusion_apply(config_overrides)

    def fn(pixels):
        with torch.inference_mode():
            return apply(tower_params, entry, torch.as_tensor(pixels).to(
                device))
    return fn


def _fits(tower, cfg: ViTConfig, select_layer: int, select_feature: str,
          precision: Precision, device: torch.device) -> bool:
    """Whether `tower` is a `ViTTower` that computes what a tower built
    from these arguments would."""
    return (isinstance(tower, ViTTower) and tower.cfg == cfg
            and tower.select_feature == select_feature
            and tower.encoder.precision == precision
            and len(tower.encoder.blocks) == cfg.resolve_layer(select_layer)
            and all(p.device == device for p in tower.parameters()))


def extract_tower_features(apply_fn: Callable, image_paths: Sequence[str],
                           processor: ImageProcessorConfig, out_dir: str, *,
                           batch_size: int = 16, suffix: str = "",
                           process_index: int = 0, process_count: int = 1,
                           pad_square: bool = False) -> List[str]:
    """Run `apply_fn(pixels [B,H,W,3]) -> [B,P,C]` over images, saving one
    `<stem><suffix>.npy` per image. Returns written paths (this process)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    mine = list(image_paths)[process_index::process_count]
    written = []
    for s in range(0, len(mine), batch_size):
        chunk = mine[s:s + batch_size]
        pixels = np.stack([
            preprocess_image(Image.open(p), processor,
                             pad_square=pad_square) for p in chunk])
        # pad the tail batch to the batch size: every call has one shape
        n = len(chunk)
        if n < batch_size:
            pixels = np.concatenate(
                [pixels, np.zeros((batch_size - n, *pixels.shape[1:]),
                                  np.float32)])
        feats = apply_fn(torch.from_numpy(pixels))[:n]
        feats = feats.float().cpu().numpy()
        for p, f in zip(chunk, feats):
            stem = os.path.splitext(os.path.basename(p))[0]
            out = os.path.join(out_dir, f"{stem}{suffix}.npy")
            np.save(out, f)
            written.append(out)
    manifest = os.path.join(out_dir, f"manifest_{process_index}.json")
    with open(manifest, "w") as f:
        json.dump({"count": len(written), "suffix": suffix}, f)
    return written
