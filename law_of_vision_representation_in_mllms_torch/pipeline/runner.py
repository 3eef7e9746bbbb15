"""Feature-extraction runner: RunConfig -> per-image feature dump
(counterpart of the JAX package's `pipeline/runner.py`)."""

from __future__ import annotations

import glob
import json
import os

from ..core.config import RunConfig
from ..core.precision import DEFAULT_PRECISION, FP32_PRECISION
from ..data.image_processing import processor_for_tower
from .features import (extract_tower_features, make_diffusion_extractor,
                       make_vit_extractor)


def run_feature_extraction(cfg: RunConfig, images: str, out_dir: str, *,
                           device, batch_size: int = 16,
                           suffix: str = "") -> int:
    """Dump the first tower's features of every image under `images` (a
    directory, searched recursively for jpg / jpeg / png, or a json list of
    paths) to `out_dir`; returns the file count.

    The tower comes from `train.runner.build_model`: seeded random weights,
    or `model.tower_weights` / `model.checkpoint` (a JAX `.npz` gives the
    JAX package's tower). bf16 compute (fp32 weights) under `train.bf16`,
    else fp32; the card's kernels 1 and 2 take bf16 only, so fp32 runs on
    the CPU. A diffusion tower (its bundle in `model.tower_weights`)
    featurizes deterministically: the posterior mean and no noise, so a
    feature cache is the same bits from run to run
    (`C_score/extract_feature.py`), at the tower's image size (512 px for
    DiT-XL/2, SDXL and SD3-medium, 768 px for the others) unless
    `model.img_size` sets another."""
    precision = DEFAULT_PRECISION if cfg.train.bf16 else FP32_PRECISION
    if os.path.isdir(images):
        paths = sorted(p for ext in ("jpg", "jpeg", "png")
                       for p in glob.glob(f"{images}/**/*.{ext}",
                                          recursive=True))
    else:
        with open(images) as f:
            paths = json.load(f)

    from ..train.runner import build_model
    model_cfg, params = build_model(cfg, device=device, precision=precision)
    entry = model_cfg.tower_spec.entries[0]
    if entry.kind == "vit":
        fn = make_vit_extractor(entry.vit_config, params.towers[0],
                                select_layer=cfg.model.select_layer,
                                precision=precision, device=device)
    elif entry.kind == "diffusion":
        fn = make_diffusion_extractor(
            params.towers[0], entry, model_cfg.featurizer_overrides,
            device=device)
    else:
        raise ValueError(
            f"cannot extract features from a '{entry.kind}' tower "
            f"({entry.name}) — precomputed-feature entries ARE the cache")
    # the extractor holds the tower: the rest of the model can go
    del params
    proc = processor_for_tower(entry.name, entry.img_size)
    written = extract_tower_features(fn, paths, proc, out_dir,
                                     batch_size=batch_size, suffix=suffix)
    return len(written)
