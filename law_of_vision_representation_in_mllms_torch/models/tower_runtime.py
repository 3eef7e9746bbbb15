"""Glue between tower entries and the diffusion featurizers (counterpart of
the JAX package's `models/tower_runtime.py`).

`make_diffusion_apply` returns the callable that `llava.encode_images` runs
for `kind == "diffusion"` entries: it resolves the entry's
`FeaturizerConfig` (a preset, or the bundle's own configuration in
`config_overrides`), and runs `featurizer.extract_features` on the entry's
`FeaturizerParams`, deterministic.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from .featurizer import (FEATURIZER_PRESETS, FeaturizerConfig,
                         FeaturizerParams, extract_features)
from .towers import TowerEntry


def resolve_featurizer_config(entry: TowerEntry,
                              override: Optional[FeaturizerConfig] = None
                              ) -> FeaturizerConfig:
    cfg = override or FEATURIZER_PRESETS[entry.name]()
    return dataclasses.replace(cfg, t=entry.t,
                               up_ft_index=(entry.up_ft_index
                                            if entry.up_ft_index is not None
                                            else cfg.up_ft_index),
                               ensemble_size=entry.ensemble_size,
                               img_size=entry.img_size)


def make_diffusion_apply(config_overrides: Optional[Dict[str, Any]] = None):
    """Returns apply(tower_params, entry, pixels) -> [B, P, C], deterministic
    (posterior mean, no noise), as every entry point of the JAX package
    builds it."""
    overrides = config_overrides or {}

    def apply(tower_params, entry: TowerEntry, pixels):
        if not isinstance(tower_params, FeaturizerParams):
            raise ValueError(
                f"diffusion tower '{entry.name}' has no params — port a "
                "checkpoint first (the JAX CLI's `port-featurizer`) and pass "
                "the bundle in model.tower_weights")
        cfg = resolve_featurizer_config(entry, overrides.get(entry.name))
        return extract_features(tower_params, cfg, pixels,
                                deterministic=True)
    return apply
