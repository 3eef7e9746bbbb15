"""Diffusion featurizer bundles in the JAX package's format (a copy of its
`io/featurizer_bundle.py` save and load).

A bundle is a flat `param_io` .npz of the featurizer's tree (`vae/...`,
`backbone/...`, `prompt_embeds` [1, T, D], `image_encoder/...` for imsd)
plus `<path>.json`, the `FeaturizerConfig` as `config_to_dict` writes it.
The JAX CLI's `port-featurizer` makes one from a diffusers snapshot; either
package reads what the other writes. Porting a snapshot stays in the JAX
package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

from torch import nn

from ..models import featurizer as F
from . import from_jax
from .param_io import load_params, save_params


def save_featurizer_bundle(out_path: str, params, cfg: F.FeaturizerConfig
                           ) -> str:
    """Write `params` (a `FeaturizerParams` or the JAX tree of numpy
    arrays) and `cfg`; returns the .npz path."""
    if not out_path.endswith(".npz"):
        out_path += ".npz"
    if isinstance(params, nn.Module):
        params = from_jax.featurizer_tree(params.state_dict())
    save_params(out_path, params)
    with open(out_path + ".json", "w") as f:
        json.dump(F.config_to_dict(cfg), f)
    return out_path


def load_featurizer_bundle(path: str
                           ) -> Tuple[Dict, Optional[F.FeaturizerConfig]]:
    """(tree of numpy arrays, config or None): a bundle without its sidecar
    loads with config None (the caller takes the tower's preset)."""
    params = load_params(path)
    sidecar = path + ".json"
    cfg = None
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            cfg = F.config_from_dict(json.load(f))
    return params, cfg
