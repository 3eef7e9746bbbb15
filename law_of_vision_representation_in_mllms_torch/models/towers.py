"""Tower registry + multi-tower specs (counterpart of the JAX package's
`models/towers.py`: ViT, UNet-family diffusion and precomputed-feature
entries).

A spec string names one tower, or several joined by '.' (channel concat into
one shared projector). A `*_feature` name is the precomputed-feature
pseudo-tower (JAX `kind="feature"`, the reference's `build_vision_tower`): the
dataset hands its features in and `encode_images` passes them through, so
feature-cached training runs no tower. SD1.5, SD2.1, SD image-variations and
SDXL are `kind="diffusion"` entries (`models/featurizer.py`), with the
featurizer knobs `t`, `up_ft_index`, `ensemble_size` and the image size.
DiT, SD3 and ',' (MoF, per-tower projectors) specs are not ported yet and
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .vit import VIT_PRESETS, ViTConfig

VIT_FAMILIES = {
    "debug/tiny-vit": "clip",
    "openai/clip-vit-large-patch14": "clip",
    "openai/clip-vit-large-patch14-336": "clip",
    "laion/CLIP-ViT-L-14-laion2B-s32B-b82K": "clip",
    "google/siglip-base-patch16-224": "siglip",
    "facebook/dinov2-large": "dinov2",
    "facebook/dinov2-large-336": "dinov2",
}

# hidden sizes of the diffusion feature towers
# (`diffusion_encoder.py:22-28` feature_hid_size_mapping)
DIFFUSION_HIDDEN_SIZES = {
    "runwayml/stable-diffusion-v1-5": 1280,
    "stabilityai/stable-diffusion-2-1": 1280,
    "stabilityai/stable-diffusion-xl-base-1.0": 1280,
    "lambdalabs/sd-image-variations-diffusers": 1280,
    "facebook/DiT-XL-2-512": 4608,
    "stabilityai/stable-diffusion-3-medium-diffusers": 6144,
}
# default image size of each diffusion tower (`train.py:88`: 768; DiT and
# SD3 512 as in `C_score/extract_feature.py:57-62`)
DIFFUSION_IMG_SIZES = {
    "runwayml/stable-diffusion-v1-5": 768,
    "stabilityai/stable-diffusion-2-1": 768,
    "lambdalabs/sd-image-variations-diffusers": 768,
    "stabilityai/stable-diffusion-xl-base-1.0": 512,
    "facebook/DiT-XL-2-512": 512,
    "stabilityai/stable-diffusion-3-medium-diffusers": 512,
}
DIFFUSION_TOWERS = tuple(DIFFUSION_HIDDEN_SIZES)
# the diffusion towers this port does not run yet
UNPORTED_DIFFUSION = ("facebook/DiT-XL-2-512",
                      "stabilityai/stable-diffusion-3-medium-diffusers")
# precomputed-feature pseudo-towers: name -> feature width; 576 tokens each
# (the reference's dummy feature, `train.py:830-831`)
FEATURE_TOWERS = {"runwayml/stable-diffusion-v1-5_feature": 1280}
FEATURE_TOKENS = 576

_NOT_PORTED = ("{what} is not ported to the PyTorch package yet "
               "(ROADMAP, queue 1: {item})")


@dataclasses.dataclass(frozen=True)
class TowerEntry:
    name: str
    kind: str                      # "vit" | "diffusion" | "feature"
    vit_config: Optional[ViTConfig] = None
    vit_family: Optional[str] = None
    hidden_size: int = 0
    num_patches: int = 0
    # diffusion featurizer knobs (`train.py:83-88`)
    up_ft_index: int = 0
    t: int = 1
    prompt: str = ""
    ensemble_size: int = 1
    img_size: int = 768


@dataclasses.dataclass(frozen=True)
class TowerSpec:
    entries: List[TowerEntry]
    join: str                      # "concat" ('.') | "single"

    @property
    def mm_hidden_size(self) -> int:
        return sum(e.hidden_size for e in self.entries)

    @property
    def num_patches(self) -> int:
        n = {e.num_patches for e in self.entries}
        if len(n) != 1:
            raise ValueError(
                f"concat towers must agree on token count, got {n}")
        return n.pop()


def _make_entry(name: str, **overrides) -> TowerEntry:
    if name in VIT_FAMILIES:
        cfg = VIT_PRESETS[name]()
        return TowerEntry(name=name, kind="vit", vit_config=cfg,
                          vit_family=VIT_FAMILIES[name],
                          hidden_size=cfg.hidden_size,
                          num_patches=cfg.num_patches,
                          img_size=cfg.image_size)
    if name in FEATURE_TOWERS:
        return TowerEntry(name=name, kind="feature",
                          hidden_size=FEATURE_TOWERS[name],
                          num_patches=FEATURE_TOKENS)
    if name in UNPORTED_DIFFUSION:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"diffusion tower {name}", item="5, diffusion towers"))
    if name in DIFFUSION_TOWERS:
        overrides = dict(overrides)
        img = overrides.pop("img_size", None) or DIFFUSION_IMG_SIZES[name]
        grid = diffusion_grid(name, img, overrides.get("up_ft_index", 0))
        return TowerEntry(name=name, kind="diffusion",
                          hidden_size=DIFFUSION_HIDDEN_SIZES[name],
                          num_patches=grid * grid, img_size=img, **overrides)
    raise ValueError(f"Unknown vision tower: {name}")


def diffusion_grid(name: str, img_size: int, up_ft_index: int = 0) -> int:
    """Side of a UNet tower's harvested feature map at the production block
    counts: the VAE's /8 latent, 3 downsamplers (SDXL 2); up block i has
    run its upsampler but for the last block. SD1.5 at 768, up_ft 0:
    24 x 24 x 1280 = 576 tokens (`train.py:830-831`)."""
    latent = img_size // 8
    n_up = 3 if "xl" in name else 4
    mid = latent >> (n_up - 1)
    return mid << min(up_ft_index + 1, n_up - 1)


def parse_tower_spec(spec: str, **overrides) -> TowerSpec:
    """'.' joins => channel concat (shared projector); a single name =>
    single tower; ',' (MoF) raises NotImplementedError. `overrides`
    (`up_ft_index`, `t`, `ensemble_size`, `img_size`) go to the diffusion
    entries."""
    if "," in spec:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"the MoF tower spec {spec!r}",
            item="5, diffusion towers"))
    if "." in spec and spec not in _known():
        names, join = _split_dot(spec), "concat"
    else:
        names, join = [spec], "single"
    return TowerSpec(entries=[
        _make_entry(n, **overrides) if n in DIFFUSION_TOWERS
        else _make_entry(n) for n in names], join=join)


def _known() -> list:
    return [*VIT_FAMILIES, *DIFFUSION_TOWERS, *FEATURE_TOWERS]


def _split_dot(spec: str):
    """Split on '.' with longest-match against known names (HF ids may
    contain dots)."""
    known = sorted(_known(), key=len, reverse=True)
    parts, rest = [], spec
    while rest:
        for k in known:
            if rest == k:
                parts.append(k)
                return parts
            if rest.startswith(k + "."):
                parts.append(k)
                rest = rest[len(k) + 1:]
                break
        else:
            parts.append(rest)
            return parts
    return parts
