"""Tower registry + multi-tower specs (counterpart of the JAX package's
`models/towers.py`, ViT and precomputed-feature entries).

A spec string names one tower, or several joined by '.' (channel concat into
one shared projector). A `*_feature` name is the precomputed-feature
pseudo-tower (JAX `kind="feature"`, the reference's `build_vision_tower`): the
dataset hands its features in and `encode_images` passes them through, so
feature-cached training runs no tower. Diffusion towers and ',' (MoF,
per-tower projectors) specs are not ported yet and raise
NotImplementedError.
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

# tower names of the JAX package that this port does not run yet
DIFFUSION_TOWERS = (
    "runwayml/stable-diffusion-v1-5",
    "stabilityai/stable-diffusion-2-1",
    "stabilityai/stable-diffusion-xl-base-1.0",
    "lambdalabs/sd-image-variations-diffusers",
    "facebook/DiT-XL-2-512",
    "stabilityai/stable-diffusion-3-medium-diffusers",
)
# precomputed-feature pseudo-towers: name -> feature width; 576 tokens each
# (the reference's dummy feature, `train.py:830-831`)
FEATURE_TOWERS = {"runwayml/stable-diffusion-v1-5_feature": 1280}
FEATURE_TOKENS = 576

_NOT_PORTED = ("{what} is not ported to the PyTorch package yet "
               "(ROADMAP, queue 1: {item})")


@dataclasses.dataclass(frozen=True)
class TowerEntry:
    name: str
    kind: str                      # "vit" | "feature"
    vit_config: Optional[ViTConfig] = None
    vit_family: Optional[str] = None
    hidden_size: int = 0
    num_patches: int = 0
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


def _make_entry(name: str) -> TowerEntry:
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
    if name in DIFFUSION_TOWERS:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"diffusion tower {name}", item="5, diffusion towers"))
    raise ValueError(f"Unknown vision tower: {name}")


def parse_tower_spec(spec: str) -> TowerSpec:
    """'.' joins => channel concat (shared projector); a single name =>
    single tower; ',' (MoF) raises NotImplementedError."""
    if "," in spec:
        raise NotImplementedError(_NOT_PORTED.format(
            what=f"the MoF tower spec {spec!r}",
            item="5, diffusion towers"))
    if "." in spec and spec not in _known():
        names, join = _split_dot(spec), "concat"
    else:
        names, join = [spec], "single"
    return TowerSpec(entries=[_make_entry(n) for n in names], join=join)


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
