"""One-step diffusion featurizers of the UNet family (counterpart of the JAX
package's `models/featurizer.py`: SD1.5, SD2.1, SD image-variations and
SDXL; DiT and SD3 are not ported yet).

VAE-encode the [-1, 1] image, take the posterior mean (deterministic) or a
sample, scale, add DDIM noise at the fixed timestep t, run the UNet once,
harvest up block `up_ft_index`, average an ensemble, and flatten to tokens
[B, h * w, C] (`diffusion_encoder.py DiffVisionTower` + `dift_sd.py`).

- sd (SD1.5, SD2.1) and sdxl condition on the fixed prompt's text embedding,
  precomputed when the bundle was made (`prompt_embeds` [1, T, D]); SDXL's
  text_time addition embedding is never computed (the reference's quirk);
- imsd conditions on the pooled CLIP image embedding of the input resized
  to 224 px (bilinear with antialiasing, as `jax.image.resize`; no CLIP
  normalisation, as in the reference).

The weights of one featurizer are a `FeaturizerParams` module: `vae`,
`backbone` (the UNet), `image_encoder` (imsd) and the `prompt_embeds`
buffer, the subtrees of the JAX bundle (`io.from_jax.featurizer_state_dict`
maps one onto the other). The random draws of a non-deterministic call come
from a `torch.Generator` where the JAX package takes a PRNG key, so the two
packages draw different numbers; `deterministic=True` (posterior mean, no
noise) draws none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from . import unet as UN
from . import vae as VA
from .diffusion_blocks import add_noise, ddim_alphas_cumprod, nchw, nhwc
from .vit import CLIPVisionPooled, ViTConfig, clip_l14

_NOT_PORTED = ("the {family} featurizer is not ported to the PyTorch package "
               "yet (ROADMAP, queue 1: 5, diffusion towers)")
UNET_FAMILIES = ("sd", "imsd", "sdxl")


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    family: str                       # sd | imsd | sdxl | dit | sd3
    t: int = 1
    up_ft_index: int = 0
    ensemble_size: int = 1
    img_size: int = 768
    unet: Optional[UN.UNetConfig] = None
    vae: Optional[VA.VAEConfig] = None
    # the DiT / MMDiT configurations of the JAX package (not ported)
    dit: Optional[Any] = None
    mmdit: Optional[Any] = None
    beta_schedule: str = "scaled_linear"
    beta_start: float = 0.00085
    beta_end: float = 0.012


FEATURIZER_PRESETS = {
    "runwayml/stable-diffusion-v1-5": lambda: FeaturizerConfig(
        family="sd", unet=UN.sd15_unet(), vae=VA.sd_vae()),
    "stabilityai/stable-diffusion-2-1": lambda: FeaturizerConfig(
        family="sd", unet=UN.sd21_unet(), vae=VA.sd_vae()),
    "lambdalabs/sd-image-variations-diffusers": lambda: FeaturizerConfig(
        family="imsd", unet=UN.sd15_unet(), vae=VA.sd_vae()),
    "stabilityai/stable-diffusion-xl-base-1.0": lambda: FeaturizerConfig(
        family="sdxl", unet=UN.sdxl_unet(), vae=VA.sdxl_vae(), img_size=512),
    "facebook/DiT-XL-2-512": lambda: FeaturizerConfig(
        family="dit", vae=VA.sd_vae(), img_size=512, up_ft_index=-1,
        beta_schedule="linear", beta_start=0.0001, beta_end=0.02),
    "stabilityai/stable-diffusion-3-medium-diffusers": lambda:
        FeaturizerConfig(family="sd3", vae=VA.sd3_vae(), img_size=512,
                         up_ft_index=-1),
}


def _require_unet_family(cfg: FeaturizerConfig) -> None:
    if cfg.family not in UNET_FAMILIES:
        if cfg.family in ("dit", "sd3"):
            raise NotImplementedError(_NOT_PORTED.format(family=cfg.family))
        raise ValueError(f"unknown featurizer family {cfg.family!r}")


def feature_grid(cfg: FeaturizerConfig) -> int:
    """Side of the harvested token grid, from the configs themselves."""
    _require_unet_family(cfg)
    latent = cfg.img_size // 2 ** (len(cfg.vae.block_out_channels) - 1)
    n_up = len(cfg.unet.block_out_channels)
    mid = latent >> (n_up - 1)
    return mid << min(cfg.up_ft_index % n_up + 1, n_up - 1)


def feature_dim(cfg: FeaturizerConfig) -> int:
    """Channel width of the harvested tokens."""
    _require_unet_family(cfg)
    n = len(cfg.unet.block_out_channels)
    return cfg.unet.block_out_channels[n - 1 - cfg.up_ft_index % n]


def config_to_dict(cfg: FeaturizerConfig) -> Dict:
    """JSON-safe dict: the JAX bundle sidecar's format."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict) -> FeaturizerConfig:
    """Inverse of `config_to_dict` (JSON lists -> tuples); the JAX package's
    sidecars load too."""
    d = dict(d)
    if d.get("family") in ("dit", "sd3"):
        raise NotImplementedError(_NOT_PORTED.format(family=d["family"]))

    def detuple(cls, sub):
        if sub is None:
            return None
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in sub.items()})
    d["unet"] = detuple(UN.UNetConfig, d.get("unet"))
    d["vae"] = detuple(VA.VAEConfig, d.get("vae"))
    return FeaturizerConfig(**d)


class FeaturizerParams(nn.Module):
    """The weights of one UNet-family featurizer: `vae` (VAEEncoder),
    `backbone` (UNetHarvest with up blocks 0 .. n_up - 1), `image_encoder`
    (CLIPVisionPooled, imsd only) and the `prompt_embeds` buffer [1, T, D]
    (not imsd)."""

    def __init__(self, cfg: FeaturizerConfig,
                 precision: Precision = DEFAULT_PRECISION, *, device=None,
                 n_up: Optional[int] = None, prompt_len: int = 77,
                 image_encoder: Optional[ViTConfig] = None,
                 projection_dim: int = 768):
        super().__init__()
        _require_unet_family(cfg)
        self.cfg, self.precision = cfg, precision
        n_up = n_up or cfg.up_ft_index % len(cfg.unet.block_out_channels) + 1
        self.vae = VA.VAEEncoder(cfg.vae, precision, device=device)
        self.backbone = UN.UNetHarvest(cfg.unet, (n_up - 1,), precision,
                                       device=device)
        if cfg.family == "imsd":
            self.image_encoder = CLIPVisionPooled(
                image_encoder or clip_l14(224), projection_dim, precision,
                device=device)
        else:
            self.image_encoder = None
            self.register_buffer("prompt_embeds", torch.zeros(
                1, prompt_len, cfg.unet.cross_attention_dim, device=device,
                dtype=precision.param_dtype))

    @classmethod
    def for_state_dict(cls, sd: Dict[str, torch.Tensor],
                       cfg: FeaturizerConfig,
                       precision: Precision = DEFAULT_PRECISION, *,
                       device=None, image_encoder: Optional[ViTConfig] = None
                       ) -> "FeaturizerParams":
        """A module shaped for `sd` (its up blocks, prompt length and
        projection width), with `sd` loaded."""
        n_up = 1 + max(int(k.split(".")[1].split("_")[1]) for k in sd
                       if k.startswith("backbone.up_"))
        kw = {}
        if "prompt_embeds" in sd:
            kw["prompt_len"] = sd["prompt_embeds"].shape[1]
        if "image_encoder.visual_projection" in sd:
            kw["projection_dim"] = sd["image_encoder.visual_projection"
                                      ].shape[1]
        mod = cls(cfg, precision, device=device, n_up=n_up,
                  image_encoder=image_encoder, **kw)
        mod.load_state_dict(sd)
        return mod.eval()


def _noisy_latents(params: FeaturizerParams, cfg: FeaturizerConfig,
                   pixel_values, generator: Optional[torch.Generator], *,
                   deterministic: bool):
    """VAE encode -> posterior mean (deterministic) or a sample -> scaled
    latents -> DDIM noise at step t, in the compute dtype. The sample's
    eps, then the noise, are drawn from `generator` (a generator on the
    pixels' device seeded with 0 when None)."""
    moments = params.vae(pixel_values)
    if deterministic:
        mean = moments.float().chunk(2, dim=-1)[0]
        if cfg.vae.shift_factor:
            mean = mean - cfg.vae.shift_factor
        latents = mean * cfg.vae.scaling_factor
        noise = torch.zeros_like(latents)
    else:
        if generator is None:
            generator = torch.Generator(moments.device).manual_seed(0)
        latents = VA.sample_latents(moments, generator, cfg.vae)
        noise = torch.randn(latents.shape, generator=generator,
                            device=latents.device, dtype=torch.float32)
    acp = ddim_alphas_cumprod(beta_start=cfg.beta_start,
                              beta_end=cfg.beta_end,
                              schedule=cfg.beta_schedule,
                              device=latents.device)
    noisy = add_noise(latents, noise, cfg.t, acp)
    return noisy.to(params.precision.compute_dtype)


@torch.no_grad()
def extract_features(params: FeaturizerParams, cfg: FeaturizerConfig,
                     pixel_values, generator: Optional[torch.Generator] = None,
                     *, deterministic: bool = False):
    """pixel_values [B, H, W, 3] in [-1, 1] -> tokens [B, P, C] in the
    compute dtype. imsd conditions on `params.image_encoder`'s pooled CLIP
    image embedding [B, D] of the 224 px pixels."""
    _require_unet_family(cfg)
    b = pixel_values.shape[0]
    e = cfg.ensemble_size
    if e > 1:
        pixel_values = pixel_values.repeat_interleave(e, dim=0)
    noisy = _noisy_latents(params, cfg, pixel_values, generator,
                           deterministic=deterministic)
    if cfg.family == "imsd":
        px224 = nhwc(F.interpolate(nchw(pixel_values.float()),
                                   size=(224, 224), mode="bilinear",
                                   align_corners=False, antialias=True))
        ctx = params.image_encoder(px224.contiguous())[:, None, :]
    else:
        pe = params.prompt_embeds
        ctx = pe.expand(noisy.shape[0], *pe.shape[1:])
    feat = params.backbone(noisy, cfg.t, ctx,
                           up_ft_indices=(cfg.up_ft_index,))[cfg.up_ft_index]
    n, h, w, c = feat.shape
    tokens = feat.reshape(n, h * w, c)
    if e > 1:
        tokens = tokens.reshape(b, e, h * w, c).mean(dim=1)
    return tokens
