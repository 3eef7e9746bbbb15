"""One-step diffusion featurizers (counterpart of the JAX package's
`models/featurizer.py`): SD1.5, SD2.1, SD image-variations, SDXL, DiT-XL/2
and SD3-medium.

VAE-encode the [-1, 1] image, take the posterior mean (deterministic) or a
sample, scale, add noise at the fixed timestep t, run the backbone once,
harvest, average an ensemble, and flatten to tokens [B, P, C]
(`diffusion_encoder.py DiffVisionTower` + the `dift_*.py` featurizers).

- sd (SD1.5, SD2.1) and sdxl: DDIM scaled-linear noise; the UNet conditions
  on the fixed prompt's text embedding, precomputed when the bundle was made
  (`prompt_embeds` [1, T, D]); SDXL's text_time addition embedding is never
  computed (the reference's quirk); up block `up_ft_index` is the feature;
- imsd conditions on the pooled CLIP image embedding of the input resized
  to 224 px (bilinear with antialiasing, as `jax.image.resize`; no CLIP
  normalisation, as in the reference);
- dit: DDPM linear (0.0001, 0.02) noise, timestep-only adaLN conditioning,
  block `up_ft_index` (-1: the last) 2x2-unfolded to 4 x hidden channels
  (`dift_dit.py:192-195`);
- sd3: the flow-matching "add_noise" with the raw integer t (t = 1 gives
  the clean latents, `mmdit.flow_match_add_noise`), conditioning on the
  precomputed `prompt_embeds` [1, 77 + 256, 4096] (CLIP, then T5's zero
  slots) and `pooled` [1, 2048]; the same 2x2 unfold.

The weights of one featurizer are a `FeaturizerParams` module: `vae`,
`backbone` (UNetHarvest, DiTHarvest or MMDiTHarvest), `image_encoder`
(imsd) and the `prompt_embeds` / `pooled` buffers, the subtrees of the JAX
bundle (`io.from_jax.featurizer_state_dict` maps one onto the other). The
random draws of a non-deterministic call come from a `torch.Generator`
where the JAX package takes a PRNG key, so the two packages draw different
numbers; `deterministic=True` (posterior mean, no noise) draws none.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from . import dit as DT
from . import mmdit as MM
from . import unet as UN
from . import vae as VA
from .diffusion_blocks import add_noise, ddim_alphas_cumprod, nchw, nhwc
from .vit import CLIPVisionPooled, ViTConfig, clip_l14

FAMILIES = ("sd", "imsd", "sdxl", "dit", "sd3")
# SD3's context: 77 CLIP tokens, then T5's 256 (zeros: T5 is dropped)
SD3_PROMPT_LEN = 77 + 256


@dataclasses.dataclass(frozen=True)
class FeaturizerConfig:
    family: str                       # sd | imsd | sdxl | dit | sd3
    t: int = 1
    up_ft_index: int = 0
    ensemble_size: int = 1
    img_size: int = 768
    unet: Optional[UN.UNetConfig] = None
    vae: Optional[VA.VAEConfig] = None
    dit: Optional[DT.DiTConfig] = None
    mmdit: Optional[MM.MMDiTConfig] = None
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
        family="dit", dit=DT.dit_xl_2(), vae=VA.sd_vae(), img_size=512,
        up_ft_index=-1, beta_schedule="linear", beta_start=0.0001,
        beta_end=0.02),
    "stabilityai/stable-diffusion-3-medium-diffusers": lambda:
        FeaturizerConfig(family="sd3", mmdit=MM.sd3_medium(),
                         vae=VA.sd3_vae(), img_size=512, up_ft_index=-1),
}


def _transformer(cfg: FeaturizerConfig):
    """The DiT / MMDiT configuration of a transformer family, else None."""
    return {"dit": cfg.dit, "sd3": cfg.mmdit}.get(cfg.family)


def feature_grid(cfg: FeaturizerConfig) -> int:
    """Side of the harvested token grid, from the configs themselves."""
    latent = cfg.img_size // 2 ** (len(cfg.vae.block_out_channels) - 1)
    tcfg = _transformer(cfg)
    if tcfg is not None:
        return latent // tcfg.patch_size // 2        # patchify + 2x2 unfold
    n_up = len(cfg.unet.block_out_channels)
    mid = latent >> (n_up - 1)
    return mid << min(cfg.up_ft_index % n_up + 1, n_up - 1)


def feature_dim(cfg: FeaturizerConfig) -> int:
    """Channel width of the harvested tokens."""
    tcfg = _transformer(cfg)
    if tcfg is not None:
        return 4 * tcfg.hidden_size                  # 2x2 unfold
    n = len(cfg.unet.block_out_channels)
    return cfg.unet.block_out_channels[n - 1 - cfg.up_ft_index % n]


def config_to_dict(cfg: FeaturizerConfig) -> Dict:
    """JSON-safe dict: the JAX bundle sidecar's format."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: Dict) -> FeaturizerConfig:
    """Inverse of `config_to_dict` (JSON lists -> tuples); the JAX package's
    sidecars load too."""
    d = dict(d)

    def detuple(cls, sub):
        if sub is None:
            return None
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in sub.items()})
    d["unet"] = detuple(UN.UNetConfig, d.get("unet"))
    d["vae"] = detuple(VA.VAEConfig, d.get("vae"))
    d["dit"] = detuple(DT.DiTConfig, d.get("dit"))
    d["mmdit"] = detuple(MM.MMDiTConfig, d.get("mmdit"))
    return FeaturizerConfig(**d)


class FeaturizerParams(nn.Module):
    """The weights of one featurizer: `vae` (VAEEncoder), `backbone` (a
    UNetHarvest with up blocks 0 .. n_up - 1, or a DiTHarvest /
    MMDiTHarvest with blocks 0 .. n_blocks - 1), `image_encoder`
    (CLIPVisionPooled, imsd only) and the buffers `prompt_embeds` [1, T, D]
    (sd, sdxl, sd3) and `pooled` [1, D] (sd3)."""

    def __init__(self, cfg: FeaturizerConfig,
                 precision: Precision = DEFAULT_PRECISION, *, device=None,
                 n_up: Optional[int] = None, n_blocks: Optional[int] = None,
                 prompt_len: Optional[int] = None,
                 image_encoder: Optional[ViTConfig] = None,
                 projection_dim: int = 768):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown featurizer family {cfg.family!r}")
        self.cfg, self.precision = cfg, precision
        kw = dict(device=device, dtype=precision.param_dtype)
        self.vae = VA.VAEEncoder(cfg.vae, precision, device=device)
        self.image_encoder = None
        if cfg.family in ("dit", "sd3"):
            tcfg = _transformer(cfg)
            last = (n_blocks - 1 if n_blocks
                    else cfg.up_ft_index % tcfg.num_layers)
            harvest = DT.DiTHarvest if cfg.family == "dit" else \
                MM.MMDiTHarvest
            self.backbone = harvest(tcfg, (last,), precision, device=device)
            if cfg.family == "sd3":
                self.register_buffer("prompt_embeds", torch.zeros(
                    1, prompt_len or SD3_PROMPT_LEN, tcfg.context_dim, **kw))
                self.register_buffer("pooled",
                                     torch.zeros(1, tcfg.pooled_dim, **kw))
            return
        n_up = n_up or cfg.up_ft_index % len(cfg.unet.block_out_channels) + 1
        self.backbone = UN.UNetHarvest(cfg.unet, (n_up - 1,), precision,
                                       device=device)
        if cfg.family == "imsd":
            self.image_encoder = CLIPVisionPooled(
                image_encoder or clip_l14(224), projection_dim, precision,
                device=device)
        else:
            self.register_buffer("prompt_embeds", torch.zeros(
                1, prompt_len or 77, cfg.unet.cross_attention_dim, **kw))

    @classmethod
    def for_state_dict(cls, sd: Dict[str, torch.Tensor],
                       cfg: FeaturizerConfig,
                       precision: Precision = DEFAULT_PRECISION, *,
                       device=None, image_encoder: Optional[ViTConfig] = None
                       ) -> "FeaturizerParams":
        """A module shaped for `sd` (its up blocks or blocks, prompt length
        and projection width), with `sd` loaded."""
        def count(prefix):
            return 1 + max(int(k.split(".")[1].split("_")[1]) for k in sd
                           if k.startswith(prefix))
        kw = {}
        if cfg.family in ("dit", "sd3"):
            kw["n_blocks"] = count("backbone.block_")
        else:
            kw["n_up"] = count("backbone.up_")
        if "prompt_embeds" in sd:
            kw["prompt_len"] = sd["prompt_embeds"].shape[1]
        if "image_encoder.visual_projection" in sd:
            kw["projection_dim"] = sd["image_encoder.visual_projection"
                                      ].shape[1]
        mod = cls(cfg, precision, device=device, image_encoder=image_encoder,
                  **kw)
        mod.load_state_dict(sd)
        return mod.eval()


def _noisy_latents(params: FeaturizerParams, cfg: FeaturizerConfig,
                   pixel_values, generator: Optional[torch.Generator], *,
                   deterministic: bool):
    """VAE encode -> posterior mean (deterministic) or a sample -> scaled
    latents -> noise at step t (flow matching for sd3, DDIM otherwise), in
    the compute dtype. The sample's eps, then the noise, are drawn from
    `generator` (a generator on the pixels' device seeded with 0 when
    None)."""
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
    if cfg.family == "sd3":
        noisy = MM.flow_match_add_noise(latents, noise, cfg.t)
    else:
        acp = ddim_alphas_cumprod(beta_start=cfg.beta_start,
                                  beta_end=cfg.beta_end,
                                  schedule=cfg.beta_schedule,
                                  device=latents.device)
        noisy = add_noise(latents, noise, cfg.t, acp)
    return noisy.to(params.precision.compute_dtype)


@torch.no_grad()
def backbone_tokens(params: FeaturizerParams, cfg: FeaturizerConfig, noisy,
                    ctx=None):
    """What `extract_features` runs after the VAE: the backbone on the noisy
    latents [N, h, w, C], harvested at `cfg.up_ft_index`, as tokens
    [N, P, C']. DiT and SD3 unfold the map 2x2 (SD3 reads its prompt and
    pooled buffers); a UNet's map is flattened, conditioned on `ctx`
    [N, L, D] (the prompt buffer when None)."""
    n = noisy.shape[0]
    up = (cfg.up_ft_index,)
    if cfg.family == "dit":
        feat = params.backbone(noisy, cfg.t, up_ft_indices=up)
    else:
        if ctx is None:
            pe = params.prompt_embeds
            ctx = pe.expand(n, *pe.shape[1:])
        if cfg.family == "sd3":
            feat = params.backbone(noisy, cfg.t, ctx,
                                   params.pooled.expand(n, -1),
                                   up_ft_indices=up)
        else:
            feat = params.backbone(noisy, cfg.t, ctx, up_ft_indices=up)
    feat = feat[cfg.up_ft_index]
    if cfg.family in ("dit", "sd3"):
        return DT.unfold_tokens_2x2(feat)
    return feat.flatten(1, 2)


@torch.no_grad()
def extract_features(params: FeaturizerParams, cfg: FeaturizerConfig,
                     pixel_values, generator: Optional[torch.Generator] = None,
                     *, deterministic: bool = False):
    """pixel_values [B, H, W, 3] in [-1, 1] -> tokens [B, P, C] in the
    compute dtype. imsd conditions on `params.image_encoder`'s pooled CLIP
    image embedding [B, D] of the 224 px pixels."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown featurizer family {cfg.family!r}")
    b = pixel_values.shape[0]
    e = cfg.ensemble_size
    if e > 1:
        pixel_values = pixel_values.repeat_interleave(e, dim=0)
    noisy = _noisy_latents(params, cfg, pixel_values, generator,
                           deterministic=deterministic)
    ctx = None
    if cfg.family == "imsd":
        px224 = nhwc(F.interpolate(nchw(pixel_values.float()),
                                   size=(224, 224), mode="bilinear",
                                   align_corners=False, antialias=True))
        ctx = params.image_encoder(px224.contiguous())[:, None, :]
    tokens = backbone_tokens(params, cfg, noisy, ctx)
    if e > 1:
        tokens = tokens.reshape(b, e, *tokens.shape[1:]).mean(dim=1)
    return tokens


@torch.no_grad()
def extract_multiscale_features(params: FeaturizerParams,
                                cfg: FeaturizerConfig, pixel_values,
                                generator: Optional[torch.Generator] = None,
                                *, deterministic: bool = False) -> Dict:
    """GeoAware-SC's multi-scale SD harvest: {"s3", "s4", "s5"} NHWC maps
    in the compute dtype.

    The reference taps ODISE's FeatureExtractorBackbone at the last
    res / attn output of each decoder resolution BEFORE its upsampler
    (`C_score/model_utils/extractor_sd.py`); s2 (stride 8) is dropped by
    its consumers (`preprocess_map.py:32`). Pre-upsample harvest indices
    0 / 1 / 2 are s5 / s4 / s3 (strides 64 / 32 / 16; 1280 / 1280 / 640
    channels for SD1.5, the AggregationNetwork's feature_dims). UNet
    families only; the bundle must hold up blocks through 2 (a
    `port-featurizer --up-ft-index 2` bundle)."""
    if cfg.family not in ("sd", "sdxl"):
        raise ValueError("multi-scale harvest is a UNet-family feature "
                         f"(got family={cfg.family!r})")
    noisy = _noisy_latents(params, cfg, pixel_values, generator,
                           deterministic=deterministic)
    pe = params.prompt_embeds
    ctx = pe.expand(noisy.shape[0], *pe.shape[1:])
    got = params.backbone(noisy, cfg.t, ctx, up_ft_indices=(),
                          pre_up_indices=(0, 1, 2))
    return {"s5": got["pre0"], "s4": got["pre1"], "s3": got["pre2"]}
