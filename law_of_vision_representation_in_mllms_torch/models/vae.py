"""SD VAE encoder, the `AutoencoderKL.encode` half (counterpart of the JAX
package's `models/vae.py`).

The featurizers VAE-encode the [-1, 1] image, take the posterior (its mean,
or a sample), and scale it; the decoder is never used, so only the encoder
exists. SD1.5 / 2.1: block_out (128, 256, 512, 512), 2 layers a block,
4 latent channels, scaling 0.18215; SDXL the same trunk at scaling 0.13025;
SD3 (a configuration only here: its featurizer is not ported) 16 latent
channels, scaling 1.5305, shift 0.0609, no quant conv.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from .diffusion_blocks import (Conv, Conv2d, Downsample, GroupNorm,
                               ResnetBlock, VAESelfAttention)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_groups: int = 32
    scaling_factor: float = 0.18215
    shift_factor: float = 0.0
    use_quant_conv: bool = True


def sd_vae() -> VAEConfig:
    return VAEConfig()


def sdxl_vae() -> VAEConfig:
    return VAEConfig(scaling_factor=0.13025)


def sd3_vae() -> VAEConfig:
    return VAEConfig(latent_channels=16, scaling_factor=1.5305,
                     shift_factor=0.0609, use_quant_conv=False)


class VAEEncoder(nn.Module):
    """pixel_values [B, H, W, 3] in [-1, 1] -> moments [B, H/f, W/f, 2C]
    (mean, then log-variance), f = 2^(blocks - 1)."""

    def __init__(self, cfg: VAEConfig,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        kw = dict(groups=cfg.norm_groups, device=device)
        chans = cfg.block_out_channels
        self.conv_in = Conv(3, chans[0], precision, device=device)
        cin = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(
                    cin, ch, precision, eps=1e-6, **kw))
                cin = ch
            if i < len(chans) - 1:
                self.add_module(f"down_{i}_downsample", Downsample(
                    ch, ch, precision, asymmetric_pad=True, device=device))
        mid = chans[-1]
        self.mid_res_0 = ResnetBlock(mid, mid, precision, eps=1e-6, **kw)
        self.mid_attn = VAESelfAttention(mid, precision, **kw)
        self.mid_res_1 = ResnetBlock(mid, mid, precision, eps=1e-6, **kw)
        self.conv_norm_out = GroupNorm(mid, cfg.norm_groups, 1e-6, precision,
                                       device=device)
        self.conv_out = Conv(mid, 2 * cfg.latent_channels, precision,
                             device=device)
        self.quant_conv = (Conv2d(2 * cfg.latent_channels,
                                  2 * cfg.latent_channels, 1, precision,
                                  device=device)
                           if cfg.use_quant_conv else None)

    def forward(self, pixel_values):
        cfg = self.cfg
        x = self.conv_in(pixel_values.to(self.precision.compute_dtype))
        n = len(cfg.block_out_channels)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x)))
        x = self.conv_out(F.silu(self.conv_norm_out(x)))
        if self.quant_conv is not None:
            x = self.quant_conv(x)
        return x


def sample_latents(moments, generator: torch.Generator, cfg: VAEConfig):
    """DiagonalGaussianDistribution.sample() then the pipeline's scaling:
    (z - shift) * scaling, with z = mean + exp(logvar / 2) * eps and eps
    drawn from `generator` (on the moments' device)."""
    mean, logvar = moments.float().chunk(2, dim=-1)
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                      dtype=torch.float32)
    z = mean + std * eps
    if cfg.shift_factor:
        z = z - cfg.shift_factor
    return z * cfg.scaling_factor
