"""SD UNet (1.5 / 2.1 / image-variations / XL) with up-block feature harvest
(counterpart of the JAX package's `models/unet.py`).

The diffusion towers never denoise: one UNet pass at a fixed timestep, and
the hidden state after up block i is the feature (`dift_sd.py
MyUNet2DConditionModel.forward`, which stops past the largest index). Only
the up blocks up to the largest index the module is built for exist, and a
forward runs only those its call asks for.

- SD1.5 / imsd: block_out (320, 640, 1280, 1280), 8 heads (head sizes 40,
  80, 160), context 768, conv projections;
- SD2.1: the same blocks, heads (5, 10, 20) x 64, context 1024, linear
  projections, upcast attention;
- SDXL: block_out (320, 640, 1280), no attention in block 0, transformer
  depths (0, 2, 10), context 2048, linear projections. Its `text_time`
  addition embedding is never computed on the featurizer path (the
  reference's forward has no added-cond branch), so it is not built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from .diffusion_blocks import (Conv, Downsample, ResnetBlock,
                               SpatialTransformer, TimestepEmbedMLP,
                               Upsample, timestep_embedding)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    # heads a block; None: the block has no attention
    num_heads: Tuple[Optional[int], ...] = (8, 8, 8, None)
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 0)
    use_linear_projection: bool = False
    upcast_attention: bool = False
    norm_groups: int = 32
    addition_embed_type: Optional[str] = None     # "text_time" for XL
    addition_time_embed_dim: int = 256
    addition_pooled_dim: int = 1280
    head_dim_is_fixed: bool = False

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_and_dim(self, block_channels: int, heads: Optional[int]):
        if heads is None:
            return None, None
        return heads, block_channels // heads


def sd15_unet() -> UNetConfig:
    return UNetConfig()


def sd21_unet() -> UNetConfig:
    return UNetConfig(cross_attention_dim=1024, num_heads=(5, 10, 20, None),
                      use_linear_projection=True, upcast_attention=True)


def sdxl_unet() -> UNetConfig:
    return UNetConfig(block_out_channels=(320, 640, 1280),
                      cross_attention_dim=2048, num_heads=(None, 10, 20),
                      transformer_depth=(0, 2, 10),
                      use_linear_projection=True,
                      addition_embed_type="text_time",
                      addition_pooled_dim=1280)


def mid_heads(cfg: UNetConfig) -> Optional[int]:
    """The mid block's heads: the last block's that has attention."""
    for h in reversed(cfg.num_heads):
        if h is not None:
            return h
    return None


class UNetHarvest(nn.Module):
    """One-step UNet forward returning {i: feature [B, h, w, C]} for the
    requested up blocks, and {"pre{i}": ...} for `pre_up_indices` (the
    output of up block i before its upsampler: GeoAware-SC's taps).

    Built with `up_ft_indices` / `pre_up_indices`: up blocks 0 .. the
    largest of them exist. `forward` takes its own indices (default: the
    built ones) and runs only the up blocks they need."""

    def __init__(self, cfg: UNetConfig, up_ft_indices: Sequence[int] = (0,),
                 precision: Precision = DEFAULT_PRECISION,
                 pre_up_indices: Sequence[int] = (), *, device=None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        self.up_ft_indices = tuple(up_ft_indices)
        self.pre_up_indices = tuple(pre_up_indices)
        self.n_up = max(self.up_ft_indices + self.pre_up_indices) + 1
        kw = dict(groups=cfg.norm_groups, device=device)
        chans = cfg.block_out_channels
        n = len(chans)
        temb = cfg.time_embed_dim

        def attn(ch, heads, depth):
            h, d = cfg.heads_and_dim(ch, heads)
            return SpatialTransformer(
                ch, h, d, depth, cfg.cross_attention_dim, precision,
                use_linear_projection=cfg.use_linear_projection,
                upcast=cfg.upcast_attention, **kw)

        self.time_embedding = TimestepEmbedMLP(chans[0], temb, precision,
                                               device=device)
        self.conv_in = Conv(cfg.in_channels, chans[0], precision,
                            device=device)
        skips = [chans[0]]
        cin = chans[0]
        for i, ch in enumerate(chans):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(
                    cin, ch, precision, temb_dim=temb, **kw))
                cin = ch
                if cfg.num_heads[i] is not None:
                    self.add_module(f"down_{i}_attn_{j}", attn(
                        ch, cfg.num_heads[i], cfg.transformer_depth[i]))
                skips.append(ch)
            if i < n - 1:
                self.add_module(f"down_{i}_downsample",
                                Downsample(ch, ch, precision, device=device))
                skips.append(ch)
        mid = chans[-1]
        self.mid_res_0 = ResnetBlock(mid, mid, precision, temb_dim=temb, **kw)
        self.mid_attn = attn(mid, mid_heads(cfg),
                             cfg.transformer_depth[-1] or 1)
        self.mid_res_1 = ResnetBlock(mid, mid, precision, temb_dim=temb, **kw)
        rev = list(reversed(chans))
        x_ch = mid
        for i in range(self.n_up):
            out_ch = rev[i]
            down_idx = n - 1 - i
            for j in range(cfg.layers_per_block + 1):
                skip_ch = skips.pop()
                self.add_module(f"up_{i}_res_{j}", ResnetBlock(
                    x_ch + skip_ch, out_ch, precision, temb_dim=temb, **kw))
                x_ch = out_ch
                if cfg.num_heads[down_idx] is not None:
                    self.add_module(f"up_{i}_attn_{j}", attn(
                        out_ch, cfg.num_heads[down_idx],
                        cfg.transformer_depth[down_idx]))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample",
                                Upsample(out_ch, out_ch, precision,
                                         device=device))

    def forward(self, sample, timestep, encoder_hidden_states, *,
                up_ft_indices: Optional[Sequence[int]] = None,
                pre_up_indices: Optional[Sequence[int]] = None
                ) -> Dict:
        """sample [B, H, W, C_latent]; timestep a Python int; context
        [B, T, ctx_dim]."""
        up = self.up_ft_indices if up_ft_indices is None \
            else tuple(up_ft_indices)
        pre = self.pre_up_indices if pre_up_indices is None \
            else tuple(pre_up_indices)
        max_up = max(up + pre)
        if max_up >= self.n_up:
            raise ValueError(f"up block {max_up} asked of a UNetHarvest built "
                             f"through up block {self.n_up - 1}")
        cfg = self.cfg
        cd = self.precision.compute_dtype
        b = sample.shape[0]
        n = len(cfg.block_out_channels)
        ts = torch.full((b,), float(timestep), dtype=torch.float32,
                        device=sample.device)
        emb = self.time_embedding(
            timestep_embedding(ts, cfg.block_out_channels[0]))
        ctx = encoder_hidden_states.to(cd)
        x = self.conv_in(sample.to(cd))

        res_stack = [x]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x, emb)
                attn = getattr(self, f"down_{i}_attn_{j}", None)
                if attn is not None:
                    x = attn(x, ctx)
                res_stack.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x)
                res_stack.append(x)

        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x, emb), ctx), emb)

        harvested = {}
        for i in range(max_up + 1):
            for j in range(cfg.layers_per_block + 1):
                x = torch.cat([x, res_stack.pop()], dim=-1)
                x = getattr(self, f"up_{i}_res_{j}")(x, emb)
                attn = getattr(self, f"up_{i}_attn_{j}", None)
                if attn is not None:
                    x = attn(x, ctx)
            if i in pre:
                harvested[f"pre{i}"] = x
            if i < n - 1:
                x = getattr(self, f"up_{i}_upsample")(x)
            if i in up:
                harvested[i] = x
        return harvested
