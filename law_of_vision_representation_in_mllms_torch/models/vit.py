"""One parameterized ViT for the non-diffusion tower zoo (counterpart of the
JAX package's `models/vit.py`).

CLIP-L/14 @224/@336, OpenCLIP-L/14, SigLIP-B/16, DINOv2 and the tiny debug
tower are all `ViTConfig`s. The patch embedding is an unfold in NHWC order
(ph, pw, c) followed by a matmul, exactly as the JAX tower does it, so a JAX
`patch_kernel (p, p, c, D)` maps onto it by a reshape. `ViTTower` builds only
the blocks `select_layer` needs (`select_layer=-2` runs N-1 blocks).

`ViTConfig.attn_impl` takes the JAX tower's names (`model.tower_attn_impl`)
and maps each onto the Hopper kernel that computes the same function:
- `auto`, `encoder`, `encoder2*` (the per-head 2-D-dot TPU kernel
  `encoder_mha_v2`; its `_nt`, `_pad`, `_hbN` options change the TPU layout
  only) and `tpu_flash` (the JAX library's TPU flash kernel) run kernel 1
  (`ops.encoder_attention`);
- `flash` (the TPU kernel `flash_attention_bhsd`, non-causal, no ALiBi) runs
  kernel 2 (`ops.flash_attention`) non-causal with `kv_len = S`;
- `xla`, `xla_post`, `xla_blocked`, `xla_expclamp*` name XLA formulations of
  the same softmax attention that exist to steer the TPU compiler; a fused
  kernel never writes logits, so they run kernel 1 too.
An unknown name raises ValueError. For CPU tensors every route is the
wrapper's plain version.
"""

from __future__ import annotations

import dataclasses
import re

import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.activations import ACT2FN
from ..ops.encoder_attention import encoder_attention
from ..ops.flash_attention import flash_attention
from .layers import Dense, LayerNorm32


_KERNEL1_IMPLS = re.compile(
    r"auto|encoder|encoder2(_nt|_pad|_hb\d+)*|tpu_flash|xla|xla_post|"
    r"xla_blocked|xla_expclamp(_fused)?")


def attention_route(attn_impl: str) -> str:
    """The port's kernel for a JAX `attn_impl` name: "encoder" (kernel 1) or
    "flash" (kernel 2, non-causal)."""
    if attn_impl == "flash":
        return "flash"
    if isinstance(attn_impl, str) and _KERNEL1_IMPLS.fullmatch(attn_impl):
        return "encoder"
    raise ValueError(f"unknown tower attn_impl {attn_impl!r}")


def attend(route: str, q, k, v):
    """Non-causal attention over a whole tower sequence, q, k, v
    [B, S, H, D], through the kernel of `route` (see `attention_route`)."""
    if route == "flash":
        return flash_attention(q, k, v, causal=False)
    return encoder_attention(q, k, v)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    use_class_token: bool = True
    use_pre_layernorm: bool = True
    patch_bias: bool = False
    use_layerscale: bool = False
    num_channels: int = 3
    # patch-embedding stride; None -> patch_size (non-overlapping tiling)
    stride: int | None = None
    # a JAX tower route name; see `attention_route`
    attn_impl: str = "auto"

    @property
    def stride_(self) -> int:
        return self.patch_size if self.stride is None else self.stride

    @property
    def grid(self) -> int:
        return 1 + (self.image_size - self.patch_size) // self.stride_

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + (1 if self.use_class_token else 0)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def resolve_layer(self, select_layer: int) -> int:
        """HF hidden_states index (e.g. -2) -> number of blocks to run."""
        return select_layer % (self.num_layers + 1)


def clip_l14(image_size: int = 224, act: str = "quick_gelu") -> ViTConfig:
    return ViTConfig(image_size=image_size, patch_size=14, hidden_size=1024,
                     num_layers=24, num_heads=16, intermediate_size=4096,
                     hidden_act=act, layer_norm_eps=1e-5,
                     use_class_token=True, use_pre_layernorm=True,
                     patch_bias=False)


def siglip_b16(image_size: int = 224) -> ViTConfig:
    return ViTConfig(image_size=image_size, patch_size=16, hidden_size=768,
                     num_layers=12, num_heads=12, intermediate_size=3072,
                     hidden_act="gelu_tanh", layer_norm_eps=1e-6,
                     use_class_token=False, use_pre_layernorm=False,
                     patch_bias=True)


def dinov2_large(image_size: int = 224) -> ViTConfig:
    # LayerScale is folded into the o/fc2 weights when HF weights are ported
    return ViTConfig(image_size=image_size, patch_size=14, hidden_size=1024,
                     num_layers=24, num_heads=16, intermediate_size=4096,
                     hidden_act="gelu", layer_norm_eps=1e-6,
                     use_class_token=True, use_pre_layernorm=False,
                     patch_bias=True, use_layerscale=False)


def dinov2_base(image_size: int = 224, stride: int | None = None) -> ViTConfig:
    return ViTConfig(image_size=image_size, patch_size=14, hidden_size=768,
                     num_layers=12, num_heads=12, intermediate_size=3072,
                     hidden_act="gelu", layer_norm_eps=1e-6,
                     use_class_token=True, use_pre_layernorm=False,
                     patch_bias=True, use_layerscale=False, stride=stride)


def tiny_vit(image_size: int = 28) -> ViTConfig:
    """Debug/smoke-run tower (also used by CLI tests)."""
    return ViTConfig(image_size=image_size, patch_size=7, hidden_size=32,
                     num_layers=2, num_heads=4, intermediate_size=64)


VIT_PRESETS = {
    "debug/tiny-vit": lambda: tiny_vit(),
    "debug/tiny-vit-112": lambda: tiny_vit(112),
    "openai/clip-vit-large-patch14": lambda: clip_l14(224),
    "openai/clip-vit-large-patch14-336": lambda: clip_l14(336),
    "laion/CLIP-ViT-L-14-laion2B-s32B-b82K": lambda: clip_l14(224, act="gelu"),
    "google/siglip-base-patch16-224": lambda: siglip_b16(224),
    "facebook/dinov2-large": lambda: dinov2_large(224),
    "facebook/dinov2-large-336": lambda: dinov2_large(336),
    "facebook/dinov2-base": lambda: dinov2_base(224),
    "facebook/dinov2-base-840": lambda: dinov2_base(840),
}


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, precision: Precision, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.route = attention_route(cfg.attn_impl)
        d, i = cfg.hidden_size, cfg.intermediate_size
        eps = cfg.layer_norm_eps
        self.ln1 = LayerNorm32(d, eps, precision, device=device)
        self.q = Dense(d, d, precision, device=device)
        self.k = Dense(d, d, precision, device=device)
        self.v = Dense(d, d, precision, device=device)
        self.o = Dense(d, d, precision, device=device)
        self.ln2 = LayerNorm32(d, eps, precision, device=device)
        self.fc1 = Dense(d, i, precision, device=device)
        self.fc2 = Dense(i, d, precision, device=device)
        if cfg.use_layerscale:
            kw = dict(device=device, dtype=precision.param_dtype)
            self.ls1 = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
            self.ls2 = nn.Parameter(torch.empty(d, **kw), requires_grad=False)

    def reset_parameters(self, generator):
        if self.cfg.use_layerscale:
            self.ls1.fill_(1.0)
            self.ls2.fill_(1.0)

    def forward(self, x):
        cfg = self.cfg
        h = self.ln1(x)
        b, s, _ = h.shape
        shape = (b, s, cfg.num_heads, cfg.head_dim)
        attn = attend(self.route, self.q(h).view(shape),
                      self.k(h).view(shape), self.v(h).view(shape))
        attn = self.o(attn.reshape(b, s, cfg.hidden_size))
        if cfg.use_layerscale:
            attn = attn * self.ls1.to(attn.dtype)
        x = x + attn
        h = self.fc2(ACT2FN[cfg.hidden_act](self.fc1(self.ln2(x))))
        if cfg.use_layerscale:
            h = h * self.ls2.to(h.dtype)
        return x + h


class ViTEncoder(nn.Module):
    """ViT trunk. `forward(pixel_values)` takes NHWC images already
    normalized for the tower and returns the last run block's output."""

    def __init__(self, cfg: ViTConfig,
                 precision: Precision = DEFAULT_PRECISION, *,
                 num_blocks: int | None = None, device=None):
        super().__init__()
        self.cfg = cfg
        self.precision = precision
        p, c, d = cfg.patch_size, cfg.num_channels, cfg.hidden_size
        kw = dict(device=device, dtype=precision.param_dtype)
        self.patch_embed = Dense(p * p * c, d, precision, bias=cfg.patch_bias,
                                 device=device)
        self.cls_token = (nn.Parameter(torch.empty(1, 1, d, **kw),
                                       requires_grad=False)
                          if cfg.use_class_token else None)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.seq_len, d, **kw),
                                      requires_grad=False)
        self.pre_ln = (LayerNorm32(d, cfg.layer_norm_eps, precision,
                                   device=device)
                       if cfg.use_pre_layernorm else None)
        n = cfg.num_layers if num_blocks is None else num_blocks
        self.blocks = nn.ModuleList(
            ViTBlock(cfg, precision, device=device) for _ in range(n))

    def reset_parameters(self, generator):
        if self.cls_token is not None:
            self.cls_token.zero_()
        self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixel_values):
        cfg = self.cfg
        b, h, w, c = pixel_values.shape
        p, st = cfg.patch_size, cfg.stride_
        gh = 1 + (h - p) // st
        gw = 1 + (w - p) // st
        x = pixel_values.to(self.precision.compute_dtype)
        if st == p:
            x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        else:
            # overlapping patches: strided gathers along H then W, into the
            # same (gh, gw, p, p, c) layout as the fast path
            dev = x.device
            idx_h = (torch.arange(gh, device=dev)[:, None] * st
                     + torch.arange(p, device=dev)[None, :])
            idx_w = (torch.arange(gw, device=dev)[:, None] * st
                     + torch.arange(p, device=dev)[None, :])
            x = x[:, idx_h][:, :, :, idx_w].permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(b, gh * gw, p * p * c))
        if self.cls_token is not None:
            cls = self.cls_token.to(x.dtype).expand(b, 1, cfg.hidden_size)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        if self.pre_ln is not None:
            x = self.pre_ln(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class ViTTower(nn.Module):
    """The LLaVA-facing tower: hidden-layer selection + CLS handling
    (`CLIPVisionTower.feature_select`). Only `resolve_layer(select_layer)`
    blocks exist."""

    def __init__(self, cfg: ViTConfig, select_layer: int = -2,
                 select_feature: str = "patch",
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        if select_feature not in ("patch", "cls_patch"):
            raise ValueError(f"bad select_feature {select_feature}")
        self.cfg = cfg
        self.select_feature = select_feature
        self.encoder = ViTEncoder(cfg, precision,
                                  num_blocks=cfg.resolve_layer(select_layer),
                                  device=device)

    def forward(self, pixel_values):
        feats = self.encoder(pixel_values)
        if self.select_feature == "patch" and self.cfg.use_class_token:
            feats = feats[:, 1:]
        return feats


class CLIPVisionPooled(nn.Module):
    """CLIPVisionModelWithProjection: the whole trunk, post-LN on the CLS
    token, then `visual_projection` [hidden, projection_dim] (a raw matrix,
    as in the JAX tree). The SD image-variations featurizer's conditioner
    (`dift_imsd.py:215-221`); at 224 px its attention is kernel 1 (S = 257,
    D = 64)."""

    def __init__(self, cfg: ViTConfig, projection_dim: int,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        self.encoder = ViTEncoder(cfg, precision, device=device)
        self.post_ln = LayerNorm32(cfg.hidden_size, cfg.layer_norm_eps,
                                   precision, device=device)
        self.visual_projection = nn.Parameter(
            torch.empty(cfg.hidden_size, projection_dim, device=device,
                        dtype=precision.param_dtype), requires_grad=False)

    def reset_parameters(self, generator):
        self.visual_projection.normal_(0.0, 0.02, generator=generator)

    def forward(self, pixel_values):
        cls = self.post_ln(self.encoder(pixel_values)[:, 0])
        return cls @ self.visual_projection.to(cls.dtype)
