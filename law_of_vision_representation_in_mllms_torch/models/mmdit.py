"""SD3 MMDiT feature extractor (counterpart of the JAX package's
`models/mmdit.py`: stabilityai/stable-diffusion-3-medium).

Patchify plus a position embedding centre-cropped from a [1, 192², D]
parameter, a timestep + pooled-text conditioning, then joint blocks: the
latent and the context tokens each have their own adaLN-Zero, projections
and MLP, and one attention runs over their concatenation [latent, context]
(kernel 2 non-causal on the card, head size 64). The latent stream's hidden
states after the requested blocks are the features; only the blocks up to
the largest index exist. The last block of the model is `context_pre_only`:
its context stream is only normalised (`norm1_context_linear`) and has no
output projection or MLP. T5 is dropped (`dift_sd3.py:131-132`): its 256
context slots are zeros in the precomputed `prompt_embeds`.

`flow_match_add_noise` keeps the reference's raw integer t: x_t = t x0 +
(1 - t) eps, so t = 1 returns the clean latents.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from .diffusion_blocks import (Conv2d, TimestepEmbedMLP, diffusion_attention,
                               timestep_embedding)
from .dit import (AdaLNZero, FFGeluTanh, heads_view, layer_norm32, modulate,
                  resolve_blocks)
from .layers import Dense


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    in_channels: int = 16
    hidden_size: int = 1536
    num_layers: int = 24
    num_heads: int = 24
    patch_size: int = 2
    context_dim: int = 4096          # T5 / CLIP joint context width
    pooled_dim: int = 2048           # pooled CLIP-L + bigG
    pos_embed_max_size: int = 192

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def sd3_medium() -> MMDiTConfig:
    return MMDiTConfig()


TINY_TEST_CONFIG = MMDiTConfig(in_channels=4, hidden_size=16, num_layers=2,
                               num_heads=2, context_dim=24, pooled_dim=12,
                               pos_embed_max_size=8)


class JointBlock(nn.Module):
    """MMDiT dual-stream block (diffusers `JointTransformerBlock`)."""

    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool = False,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        self.context_pre_only = context_pre_only
        d = cfg.hidden_size
        kw = dict(device=device)
        self.norm1 = AdaLNZero(d, precision, **kw)
        if context_pre_only:
            # AdaLayerNormContinuous: linear(silu(cond)) -> (scale, shift)
            self.norm1_context_linear = Dense(d, 2 * d, precision, **kw)
        else:
            self.norm1_context = AdaLNZero(d, precision, **kw)
        names = ["to_q", "to_k", "to_v", "add_q_proj", "add_k_proj",
                 "add_v_proj", "to_out"]
        if not context_pre_only:
            names.append("to_add_out")
        for name in names:
            self.add_module(name, Dense(d, d, precision, **kw))
        self.ff = FFGeluTanh(d, precision, **kw)
        if not context_pre_only:
            self.ff_context = FFGeluTanh(d, precision, **kw)

    def forward(self, x, ctx, cond):
        cd = self.precision.compute_dtype
        h = self.cfg.num_heads
        s = x.shape[1]
        hx, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, cond)
        if self.context_pre_only:
            scale_c, shift_c = self.norm1_context_linear(
                F.silu(cond.to(cd))).chunk(2, dim=-1)
            hc = modulate(layer_norm32(ctx, 1e-6, cd), scale_c, shift_c)
        else:
            hc, c_gate_msa, c_shift_mlp, c_scale_mlp, c_gate_mlp = \
                self.norm1_context(ctx, cond)
        # joint attention over [latent, context] along the sequence
        q, k, v = (heads_view(torch.cat([fx(hx), fc(hc)], dim=1), h)
                   for fx, fc in ((self.to_q, self.add_q_proj),
                                  (self.to_k, self.add_k_proj),
                                  (self.to_v, self.add_v_proj)))
        o = diffusion_attention(q, k, v, cd).flatten(2)
        attn_x, attn_c = o[:, :s], o[:, s:]

        x = x + gate_msa[:, None] * self.to_out(attn_x)
        hm = modulate(layer_norm32(x, 1e-6, cd), scale_mlp, shift_mlp)
        x = x + gate_mlp[:, None] * self.ff(hm)
        if self.context_pre_only:
            return x, None
        ctx = ctx + c_gate_msa[:, None] * self.to_add_out(attn_c)
        hm = modulate(layer_norm32(ctx, 1e-6, cd), c_scale_mlp, c_shift_mlp)
        return x, ctx + c_gate_mlp[:, None] * self.ff_context(hm)


class MMDiTHarvest(nn.Module):
    """Patchify, the cropped position embedding, the conditioning, the
    context embedder and the joint blocks through the largest of
    `up_ft_indices`; `forward` returns {index: [B, N, hidden]} latent-stream
    states for the indices it is given (default: the built ones)."""

    def __init__(self, cfg: MMDiTConfig, up_ft_indices: Sequence[int] = (-1,),
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        self.up_ft_indices = tuple(up_ft_indices)
        self.n_blocks = max(resolve_blocks(self.up_ft_indices,
                                           cfg.num_layers)) + 1
        kw = dict(device=device)
        d, p, m = cfg.hidden_size, cfg.patch_size, cfg.pos_embed_max_size
        self.patch_proj = Conv2d(cfg.in_channels, d, p, precision, stride=p,
                                 **kw)
        # fp32 whatever the param dtype, as the JAX parameter is
        self.pos_embed = nn.Parameter(
            torch.zeros(1, m * m, d, dtype=torch.float32, device=device),
            requires_grad=False)
        self.timestep_embedder = TimestepEmbedMLP(256, d, precision, **kw)
        self.text_embedder = TimestepEmbedMLP(cfg.pooled_dim, d, precision,
                                              **kw)
        self.context_embedder = Dense(cfg.context_dim, d, precision, **kw)
        for i in range(self.n_blocks):
            self.add_module(f"block_{i}", JointBlock(
                cfg, i == cfg.num_layers - 1, precision, **kw))

    def forward(self, latents, timestep, context, pooled, *,
                up_ft_indices=None) -> Dict:
        """latents [B, h, w, C]; timestep a Python int; context
        [B, T, context_dim]; pooled [B, pooled_dim]."""
        cfg = self.cfg
        cd = self.precision.compute_dtype
        up = self.up_ft_indices if up_ft_indices is None \
            else tuple(up_ft_indices)
        resolved = resolve_blocks(up, cfg.num_layers)
        if max(resolved) >= self.n_blocks:
            raise ValueError(f"block {max(resolved)} asked of an "
                             f"MMDiTHarvest built through block "
                             f"{self.n_blocks - 1}")
        b, h, w, _ = latents.shape
        d, p, m = cfg.hidden_size, cfg.patch_size, cfg.pos_embed_max_size
        gh, gw = h // p, w // p
        x = self.patch_proj(latents.to(cd)).reshape(b, gh * gw, d)
        top, left = (m - gh) // 2, (m - gw) // 2
        pos = self.pos_embed.view(1, m, m, d)[:, top:top + gh,
                                              left:left + gw]
        x = x + pos.reshape(1, gh * gw, d).to(cd)
        ts = torch.full((b,), float(timestep), dtype=torch.float32,
                        device=latents.device)
        cond = (self.timestep_embedder(timestep_embedding(ts, 256))
                + self.text_embedder(pooled.to(cd)))
        ctx = self.context_embedder(context.to(cd))
        harvested = {}
        for i in range(max(resolved) + 1):
            x, ctx = getattr(self, f"block_{i}")(x, ctx, cond)
            for orig, r in zip(up, resolved):
                if r == i:
                    harvested[orig] = x
        return harvested


def flow_match_add_noise(latents, noise, t):
    """FlowMatchEulerDiscreteScheduler.add_noise as the reference calls it
    (`dift_sd3.py:112`, integer t): x_t = t x0 + (1 - t) eps with the raw
    integer t, in fp32, returned in the latents' dtype; t = 1 returns the
    clean latents."""
    t = float(t)
    return (t * latents.float() + (1.0 - t) * noise.float()).to(latents.dtype)
