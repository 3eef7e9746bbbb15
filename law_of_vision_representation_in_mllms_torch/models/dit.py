"""DiT-XL/2 feature extractor (counterpart of the JAX package's
`models/dit.py`: facebook/DiT-XL-2-512 with the class conditioning stripped).

Patchify (a p x p conv of stride p on the VAE latent) plus fixed 2D sincos
position embeddings, then adaLN-Zero blocks: self-attention with q, k, v and
out biases, a tanh-GELU MLP, and a timestep modulation of its own a block
(`t_embedder_{i}`, the reference's `MyCombinedTimestepLabelEmbeddings`
without the class embedding). The hidden states after the requested blocks
are the features (negative indices count from the end); only the blocks up
to the largest index exist. `unfold_tokens_2x2` is the reference's 2x2
token unfold (`dift_dit.py:192-195`).

Module and parameter names follow the Flax tree, so the JAX params map
across name by name (`io.from_jax.flax_state_dict`). The attention is
`diffusion_blocks.diffusion_attention` (kernel 2 non-causal on the card: at
1,152 channels over 16 heads its head size is 72), whatever
`diffusion_attn_impl` names. Both LayerNorms have no affine and run in fp32
(norm1 at eps 1e-6, norm3 at 1e-5).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.activations import gelu_tanh
from .diffusion_blocks import (Conv2d, TimestepEmbedMLP, diffusion_attention,
                               timestep_embedding)
from .layers import Dense


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    in_channels: int = 4
    hidden_size: int = 1152
    num_layers: int = 28
    num_heads: int = 16
    patch_size: int = 2
    sample_size: int = 64             # latent grid (512 / 8)
    timestep_freq_shift: float = 1.0  # CombinedTimestepLabelEmbeddings

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def dit_xl_2() -> DiTConfig:
    return DiTConfig()


TINY_TEST_CONFIG = DiTConfig(hidden_size=16, num_layers=3, num_heads=2,
                             sample_size=8)


def sincos_pos_embed_2d(embed_dim: int, grid_h: int, grid_w: int,
                        base_size: int = 16, interpolation_scale: float = 1.0,
                        scale_by_base: bool = False) -> np.ndarray:
    """diffusers `get_2d_sincos_pos_embed`: half the dim encodes the grid's
    x, half its y, each as [sin, cos] over 10000^(-2i/d); [h * w, dim]
    fp32, x fastest."""
    def axis(pos, dim):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid_h, dtype=np.float32)
    gw = np.arange(grid_w, dtype=np.float32)
    if scale_by_base:
        gh = gh / (grid_h / base_size) / interpolation_scale
        gw = gw / (grid_w / base_size) / interpolation_scale
    grid = np.stack(np.meshgrid(gw, gh))            # [2, h, w]
    emb_x = axis(grid[0], embed_dim // 2)
    emb_y = axis(grid[1], embed_dim // 2)
    return np.concatenate([emb_x, emb_y], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _pos_embed(dim: int, gh: int, gw: int, base: int, device,
               dtype) -> torch.Tensor:
    # HF PatchEmbed rescales the grid by (grid / base) off the native size
    return torch.from_numpy(sincos_pos_embed_2d(
        dim, gh, gw, base_size=base, scale_by_base=(gh != base or gw != base))
    ).to(device=device, dtype=dtype)


def layer_norm32(x, eps: float, dtype):
    """LayerNorm without affine, statistics in fp32, output in `dtype`."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(dtype)


def modulate(h, scale, shift):
    return h * (1 + scale[:, None]) + shift[:, None]


class AdaLNZero(nn.Module):
    """linear(silu(cond)) -> 6 modulation tensors; the input LayerNorm'd
    (eps 1e-6, no affine) and modulated by the first two."""

    def __init__(self, dim: int, precision: Precision, *, device=None):
        super().__init__()
        self.precision = precision
        self.linear = Dense(dim, 6 * dim, precision, device=device)

    def forward(self, x, cond):
        cd = self.precision.compute_dtype
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.linear(F.silu(cond.to(cd))).chunk(6, dim=-1)
        h = modulate(layer_norm32(x, 1e-6, cd), scale_msa, shift_msa)
        return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


def heads_view(x, heads: int):
    b, s, d = x.shape
    return x.view(b, s, heads, d // heads)


class SelfAttentionBias(nn.Module):
    """q, k, v and out, each with a bias (DiT's attention_bias=True)."""

    def __init__(self, dim: int, heads: int, precision: Precision, *,
                 device=None):
        super().__init__()
        self.heads, self.precision = heads, precision
        for name in ("to_q", "to_k", "to_v", "to_out"):
            self.add_module(name, Dense(dim, dim, precision, device=device))

    def forward(self, x):
        b, s, d = x.shape
        q, k, v = (heads_view(f(x), self.heads)
                   for f in (self.to_q, self.to_k, self.to_v))
        o = diffusion_attention(q, k, v, self.precision.compute_dtype)
        return self.to_out(o.reshape(b, s, d))


class FFGeluTanh(nn.Module):
    def __init__(self, dim: int, precision: Precision, *, mult: int = 4,
                 device=None):
        super().__init__()
        self.proj_in = Dense(dim, dim * mult, precision, device=device)
        self.proj_out = Dense(dim * mult, dim, precision, device=device)

    def forward(self, x):
        return self.proj_out(gelu_tanh(self.proj_in(x)))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, precision: Precision, *, device=None):
        super().__init__()
        self.precision = precision
        kw = dict(device=device)
        self.norm1 = AdaLNZero(cfg.hidden_size, precision, **kw)
        self.attn1 = SelfAttentionBias(cfg.hidden_size, cfg.num_heads,
                                       precision, **kw)
        self.ff = FFGeluTanh(cfg.hidden_size, precision, **kw)

    def forward(self, x, t_cond):
        h, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.norm1(x, t_cond)
        x = x + gate_msa[:, None] * self.attn1(h)
        h = modulate(layer_norm32(x, 1e-5, self.precision.compute_dtype),
                     scale_mlp, shift_mlp)
        return x + gate_mlp[:, None] * self.ff(h)


def resolve_blocks(indices: Sequence[int], num_layers: int) -> Tuple[int, ...]:
    """Harvest indices (negative ones count from the end) -> block indices."""
    return tuple(i % num_layers for i in indices)


class DiTHarvest(nn.Module):
    """Patchify, position embedding and the blocks through the largest of
    `up_ft_indices`; `forward` returns {index: [B, N, hidden]} for the
    indices it is given (default: the built ones)."""

    def __init__(self, cfg: DiTConfig, up_ft_indices: Sequence[int] = (-1,),
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        self.up_ft_indices = tuple(up_ft_indices)
        self.n_blocks = max(resolve_blocks(self.up_ft_indices,
                                           cfg.num_layers)) + 1
        kw = dict(device=device)
        d, p = cfg.hidden_size, cfg.patch_size
        self.patch_proj = Conv2d(cfg.in_channels, d, p, precision, stride=p,
                                 **kw)
        for i in range(self.n_blocks):
            self.add_module(f"t_embedder_{i}",
                            TimestepEmbedMLP(256, d, precision, **kw))
            self.add_module(f"block_{i}", DiTBlock(cfg, precision, **kw))

    def forward(self, latents, timestep, *, up_ft_indices=None) -> Dict:
        """latents [B, h, w, C] noisy VAE latents; timestep a Python int."""
        cfg = self.cfg
        cd = self.precision.compute_dtype
        up = self.up_ft_indices if up_ft_indices is None \
            else tuple(up_ft_indices)
        resolved = resolve_blocks(up, cfg.num_layers)
        if max(resolved) >= self.n_blocks:
            raise ValueError(f"block {max(resolved)} asked of a DiTHarvest "
                             f"built through block {self.n_blocks - 1}")
        b, h, w, _ = latents.shape
        p = cfg.patch_size
        x = self.patch_proj(latents.to(cd)).reshape(b, -1, cfg.hidden_size)
        x = x + _pos_embed(cfg.hidden_size, h // p, w // p,
                           cfg.sample_size // p, x.device, cd)[None]
        ts = torch.full((b,), float(timestep), dtype=torch.float32,
                        device=latents.device)
        t_emb = timestep_embedding(ts, 256, freq_shift=cfg.timestep_freq_shift)
        harvested = {}
        for i in range(max(resolved) + 1):
            cond = getattr(self, f"t_embedder_{i}")(t_emb)
            x = getattr(self, f"block_{i}")(x, cond)
            for orig, r in zip(up, resolved):
                if r == i:
                    harvested[orig] = x
        return harvested


def unfold_tokens_2x2(tokens):
    """[B, N, C] row-major token grid -> [B, (h/2)(w/2), 4C]
    (`dift_dit.py:192-195`): output channel = offset * C + c with offset =
    x_offset * 2 + y_offset, the torch double-unfold order."""
    b, n, c = tokens.shape
    h = w = int(round(n ** 0.5))
    grid = tokens.reshape(b, h // 2, 2, w // 2, 2, c)   # [B,y2,yo,x2,xo,C]
    grid = grid.permute(0, 1, 3, 4, 2, 5)               # [B,y2,x2,xo,yo,C]
    return grid.reshape(b, (h // 2) * (w // 2), 4 * c)
