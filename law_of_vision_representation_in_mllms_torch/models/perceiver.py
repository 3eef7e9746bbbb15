"""Perceiver resampler projector, `perceiverNx` (counterpart of the JAX
package's `models/perceiver.py`).

The reference's `perceiver_helpers.py` (Flamingo's PerceiverResampler: 64
learned latents cross-attend to the image tokens, N blocks of attention and
feed-forward, a final LayerNorm) followed by a Linear to the LLM width.
Its `build_vision_projector` passes only the width and the depth, so the
heads (8 of 64), the latents (64) and the feed-forward's factor (4) are the
defaults.

Each block's attention lets the latents attend over [image tokens; latents],
non-causal: at CLIP-L/14-336 that is Sq = 64 against Skv = 576 + 64 = 640,
8 heads of 64. It runs through `ops.flash_attention.flash_attention`:
kernel 2 forward on the card, kernels 5 and 6 backward under autograd (the
stage-1 gradient), the plain version for CPU tensors. The JAX function
computes it as an fp32 softmax whose probabilities it casts to the compute
dtype before P·V; kernel 2 rounds P to bf16 there too, so both compute the
same function. LayerNorms take fp32 statistics (eps 1e-5) and give the
compute dtype; residuals stay in the compute dtype; the GELU is exact.
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.activations import gelu_exact
from ..ops.flash_attention import flash_attention
from .layers import Dense, LayerNorm32

# the reference's defaults (`perceiver_helpers.py:73-76`)
NUM_LATENTS = 64
DEFAULT_HEADS = 8
HEAD_DIM = 64
FF_MULT = 4
LN_EPS = 1e-5


class PerceiverLayer(nn.Module):
    """One block: the latents' cross-attention over [media; latents], then a
    feed-forward, each added to the latents."""

    def __init__(self, d: int, precision: Precision, *, device=None):
        super().__init__()
        inner = DEFAULT_HEADS * HEAD_DIM
        kw = dict(device=device)
        self.norm_media = LayerNorm32(d, LN_EPS, precision, **kw)
        self.norm_latents = LayerNorm32(d, LN_EPS, precision, **kw)
        self.to_q = Dense(d, inner, precision, bias=False, init_std=0.02, **kw)
        self.to_kv = Dense(d, 2 * inner, precision, bias=False,
                           init_std=0.02, **kw)
        self.to_out = Dense(inner, d, precision, bias=False, init_std=0.02,
                            **kw)
        self.ff_norm = LayerNorm32(d, LN_EPS, precision, **kw)
        self.ff_in = Dense(d, d * FF_MULT, precision, bias=False,
                           init_std=0.02, **kw)
        self.ff_out = Dense(d * FF_MULT, d, precision, bias=False,
                            init_std=0.02, **kw)

    def forward(self, x, lat):
        b, n = lat.shape[:2]
        xm, lm = self.norm_media(x), self.norm_latents(lat)
        q = self.to_q(lm).view(b, n, DEFAULT_HEADS, HEAD_DIM)
        kv = self.to_kv(torch.cat([xm, lm], dim=1))
        kv = kv.view(b, kv.shape[1], 2, DEFAULT_HEADS, HEAD_DIM)
        k, v = kv[:, :, 0].contiguous(), kv[:, :, 1].contiguous()
        out = flash_attention(q, k, v, causal=False)
        lat = lat + self.to_out(out.reshape(b, n, DEFAULT_HEADS * HEAD_DIM))
        h = gelu_exact(self.ff_in(self.ff_norm(lat)))
        return lat + self.ff_out(h)


class PerceiverResampler(nn.Module):
    """feats [B, P, mm_hidden] -> [B, NUM_LATENTS, hidden]. The state dict
    holds `latents` [NUM_LATENTS, d], `layers.{i}.{norm_media, norm_latents,
    to_q, to_kv, to_out, ff_norm, ff_in, ff_out}`, `final_norm` and `proj`;
    `io.from_jax.perceiver_state_dict` / `perceiver_tree` map it to and from
    the JAX tree."""

    def __init__(self, depth: int, mm_hidden_size: int, hidden_size: int,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        d = mm_hidden_size
        self.precision = precision
        self.latents = nn.Parameter(
            torch.empty(NUM_LATENTS, d, device=device,
                        dtype=precision.param_dtype), requires_grad=False)
        self.layers = nn.ModuleList(
            PerceiverLayer(d, precision, device=device)
            for _ in range(depth))
        self.final_norm = LayerNorm32(d, LN_EPS, precision, device=device)
        self.proj = Dense(d, hidden_size, precision, init_std=0.02,
                          device=device)

    def reset_parameters(self, generator):
        # the JAX init: latents N(0, 1), every matrix N(0, 0.02), zero bias
        self.latents.normal_(0.0, 1.0, generator=generator)

    def forward(self, feats):
        cd = self.precision.compute_dtype
        x = feats.to(cd)
        lat = self.latents.to(cd)[None].expand(x.shape[0], -1, -1)
        for layer in self.layers:
            lat = layer(x, lat)
        return self.proj(self.final_norm(lat))
