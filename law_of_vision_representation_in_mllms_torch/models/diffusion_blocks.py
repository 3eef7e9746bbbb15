"""Building blocks of the diffusion towers' VAE encoder and SD UNets
(counterpart of the JAX package's `models/diffusion_blocks.py`).

Activations are NHWC at every module boundary, as in the JAX package, so a
feature map flattens to tokens in the same order; a convolution, a GroupNorm
and the nearest upsampling run on the NCHW view of the same memory (a
channels-last tensor to cuDNN), and a conv weight is the Flax kernel
[kh, kw, I, O] transposed to [O, I, kh, kw] (`io.from_jax`). Module and
parameter names follow the Flax tree (`conv_in.conv.weight` is Flax's
`conv_in/conv/kernel`), so the JAX params map across name by name.

Precision as in the JAX blocks: matmuls and convolutions in
`precision.compute_dtype`; GroupNorm statistics in `precision.accum_dtype`;
the transformer blocks' LayerNorms in fp32.

Attention. `CrossAttention` (every UNet attention) runs kernel 2,
non-causal, `kv_len = Skv` (`ops.flash_attention`), whatever
`diffusion_attn_impl` names: `None`, `flash`, `auto`, `xla_expclamp` and
`xla_expclamp_fused` are the JAX package's formulations of one softmax
attention (the `xla_*` ones steer the TPU compiler; a fused kernel writes no
logits), and an unknown name raises ValueError. On CPU tensors the kernel's
wrapper runs its plain version. SD2.1's `upcast_attention` runs kernel 2 on
the bf16 q, k and v: in the JAX package they leave bf16 `Dense`s before the
upcast, so they hold bf16 values already, and the kernel accumulates Q·Kᵀ,
the softmax and P·V in fp32 as the upcast asks; only P is rounded to bf16
before P·V (the upcast path keeps it in fp32), a difference that stands.
`VAESelfAttention` (one head of 512 channels in the VAE's mid block) calls
the plain `ops.attention.mha`, as the JAX block calls its `mha`: no Pallas
kernel computes it there either.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import Precision
from ..ops.attention import mha
from ..ops.flash_attention import flash_attention
from .layers import Dense, LayerNorm32

# the JAX package's `diffusion_attn_impl` names; each runs kernel 2
ATTN_IMPLS = (None, "flash", "auto", "xla_expclamp", "xla_expclamp_fused")


def check_attn_impl(impl: Optional[str]) -> None:
    """`model.diffusion_attn_impl` must be one of the JAX package's route
    names; every one of them runs kernel 2, so nothing else depends on
    it."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown diffusion_attn_impl {impl!r}; one of "
                         f"{ATTN_IMPLS}")


def nchw(x):
    """The NCHW view of an NHWC tensor (channels-last memory)."""
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def timestep_embedding(timesteps, dim: int, *, flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0,
                       max_period: float = 10000.0):
    """Sinusoidal timestep embedding: timesteps [B] -> [B, dim] fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


class Conv2d(nn.Module):
    """A Flax `nn.Conv` on NHWC activations: weight [O, I, kh, kw], bias
    [O], symmetric zero padding, computed in the compute dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, precision: Precision,
                 *, stride: int = 1, padding: int = 0, device=None):
        super().__init__()
        self.precision = precision
        self.stride, self.padding = stride, padding
        kw = dict(device=device, dtype=precision.param_dtype)
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, **kw),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty(cout, **kw), requires_grad=False)

    def forward(self, x):
        cd = self.precision.compute_dtype
        y = F.conv2d(nchw(x.to(cd)), self.weight.to(cd), self.bias.to(cd),
                     stride=self.stride, padding=self.padding)
        return nhwc(y)

    def reset_parameters(self, generator):
        # Flax's lecun-normal kernel, zero bias
        fan_in = self.weight[0].numel()
        self.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
        self.bias.zero_()


class Conv(nn.Module):
    """The JAX `Conv` block: a k x k conv named `conv`."""

    def __init__(self, cin: int, cout: int, precision: Precision, *,
                 kernel: int = 3, stride: int = 1, padding: int = 1,
                 device=None):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, precision, stride=stride,
                           padding=padding, device=device)

    def forward(self, x):
        return self.conv(x)


class _Norm(nn.Module):
    """Affine parameters of a Flax norm: `scale` -> weight, `bias`."""

    def __init__(self, dim: int, precision: Precision, device=None):
        super().__init__()
        kw = dict(device=device, dtype=precision.param_dtype)
        self.weight = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)

    def reset_parameters(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


class GroupNorm(nn.Module):
    """GroupNorm with statistics in `precision.accum_dtype`, output in the
    compute dtype (the JAX block's `gn`)."""

    def __init__(self, channels: int, groups: int, eps: float,
                 precision: Precision, *, device=None):
        super().__init__()
        self.groups, self.eps, self.precision = groups, eps, precision
        self.gn = _Norm(channels, precision, device)

    def forward(self, x):
        acc = self.precision.accum_dtype
        y = F.group_norm(nchw(x.to(acc)), self.groups, self.gn.weight.to(acc),
                         self.gn.bias.to(acc), self.eps)
        return nhwc(y).to(self.precision.compute_dtype)


class LayerNorm(nn.Module):
    """LayerNorm in fp32, output in the compute dtype (the JAX block's
    `ln`)."""

    def __init__(self, dim: int, eps: float, precision: Precision, *,
                 device=None):
        super().__init__()
        self.ln = LayerNorm32(dim, eps, precision, device=device)

    def forward(self, x):
        return self.ln(x)


class TimestepEmbedMLP(nn.Module):
    """linear -> silu -> linear."""

    def __init__(self, din: int, dim: int, precision: Precision, *,
                 device=None):
        super().__init__()
        self.fc1 = Dense(din, dim, precision, device=device)
        self.fc2 = Dense(dim, dim, precision, device=device)

    def forward(self, t_emb):
        return self.fc2(F.silu(self.fc1(t_emb)))


class ResnetBlock(nn.Module):
    """GN -> silu -> conv -> (+temb) -> GN -> silu -> conv -> + shortcut."""

    def __init__(self, cin: int, cout: int, precision: Precision, *,
                 groups: int = 32, eps: float = 1e-5,
                 temb_dim: Optional[int] = None, device=None):
        super().__init__()
        kw = dict(device=device)
        self.norm1 = GroupNorm(cin, groups, eps, precision, **kw)
        self.conv1 = Conv(cin, cout, precision, **kw)
        self.time_emb_proj = (Dense(temb_dim, cout, precision, **kw)
                              if temb_dim else None)
        self.norm2 = GroupNorm(cout, groups, eps, precision, **kw)
        self.conv2 = Conv(cout, cout, precision, **kw)
        self.conv_shortcut = (Conv2d(cin, cout, 1, precision, **kw)
                              if cin != cout else None)

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 conv3x3: symmetric padding 1 (the UNets), or the VAE
    encoder's asymmetric (0, 1) padding of bottom and right."""

    def __init__(self, cin: int, cout: int, precision: Precision, *,
                 asymmetric_pad: bool = False, device=None):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(cin, cout, 3, precision, stride=2,
                           padding=0 if asymmetric_pad else 1, device=device)

    def forward(self, x):
        if self.asymmetric_pad:
            x = F.pad(x, (0, 0, 0, 1, 0, 1))        # NHWC: W then H
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2, then conv3x3."""

    def __init__(self, cin: int, cout: int, precision: Precision, *,
                 device=None):
        super().__init__()
        self.conv = Conv(cin, cout, precision, device=device)

    def forward(self, x):
        x = nhwc(F.interpolate(nchw(x), scale_factor=2, mode="nearest"))
        return self.conv(x)


class CrossAttention(nn.Module):
    """diffusers Attention: q, k, v without bias, out with bias; self
    attention when no context is given."""

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 precision: Precision, *, context_dim: Optional[int] = None,
                 upcast: bool = False, device=None):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.upcast = upcast
        self.precision = precision
        inner = heads * head_dim
        ctx = context_dim or query_dim
        kw = dict(device=device)
        self.to_q = Dense(query_dim, inner, precision, bias=False, **kw)
        self.to_k = Dense(ctx, inner, precision, bias=False, **kw)
        self.to_v = Dense(ctx, inner, precision, bias=False, **kw)
        self.to_out = Dense(inner, query_dim, precision, **kw)

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, s, _ = x.shape
        t = ctx.shape[1]
        h, d = self.heads, self.head_dim
        q = self.to_q(x).view(b, s, h, d)
        k = self.to_k(ctx).view(b, t, h, d)
        v = self.to_v(ctx).view(b, t, h, d)
        if self.upcast and q.device.type == "cpu":
            # the plain version takes fp32 as the JAX upcast does; kernel 2
            # keeps bf16 operands and accumulates in fp32 (module docstring)
            q, k, v = q.float(), k.float(), v.float()
        o = flash_attention(q, k, v).to(self.precision.compute_dtype)
        return self.to_out(o.reshape(b, s, h * d))


class FeedForwardGEGLU(nn.Module):
    """proj to 2 x inner, value * gelu(gate) (erf-exact), proj back."""

    def __init__(self, dim: int, precision: Precision, *, mult: int = 4,
                 device=None):
        super().__init__()
        inner = dim * mult
        self.proj_in = Dense(dim, inner * 2, precision, device=device)
        self.proj_out = Dense(inner, dim, precision, device=device)

    def forward(self, x):
        a, gate = self.proj_in(x).chunk(2, dim=-1)
        return self.proj_out(a * F.gelu(gate, approximate="none"))


class BasicTransformerBlock(nn.Module):
    """self-attn -> cross-attn -> geglu FF, pre-LN residuals."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int,
                 precision: Precision, *, upcast: bool = False, device=None):
        super().__init__()
        kw = dict(device=device)
        self.norm1 = LayerNorm(dim, 1e-5, precision, **kw)
        self.attn1 = CrossAttention(dim, heads, head_dim, precision,
                                    upcast=upcast, **kw)
        self.norm2 = LayerNorm(dim, 1e-5, precision, **kw)
        self.attn2 = CrossAttention(dim, heads, head_dim, precision,
                                    context_dim=context_dim, upcast=upcast,
                                    **kw)
        self.norm3 = LayerNorm(dim, 1e-5, precision, **kw)
        self.ff = FeedForwardGEGLU(dim, precision, **kw)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer2DModel: GN -> proj_in -> blocks -> proj_out -> +residual;
    1x1 conv projections (SD1.5) or dense ones after flattening
    (`use_linear_projection`, SD2.1 / XL)."""

    def __init__(self, channels: int, heads: int, head_dim: int, depth: int,
                 context_dim: int, precision: Precision, *,
                 use_linear_projection: bool = False, upcast: bool = False,
                 groups: int = 32, device=None):
        super().__init__()
        kw = dict(device=device)
        self.linear = use_linear_projection
        self.norm = GroupNorm(channels, groups, 1e-6, precision, **kw)
        proj = ((lambda: Dense(channels, channels, precision, **kw))
                if use_linear_projection else
                (lambda: Conv2d(channels, channels, 1, precision, **kw)))
        self.proj_in = proj()
        for i in range(depth):
            self.add_module(f"block_{i}", BasicTransformerBlock(
                channels, heads, head_dim, context_dim, precision,
                upcast=upcast, **kw))
        self.depth = depth
        self.proj_out = proj()

    def forward(self, x, context):
        b, h, w, c = x.shape
        y = self.proj_in(self.norm(x)).reshape(b, h * w, c)
        for i in range(self.depth):
            y = getattr(self, f"block_{i}")(y, context)
        return self.proj_out(y.reshape(b, h, w, c)) + x


# query rows of one plain-attention pass: [B, rows, S] fp32 scores of at
# most this many bytes (an SD1.5 768 px image's are 340 MB whole)
VAE_ATTN_BYTES = 1 << 29


class VAESelfAttention(nn.Module):
    """Single-head GN self-attention of the VAE mid block.

    The attention is the plain softmax attention of `ops.attention.mha`
    (fp32 scores and sums), as the JAX block computes it with its `mha`:
    no Pallas kernel computes this one in the JAX package, so it is not a
    fallback from a kernel. Its query rows go in chunks of at most
    `VAE_ATTN_BYTES` of scores; each row's softmax is whole in its chunk,
    so the chunking changes nothing but the peak memory."""

    def __init__(self, channels: int, precision: Precision, *,
                 groups: int = 32, eps: float = 1e-6, device=None):
        super().__init__()
        kw = dict(device=device)
        self.group_norm = GroupNorm(channels, groups, eps, precision, **kw)
        for name in ("to_q", "to_k", "to_v", "to_out"):
            self.add_module(name, Dense(channels, channels, precision, **kw))

    def forward(self, x):
        b, h, w, c = x.shape
        y = self.group_norm(x).reshape(b, h * w, 1, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        rows = max(1, VAE_ATTN_BYTES // (4 * b * h * w))
        o = torch.cat([mha(q[:, i:i + rows], k, v)
                       for i in range(0, h * w, rows)], dim=1)
        return x + self.to_out(o.reshape(b, h * w, c)).reshape(b, h, w, c)


def ddim_alphas_cumprod(num_steps: int = 1000, beta_start: float = 0.00085,
                        beta_end: float = 0.012,
                        schedule: str = "scaled_linear", device=None):
    """DDIM alphas_cumprod [num_steps] fp32 (`scheduling_ddim.py`)."""
    if schedule == "scaled_linear":
        betas = torch.linspace(beta_start ** 0.5, beta_end ** 0.5, num_steps,
                               dtype=torch.float32, device=device) ** 2
    elif schedule == "linear":
        betas = torch.linspace(beta_start, beta_end, num_steps,
                               dtype=torch.float32, device=device)
    else:
        raise ValueError(schedule)
    return torch.cumprod(1.0 - betas, dim=0)


def add_noise(latents, noise, t: int, alphas_cumprod):
    """DDIMScheduler.add_noise: sqrt(acp_t) x0 + sqrt(1 - acp_t) eps, in
    fp32, returned in the latents' dtype."""
    acp = alphas_cumprod[t]
    return (torch.sqrt(acp) * latents.float()
            + torch.sqrt(1.0 - acp) * noise.float()).to(latents.dtype)

