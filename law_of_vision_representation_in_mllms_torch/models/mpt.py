"""MPT decoder, the legacy LLaVA branch (counterpart of the JAX package's
`models/mpt.py`).

ALiBi positional biases (no RoPE), pre-LN blocks with a weight-only LayerNorm
in fp32, a fused `wqkv` projection without bias, an exact-GELU MLP and the
embedding tied as the LM head. The trunk is a per-layer `nn.ModuleList`
walked by a Python loop where the JAX package scans over stacked weights.

Attention routes (`use_flash`):
- the flash route runs kernel 2 (`ops.flash_attention`, causal) with the
  ALiBi bias computed inside the kernel from the per-head slopes; under
  autograd its backward is kernels 5 and 6 with the same bias. No [S, S] bias
  or logits tensor exists. Like the LLaMA flash route it assumes RIGHT
  padding (causality keeps pad keys out of a valid query's reach) and does
  not read `attn_mask`;
- the plain route is `ops.attention.mha` with the materialised bias
  (`alibi_bias`) and the causal mask, combined with `attn_mask`.
`use_flash=None` takes the kernels on a CUDA tensor and the plain route on
the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.attention import mha
from ..ops.flash_attention import flash_attention
from .layers import Dense, init_weights

INIT_STD = 0.02   # every matmul weight ~ N(0, 0.02), as in the JAX init


@dataclasses.dataclass(frozen=True)
class MptConfig:
    """mosaicml/mpt-7b by default."""
    vocab_size: int = 50432
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    expansion_ratio: int = 4
    alibi_bias_max: float = 8.0
    ln_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def tiny(vocab_size: int = 128, hidden_size: int = 32, num_layers: int = 2,
         num_heads: int = 4) -> MptConfig:
    return MptConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                     num_layers=num_layers, num_heads=num_heads)


def alibi_slopes(num_heads: int, bias_max: float = 8.0,
                 device=None) -> torch.Tensor:
    """MPT's ALiBi slopes, fp32 [H] (HF `build_mpt_alibi_tensor`): for a head
    count that is no power of two the slopes of the next power interleave,
    odd positions first."""
    n = 2 ** math.ceil(math.log2(num_heads))
    base = torch.arange(1, n + 1, dtype=torch.float32,
                        device=device) * (bias_max / n)
    slopes = 1.0 / torch.pow(2.0, base)
    if n != num_heads:
        slopes = torch.cat([slopes[1::2], slopes[0::2]])[:num_heads]
    return slopes


def alibi_bias(num_heads: int, seq_len: int, bias_max: float = 8.0,
               device=None) -> torch.Tensor:
    """[H, 1, S] additive bias: -(S - 1 - j) * slope for key j."""
    dist = torch.arange(1 - seq_len, 1, dtype=torch.float32, device=device)
    return dist[None, None, :] * alibi_slopes(num_heads, bias_max,
                                              device)[:, None, None]


def _ln(x, weight, eps: float):
    """Weight-only LayerNorm with fp32 statistics (MPT checkpoints carry no
    LayerNorm bias), output in x.dtype."""
    y = F.layer_norm(x.float(), weight.shape, weight.float(), None, eps)
    return y.to(x.dtype)


class MptBlock(nn.Module):
    def __init__(self, cfg: MptConfig, precision: Precision, *, device=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        kw = dict(device=device, dtype=precision.param_dtype)

        def dense(din, dout):
            return Dense(din, dout, precision, bias=False, init_std=INIT_STD,
                         device=device)
        self.ln1 = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
        self.wqkv = dense(d, 3 * d)
        self.wo = dense(d, d)
        self.ln2 = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
        self.up = dense(d, cfg.expansion_ratio * d)
        self.down = dense(cfg.expansion_ratio * d, d)

    def reset_parameters(self, generator):
        self.ln1.fill_(1.0)
        self.ln2.fill_(1.0)

    def forward(self, x, slopes, bias, mask):
        """`bias`/`mask` None selects the flash route."""
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = self.wqkv(_ln(x, self.ln1, cfg.ln_eps))
        q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim)
                   for t in qkv.chunk(3, dim=-1))
        if mask is None:
            attn = flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True,
                                   alibi_slopes=slopes)
        else:
            attn = mha(q, k, v, bias=bias, mask=mask)
        x = x + self.wo(attn.reshape(b, s, cfg.hidden_size))
        hn = F.gelu(self.up(_ln(x, self.ln2, cfg.ln_eps)))
        return x + self.down(hn)


class MptModel(nn.Module):
    """The decoder's weights: `embed` [V, d] (also the LM head), per-layer
    blocks, `final_ln` [d]."""

    def __init__(self, cfg: MptConfig,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.precision = precision
        kw = dict(device=device, dtype=precision.param_dtype)
        self.embed = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.hidden_size, **kw),
            requires_grad=False)
        self.layers = nn.ModuleList(MptBlock(cfg, precision, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = nn.Parameter(torch.empty(cfg.hidden_size, **kw),
                                     requires_grad=False)

    def reset_parameters(self, generator):
        self.embed.normal_(0.0, INIT_STD, generator=generator)
        self.final_ln.fill_(1.0)

    def forward(self, input_ids, attn_mask=None, use_flash=None):
        """input_ids [B, S] -> logits [B, S, V] in fp32 (tied LM head). Ids
        are clipped into the vocabulary. `attn_mask` [B, S] bool (key
        validity) is honoured on the plain route only; the flash route
        assumes right padding."""
        cfg = self.cfg
        cd = self.precision.compute_dtype
        if use_flash is None:
            use_flash = input_ids.device.type == "cuda"
        s = input_ids.shape[1]
        dev = input_ids.device
        h = self.embed[input_ids.clamp(0, cfg.vocab_size - 1)].to(cd)
        slopes = bias = mask = None
        if use_flash:
            slopes = alibi_slopes(cfg.num_heads, cfg.alibi_bias_max, dev)
        else:
            bias = alibi_bias(cfg.num_heads, s, cfg.alibi_bias_max, dev)[None]
            mask = torch.tril(torch.ones(s, s, dtype=torch.bool,
                                         device=dev))[None, None]
            if attn_mask is not None:
                mask = mask & attn_mask[:, None, None, :]
        for layer in self.layers:
            h = layer(h, slopes, bias, mask)
        h = _ln(h, self.final_ln, cfg.ln_eps)
        return F.linear(h, self.embed.to(cd)).float()


def init_params(generator: torch.Generator, cfg: MptConfig,
                precision: Precision = DEFAULT_PRECISION,
                device=None) -> MptModel:
    """Random weights, seeded by `generator` (which must live on `device`'s
    type), allocated and sampled directly on `device` in the param dtype."""
    params = MptModel(cfg, precision, device=device)
    init_weights(params, generator)
    return params.eval()


def port_mpt(state_dict, cfg: MptConfig) -> Dict[str, torch.Tensor]:
    """HF `MptForCausalLM` state dict -> `MptModel` state dict. Both store a
    linear weight as [out, in], so only the names change; the tied
    `lm_head.weight` is dropped."""
    def t(key):
        return torch.from_numpy(
            np.array(state_dict[key].detach().float().cpu().numpy()))

    out = {"embed": t("transformer.wte.weight"),
           "final_ln": t("transformer.norm_f.weight")}
    names = {"ln1": "norm_1", "wqkv.weight": "attn.Wqkv", "ln2": "norm_2",
             "wo.weight": "attn.out_proj", "up.weight": "ffn.up_proj",
             "down.weight": "ffn.down_proj"}
    for i in range(cfg.num_layers):
        for ours, theirs in names.items():
            out[f"layers.{i}.{ours}"] = t(
                f"transformer.blocks.{i}.{theirs}.weight")
    return out
