"""CLIP text encoders: the prompt conditioning of the SD featurizers
(counterpart of the JAX package's `models/text_encoder.py`).

The featurizers encode one fixed (usually empty) prompt a model, once, when
a bundle is made (`io.featurizer_bundle.port_featurizer_bundle`):
- SD1.5 / 2.1: CLIPTextModel's last_hidden_state (`dift_sd.py:252-258`);
- SDXL: hidden_states[-2] of CLIP-L and OpenCLIP-bigG, concatenated;
- SD3: the same two hidden_states[-2], zero-padded to the T5 width, with
  T5's context as zeros, and pooled = both pooled projections concatenated.

The blocks are the towers' `ViTBlock` with `causal=True`, so on the card
their attention is kernel 2's causal form (D = 64 for all three encoders,
S = 77; 12, 16 and 20 heads); on the CPU it is its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from .layers import LayerNorm32
from .vit import ViTBlock, ViTConfig


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    max_positions: int = 77
    eos_token_id: int = 49407
    projection_dim: int = 0          # > 0: the pooled text_projection exists

    def block_cfg(self) -> ViTConfig:
        return ViTConfig(hidden_size=self.hidden_size,
                         num_layers=self.num_layers,
                         num_heads=self.num_heads,
                         intermediate_size=self.intermediate_size,
                         hidden_act=self.hidden_act,
                         layer_norm_eps=self.layer_norm_eps)


def clip_l_text() -> TextConfig:
    return TextConfig()


def clip_sd21_text() -> TextConfig:
    # SD2.1's text encoder: OpenCLIP ViT-H's text tower as a CLIPTextModel
    return TextConfig(hidden_size=1024, num_layers=23, num_heads=16,
                      intermediate_size=4096, hidden_act="gelu")


def clip_bigg_text() -> TextConfig:
    return TextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                      intermediate_size=5120, hidden_act="gelu",
                      projection_dim=1280)


def text_config_from_hf(hf: Dict, state_dict) -> TextConfig:
    """The TextConfig of a snapshot's `config.json` (a CLIPTextConfig, or a
    CLIPConfig's `text_config`); the projection exists where the state dict
    has `text_projection.weight`."""
    tc = hf.get("text_config", hf)
    return TextConfig(
        vocab_size=tc["vocab_size"], hidden_size=tc["hidden_size"],
        num_layers=tc["num_hidden_layers"],
        num_heads=tc["num_attention_heads"],
        intermediate_size=tc["intermediate_size"],
        hidden_act=tc.get("hidden_act", "quick_gelu"),
        max_positions=tc.get("max_position_embeddings", 77),
        eos_token_id=tc.get("eos_token_id", 49407),
        projection_dim=(tc.get("projection_dim", 0)
                        if "text_projection.weight" in state_dict else 0))


class CLIPTextEncoder(nn.Module):
    """Token and position embeddings, `num_blocks` causal blocks (all of
    them unless given), the final LayerNorm and, with
    `cfg.projection_dim`, `text_projection` [hidden, projection] (a raw
    matrix, as in the JAX tree)."""

    def __init__(self, cfg: TextConfig,
                 precision: Precision = DEFAULT_PRECISION, *,
                 num_blocks: Optional[int] = None, device=None):
        super().__init__()
        self.cfg, self.precision = cfg, precision
        d = cfg.hidden_size
        kw = dict(device=device, dtype=precision.param_dtype)
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, d, **kw), requires_grad=False)
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.max_positions, d, **kw), requires_grad=False)
        n = cfg.num_layers if num_blocks is None else num_blocks
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.block_cfg(), precision, causal=True, device=device)
            for _ in range(n))
        self.final_ln = LayerNorm32(d, cfg.layer_norm_eps, precision,
                                    device=device)
        self.text_projection = (
            nn.Parameter(torch.empty(d, cfg.projection_dim, **kw),
                         requires_grad=False)
            if cfg.projection_dim else None)

    def reset_parameters(self, generator):
        self.token_embedding.normal_(0.0, 0.02, generator=generator)
        self.pos_embed.normal_(0.0, 0.02, generator=generator)
        if self.text_projection is not None:
            self.text_projection.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids, num_blocks: Optional[int] = None,
                want_pooled: bool = False):
        """input_ids [B, S] -> (hidden [B, S, D], pooled [B, P] or None).

        `num_blocks` gives the hidden output of a prefix of the blocks;
        with fewer blocks than the model has it is that block's output,
        without the final LayerNorm (SDXL and SD3 take hidden_states[-2]),
        and with all of them the final LayerNorm's. The pooled output takes
        the whole stack and the final LayerNorm whatever `num_blocks` is
        (HF's `pooler_output` / `text_embeds`), gathers the first eos
        position (under a legacy `eos_token_id` of 2, the highest id, as HF
        does), and applies `text_projection` where it exists."""
        cfg, cd = self.cfg, self.precision.compute_dtype
        s = input_ids.shape[1]
        x = (self.token_embedding[input_ids].to(cd)
             + self.pos_embed[:, :s].to(cd))
        n = cfg.num_layers if num_blocks is None else num_blocks
        depth = cfg.num_layers if want_pooled else n
        if depth > len(self.blocks):
            raise ValueError(f"asked for {depth} blocks; the encoder holds "
                             f"{len(self.blocks)}")
        hidden = None
        for i, blk in enumerate(self.blocks[:depth]):
            if i == n:
                hidden = x      # hidden_states[n]: no final LayerNorm
            x = blk(x)
        if not want_pooled:
            return (x if n < cfg.num_layers else self.final_ln(x)), None
        last = self.final_ln(x)
        hidden = last if hidden is None else hidden
        if cfg.eos_token_id == 2:
            # a legacy CLIP config (the published CLIP-L's and SD3's text
            # encoders carry eos_token_id 2, not 49407): HF pools at the
            # highest id of each row, which is CLIP's eos
            eos = input_ids.int().argmax(dim=1)
        else:
            eos = (input_ids == cfg.eos_token_id).int().argmax(dim=1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos]
        if self.text_projection is not None:
            pooled = pooled @ self.text_projection.to(pooled.dtype)
        return hidden, pooled


def port_clip_text(state_dict, cfg: TextConfig,
                   num_blocks: Optional[int] = None) -> Dict:
    """HF CLIPTextModel(WithProjection) -> the CLIPTextEncoder tree (the
    JAX layout; `io.from_jax.text_encoder_state_dict` maps it onto the
    module), with the first `num_blocks` blocks (all unless given)."""
    from ..io.hf_port import _block, _linear, _ln, _t

    sd, pre = state_dict, "text_model"
    params = {
        "token_embedding": _t(sd, f"{pre}.embeddings.token_embedding.weight"),
        "pos_embed": _t(sd, f"{pre}.embeddings.position_embedding.weight"
                        )[None],
        "final_ln": _ln(sd, f"{pre}.final_layer_norm"),
    }
    n = cfg.num_layers if num_blocks is None else num_blocks
    for i in range(n):
        lp = f"{pre}.encoder.layers.{i}"
        params[f"block_{i}"] = _block(
            sd, lp, "self_attn", _linear(sd, f"{lp}.self_attn.out_proj"),
            _linear(sd, f"{lp}.mlp.fc2"))
    if "text_projection.weight" in sd:
        params["text_projection"] = _t(sd, "text_projection.weight").T
    return params
