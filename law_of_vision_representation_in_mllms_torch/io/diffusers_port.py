"""Port diffusers torch checkpoints (UNet, VAE, DiT, SD3) into the JAX
package's parameter trees (counterpart of its `io/diffusers_port.py`).

Each porter maps a state dict by diffusers' key names (it imports nothing of
diffusers) and returns the tree of fp32 numpy arrays, in the JAX layout,
that the JAX porter returns: a conv weight [O, I, kh, kw] becomes a
`kernel` [kh, kw, I, O], a Linear weight a `kernel` [in, out], a norm's
`weight` its `scale`. A bundle or a `port_cli` .npz of these trees becomes
the port's `FeaturizerParams` through `io.from_jax.featurizer_state_dict`.
"""

from __future__ import annotations

from typing import Dict

from ..models.unet import UNetConfig
from ..models.vae import VAEConfig
from .hf_port import _t


def _conv(sd, prefix) -> Dict:
    """torch Conv2d [O, I, kh, kw] -> {kernel [kh, kw, I, O], bias}."""
    out = {"kernel": _t(sd, prefix + ".weight").transpose(2, 3, 1, 0)}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd, prefix + ".bias")
    return out


def _dense(sd, prefix) -> Dict:
    out = {"kernel": _t(sd, prefix + ".weight").T}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd, prefix + ".bias")
    return out


def _norm(sd, prefix, kind: str) -> Dict:
    return {kind: {"scale": _t(sd, prefix + ".weight"),
                   "bias": _t(sd, prefix + ".bias")}}


def _resnet(sd, p) -> Dict:
    out = {"norm1": _norm(sd, f"{p}.norm1", "gn"),
           "conv1": {"conv": _conv(sd, f"{p}.conv1")},
           "norm2": _norm(sd, f"{p}.norm2", "gn"),
           "conv2": {"conv": _conv(sd, f"{p}.conv2")}}
    if f"{p}.time_emb_proj.weight" in sd:
        out["time_emb_proj"] = _dense(sd, f"{p}.time_emb_proj")
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = _conv(sd, f"{p}.conv_shortcut")
    return out


def _qkvo(sd, ap) -> Dict:
    return {"to_q": _dense(sd, f"{ap}.to_q"), "to_k": _dense(sd, f"{ap}.to_k"),
            "to_v": _dense(sd, f"{ap}.to_v"),
            "to_out": _dense(sd, f"{ap}.to_out.0")}


def _ff(sd, p) -> Dict:
    return {"proj_in": _dense(sd, f"{p}.net.0.proj"),
            "proj_out": _dense(sd, f"{p}.net.2")}


def _basic_block(sd, p) -> Dict:
    return {"norm1": _norm(sd, f"{p}.norm1", "ln"),
            "attn1": _qkvo(sd, f"{p}.attn1"),
            "norm2": _norm(sd, f"{p}.norm2", "ln"),
            "attn2": _qkvo(sd, f"{p}.attn2"),
            "norm3": _norm(sd, f"{p}.norm3", "ln"),
            "ff": _ff(sd, f"{p}.ff")}


def _spatial_transformer(sd, p, linear: bool, depth: int) -> Dict:
    proj = _dense if linear else _conv
    out = {"norm": _norm(sd, f"{p}.norm", "gn"),
           "proj_in": proj(sd, f"{p}.proj_in"),
           "proj_out": proj(sd, f"{p}.proj_out")}
    for k in range(depth):
        out[f"block_{k}"] = _basic_block(sd, f"{p}.transformer_blocks.{k}")
    return out


def port_unet(state_dict, cfg: UNetConfig, up_ft_indices=(0,)) -> Dict:
    """diffusers UNet2DConditionModel -> the UNetHarvest tree. Only up
    blocks <= max(up_ft_indices) are ported (the rest are never built)."""
    sd, lin = state_dict, cfg.use_linear_projection
    n = len(cfg.block_out_channels)
    params = {
        "conv_in": {"conv": _conv(sd, "conv_in")},
        "time_embedding": {"fc1": _dense(sd, "time_embedding.linear_1"),
                           "fc2": _dense(sd, "time_embedding.linear_2")},
    }
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "fc1": _dense(sd, "add_embedding.linear_1"),
            "fc2": _dense(sd, "add_embedding.linear_2")}
    for i in range(n):
        for j in range(cfg.layers_per_block):
            params[f"down_{i}_res_{j}"] = _resnet(
                sd, f"down_blocks.{i}.resnets.{j}")
            if cfg.num_heads[i] is not None:
                params[f"down_{i}_attn_{j}"] = _spatial_transformer(
                    sd, f"down_blocks.{i}.attentions.{j}", lin,
                    cfg.transformer_depth[i])
        if i < n - 1:
            params[f"down_{i}_downsample"] = {
                "conv": _conv(sd, f"down_blocks.{i}.downsamplers.0.conv")}
    params["mid_res_0"] = _resnet(sd, "mid_block.resnets.0")
    params["mid_res_1"] = _resnet(sd, "mid_block.resnets.1")
    params["mid_attn"] = _spatial_transformer(
        sd, "mid_block.attentions.0", lin, cfg.transformer_depth[-1] or 1)
    for i in range(max(up_ft_indices) + 1):
        down_idx = n - 1 - i
        for j in range(cfg.layers_per_block + 1):
            params[f"up_{i}_res_{j}"] = _resnet(
                sd, f"up_blocks.{i}.resnets.{j}")
            if cfg.num_heads[down_idx] is not None:
                params[f"up_{i}_attn_{j}"] = _spatial_transformer(
                    sd, f"up_blocks.{i}.attentions.{j}", lin,
                    cfg.transformer_depth[down_idx])
        if i < n - 1:
            params[f"up_{i}_upsample"] = {"conv": {
                "conv": _conv(sd, f"up_blocks.{i}.upsamplers.0.conv")}}
    return params


def port_vae_encoder(state_dict, cfg: VAEConfig) -> Dict:
    """diffusers AutoencoderKL (encoder.* + quant_conv) -> the VAEEncoder
    tree."""
    sd, pre = state_dict, "encoder"
    n = len(cfg.block_out_channels)
    params = {
        "conv_in": {"conv": _conv(sd, f"{pre}.conv_in")},
        "conv_norm_out": _norm(sd, f"{pre}.conv_norm_out", "gn"),
        "conv_out": {"conv": _conv(sd, f"{pre}.conv_out")},
    }
    for i in range(n):
        for j in range(cfg.layers_per_block):
            params[f"down_{i}_res_{j}"] = _resnet(
                sd, f"{pre}.down_blocks.{i}.resnets.{j}")
        if i < n - 1:
            params[f"down_{i}_downsample"] = {"conv": _conv(
                sd, f"{pre}.down_blocks.{i}.downsamplers.0.conv")}
    params["mid_res_0"] = _resnet(sd, f"{pre}.mid_block.resnets.0")
    params["mid_res_1"] = _resnet(sd, f"{pre}.mid_block.resnets.1")
    ap = f"{pre}.mid_block.attentions.0"
    params["mid_attn"] = {"group_norm": _norm(sd, f"{ap}.group_norm", "gn"),
                          **_qkvo(sd, ap)}
    if cfg.use_quant_conv:
        params["quant_conv"] = _conv(sd, "quant_conv")
    return params


def port_dit(state_dict, cfg, up_ft_indices=(-1,)) -> Dict:
    """diffusers DiTTransformer2DModel -> the DiTHarvest tree. The class
    embedding is dropped: the featurizer conditions on the timestep only
    (`dift_dit.py` MyCombinedTimestepLabelEmbeddings)."""
    sd = state_dict
    last = max(i % cfg.num_layers for i in up_ft_indices)
    params = {"patch_proj": _conv(sd, "pos_embed.proj")}
    for i in range(last + 1):
        p = f"transformer_blocks.{i}"
        emb = f"{p}.norm1.emb.timestep_embedder"
        params[f"t_embedder_{i}"] = {"fc1": _dense(sd, f"{emb}.linear_1"),
                                     "fc2": _dense(sd, f"{emb}.linear_2")}
        params[f"block_{i}"] = {
            "norm1": {"linear": _dense(sd, f"{p}.norm1.linear")},
            "attn1": _qkvo(sd, f"{p}.attn1"),
            "ff": _ff(sd, f"{p}.ff"),
        }
    return params


def port_mmdit(state_dict, cfg, up_ft_indices=(-1,)) -> Dict:
    """diffusers SD3Transformer2DModel -> the MMDiTHarvest tree. The last
    block of the model is context-pre-only: its context stream has only the
    modulation's linear."""
    sd = state_dict
    last = max(i % cfg.num_layers for i in up_ft_indices)
    tte = "time_text_embed"
    params = {
        "patch_proj": _conv(sd, "pos_embed.proj"),
        "pos_embed": _t(sd, "pos_embed.pos_embed"),
        "timestep_embedder": {
            "fc1": _dense(sd, f"{tte}.timestep_embedder.linear_1"),
            "fc2": _dense(sd, f"{tte}.timestep_embedder.linear_2")},
        "text_embedder": {
            "fc1": _dense(sd, f"{tte}.text_embedder.linear_1"),
            "fc2": _dense(sd, f"{tte}.text_embedder.linear_2")},
        "context_embedder": _dense(sd, "context_embedder"),
    }
    for i in range(last + 1):
        p = f"transformer_blocks.{i}"
        blk = {
            "norm1": {"linear": _dense(sd, f"{p}.norm1.linear")},
            **_qkvo(sd, f"{p}.attn"),
            "add_q_proj": _dense(sd, f"{p}.attn.add_q_proj"),
            "add_k_proj": _dense(sd, f"{p}.attn.add_k_proj"),
            "add_v_proj": _dense(sd, f"{p}.attn.add_v_proj"),
            "ff": _ff(sd, f"{p}.ff"),
        }
        if i == cfg.num_layers - 1:
            blk["norm1_context_linear"] = _dense(
                sd, f"{p}.norm1_context.linear")
        else:
            blk["norm1_context"] = {
                "linear": _dense(sd, f"{p}.norm1_context.linear")}
            blk["to_add_out"] = _dense(sd, f"{p}.attn.to_add_out")
            blk["ff_context"] = _ff(sd, f"{p}.ff_context")
        params[f"block_{i}"] = blk
    return params
