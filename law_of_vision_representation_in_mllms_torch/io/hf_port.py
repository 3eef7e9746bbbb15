"""Port HuggingFace torch checkpoints into the JAX package's parameter trees
(counterpart of its `io/hf_port.py`).

Each porter takes a state dict of torch tensors (`io.port_cli.
load_torch_state_dict` of a local snapshot, or a model's `state_dict()`)
and returns the tree of fp32 numpy arrays, in the JAX layout, that the JAX
porter of the same name returns: a Dense `kernel` is the torch weight
transposed ([in, out]), a patch kernel `(p, p, c, D)` is the torch conv
weight `transpose(2, 3, 1, 0)`, a LayerNorm is `{"ln": {"scale", "bias"}}`.
So the .npz the port writes (`param_io.save_params`) is the one the JAX
package writes, and `io.from_jax` turns it into the port's state dicts
(`vit_state_dict`, `llama_state_dict`, ...). One name map per model family,
held to HF's own forward on tiny configs (tests/test_torch_hf_port.py).

SAM's porter (`port_sam`, `sam_config_from_hf`) waits for the port's
`models/sam`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.vit import ViTConfig

_SAM_NOT_PORTED = ("SAM's porter is not ported to the PyTorch package yet "
                   "(ROADMAP, queue 1: 8, C score / GeoAware)")


def _t(sd, key) -> np.ndarray:
    """A state-dict tensor as fp32 numpy on the host."""
    return sd[key].detach().to("cpu").float().numpy()


def _linear(sd, prefix) -> Dict:
    out = {"kernel": _t(sd, prefix + ".weight").T}
    if prefix + ".bias" in sd:
        out["bias"] = _t(sd, prefix + ".bias")
    return out


def _ln(sd, prefix) -> Dict:
    return {"ln": {"scale": _t(sd, prefix + ".weight"),
                   "bias": _t(sd, prefix + ".bias")}}


def _block(sd, lp, attn: str, o: Dict, fc2: Dict, ln1: str = "layer_norm1",
           ln2: str = "layer_norm2", qkv=("q_proj", "k_proj", "v_proj")
           ) -> Dict:
    """One transformer block's tree: `attn` is the prefix of q, k, v; the
    output projection `o` and `fc2` come ported (DINOv2 folds LayerScale
    into them)."""
    q, k, v = (_linear(sd, f"{lp}.{attn}.{n}") for n in qkv)
    return {"ln1": _ln(sd, f"{lp}.{ln1}"), "q": q, "k": k, "v": v, "o": o,
            "ln2": _ln(sd, f"{lp}.{ln2}"),
            "fc1": _linear(sd, f"{lp}.mlp.fc1"), "fc2": fc2}


def _clip_blocks(sd, enc: str, cfg: ViTConfig, params: Dict) -> Dict:
    """The `{enc}.layers.{i}` blocks of a CLIP or SigLIP encoder, up to the
    first missing one."""
    for i in range(cfg.num_layers):
        lp = f"{enc}.layers.{i}"
        if f"{lp}.layer_norm1.weight" not in sd:
            break
        params[f"block_{i}"] = _block(
            sd, lp, "self_attn", _linear(sd, f"{lp}.self_attn.out_proj"),
            _linear(sd, f"{lp}.mlp.fc2"))
    return params


def port_clip_vision(state_dict, cfg: ViTConfig) -> Dict:
    """openai / laion CLIPVisionModel -> the ViTEncoder tree.

    HF layout: vision_model.embeddings.{class_embedding, patch_embedding,
    position_embedding}, vision_model.pre_layrnorm,
    vision_model.encoder.layers.{i}.{layer_norm1, self_attn, layer_norm2,
    mlp}."""
    sd, pre = state_dict, "vision_model"
    params = {
        "patch_kernel": _t(sd, f"{pre}.embeddings.patch_embedding.weight"
                           ).transpose(2, 3, 1, 0),
        "cls_token": _t(sd, f"{pre}.embeddings.class_embedding"
                        ).reshape(1, 1, -1),
        "pos_embed": _t(sd, f"{pre}.embeddings.position_embedding.weight"
                        )[None],
        "pre_ln": _ln(sd, f"{pre}.pre_layrnorm"),
    }
    return _clip_blocks(sd, f"{pre}.encoder", cfg, params)


def port_siglip_vision(state_dict, cfg: ViTConfig) -> Dict:
    """google/siglip SiglipVisionModel (`vision_model.*`, or the bare
    vision tower's keys) -> the ViTEncoder tree."""
    sd = state_dict
    pre = ("vision_model." if any(k.startswith("vision_model") for k in sd)
           else "")
    params = {
        "patch_kernel": _t(sd, f"{pre}embeddings.patch_embedding.weight"
                           ).transpose(2, 3, 1, 0),
        "patch_bias": _t(sd, f"{pre}embeddings.patch_embedding.bias"),
        "pos_embed": _t(sd, f"{pre}embeddings.position_embedding.weight"
                        )[None],
    }
    return _clip_blocks(sd, f"{pre}encoder", cfg, params)


def port_dinov2(state_dict, cfg: ViTConfig) -> Dict:
    """facebook/dinov2 Dinov2Model -> the ViTEncoder tree.

    The position embeddings are interpolated to `cfg.grid` at port time
    (torch bicubic, no antialias: HF's `interpolate_pos_encoding`), so the
    tower never interpolates. LayerScale is folded into the projection
    before it ((Wx + b) * l == (W * l) x + b * l, exact in fp32) unless
    `cfg.use_layerscale` keeps `ls1` / `ls2`."""
    sd = state_dict
    pos = sd["embeddings.position_embeddings"].detach().float()  # [1,1+N,D]
    dim, g1 = pos.shape[-1], cfg.grid
    g0 = int(round((pos.shape[1] - 1) ** 0.5))
    if g0 != g1:
        cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
        patch_pos = patch_pos.reshape(1, g0, g0, dim).permute(0, 3, 1, 2)
        patch_pos = F.interpolate(patch_pos, size=(g1, g1), mode="bicubic",
                                  align_corners=False)
        patch_pos = patch_pos.permute(0, 2, 3, 1).reshape(1, g1 * g1, dim)
        pos = torch.cat([cls_pos, patch_pos], dim=1)
    params = {
        "patch_kernel": _t(sd, "embeddings.patch_embeddings.projection."
                               "weight").transpose(2, 3, 1, 0),
        "patch_bias": _t(sd, "embeddings.patch_embeddings.projection.bias"),
        "cls_token": _t(sd, "embeddings.cls_token"),
        "pos_embed": pos.numpy().astype(np.float32),
    }

    def scaled(prefix: str, lam: np.ndarray) -> Dict:
        lin = _linear(sd, prefix)
        return {"kernel": lin["kernel"] * lam[None, :],
                "bias": lin["bias"] * lam}

    fold = not cfg.use_layerscale
    for i in range(cfg.num_layers):
        lp = f"encoder.layer.{i}"
        if f"{lp}.norm1.weight" not in sd:
            break
        ls1 = _t(sd, f"{lp}.layer_scale1.lambda1")
        ls2 = _t(sd, f"{lp}.layer_scale2.lambda1")
        o, fc2 = f"{lp}.attention.output.dense", f"{lp}.mlp.fc2"
        blk = _block(sd, lp, "attention.attention",
                     scaled(o, ls1) if fold else _linear(sd, o),
                     scaled(fc2, ls2) if fold else _linear(sd, fc2),
                     ln1="norm1", ln2="norm2", qkv=("query", "key", "value"))
        if not fold:
            blk["ls1"], blk["ls2"] = ls1, ls2
        params[f"block_{i}"] = blk
    return params


VIT_PORTERS = {
    "clip": port_clip_vision,
    "siglip": port_siglip_vision,
    "dinov2": port_dinov2,
}


def port_vit(family: str, state_dict, cfg: ViTConfig,
             num_blocks: int | None = None) -> Dict:
    """Port a ViT family checkpoint, keeping only the first `num_blocks`."""
    params = VIT_PORTERS[family](state_dict, cfg)
    if num_blocks is not None:
        params = {k: v for k, v in params.items()
                  if not k.startswith("block_")
                  or int(k.split("_")[1]) < num_blocks}
    return params


def port_llama(state_dict, cfg) -> Dict:
    """HF LlamaForCausalLM -> the JAX decoder tree: per-layer weights
    stacked on a leading axis (`io.from_jax.llama_state_dict` splits
    them)."""
    sd = state_dict

    def stack(fmt, transpose=True):
        ws = [_t(sd, fmt.format(i=i)) for i in range(cfg.num_layers)]
        return np.stack([w.T for w in ws] if transpose else ws)

    lay = "model.layers.{i}."
    return {
        "embed": _t(sd, "model.embed_tokens.weight"),
        "layers": {
            "wq": stack(lay + "self_attn.q_proj.weight"),
            "wk": stack(lay + "self_attn.k_proj.weight"),
            "wv": stack(lay + "self_attn.v_proj.weight"),
            "wo": stack(lay + "self_attn.o_proj.weight"),
            "gate": stack(lay + "mlp.gate_proj.weight"),
            "up": stack(lay + "mlp.up_proj.weight"),
            "down": stack(lay + "mlp.down_proj.weight"),
            "rms1": stack(lay + "input_layernorm.weight", transpose=False),
            "rms2": stack(lay + "post_attention_layernorm.weight",
                          transpose=False),
        },
        "final_norm": _t(sd, "model.norm.weight"),
        "lm_head": _t(sd, "lm_head.weight").T,
    }


def port_clip_vision_pooled(state_dict, cfg: ViTConfig) -> Dict:
    """CLIPVisionModelWithProjection -> the CLIPVisionPooled tree."""
    sd = state_dict
    return {"encoder": port_clip_vision(sd, cfg),
            "post_ln": _ln(sd, "vision_model.post_layernorm"),
            "visual_projection": _t(sd, "visual_projection.weight").T}


def sam_config_from_hf(hf_cfg):
    raise NotImplementedError(_SAM_NOT_PORTED)


def port_sam(state_dict, cfg):
    raise NotImplementedError(_SAM_NOT_PORTED)
