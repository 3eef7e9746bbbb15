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

SAM's porter (`port_sam`) gives the JAX `models/sam` tree, which the
port's `models.sam.SamModel` loads through `io.from_jax.sam_state_dict`;
`sam_config_from_hf` reads the snapshot's `config.json` as a dict (no
`transformers.SamConfig`: the card's machine has another transformers).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..models.vit import ViTConfig

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


# transformers' SamConfig defaults, for keys a config.json leaves out
_SAM_VISION_DEFAULTS = dict(
    image_size=1024, patch_size=16, hidden_size=768, num_hidden_layers=12,
    num_attention_heads=12, mlp_ratio=4.0, mlp_dim=None, output_channels=256,
    window_size=14, global_attn_indexes=[2, 5, 8, 11], layer_norm_eps=1e-6,
    num_pos_feats=128)
_SAM_PROMPT_DEFAULTS = dict(hidden_size=256, image_size=1024)
_SAM_DECODER_DEFAULTS = dict(
    num_attention_heads=8, num_hidden_layers=2, mlp_dim=2048,
    iou_head_hidden_dim=256, iou_head_depth=3, num_multimask_outputs=3,
    attention_downsample_rate=2)


def sam_config_from_hf(hf_cfg: Dict):
    """A `models.sam.SamConfig` from a SamModel snapshot's `config.json`
    (read with `json`), the fields the JAX `sam_config_from_hf` reads off a
    `transformers.SamConfig`; a key the file leaves out takes transformers'
    default."""
    from ..models.sam import SamConfig, SamVisionCfg
    v = {**_SAM_VISION_DEFAULTS, **(hf_cfg.get("vision_config") or {})}
    pc = {**_SAM_PROMPT_DEFAULTS, **(hf_cfg.get("prompt_encoder_config")
                                     or {})}
    mc = {**_SAM_DECODER_DEFAULTS, **(hf_cfg.get("mask_decoder_config")
                                      or {})}
    mlp_dim = v["mlp_dim"] or int(v["hidden_size"] * v["mlp_ratio"])
    return SamConfig(
        vision=SamVisionCfg(
            image_size=v["image_size"], patch_size=v["patch_size"],
            hidden_size=v["hidden_size"], num_layers=v["num_hidden_layers"],
            num_heads=v["num_attention_heads"], mlp_dim=mlp_dim,
            out_chans=v["output_channels"], window_size=v["window_size"],
            global_attn_indexes=tuple(v["global_attn_indexes"]),
            layer_norm_eps=v["layer_norm_eps"]),
        prompt_hidden=pc["hidden_size"],
        num_pos_feats=v["num_pos_feats"],
        decoder_heads=mc["num_attention_heads"],
        decoder_layers=mc["num_hidden_layers"],
        decoder_mlp_dim=mc["mlp_dim"],
        iou_head_hidden=mc["iou_head_hidden_dim"],
        iou_head_depth=mc["iou_head_depth"],
        num_multimask_outputs=mc["num_multimask_outputs"],
        input_image_size=pc["image_size"],
        attention_downsample_rate=mc["attention_downsample_rate"])


def port_sam(state_dict, cfg) -> Dict:
    """transformers.SamModel -> the JAX `models/sam` tree (`pe`, `vision`,
    `prompt`, `decoder`), which `io.from_jax.sam_state_dict` makes the
    port's `SamModel` state dict.

    Name map per `modeling_sam.py`: vision_encoder.* (rel-pos windowed
    ViT + neck), prompt_encoder.* (Fourier PE + corner / point embeddings),
    mask_decoder.* (two-way transformer + upscale + hypernetwork MLPs).
    """
    sd = state_dict
    v = cfg.vision
    p = v.patch_size

    def lin(prefix):
        out = {"w": _t(sd, prefix + ".weight").T}
        if prefix + ".bias" in sd:
            out["b"] = _t(sd, prefix + ".bias")
        return out

    def ln(prefix):
        return {"w": _t(sd, prefix + ".weight"),
                "b": _t(sd, prefix + ".bias")}

    vision = {
        # conv [C, 3, P, P] -> the (kh, kw, c)-flattened matmul kernel
        "patch_w": _t(sd, "vision_encoder.patch_embed.projection.weight"
                      ).transpose(2, 3, 1, 0).reshape(p * p * 3,
                                                      v.hidden_size),
        "patch_b": _t(sd, "vision_encoder.patch_embed.projection.bias"),
        "pos_embed": _t(sd, "vision_encoder.pos_embed"),
        "neck_conv1": _t(sd, "vision_encoder.neck.conv1.weight"
                         )[:, :, 0, 0].T,
        "neck_ln1": ln("vision_encoder.neck.layer_norm1"),
        "neck_conv2": _t(sd, "vision_encoder.neck.conv2.weight"
                         ).transpose(2, 3, 1, 0),
        "neck_ln2": ln("vision_encoder.neck.layer_norm2"),
        "layers": [],
    }
    for i in range(v.num_layers):
        pre = f"vision_encoder.layers.{i}"
        vision["layers"].append({
            "ln1": ln(pre + ".layer_norm1"),
            "ln2": ln(pre + ".layer_norm2"),
            "attn": {
                "qkv": lin(pre + ".attn.qkv"),
                "proj": lin(pre + ".attn.proj"),
                "rel_pos_h": _t(sd, pre + ".attn.rel_pos_h"),
                "rel_pos_w": _t(sd, pre + ".attn.rel_pos_w"),
            },
            "mlp1": lin(pre + ".mlp.lin1"),
            "mlp2": lin(pre + ".mlp.lin2"),
        })

    prompt = {
        "point_embed": np.stack(
            [_t(sd, f"prompt_encoder.point_embed.{i}.weight")[0]
             for i in range(4)]),
        "not_a_point": _t(sd, "prompt_encoder.not_a_point_embed.weight")[0],
        "no_mask": _t(sd, "prompt_encoder.no_mask_embed.weight")[0],
    }

    def sam_attn(prefix):
        return {"q": lin(prefix + ".q_proj"), "k": lin(prefix + ".k_proj"),
                "v": lin(prefix + ".v_proj"),
                "out": lin(prefix + ".out_proj")}

    def ffw(prefix, depth):
        return {"in": lin(prefix + ".proj_in"),
                "mid": [lin(f"{prefix}.layers.{j}")
                        for j in range(depth - 2)],
                "out": lin(prefix + ".proj_out")}

    n_mask_tokens = cfg.num_multimask_outputs + 1
    decoder = {
        "iou_token": _t(sd, "mask_decoder.iou_token.weight")[0],
        "mask_tokens": _t(sd, "mask_decoder.mask_tokens.weight"),
        "layers": [],
        "final_t2i": sam_attn(
            "mask_decoder.transformer.final_attn_token_to_image"),
        "final_ln": ln("mask_decoder.transformer.layer_norm_final_attn"),
        # ConvTranspose2d [in, out, kh, kw] -> [kh, kw, out, in]
        "up1_w": _t(sd, "mask_decoder.upscale_conv1.weight"
                    ).transpose(2, 3, 1, 0),
        "up1_b": _t(sd, "mask_decoder.upscale_conv1.bias"),
        "up_ln": ln("mask_decoder.upscale_layer_norm"),
        "up2_w": _t(sd, "mask_decoder.upscale_conv2.weight"
                    ).transpose(2, 3, 1, 0),
        "up2_b": _t(sd, "mask_decoder.upscale_conv2.bias"),
        "hyper": [ffw(f"mask_decoder.output_hypernetworks_mlps.{i}", 3)
                  for i in range(n_mask_tokens)],
        "iou_head": ffw("mask_decoder.iou_prediction_head",
                        cfg.iou_head_depth),
    }
    for i in range(cfg.decoder_layers):
        pre = f"mask_decoder.transformer.layers.{i}"
        decoder["layers"].append({
            "self_attn": sam_attn(pre + ".self_attn"),
            "t2i": sam_attn(pre + ".cross_attn_token_to_image"),
            "i2t": sam_attn(pre + ".cross_attn_image_to_token"),
            "ln1": ln(pre + ".layer_norm1"),
            "ln2": ln(pre + ".layer_norm2"),
            "ln3": ln(pre + ".layer_norm3"),
            "ln4": ln(pre + ".layer_norm4"),
            "mlp1": lin(pre + ".mlp.lin1"),
            "mlp2": lin(pre + ".mlp.lin2"),
        })

    return {
        "pe": _t(sd, "shared_image_embedding.positional_embedding"),
        "vision": vision,
        "prompt": prompt,
        "decoder": decoder,
    }
