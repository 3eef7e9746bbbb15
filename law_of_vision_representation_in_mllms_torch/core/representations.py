"""The paper's 13 vision representations as a registry (a copy of the JAX
package's `core/representations.py`).

Maps the short names of the reference (README.md:66-80,
`policy/ablations_t.csv` row labels, `policy/prediction.py:13`) to tower
specs, the diffusion towers' image sizes and the `port-featurizer` kind
each needs. `render_config` writes a RunConfig YAML for any rep x stage
(`lvr-torch make-config`), the reference's 13 hand-edited pretrain /
finetune script variants; its text is the JAX package's, so one file
configures either package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Representation:
    name: str                 # paper short name (ablations_t.csv rows)
    tower: str                # tower spec ('.'-join = channel concat)
    img_size: Optional[int] = None       # diffusion towers only
    bundle_kinds: tuple = ()  # port-featurizer kinds, per entry
    notes: str = ""


REPRESENTATIONS: Dict[str, Representation] = {r.name: r for r in [
    Representation("CLIP336", "openai/clip-vit-large-patch14-336"),
    Representation("CLIP224", "openai/clip-vit-large-patch14"),
    Representation("OpenCLIP", "laion/CLIP-ViT-L-14-laion2B-s32B-b82K"),
    Representation("DINOv2", "facebook/dinov2-large"),
    Representation("SigLIP", "google/siglip-base-patch16-224"),
    Representation("SD1.5", "runwayml/stable-diffusion-v1-5",
                   img_size=768, bundle_kinds=("sd15",)),
    Representation("SD2.1", "stabilityai/stable-diffusion-2-1",
                   img_size=768, bundle_kinds=("sd21",)),
    Representation("SDim", "lambdalabs/sd-image-variations-diffusers",
                   img_size=768, bundle_kinds=("imsd",),
                   notes="CLIP-image conditioned (dift_imsd.py)"),
    Representation("SDXL", "stabilityai/stable-diffusion-xl-base-1.0",
                   img_size=512, bundle_kinds=("sdxl",)),
    Representation("DiT", "facebook/DiT-XL-2-512", img_size=512,
                   bundle_kinds=("dit",)),
    Representation("SD3", "stabilityai/stable-diffusion-3-medium-diffusers",
                   img_size=512, bundle_kinds=("sd3",)),
    Representation("CLIP224+DINOv2",
                   "openai/clip-vit-large-patch14.facebook/dinov2-large",
                   notes="channel concat, 256 tokens each"),
    Representation("CLIP336+DINOv2",
                   "openai/clip-vit-large-patch14-336."
                   "facebook/dinov2-large-336",
                   notes="channel concat, 576 tokens each (DINOv2 pos-embed"
                         " interpolated to 336)"),
]}


def render_config(rep_name: str, stage: int = 1, *,
                  tokenizer: str = "/ckpts/vicuna-7b-v1.5",
                  output_dir: Optional[str] = None,
                  data_path: str = "", image_folder: str = "",
                  n_data: int = 8, n_model: int = 1, zero: int = 2,
                  pretrain_mm_mlp_adapter: Optional[str] = None,
                  lora: bool = False,
                  qlora: Optional[str] = None) -> str:
    """RunConfig YAML for one representation x training stage.

    Stage-1 / 2 hyperparameters follow `scripts/v1_5/train/pretrain.sh` /
    `finetune.sh` (lr 1e-3 vs 2e-5, global batch 256 vs 128, projector-only
    vs full finetune). `lora=True` writes the `finetune_lora.sh` variant
    (lora_r 128, lora_alpha 256, lr 2e-4); `qlora` also stores the frozen
    decoder base in int4 / int8 (`train.py:908-932` load_in_{4,8}bit +
    peft). The attention routes, `tower_fast_act` and `remat_policy` are
    the JAX package's choices for its own kernels; the port maps each route
    name onto its Hopper kernel (`models.vit.attention_route`)."""
    import yaml

    rep = REPRESENTATIONS[rep_name]
    slug = rep_name.lower().replace("+", "_").replace(".", "")
    model: Dict = {
        "vision_tower": rep.tower,
        "decoder": "vicuna-7b",
        "projector_type": "mlp2x_gelu",
        "tokenizer": tokenizer,
    }
    if rep.img_size:
        model["img_size"] = rep.img_size
    if rep.bundle_kinds:
        model["tower_weights"] = [
            f"ports/{k}_bundle.npz" for k in rep.bundle_kinds]
        model["diffusion_attn_impl"] = "xla_expclamp_fused"
    else:
        model["tower_attn_impl"] = "xla_expclamp_fused"
        if "dinov2" in rep.tower or "laion" in rep.tower:
            # the erf-GELU towers take the tanh GELU
            model["tower_fast_act"] = True
    train: Dict = {
        "stage": stage,
        "learning_rate": 1e-3 if stage == 1 else 2e-5,
        "warmup_ratio": 0.03,
        "epochs": 1,
        "batch_size": 256 if stage == 1 else 128,
        "max_length": 2048,
        "bf16": True,
        "gradient_checkpointing": True,
        "remat_policy": "dots",
        "group_by_modality_length": stage == 2,
        "output_dir": output_dir or f"checkpoints/stage{stage}_{slug}",
    }
    if stage == 2:
        train["pretrain_mm_mlp_adapter"] = (
            pretrain_mm_mlp_adapter or f"checkpoints/stage1_{slug}")
    if lora or qlora:
        # finetune_lora.sh: --lora_enable True --lora_r 128
        # --lora_alpha 256 --learning_rate 2e-4
        train["lora_enable"] = True
        train["lora_r"] = 128
        train["lora_alpha"] = 256.0
        if stage == 2:
            train["learning_rate"] = 2e-4
    if qlora:
        if qlora not in ("int4", "int8"):
            raise ValueError(f"qlora must be int4/int8, got {qlora!r}")
        train["quantize_base"] = qlora
    data = {
        "data_path": data_path or (
            "data/blip_laion_cc_sbu_558k.json" if stage == 1
            else "data/llava_v1_5_mix665k.json"),
        "image_folder": image_folder or "data/images",
        "image_aspect_ratio": "pad",
    }
    cfg = {"model": model, "train": train, "data": data,
           "parallel": {"n_data": n_data, "n_model": n_model,
                        "zero": zero}}
    header = f"# {rep_name} ({rep.tower}) stage {stage}"
    if rep.notes:
        header += f" — {rep.notes}"
    if rep.bundle_kinds:
        # the command's words as the JAX package writes them: `lvr-torch
        # port-featurizer` takes the same arguments
        header += ("\n# port first: lvr port-featurizer "
                   f"{rep.bundle_kinds[0]} <snapshot_dir> "
                   f"ports/{rep.bundle_kinds[0]}_bundle.npz")
    return header + "\n" + yaml.safe_dump(cfg, sort_keys=False)
