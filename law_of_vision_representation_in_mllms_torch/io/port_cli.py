"""Port checkpoints from local HF / diffusers snapshot directories
(counterpart of the JAX package's `io/port_cli.py`).

Reads a LOCAL snapshot directory (config.json + *.safetensors or
pytorch_model*.bin; no network), maps its state dict through the family
porters (`io.hf_port`, `io.diffusers_port`, `models.text_encoder`) into the
JAX package's parameter tree, and writes one flat `param_io` .npz per
component: the file the JAX CLI writes, which `io.from_jax` turns into the
port's state dicts (a ported tower goes into `model.tower_weights`).

    python -m law_of_vision_representation_in_mllms_torch.io.port_cli \\
        clip_vision /ckpts/clip-vit-large-patch14-336 ports/clip336.npz \\
        --image-size 336

`*.safetensors` files are read by `load_safetensors`, this module's own
reader of the format: the `safetensors` package is not a dependency.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import struct
from typing import Dict, Optional

import torch

from .param_io import save_params

# the safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8,
    "U8": torch.uint8, "BOOL": torch.bool,
}


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file -> {name: CPU tensor}.

    The format: an 8-byte little-endian header length N, N bytes of JSON
    ({name: {"dtype", "shape", "data_offsets": [begin, end]}} and an
    optional "__metadata__"), then the tensors' raw little-endian bytes,
    each at its offsets from the end of the header. The tensors share one
    buffer holding the file's data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        # one buffer, read into in place (not a bytes copy as well)
        data = bytearray(os.path.getsize(path) - 8 - n)
        if f.readinto(data) != len(data):
            raise ValueError(f"{path}: the file ended early")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which this reader does not "
                             f"take ({sorted(SAFETENSORS_DTYPES)})")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        size = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * size or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} "
                             f"{info['dtype']} has data_offsets "
                             f"[{begin}, {end}]")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(data, dtype=dtype, count=count,
                                     offset=begin).reshape(shape)
    return out


def load_torch_state_dict(src_dir: str) -> Dict[str, torch.Tensor]:
    """Every weight shard of a snapshot directory, in sorted order: its
    `*.safetensors` files, else its `pytorch_model*.bin` /
    `diffusion_pytorch_model*.bin` files (`torch.load`, weights only)."""
    sd: Dict[str, torch.Tensor] = {}
    safes = sorted(glob.glob(os.path.join(src_dir, "*.safetensors")))
    if safes:
        for f in safes:
            sd.update(load_safetensors(f))
        return sd
    bins = sorted(glob.glob(os.path.join(src_dir, "pytorch_model*.bin")) +
                  glob.glob(os.path.join(src_dir,
                                         "diffusion_pytorch_model*.bin")))
    if not bins:
        raise FileNotFoundError(f"no weight files in {src_dir}")
    for f in bins:
        sd.update(torch.load(f, map_location="cpu", weights_only=True))
    return sd


def port_component(kind: str, src_dir: str, out_path: str,
                   **kwargs) -> str:
    """Port the snapshot in `src_dir` as `kind` (a key of `PORTERS`) and
    write the tree to `out_path`; returns `out_path`."""
    sd = load_torch_state_dict(src_dir)
    params = PORTERS[kind](sd, src_dir, **kwargs)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    save_params(out_path, params)
    return out_path


def _hf_config(src_dir: str) -> Dict:
    with open(os.path.join(src_dir, "config.json")) as f:
        return json.load(f)


def _vit(family):
    def port(sd, src_dir, image_size: Optional[int] = None,
             select_layer: int = -2, **_):
        from ..models.vit import VIT_PRESETS
        from .hf_port import port_vit
        vc = _hf_config(src_dir)
        vc = vc.get("vision_config", vc)
        # the family presets carry the structural flags
        base = {"clip": VIT_PRESETS["openai/clip-vit-large-patch14"](),
                "siglip": VIT_PRESETS["google/siglip-base-patch16-224"](),
                "dinov2": VIT_PRESETS["facebook/dinov2-large"]()}[family]
        cfg = dataclasses.replace(
            base, image_size=image_size or vc.get("image_size", 224),
            patch_size=vc.get("patch_size", 14),
            hidden_size=vc.get("hidden_size", 1024),
            num_layers=vc.get("num_hidden_layers", 24),
            num_heads=vc.get("num_attention_heads", 16),
            intermediate_size=vc.get("intermediate_size", 4096),
            hidden_act=vc.get("hidden_act", base.hidden_act))
        return port_vit(family, sd, cfg,
                        num_blocks=cfg.resolve_layer(select_layer))
    return port


def _llama(sd, src_dir, **_):
    from ..models.llama import LlamaConfig
    from .hf_port import port_llama
    hf = _hf_config(src_dir)
    cfg = LlamaConfig(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads",
                            hf["num_attention_heads"]),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_eps=hf.get("rms_norm_eps", 1e-5))
    return port_llama(sd, cfg)


def _clip_text(sd, src_dir, penultimate: bool = False, **_):
    from ..models.text_encoder import port_clip_text, text_config_from_hf
    cfg = text_config_from_hf(_hf_config(src_dir), sd)
    n = cfg.num_layers - 1 if penultimate else None
    return port_clip_text(sd, cfg, num_blocks=n)


def _unet(style):
    def port(sd, src_dir, up_ft_index: int = 0, **_):
        from ..models import unet as UN
        from .diffusers_port import port_unet
        cfg = {"sd15": UN.sd15_unet, "sd21": UN.sd21_unet,
               "sdxl": UN.sdxl_unet}[style]()
        return port_unet(sd, cfg, (up_ft_index,))
    return port


def _vae(style):
    def port(sd, src_dir, **_):
        from ..models import vae as VA
        from .diffusers_port import port_vae_encoder
        cfg = {"sd": VA.sd_vae, "sdxl": VA.sdxl_vae,
               "sd3": VA.sd3_vae}[style]()
        return port_vae_encoder(sd, cfg)
    return port


def _dit(sd, src_dir, up_ft_index: int = -1, **_):
    from ..models.dit import dit_xl_2
    from .diffusers_port import port_dit
    return port_dit(sd, dit_xl_2(), (up_ft_index,))


def _mmdit(sd, src_dir, up_ft_index: int = -1, **_):
    from ..models.mmdit import sd3_medium
    from .diffusers_port import port_mmdit
    return port_mmdit(sd, sd3_medium(), (up_ft_index,))


def _clip_vision_pooled(sd, src_dir, **_):
    from ..models.vit import clip_l14
    from .hf_port import port_clip_vision_pooled
    return port_clip_vision_pooled(sd, clip_l14(224))


PORTERS = {
    "clip_vision": _vit("clip"),
    "siglip_vision": _vit("siglip"),
    "dinov2": _vit("dinov2"),
    "clip_text": _clip_text,
    "llama": _llama,
    "unet_sd15": _unet("sd15"),
    "unet_sd21": _unet("sd21"),
    "unet_sdxl": _unet("sdxl"),
    "vae_sd": _vae("sd"),
    "vae_sdxl": _vae("sdxl"),
    "vae_sd3": _vae("sd3"),
    "dit": _dit,
    "mmdit": _mmdit,
    "clip_vision_pooled": _clip_vision_pooled,
}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=sorted(PORTERS))
    p.add_argument("src_dir")
    p.add_argument("out_path")
    p.add_argument("--image-size", type=int)
    p.add_argument("--select-layer", type=int, default=-2)
    p.add_argument("--up-ft-index", type=int, default=0)
    p.add_argument("--penultimate", action="store_true")
    a = p.parse_args(argv)
    kw = {"select_layer": a.select_layer, "up_ft_index": a.up_ft_index,
          "penultimate": a.penultimate}
    if a.image_size:
        kw["image_size"] = a.image_size
    out = port_component(a.kind, a.src_dir, a.out_path, **kw)
    print(f"ported {a.kind} from {a.src_dir} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
