"""Diffusion featurizer bundles in the JAX package's format (a copy of its
`io/featurizer_bundle.py`): save, load, and `port_featurizer_bundle`, which
makes one from a local diffusers snapshot.

A bundle is a flat `param_io` .npz of the featurizer's tree (`vae/...`,
`backbone/...` (a UNet, DiT or MMDiT), `prompt_embeds` [1, T, D] (not dit
or imsd), `pooled` [1, D] (sd3), `image_encoder/...` for imsd)
plus `<path>.json`, the `FeaturizerConfig` as `config_to_dict` writes it.
`lvr-torch port-featurizer` (`port_featurizer_bundle`) makes one from a
diffusers snapshot; either package reads what the other writes.

The text conditioning of the run's fixed prompt ('' throughout the
pipeline, `train.py:85`) is computed once, here, by the snapshot's CLIP
text encoders (`models.text_encoder`), and stored as a buffer. On the card
it runs in bf16 compute with fp32 LayerNorms, its attention on kernel 2's
causal form; on the CPU in fp32 through the plain version, the precision of
the JAX `port_featurizer_bundle`. Either way it is stored in fp32.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import featurizer as F
from . import from_jax
from .param_io import load_params, save_params


def save_featurizer_bundle(out_path: str, params, cfg: F.FeaturizerConfig
                           ) -> str:
    """Write `params` (a `FeaturizerParams` or the JAX tree of numpy
    arrays) and `cfg`; returns the .npz path."""
    if not out_path.endswith(".npz"):
        out_path += ".npz"
    if isinstance(params, nn.Module):
        params = from_jax.featurizer_tree(params.state_dict())
    save_params(out_path, params)
    with open(out_path + ".json", "w") as f:
        json.dump(F.config_to_dict(cfg), f)
    return out_path


def load_featurizer_bundle(path: str
                           ) -> Tuple[Dict, Optional[F.FeaturizerConfig]]:
    """(tree of numpy arrays, config or None): a bundle without its sidecar
    loads with config None (the caller takes the tower's preset)."""
    params = load_params(path)
    sidecar = path + ".json"
    cfg = None
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            cfg = F.config_from_dict(json.load(f))
    return params, cfg


# ---------------------------------------------------------------------------
# Porting: a diffusers snapshot directory -> a bundle
# ---------------------------------------------------------------------------

_CLIP_BOS, _CLIP_EOS = 49406, 49407

# the kind names of `port-featurizer` -> the FEATURIZER_PRESETS entry
BUNDLE_KINDS = {
    "sd15": "runwayml/stable-diffusion-v1-5",
    "sd21": "stabilityai/stable-diffusion-2-1",
    "imsd": "lambdalabs/sd-image-variations-diffusers",
    "sdxl": "stabilityai/stable-diffusion-xl-base-1.0",
    "dit": "facebook/DiT-XL-2-512",
    "sd3": "stabilityai/stable-diffusion-3-medium-diffusers",
}


def _empty_prompt_ids(length: int = 77, pad_id: int = _CLIP_EOS
                      ) -> np.ndarray:
    """Token ids of the empty prompt: [bos, eos, pad...]. SD1.5-style CLIP
    pads with eos; SD2.1 / SDXL's second tokenizer pads with 0 ('!')."""
    ids = np.full((1, length), pad_id, np.int32)
    ids[0, 0] = _CLIP_BOS
    ids[0, 1] = _CLIP_EOS
    return ids


def _text_config(src_dir: str):
    """(TextConfig, state dict) of the text encoder snapshot in `src_dir`."""
    from ..models.text_encoder import text_config_from_hf
    from .port_cli import load_torch_state_dict
    with open(os.path.join(src_dir, "config.json")) as f:
        hf = json.load(f)
    sd = load_torch_state_dict(src_dir)
    return text_config_from_hf(hf, sd), sd


def _encode_prompt(src_dir: str, prompt_ids: np.ndarray, *,
                   penultimate: bool, want_pooled: bool = False,
                   device=torch.device("cpu")):
    """Port the CLIP text encoder in `src_dir` and run the fixed prompt
    through it on `device`: fp32 on the CPU, bf16 compute (fp32 weights and
    LayerNorms) on the card. Returns fp32 numpy (hidden [1, T, D], pooled
    [1, P] or None)."""
    from ..core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from ..models.text_encoder import CLIPTextEncoder, port_clip_text

    cfg, sd = _text_config(src_dir)
    n_blocks = cfg.num_layers - 1 if penultimate else None
    tree = port_clip_text(sd, cfg, num_blocks=None if want_pooled
                          else n_blocks)
    del sd
    precision = FP32_PRECISION if device.type == "cpu" else DEFAULT_PRECISION
    enc = CLIPTextEncoder(cfg, precision, device=device, num_blocks=sum(
        1 for k in tree if k.startswith("block_")))
    enc.load_state_dict(from_jax.text_encoder_state_dict(tree))
    ids = torch.as_tensor(np.asarray(prompt_ids), dtype=torch.long,
                          device=device)
    with torch.no_grad():
        hidden, pooled = enc(ids, num_blocks=n_blocks,
                             want_pooled=want_pooled)
    return (hidden.float().cpu().numpy(),
            None if pooled is None else pooled.float().cpu().numpy())


def port_featurizer_bundle(kind: str, src_root: str, out_path: str, *,
                           t: int = 1, up_ft_index: Optional[int] = None,
                           ensemble_size: int = 1,
                           img_size: Optional[int] = None,
                           prompt_ids: Optional[np.ndarray] = None,
                           prompt_ids_2: Optional[np.ndarray] = None,
                           config: Optional[F.FeaturizerConfig] = None,
                           device=None) -> str:
    """Assemble a bundle from a local diffusers snapshot directory (its
    `unet/ vae/ text_encoder*/ transformer/ image_encoder/` sub-dirs) and
    write it to `out_path`; returns the .npz path.

    As the reference featurizers assemble themselves at run time:
    `dift_sd.py:224-237` (SD1.5 / 2.1: UNet + VAE + CLIP text),
    `dift_imsd.py:195-230` (image variations: CLIP image conditioning),
    `dift_dit.py:117-160` (DiT: timestep only), `dift_sd3.py:105-135` (SD3:
    two CLIPs, T5 dropped: a zero-padded context). The prompt is encoded on
    `device` (default the card; a CUDA request without one raises)."""
    from .diffusers_port import (port_dit, port_mmdit, port_unet,
                                 port_vae_encoder)
    from .port_cli import load_torch_state_dict

    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to encode the "
                           "prompt on the CPU")
    cfg = config or F.FEATURIZER_PRESETS[BUNDLE_KINDS[kind]]()
    cfg = dataclasses.replace(
        cfg, t=t, ensemble_size=ensemble_size,
        up_ft_index=cfg.up_ft_index if up_ft_index is None else up_ft_index,
        img_size=img_size or cfg.img_size)

    def sub(d):
        return load_torch_state_dict(os.path.join(src_root, d))

    def encode(d, ids, **kw):
        return _encode_prompt(os.path.join(src_root, d), ids, device=device,
                              **kw)

    ids1 = prompt_ids if prompt_ids is not None else _empty_prompt_ids()
    ids2 = (prompt_ids_2 if prompt_ids_2 is not None
            else _empty_prompt_ids(pad_id=0))
    params: Dict = {}
    if cfg.family == "dit":
        params["backbone"] = port_dit(sub("transformer"), cfg.dit,
                                      (cfg.up_ft_index,))
        params["vae"] = port_vae_encoder(sub("vae"), cfg.vae)
    elif cfg.family == "sd3":
        params["backbone"] = port_mmdit(sub("transformer"), cfg.mmdit,
                                        (cfg.up_ft_index,))
        params["vae"] = port_vae_encoder(sub("vae"), cfg.vae)
        h1, p1 = encode("text_encoder", ids1, penultimate=True,
                        want_pooled=True)
        h2, p2 = encode("text_encoder_2", ids2, penultimate=True,
                        want_pooled=True)
        clip = np.concatenate([h1, h2], axis=-1)          # [1, 77, 2048]
        clip = np.pad(clip, ((0, 0), (0, 0),
                             (0, cfg.mmdit.context_dim - clip.shape[-1])))
        # T5 dropped (`dift_sd3.py:131-132`): its 256 context tokens are
        # zeros, as diffusers gives them with text_encoder_3=None
        t5 = np.zeros((1, 256, cfg.mmdit.context_dim), np.float32)
        params["prompt_embeds"] = np.concatenate([clip, t5], axis=1)
        params["pooled"] = np.concatenate([p1, p2], axis=-1)  # [1, 2048]
    else:
        params["backbone"] = port_unet(sub("unet"), cfg.unet,
                                       (cfg.up_ft_index,))
        params["vae"] = port_vae_encoder(sub("vae"), cfg.vae)
        if cfg.family == "imsd":
            from ..models.vit import clip_l14
            from .hf_port import port_clip_vision_pooled
            params["image_encoder"] = port_clip_vision_pooled(
                sub("image_encoder"), clip_l14(224))
        elif cfg.family == "sdxl":
            h1, _ = encode("text_encoder", ids1, penultimate=True)
            h2, _ = encode("text_encoder_2", ids2, penultimate=True)
            params["prompt_embeds"] = np.concatenate([h1, h2], axis=-1)
        else:                                             # sd15 / sd21
            params["prompt_embeds"], _ = encode("text_encoder", ids1,
                                                penultimate=False)
    return save_featurizer_bundle(out_path, params, cfg)
