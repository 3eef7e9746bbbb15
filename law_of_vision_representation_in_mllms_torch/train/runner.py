"""Model and tokenizer construction from a RunConfig (the parts of the JAX
package's `train/runner.py` that `eval.runner.build_lmm` needs).

`build_model` supports ViT towers with seeded random weights, per-tower
weights from `model.tower_weights` (JAX `param_io` .npz files), and a full
LLaVA parameter file in `model.checkpoint` (a `param_io` .npz, such as the
JAX CLI's `consolidate` writes). The training loop itself is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.config import RunConfig
from ..core.precision import DEFAULT_PRECISION, Precision
from ..data.preprocess import SimpleTokenizer
from ..io import from_jax
from ..io.param_io import load_params
from ..models import llama, llava
from ..models.towers import parse_tower_spec

# RunConfig fields whose features the port does not have yet: field -> the
# ROADMAP queue-1 item that brings them
_UNPORTED = {
    "quantize": "9, generation and serving",
    "kv_quant": "9, generation and serving",
    "visual_keep": "4, projector and image encoding",
    "tower_attn_impl": "2, ViT tower",
    "diffusion_attn_impl": "8, diffusion towers",
}


def build_tokenizer(cfg: RunConfig):
    if cfg.model.tokenizer:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(cfg.model.tokenizer)
    # the hash tokenizer must emit ids inside the decoder's vocab
    vocab = llama.tiny().vocab_size if cfg.model.decoder == "tiny" else 32000
    return SimpleTokenizer(vocab_size=vocab)


def build_model(cfg: RunConfig, *, device, precision: Precision =
                DEFAULT_PRECISION, generator: torch.Generator | None = None):
    """(LlavaConfig, LlavaParams) on `device`. Random weights come from
    `generator`, by default a generator on `device` seeded with
    `cfg.train.seed`."""
    for field, item in _UNPORTED.items():
        if getattr(cfg.model, field):
            raise NotImplementedError(
                f"model.{field} is not ported to the PyTorch package yet "
                f"(ROADMAP, queue 1: {item})")
    spec = parse_tower_spec(cfg.model.vision_tower)
    if cfg.model.tower_fast_act:
        # erf-GELU -> tanh-GELU substitution, only where the act is "gelu"
        spec = dataclasses.replace(spec, entries=[
            dataclasses.replace(e, vit_config=dataclasses.replace(
                e.vit_config, hidden_act="gelu_tanh"))
            if e.vit_config.hidden_act == "gelu" else e
            for e in spec.entries])
    if cfg.model.decoder == "vicuna-7b":
        dec = llama.vicuna_7b()
    elif cfg.model.decoder == "tiny":
        dec = llama.tiny()
    else:
        raise ValueError(f"unknown decoder {cfg.model.decoder}")
    if cfg.model.decoder_layers:
        dec = dataclasses.replace(dec, num_layers=cfg.model.decoder_layers)
    model_cfg = llava.LlavaConfig(
        tower_spec=spec, decoder=dec,
        projector_type=cfg.model.projector_type,
        select_layer=cfg.model.select_layer,
        select_feature=cfg.model.select_feature)

    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(cfg.train.seed)
    params = llava.init_params(generator, model_cfg, precision, device)

    paths = cfg.model.tower_weights or []
    if paths and len(paths) != len(spec.entries):
        raise ValueError(f"model.tower_weights has {len(paths)} paths for "
                         f"{len(spec.entries)} tower entries")
    for tower, path in zip(params.towers, paths):
        if path:
            tower.load_state_dict(from_jax.vit_state_dict(load_params(path)))
    if cfg.model.checkpoint:
        if not cfg.model.checkpoint.endswith(".npz"):
            raise NotImplementedError(
                "model.checkpoint must be a flat params .npz in the PyTorch "
                "package (turn an orbax checkpoint into one with the JAX "
                "CLI's `consolidate`)")
        params.load_state_dict(from_jax.load_llava_npz(cfg.model.checkpoint))
    if cfg.train.pretrain_mm_mlp_adapter:
        raise NotImplementedError(
            "train.pretrain_mm_mlp_adapter is not ported to the PyTorch "
            "package yet (ROADMAP, queue 1: 5, decoder and training)")
    return model_cfg, params
