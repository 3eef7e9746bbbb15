"""Checkpoints of the port's training (counterpart of the JAX package's
`io/checkpoint.py`, which writes its train states with orbax).

- `save_projector` / `load_projector`: the stage-1 artifact. It writes
  `mm_projector.npz` in the JAX flat layout (`layers.{i}.kernel` [in, out],
  `layers.{i}.bias`; under MoF each tower's projector with the prefix
  `proj{t}.`), which the JAX `io.checkpoint.load_projector` reads, the
  reference's torch `mm_projector.bin` (`model.mm_projector.{2i}.weight`
  [out, in], the Sequential index skipping the GELUs; not for a perceiver
  or MoF projector, as in the JAX package) and `config.json` (the
  reference's `llava_trainer.py:167-192` projector-only save). A perceiver
  projector is saved whole, its tree's leaves under '.'-joined keys
  (`latents`, `layers.{i}.norm_media.scale`, `layers.{i}.to_q`, ...,
  `final_norm.bias`, `proj.kernel`). The JAX `save_projector` writes only
  its `layers`, with the LayerNorms as pickled objects, which no
  `np.load` without pickle reads: `load_projector` refuses such a file.
- `save_train_state` / `latest_checkpoint`: `checkpoint-{step}/` holds
  `params.npz`, the whole LLaVA in the flat `param_io` layout of the JAX
  params tree (`from_jax.load_llava_npz` reads it back, as does the JAX
  package's `param_io.load_params`), and `opt_state.pt`, the optimizer's
  state dict. Orbax is not available to the port: the layout of the
  parameters, not the container, is what matches. `keep` prunes to the
  newest checkpoints (HF `save_total_limit`).
- `save_lora` / `save_switch`: the LoRA-split save (`train.py:1122-1132`:
  the adapters, `lora_adapters.npz` in the JAX `lora` tree's layout, beside
  the projector and a `config.json` with `lora_r` / `lora_alpha`; not the
  frozen base) and the switch matrix (`switch.npz`). The JAX package's
  `param_io.load_params` reads both.
- `load_pretrained`: a checkpoint directory applied over a model the way
  the reference's `load_pretrained_model` resolves one: a full
  train state, or LoRA adapters (merged into the decoder) and/or a projector,
  whichever is present.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..models.perceiver import PerceiverResampler
from ..models.projector import Projector, parse_projector_type, port_perceiver
from . import from_jax
from .orbax_state import is_orbax_checkpoint, restore_params
from .param_io import load_params, save_params

PROJECTOR_NPZ = "mm_projector.npz"
LORA_NPZ = "lora_adapters.npz"
SWITCH_NPZ = "switch.npz"


def export_projector_torch_sd(projector: Projector,
                              proj_type: str = "mlp2x_gelu"
                              ) -> Dict[str, torch.Tensor]:
    """The reference's `mm_projector.bin` state dict (JAX
    `export_projector_torch_sd`): fp32 on the CPU."""
    kind, _ = parse_projector_type(proj_type)
    sd = {}
    for i, layer in enumerate(projector.layers):
        name = ("model.mm_projector" if kind == "linear"
                else f"model.mm_projector.{2 * i}")
        sd[f"{name}.weight"] = layer.weight.detach().float().cpu().clone()
        sd[f"{name}.bias"] = layer.bias.detach().float().cpu().clone()
    return sd


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    """A projector tree's leaves under '.'-joined keys, list indices as
    numbers: `layers.0.kernel`, `layers.0.norm_media.scale`, `latents`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _unflatten(flat: Dict[str, np.ndarray]):
    """Inverse of `_flatten`: numeric key parts are list indices."""
    root: Dict = {}
    for key, value in flat.items():
        node, parts = root, key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if all(k.isdigit() for k in node):
            return [listify(node[k]) for k in sorted(node, key=int)]
        return {k: listify(v) for k, v in node.items()}
    return listify(root)


def save_projector(ckpt_dir: str, projector,
                   config: Optional[Dict] = None,
                   proj_type: Optional[str] = None) -> str:
    """Stage-1 projector-only checkpoint of a `Projector`, a
    `PerceiverResampler` or MoF's `ModuleList` of per-tower projectors; with
    `proj_type`, the reference's torch `mm_projector.bin` too where the
    reference has one (not for a perceiver or MoF). Returns the .npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = from_jax.projector_tree(projector.state_dict())
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, list):
        for t, sub in enumerate(tree):
            _flatten(sub, f"proj{t}.", flat)
    else:
        _flatten(tree, "", flat)
    path = os.path.join(ckpt_dir, PROJECTOR_NPZ)
    np.savez(path, **flat)
    if proj_type is not None and isinstance(projector, Projector):
        torch.save(export_projector_torch_sd(projector, proj_type),
                   os.path.join(ckpt_dir, "mm_projector.bin"))
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=1)
    return path


def load_projector(path: str) -> Dict[str, torch.Tensor]:
    """A projector-only checkpoint (`mm_projector.npz`, or its directory),
    as the port's or the JAX package's `save_projector` writes it -> the
    state dict of the model's projector (a `Projector`, a
    `PerceiverResampler`, or MoF's `ModuleList`: keys `{t}.…`)."""
    if os.path.isdir(path):
        path = os.path.join(path, PROJECTOR_NPZ)
    with np.load(path) as data:
        keys = data.files
        if any(".to_q" in k for k in keys) and not any(
                k.split(".")[-1] == "latents" for k in keys):
            raise ValueError(
                f"{path} holds a perceiver projector without its latents, "
                f"final norm and output Linear (the JAX save_projector keeps "
                f"only its layers, and its LayerNorms as pickled objects): "
                f"it cannot be loaded")
        flat = {k: data[k] for k in keys}
    if any(k.startswith("proj0.") for k in flat):
        trees, t = [], 0
        while any(k.startswith(f"proj{t}.") for k in flat):
            pfx = f"proj{t}."
            trees.append(_unflatten({k[len(pfx):]: v for k, v in flat.items()
                                     if k.startswith(pfx)}))
            t += 1
        return from_jax.projector_state_dict(trees)
    return from_jax.projector_state_dict(_unflatten(flat))


def load_projector_bin(path: str, projector) -> Dict[str, torch.Tensor]:
    """The reference's `mm_projector.bin` -> the state dict of `projector`:
    a perceiver's `nn.Sequential(PerceiverResampler, Linear)` through
    `port_perceiver`, else the Linears in order (GELUs between them)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(projector, PerceiverResampler):
        prefix = ("model.mm_projector." if any(
            k.startswith("model.mm_projector.") for k in sd) else "")
        return port_perceiver(sd, len(projector.layers), prefix)
    if not isinstance(projector, Projector):
        raise ValueError(f"{path}: the reference writes no mm_projector.bin "
                         f"for per-tower (MoF) projectors")
    weights = sorted((k for k in sd if k.endswith(".weight")),
                     key=lambda k: [int(t) for t in k.split(".")
                                    if t.isdigit()])
    return {f"layers.{i}.{kind}": sd[w[:-len("weight")] + kind]
            for i, w in enumerate(weights) for kind in ("weight", "bias")}


def _step_dirs(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d.split("-")[-1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("checkpoint-")
                  and d.split("-")[-1].isdigit())


def save_train_state(ckpt_dir: str, params, optimizer, step: int,
                     keep: Optional[int] = None) -> str:
    """Write `checkpoint-{step}/{params.npz, opt_state.pt}`; with `keep`,
    remove all but the newest `keep` checkpoints."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    save_params(os.path.join(path, "params.npz"), from_jax.llava_tree(params))
    torch.save(optimizer.state_dict(), os.path.join(path, "opt_state.pt"))
    if keep:
        for s in _step_dirs(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(os.path.abspath(ckpt_dir),
                                       f"checkpoint-{s}"))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = _step_dirs(ckpt_dir)
    if not steps:
        return None
    return os.path.join(os.path.abspath(ckpt_dir), f"checkpoint-{steps[-1]}")


def save_lora(ckpt_dir: str, params, lora_r: int, lora_alpha: float) -> str:
    """The LoRA-split save: `lora_adapters.npz`, the projector and a
    `config.json` holding `lora_r` and `lora_alpha`. Returns the adapters'
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, LORA_NPZ)
    save_params(path, from_jax.lora_tree(params.lora.state_dict()))
    save_projector(ckpt_dir, params.projector,
                   config={"lora_r": lora_r, "lora_alpha": lora_alpha})
    return path


def save_switch(ckpt_dir: str, switch) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, SWITCH_NPZ)
    save_params(path, from_jax.switch_tree(switch.state_dict()))
    return path


def load_pretrained(model_dir: str, params, *, lora_cfg=None):
    """Apply the checkpoint directory `model_dir` over `params` (a
    `LlavaParams`, changed IN PLACE and returned): the newest
    `checkpoint-{step}` if there is one (the port's runner's, or the JAX
    runner's orbax train state); else LoRA adapters, merged into the
    decoder's dense weights, and/or a projector (`mm_projector.npz`, then
    `mm_projector.bin`, which wins where both are there; either of a
    perceiver, MoF's `.npz` of per-tower projectors).

    The adapters are read from `lora_adapters.npz`, the name the runners of
    both packages write, or from `lora.npz`, the name the JAX
    `load_pretrained` looks for. Without `lora_cfg` the rank comes from the
    adapters' shape and alpha from the directory's `config.json`
    (`lora_alpha`, as `save_lora` writes it), else from `LoraConfig()`."""
    from ..models.lora import LoraAdapters, LoraConfig, merge_lora
    latest = latest_checkpoint(model_dir)
    if latest is not None:
        sd = (from_jax.llava_state_dict(restore_params(latest))
              if is_orbax_checkpoint(latest) else
              from_jax.load_llava_npz(os.path.join(latest, "params.npz")))
        have = set(params.state_dict())
        params.load_state_dict({k: v for k, v in sd.items() if k in have})
        return params
    for name in (LORA_NPZ, "lora.npz"):
        path = os.path.join(model_dir, name)
        if not os.path.exists(path):
            continue
        tree = load_params(path)
        if lora_cfg is None:
            saved = {}
            cfg_path = os.path.join(model_dir, "config.json")
            if os.path.exists(cfg_path):
                with open(cfg_path) as f:
                    saved = json.load(f)
            rank = next(v for k, v in tree.items()
                        if k.endswith("_a")).shape[-1]
            lora_cfg = LoraConfig(
                rank=rank, alpha=saved.get("lora_alpha", LoraConfig().alpha),
                targets=tuple(sorted({k[:-2] for k in tree})))
        dec = params.decoder
        # on the decoder's device, so that the merge's products run there
        lora = LoraAdapters(dec.cfg, lora_cfg, dec.precision,
                            device=dec.embed.device)
        lora.load_state_dict(from_jax.lora_state_dict(tree))
        merge_lora(dec, lora, lora_cfg)
        break
    proj_path = os.path.join(model_dir, PROJECTOR_NPZ)
    torch_proj = os.path.join(model_dir, "mm_projector.bin")
    # both files may be there: the `.bin` is applied last and wins, as in
    # the JAX `load_pretrained`
    if os.path.exists(proj_path):
        params.projector.load_state_dict(load_projector(proj_path))
    if os.path.exists(torch_proj):
        params.projector.load_state_dict(
            load_projector_bin(torch_proj, params.projector))
    return params
