"""Checkpoints of the port's training (counterpart of the JAX package's
`io/checkpoint.py`, which writes its train states with orbax).

- `save_projector` / `load_projector`: the stage-1 artifact. It writes
  `mm_projector.npz` in the JAX flat layout (`layers.{i}.kernel` [in, out],
  `layers.{i}.bias`), which the JAX `io.checkpoint.load_projector` reads, the
  reference's torch `mm_projector.bin` (`model.mm_projector.{2i}.weight`
  [out, in], the Sequential index skipping the GELUs) and `config.json`
  (the reference's `llava_trainer.py:167-192` projector-only save).
- `save_train_state` / `latest_checkpoint`: `checkpoint-{step}/` holds
  `params.npz`, the whole LLaVA in the flat `param_io` layout of the JAX
  params tree (`from_jax.load_llava_npz` reads it back, as does the JAX
  package's `param_io.load_params`), and `opt_state.pt`, the optimizer's
  state dict. Orbax is not available to the port: the layout of the
  parameters, not the container, is what matches. `keep` prunes to the
  newest checkpoints (HF `save_total_limit`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Optional

import numpy as np
import torch

from ..models.projector import Projector, parse_projector_type
from . import from_jax
from .param_io import save_params

PROJECTOR_NPZ = "mm_projector.npz"


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


def save_projector(ckpt_dir: str, projector: Projector,
                   config: Optional[Dict] = None,
                   proj_type: Optional[str] = None) -> str:
    """Stage-1 projector-only checkpoint; with `proj_type`, the reference's
    torch `mm_projector.bin` too. Returns the .npz path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = from_jax.projector_tree(projector.state_dict())
    flat = {f"layers.{i}.{k}": v for i, layer in enumerate(tree["layers"])
            for k, v in layer.items()}
    path = os.path.join(ckpt_dir, PROJECTOR_NPZ)
    np.savez(path, **flat)
    if proj_type is not None:
        torch.save(export_projector_torch_sd(projector, proj_type),
                   os.path.join(ckpt_dir, "mm_projector.bin"))
    if config is not None:
        with open(os.path.join(ckpt_dir, "config.json"), "w") as f:
            json.dump(config, f, indent=1)
    return path


def load_projector(path: str) -> Dict[str, torch.Tensor]:
    """A projector-only checkpoint (`mm_projector.npz`, or its directory),
    as the port's or the JAX package's `save_projector` writes it -> a
    `Projector` state dict."""
    if os.path.isdir(path):
        path = os.path.join(path, PROJECTOR_NPZ)
    with np.load(path) as data:
        if any(k.startswith("proj0.") for k in data.files):
            raise NotImplementedError(
                "MoF (per-tower) projector checkpoints are not ported to the "
                "PyTorch package yet (ROADMAP, queue 1: 5, diffusion towers)")
        n = 1 + max(int(k.split(".")[1]) for k in data.files)
        layers = [{k.split(".")[-1]: data[k] for k in data.files
                   if k.startswith(f"layers.{i}.")} for i in range(n)]
    return from_jax.projector_state_dict({"layers": layers})


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
