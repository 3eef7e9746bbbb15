"""JAX parameter trees -> the port's state dicts.

Input: the nested dict/list tree of numpy arrays that
`jax.tree.map(np.asarray, params)` or `io.param_io.load_params` gives for the
JAX package's LLaVA params `{"towers": [...], "projector": {...},
"decoder": {...}}` (or one of its subtrees). Output: flat state dicts of
torch tensors for `models.llava.LlavaParams` and its parts; `load_state_dict`
casts them to the module's param dtype.

Layout mapping:
- a Flax `Dense` kernel [in, out] becomes a `Dense.weight` [out, in];
- the decoder's stacked leaves [L, ...] split into per-layer weights;
- `patch_kernel (p, p, c, D)` reshapes to [p*p*c, D] in the NHWC unfold order
  of the tower's patch embedding, then transposes;
- LayerNorm `ln/scale`, `ln/bias` become `weight`, `bias`;
- the projector's `layers/#i/{kernel,bias}` become `layers.i.{weight,bias}`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .param_io import load_params

StateDict = Dict[str, torch.Tensor]

_VIT_DENSES = ("q", "k", "v", "o", "fc1", "fc2")
_LLAMA_DENSES = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from JAX
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))       # a writable copy


def _dense(tree, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _ln(tree, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(tree["ln"]["scale"])
    out[f"{prefix}.bias"] = _t(tree["ln"]["bias"])


def vit_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """One ViTTower's params ({"encoder": {...}}) -> ViTTower state dict."""
    enc = tree["encoder"]
    out: StateDict = {}
    e = f"{prefix}encoder"
    kernel = np.asarray(enc["patch_kernel"])
    out[f"{e}.patch_embed.weight"] = _t(kernel.reshape(-1, kernel.shape[-1]).T)
    if "patch_bias" in enc:
        out[f"{e}.patch_embed.bias"] = _t(enc["patch_bias"])
    if "cls_token" in enc:
        out[f"{e}.cls_token"] = _t(enc["cls_token"])
    out[f"{e}.pos_embed"] = _t(enc["pos_embed"])
    if "pre_ln" in enc:
        _ln(enc["pre_ln"], f"{e}.pre_ln", out)
    n_blocks = sum(1 for k in enc if k.startswith("block_"))
    for i in range(n_blocks):
        blk, bp = enc[f"block_{i}"], f"{e}.blocks.{i}"
        _ln(blk["ln1"], f"{bp}.ln1", out)
        _ln(blk["ln2"], f"{bp}.ln2", out)
        for name in _VIT_DENSES:
            _dense(blk[name], f"{bp}.{name}", out)
        for name in ("ls1", "ls2"):
            if name in blk:
                out[f"{bp}.{name}"] = _t(blk[name])
    return out


def projector_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    out: StateDict = {}
    for i, layer in enumerate(tree["layers"]):
        _dense(layer, f"{prefix}layers.{i}", out)
    return out


def llama_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """Stacked decoder params -> LlamaModel state dict."""
    layers = tree["layers"]
    out: StateDict = {f"{prefix}embed": _t(tree["embed"]),
                      f"{prefix}final_norm": _t(tree["final_norm"]),
                      f"{prefix}lm_head.weight": _t(
                          np.asarray(tree["lm_head"]).T)}
    for i in range(np.asarray(layers["wq"]).shape[0]):
        lp = f"{prefix}layers.{i}"
        for name in _LLAMA_DENSES:
            out[f"{lp}.{name}.weight"] = _t(np.asarray(layers[name][i]).T)
        out[f"{lp}.rms1"] = _t(np.asarray(layers["rms1"][i]))
        out[f"{lp}.rms2"] = _t(np.asarray(layers["rms2"][i]))
    return out


def llava_state_dict(params: Dict[str, Any]) -> StateDict:
    """Full JAX LLaVA params -> LlavaParams state dict."""
    out: StateDict = {}
    for i, tower in enumerate(params["towers"]):
        out.update(vit_state_dict(tower, f"towers.{i}."))
    out.update(projector_state_dict(params["projector"], "projector."))
    out.update(llama_state_dict(params["decoder"], "decoder."))
    return out


def load_llava_npz(path: str) -> StateDict:
    """A `param_io.save_params` .npz of full JAX LLaVA params -> state dict."""
    return llava_state_dict(load_params(path))
