"""JAX parameter trees <-> the port's state dicts.

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
- the projector's `layers/#i/{kernel,bias}` become `layers.i.{weight,bias}`;
  a perceiver's tree (`latents`, `layers/#i/{norm_media, norm_latents,
  ff_norm}/{scale,bias}`, raw matrices `to_q`, `to_kv`, `to_out`, `ff_in`,
  `ff_out` [in, out], `final_norm`, `proj`) becomes a
  `models.perceiver.PerceiverResampler` state dict (the matrices
  transposed, `scale` -> `weight`); under MoF the projector is a list of
  such trees, `projector.{t}.` the prefix of tower t's;
- a feature pseudo-tower has no weights (an empty tree, an `nn.Identity`);
- the MPT tree (`embed`, stacked `layers.{wqkv, wo, up, down}` [L, in, out]
  and `layers.{ln1, ln2}` [L, d], `final_ln`) becomes a `models.mpt.MptModel`
  state dict (`layers.i.wqkv.weight` [out, in], `layers.i.ln1` [d]);
- the optional `lora` subtree (`{t}_a` [L, din, r], `{t}_b` [L, r, dout])
  becomes `lora.layers.i.{t}_a` [din, r], `{t}_b` [r, dout], not transposed,
  and `switch.w` [D, D] stays as it is;
- the C score's `AggregationNetwork` tree (`metrics/aggregation.py`): a
  conv `bottleneck_{i}/{name}_conv/kernel (kh, kw, in, out)` becomes
  `bottlenecks.{i}.{name}.conv.weight (out, in, kh, kw)`, GroupNorm
  `{name}_gn/{scale, bias}` becomes `bottlenecks.{i}.{name}.gn.{weight,
  bias}`; `mixing_weights`, `logit_scale` and `self_logit_scale` stay as
  they are (one `BottleneckBlock`'s tree maps the same way without the
  `bottlenecks.{i}.` prefix);
- a diffusion featurizer bundle tree (`vae`, `backbone`, `image_encoder`,
  `prompt_embeds`, `pooled`; `models/featurizer.py`) becomes a
  `FeaturizerParams` state dict: the port's modules carry the Flax names
  (the UNets', DiT's and MMDiT's alike), so a path maps name by name,
  `kernel` to `weight` (a Dense [in, out] transposed, a conv [kh, kw, I, O],
  the DiT / MMDiT patch embedding's (p, p, C, D) among them, to
  [O, I, kh, kw]), a norm's `scale` to `weight`, and a bare leaf (MMDiT's
  `pos_embed` [1, 192², D]) as it is; the imsd `image_encoder`
  (CLIPVisionPooled) maps its `encoder` as a ViT tower does, its `post_ln`
  as a LayerNorm, and keeps `visual_projection` [hidden, projection]; the
  `prompt_embeds` and `pooled` buffers stay as they are;
- a CLIP text encoder's tree (`token_embedding`, `pos_embed`, `final_ln`,
  `block_{i}` as a tower's, `text_projection` [hidden, projection]) becomes
  a `models.text_encoder.CLIPTextEncoder` state dict, its blocks named as
  a tower's (`blocks.{i}.q.weight`, ...);
- a weight-only quantised decoder leaf of the JAX `ops/quant.py` becomes the
  buffers of a `QuantDense`: `{"q8" [in, out], "scale" [1, out]}` ->
  `q8` [out, in], `scale` [out]; `{"q4" [in / 2, out] bytes, "scale"
  [G, out]}` -> `q4` int32 [out, in / 8] in the port's nibble order
  (`ops.quant.pack_int4`), `scale` [G, out]. The codes and scales are the
  same numbers, so the two packages compute with the same weights;
- the SAM tree of `models/sam.py` (`pe`, `vision`, `prompt`, `decoder`;
  `io.hf_port.port_sam` gives it) becomes a `models.sam.SamModel` state
  dict path for path, '/' -> '.' and a list index `#i` -> `i`: the port's
  module keeps the JAX layouts (`w` [in, out], HWIO convs).

The `*_tree` functions are the inverse: the port's state dicts back to the
JAX trees of numpy fp32 arrays, which `param_io.save_params` writes and the
JAX package (or `load_llava_npz`) reads.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops import quant
from .param_io import _flatten, _listify, load_params

StateDict = Dict[str, torch.Tensor]

_VIT_DENSES = ("q", "k", "v", "o", "fc1", "fc2")
_LLAMA_DENSES = ("wq", "wk", "wv", "wo", "gate", "up", "down")
_MPT_DENSES = ("wqkv", "wo", "up", "down")


def _t(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16 from JAX
        a = a.astype(np.float32)
    elif a.dtype == np.dtype("V2"):         # bf16 read from a .npz or orbax
        a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return torch.from_numpy(np.array(a))       # a writable copy


def _unpack_q4_jax(q4: np.ndarray, ng: int) -> np.ndarray:
    """JAX packed bytes [in / 2, out] -> signed codes [in, out]: byte row j
    of a group holds contraction row j in its low nibble and row j + half a
    group in its high one."""
    b = np.asarray(q4).astype(np.uint8).astype(np.int16)
    lo, hi = b & 0xF, b >> 4
    lo, hi = np.where(lo >= 8, lo - 16, lo), np.where(hi >= 8, hi - 16, hi)
    half, do = b.shape[0] // ng, b.shape[1]
    codes = np.concatenate([lo.reshape(ng, half, do),
                            hi.reshape(ng, half, do)], axis=1)
    return codes.reshape(2 * b.shape[0], do).astype(np.int8)


def _pack_q4_jax(codes: np.ndarray, ng: int) -> np.ndarray:
    """Signed codes [in, out] -> the JAX packed bytes [in / 2, out]."""
    di, do = codes.shape
    g = codes.astype(np.int16).reshape(ng, di // ng, do)
    lo, hi = g[:, :di // ng // 2], g[:, di // ng // 2:]
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    return packed.astype(np.uint8).view(np.int8).reshape(di // 2, do)


def _quant_leaf(leaf, prefix: str, out: StateDict) -> None:
    """One (per-layer) JAX quantised leaf -> `QuantDense` buffers."""
    scale = np.asarray(leaf["scale"], np.float32)
    if "q8" in leaf:
        out[f"{prefix}.q8"] = _t(np.asarray(leaf["q8"]).T)
        out[f"{prefix}.scale"] = _t(scale.reshape(-1))
    else:
        codes = _unpack_q4_jax(leaf["q4"], scale.shape[0])
        out[f"{prefix}.q4"] = quant.pack_int4(_t(codes.T), scale.shape[0])
        out[f"{prefix}.scale"] = _t(scale)


def _llama_dense(leaf, prefix: str, out: StateDict, layer=None) -> None:
    """A decoder matmul weight, dense [in, out] or quantised, stacked over
    layers when `layer` is given."""
    if quant.is_quantized(leaf):
        if layer is not None:
            leaf = {k: np.asarray(v)[layer] for k, v in leaf.items()}
        _quant_leaf(leaf, prefix, out)
    else:
        w = np.asarray(leaf) if layer is None else np.asarray(leaf[layer])
        out[f"{prefix}.weight"] = _t(w.T)


def _dense(tree, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _ln(tree, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(tree["ln"]["scale"])
    out[f"{prefix}.bias"] = _t(tree["ln"]["bias"])


def vit_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """One ViTTower's params ({"encoder": {...}}) -> ViTTower state dict.
    The encoder's tree alone (what `io.port_cli` writes for a ViT tower)
    maps the same way."""
    enc = tree["encoder"] if "encoder" in tree else tree
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


def text_encoder_state_dict(tree: Dict[str, Any],
                            prefix: str = "") -> StateDict:
    """A CLIPTextEncoder tree (`models.text_encoder.port_clip_text`) ->
    `CLIPTextEncoder` state dict (its blocks as a tower's)."""
    out: StateDict = {f"{prefix}token_embedding": _t(tree["token_embedding"]),
                      f"{prefix}pos_embed": _t(tree["pos_embed"])}
    _ln(tree["final_ln"], f"{prefix}final_ln", out)
    n_blocks = sum(1 for k in tree if k.startswith("block_"))
    for i in range(n_blocks):
        blk, bp = tree[f"block_{i}"], f"{prefix}blocks.{i}"
        _ln(blk["ln1"], f"{bp}.ln1", out)
        _ln(blk["ln2"], f"{bp}.ln2", out)
        for name in _VIT_DENSES:
            _dense(blk[name], f"{bp}.{name}", out)
    if "text_projection" in tree:
        out[f"{prefix}text_projection"] = _t(tree["text_projection"])
    return out


_PERCEIVER_NORMS = ("norm_media", "norm_latents", "ff_norm")
_PERCEIVER_MATRICES = ("to_q", "to_kv", "to_out", "ff_in", "ff_out")


def _norm(tree, prefix: str, out: StateDict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def perceiver_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """A JAX perceiver projector tree -> `PerceiverResampler` state dict."""
    out: StateDict = {f"{prefix}latents": _t(tree["latents"])}
    for i, layer in enumerate(tree["layers"]):
        lp = f"{prefix}layers.{i}"
        for name in _PERCEIVER_NORMS:
            _norm(layer[name], f"{lp}.{name}", out)
        for name in _PERCEIVER_MATRICES:
            out[f"{lp}.{name}.weight"] = _t(np.asarray(layer[name]).T)
    _norm(tree["final_norm"], f"{prefix}final_norm", out)
    _dense(tree["proj"], f"{prefix}proj", out)
    return out


def projector_state_dict(tree, prefix: str = "") -> StateDict:
    """A JAX projector tree (dense layers or a perceiver), or MoF's list of
    per-tower trees -> the port's projector state dict."""
    if isinstance(tree, (list, tuple)):
        out: StateDict = {}
        for t, sub in enumerate(tree):
            out.update(projector_state_dict(sub, f"{prefix}{t}."))
        return out
    if "latents" in tree:
        return perceiver_state_dict(tree, prefix)
    out = {}
    for i, layer in enumerate(tree["layers"]):
        _dense(layer, f"{prefix}layers.{i}", out)
    return out


def llama_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """Stacked decoder params -> LlamaModel state dict. Quantised leaves
    (`quantize_decoder` on the JAX side) give the state dict of a decoder
    that `ops.quant.quantize_decoder` has quantised the same way."""
    layers = tree["layers"]
    out: StateDict = {f"{prefix}embed": _t(tree["embed"]),
                      f"{prefix}final_norm": _t(tree["final_norm"])}
    _llama_dense(tree["lm_head"], f"{prefix}lm_head", out)
    for i in range(np.asarray(layers["rms1"]).shape[0]):
        lp = f"{prefix}layers.{i}"
        for name in _LLAMA_DENSES:
            _llama_dense(layers[name], f"{lp}.{name}", out, layer=i)
        out[f"{lp}.rms1"] = _t(np.asarray(layers["rms1"][i]))
        out[f"{lp}.rms2"] = _t(np.asarray(layers["rms2"][i]))
    return out


def mpt_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """Stacked JAX MPT params -> `models.mpt.MptModel` state dict."""
    layers = tree["layers"]
    out: StateDict = {f"{prefix}embed": _t(tree["embed"]),
                      f"{prefix}final_ln": _t(tree["final_ln"])}
    for i in range(np.asarray(layers["ln1"]).shape[0]):
        lp = f"{prefix}layers.{i}"
        for name in _MPT_DENSES:
            out[f"{lp}.{name}.weight"] = _t(np.asarray(layers[name][i]).T)
        out[f"{lp}.ln1"] = _t(np.asarray(layers["ln1"][i]))
        out[f"{lp}.ln2"] = _t(np.asarray(layers["ln2"][i]))
    return out


def lora_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """The JAX `lora` tree -> `models.lora.LoraAdapters` state dict."""
    out: StateDict = {}
    for name, stacked in tree.items():
        for i, leaf in enumerate(np.asarray(stacked)):
            out[f"{prefix}layers.{i}.{name}"] = _t(leaf)
    return out


def switch_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    return {f"{prefix}w": _t(tree["w"])}


def flax_state_dict(tree: Dict[str, Any], prefix: str = "") -> StateDict:
    """A Flax subtree whose modules the port names the same way (the
    diffusion blocks) -> their state dict."""
    out: StateDict = {}
    _flax_into(tree, prefix, out)
    return out


def _flax_into(tree: Dict[str, Any], prefix: str, out: StateDict) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flax_into(leaf, f"{prefix}{name}.", out)
            continue
        a = np.asarray(leaf)
        if name == "kernel":
            a = a.T if a.ndim == 2 else a.transpose(3, 2, 0, 1)
            name = "weight"
        elif name == "scale":
            name = "weight"
        out[f"{prefix}{name}"] = _t(a)


def featurizer_state_dict(tree: Dict[str, Any],
                          prefix: str = "") -> StateDict:
    """A JAX featurizer bundle tree -> `models.featurizer.FeaturizerParams`
    state dict."""
    out: StateDict = {}
    _flax_into(tree["vae"], f"{prefix}vae.", out)
    # SDXL's text-time addition embedding: the porters of both packages
    # keep it, but no featurizer runs it (the reference's UNet forward has
    # no added-cond branch), and the port's UNetHarvest has no such module
    _flax_into({k: v for k, v in tree["backbone"].items()
                if k != "add_embedding"}, f"{prefix}backbone.", out)
    if "image_encoder" in tree:
        enc, p = tree["image_encoder"], f"{prefix}image_encoder."
        out.update(vit_state_dict(enc, p))
        _ln(enc["post_ln"], f"{p}post_ln", out)
        out[f"{p}visual_projection"] = _t(enc["visual_projection"])
    for name in ("prompt_embeds", "pooled"):
        if name in tree:
            out[f"{prefix}{name}"] = _t(tree[name])
    return out


def llava_state_dict(params: Dict[str, Any]) -> StateDict:
    """Full JAX LLaVA params -> LlavaParams state dict (with the `lora` and
    `switch` subtrees where the tree has them)."""
    out: StateDict = {}
    # a tree of feature pseudo-towers only saves no "towers" key at all
    for i, tower in enumerate(params.get("towers", [])):
        if tower and "vae" in tower:    # a diffusion featurizer
            out.update(featurizer_state_dict(tower, f"towers.{i}."))
        elif tower:                     # {} for a feature pseudo-tower
            out.update(vit_state_dict(tower, f"towers.{i}."))
    out.update(projector_state_dict(params["projector"], "projector."))
    out.update(llama_state_dict(params["decoder"], "decoder."))
    if "lora" in params:
        out.update(lora_state_dict(params["lora"], "lora."))
    if "switch" in params:
        out.update(switch_state_dict(params["switch"], "switch."))
    return out


_BOTTLENECK_CONVS = ("shortcut", "conv1", "conv2", "conv3")
_AGGREGATION_SCALARS = ("mixing_weights", "logit_scale", "self_logit_scale")


def _bottleneck_state_dict(tree, prefix: str, out: StateDict) -> None:
    for name in _BOTTLENECK_CONVS:
        if f"{name}_conv" not in tree:       # no shortcut when in == out
            continue
        kernel = np.asarray(tree[f"{name}_conv"]["kernel"])
        out[f"{prefix}{name}.conv.weight"] = _t(kernel.transpose(3, 2, 0, 1))
        out[f"{prefix}{name}.gn.weight"] = _t(tree[f"{name}_gn"]["scale"])
        out[f"{prefix}{name}.gn.bias"] = _t(tree[f"{name}_gn"]["bias"])


def aggregation_state_dict(tree: Dict[str, Any],
                           prefix: str = "") -> StateDict:
    """The Flax `AggregationNetwork` params (or one `BottleneckBlock`'s) ->
    the `metrics.aggregation` module's state dict."""
    out: StateDict = {}
    if "mixing_weights" not in tree:
        _bottleneck_state_dict(tree, prefix, out)
        return out
    for name in _AGGREGATION_SCALARS:
        out[f"{prefix}{name}"] = _t(tree[name])
    n = sum(1 for k in tree if k.startswith("bottleneck_"))
    for i in range(n):
        _bottleneck_state_dict(tree[f"bottleneck_{i}"],
                               f"{prefix}bottlenecks.{i}.", out)
    return out


def sam_state_dict(tree: Dict[str, Any]) -> StateDict:
    """The JAX SAM tree -> the `models.sam.SamModel` state dict."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k.replace("#", "").replace("/", "."): _t(v)
            for k, v in flat.items()}


def load_llava_npz(path: str) -> StateDict:
    """A `param_io.save_params` .npz of full JAX LLaVA params -> state dict."""
    return llava_state_dict(load_params(path))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _sub(sd: StateDict, prefix: str) -> StateDict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _dense_tree(sd: StateDict, prefix: str) -> Dict[str, np.ndarray]:
    out = {"kernel": _np(sd[f"{prefix}.weight"]).T.copy()}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _ln_tree(sd: StateDict, prefix: str) -> Dict[str, Any]:
    return {"ln": {"scale": _np(sd[f"{prefix}.weight"]),
                   "bias": _np(sd[f"{prefix}.bias"])}}


def _norm_tree(sd: StateDict, prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"])}


def perceiver_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `perceiver_state_dict`."""
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    layers = []
    for i in range(n):
        lp = f"layers.{i}"
        layer = {name: _norm_tree(sd, f"{lp}.{name}")
                 for name in _PERCEIVER_NORMS}
        layer.update({name: _np(sd[f"{lp}.{name}.weight"]).T.copy()
                      for name in _PERCEIVER_MATRICES})
        layers.append(layer)
    return {"latents": _np(sd["latents"]), "layers": layers,
            "final_norm": _norm_tree(sd, "final_norm"),
            "proj": _dense_tree(sd, "proj")}


def projector_tree(sd: StateDict):
    """Inverse of `projector_state_dict`: {"layers": [{"kernel" [in, out],
    "bias"}, ...]}, a perceiver's tree, or MoF's list of per-tower trees
    (keys `{t}.…`)."""
    towers = sorted({int(k.split(".")[0]) for k in sd
                     if k.split(".")[0].isdigit()})
    if towers:
        return [projector_tree(_sub(sd, f"{t}.")) for t in towers]
    if "latents" in sd:
        return perceiver_tree(sd)
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    return {"layers": [_dense_tree(sd, f"layers.{i}") for i in range(n)]}


def vit_tree(sd: StateDict, patch_size: int,
             num_channels: int = 3) -> Dict[str, Any]:
    """Inverse of `vit_state_dict` for one ViTTower state dict."""
    e = "encoder"
    kernel = _np(sd[f"{e}.patch_embed.weight"]).T
    enc: Dict[str, Any] = {"patch_kernel": kernel.reshape(
        patch_size, patch_size, num_channels, kernel.shape[-1]).copy()}
    if f"{e}.patch_embed.bias" in sd:
        enc["patch_bias"] = _np(sd[f"{e}.patch_embed.bias"])
    if f"{e}.cls_token" in sd:
        enc["cls_token"] = _np(sd[f"{e}.cls_token"])
    enc["pos_embed"] = _np(sd[f"{e}.pos_embed"])
    if f"{e}.pre_ln.weight" in sd:
        enc["pre_ln"] = _ln_tree(sd, f"{e}.pre_ln")
    n_blocks = len({k.split(".")[2] for k in sd
                    if k.startswith(f"{e}.blocks.")})
    for i in range(n_blocks):
        bp = f"{e}.blocks.{i}"
        blk: Dict[str, Any] = {"ln1": _ln_tree(sd, f"{bp}.ln1"),
                               "ln2": _ln_tree(sd, f"{bp}.ln2")}
        for name in _VIT_DENSES:
            blk[name] = _dense_tree(sd, f"{bp}.{name}")
        for name in ("ls1", "ls2"):
            if f"{bp}.{name}" in sd:
                blk[name] = _np(sd[f"{bp}.{name}"])
        enc[f"block_{i}"] = blk
    return {"encoder": enc}


def _llama_dense_tree(sd: StateDict, prefix: str, di=None):
    """Inverse of `_llama_dense` for one module: a dense [in, out] kernel or
    the JAX quantised leaf. `di` is the contraction dim of an int4 leaf
    whose words hold zero-padded groups (`quant.stored_width`)."""
    if f"{prefix}.weight" in sd:
        return _np(sd[f"{prefix}.weight"]).T.copy()
    scale = _np(sd[f"{prefix}.scale"])
    if f"{prefix}.q8" in sd:
        return {"q8": sd[f"{prefix}.q8"].cpu().numpy().T.copy(),
                "scale": scale.reshape(1, -1)}
    codes = quant._unpack_int4(sd[f"{prefix}.q4"].cpu(), torch.int8)
    if di is not None:
        codes = quant.unpad_groups(codes, scale.shape[0], di)
    codes = codes.numpy()
    return {"q4": _pack_q4_jax(codes.T, scale.shape[0]), "scale": scale}


def _out_dim(sd: StateDict, prefix: str) -> int:
    """Output channels of a dense or quantised decoder matmul."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"].shape[0]
    return sd[f"{prefix}.scale"].shape[-1]


def _stack(leaves):
    if isinstance(leaves[0], dict):
        return {k: np.stack([leaf[k] for leaf in leaves]) for k in leaves[0]}
    return np.stack(leaves)


def llama_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `llama_state_dict`: per-layer weights stacked to [L, ...],
    Dense weights back to [in, out] kernels, `QuantDense` buffers back to
    the JAX quantised leaves."""
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    hidden = sd["embed"].shape[1]
    # contraction dims: the attention's width into wo, the MLP's into down
    di = {name: hidden for name in _LLAMA_DENSES}
    di["wo"] = _out_dim(sd, "layers.0.wq")
    di["down"] = _out_dim(sd, "layers.0.up")
    layers = {name: _stack([_llama_dense_tree(sd, f"layers.{i}.{name}",
                                              di[name])
                            for i in range(n)])
              for name in _LLAMA_DENSES}
    for name in ("rms1", "rms2"):
        layers[name] = np.stack([_np(sd[f"layers.{i}.{name}"])
                                 for i in range(n)])
    return {"embed": _np(sd["embed"]), "layers": layers,
            "final_norm": _np(sd["final_norm"]),
            "lm_head": _llama_dense_tree(sd, "lm_head", hidden)}


def mpt_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `mpt_state_dict`."""
    n = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    layers = {name: np.stack([_np(sd[f"layers.{i}.{name}.weight"]).T
                              for i in range(n)]) for name in _MPT_DENSES}
    for name in ("ln1", "ln2"):
        layers[name] = np.stack([_np(sd[f"layers.{i}.{name}"])
                                 for i in range(n)])
    return {"embed": _np(sd["embed"]), "layers": layers,
            "final_ln": _np(sd["final_ln"])}


def lora_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `lora_state_dict`: `{t}_a` [L, din, r], `{t}_b`
    [L, r, dout]."""
    n = len({k.split(".")[1] for k in sd})
    names = sorted({k.split(".")[2] for k in sd})
    return {name: np.stack([_np(sd[f"layers.{i}.{name}"]) for i in range(n)])
            for name in names}


def switch_tree(sd: StateDict) -> Dict[str, Any]:
    return {"w": _np(sd["w"])}


def llava_tree(params) -> Dict[str, Any]:
    """A `models.llava.LlavaParams` -> the JAX LLaVA params tree (numpy),
    with `lora` / `switch` where the params carry them."""
    sd = params.state_dict()
    towers = []
    for i, tower in enumerate(params.towers):
        tsd = _sub(sd, f"towers.{i}.")
        if not tsd:
            towers.append({})
        elif "prompt_embeds" in tsd or "vae.conv_in.conv.weight" in tsd:
            towers.append(featurizer_tree(tsd))
        else:
            towers.append(vit_tree(tsd, tower.cfg.patch_size,
                                   tower.cfg.num_channels))
    tree = {"towers": towers,
            "projector": projector_tree(_sub(sd, "projector.")),
            "decoder": llama_tree(_sub(sd, "decoder."))}
    if params.lora is not None:
        tree["lora"] = lora_tree(_sub(sd, "lora."))
    if params.switch is not None:
        tree["switch"] = switch_tree(_sub(sd, "switch."))
    return tree


def flax_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `flax_state_dict`: a weight of rank 1 is a norm's
    `scale`, of rank 2 a Dense kernel, of rank 4 a conv kernel."""
    tree: Dict[str, Any] = {}
    for key, t in sd.items():
        *path, name = key.split(".")
        a = _np(t)
        if name == "weight":
            if a.ndim == 1:
                name = "scale"
            else:
                a = (a.T if a.ndim == 2 else a.transpose(2, 3, 1, 0)).copy()
                name = "kernel"
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[name] = a
    return tree


def featurizer_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `featurizer_state_dict`: a `FeaturizerParams` state dict
    -> the JAX bundle tree (numpy fp32) that `save_featurizer_bundle` of
    either package writes."""
    tree: Dict[str, Any] = {name: flax_tree(_sub(sd, f"{name}."))
                            for name in ("vae", "backbone")}
    enc = _sub(sd, "image_encoder.")
    if enc:
        w = enc["encoder.patch_embed.weight"]
        patch = int(round((w.shape[1] / 3) ** 0.5))
        sub = vit_tree({k: v for k, v in enc.items()
                        if k.startswith("encoder.")}, patch)
        sub["post_ln"] = _ln_tree(enc, "post_ln")
        sub["visual_projection"] = _np(enc["visual_projection"])
        tree["image_encoder"] = sub
    for name in ("prompt_embeds", "pooled"):
        if name in sd:
            tree[name] = _np(sd[name])
    return tree


def _bottleneck_tree(sd: StateDict, prefix: str) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name in _BOTTLENECK_CONVS:
        if f"{prefix}{name}.conv.weight" not in sd:
            continue
        tree[f"{name}_conv"] = {"kernel": _np(
            sd[f"{prefix}{name}.conv.weight"]).transpose(2, 3, 1, 0).copy()}
        tree[f"{name}_gn"] = {"scale": _np(sd[f"{prefix}{name}.gn.weight"]),
                              "bias": _np(sd[f"{prefix}{name}.gn.bias"])}
    return tree


def aggregation_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `aggregation_state_dict`."""
    if "mixing_weights" not in sd:
        return _bottleneck_tree(sd, "")
    tree: Dict[str, Any] = {name: _np(sd[name])
                            for name in _AGGREGATION_SCALARS}
    n = len({k.split(".")[1] for k in sd if k.startswith("bottlenecks.")})
    for i in range(n):
        tree[f"bottleneck_{i}"] = _bottleneck_tree(sd, f"bottlenecks.{i}.")
    return tree


def sam_tree(sd: StateDict) -> Dict[str, Any]:
    """Inverse of `sam_state_dict`: the '/'-joined tree, list indices
    `#i` (what `param_io.save_params` writes and the JAX `models/sam`
    reads)."""
    root: Dict[str, Any] = {}
    for key, t in sd.items():
        node = root
        parts = [f"#{p}" if p.isdigit() else p for p in key.split(".")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _np(t)
    return _listify(root)
