"""LoRA adapters for the LLaMA decoder (counterpart of the JAX package's
`models/lora.py`).

Reference: `llava/train/train.py:945-985` (peft LoraConfig over the decoder's
linear layers, r / alpha flags at :110-115, the LoRA-split save at
:1122-1132). The low-rank factors live in their own module beside the
decoder, `LlavaParams.lora`, one `LoraLayer` per decoder block holding
`{t}_a` [din, r] and `{t}_b` [r, dout] for every target `t` (the JAX leaves
`{t}_a [L, din, r]`, `{t}_b [L, r, dout]`, split per layer and not
transposed). A block adds the per-site delta `(x · A) · B · (alpha / r)` in the
compute dtype to its base product, dense or quantised: two rank-r matmuls
that never form the weight delta. `merge_lora` folds the adapters into the
base weights in fp32 for serving.

Freeze rule (`train.train_step._freeze_labels`): with adapters present the
decoder is frozen, the adapters and the projector train, the towers never.

Tensor parallelism (`LoraAdapters.shard_tensor_parallel`, beside the
decoder's `shard_tensor_parallel`): the adapters of a column-parallel
product keep A whole and B's columns of the rank's output channels; those
of a row-parallel product A's rows of the rank's input features and B
whole (`param_partition_specs`; `models/llama.py` says how each gets its
whole gradient). The JAX package keeps the adapters whole on every model
rank (its `param_partition_tree` gives them no spec); the numbers are the
same. `unshard_tensor_parallel` gathers them for a save, which writes the
JAX `lora` tree's whole [L, din, r] / [L, r, dout] tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..parallel import comm
from ..parallel.fsdp import P
from .layers import Dense, init_weights, round_to_dtype
from .llama import TP_ROW, LlamaConfig, LlamaModel

LORA_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
A_INIT_STD = 0.01     # A ~ 0.01 * N(0, 1), B = 0: the delta starts at 0


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: float = 32.0          # train.py:111 lora_alpha default 16/32
    targets: Sequence[str] = LORA_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def _dims(cfg: LlamaConfig) -> Dict[str, Tuple[int, int]]:
    d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    return {
        "wq": (d, cfg.num_heads * hd),
        "wk": (d, cfg.num_kv_heads * hd),
        "wv": (d, cfg.num_kv_heads * hd),
        "wo": (cfg.num_heads * hd, d),
        "gate": (d, i),
        "up": (d, i),
        "down": (i, d),
    }


class LoraLayer(nn.Module):
    """One decoder block's adapters: parameters `{t}_a` [din, r] and `{t}_b`
    [r, dout] for each target."""

    def __init__(self, cfg: LlamaConfig, lora_cfg: LoraConfig,
                 precision: Precision, *, device=None):
        super().__init__()
        self.targets = tuple(lora_cfg.targets)
        kw = dict(device=device, dtype=precision.param_dtype)
        dims = _dims(cfg)
        for t in self.targets:
            din, dout = dims[t]
            setattr(self, f"{t}_a", nn.Parameter(
                torch.empty(din, lora_cfg.rank, **kw), requires_grad=False))
            setattr(self, f"{t}_b", nn.Parameter(
                torch.empty(lora_cfg.rank, dout, **kw), requires_grad=False))

    def reset_parameters(self, generator):
        for t in self.targets:
            getattr(self, f"{t}_a").normal_(0.0, A_INIT_STD,
                                            generator=generator)
            getattr(self, f"{t}_b").zero_()

    def delta(self, x, name: str, scaling: float, tp=None):
        """(x · A) · B · scaling in x.dtype, or None where `name` has no
        adapters. The scaling is rounded to x.dtype first, as the JAX
        `lora_matmul` does. `tp`: the model axis' group of a decoder under
        tensor parallelism, over which x · A is all-reduced (a row-parallel
        product's: x and A are the rank's rows) or has its gradient
        all-reduced (a column-parallel product's: x is the whole input)."""
        if name not in self.targets:
            return None
        a = getattr(self, f"{name}_a").to(x.dtype)
        b = getattr(self, f"{name}_b").to(x.dtype)
        u = (comm.reduce_from if name in TP_ROW else comm.copy_to)(x @ a, tp)
        return (u @ b) * round_to_dtype(scaling, x.dtype)


class LoraAdapters(nn.Module):
    """`layers[i]` holds the adapters of decoder block i."""

    def __init__(self, cfg: LlamaConfig, lora_cfg: LoraConfig,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.lora_cfg = lora_cfg
        self.layers = nn.ModuleList(
            LoraLayer(cfg, lora_cfg, precision, device=device)
            for _ in range(cfg.num_layers))
        self.tp_group = None

    def _tp_leaves(self):
        """(parameter, dim) of every adapter the model axis cuts."""
        return [(getattr(layer, f"{t}_{'a' if t in TP_ROW else 'b'}"),
                 0 if t in TP_ROW else 1)
                for layer in self.layers for t in layer.targets]

    @torch.no_grad()
    def shard_tensor_parallel(self, group) -> None:
        """Keep this rank's slice of each cut adapter (in place: the
        Parameter objects stay); the decoder's blocks hand their model
        group to `LoraLayer.delta`."""
        for p, dim in self._tp_leaves():
            p.data = comm.local_slice(p.data, dim, group).clone()
        self.tp_group = group

    @torch.no_grad()
    def unshard_tensor_parallel(self) -> None:
        for p, dim in self._tp_leaves():
            p.data = comm.all_gather(p.data, dim, self.tp_group)

    @torch.no_grad()
    def reshard_tensor_parallel(self) -> None:
        for p, dim in self._tp_leaves():
            p.data = comm.local_slice(p.data, dim, self.tp_group).clone()


def param_partition_specs(cfg: LlamaConfig, lora_cfg: LoraConfig) -> dict:
    """Adapter name (under `LlavaParams.lora`) -> spec over the mesh's
    model axis: B of a column-parallel product by its output columns, A of
    a row-parallel one by its input rows, the rest whole."""
    specs = {}
    for i in range(cfg.num_layers):
        for t in lora_cfg.targets:
            row = t in TP_ROW
            specs[f"layers.{i}.{t}_a"] = P("model" if row else None, None)
            specs[f"layers.{i}.{t}_b"] = P(None, None if row else "model")
    return specs


def init_lora(generator: torch.Generator, cfg: LlamaConfig,
              lora_cfg: LoraConfig, precision: Precision = DEFAULT_PRECISION,
              device=None) -> LoraAdapters:
    """Standard LoRA init from `generator` (which must live on `device`'s
    type): A ~ 0.01 * N(0, 1), B = 0."""
    adapters = LoraAdapters(cfg, lora_cfg, precision, device=device)
    init_weights(adapters, generator)
    return adapters


@torch.no_grad()
def merge_lora(decoder: LlamaModel, lora: LoraAdapters,
               lora_cfg: Optional[LoraConfig] = None) -> LlamaModel:
    """Fold the adapters into the decoder's dense weights IN PLACE (serving):
    W += (A · B)ᵀ · scaling, summed in fp32 and rounded once to the weight's
    dtype. A quantised base cannot absorb a dense delta and raises."""
    lora_cfg = lora_cfg or lora.lora_cfg
    for block, layer in zip(decoder.layers, lora.layers):
        for t in lora_cfg.targets:
            dense = getattr(block, t)
            if not isinstance(dense, Dense):
                raise ValueError(
                    f"merge_lora: decoder weight {t!r} is quantised; merge "
                    f"the adapters into the dense base before quantising")
            delta = (getattr(layer, f"{t}_a").float()
                     @ getattr(layer, f"{t}_b").float()) * lora_cfg.scaling
            w = dense.weight
            w.copy_((w.float() + delta.T.to(w.device)).to(w.dtype))
    return decoder
