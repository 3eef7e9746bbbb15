"""mm_projector: linear | mlpNx_gelu | identity | perceiverNx (counterpart of
the JAX package's `models/projector.py`; the reference's
`build_vision_projector`).

GELU (erf-exact) sits between the mlp layers; `linear` is one layer with no
activation; `identity` passes features through; `perceiverNx` is the depth-N
`models.perceiver.PerceiverResampler` and its Linear. `build_projector`
builds any of them; `port_perceiver` reads the reference's perceiver
`mm_projector.bin` state dict.
"""

from __future__ import annotations

import re

from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.activations import gelu_exact
from .layers import Dense
from .perceiver import PerceiverResampler


def parse_projector_type(name: str):
    if name in ("linear", "identity"):
        return name, None
    m = re.match(r"^mlp(\d+)x_gelu$", name)
    if m:
        return "mlp", int(m.group(1))
    m = re.match(r"^perceiver(\d+)x$", name)
    if m:
        return "perceiver", int(m.group(1))
    raise ValueError(f"Unknown projector type: {name}")


def build_projector(proj_type: str, mm_hidden_size: int, hidden_size: int,
                    precision: Precision = DEFAULT_PRECISION, *,
                    device=None) -> nn.Module:
    """The projector of `proj_type`: a `PerceiverResampler` for
    `perceiverNx` (the reference's defaults: 64 latents, 8 heads),
    else a `Projector`."""
    kind, depth = parse_projector_type(proj_type)
    if kind == "perceiver":
        return PerceiverResampler(depth, mm_hidden_size, hidden_size,
                                  precision, device=device)
    return Projector(proj_type, mm_hidden_size, hidden_size, precision,
                     device=device)


class Projector(nn.Module):
    """feats [B, P, mm_hidden] -> [B, P, hidden] (linear, mlpNx_gelu,
    identity; `build_projector` builds a perceiver)."""

    def __init__(self, proj_type: str, mm_hidden_size: int, hidden_size: int,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        kind, depth = parse_projector_type(proj_type)
        if kind == "perceiver":
            raise ValueError(f"{proj_type} is a PerceiverResampler: build it "
                             f"with build_projector")
        self.precision = precision
        dims = []
        if kind == "linear":
            dims = [(mm_hidden_size, hidden_size)]
        elif kind == "mlp":
            dims = [(mm_hidden_size, hidden_size)]
            dims += [(hidden_size, hidden_size)] * (depth - 1)
        self.layers = nn.ModuleList(
            _XavierDense(i, o, precision, device=device) for i, o in dims)

    def forward(self, feats):
        x = feats.to(self.precision.compute_dtype)
        for i, layer in enumerate(self.layers):
            if i > 0:
                x = gelu_exact(x)
            x = layer(x)
        return x


class _XavierDense(Dense):
    """The JAX projector's init: uniform(+-sqrt(6 / (in + out))), zero bias."""

    def reset_parameters(self, generator):
        dout, din = self.weight.shape
        bound = (6.0 / (din + dout)) ** 0.5
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.zero_()


def port_perceiver(state_dict, depth: int, prefix: str = ""):
    """The reference's `nn.Sequential(PerceiverResampler, Linear)` weights
    (`build_vision_projector`; module 0 the resampler: `latents`, `layers.{i}.0`
    the attention, `layers.{i}.1` the FeedForward = LN, Linear, GELU,
    Linear, `norm`; module 1 the output Linear) -> a `PerceiverResampler`
    state dict (JAX `models/projector.py` `_port_perceiver`), fp32."""
    def t(key):
        return state_dict[prefix + key].detach().float().cpu().clone()

    sd = {"latents": t("0.latents")}
    for i in range(depth):
        src, dst = f"0.layers.{i}.", f"layers.{i}."
        for name, key in (("norm_media", "0.norm_media"),
                          ("norm_latents", "0.norm_latents"),
                          ("ff_norm", "1.0")):
            sd[f"{dst}{name}.weight"] = t(f"{src}{key}.weight")
            sd[f"{dst}{name}.bias"] = t(f"{src}{key}.bias")
        for name, key in (("to_q", "0.to_q"), ("to_kv", "0.to_kv"),
                          ("to_out", "0.to_out"), ("ff_in", "1.1"),
                          ("ff_out", "1.3")):
            sd[f"{dst}{name}.weight"] = t(f"{src}{key}.weight")
    sd["final_norm.weight"] = t("0.norm.weight")
    sd["final_norm.bias"] = t("0.norm.bias")
    sd["proj.weight"] = t("1.weight")
    sd["proj.bias"] = t("1.bias")
    return sd
