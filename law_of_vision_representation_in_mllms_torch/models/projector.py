"""mm_projector: linear | mlpNx_gelu | identity (counterpart of the JAX
package's `models/projector.py`; the reference's `build_vision_projector`).

GELU (erf-exact) sits between the mlp layers; `linear` is one layer with no
activation; `identity` passes features through. The perceiver resampler is
not ported yet.
"""

from __future__ import annotations

import re

from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.activations import gelu_exact
from .layers import Dense


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


class Projector(nn.Module):
    """feats [B, P, mm_hidden] -> [B, P, hidden]."""

    def __init__(self, proj_type: str, mm_hidden_size: int, hidden_size: int,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        kind, depth = parse_projector_type(proj_type)
        if kind == "perceiver":
            raise NotImplementedError(
                f"projector {proj_type} is not ported to the PyTorch package "
                "yet (ROADMAP, queue 1: 5, diffusion towers)")
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
