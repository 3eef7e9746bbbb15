"""Building blocks shared by the port's models.

`Dense` and `LayerNorm32` play the roles of Flax's `nn.Dense(dtype=compute,
param_dtype=param)` and the JAX package's fp32-statistics `_LayerNorm`:
weights are stored in `precision.param_dtype`, inputs and weights are cast
to `precision.compute_dtype` for the op. Storage is allocated uninitialised
on the target device; `init_weights(module, generator)` fills every module
that defines `reset_parameters(generator)`, sampling on that device. Each
`reset_parameters` fills only the module's own parameters, not its
children's, so every weight is sampled once.

`QuantDense` stands where a `Dense` stood once `ops.quant.quantize_decoder`
has run: it holds the integer codes and the scales as buffers and no dense
weight.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ..core.precision import Precision
from ..ops import quant


class Dense(nn.Module):
    """y = x @ W.T + b with W [out, in] (a Flax kernel transposed)."""

    def __init__(self, din: int, dout: int, precision: Precision, *,
                 bias: bool = True, init_std: float | None = None,
                 device=None):
        super().__init__()
        self.precision = precision
        self.init_std = init_std
        kw = dict(device=device, dtype=precision.param_dtype)
        self.weight = nn.Parameter(torch.empty(dout, din, **kw),
                                   requires_grad=False)
        self.bias = (nn.Parameter(torch.empty(dout, **kw),
                                  requires_grad=False) if bias else None)

    def forward(self, x):
        cd = self.precision.compute_dtype
        b = None if self.bias is None else self.bias.to(cd)
        return F.linear(x.to(cd), self.weight.to(cd), b)

    def reset_parameters(self, generator):
        # `init_std`, else lecun-normal scale (Flax's Dense default); zero bias
        std = self.init_std or self.weight.shape[1] ** -0.5
        self.weight.normal_(0.0, std, generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class QuantDense(nn.Module):
    """y = x @ dequant(leaf).T for a weight-only quantised leaf of
    `ops.quant` (`{"q8" | "q4", "scale"}`, no bias). The codes and scales
    are buffers, so `state_dict`, `.to()` and `load_state_dict` carry them;
    int4 on a CUDA tensor runs kernel 10."""

    def __init__(self, leaf, precision: Precision):
        super().__init__()
        self.precision = precision
        self.kind = "q4" if "q4" in leaf else "q8"
        self.register_buffer(self.kind, leaf[self.kind])
        self.register_buffer("scale", leaf["scale"])

    def leaf(self):
        return {self.kind: getattr(self, self.kind), "scale": self.scale}

    def forward(self, x):
        return quant.quant_matmul(x.to(self.precision.compute_dtype),
                                  self.leaf())


class LayerNorm32(nn.Module):
    """LayerNorm with fp32 statistics, output in the compute dtype."""

    def __init__(self, dim: int, eps: float, precision: Precision, *,
                 device=None):
        super().__init__()
        self.eps = eps
        self.precision = precision
        kw = dict(device=device, dtype=precision.param_dtype)
        self.weight = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty(dim, **kw), requires_grad=False)

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(self.precision.compute_dtype)

    def reset_parameters(self, generator):
        self.weight.fill_(1.0)
        self.bias.zero_()


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random init of every sub-module, in module order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)


@functools.lru_cache(maxsize=None)
def round_to_dtype(value: float, dtype: torch.dtype) -> float:
    """`value` rounded to `dtype`, as a Python float: a scalar factor that
    multiplies a `dtype` tensor the way the JAX package's `jnp.asarray(value,
    x.dtype)` does. Cached, so a forward pays for the rounding once."""
    return torch.tensor(value, dtype=dtype).item()
