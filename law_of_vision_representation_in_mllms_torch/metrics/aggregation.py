"""Aggregation / post-processing networks for supervised correspondence
(counterpart of the JAX package's `metrics/aggregation.py`).

Reference: `C_score/model_utils/projection_network.py` —
- `DummyAggregation` (identity scale; the zero-shot C-score path),
- `AggregationNetwork`: one GN-bottleneck ResNet block per feature layer
  (ODISE-style; kernel sizes [1,3,1]) whose outputs are blended with
  softmax mixing weights; CLIP-style logit scales as trainable scalars,
  which the forward pass does not use (the losses do);

and `C_score/model_utils/corr_map_model.py Correlation2Displacement`: the
correlation map -> soft-argmax *displacement* (the eval-time flow minus the
identity grid).

The modules take and give NHWC tensors, the JAX layout, and convolve in NCHW
inside. As in Flax: "SAME" padding (k // 2 for the odd kernels here), no
conv bias, GroupNorm with epsilon 1e-6 over min(num_groups, channels)
groups. `io.from_jax.aggregation_state_dict` carries Flax weights over.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
from torch import nn

from .c_score import soft_argmax_flow

GN_EPS = 1e-6          # Flax nn.GroupNorm's default (torch's is 1e-5)


class DummyAggregation(nn.Module):
    """Identity with a scalar parameter (`projection_network.py:7-13`)."""

    def __init__(self):
        super().__init__()
        self.dummy = nn.Parameter(torch.ones(()))

    def forward(self, x):
        return x * self.dummy


class ConvGN(nn.Module):
    """A k x k "SAME" conv without bias, then GroupNorm (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int, k: int,
                 num_groups: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, k, padding=k // 2,
                              bias=False)
        self.gn = nn.GroupNorm(min(num_groups, out_channels), out_channels,
                               eps=GN_EPS)

    def forward(self, x):
        return self.gn(self.conv(x))


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 convs with GroupNorm + ReLU, additive shortcut
    (detectron2-style, `model_utils/resnet.py BottleneckBlock`).
    [B, H, W, in_channels] -> [B, H, W, out_channels]."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, num_groups: int = 32,
                 kernel_sizes: Tuple[int, int, int] = (1, 3, 1)):
        super().__init__()
        k1, k2, k3 = kernel_sizes
        self.shortcut = (ConvGN(in_channels, out_channels, 1, num_groups)
                         if in_channels != out_channels else None)
        self.conv1 = ConvGN(in_channels, bottleneck_channels, k1, num_groups)
        self.conv2 = ConvGN(bottleneck_channels, bottleneck_channels, k2,
                            num_groups)
        self.conv3 = ConvGN(bottleneck_channels, out_channels, k3,
                            num_groups)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        sc = x if self.shortcut is None else self.shortcut(x)
        h = torch.relu(self.conv1(x))
        h = torch.relu(self.conv2(h))
        h = self.conv3(h)
        return torch.relu(h + sc).permute(0, 2, 3, 1)


class AggregationNetwork(nn.Module):
    """Blend per-layer bottlenecked features with softmax mixing weights.

    forward input: [B, H, W, C_cat] where C_cat concatenates the per-layer
    channels in `feature_dims` order; output [B, H, W, projection_dim].
    """

    def __init__(self, feature_dims: Sequence[int] = (640, 1280, 1280, 768),
                 projection_dim: int = 384, num_norm_groups: int = 32,
                 contrastive_temp: float = 10.0):
        super().__init__()
        self.feature_dims = tuple(feature_dims)
        self.mixing_weights = nn.Parameter(torch.ones(len(feature_dims)))
        # trainable CLIP logit scales (used by the losses)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        self.self_logit_scale = nn.Parameter(
            torch.tensor(math.log(contrastive_temp)))
        self.bottlenecks = nn.ModuleList(
            BottleneckBlock(dim, projection_dim // 4, projection_dim,
                            num_norm_groups) for dim in self.feature_dims)

    def forward(self, x):
        w = torch.softmax(self.mixing_weights, dim=0)
        out = None
        start = 0
        for i, (dim, block) in enumerate(zip(self.feature_dims,
                                             self.bottlenecks)):
            y = block(x[..., start:start + dim]) * w[i]
            start += dim
            out = y if out is None else out + y
        return out


def soft_argmax_displacement(sim, num_patches: int, *, window: int = 0,
                             beta: float = 0.02):
    """Correlation2Displacement forward: the soft-argmax mapping MINUS the
    identity grid (`corr_map_model.py:58-73` subtracts the meshgrid, unlike
    the eval-time `get_flow`). sim: [..., S, T] -> [..., S, 2]."""
    n = num_patches
    mapping = soft_argmax_flow(sim, n, window=window, beta=beta)
    s_idx = torch.arange(n * n, device=sim.device)
    grid = torch.stack([(s_idx % n).float(), (s_idx // n).float()], dim=-1)
    return mapping - grid
