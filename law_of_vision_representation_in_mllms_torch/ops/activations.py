"""Activation functions of the tower zoo (HF semantics).

- ``quick_gelu`` — OpenAI CLIP ViTs (x * sigmoid(1.702 x))
- ``gelu``       — OpenCLIP / DINOv2 (erf-exact)
- ``gelu_tanh``  — SigLIP (`gelu_pytorch_tanh`)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x):
    return F.gelu(x, approximate="none")


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


ACT2FN = {
    "quick_gelu": quick_gelu,
    "gelu": gelu_exact,
    "gelu_tanh": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
}
