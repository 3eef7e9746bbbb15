"""Precision policy (counterpart of the JAX package's `core/precision.py`).

`param_dtype` is what weights are stored in, `compute_dtype` what activations
and matmuls run in, `accum_dtype` what the plain attention path takes its
logits and softmax in. The CUDA kernels always keep fp32 softmax statistics.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Precision:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    accum_dtype: torch.dtype = torch.float32


DEFAULT_PRECISION = Precision()
FP32_PRECISION = Precision(compute_dtype=torch.float32)
# Frozen-tower inference: bf16 weights, activations and (plain-path) softmax.
BF16_TOWER_PRECISION = Precision(param_dtype=torch.bfloat16,
                                 compute_dtype=torch.bfloat16,
                                 accum_dtype=torch.bfloat16)
# Serving on the card: bf16 weights and activations, fp32 accumulation.
BF16_PRECISION = Precision(param_dtype=torch.bfloat16,
                           compute_dtype=torch.bfloat16)
