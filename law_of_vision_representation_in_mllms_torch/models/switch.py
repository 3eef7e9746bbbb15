"""The "Switch" representation-steering variant (counterpart of the JAX
package's `models/switch.py`).

Reference: `llava/model/language_model/llava_llama_switch.py:19-135` and
`llava/train/train_switch.py:895-898`: one trainable square matrix W applied
to the decoder's final hidden state (after its final norm) as

    h' = h + sigma * (h · W)        (sigma: a fixed scale, default 1.0)

with everything else frozen. The matrix lives in `LlavaParams.switch`;
`train.train_step._freeze_labels` trains it alone. Since W sits behind the
decoder, a switch step runs no decoder backward at all: autograd stops at
the frozen hidden state.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from . import llama as L
from .layers import init_weights, round_to_dtype
from .splice import splice_embeds, splice_plan

INIT_STD = 0.02


class Switch(nn.Module):
    """`w` [D, D], applied as h · w (the JAX leaf `switch.w`)."""

    def __init__(self, hidden_size: int,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.w = nn.Parameter(
            torch.empty(hidden_size, hidden_size, device=device,
                        dtype=precision.param_dtype), requires_grad=False)

    def reset_parameters(self, generator):
        self.w.normal_(0.0, INIT_STD, generator=generator)


def init_switch(generator: torch.Generator, hidden_size: int,
                precision: Precision = DEFAULT_PRECISION,
                device=None) -> Switch:
    """W ~ 0.02 * N(0, 1) from `generator` (on `device`'s type)."""
    switch = Switch(hidden_size, precision, device=device)
    init_weights(switch, generator)
    return switch


def apply_switch(switch: Switch, hidden, sigma: float = 1.0):
    """hidden [B, S, D] -> steered hidden, in hidden.dtype (sigma is rounded
    to that dtype first, as the JAX function does)."""
    w = switch.w.to(hidden.dtype)
    return hidden + round_to_dtype(sigma, hidden.dtype) * (hidden @ w)


def switch_loss_fn(params, model_cfg, batch: Dict[str, torch.Tensor],
                   sigma: float = 1.0, *, use_flash: bool = False,
                   remat: bool = False, remat_policy: Optional[str] = None):
    """LLaVA loss with the switch applied before the LM head. `params` is a
    `LlavaParams` whose `switch` is set; every other weight is frozen by the
    freeze labels. `use_flash` takes the decoder through kernel 2 (the JAX
    function runs its plain attention; the result is the same function)."""
    from .llava import encode_images
    dec = params.decoder
    plan = splice_plan(batch["input_ids"], batch["labels"],
                       batch["text_mask"], model_cfg.num_patches)
    img = encode_images(params, model_cfg, batch["pixel_values"])
    txt = L.embed_tokens(dec, batch["input_ids"])
    embeds = splice_embeds(plan, txt, img)
    h, _ = dec(embeds, plan.positions, attn_mask=plan.attn_mask,
               use_flash=use_flash, remat=remat, remat_policy=remat_policy)
    h = apply_switch(params.switch, h, sigma)
    return L.causal_lm_loss(L.logits_fn(dec, h), plan.labels)
