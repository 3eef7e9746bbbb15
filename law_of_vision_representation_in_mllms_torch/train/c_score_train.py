"""Supervised correspondence training (counterpart of the JAX package's
`train/c_score_train.py`; `C_score/pck_train.py:247-313`).

Trains the `metrics.aggregation.AggregationNetwork` (CLIP-style symmetric
cross-entropy over matched keypoint descriptors, plus the dense
soft-argmax EPE objective) with AdamW; the caller keeps the best PCK@0.10
checkpoint. No attention runs here: the network is convolutions and
GroupNorms (cuDNN on the card).

The optimizer is the JAX package's `optax.adamw(warmup_cosine_decay_
schedule(0, lr, max(1, total // 100), total), weight_decay=wd)` written as
`torch.optim.AdamW` (betas 0.9 / 0.999, eps 1e-8 outside the square root,
decay lr * wd * p) with the schedule set before each step:
- optax evaluates the schedule at the count of earlier updates, so the
  first step's learning rate is 0 (the weights stay, the moments move);
- optax decays every leaf, `self_logit_scale` too, whose gradient is zero
  (no loss reads it), so a parameter without a gradient gets a zero one
  (torch's AdamW skips a parameter whose `grad` is None).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..metrics.aggregation import AggregationNetwork
from ..metrics.c_losses import clip_loss, dense_epe_loss
from ..metrics.c_score import normalize_feats

# Flax's lecun_normal: a normal of variance 1 / fan_in truncated at two
# standard deviations, its std widened by this to keep the variance
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class CTrainConfig:
    learning_rate: float = 5e-4
    weight_decay: float = 1e-3
    total_steps: int = 10000
    num_patches: int = 60
    dense_obj: bool = True
    epe_weight: float = 1.0
    window: int = 0


def lr_at(cfg: CTrainConfig, count: int) -> float:
    """optax's `warmup_cosine_decay_schedule(0, lr, max(1, total // 100),
    total)` at `count` earlier updates: linear from 0 over the warmup, then
    a cosine to 0 over the rest."""
    warmup = max(1, cfg.total_steps // 100)
    if count < warmup:
        return cfg.learning_rate * count / warmup
    decay = cfg.total_steps - warmup
    if decay <= 0:
        raise ValueError("the cosine decay needs total_steps > warmup "
                         f"({cfg.total_steps} <= {warmup})")
    t = min(count - warmup, decay)
    return cfg.learning_rate * 0.5 * (1 + math.cos(math.pi * t / decay))


def init_aggregation(net: AggregationNetwork, generator: torch.Generator
                     ) -> None:
    """Flax's initialisation of the network, drawn from `generator`: conv
    kernels lecun-normal, GroupNorms scale 1 and bias 0, mixing weights 1,
    the logit scales log(1 / 0.07) and log(contrastive_temp) (kept as
    built)."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                std = fan_in ** -0.5 / _TRUNC_STD
                torch.nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std,
                                            2 * std, generator=generator)
            elif isinstance(m, torch.nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        net.mixing_weights.fill_(1.0)


def init_c_train(net: AggregationNetwork, cfg: CTrainConfig,
                 generator: torch.Generator) -> torch.optim.AdamW:
    """Initialise `net` in place from `generator` and return its optimizer
    (the learning rate is set by the step, `lr_at`)."""
    init_aggregation(net, generator)
    return torch.optim.AdamW(net.parameters(), lr=0.0, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=cfg.weight_decay)


def c_train_loss(net: AggregationNetwork, cfg: CTrainConfig, batch):
    """The mean over the batch's pairs of the CLIP loss of the keypoints
    (invalid ones become zero vectors: near-uniform logits), plus the
    dense EPE term. batch: feat1 / feat2 [B, H, W, C_cat] stacked raw
    features; kp_idx1 / kp_idx2 [B, K] patch indices; kp_valid [B, K];
    gt_flow [B, K, 2] in patch units."""
    f1, f2 = net(batch["feat1"]), net(batch["feat2"])
    b, h, w, c = f1.shape
    d1 = normalize_feats(f1.reshape(b, h * w, c))
    d2 = normalize_feats(f2.reshape(b, h * w, c))
    losses = []
    for i in range(b):
        idx1, idx2 = batch["kp_idx1"][i].long(), batch["kp_idx2"][i].long()
        valid = batch["kp_valid"][i][:, None]
        loss = clip_loss(d1[i][idx1] * valid, d2[i][idx2] * valid,
                         net.logit_scale)
        if cfg.dense_obj:
            loss = loss + cfg.epe_weight * dense_epe_loss(
                d1[i], d2[i], idx1, batch["gt_flow"][i], cfg.num_patches,
                window=cfg.window)
        losses.append(loss)
    return torch.stack(losses).mean()


def make_c_train_step(net: AggregationNetwork, cfg: CTrainConfig,
                      opt: torch.optim.AdamW):
    """step(batch) -> {"loss": 0-d tensor}: one AdamW update at `lr_at(cfg,
    updates so far)`; `step.count` counts the updates."""

    def step(batch):
        for group in opt.param_groups:
            group["lr"] = lr_at(cfg, step.count)
        opt.zero_grad(set_to_none=True)
        loss = c_train_loss(net, cfg, batch)
        loss.backward()
        for p in net.parameters():
            if p.grad is None:              # optax decays it all the same
                p.grad = torch.zeros_like(p)
        opt.step()
        step.count += 1
        return {"loss": loss.detach()}

    step.count = 0
    return step
