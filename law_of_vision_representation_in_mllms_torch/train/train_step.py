"""Stage-1 / stage-2 training steps on one device (counterpart of the JAX
package's `train/train_step.py`).

Reference training (`llava/train/train.py:899-1136`):
- stage 1 ("pretrain"): towers and decoder frozen, only the mm_projector
  trains (lr 1e-3, cosine, warmup 0.03, `scripts/v1_5/train/pretrain.sh`);
- stage 2 ("finetune"): projector and decoder train, towers stay frozen
  (lr 2e-5, `scripts/v1_5/train/finetune.sh`).

Freezing sets `requires_grad` (as the reference does, `train.py:1024-1031`)
where the JAX step wraps frozen leaves in `stop_gradient`: autograd still
carries activation gradients through the frozen decoder to the projector,
but computes no frozen weight gradient, and the optimizer sees only the
trainable parameters. The step mutates the parameters and the optimizer
state in place.

A decoder quantised by `ops.quant.quantize_decoder` (`train.quantize_base`,
stage 1 or QLoRA) holds buffers, not parameters, so it is frozen by
construction and its integer codes never enter the gradient norm (the JAX
step hands them zero gradients to the same effect).

Training variants (JAX `_freeze_labels`): with `LlavaParams.lora` set
(`TrainConfig.lora_rank`) the decoder base is frozen and the adapters and the
projector train (peft semantics, `train.py:969-985`); with
`LlavaParams.switch` set (`TrainConfig.switch_sigma`) only W trains
(`train_switch.py:895-898`) and the loss is `models.switch.switch_loss_fn`.

The sharded, ZeRO and offload variants are not ported (ROADMAP, queue 1: 10,
parallelism).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import torch

from ..models import llava
from ..models.switch import switch_loss_fn


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    stage: int = 1                    # 1: projector-only, 2: full finetune
    learning_rate: float = 1e-3      # stage-2 default: 2e-5
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03       # pretrain.sh:24
    total_steps: int = 1000
    max_grad_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    remat: bool = False              # per-block gradient checkpointing
    # "block" re-runs each block's forward in the backward; "dots" saves
    # the weight-matmul outputs (models/llama._remat)
    remat_policy: str = "block"
    use_flash: bool = False          # kernels 2, 5 and 6 in the decoder
    # sequential microbatches per step (HF gradient_accumulation_steps)
    grad_accum: int = 1
    # LoRA finetune (`finetune_lora.sh`: r 128, alpha 256): rank > 0 expects
    # `params.lora`; the decoder base freezes, adapters and projector train
    lora_rank: int = 0
    lora_alpha: float = 256.0
    # switch ablation: a nonzero sigma expects `params.switch`; only W trains
    switch_sigma: float = 0.0
    # FusedAdamW below; False = torch.optim.AdamW + clip_grad_norm_, the
    # counterpart of the JAX optax chain (the parity oracle)
    fused_optimizer: bool = True

    @property
    def lora_scaling(self) -> float:
        return self.lora_alpha / self.lora_rank if self.lora_rank else 1.0


def _freeze_labels(params: llava.LlavaParams, stage: int) -> Dict[str, str]:
    """Parameter name -> 'train' | 'freeze'. Towers never train (the
    reference freezes them in both stages); stage 1 freezes the decoder.
    With a switch present only W trains; with LoRA adapters present the
    decoder base freezes and the adapters (and the projector) train."""
    names = [name for name, _ in params.named_parameters()]
    if params.switch is not None:
        return {name: "train" if name.startswith("switch.") else "freeze"
                for name in names}
    freeze_decoder = stage == 1 or params.lora is not None
    labels = {}
    for name in names:
        frozen = name.startswith("towers.") or (
            freeze_decoder and name.startswith("decoder."))
        labels[name] = "freeze" if frozen else "train"
    return labels


def apply_freeze(params: llava.LlavaParams, stage: int
                 ) -> List[Tuple[str, torch.nn.Parameter]]:
    """Set `requires_grad` from the freeze labels; returns the trainable
    (name, parameter) pairs in module order."""
    labels = _freeze_labels(params, stage)
    trainable = []
    for name, p in params.named_parameters():
        p.requires_grad_(labels[name] == "train")
        if p.requires_grad:
            trainable.append((name, p))
    return trainable


def make_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """`optax.warmup_cosine_decay_schedule(0, lr, warmup, total, 0)`: linear
    warmup from 0 over max(1, int(warmup_ratio * total)) steps, then cosine
    decay to 0 at `total_steps`; read at the optimizer's count."""
    peak = cfg.learning_rate
    warmup = max(1, int(cfg.warmup_ratio * cfg.total_steps))
    decay = cfg.total_steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs total_steps "
                         f"({cfg.total_steps}) > warmup steps ({warmup})")

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        t = min(count - warmup, decay)
        return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))
    return schedule


class FusedAdamW:
    """AdamW with the global-norm clip, the nonfinite guard and the
    schedule, with the JAX `FusedAdamW` semantics (`train_step.py:114-130`):

    - clip: g *= max_grad_norm / max(gnorm, max_grad_norm);
    - bias correction at t = count + 1, eps 1e-8 after the sqrt, additive
      weight decay wd * p, lr = schedule(count) read at the pre-increment
      count;
    - nonfinite guard: the grads are select-zeroed before the moments update
      and the applied delta is multiplied by 0, so a skipped step leaves the
      parameters unchanged, decays the moments once and advances the count;
    - the moments are stored in the parameter dtype, the math runs in fp32.

    Only trainable parameters carry moments. On the card this is a handful
    of elementwise torch ops per parameter; at stage 1 (21 M parameters) it
    is a small share of the step.
    """

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.named_params = list(named_params)
        self.count = 0
        self.mu = [torch.zeros_like(p) for _, p in self.named_params]
        self.nu = [torch.zeros_like(p) for _, p in self.named_params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], finite: torch.Tensor,
             gnorm: torch.Tensor) -> None:
        cfg = self.cfg
        lr = self.schedule(self.count)
        t = self.count + 1
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        scale = cfg.max_grad_norm / torch.clamp_min(gnorm.float(),
                                                    cfg.max_grad_norm)
        fin = finite.float()
        for (_, p), g, m, v in zip(self.named_params, grads, self.mu,
                                   self.nu):
            # a true select, not scale * 0: NaN * 0 is NaN
            g32 = torch.where(finite, g.float() * scale,
                              torch.zeros((), device=g.device))
            m32 = cfg.b1 * m.float() + (1.0 - cfg.b1) * g32
            v32 = cfg.b2 * v.float() + (1.0 - cfg.b2) * (g32 * g32)
            u = (m32 / c1) / (torch.sqrt(v32 / c2) + 1e-8)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.float()
            p.copy_((p.float() + (-lr * fin) * u).to(p.dtype))
            m.copy_(m32)
            v.copy_(v32)
        self.count = t

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": {n: m for (n, _), m in zip(self.named_params, self.mu)},
                "nu": {n: v for (n, _), v in zip(self.named_params, self.nu)}}


class TorchAdamW:
    """`torch.optim.AdamW` + `clip_grad_norm_` + the same schedule: the
    counterpart of the JAX optax chain (`clip_by_global_norm` + `adamw`). A
    nonfinite step zeroes the grads, steps (the moments decay once and the
    count advances) and restores the parameters, as the optax chain's
    select-zeroed updates do."""

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.named_params = list(named_params)
        self.count = 0
        self.opt = torch.optim.AdamW(
            [p for _, p in self.named_params], lr=self.schedule(0),
            betas=(cfg.b1, cfg.b2), eps=1e-8, weight_decay=cfg.weight_decay)

    def step(self, grads: List[torch.Tensor], finite: torch.Tensor,
             gnorm: torch.Tensor) -> None:
        ok = bool(finite)
        params = [p for _, p in self.named_params]
        for p, g in zip(params, grads):
            p.grad = g.to(p.dtype) if ok else torch.zeros_like(p)
        torch.nn.utils.clip_grad_norm_(params, self.cfg.max_grad_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        kept = None if ok else [p.detach().clone() for p in params]
        self.opt.step()
        if kept is not None:
            with torch.no_grad():
                for p, k in zip(params, kept):
                    p.copy_(k)
        for p in params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.opt.state_dict()}


def make_optimizer(named_params: List[Tuple[str, torch.nn.Parameter]],
                   cfg: TrainConfig):
    if cfg.fused_optimizer:
        return FusedAdamW(named_params, cfg)
    return TorchAdamW(named_params, cfg)


def init_train_state(params: llava.LlavaParams, train_cfg: TrainConfig):
    """Freeze per stage and build the optimizer over the trainable
    parameters. Returns ({"params", "step"}, optimizer). `lora_rank` and
    `switch_sigma` must agree with what `params` carries: the labels follow
    the parameters, the loss follows the config."""
    if train_cfg.lora_rank and params.lora is None:
        raise ValueError(
            f"TrainConfig.lora_rank={train_cfg.lora_rank} but params.lora "
            f"is None: attach `models.lora.init_lora(...)` as params.lora")
    if bool(train_cfg.switch_sigma) != (params.switch is not None):
        raise ValueError(
            f"TrainConfig.switch_sigma={train_cfg.switch_sigma} but "
            f"params.switch is "
            f"{'set' if params.switch is not None else 'None'}: attach "
            f"`models.switch.init_switch(...)` as params.switch")
    opt = make_optimizer(apply_freeze(params, train_cfg.stage), train_cfg)
    return {"params": params, "step": 0}, opt


def _split(batch: Dict, a: int) -> List[Dict]:
    """The batch's leading axis cut into `a` consecutive microbatches (the
    JAX reshape [B, ...] -> [a, B / a, ...])."""
    def part(x, i):
        n = x.shape[0] // a
        return x[i * n:(i + 1) * n]
    return [{k: ([part(x, i) for x in v] if isinstance(v, list)
                 else part(v, i)) for k, v in batch.items()}
            for i in range(a)]


def make_train_step(model_cfg: llava.LlavaConfig, train_cfg: TrainConfig,
                    opt, *, cp=None, pp=None):
    """Returns step(state, batch) -> (state, metrics). The metrics are
    device scalars `loss`, `grad_norm`, `skipped_nonfinite` and the int
    `step`. The batch is the `collate_batch` dict as tensors on the model's
    device (ids and labels as int64)."""
    if cp is not None or pp is not None:
        raise NotImplementedError(
            "context and pipeline parallelism are not ported to the PyTorch "
            "package yet (ROADMAP, queue 1: 10, parallelism)")
    trainable = [p for _, p in opt.named_params]

    def loss_and_grads(params, batch):
        kw = dict(remat=train_cfg.remat, remat_policy=train_cfg.remat_policy,
                  use_flash=train_cfg.use_flash)
        if train_cfg.switch_sigma:
            loss = switch_loss_fn(params, model_cfg, batch,
                                  train_cfg.switch_sigma, **kw)
        else:
            loss = llava.loss_fn(params, model_cfg, batch,
                                 lora_scaling=train_cfg.lora_scaling, **kw)
        return loss.detach(), torch.autograd.grad(loss, trainable)

    def step(state, batch):
        params = state["params"]
        a = train_cfg.grad_accum
        if a <= 1:
            loss, grads = loss_and_grads(params, batch)
        else:
            if batch["input_ids"].shape[0] % a:
                raise ValueError("batch size must divide by grad_accum")
            loss, grads = None, None
            for mb in _split(batch, a):
                l, g = loss_and_grads(params, mb)
                loss = l if loss is None else loss + l
                grads = list(g) if grads is None else [
                    x + y for x, y in zip(grads, g)]
            loss = loss / a
            grads = [g / a for g in grads]
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        # production guard (absent in the reference): a nonfinite loss or
        # gradient applies no update instead of poisoning the parameters
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        opt.step(grads, finite, gnorm)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm,
                       "skipped_nonfinite": 1.0 - finite.float(),
                       "step": state["step"]}

    return step
