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

Parallel training (the JAX `init_sharded_train_state` and `make_train_step(
mesh=...)`): `init_sharded_train_state` shards a whole model in place over a
`parallel.Mesh` (tensor parallelism of the decoder over the model axis,
ZeRO-2 / ZeRO-3 over the data axis, `parallel/fsdp.py`) and offloads the
moments (`offload_opt_state`) and the parameters (`offload_params`) to
pinned host memory; the step then takes this data rank's rows, divides its
loss by the global batch's valid targets, reduces each gradient as its leaf
is held (all-reduce, reduce-scatter, or already reduce-scattered under
ZeRO-3) and counts each element once in the global norm, so every rank
agrees on the loss, the norm and the nonfinite guard.

Context parallelism (`make_train_step(cp=...)`, the seq axis): every leaf
is whole on each seq rank, so its gradient is summed over the seq group
before the data axis' reduction, and the loss over the seq ranks too.
Pipeline parallelism (`init_sharded_train_state(pipeline=True)`,
`make_train_step(pp=...)`, the stage axis): each stage keeps only its
decoder layers (`LlamaModel.hold_layers`), whose gradients stay on their
stage and whose squares the global norm sums over the stage group; the
gradients of the leaves every stage holds whole (tower, projector,
embedding, final norm, `lm_head`) are summed over the stage group, as is
the loss (the last stage's). ZeRO <= 2 and no LoRA with it, as in the JAX
package.

The variants on a mesh: LoRA and QLoRA adapters are cut over the model axis
beside the decoder (`models.lora.param_partition_specs`), and a quantised
decoder's codes and scales with its products (`layers.QuantDense`). The
switch loss runs the whole trunk, as the JAX one does: under `seq` every seq
rank computes the whole sequence's loss, so nothing is summed over the seq
axis; under a pipeline the stages run the trunk forward only and the last
one differentiates the switch and the head (`models.switch.
switch_loss_fn`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..models import llama, llava, lora
from ..models.switch import switch_loss_fn
from ..parallel import comm, fsdp, make_mesh
from ..parallel.pipeline import stage_layers


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

    `moment_shapes`: the moments' shapes where they are a slice of each
    leaf (ZeRO-2 / ZeRO-3); `step(..., params=...)` then names the slices to
    update. `offload`: the moments live in pinned host memory (one block,
    `fsdp.HostBlock`); on the card the update streams them leaf by leaf, the
    next leaf's copied in on a side stream while one updates and each copied
    back once updated (the two directions on two streams), so the card
    holds about two leaves' moments, never the whole tree. The math is the
    same either way.
    """

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 cfg: TrainConfig, *, moment_shapes=None,
                 offload: bool = False):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.named_params = list(named_params)
        self.count = 0
        self.offload = offload
        self.host = None
        # a list to collect ("h2d" | "d2h", start, end) CUDA events of the
        # streamed update's copies (`copy_ms`); None records nothing
        self.copy_events = None
        shapes = [tuple(p.shape) for _, p in self.named_params] \
            if moment_shapes is None else [tuple(s) for s in moment_shapes]
        kinds = [(s, p.dtype) for s, (_, p) in zip(shapes, self.named_params)]
        if offload:
            device = (self.named_params[0][1].device if self.named_params
                      else torch.device("cpu"))
            self.host = fsdp.HostBlock(kinds + kinds, device)
            n = len(kinds)
            self.mu, self.nu = self.host.tensors[:n], self.host.tensors[n:]
        else:
            self.mu = [torch.zeros(s, dtype=p.dtype, device=p.device)
                       for s, (_, p) in zip(shapes, self.named_params)]
            self.nu = [torch.zeros_like(m) for m in self.mu]

    def _update(self, p, g, m, v, finite, fin, scale, lr, c1, c2) -> None:
        cfg = self.cfg
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

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], finite: torch.Tensor,
             gnorm: torch.Tensor, params=None) -> None:
        cfg = self.cfg
        lr = self.schedule(self.count)
        t = self.count + 1
        c1 = 1.0 - cfg.b1 ** t
        c2 = 1.0 - cfg.b2 ** t
        scale = cfg.max_grad_norm / torch.clamp_min(gnorm.float(),
                                                    cfg.max_grad_norm)
        fin = finite.float()
        if params is None:
            params = [p for _, p in self.named_params]
        args = (finite, fin, scale, lr, c1, c2)
        if self.offload and params and params[0].device.type == "cuda":
            self._streamed(params, grads, args)
        else:
            for p, g, m, v in zip(params, grads, self.mu, self.nu):
                self._update(p, g, m, v, *args)
        self.count = t

    def _streamed(self, params, grads, args) -> None:
        """The update with host moments: leaf i + 1's moments are copied in
        on one side stream while leaf i updates, and leaf i's copied back on
        another behind its update (the two directions overlap)."""
        dev = params[0].device
        main = torch.cuda.current_stream(dev)
        h2d, d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        h2d.wait_stream(main)
        d2h.wait_stream(main)
        timing = self.copy_events is not None

        def mark(stream):
            e = torch.cuda.Event(enable_timing=timing)
            e.record(stream)
            return e

        def fetch(i):
            with torch.cuda.stream(h2d):
                start = mark(h2d) if timing else None
                m = self.mu[i].to(dev, non_blocking=True)
                v = self.nu[i].to(dev, non_blocking=True)
                landed = mark(h2d)
            if timing:
                self.copy_events.append(("h2d", start, landed))
            return m, v, landed

        nxt = fetch(0)
        for i, (p, g) in enumerate(zip(params, grads)):
            m, v, landed = nxt
            if i + 1 < len(params):
                nxt = fetch(i + 1)
            main.wait_event(landed)
            for t in (m, v):
                t.record_stream(main)
                t.record_stream(d2h)
            self._update(p, g, m, v, *args)
            done = mark(main)
            with torch.cuda.stream(d2h):
                d2h.wait_event(done)
                start = mark(d2h) if timing else None
                self.mu[i].copy_(m, non_blocking=True)
                self.nu[i].copy_(v, non_blocking=True)
                if timing:
                    self.copy_events.append(("d2h", start, mark(d2h)))
        main.wait_stream(h2d)
        main.wait_stream(d2h)

    def copy_ms(self) -> Dict[str, float]:
        """Milliseconds the streamed updates since the last call spent in
        host-to-device and device-to-host copies of the moments (summed
        over leaves; they overlap the updates)."""
        out = {"h2d": 0.0, "d2h": 0.0}
        if self.copy_events:
            torch.cuda.synchronize()
            for kind, a, b in self.copy_events:
                out[kind] += a.elapsed_time(b)
            self.copy_events.clear()
        return out

    def moment_bytes(self) -> int:
        return sum(m.numel() * m.element_size() for m in self.mu + self.nu)

    def moments(self) -> Tuple[List, List]:
        """(first moments, second moments), one a trainable leaf."""
        return self.mu, self.nu

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": {n: m for (n, _), m in zip(self.named_params, self.mu)},
                "nu": {n: v for (n, _), v in zip(self.named_params, self.nu)}}


class TorchAdamW:
    """`torch.optim.AdamW` + the global-norm clip + the same schedule: the
    counterpart of the JAX optax chain (`clip_by_global_norm` + `adamw`).

    It steps copies of what it updates (`moment_like`: a rank's slices under
    ZeRO, by default the parameters), because `torch.optim` keys its state
    by Parameter and a slice is a new view every step; it clips by the
    global norm it is given (`clip_grad_norm_`'s formula) and keeps its
    moments on the host between steps when `offload`. A nonfinite step
    zeroes the grads and steps (the moments decay once and the count
    advances) but copies nothing back, as the optax chain's select-zeroed
    updates leave the parameters."""

    def __init__(self, named_params: List[Tuple[str, torch.nn.Parameter]],
                 cfg: TrainConfig, *, moment_like=None,
                 offload: bool = False):
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.named_params = list(named_params)
        self.count = 0
        self.offload = offload
        if moment_like is None:
            moment_like = [p for _, p in self.named_params]
        self.params = [nn.Parameter(t.detach().clone()) for t in moment_like]
        self.opt = torch.optim.AdamW(
            self.params, lr=self.schedule(0),
            betas=(cfg.b1, cfg.b2), eps=1e-8, weight_decay=cfg.weight_decay)

    def step(self, grads: List[torch.Tensor], finite: torch.Tensor,
             gnorm: torch.Tensor, params=None) -> None:
        ok = bool(finite)
        if params is None:
            params = [p for _, p in self.named_params]
        coef = min(1.0, self.cfg.max_grad_norm / (float(gnorm) + 1e-6))
        with torch.no_grad():
            for c, t, g in zip(self.params, params, grads):
                c.copy_(t)
                c.grad = (g * coef).to(c.dtype) if ok else torch.zeros_like(c)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        offload = self.offload and self.params
        if offload:
            self._move_state(self.params[0].device)
        self.opt.step()
        if offload:
            self._move_state(torch.device("cpu"))
        with torch.no_grad():
            for c, t in zip(self.params, params):
                if ok:
                    t.copy_(c)
                c.grad = None
        self.count += 1

    def _move_state(self, device) -> None:
        for st in self.opt.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                t = st[k]
                if device.type == "cpu" and t.is_cuda:
                    st[k] = torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True).copy_(t)
                else:
                    st[k] = t.to(device, non_blocking=True)

    def moments(self) -> Tuple[List, List]:
        """(exp_avg, exp_avg_sq), one a trainable leaf (zeros before the
        first step)."""
        state = [self.opt.state.get(p, {}) for p in self.params]
        return tuple([st.get(k, torch.zeros_like(p)) for st, p in
                      zip(state, self.params)]
                     for k in ("exp_avg", "exp_avg_sq"))

    def state_dict(self) -> Dict:
        return {"count": self.count, "adamw": self.opt.state_dict()}


def make_optimizer(named_params: List[Tuple[str, torch.nn.Parameter]],
                   cfg: TrainConfig, *, moment_like=None,
                   offload: bool = False):
    """FusedAdamW (or the torch.optim oracle) over the trainable
    parameters; `moment_like`: the tensors whose shapes the moments take
    (a rank's slices under ZeRO), `offload`: moments on the host."""
    if cfg.fused_optimizer:
        return FusedAdamW(named_params, cfg, offload=offload,
                          moment_shapes=None if moment_like is None else
                          [t.shape for t in moment_like])
    return TorchAdamW(named_params, cfg, moment_like=moment_like,
                      offload=offload)


def _check_variants(params: llava.LlavaParams, train_cfg: TrainConfig):
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


def init_train_state(params: llava.LlavaParams, train_cfg: TrainConfig):
    """`init_sharded_train_state` on one process without ZeRO: freeze per
    stage and build the optimizer over the trainable parameters. Returns
    ({"params", "step"}, optimizer). `lora_rank` and `switch_sigma` must
    agree with what `params` carries: the labels follow the parameters, the
    loss follows the config."""
    return init_sharded_train_state(params, train_cfg, None,
                                    make_mesh(world_size=1), zero=0)


def param_partition_tree(params: llava.LlavaParams,
                         model_cfg: llava.LlavaConfig, mesh, *,
                         zero: int = 0, min_size: Optional[int] = None,
                         pipeline: bool = False) -> Dict[str, fsdp.P]:
    """Parameter name -> spec over `mesh` for a whole (not yet sharded)
    model: the decoder's and the adapters' TP specs
    (`llama.param_partition_specs`, `lora.param_partition_specs`), the rest
    replicated; `zero >= 3` adds the data axis to every leaf of at least
    `min_size` elements (`fsdp.fsdp_spec`, the JAX placement). `pipeline`:
    the decoder layers are held by stage (`LlamaModel.hold_layers`, the JAX
    `pp_layer_specs`), which ZeRO-3 does not compose with."""
    if pipeline and zero >= 3:
        raise ValueError("pipeline parallelism composes with zero<=2 "
                         "(stage-sharded layers; re-sharding them on "
                         "the data axis is not supported)")
    if min_size is None:
        min_size = fsdp.MIN_SIZE_TO_SHARD
    tp = {f"decoder.{k}": v for k, v in
          llama.param_partition_specs(model_cfg.decoder).items()}
    if params.lora is not None:
        tp.update({f"lora.{k}": v for k, v in lora.param_partition_specs(
            model_cfg.decoder, params.lora.lora_cfg).items()})
    specs = {}
    for name, p in params.named_parameters():
        spec = tp.get(name, fsdp.P(*([None] * p.dim())))
        if zero >= 3:
            spec = fsdp.fsdp_spec(tuple(p.shape), spec, mesh.n("data"),
                                  min_size=min_size)
        specs[name] = spec
    return specs


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a trainable leaf is held over the mesh. `mode`: "replicated"
    (whole on every data rank, its gradient all-reduced), "scatter" (ZeRO-2:
    the gradient reduce-scattered along `dp_dim`, the slice updated, the
    leaf all-gathered again) or "sharded" (ZeRO-3: the leaf is a slice along
    `dp_dim`, its gradient arrives reduce-scattered). `tp_dim`: the dim the
    decoder's TP cut it along, None where it is whole on every model
    rank. `staged`: a decoder layer's leaf, held by one pipeline stage."""
    name: str
    mode: str
    dp_dim: Optional[int]
    tp_dim: Optional[int]
    staged: bool = False


def init_sharded_train_state(params: llava.LlavaParams,
                             train_cfg: TrainConfig,
                             model_cfg: llava.LlavaConfig, mesh, *,
                             zero: int = 2, offload_opt_state: bool = False,
                             offload_params: bool = False,
                             min_size: Optional[int] = None,
                             pipeline: bool = False):
    """The JAX `init_sharded_train_state` for a `parallel.Mesh`: `params` is
    the whole model (every rank builds the same one) and is sharded in
    place: its decoder tensor-parallel over the model axis, its leaves over
    the data axis under `zero=3`; under `zero=2` each rank's moments are the
    slice `fsdp_spec` picks. `offload_opt_state` keeps the moments, and
    `offload_params` every parameter of at least 4,096 elements, in pinned
    host memory between steps. `pipeline`: this rank keeps only its stage's
    decoder layers (`parallel.pipeline.stage_layers` of its stage-axis
    coordinate). `model_cfg` is read only for a model axis, ZeRO or a
    pipeline (`param_partition_tree`). Returns ({"params", "step"},
    optimizer); the optimizer carries the leaves' `plans` and the
    `param_offload` for `make_train_step(..., mesh=mesh)`."""
    _check_variants(params, train_cfg)
    n_data, n_model = mesh.n("data"), mesh.n("model")
    if min_size is None:
        min_size = fsdp.MIN_SIZE_TO_SHARD
    specs = param_partition_tree(params, model_cfg, mesh, zero=zero,
                                 min_size=min_size, pipeline=pipeline) \
        if n_model > 1 or zero >= 2 or pipeline else {}
    if pipeline:
        params.decoder.hold_layers(stage_layers(
            model_cfg.decoder.num_layers, mesh.n("stage"),
            mesh.coord("stage")))
    shapes = {n: tuple(p.shape) for n, p in params.named_parameters()}
    device = next(params.parameters()).device
    trainable = apply_freeze(params, train_cfg.stage)
    if n_model > 1:
        params.decoder.shard_tensor_parallel(mesh.group("model"))
        if params.lora is not None:
            params.lora.shard_tensor_parallel(mesh.group("model"))
    data_g = mesh.group("data")
    sliced = {}
    if zero >= 3:
        sliced = {n: d for n, spec in specs.items()
                  if (d := fsdp.spec_dim(spec, "data")) is not None}
        fsdp.shard_parameters(params, sliced, data_g)
    plans, like = [], []
    for name, p in trainable:
        staged = pipeline and name.startswith("decoder.layers.")
        tp_dim = fsdp.spec_dim(specs[name], "model") if n_model > 1 else None
        dp_dim = fsdp.spec_dim(fsdp.fsdp_spec(
            shapes[name], specs[name], n_data, min_size=min_size), "data") \
            if zero >= 2 else None
        if name in sliced:
            plan = LeafPlan(name, "sharded", sliced[name], tp_dim, staged)
        elif dp_dim is not None:
            plan = LeafPlan(name, "scatter", dp_dim, tp_dim, staged)
        else:
            plan = LeafPlan(name, "replicated", None, tp_dim, staged)
        plans.append(plan)
        like.append(comm.local_slice(p.data, dp_dim, data_g)
                    if plan.mode == "scatter" else p.data)
    opt = make_optimizer(trainable, train_cfg, moment_like=like,
                         offload=offload_opt_state)
    opt.plans, opt.device = plans, device
    opt.held = params.decoder.held
    opt.param_offload = (fsdp.ParamOffload(params, device)
                         if offload_params else None)
    return {"params": params, "step": 0}, opt


def global_norm(grads, plans, data_group, model_group,
                stage_group=None) -> torch.Tensor:
    """The global gradient norm over the mesh: the squares of a leaf sliced
    over an axis (data, model, or held by one pipeline stage) are summed
    over that axis, those of a leaf whole on it are counted once (every
    leaf is whole on the seq axis)."""
    dev = grads[0].device if grads else torch.device("cpu")

    def part(which) -> torch.Tensor:
        sums = {k: torch.zeros((), device=dev)
                for k in ("both", "data", "model", "none")}
        for g, plan in zip(grads, plans):
            if plan.staged != which:
                continue
            dp, tp = plan.mode != "replicated", plan.tp_dim is not None
            key = "both" if dp and tp else "data" if dp else \
                "model" if tp else "none"
            sums[key] = sums[key] + g.float().square().sum()
        x = comm.all_reduce(torch.stack([sums["both"], sums["data"]]),
                            data_group)
        y = comm.all_reduce(torch.stack([x[0], sums["model"]]), model_group)
        return y[0] + y[1] + x[1] + sums["none"]
    total = part(False)
    if any(plan.staged for plan in plans):
        total = total + comm.all_reduce(part(True), stage_group)
    return torch.sqrt(total)


@contextlib.contextmanager
def whole_params(params: llava.LlavaParams, opt=None, mesh=None):
    """Every rank holds the whole model in place for the body (ZeRO-3 slices
    and TP slices all-gathered, offloaded parameters on the device, and
    under pipeline parallelism every stage's layers, gathered over the
    `mesh`'s stage group), and its shards again after: how a sharded run
    saves. Every rank must enter it (the gathers are collectives)."""
    off = getattr(opt, "param_offload", None)
    if off is not None:
        off.to_device()
    held = fsdp.unshard_parameters(params)
    dec = params.decoder
    tp = [m for m in (dec, params.lora)
          if m is not None and m.tp_group is not None]
    staged = len(dec.held) < dec.cfg.num_layers
    for m in tp:
        m.unshard_tensor_parallel()
    if staged:
        dec.gather_stages(mesh.group("stage"))
    try:
        yield params
    finally:
        if staged:
            dec.drop_unheld()
        for m in tp:
            m.reshard_tensor_parallel()
        fsdp.reshard_parameters(held)
        if off is not None:
            off.to_host()


class GatheredOptState:
    """An optimizer's state for a checkpoint's `opt_state.pt`: `count` and
    each leaf's whole moments `mu` / `nu`, every rank's slices all-gathered
    when it is made (every rank must make it)."""

    def __init__(self, opt, mesh):
        device = getattr(opt, "device", torch.device("cpu"))
        self.sd = {"count": opt.count, "mu": {}, "nu": {}}
        stage_g = mesh.group("stage")
        for which, moments in zip(("mu", "nu"), opt.moments()):
            for plan, t in zip(opt.plans, moments):
                # a whole leaf's moments are saved where they live (no
                # second copy of the tree on the host)
                if plan.mode != "replicated" or plan.tp_dim is not None \
                        or plan.staged:
                    t = t.to(device)
                    if plan.mode != "replicated":
                        t = comm.all_gather(t, plan.dp_dim,
                                            mesh.group("data"))
                    if plan.tp_dim is not None:
                        t = comm.all_gather(t, plan.tp_dim,
                                            mesh.group("model"))
                    if plan.staged:
                        # every stage's moments of this leaf, by the same
                        # position in each stage's layers
                        for name, x in zip(_stage_names(
                                plan.name, opt.held, mesh.n("stage")),
                                           comm.all_gather(t[None], 0,
                                                           stage_g)):
                            self.sd[which][name] = x.cpu()
                        continue
                    t = t.cpu()
                self.sd[which][plan.name] = t

    def state_dict(self) -> Dict:
        return self.sd


def _stage_names(name: str, held: range, n_stages: int) -> List[str]:
    """`decoder.layers.{i}.<leaf>` of this stage's `held` layers -> the
    names of the leaf at the same place in each stage's layers, in stage
    order."""
    _, _, i, leaf = name.split(".", 3)
    j = int(i) - held.start
    return [f"decoder.layers.{k * len(held) + j}.{leaf}"
            for k in range(n_stages)]


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
                    opt, *, mesh=None, cp=None, pp=None):
    """Returns step(state, batch) -> (state, metrics) for the optimizer of
    `init_sharded_train_state` (or `init_train_state`). The metrics are
    device scalars `loss`, `grad_norm`, `skipped_nonfinite` and the int
    `step`, those of the global batch on every rank. The batch is the
    `collate_batch` dict as tensors on the model's device (ids and labels as
    int64): with a `mesh`, this data rank's rows of the global batch
    (`parallel.shard_batch`); without one, or on a mesh without process
    groups, every collective of the step is the identity. `cp`
    (`ops.ring_attention.ContextParallel`) and `pp`
    (`parallel.pipeline.PipelineParallel`, with a state from
    `init_sharded_train_state(pipeline=True)`) run the loss context- or
    pipeline-parallel (`llava.loss_fn`)."""
    trainable = [p for _, p in opt.named_params]
    plans = opt.plans
    group = (lambda axis: None) if mesh is None else mesh.group
    data_g, model_g = group("data"), group("model")
    # the switch loss runs the whole sequence on every seq rank: nothing to
    # sum there (`llava.loss_fn` refuses a pipeline with LoRA, with the JAX
    # words)
    seq_g = group("seq") if cp is not None and not train_cfg.switch_sigma \
        else None
    stage_g = group("stage") if pp is not None else None

    def loss_and_grads(params, batch):
        kw = dict(remat=train_cfg.remat, remat_policy=train_cfg.remat_policy,
                  use_flash=train_cfg.use_flash, mesh=mesh)
        if train_cfg.switch_sigma:
            loss = switch_loss_fn(params, model_cfg, batch,
                                  train_cfg.switch_sigma, pp=pp, **kw)
        else:
            loss = llava.loss_fn(params, model_cfg, batch,
                                 lora_scaling=train_cfg.lora_scaling, cp=cp,
                                 pp=pp, **kw)
        return loss.detach(), torch.autograd.grad(loss, trainable)

    def accumulated(params, batch):
        a = train_cfg.grad_accum
        if a <= 1:
            return loss_and_grads(params, batch)
        if batch["input_ids"].shape[0] % a:
            raise ValueError("batch size must divide by grad_accum")
        loss, grads = None, None
        for mb in _split(batch, a):
            l, g = loss_and_grads(params, mb)
            loss = l if loss is None else loss + l
            grads = list(g) if grads is None else [
                x + y for x, y in zip(grads, g)]
        return loss / a, [g / a for g in grads]

    def step(state, batch):
        off = opt.param_offload
        if off is not None:
            off.to_device()
        loss, grads = accumulated(state["params"], batch)
        # the data (x seq) ranks' shares sum to the global token mean; the
        # last pipeline stage holds it
        loss = comm.all_reduce(loss.clone(), data_g)
        loss = comm.all_reduce(comm.all_reduce(loss, seq_g), stage_g)
        held = []
        for g, plan in zip(grads, plans):
            # every leaf is whole on the seq ranks, and all but a stage's
            # layers on the stages: their gradients are summed there first
            g = comm.all_reduce(g.contiguous(), seq_g)
            if not plan.staged:
                g = comm.all_reduce(g, stage_g)
            if plan.mode == "replicated":
                g = comm.all_reduce(g.contiguous(), data_g)
            elif plan.mode == "scatter":
                g = comm.reduce_scatter(g, plan.dp_dim, data_g)
            held.append(g)
        gnorm = global_norm(held, plans, data_g, model_g, stage_g)
        # production guard (absent in the reference): a nonfinite loss or
        # gradient applies no update instead of poisoning the parameters;
        # loss and norm are reduced values, so every rank takes one branch
        finite = torch.isfinite(loss) & torch.isfinite(gnorm)
        targets = [comm.local_slice(p.data, plan.dp_dim, data_g)
                   if plan.mode == "scatter" else p
                   for p, plan in zip(trainable, plans)]
        opt.step(held, finite, gnorm, params=targets)
        with torch.no_grad():
            for p, t, plan in zip(trainable, targets, plans):
                if plan.mode == "scatter":
                    p.data.copy_(comm.all_gather(t, plan.dp_dim, data_g))
        if off is not None:
            off.to_host(trained_only=True)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm,
                       "skipped_nonfinite": 1.0 - finite.float(),
                       "step": state["step"]}

    return step
