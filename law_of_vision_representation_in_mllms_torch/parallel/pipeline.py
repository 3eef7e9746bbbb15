"""Pipeline parallelism of the decoder trunk: a GPipe schedule over the
mesh's ``stage`` axis (counterpart of the JAX package's
`parallel/pipeline.py`).

- Stage k holds decoder layers [k·L/S, (k+1)·L/S) (the JAX [L] -> [S, L/S]
  reshape of the stacked layers; `stage_layers`,
  `models.llama.LlamaModel.hold_layers`). The embedding, the final norm,
  the `lm_head`, the tower and the projector stay whole on every stage, as
  in JAX; their gradients are summed over the stage group by the step.
- A step's rows (this data rank's) are cut into M microbatches of B / M
  consecutive rows (the JAX [M, mb] split; the runner hands a data rank the
  rows that make each of them its share of the JAX microbatch). GPipe:
  every microbatch's forward through the S stages, then every backward in
  reverse. Stage 0 runs the tower, the projector, the embedding and the
  splice (`models.llava.loss_fn`); the last stage the final RMSNorm, the
  logits and each microbatch's loss as its share of the GLOBAL token mean,
  the valid targets counted up front from the labels, which every rank
  holds. Every stage builds the positions and the mask from the batch
  itself, so only the hidden states and their gradients cross stages.
- `remat_ticks` checkpoints each (stage, microbatch) forward: the backward
  runs it again instead of keeping its activations.
- The hand-off between stages is an argument of `PipelineParallel`: by
  default `P2PHandoff`, point to point over the stage group (one stage a
  process, as the JAX mesh gives a stage its devices). A hand-off names the
  stages its process runs (`stages`) and moves a tensor from stage `src`
  to stage `dst` (`send(x, src, dst, key)`, `recv(like, src, dst, key)`;
  `key` is ("h" | "g", microbatch)); `LocalHandoff` runs all S stages in
  one process.
- A stage's trunk is `LlamaModel.forward` over its layers (the final norm
  on the last stage only).

`gpipe_loss` is a `torch.autograd.Function`: its forward runs the forward
schedule and keeps each (stage, microbatch)'s graph, its backward runs the
backward schedule and returns the gradients of every trainable parameter
of this process (zero for those no stage here uses: they come through the
embeddings, or from another stage), so the backward schedule runs on every
stage whatever the step asks for.

`head` replaces the last stage's logits (`head(h)` of the final-normed
hidden states, the switch's steered head). The trainable tensors outside
the decoder are then the head's, which the last stage differentiates, and
a gradient crosses a stage only where a decoder weight trains (the freeze
labels set that alike on every process): with the decoder frozen (a
switch step) the trunk runs forward only, and embeddings that take a
gradient are refused. Without a `head` the relay always runs: the
trainable tensors outside the decoder (the projector's) take their
gradient through the embeddings. A frozen quantised trunk (stage 1 with `train.quantize_base`) runs
as a dense one: each stage holds its layers' codes and scales, and the
relay carries the gradient through them to the projector.

Not with context parallelism or LoRA (the JAX refusal), nor with ZeRO-3.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Sequence

import torch
from torch.utils import checkpoint as ckpt

from ..models import llama as L
from . import comm
from .fsdp import P


@dataclasses.dataclass(frozen=True)
class PipelineParallel:
    """Handle threaded through `llava.loss_fn` (like ContextParallel).
    `microbatches`: the GPipe microbatch count (None: one a stage);
    `remat_ticks`: checkpoint each (stage, microbatch) forward; `handoff`:
    how hidden states and their gradients cross stages (None:
    `P2PHandoff` over the mesh's stage group)."""
    mesh: Any
    microbatches: Optional[int] = None
    remat_ticks: bool = False
    handoff: Any = None

    @property
    def n_stages(self) -> int:
        return self.mesh.n("stage")

    @property
    def n_micro(self) -> int:
        return self.microbatches or self.n_stages

    @property
    def group(self):
        return self.mesh.group("stage")

    @property
    def stage(self) -> int:
        return self.mesh.coord("stage")

    def link(self):
        return self.handoff or P2PHandoff(self.group, self.stage)


def pp_layer_specs(dec_specs: dict) -> dict:
    """The decoder's stacked-layer specs with the leading (layer) axis on
    the stage axis (the JAX `pp_layer_specs`; `parallel/fsdp.py`'s
    `memory_report` and `derived_state_specs` read them as JAX does)."""
    return {k: P("stage", *tuple(s)[1:])
            for k, s in dec_specs["layers"].items()}


def stage_layers(num_layers: int, n_stages: int, stage: int) -> range:
    """The decoder layers stage `stage` holds."""
    if num_layers % n_stages:
        raise ValueError(f"num_layers {num_layers} not divisible by "
                         f"{n_stages} pipeline stages")
    per = num_layers // n_stages
    return range(stage * per, (stage + 1) * per)


class P2PHandoff:
    """The default hand-off: this process runs stage `stage`; a tensor
    crosses to a neighbour by `comm.send_to` / `comm.recv_from` over the
    stage group."""

    def __init__(self, group, stage: int):
        self.group = group
        self.stages = (stage,)

    def send(self, x, src: int, dst: int, key) -> None:
        comm.send_to(x, dst, self.group)

    def recv(self, like, src: int, dst: int, key):
        return comm.recv_from(torch.empty_like(like), src, self.group)


class LocalHandoff:
    """Every stage in this process: what stage `src` sends to `dst` waits
    in a dict until `dst` takes it."""

    def __init__(self, n_stages: int):
        self.stages = tuple(range(n_stages))
        self.box = {}

    def send(self, x, src: int, dst: int, key) -> None:
        self.box[(src, dst, key)] = x

    def recv(self, like, src: int, dst: int, key):
        return self.box.pop((src, dst, key))


class _Schedule:
    """One step's GPipe over the stages this process runs: `forward` keeps
    each (stage, microbatch)'s input and output, `backward` consumes
    them."""

    def __init__(self, dec, pp: PipelineParallel, embeds, positions,
                 attn_mask, labels, count, *, use_flash, remat,
                 remat_policy, trainable=(), head=None):
        self.dec, self.pp = dec, pp
        own = {id(p) for p in dec.parameters()}
        self.head = head or functools.partial(L.logits_fn, dec)
        self.head_params = [] if head is None else [
            w for w in trainable if w.requires_grad and id(w) not in own]
        self.trunk_grad = head is None or any(
            p.requires_grad for p in dec.parameters())
        self.link = pp.link()
        self.stages = tuple(sorted(self.link.stages))
        self.S, self.M = pp.n_stages, pp.n_micro
        b, s = positions.shape
        if b % self.M:
            raise ValueError(f"batch {b} not divisible by {self.M} "
                             f"microbatches")
        self.mb = b // self.M
        self.layers = {k: stage_layers(dec.cfg.num_layers, self.S, k)
                       for k in self.stages}
        self.embeds, self.positions, self.attn_mask = embeds, positions, \
            attn_mask
        self.labels, self.count = labels, count
        self.use_flash, self.remat, self.remat_policy = use_flash, remat, \
            remat_policy
        cd = dec.precision.compute_dtype
        self.template = torch.empty((self.mb, s, dec.cfg.hidden_size),
                                    dtype=cd, device=positions.device)
        self.saved = {}

    def rows(self, m: int) -> slice:
        return slice(m * self.mb, (m + 1) * self.mb)

    def weights(self, k: int) -> list:
        """The parameters stage k's forward reads that take a gradient."""
        dec = self.dec
        ws = [p for i in self.layers[k] for p in dec.layers[i].parameters()]
        if k == self.S - 1:
            ws += [dec.final_norm, *dec.lm_head.parameters(),
                   *self.head_params]
        return [w for w in ws if w.requires_grad]

    def stage_forward(self, k: int, m: int, x):
        """Stage k on microbatch m: its layers, and on the last stage the
        final norm, the head and the microbatch's share of the loss (the
        head differentiated even where the trunk is not)."""
        dec, rows, last = self.dec, self.rows(m), k == self.S - 1
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and self.trunk_grad):
            h, _ = dec(x, self.positions[rows],
                       attn_mask=self.attn_mask[rows],
                       use_flash=self.use_flash, remat=self.remat,
                       remat_policy=self.remat_policy,
                       layers=self.layers[k], final_norm=last)
        if not last:
            return h
        nll, _ = L.target_nll(self.head(h)[:, :-1], self.labels[rows][:, 1:])
        return nll / self.count.clamp_min(1)

    def forward(self, keep: bool):
        """Every microbatch through the stages here, in GPipe order; the
        loss on the last stage's process (0 elsewhere). `keep`: build and
        keep the graphs for `backward`."""
        loss = torch.zeros((), dtype=torch.float32,
                           device=self.positions.device)
        for m in range(self.M):
            for k in self.stages:
                if k == 0:
                    if self.embeds.requires_grad and not self.trunk_grad:
                        raise ValueError(
                            "gpipe_loss: the embeddings take a gradient, but "
                            "with a `head` the trainable tensors outside the "
                            "decoder are the head's")
                    x = self.embeds[self.rows(m)].to(self.template.dtype)
                    x = x.detach().requires_grad_(
                        keep and self.trunk_grad and self.embeds.requires_grad)
                else:
                    x = self.link.recv(self.template, k - 1, k, ("h", m))
                    x.requires_grad_(keep and self.trunk_grad)
                fn = functools.partial(self.stage_forward, k, m)
                with torch.set_grad_enabled(keep):
                    if keep and self.trunk_grad and self.pp.remat_ticks:
                        y = ckpt.checkpoint(fn, x, use_reentrant=False)
                    else:
                        y = fn(x)
                if k < self.S - 1:
                    self.link.send(y.detach(), k, k + 1, ("h", m))
                else:
                    loss = loss + y.detach().float()
                if keep:
                    self.saved[(k, m)] = (x, y)
        return loss

    def backward(self, g_loss, wanted: Sequence[torch.Tensor]):
        """Every microbatch's backward in reverse through the stages here.
        Returns (the embeddings' gradient or None, a gradient a tensor of
        `wanted`: zeros where no stage here uses it)."""
        grads = {id(w): None for w in wanted}
        d_embeds = None
        if 0 in self.stages and self.embeds.requires_grad:
            d_embeds = torch.zeros_like(self.embeds)
        for m in reversed(range(self.M)):
            for k in reversed(self.stages):
                x, y = self.saved.pop((k, m))
                if not (self.trunk_grad or k == self.S - 1):
                    continue
                if k == self.S - 1:
                    g_y = g_loss.to(y.dtype)
                else:
                    g_y = self.link.recv(self.template, k + 1, k, ("g", m))
                ws = self.weights(k)
                ins = ([x] if x.requires_grad else []) + ws
                got = torch.autograd.grad(y, ins, g_y, allow_unused=True) \
                    if ins else ()
                if x.requires_grad:
                    g_x, got = got[0], got[1:]
                    if g_x is None:
                        g_x = torch.zeros_like(x)
                    if k > 0:
                        self.link.send(g_x, k, k - 1, ("g", m))
                    elif d_embeds is not None:
                        d_embeds[self.rows(m)] = g_x.to(d_embeds.dtype)
                for w, g in zip(ws, got):
                    if g is not None and id(w) in grads:
                        prev = grads[id(w)]
                        grads[id(w)] = g if prev is None else prev + g
        return d_embeds, [torch.zeros_like(w) if grads[id(w)] is None
                          else grads[id(w)] for w in wanted]


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run: _Schedule, embeds, *weights):
        ctx.run, ctx.weights = run, weights
        return run.forward(keep=True)

    @staticmethod
    def backward(ctx, g_loss):
        d_embeds, grads = ctx.run.backward(g_loss, ctx.weights)
        ctx.run = ctx.weights = None
        return (None, d_embeds, *grads)


def gpipe_loss(dec, pp: PipelineParallel, embeds, positions, attn_mask,
               labels, count, *, trainable: Sequence[torch.Tensor] = (),
               use_flash: bool = False, remat: bool = False,
               remat_policy: Optional[str] = None, head=None):
    """The pipelined loss of this process: the sum of the microbatches'
    shares of the global token mean (`count`: the global batch's valid
    targets) on the last stage's process, 0 on the others.

    `dec`: the decoder (holding at least the layers of the stages here);
    `embeds` [B, S, D]: the spliced embeddings on a process that runs stage
    0, else None; `positions`, `attn_mask`, `labels` [B, S]: the splice's,
    on every process. `trainable`: every tensor of this process that takes
    a gradient (`params.parameters()` that require one): the backward
    returns one for each, so the backward schedule runs whatever the
    caller differentiates. Without grad mode the forward runs alone.
    `head`: as in the module text."""
    run = _Schedule(dec, pp, embeds, positions, attn_mask, labels, count,
                    use_flash=use_flash, remat=remat,
                    remat_policy=remat_policy, trainable=trainable,
                    head=head)
    if not torch.is_grad_enabled():
        return run.forward(keep=False)
    weights = [w for w in trainable if w.requires_grad]
    return _GPipe.apply(run, embeds, *weights)
