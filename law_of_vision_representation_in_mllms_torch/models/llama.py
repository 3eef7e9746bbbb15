"""LLaMA decoder (counterpart of the JAX package's `models/llama.py`).

RMSNorm in fp32, rotate-half RoPE, SwiGLU MLP, grouped-query attention
(query head h reads kv head h // (H / KV)). The trunk is a per-layer
`nn.ModuleList` walked by a Python loop instead of a `lax.scan` over stacked
weights.

Attention routes:
- a prefill at cache slot 0 (and any no-cache pass with `use_flash=True`,
  training included) runs kernel 2 (`ops.flash_attention`, causal over array
  order) on the local K/V, as the JAX `flash_ok` path does; the batch must be
  right-padded. Under autograd its backward is kernels 5 and 6;
- a decode step (one query token against a cache) runs kernel 3
  (`ops.decode_attention`) over the cache in its stored layout;
- everything else runs the plain masked `_attention`.

The KV cache is a list with one `(k, v)` pair of [B, T, KV, Dh] tensors per
layer (the JAX cache's per-layer layout). A forward writes the new K/V into
its slots IN PLACE and returns the same list. `init_cache(quant="int8")`
gives each layer `(k, v, k_scale, v_scale)`: int8 codes and fp32 scales
[B, T, KV] (`ops.quant.quantize_kv`). Fresh K/V are quantised on write; a
decode step reads codes and scales through kernel 3's int8 branch, the plain
`_attention` takes them too, and the flash prefill attends over the fresh
bf16 K/V, as in the JAX package.

Weight-only quantisation: after `ops.quant.quantize_decoder` the blocks'
`Dense` modules and the `lm_head` are `QuantDense` (int8: a plain PyTorch
product on the cast codes; int4: kernel 10), called like a `Dense`.

LoRA: `forward(lora=...)` hands block i the adapters `lora.layers[i]`
(`models/lora.py`); every weight product of the block, `QuantDense` included
(QLoRA), gains its rank-r delta, added after the product's TP reduction.

Training: a no-cache pass takes `remat` / `remat_policy` (the JAX `_remat`):
"block" checkpoints every block (`torch.utils.checkpoint`, non-reentrant),
"dots" checkpoints it selectively, saving the outputs of the block's weight
matmuls and recomputing the rest. `causal_lm_loss` is the JAX loss; given
the data group it divides by the valid targets of the whole global batch.

Tensor parallelism (`LlamaModel.shard_tensor_parallel`, the JAX
`param_partition_specs` placement over the mesh's model axis): `wq`, `wk`,
`wv`, `gate` and `up` are column-parallel (each rank holds H / n query heads
and KV / n kv heads), `wo` and `down` row-parallel and followed by an
all-reduce, `embed` vocab-parallel (ids another rank owns are masked, then
an all-reduce) and `lm_head` vocab-sharded with its fp32 logits all-gathered
(`parallel/comm.py`). Attention (kernels 2, 5 and 6) runs unchanged on each
rank's local heads; the norms stay replicated. Training passes only: a KV
cache holds every head. A quantised product is cut the same way
(`layers.QuantDense.shard_tensor_parallel`: codes and scales of its output
channels, or of its contraction range). The adapters of a column-parallel
product keep A whole and B's output columns (`lora.LoraAdapters.
shard_tensor_parallel`): x·A is the same on every rank, so A runs on the
norm's output before its `copy_to`, and its own `copy_to` sums the
gradient of x·A over the ranks. Those of a row-parallel product keep A's
input rows and B whole: the rank's partial x_r·A_r is all-reduced
(`reduce_from`) before B. So every leaf that is whole on the model ranks
gets the whole gradient on each of them, and no gradient is reduced over
the model axis by the step.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.decode_attention import decode_attention
from ..ops.flash_attention import flash_attention
from ..ops.quant import quantize_kv
from ..ops.ring_attention import ring_attention
from ..parallel import comm
from ..parallel.fsdp import P
from .layers import Dense, QuantDense

Cache = List[Tuple[torch.Tensor, ...]]
DECODE_ATTN_ROUTES = ("xla", "pallas", "pallas_stacked")
INIT_STD = 0.02   # every decoder weight ~ N(0, 0.02), as in the JAX init


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 2048
    # accepted so that the JAX package's RunConfigs load; it selects nothing
    # here. The JAX names are "xla", "pallas" (the TPU kernel
    # `decode_attention`) and "pallas_stacked" (`decode_attention_stacked`,
    # which indexes the layer inside the stacked cache). The port's cache is
    # a list of per-layer tensors, which is the slice the stacked kernel
    # reads, so every name runs kernel 3; only an unknown name raises.
    decode_attn: str = "xla"

    def __post_init__(self):
        if self.decode_attn not in DECODE_ATTN_ROUTES:
            raise ValueError(f"unknown decode_attn {self.decode_attn!r}; "
                             f"one of {DECODE_ATTN_ROUTES}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


def vicuna_7b() -> LlamaConfig:
    """lmsys/vicuna-7b-v1.5, the decoder of every reference model."""
    return LlamaConfig()


def tiny(vocab_size: int = 256, hidden_size: int = 64, num_layers: int = 2,
         num_heads: int = 4, num_kv_heads: int = 2,
         intermediate_size: int = 128, max_seq_len: int = 128
         ) -> LlamaConfig:
    return LlamaConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                       intermediate_size=intermediate_size,
                       num_layers=num_layers, num_heads=num_heads,
                       num_kv_heads=num_kv_heads, max_seq_len=max_seq_len)


# the decoder matmuls of tensor parallelism: column-parallel (the output
# features split over the model axis) and row-parallel (the input features)
TP_COLUMN = ("wq", "wk", "wv", "gate", "up")
TP_ROW = ("wo", "down")


def param_partition_specs(cfg: LlamaConfig) -> dict:
    """Parameter name -> spec over the mesh's model axis: the JAX
    `param_partition_specs` (Megatron TP) in the port's layout (a Dense
    weight is [out, in], one entry a block)."""
    specs = {"embed": P("model", None), "final_norm": P(None),
             "lm_head.weight": P("model", None)}
    for i in range(cfg.num_layers):
        for name in TP_COLUMN:
            specs[f"layers.{i}.{name}.weight"] = P("model", None)
        for name in TP_ROW:
            specs[f"layers.{i}.{name}.weight"] = P(None, "model")
        specs[f"layers.{i}.rms1"] = specs[f"layers.{i}.rms2"] = P(None)
    return specs


def rms_norm(x, weight, eps: float):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rope_tables(cfg: LlamaConfig, positions):
    """cos/sin [B, S, Dh] for positions [B, S] (HF rotate-half layout)."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32,
                     device=positions.device) / hd))
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x, cos, sin):
    """x [B, S, H, Dh]; cos/sin [B, S, Dh]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[..., None, :]
            + rotated.float() * sin[..., None, :]).to(x.dtype)


def _attention(q, k, v, mask, accum_dtype=torch.float32, k_scale=None,
               v_scale=None):
    """Plain masked GQA attention. q [B,S,H,Dh], k/v [B,T,KV,Dh], mask
    [B,S,T] bool; fp32 softmax, probabilities cast to q.dtype before P·V.
    With `k_scale`/`v_scale` [B,T,KV], k and v are int8 cache codes: the K
    scale multiplies the logits along the key axis, the V scale the fp32
    probabilities before their cast."""
    b, s, nh, dh = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, s, nkv, nh // nkv, dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(accum_dtype),
                          k.to(accum_dtype)) * dh ** -0.5
    if k_scale is not None:
        logits = logits * k_scale.transpose(1, 2)[:, :, None, None, :].to(
            logits.dtype)
    # masked_fill of a Python scalar: no host tensor is copied to the card,
    # so the verify round of the speculative decode can be captured
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)[:, :, None, None, :]
    probs = probs.to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(accum_dtype),
                       v.to(accum_dtype))
    return out.reshape(b, s, nh, dh).to(q.dtype)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, precision: Precision, *,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.precision = precision
        d, i, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
        nh, nkv = cfg.num_heads, cfg.num_kv_heads
        kw = dict(device=device, dtype=precision.param_dtype)

        def dense(din, dout):
            return Dense(din, dout, precision, bias=False, init_std=INIT_STD,
                         device=device)
        self.rms1 = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
        self.wq = dense(d, nh * hd)
        self.wk = dense(d, nkv * hd)
        self.wv = dense(d, nkv * hd)
        self.wo = dense(nh * hd, d)
        self.rms2 = nn.Parameter(torch.empty(d, **kw), requires_grad=False)
        self.gate = dense(d, i)
        self.up = dense(d, i)
        self.down = dense(i, d)
        self.tp_group = None     # the model axis' group under TP

    def reset_parameters(self, generator):
        self.rms1.fill_(1.0)
        self.rms2.fill_(1.0)

    def forward(self, h, cos, sin, mask, kv_cache, cache_index,
                use_flash: bool, lora=None, lora_scaling: float = 1.0,
                ring=None):
        """`lora`: this block's `models.lora.LoraLayer` or None. Each weight
        product, dense or quantised, gains its rank-r delta on top. `ring`:
        a context-parallel attention `ring(q, k, v)` over this rank's
        sequence shard (`LlamaModel.forward(cp=...)`), or None."""
        cfg = self.cfg
        b, s, _ = h.shape
        tp = self.tp_group
        nh = cfg.num_heads // comm.size(tp)
        nkv = cfg.num_kv_heads // comm.size(tp)
        hd = cfg.head_dim

        def mm(x_, name, src=None):
            """The product `name` of x_, reduced over the model ranks where
            it is row-parallel, plus its adapters' delta; `src`: x_ before
            its `copy_to` (a column-parallel product's adapters read it)."""
            y = getattr(self, name)(x_)
            if name in TP_ROW:
                y = comm.reduce_from(y, tp)
            delta = None if lora is None else lora.delta(
                (x_ if src is None else src).to(y.dtype), name, lora_scaling,
                tp)
            return y if delta is None else y + delta

        xn = rms_norm(h, self.rms1, cfg.rms_eps)
        x = comm.copy_to(xn, tp)
        q = apply_rope(mm(x, "wq", xn).view(b, s, nh, hd), cos, sin)
        k = apply_rope(mm(x, "wk", xn).view(b, s, nkv, hd), cos, sin)
        v = mm(x, "wv", xn).view(b, s, nkv, hd)
        k_sc = v_sc = None
        if kv_cache is not None:
            ck, cv = kv_cache[:2]
            if torch.is_tensor(cache_index):
                # [B, s] slots held on the device: an index_put_, no host
                # value, so the write can sit in a captured CUDA graph
                rows = torch.arange(b, device=h.device)[:, None]
                new = (rows, cache_index)
            else:
                new = (slice(None), slice(cache_index, cache_index + s))
            if len(kv_cache) == 4:
                # int8 cache: the fresh block is quantised on write
                k_sc, v_sc = kv_cache[2:]
                (ck[new], k_sc[new]) = quantize_kv(k)
                (cv[new], v_sc[new]) = quantize_kv(v)
            else:
                ck[new] = k
                cv[new] = v
            k_all, v_all = ck, cv
        else:
            k_all, v_all = k, v
        if ring is not None:
            # the sequence sharded over the seq axis, K/V rotating
            # (`ops/ring_attention.py`): causality and padding in the ring
            attn = ring(q, k, v)
        elif use_flash:
            # right-padded prefill over the local K/V (kernel 2's contract)
            attn = flash_attention(q, k, v, causal=True)
        elif s == 1 and k_all.shape[1] > 1:
            attn = decode_attention(q, k_all, v_all, mask[:, 0], k_sc, v_sc)
        else:
            attn = _attention(q, k_all, v_all, mask,
                              self.precision.accum_dtype, k_sc, v_sc)
        h = h + mm(attn.reshape(b, s, nh * hd), "wo")
        xn = rms_norm(h, self.rms2, cfg.rms_eps)
        x = comm.copy_to(xn, tp)
        return h + mm(F.silu(mm(x, "gate", xn)) * mm(x, "up", xn), "down")


# "dots": the non-batched matmuls (the block's weight products) are saved;
# batched products (plain attention) and every elementwise op recompute
# (JAX `checkpoint_dots_with_no_batch_dims`)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(block, policy: Optional[str]):
    """Per-block gradient checkpointing (JAX `models/llama._remat`): "block"
    (or None, "full") keeps only the block's inputs and re-runs its forward
    in the backward; "dots" keeps the weight-matmul outputs too."""
    if policy in (None, "block", "full"):
        return functools.partial(ckpt.checkpoint, block, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, block, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots))
    raise ValueError(f"unknown remat_policy {policy!r}")


class Absent(nn.Module):
    """The place of a block that another pipeline stage holds."""


class LlamaModel(nn.Module):
    """The decoder's weights: embed [V, d], per-layer blocks, final norm,
    lm_head (a Dense of weight [V, d])."""

    def __init__(self, cfg: LlamaConfig,
                 precision: Precision = DEFAULT_PRECISION, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.precision = precision
        kw = dict(device=device, dtype=precision.param_dtype)
        d = cfg.hidden_size
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, d, **kw),
                                  requires_grad=False)
        self.layers = nn.ModuleList(
            LlamaBlock(cfg, precision, device=device)
            for _ in range(cfg.num_layers))
        self.final_norm = nn.Parameter(torch.empty(d, **kw),
                                       requires_grad=False)
        self.lm_head = Dense(d, cfg.vocab_size, precision, bias=False,
                             init_std=INIT_STD, device=device)
        self.tp_group = None
        self.held = range(cfg.num_layers)    # the blocks this process holds

    def reset_parameters(self, generator):
        self.embed.normal_(0.0, INIT_STD, generator=generator)
        self.final_norm.fill_(1.0)

    def _tp_leaves(self):
        """(parameter, dim) of every dense tensor-parallel leaf, and
        (`QuantDense`, dim, its true contraction dim) of every quantised
        one."""
        cfg = self.cfg
        din = {"wo": cfg.num_heads * cfg.head_dim,
               "down": cfg.intermediate_size}
        leaves, quantised = [(self.embed, 0)], []
        for owner, name in [(self, "lm_head")] + [
                (blk, n) for blk in self.held_blocks()
                for n in TP_COLUMN + TP_ROW]:
            module, dim = getattr(owner, name), 1 if name in TP_ROW else 0
            if isinstance(module, QuantDense):
                quantised.append((module, dim,
                                  din.get(name, cfg.hidden_size)))
            else:
                leaves.append((module.weight, dim))
        return leaves, quantised

    @torch.no_grad()
    def shard_tensor_parallel(self, group) -> None:
        """Keep this rank's slice of every TP leaf (in place: the Parameter
        objects stay) and run the forward tensor-parallel over `group`."""
        cfg, n = self.cfg, comm.size(group)
        for what, count in (("query heads", cfg.num_heads),
                            ("kv heads", cfg.num_kv_heads),
                            ("intermediate features", cfg.intermediate_size),
                            ("vocabulary entries", cfg.vocab_size)):
            if count % n:
                raise ValueError(f"tensor parallelism over {n} ranks needs "
                                 f"the {what} ({count}) to divide by {n}")
        dense, quantised = self._tp_leaves()
        for p, dim in dense:
            p.data = comm.local_slice(p.data, dim, group).clone()
        for module, dim, di in quantised:
            module.shard_tensor_parallel(dim, group, di)
        self.tp_group = group
        for blk in self.held_blocks():
            blk.tp_group = group

    @torch.no_grad()
    def unshard_tensor_parallel(self) -> None:
        """Every rank holds the whole TP leaves again (all-gathered); the
        forward stays tensor-parallel until `reshard_tensor_parallel`."""
        dense, quantised = self._tp_leaves()
        for p, dim in dense:
            p.data = comm.all_gather(p.data, dim, self.tp_group)
        for module, *_ in quantised:
            module.unshard_tensor_parallel()

    @torch.no_grad()
    def reshard_tensor_parallel(self) -> None:
        dense, quantised = self._tp_leaves()
        for p, dim in dense:
            p.data = comm.local_slice(p.data, dim, self.tp_group).clone()
        for module, *_ in quantised:
            module.reshard_tensor_parallel()

    def held_blocks(self) -> List["LlamaBlock"]:
        return [blk for blk in self.layers if isinstance(blk, LlamaBlock)]

    def hold_layers(self, layers: range) -> None:
        """Keep only the blocks of `layers` (a pipeline stage's), each
        other one replaced by an `Absent` place holder: the held blocks
        keep their global names (`layers.{i}.`)."""
        for i in range(len(self.layers)):
            if i not in layers:
                self.layers[i] = Absent()
        self.held = layers

    @torch.no_grad()
    def gather_stages(self, group) -> None:
        """Every rank of the stage group holds every block, all-gathered
        over the group in place of the `Absent` ones (each stage holds as
        many blocks, in the same order); `drop_unheld` undoes it."""
        held = self.held
        for j, i in enumerate(held):
            own = self.layers[i]
            parts = {name: comm.all_gather(t[None], 0, group)
                     for name, t in own.state_dict().items()}
            for k in range(comm.size(group)):
                dst = k * len(held) + j
                if dst in held:
                    continue
                blk = LlamaBlock(self.cfg, self.precision, device="meta")
                blk.to_empty(device=self.embed.device)
                for name, module in own.named_children():
                    # a quantised product of this stage's block: the same
                    # kind of leaf in the gathered one
                    if isinstance(module, QuantDense):
                        setattr(blk, name, QuantDense(
                            {key: torch.empty_like(t) for key, t in
                             module.leaf().items()}, module.precision))
                blk.tp_group = self.tp_group
                blk.load_state_dict({n: x[k] for n, x in parts.items()})
                self.layers[dst] = blk

    def drop_unheld(self) -> None:
        self.hold_layers(self.held)

    def forward(self, embeds, positions, *, attn_mask=None,
                cache: Optional[Cache] = None,
                cache_index: Optional[int] = None, use_flash: bool = False,
                remat: bool = False, remat_policy: Optional[str] = None,
                lora=None, lora_scaling: float = 1.0, cp=None,
                layers: Optional[range] = None, final_norm: bool = True):
        """embeds [B, S, D]; positions [B, S] (RoPE); attn_mask [B, T] bool
        validity of key slots (T = S without a cache, else the cache
        length), combined with causality over positions (no cache) or over
        cache slots (with a cache: the query at slot cache_index + i sees
        slots <= its own). `cache_index` is a Python int (the prefill's 0,
        and every slot of the pass in a row), or a device tensor: [B] first
        slots, or [B, S] slots, one row at a time, so that nothing of the
        step is read back to the host and the step can be captured in a CUDA
        graph. `remat` checkpoints every block of a no-cache
        pass with `remat_policy`. `lora`: optional `models.lora.LoraAdapters`,
        applied per block with `lora_scaling` (alpha / r). `cp`: an
        `ops.ring_attention.ContextParallel`; a no-cache pass then holds this
        rank's shard of the sequence (embeds, positions and attn_mask [B,
        S / n_seq]) and its attention is the ring, on the flash route
        (kernels 2, 5, 6) with `use_flash`, else on the plain one with the
        key mask; causality over array order (right-padded batches).
        `layers`: run only these blocks (a pipeline stage's; None: all);
        `final_norm`: end with the final RMSNorm.
        Returns (hidden [B, S, D], cache)."""
        cfg = self.cfg
        b, s, _ = embeds.shape
        h = embeds.to(self.precision.compute_dtype)
        cos, sin = rope_tables(cfg, positions)
        on_device = torch.is_tensor(cache_index)
        if on_device:
            # [B] first slots (row b writes slots index[b] .. + s - 1) or
            # [B, s] slots: the blocks take [B, s]
            cache_index = cache_index.reshape(b, -1) + (
                torch.arange(s, device=h.device)
                if cache_index.dim() == 1 else 0)
        ring = None
        if cp is not None and cache is None:
            flash, group_ring = use_flash, cp.ring
            keys = None if flash else [attn_mask]

            def ring(q, k, v):
                return ring_attention([q], [k], [v], ring=group_ring,
                                      causal=True, kv_masks=keys,
                                      flash=flash)[0]
        flash_ok = use_flash and s > 1 and (
            cache is None or (not on_device and cache_index == 0))
        mask = None
        if not flash_ok and ring is None:
            if cache is None:
                causal = positions[:, None, :] <= positions[:, :, None]
            else:
                t = cache[0][0].shape[1]
                k_slot = torch.arange(t, device=h.device)
                q_slot = (cache_index if on_device else
                          (cache_index + torch.arange(s, device=h.device))
                          [None].expand(b, s))
                causal = k_slot[None, None, :] <= q_slot[:, :, None]
            mask = causal if attn_mask is None else (
                causal & attn_mask[:, None, :])
        if remat and cache is not None:
            raise ValueError("remat applies to no-cache (training) passes")
        for i in range(len(self.layers)) if layers is None else layers:
            layer = self.layers[i]
            run = _remat(layer, remat_policy) if remat else layer
            h = run(h, cos, sin, mask,
                    None if cache is None else cache[i], cache_index,
                    flash_ok, None if lora is None else lora.layers[i],
                    lora_scaling, ring)
        if final_norm:
            h = rms_norm(h, self.final_norm, cfg.rms_eps)
        return h, cache


def logits_fn(params: LlamaModel, hidden):
    """fp32 logits [B, S, V]; under TP each rank's vocab slice, all-gathered
    (every model rank then holds the whole logits and the same loss)."""
    tp = params.tp_group
    if tp is None:
        return params.lm_head(hidden).float()
    return comm.gather_from(params.lm_head(comm.copy_to(hidden, tp)).float(),
                            -1, tp)


def embed_tokens(params: LlamaModel, input_ids):
    """Token embedding lookup; out-of-range ids (the -200 image token) are
    clamped, and callers overwrite those positions through the splice. Under
    TP each rank looks up the ids of its vocab slice, zeroes the others'
    rows and the slices are summed."""
    weight = params.embed          # one read: one gather under ZeRO-3
    tp = params.tp_group
    ids = input_ids.clamp(0, params.cfg.vocab_size - 1)
    if tp is None:
        return weight[ids].to(params.precision.compute_dtype)
    n_local = weight.shape[0]
    local = ids - comm.rank(tp) * n_local
    own = (local >= 0) & (local < n_local)
    rows = weight[local.clamp(0, n_local - 1)] * own[..., None].to(
        weight.dtype)
    return comm.reduce_from(rows, tp).to(params.precision.compute_dtype)


def init_cache(cfg: LlamaConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None,
               quant: Optional[str] = None) -> Cache:
    """KV cache: one zeroed (k, v) pair of [B, T, KV, Dh] per layer; with
    `quant="int8"` int8 codes plus fp32 scales [B, T, KV] a layer, `(k, v,
    k_scale, v_scale)`: half the bytes, resident and read at every step."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)
    if quant is None:
        return [(zeros(shape, dtype), zeros(shape, dtype))
                for _ in range(cfg.num_layers)]
    if quant != "int8":
        raise ValueError(f"unknown kv cache quant {quant!r}")
    return [(zeros(shape, torch.int8), zeros(shape, torch.int8),
             zeros(shape[:-1], torch.float32),
             zeros(shape[:-1], torch.float32))
            for _ in range(cfg.num_layers)]


def valid_targets(targets, vocab_size: int, ignore_index: int = -100):
    """[B, S] bool: the targets that count (not ignored, inside the
    vocab)."""
    return ((targets != ignore_index) & (targets >= 0)
            & (targets < vocab_size))


def target_nll(logits, targets, ignore_index: int = -100):
    """(the summed NLL of the valid targets, their count) for targets
    [B, S] aligned with logits [B, S, V] (no shift); fp32 log-softmax."""
    valid = valid_targets(targets, logits.shape[-1], ignore_index)
    safe = torch.where(valid, targets, torch.zeros_like(targets))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()


def causal_lm_loss(logits, labels, ignore_index: int = -100, *,
                   data_group=None):
    """Next-token cross-entropy with IGNORE_INDEX masking (HF shift
    convention, JAX `causal_lm_loss`). Labels outside the vocab are ignored
    too; the log-softmax runs in fp32. Mean over the valid targets; with
    `data_group` (the data axis of a mesh) this rank's sum over the valid
    targets of the whole global batch, so that the ranks' losses sum to the
    global token mean and their gradients to its gradient."""
    nll, count = target_nll(logits[:, :-1], labels[:, 1:], ignore_index)
    if data_group is not None:
        count = comm.all_reduce(count, data_group)
    return nll / count.clamp_min(1)
