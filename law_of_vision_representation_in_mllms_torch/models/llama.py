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
(QLoRA), gains its rank-r delta.

Training: a no-cache pass takes `remat` / `remat_policy` (the JAX `_remat`):
"block" checkpoints every block (`torch.utils.checkpoint`, non-reentrant),
"dots" checkpoints it selectively, saving the outputs of the block's weight
matmuls and recomputing the rest. `causal_lm_loss` is the JAX loss.
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
from .layers import Dense

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
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(-1e30, dtype=accum_dtype,
                                      device=q.device))
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

    def reset_parameters(self, generator):
        self.rms1.fill_(1.0)
        self.rms2.fill_(1.0)

    def forward(self, h, cos, sin, mask, kv_cache, cache_index,
                use_flash: bool, lora=None, lora_scaling: float = 1.0):
        """`lora`: this block's `models.lora.LoraLayer` or None. Each weight
        product, dense or quantised, gains its rank-r delta on top."""
        cfg = self.cfg
        b, s, _ = h.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

        def mm(x_, name):
            y = getattr(self, name)(x_)
            delta = None if lora is None else lora.delta(
                x_.to(y.dtype), name, lora_scaling)
            return y if delta is None else y + delta

        x = rms_norm(h, self.rms1, cfg.rms_eps)
        q = apply_rope(mm(x, "wq").view(b, s, nh, hd), cos, sin)
        k = apply_rope(mm(x, "wk").view(b, s, nkv, hd), cos, sin)
        v = mm(x, "wv").view(b, s, nkv, hd)
        k_sc = v_sc = None
        if kv_cache is not None:
            ck, cv = kv_cache[:2]
            new = slice(cache_index, cache_index + s)
            if len(kv_cache) == 4:
                # int8 cache: the fresh block is quantised on write
                k_sc, v_sc = kv_cache[2:]
                (ck[:, new], k_sc[:, new]) = quantize_kv(k)
                (cv[:, new], v_sc[:, new]) = quantize_kv(v)
            else:
                ck[:, new] = k
                cv[:, new] = v
            k_all, v_all = ck, cv
        else:
            k_all, v_all = k, v
        if use_flash:
            # right-padded prefill over the local K/V (kernel 2's contract)
            attn = flash_attention(q, k, v, causal=True)
        elif s == 1 and k_all.shape[1] > 1:
            attn = decode_attention(q, k_all, v_all, mask[:, 0], k_sc, v_sc)
        else:
            attn = _attention(q, k_all, v_all, mask,
                              self.precision.accum_dtype, k_sc, v_sc)
        h = h + mm(attn.reshape(b, s, nh * hd), "wo")
        x = rms_norm(h, self.rms2, cfg.rms_eps)
        return h + mm(F.silu(mm(x, "gate")) * mm(x, "up"), "down")


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

    def reset_parameters(self, generator):
        self.embed.normal_(0.0, INIT_STD, generator=generator)
        self.final_norm.fill_(1.0)

    def forward(self, embeds, positions, *, attn_mask=None,
                cache: Optional[Cache] = None,
                cache_index: Optional[int] = None, use_flash: bool = False,
                remat: bool = False, remat_policy: Optional[str] = None,
                lora=None, lora_scaling: float = 1.0):
        """embeds [B, S, D]; positions [B, S] (RoPE); attn_mask [B, T] bool
        validity of key slots (T = S without a cache, else the cache
        length), combined with causality over positions (no cache) or over
        cache slots (with a cache: the query at slot cache_index + i sees
        slots <= its own). `remat` checkpoints every block of a no-cache
        pass with `remat_policy`. `lora`: optional `models.lora.LoraAdapters`,
        applied per block with `lora_scaling` (alpha / r). Returns (hidden
        [B, S, D], cache)."""
        cfg = self.cfg
        b, s, _ = embeds.shape
        h = embeds.to(self.precision.compute_dtype)
        cos, sin = rope_tables(cfg, positions)
        flash_ok = use_flash and s > 1 and (cache is None or cache_index == 0)
        mask = None
        if not flash_ok:
            if cache is None:
                causal = positions[:, None, :] <= positions[:, :, None]
            else:
                t = cache[0][0].shape[1]
                k_slot = torch.arange(t, device=h.device)
                q_slot = cache_index + torch.arange(s, device=h.device)
                causal = (k_slot[None, :] <= q_slot[:, None])[None].expand(
                    b, s, t)
            mask = causal if attn_mask is None else (
                causal & attn_mask[:, None, :])
        if remat and cache is not None:
            raise ValueError("remat applies to no-cache (training) passes")
        for i, layer in enumerate(self.layers):
            run = _remat(layer, remat_policy) if remat else layer
            h = run(h, cos, sin, mask,
                    None if cache is None else cache[i], cache_index,
                    flash_ok, None if lora is None else lora.layers[i],
                    lora_scaling)
        return rms_norm(h, self.final_norm, cfg.rms_eps), cache


def logits_fn(params: LlamaModel, hidden):
    return params.lm_head(hidden).float()


def embed_tokens(params: LlamaModel, input_ids):
    """Token embedding lookup; out-of-range ids (the -200 image token) are
    clamped, and callers overwrite those positions through the splice."""
    ids = input_ids.clamp(0, params.embed.shape[0] - 1)
    return params.embed[ids].to(params.precision.compute_dtype)


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


def causal_lm_loss(logits, labels, ignore_index: int = -100):
    """Next-token cross-entropy with IGNORE_INDEX masking (HF shift
    convention, JAX `causal_lm_loss`). Labels outside the vocab are ignored
    too; the log-softmax runs in fp32. Mean over the valid targets."""
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:]
    valid = ((shift_labels != ignore_index) & (shift_labels >= 0)
             & (shift_labels < logits.shape[-1]))
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)
