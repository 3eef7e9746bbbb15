"""LLaVA-1.5: tower(s) -> concat -> mm_projector -> splice -> LLaMA
(counterpart of the JAX package's `models/llava.py`, serving and training).

- `init_params` builds the model's weights directly on the target device in
  the param dtype and fills them from one `torch.Generator`;
- `encode_images` runs the ViT tower(s) (kernel 1) under `torch.no_grad()`
  (the JAX `stop_gradient`: towers never train), passes precomputed features
  of a feature pseudo-tower through, concatenates channels and applies the
  projector; `dump_image_embeds` is the A-score hook;
- `loss_fn` is the training loss: splice, decoder (kernel 2 forward and
  kernels 5/6 backward on the flash route, optional remat), causal LM loss;
  with `LlavaParams.lora` set the decoder runs with the rank-r adapters
  (`models/lora.py`), and `models/switch.py` holds the switch variant's loss;
- `generate_greedy` is `prefill` (kernel 2) + a Python loop of
  `decode_step`s (kernel 3) over a per-layer KV cache, int8 under
  `LlavaConfig.kv_quant`. A decoder whose weights `ops.quant.
  quantize_decoder` has quantised runs through the same functions.

Not ported yet: `visual_keep` pruning, MoF and perceiver projectors,
context and pipeline parallelism, beam search, sampling and speculative
decoding.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from ..core.precision import DEFAULT_PRECISION, Precision
from ..ops.quant import materialize_quantized
from . import llama as L
from .layers import init_weights
from .projector import Projector
from .splice import IGNORE_INDEX, splice_embeds, splice_plan
from .towers import TowerEntry, TowerSpec, parse_tower_spec
from .vit import ViTTower


@dataclasses.dataclass(frozen=True)
class LlavaConfig:
    tower_spec: TowerSpec
    decoder: L.LlamaConfig
    projector_type: str = "mlp2x_gelu"
    select_layer: int = -2
    select_feature: str = "patch"
    # KV-cache quantisation for generation ("int8" | None): int8 codes and
    # per-(slot, head) scales (`ops.quant.quantize_kv`) halve the cache's
    # bytes, resident and read by every decode step (kernel 3's int8
    # branch). The weights are untouched; None is the exact bf16 cache.
    kv_quant: Optional[str] = None

    @classmethod
    def build(cls, tower: str, decoder: Optional[L.LlamaConfig] = None,
              **kw) -> "LlavaConfig":
        return cls(tower_spec=parse_tower_spec(tower),
                   decoder=decoder or L.vicuna_7b(), **kw)

    @property
    def num_patches(self) -> int:
        """Image-token count the splice sees."""
        return self.tower_spec.num_patches


def _select_feature(cfg: LlavaConfig, entry: TowerEntry) -> str:
    # SigLIP has no CLS token; the reference forces 'cls_patch'
    # (`siglip_encoder.py:15`), i.e. keep all tokens
    if entry.vit_family == "siglip":
        return "cls_patch"
    return cfg.select_feature


class LlavaParams(nn.Module):
    """The weights of one LLaVA: `towers` (one ViTTower per spec entry; an
    `nn.Identity` holds the place of a feature pseudo-tower, which has no
    weights), `projector` and `decoder` — the JAX params tree's three
    subtrees — and the two optional ones of the training variants: `lora`
    (`models.lora.LoraAdapters`) and `switch` (`models.switch.Switch`), None
    until a caller sets them."""

    def __init__(self, cfg: LlavaConfig,
                 precision: Precision = DEFAULT_PRECISION, *, device=None,
                 decoder_device=None):
        super().__init__()
        self.towers = nn.ModuleList(
            ViTTower(e.vit_config, cfg.select_layer, _select_feature(cfg, e),
                     precision, device=device) if e.kind == "vit"
            else nn.Identity()
            for e in cfg.tower_spec.entries)
        self.projector = Projector(cfg.projector_type,
                                   cfg.tower_spec.mm_hidden_size,
                                   cfg.decoder.hidden_size, precision,
                                   device=device)
        self.decoder = L.LlamaModel(cfg.decoder, precision,
                                    device=decoder_device or device)
        self.register_module("lora", None)
        self.register_module("switch", None)


def init_params(generator: torch.Generator, cfg: LlavaConfig,
                precision: Precision = DEFAULT_PRECISION,
                device=None, *, quantize_bits: Optional[int] = None,
                decoder_weights=None) -> LlavaParams:
    """Random weights, seeded by `generator` (which must live on `device`'s
    type), allocated and sampled directly on `device` in the param dtype.

    `quantize_bits` (4 or 8) builds the decoder's matmul weights quantised,
    one block at a time (`ops.quant.materialize_quantized`): the same draws
    in the same order, and the same codes and scales, as `init_params`
    followed by `quantize_decoder`, without the dense decoder ever being
    whole on `device`. `decoder_weights` (a decoder state dict) then gives
    those matmuls their dense weights before they are quantised."""
    if not quantize_bits:
        params = LlavaParams(cfg, precision, device=device)
        init_weights(params, generator)
        return params.eval()
    params = LlavaParams(cfg, precision, device=device, decoder_device="meta")
    init_weights(params.towers, generator)
    init_weights(params.projector, generator)
    materialize_quantized(params.decoder, generator, device,
                          bits=quantize_bits, dense_weights=decoder_weights)
    return params.eval()


def encode_images(params: LlavaParams, cfg: LlavaConfig,
                  pixel_values: List[torch.Tensor]) -> torch.Tensor:
    """pixel_values: one NHWC tensor per tower entry (precomputed features
    [B, P, C] for a feature pseudo-tower). Returns projected features
    [B, P, D_llm] in the compute dtype. The towers run without autograd:
    they are frozen in every stage."""
    cd = params.decoder.precision.compute_dtype
    with torch.no_grad():
        feats = [tower(px).to(cd) for tower, px in zip(params.towers,
                                                       pixel_values)]
    cat = torch.cat(feats, dim=-1) if len(feats) > 1 else feats[0]
    return params.projector(cat)


def dump_image_embeds(params: LlavaParams, cfg: LlavaConfig, pixel_values):
    """A-score hook: the post-projector per-image embeddings
    (`llava_arch.py:229-248,475-476`)."""
    return encode_images(params, cfg, pixel_values)


def loss_fn(params: LlavaParams, cfg: LlavaConfig,
            batch: Dict[str, torch.Tensor], *, remat: bool = False,
            remat_policy: Optional[str] = None, use_flash: bool = False,
            lora_scaling: float = 1.0, cp=None, pp=None):
    """Training loss (JAX `loss_fn`). batch: input_ids [B, L] (with -200
    image slots), labels [B, L], text_mask [B, L] bool, pixel_values: a list
    of NHWC tensors (or feature tensors) per tower entry. `use_flash` runs
    the decoder's attention through kernel 2 forward and kernels 5/6
    backward; the spliced batch is right-padded, as they require. With
    `params.lora` set the decoder runs with the adapters applied at
    `lora_scaling` (alpha / r; the reference's peft-LoRA finetune). Context
    (`cp`) and pipeline (`pp`) parallelism are not ported."""
    if cp is not None or pp is not None:
        raise NotImplementedError(
            "context and pipeline parallelism are not ported to the PyTorch "
            "package yet (ROADMAP, queue 1: 10, parallelism)")
    dec = params.decoder
    plan = splice_plan(batch["input_ids"], batch["labels"],
                       batch["text_mask"], cfg.num_patches)
    img = encode_images(params, cfg, batch["pixel_values"])
    txt = L.embed_tokens(dec, batch["input_ids"])
    embeds = splice_embeds(plan, txt, img)
    h, _ = dec(embeds, plan.positions, attn_mask=plan.attn_mask,
               use_flash=use_flash, remat=remat, remat_policy=remat_policy,
               lora=params.lora, lora_scaling=lora_scaling)
    return L.causal_lm_loss(L.logits_fn(dec, h), plan.labels)


@dataclasses.dataclass
class Prefill:
    """What a prefill leaves for the decode loop."""
    logits: torch.Tensor      # [B, V] fp32, at each row's last valid slot
    cache: L.Cache
    slot_valid: torch.Tensor  # [B, T] bool: prompt validity, gen slots off
    n_valid: torch.Tensor     # [B] valid prompt length (next RoPE position)
    l_out: int                # spliced prompt length (first gen slot)


@torch.inference_mode()
def prefill(params: LlavaParams, cfg: LlavaConfig, input_ids, text_mask,
            pixel_values, *, max_new_tokens: int) -> Prefill:
    """Tower + projector + splice + decoder prefill into a fresh cache of
    l_out + max_new_tokens slots. The spliced batch is right-padded, which
    is the flash prefill's contract (kernel 2 takes no padding mask)."""
    dec = params.decoder
    b = input_ids.shape[0]
    plan = splice_plan(input_ids, torch.full_like(input_ids, IGNORE_INDEX),
                       text_mask, cfg.num_patches)
    img = encode_images(params, cfg, pixel_values)
    txt = L.embed_tokens(dec, input_ids)
    embeds = splice_embeds(plan, txt, img)
    l_out = embeds.shape[1]
    cache = L.init_cache(cfg.decoder, b, l_out + max_new_tokens,
                         dec.precision.compute_dtype, embeds.device,
                         quant=cfg.kv_quant)
    slot_valid = torch.cat(
        [plan.attn_mask,
         torch.zeros((b, max_new_tokens), dtype=torch.bool,
                     device=embeds.device)], dim=1)
    h, cache = dec(embeds, plan.positions, attn_mask=slot_valid, cache=cache,
                   cache_index=0, use_flash=True)
    # the last VALID position's logits seed generation (right padding)
    n_valid = plan.attn_mask.sum(dim=1)
    last = (n_valid - 1).clamp_min(0)
    h_last = h[torch.arange(b, device=h.device), last]
    logits = L.logits_fn(dec, h_last)
    return Prefill(logits=logits, cache=cache, slot_valid=slot_valid,
                   n_valid=n_valid, l_out=l_out)


@torch.inference_mode()
def decode_step(params: LlavaParams, pre: Prefill, tok, t: int):
    """Generation step t after `prefill`: token `tok` [B] goes into cache
    slot l_out + t at RoPE position n_valid + t (slots and positions differ
    by the prompt's pad slots, which stay masked). Returns the next-token
    logits [B, V] in fp32."""
    dec = params.decoder
    slot = pre.l_out + t
    pre.slot_valid[:, slot] = True
    h, _ = dec(L.embed_tokens(dec, tok[:, None]), (pre.n_valid + t)[:, None],
               attn_mask=pre.slot_valid, cache=pre.cache, cache_index=slot)
    return L.logits_fn(dec, h)[:, -1]


@torch.inference_mode()
def generate_greedy(params: LlavaParams, cfg: LlavaConfig, input_ids,
                    text_mask, pixel_values, *, max_new_tokens: int,
                    eos_id: int) -> torch.Tensor:
    """Greedy decode. Returns [B, max_new_tokens] token ids, eos-padded.

    Same tokens as the JAX `generate_greedy`: the first token comes from the
    prefill; once a row has emitted `eos_id` every later token of that row
    is `eos_id`. The loop stops as soon as every row is done, or before the
    forward whose result would not be returned."""
    pre = prefill(params, cfg, input_ids, text_mask, pixel_values,
                  max_new_tokens=max_new_tokens)
    b = input_ids.shape[0]
    tok = pre.logits.argmax(dim=-1)
    out = torch.full((b, max_new_tokens), eos_id, dtype=torch.long,
                     device=tok.device)
    done = torch.zeros(b, dtype=torch.bool, device=tok.device)
    for t in range(max_new_tokens):
        out[:, t] = tok
        done |= tok == eos_id
        if t == max_new_tokens - 1 or bool(done.all()):
            break
        nxt = decode_step(params, pre, tok, t).argmax(dim=-1)
        tok = torch.where(done, torch.full_like(nxt, eos_id), nxt)
    return out
