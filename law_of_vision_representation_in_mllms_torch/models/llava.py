"""LLaVA-1.5: tower(s) -> concat -> mm_projector -> splice -> LLaMA
(counterpart of the JAX package's `models/llava.py`, serving and training).

- `init_params` builds the model's weights directly on the target device in
  the param dtype and fills them from one `torch.Generator`;
- `encode_images` runs the ViT tower(s) (kernel 1) and the diffusion
  towers (`models/tower_runtime.py`: the VAE encoder and one UNet pass,
  kernel 2, deterministic, configured by `LlavaConfig.featurizer_overrides`)
  under `torch.no_grad()` (the JAX `stop_gradient`: towers never train),
  passes precomputed features of a feature pseudo-tower through,
  concatenates channels and applies the projector; `dump_image_embeds` is
  the A-score hook. The JAX functions take the diffusion apply as an
  argument; every caller builds the same one from the config, so here
  `encode_images` builds it;
- `loss_fn` is the training loss: splice, decoder (kernel 2 forward and
  kernels 5/6 backward on the flash route, optional remat), causal LM loss;
  with `LlavaParams.lora` set the decoder runs with the rank-r adapters
  (`models/lora.py`), and `models/switch.py` holds the switch variant's loss;
- `generate_greedy` is `prefill` (kernel 2) + a Python loop of
  `decode_step`s (kernel 3) over a per-layer KV cache, int8 under
  `LlavaConfig.kv_quant`; with a generator (or given noise) and a
  temperature it samples (`generate_sample`, `models/sampling.py`). A
  decoder whose weights `ops.quant.quantize_decoder` has quantised runs
  through the same functions. `models/decode.py` runs the same step as
  chunks replayed from CUDA graphs;
- `generate_beam` is HF's beam search over a [B*k] batch, the cache
  reordered by a gather over its batch axis each step;
- `generate_speculative` verifies prompt-lookup drafts (`models/
  speculative.py`), one verify round a captured CUDA graph on the card.

Not ported yet: `visual_keep` pruning, MoF and perceiver projectors, the
DiT and SD3 towers, context and pipeline parallelism.
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
from .sampling import sample_token
from .splice import IGNORE_INDEX, splice_embeds, splice_plan
from .tower_runtime import make_diffusion_apply
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
    # tower name -> the FeaturizerConfig of its bundle (the sidecar), which
    # `encode_images` takes over the tower's preset
    featurizer_overrides: Optional[Dict] = None

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
    """The weights of one LLaVA: `towers` (one ViTTower per ViT entry; an
    `nn.Identity` holds the place of a feature pseudo-tower, which has no
    weights, and of a diffusion tower until `train.runner.build_model` puts
    its bundle's `FeaturizerParams` there), `projector` and `decoder` — the
    JAX params tree's three
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
    [B, P, D_llm] in the compute dtype. A diffusion entry runs
    `tower_runtime.make_diffusion_apply(cfg.featurizer_overrides)`. The
    towers run without autograd: they are frozen in every stage."""
    cd = params.decoder.precision.compute_dtype
    feats = []
    with torch.no_grad():
        for tower, e, px in zip(params.towers, cfg.tower_spec.entries,
                                pixel_values):
            if e.kind == "diffusion":
                f = make_diffusion_apply(cfg.featurizer_overrides)(
                    tower, e, px)
            else:
                f = tower(px)
            feats.append(f.to(cd))
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
            pixel_values, *, max_new_tokens: int,
            cache: Optional[L.Cache] = None) -> Prefill:
    """Tower + projector + splice + decoder prefill into a cache of l_out +
    max_new_tokens slots: a fresh one, or `cache`, zeroed first (so that a
    cache used again gives the bits of a fresh one). The spliced batch is
    right-padded, which is the flash prefill's contract (kernel 2 takes no
    padding mask)."""
    dec = params.decoder
    b = input_ids.shape[0]
    plan = splice_plan(input_ids, torch.full_like(input_ids, IGNORE_INDEX),
                       text_mask, cfg.num_patches)
    img = encode_images(params, cfg, pixel_values)
    txt = L.embed_tokens(dec, input_ids)
    embeds = splice_embeds(plan, txt, img)
    l_out = embeds.shape[1]
    if cache is None:
        cache = L.init_cache(cfg.decoder, b, l_out + max_new_tokens,
                             dec.precision.compute_dtype, embeds.device,
                             quant=cfg.kv_quant)
    else:
        if cache[0][0].shape[:2] != (b, l_out + max_new_tokens):
            raise ValueError(f"prefill: a cache of {tuple(cache[0][0].shape[:2])}"
                             f" [B, T] slots for B={b}, T={l_out} + "
                             f"{max_new_tokens}")
        for layer in cache:
            for x in layer:
                x.zero_()
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
                    eos_id: int, generator: Optional[torch.Generator] = None,
                    temperature: float = 0.0, top_p: float = 1.0,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy decode. Returns [B, max_new_tokens] token ids, eos-padded.

    Same tokens as the JAX `generate_greedy`: the first token comes from the
    prefill; once a row has emitted `eos_id` every later token of that row
    is `eos_id`. The loop stops as soon as every row is done, or before the
    forward whose result would not be returned.

    With `temperature > 0` and a `generator` (or `noise`) it samples
    instead (`models.sampling.sample_token`, see `generate_sample`).
    `noise` [max_new_tokens, B, V] holds the Gumbel draws: row 0 for the
    prefill's token, row t + 1 for step t's (the JAX function's `first_key`
    and `keys[t]`)."""
    sampling = (generator is not None or noise is not None) \
        and temperature > 0

    def next_tok(logits, i):
        if not sampling:
            return logits.argmax(dim=-1)
        return sample_token(logits, generator, temperature, top_p,
                            noise=None if noise is None else noise[i])

    pre = prefill(params, cfg, input_ids, text_mask, pixel_values,
                  max_new_tokens=max_new_tokens)
    b = input_ids.shape[0]
    tok = next_tok(pre.logits, 0)
    out = torch.full((b, max_new_tokens), eos_id, dtype=torch.long,
                     device=tok.device)
    done = torch.zeros(b, dtype=torch.bool, device=tok.device)
    for t in range(max_new_tokens):
        out[:, t] = tok
        done |= tok == eos_id
        if t == max_new_tokens - 1 or bool(done.all()):
            break
        nxt = next_tok(decode_step(params, pre, tok, t), t + 1)
        tok = torch.where(done, torch.full_like(nxt, eos_id), nxt)
    return out


def generate_sample(params: LlavaParams, cfg: LlavaConfig, input_ids,
                    text_mask, pixel_values, *, max_new_tokens: int,
                    eos_id: int, generator: Optional[torch.Generator] = None,
                    temperature: float = 1.0, top_p: float = 1.0,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Temperature / top-p sampling decode: the reference's
    `generate(do_sample=True, temperature=..., top_p=...)`. The draws come
    from `generator` (a `torch.Generator` on the model's device) or from
    `noise` (see `generate_greedy`); `temperature <= 0` is greedy."""
    if generator is None and noise is None and temperature > 0:
        raise ValueError("generate_sample needs a generator or noise")
    return generate_greedy(params, cfg, input_ids, text_mask, pixel_values,
                           max_new_tokens=max_new_tokens, eos_id=eos_id,
                           generator=generator, temperature=temperature,
                           top_p=top_p, noise=noise)


def _top_k(x, k: int):
    """`lax.top_k` over the last axis: the k largest, descending, equal
    values in index order (a stable sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@torch.inference_mode()
def generate_beam(params: LlavaParams, cfg: LlavaConfig, input_ids,
                  text_mask, pixel_values, *, max_new_tokens: int,
                  eos_id: int, num_beams: int,
                  length_penalty: float = 1.0, return_scores: bool = False):
    """Beam-search decode (HF `generate(num_beams=k)`, `early_stopping=
    False`). Returns [B, max_new_tokens] token ids of each row's best beam,
    eos-padded; with `return_scores` also the finished pool's scores [B, k]
    (fp32, best first).

    The bookkeeping is HF's vectorised `_beam_search`, as the JAX function
    has it: each step keeps the top 2k of the k*V continuations; candidates
    that hit a stopping criterion (EOS, or the last step) and rank in the
    top k merge into a [B, k] finished pool by `sum_logprobs /
    gen_len**length_penalty`; the best k unfinished continue; HF's
    early-stop heuristic latches a row's pool. The masks are additive -1e9
    in fp32, as HF's. All k beams of all rows decode as one [B*k] batch
    through the cached step; the prompt's cache is repeated k times after
    the (flash) prefill, and each step reorders it by a gather over its
    batch axis (HF `reorder_cache`)."""
    b = input_ids.shape[0]
    k = num_beams
    steps = max_new_tokens
    pen = float(length_penalty)
    pre = prefill(params, cfg, input_ids, text_mask, pixel_values,
                  max_new_tokens=steps)
    dev = pre.logits.device
    f32 = torch.float32
    logprobs = torch.log_softmax(pre.logits.float(), dim=-1)
    vocab = logprobs.shape[-1]
    kk = 2 * k            # beams_to_keep = max(2, 1 + n_eos) * k, one EOS
    neg = torch.tensor(-1e9, dtype=f32, device=dev)
    top_mask = torch.arange(kk, device=dev) < k   # only top k may finish
    batch_base = torch.arange(b, device=dev)[:, None] * k

    def beam_update(lp_bkv, state, t: int):
        """One bookkeeping step at generated position t (0-based)."""
        run_scores, run_seqs, pool_seqs, pool_scores, pool_fin, unsat = state
        acc = lp_bkv + run_scores[:, :, None]                  # [B, k, V]
        topk_lp, flat = _top_k(acc.reshape(b, k * vocab), kk)
        parent = flat // vocab                                 # [B, 2k]
        tok2k = flat % vocab
        cand_seqs = torch.gather(
            run_seqs, 1, parent[:, :, None].expand(-1, -1, steps)).clone()
        cand_seqs[:, :, t] = tok2k
        hits = (tok2k == eos_id) | (t + 1 >= steps)
        run_lp = topk_lp + hits.to(f32) * neg
        new_run_scores, idx = _top_k(run_lp, k)
        new_run_seqs = torch.gather(
            cand_seqs, 1, idx[:, :, None].expand(-1, -1, steps))
        sel_parent = torch.gather(parent, 1, idx)
        sel_tok = torch.gather(tok2k, 1, idx)
        gen_len = torch.tensor(t + 1, dtype=f32, device=dev)
        norm = topk_lp / (gen_len ** pen)
        did_fin = hits & top_mask[None, :]
        norm = norm + (~unsat).to(f32) * neg
        norm = norm + (~did_fin).to(f32) * neg
        merged_scores = torch.cat([pool_scores, norm], dim=1)
        merged_seqs = torch.cat([pool_seqs, cand_seqs], dim=1)
        merged_fin = torch.cat([pool_fin, did_fin], dim=1)
        new_pool_scores, midx = _top_k(merged_scores, k)
        new_pool_seqs = torch.gather(
            merged_seqs, 1, midx[:, :, None].expand(-1, -1, steps))
        new_pool_fin = torch.gather(merged_fin, 1, midx)
        best_possible = new_run_scores[:, :1] / (gen_len ** pen)
        worst_fin = torch.where(
            new_pool_fin, new_pool_scores.amin(dim=1, keepdim=True), neg)
        new_unsat = unsat & (best_possible > worst_fin).any(dim=-1,
                                                            keepdim=True)
        return ((new_run_scores, new_run_seqs, new_pool_seqs,
                 new_pool_scores, new_pool_fin, new_unsat),
                sel_parent, sel_tok)

    # HF's running-score init: beam 0 at 0, the rest at -1e9, so step 1's
    # top 2k are distinct first tokens of one beam
    run_scores = torch.where(torch.arange(k, device=dev) == 0,
                             torch.zeros((), dtype=f32, device=dev),
                             neg)[None].expand(b, k).contiguous()
    state = (run_scores,
             torch.full((b, k, steps), eos_id, dtype=torch.long, device=dev),
             torch.full((b, k, steps), eos_id, dtype=torch.long, device=dev),
             torch.full((b, k), -1e9, dtype=f32, device=dev),
             torch.zeros((b, k), dtype=torch.bool, device=dev),
             torch.ones((b, 1), dtype=torch.bool, device=dev))
    state, _, tok = beam_update(logprobs[:, None, :].expand(b, k, vocab),
                                state, 0)
    # the k beams of a row share its prompt's cache: B -> B*k (identical
    # copies, so step 1 needs no reorder)
    cache = [tuple(x.repeat_interleave(k, dim=0) for x in layer)
             for layer in pre.cache]
    dec = params.decoder
    prompt_valid = pre.slot_valid[:, :pre.l_out].repeat_interleave(k, dim=0)
    pos = pre.n_valid.repeat_interleave(k)
    gen_slots = torch.arange(steps, device=dev)
    for t in range(steps - 1):
        # forward the token chosen for position t, then the bookkeeping for
        # position t + 1
        valid = torch.cat([prompt_valid, (gen_slots <= t)[None].expand(
            b * k, steps)], dim=1)
        h, _ = dec(L.embed_tokens(dec, tok.reshape(b * k, 1)), pos[:, None],
                   attn_mask=valid, cache=cache, cache_index=pre.l_out + t)
        lp = torch.log_softmax(L.logits_fn(dec, h)[:, -1].float(),
                               dim=-1).reshape(b, k, vocab)
        state, parent, tok = beam_update(lp, state, t + 1)
        rows = (batch_base + parent).reshape(b * k)
        cache = [tuple(x.index_select(0, rows) for x in layer)
                 for layer in cache]
        pos = pos + 1
    # HF finalize: the pool is sorted by score; num_return_sequences=1
    if return_scores:
        return state[2][:, 0], state[3]
    return state[2][:, 0]


def generate_speculative(params: LlavaParams, cfg: LlavaConfig, input_ids,
                         text_mask, pixel_values, *, max_new_tokens: int,
                         eos_id: int, draft_len: int = 8):
    """Greedy-equivalent decode with prompt-lookup speculation (`models/
    speculative.py`) on the full LLaVA path: right-padded ragged batches
    (positions per row, cache slots shared, acceptance the minimum over
    rows). Returns ([B, max_new_tokens] tokens, the number of verification
    rounds).

    A one-off `models.decode.SpeculativeDecoder`: on the card its verify
    round is captured as a CUDA graph and replayed, so a caller that
    decodes more than once keeps a decoder (the eval adapter does) and pays
    the capture once a shape."""
    from .decode import SpeculativeDecoder   # models/decode.py imports this
    return SpeculativeDecoder(params, cfg, eos_id=eos_id,
                              draft_len=draft_len).generate(
        input_ids, text_mask, pixel_values, max_new_tokens=max_new_tokens)
