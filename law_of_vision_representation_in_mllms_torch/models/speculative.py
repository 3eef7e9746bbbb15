"""Prompt-lookup speculative decoding (counterpart of the JAX package's
`models/speculative.py`): lossless, with no draft model.

Draft G tokens by finding the most recent earlier occurrence of the trailing
bigram in the token history, run ONE cached forward over [current, d_0 ..
d_{G-1}], and accept the longest prefix where the model's own argmax agrees:
the output is greedy decoding's by construction (in fp32; in bf16 the
(G+1)-query forward sums in another order than the one-query step, so an
exact tie of the argmax may resolve the other way). Acceptance is lockstep
over the batch (the minimum over rows), which only under-accepts. The cache
is written speculatively and overwritten where a draft was rejected; the
slot-causal mask keeps slots not yet valid out of sight.

Everything here works on device tensors with static shapes, the history
length `cur_len` included, so that a verify round has no host value in it
and can be captured in a CUDA graph (`models.llava.generate_speculative`).
"""

from __future__ import annotations

import torch

from . import llama as L


def bigram_draft(toks, cur_len, g: int):
    """toks [B, T] history; `cur_len` (int or device scalar) tokens of it
    are known. Returns the G tokens that followed the most recent earlier
    occurrence of the trailing bigram, [B, G]; a row with no match repeats
    its current token (always verified, never wrong: a cold round)."""
    b, t_max = toks.shape
    cur_len = torch.as_tensor(cur_len, device=toks.device)
    last2 = torch.gather(toks, 1, (cur_len - 2 + torch.arange(
        2, device=toks.device))[None].expand(b, 2))
    j = torch.arange(t_max - 1, device=toks.device)
    hit = (toks[:, :-1] == last2[:, :1]) & (toks[:, 1:] == last2[:, 1:2])
    hit = hit & (j[None] < cur_len - 2)
    found = hit.any(dim=1)
    j_best = torch.where(hit, j[None], torch.full_like(j[None], -1)).argmax(
        dim=1)
    src = torch.minimum(j_best[:, None] + 2 + torch.arange(
        g, device=toks.device)[None], cur_len - 1)
    draft = torch.gather(toks, 1, src)
    cur = torch.gather(toks, 1, (cur_len - 1).reshape(1, 1).expand(b, 1))
    return torch.where(found[:, None], draft, cur.expand(b, g))


def pad_after_eos(out, eos_id: int):
    """Greedy emits eos forever after the first eos: replicate that."""
    seen = torch.cumsum((out == eos_id).long(), dim=1) > 0
    prev = torch.cat([torch.zeros_like(seen[:, :1]), seen[:, :-1]], dim=1)
    return out.masked_fill(prev, eos_id)


@torch.inference_mode()
def decode_prompt_lookup(params: L.LlamaModel, input_ids, *,
                         max_new_tokens: int, draft_len: int = 8,
                         eos_id: int = 2, use_flash: bool = False,
                         kv_quant=None):
    """Decoder-only speculative decode of unpadded prompts [B, L] (the rows
    share the length). Returns (tokens [B, max_new_tokens], identical to
    step-by-step greedy and eos-padded, and the number of verification
    rounds). The decoder carries its precision."""
    b, l = input_ids.shape
    g = draft_len
    dev = input_ids.device
    t_max = l + max_new_tokens + g + 2
    toks = torch.zeros((b, t_max), dtype=torch.long, device=dev)
    toks[:, :l] = input_ids
    cache = L.init_cache(params.cfg, b, t_max, params.precision.compute_dtype,
                         dev, quant=kv_quant)
    slots = torch.arange(t_max, device=dev)[None]
    pos = torch.arange(l, device=dev)[None].expand(b, l)
    h, _ = params(L.embed_tokens(params, input_ids), pos,
                  attn_mask=(slots < l).expand(b, t_max), cache=cache,
                  cache_index=0, use_flash=use_flash)
    toks[:, l] = L.logits_fn(params, h[:, -1:])[:, -1].argmax(dim=-1)
    cur_len, rounds = l + 1, 0
    window = torch.arange(g + 1, device=dev)
    while cur_len < l + max_new_tokens:
        cur = toks[:, cur_len - 1:cur_len]
        draft = bigram_draft(toks, cur_len, g)
        inp = torch.cat([cur, draft], dim=1)
        pos = (cur_len - 1 + window)[None].expand(b, g + 1)
        h, _ = params(L.embed_tokens(params, inp), pos,
                      attn_mask=(slots < cur_len + g).expand(b, t_max),
                      cache=cache, cache_index=cur_len - 1)
        y = L.logits_fn(params, h).argmax(dim=-1)
        agree = torch.cumprod((draft == y[:, :g]).long(), dim=1)
        a = int(agree.sum(dim=1).min())
        a = max(min(a, l + max_new_tokens - cur_len - 1), 0)
        toks[:, cur_len:cur_len + g + 1] = y
        cur_len += a + 1
        rounds += 1
    return pad_after_eos(toks[:, l:l + max_new_tokens], eos_id), rounds
