"""Our LLaVA model as an evaluation LMM (counterpart of the JAX package's
`eval/llava_adapter.py`; `lmms_eval/models/llava.py:54-447`).

`generate_until`: template-rendered prompts with '<image>' splicing,
per-tower image preprocessing, prompts right-padded to a power-of-two bucket,
as the JAX adapter pads them, and the JAX adapter's routing: `num_beams > 1`
-> `generate_beam`; `temperature > 0` (and `do_sample` not False) ->
`generate_sample` with the adapter's own `torch.Generator`, seeded by
`sample_seed`; otherwise the `gen_backend`: `speculative` (one
`models.decode.SpeculativeDecoder` a run), else greedy. Greedy decoding on
the card always takes the adapter's `models.decode.ChunkedGreedyDecoder`
(chunks replayed from CUDA graphs), whether the backend says `greedy` or
`chunked`: the same tokens, without the host in every step. On the CPU
`greedy` is the eager `generate_greedy` and `chunked` the decoder's eager
chunks. The two decoders share one graph pool. A
request's visual is a PIL image (preprocessed here; PIL is imported only
then) or an HWC float array already preprocessed to the tower's crop size.
`loglikelihood` batches requests sorted by total length into power-of-two
buckets and gathers the continuation's hidden rows before the `lm_head`;
`dump_image_embeds_for_docs` is the A-score embedding dump.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.conversation import IMAGE_PLACEHOLDER, Conversation
from ..data.image_processing import preprocess_image, processor_for_tower
from ..data.preprocess import tokenizer_image_token
from ..models import llama as L
from ..models import llava as M
from ..models.splice import IGNORE_INDEX, splice_embeds, splice_plan
from .api import Instance, LMM

GEN_BACKENDS = ("greedy", "chunked", "speculative")


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class LlavaLMM(LMM):
    def __init__(self, params: M.LlavaParams, cfg: M.LlavaConfig, tokenizer,
                 template: Conversation, *,
                 batch_size: int = 8, pad_square: bool = False,
                 gen_backend: str = "greedy", decode_chunk: int = 16,
                 draft_len: int = 8, sample_seed: int = 0):
        # every backend gives greedy's tokens (the parity tests hold them
        # to each other and to the JAX ones)
        if gen_backend not in GEN_BACKENDS:
            raise ValueError(f"unknown gen_backend {gen_backend!r}; one of "
                             f"{GEN_BACKENDS}")
        self.gen_backend = gen_backend
        self.decode_chunk = decode_chunk
        self.draft_len = draft_len
        self._chunked_dec = None
        self._spec_dec = None
        self._pool = None
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.template = template
        self.batch_size = batch_size
        self.pad_square = pad_square
        self.device = params.decoder.embed.device
        for e in cfg.tower_spec.entries:
            if e.kind == "feature":
                raise ValueError(
                    "precomputed-feature towers are train-only (the eval "
                    "harness feeds images); evaluate with the real tower "
                    f"instead of {e.name}")
        self.processors = [processor_for_tower(e.name, e.img_size)
                           for e in cfg.tower_spec.entries]
        # the sampling stream of gen_kwargs' temperature / top_p (the
        # reference's do_sample routing, lmms_eval/models/llava.py:415-417)
        self._generator = torch.Generator(self.device).manual_seed(
            sample_seed)

    def _prompt(self, context: str) -> str:
        """Prepend the image marker only when the context has none."""
        if IMAGE_PLACEHOLDER in context:
            text = context
        else:
            text = IMAGE_PLACEHOLDER + "\n" + context
        return self.template.prompt_for_generation([("human", text)])

    def _pixel(self, visual, proc) -> np.ndarray:
        if isinstance(visual, np.ndarray):
            if visual.shape != (proc.crop, proc.crop, 3):
                raise ValueError(f"image array must be preprocessed HWC "
                                 f"{(proc.crop, proc.crop, 3)}, got "
                                 f"{visual.shape}")
            return visual.astype(np.float32, copy=False)
        return preprocess_image(visual, proc, pad_square=self.pad_square)

    def _pixels(self, requests: List[Instance]) -> List[torch.Tensor]:
        """Per-tower NHWC batches; a request without an image gets zeros."""
        pixels = []
        for proc in self.processors:
            arrs = [self._pixel(r.visual[0], proc) if r.visual
                    else np.zeros((proc.crop, proc.crop, 3), np.float32)
                    for r in requests]
            pixels.append(torch.from_numpy(np.stack(arrs)).to(self.device))
        for r in requests:
            release = getattr(r.visual, "release", None)
            if release:
                release()          # drop decoded image data (lazy visuals)
        return pixels

    def _encode_batch(self, requests: List[Instance]):
        ids_list = [tokenizer_image_token(self._prompt(r.args[0]), self.tok)
                    for r in requests]
        n = _bucket(max(len(x) for x in ids_list))
        ids = np.zeros((len(requests), n), np.int64)
        mask = np.zeros((len(requests), n), bool)
        for i, x in enumerate(ids_list):
            ids[i, :len(x)] = x
            mask[i, :len(x)] = True
        return (torch.from_numpy(ids).to(self.device),
                torch.from_numpy(mask).to(self.device),
                self._pixels(requests))

    def _graph_pool(self):
        if self.device.type == "cuda" and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def chunked_decoder(self):
        """The run's `ChunkedGreedyDecoder` (made on first use): its static
        tensors and captured graphs, of its most recent keys, live as long
        as the adapter."""
        if self._chunked_dec is None:
            from ..models.decode import ChunkedGreedyDecoder
            self._chunked_dec = ChunkedGreedyDecoder(
                self.params, self.cfg, eos_id=self.tok.eos_token_id,
                chunk=self.decode_chunk, pool=self._graph_pool())
        return self._chunked_dec

    def speculative_decoder(self):
        """The run's `SpeculativeDecoder` (made on first use)."""
        if self._spec_dec is None:
            from ..models.decode import SpeculativeDecoder
            self._spec_dec = SpeculativeDecoder(
                self.params, self.cfg, eos_id=self.tok.eos_token_id,
                draft_len=self.draft_len, pool=self._graph_pool())
        return self._spec_dec

    def _generate(self, ids, mask, pixels, kwargs) -> torch.Tensor:
        """One batch's tokens, routed as the JAX adapter routes them."""
        max_new = kwargs.get("max_new_tokens", 16)
        eos = self.tok.eos_token_id
        # reference contract: do_sample iff temperature > 0
        # (lmms_eval/models/llava.py:391-417)
        temperature = float(kwargs.get("temperature", 0) or 0)
        if not kwargs.get("do_sample", True):
            temperature = 0.0
        # top_p None -> 1.0, but an explicit 0.0 is honoured (the top token
        # only)
        top_p = (1.0 if kwargs.get("top_p") is None
                 else float(kwargs["top_p"]))
        num_beams = int(kwargs.get("num_beams", 1) or 1)
        common = dict(max_new_tokens=max_new, eos_id=eos)
        if num_beams > 1:        # deterministic: beams win over temperature
            return M.generate_beam(self.params, self.cfg, ids, mask, pixels,
                                   num_beams=num_beams, **common)
        if temperature > 0:      # sampling whatever the backend
            return M.generate_sample(self.params, self.cfg, ids, mask,
                                     pixels, generator=self._generator,
                                     temperature=temperature, top_p=top_p,
                                     **common)
        if self.gen_backend == "speculative":
            return self.speculative_decoder().generate(
                ids, mask, pixels, max_new_tokens=max_new)[0]
        if self.gen_backend == "chunked" or self.device.type == "cuda":
            return self.chunked_decoder().generate(ids, mask, pixels,
                                                   max_new_tokens=max_new)
        return M.generate_greedy(self.params, self.cfg, ids, mask, pixels,
                                 **common)

    def generate_until(self, requests: List[Instance]) -> List[str]:
        out: List[str] = []
        for s in range(0, len(requests), self.batch_size):
            chunk = requests[s:s + self.batch_size]
            kwargs = chunk[0].args[1]
            ids, mask, pixels = self._encode_batch(chunk)
            toks = self._generate(ids, mask, pixels, kwargs).cpu().numpy()
            until = kwargs.get("until", [])
            for row in toks:
                row = row.tolist()
                if self.tok.eos_token_id in row:
                    row = row[:row.index(self.tok.eos_token_id)]
                text = self.tok.decode(row).strip()
                for stop in until:
                    if stop and stop in text:
                        text = text.split(stop)[0]
                out.append(text.strip())
        return out

    @torch.inference_mode()
    def _ll_batch(self, ids, mask, tgt, klen, pixels):
        """Summed continuation log-probs, greedy-match flags and greedy
        margins of one bucket. ids, mask [B, L] (right-padded context +
        continuation); tgt [B, k_max] continuation ids; klen [B]. The
        prefill is kernel 2's right-padded contract, as in
        `generate_until`."""
        dec = self.params.decoder
        plan = splice_plan(ids, torch.full_like(ids, IGNORE_INDEX), mask,
                           self.cfg.num_patches)
        img = M.encode_images(self.params, self.cfg, pixels)
        embeds = splice_embeds(plan, L.embed_tokens(dec, ids), img)
        h, _ = dec(embeds, plan.positions, attn_mask=plan.attn_mask,
                   use_flash=True)
        # continuation tokens are the LAST klen valid positions of each
        # (right-padded) row; their logits sit one position earlier
        # (next-token convention). Gather hidden states BEFORE the lm_head:
        # full-sequence fp32 logits would be [B, L_out, 32000] for k_max
        # useful rows
        k_max = tgt.shape[1]
        steps = torch.arange(k_max, device=ids.device)[None]
        base = plan.attn_mask.sum(dim=1) - klen - 1
        idx = (base[:, None] + steps).clamp(0, h.shape[1] - 1)
        h_sel = torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[2]))
        rows = torch.log_softmax(L.logits_fn(dec, h_sel), dim=-1)
        tok_lp = torch.gather(rows, -1, tgt[..., None])[..., 0]
        jmask = steps < klen[:, None]
        sum_lp = torch.where(jmask, tok_lp, torch.zeros_like(tok_lp)).sum(1)
        greedy = ((rows.argmax(dim=-1) == tgt) | ~jmask).all(dim=1)
        top2 = rows.topk(2, dim=-1).values
        gap = torch.where(jmask, top2[..., 0] - top2[..., 1],
                          torch.full_like(tok_lp, float("inf")))
        return sum_lp, greedy, gap.amin(dim=1)

    def loglikelihood(self, requests: List[Instance]
                      ) -> List[Tuple[float, bool]]:
        return [(lp, greedy) for lp, greedy, _ in self._ll_rows(requests)]

    def _ll_rows(self, requests: List[Instance]
                 ) -> List[Tuple[float, bool, float]]:
        """Per request: summed log-prob, greedy flag and the smallest gap
        between the top two log-probs over its continuation positions (a
        flag whose gap is under a comparison's tolerance may differ between
        two precisions of the same model)."""
        n = len(requests)
        enc = []
        for r in requests:
            ctx_ids = tokenizer_image_token(self._prompt(r.args[0]),
                                            self.tok)
            cont_ids = list(self.tok.encode(r.args[1],
                                            add_special_tokens=False))
            enc.append((ctx_ids, cont_ids))
        # sort by total length so same-bucket requests batch together
        order = sorted(range(n),
                       key=lambda i: len(enc[i][0]) + len(enc[i][1]))
        out: List[Optional[Tuple[float, bool, float]]] = [None] * n
        for s in range(0, n, self.batch_size):
            sel = order[s:s + self.batch_size]
            tot = _bucket(max(len(enc[i][0]) + len(enc[i][1]) for i in sel))
            kmax = _bucket(max(len(enc[i][1]) for i in sel), minimum=8)
            ids = np.zeros((len(sel), tot), np.int64)
            mask = np.zeros((len(sel), tot), bool)
            tgt = np.zeros((len(sel), kmax), np.int64)
            klen = np.zeros((len(sel),), np.int64)
            for row, i in enumerate(sel):
                full = enc[i][0] + enc[i][1]
                ids[row, :len(full)] = full
                mask[row, :len(full)] = True
                tgt[row, :len(enc[i][1])] = enc[i][1]
                klen[row] = len(enc[i][1])
            sum_lp, greedy, margin = (x.cpu().numpy() for x in self._ll_batch(
                *(torch.from_numpy(x).to(self.device)
                  for x in (ids, mask, tgt, klen)),
                self._pixels([requests[i] for i in sel])))
            for row, i in enumerate(sel):
                out[i] = (float(sum_lp[row]), bool(greedy[row]),
                          float(margin[row]))
        return out

    @torch.inference_mode()
    def dump_image_embeds_for_docs(self, requests: List[Instance],
                                   out_dir: str, limit: int = 100) -> int:
        """A-score embedding dump (`A_score/compute.py` protocol: first
        `limit` docs, post-projector embeddings, one request at a time,
        fp32 `.npy`, 1-indexed files)."""
        os.makedirs(out_dir, exist_ok=True)
        n = 0
        for r in requests[:limit]:
            emb = M.dump_image_embeds(self.params, self.cfg,
                                      self._pixels([r]))
            np.save(os.path.join(out_dir, f"tensor_{n + 1}.npy"),
                    emb[0].float().cpu().numpy())
            n += 1
        return n
