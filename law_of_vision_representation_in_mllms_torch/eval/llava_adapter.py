"""Our LLaVA model as an evaluation LMM (counterpart of the JAX package's
`eval/llava_adapter.py`; `lmms_eval/models/llava.py:54-447`).

`generate_until`: template-rendered prompts with '<image>' splicing,
per-tower image preprocessing, greedy decode (`models.llava.generate_greedy`)
with prompts right-padded to a power-of-two bucket, as the JAX adapter pads
them. A request's visual is a PIL image (preprocessed here; PIL is imported
only then) or an HWC float array already preprocessed to the tower's crop
size. Sampling, beam search, the chunked/speculative backends and
`loglikelihood` are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..data.conversation import IMAGE_PLACEHOLDER, Conversation
from ..data.image_processing import preprocess_image, processor_for_tower
from ..data.preprocess import tokenizer_image_token
from ..models import llava as M
from .api import Instance, LMM

_NOT_PORTED = ("{what} is not ported to the PyTorch package yet "
               "(ROADMAP, queue 1: {item})")
_BACKENDS = "6, serving backends"


def _bucket(n: int, minimum: int = 32) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class LlavaLMM(LMM):
    def __init__(self, params: M.LlavaParams, cfg: M.LlavaConfig, tokenizer,
                 template: Conversation, *,
                 batch_size: int = 8, pad_square: bool = False,
                 gen_backend: str = "greedy"):
        if gen_backend != "greedy":
            raise NotImplementedError(_NOT_PORTED.format(
                what=f"gen_backend {gen_backend!r}", item=_BACKENDS))
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.template = template
        self.batch_size = batch_size
        self.pad_square = pad_square
        self.device = params.decoder.embed.device
        self.processors = [processor_for_tower(e.name, e.img_size)
                           for e in cfg.tower_spec.entries]

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

    def generate_until(self, requests: List[Instance]) -> List[str]:
        out: List[str] = []
        for s in range(0, len(requests), self.batch_size):
            chunk = requests[s:s + self.batch_size]
            kwargs = chunk[0].args[1]
            temperature = float(kwargs.get("temperature", 0) or 0)
            if not kwargs.get("do_sample", True):
                temperature = 0.0
            if temperature > 0:
                raise NotImplementedError(_NOT_PORTED.format(
                    what="sampling (temperature > 0)", item=_BACKENDS))
            if int(kwargs.get("num_beams", 1) or 1) > 1:
                raise NotImplementedError(_NOT_PORTED.format(
                    what="beam search", item=_BACKENDS))
            ids, mask, pixels = self._encode_batch(chunk)
            toks = M.generate_greedy(
                self.params, self.cfg, ids, mask, pixels,
                max_new_tokens=kwargs.get("max_new_tokens", 16),
                eos_id=self.tok.eos_token_id).cpu().numpy()
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

    def loglikelihood(self, requests: List[Instance]
                      ) -> List[Tuple[float, bool]]:
        raise NotImplementedError(_NOT_PORTED.format(
            what="loglikelihood", item="4, the rest of the CLI and eval"))
