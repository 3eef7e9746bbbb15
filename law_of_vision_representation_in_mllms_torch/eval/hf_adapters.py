"""Named-model HF adapters with reference prompt-format parity
(counterpart of the JAX package's `eval/hf_adapters.py`).

The fork's adapter zoo (`lmms_eval/models/*.py`) drives THIRD-PARTY torch
models; the generic `hf-vision2seq` adapter covers the mechanics, but the
named adapters differ in prompt shaping — which moves benchmark scores.
This module restores the per-model formats (VERDICT r2 #7):

- **llava_hf** (`lmms_eval/models/llava_hf.py:21-320`): '<image>'
  prepended when the context has none, then the tokenizer's chat template
  (fallback: the vicuna template the reference hardcodes);
  loglikelihood splits template(ctx)+gen-prompt vs template(ctx+cont).
- **instructblip** (`lmms_eval/models/instructblip.py:180-230`): the
  '<image>' tag is STRIPPED (the Q-Former consumes pixels separately);
  bare-text prompts otherwise.
- **qwen_vl** (`lmms_eval/models/qwen_vl.py:52-260`): interleaved
  `tokenizer.from_list_format` query ('<img>path</img>' segments);
  requires the checkpoint's remote code, so the model loads with
  trust_remote_code=True and the prompt construction is exposed for
  testing without the checkpoint.

Every adapter runs its model in fp32 on `device` (the card unless
`device="cpu"` is given; no silent CPU fallback) and moves the processor's
tensors there. `transformers` is imported only when an adapter loads a
snapshot; pass a LOCAL snapshot path (network-free). A `model=` handed in
(tests, a model already in memory) is moved to `device` when it is a
module.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Tuple

from .api import Instance, LMM
from .models_registry import (HFVision2SeqLMM, LMM_REGISTRY,
                              import_transformers, resolve_device)

# `llava_hf.py:24` VICUNA_CHAT_TEMPLATE rendered for one user turn +
# generation prompt (the only shape the harness produces)
VICUNA_SYSTEM = ("A chat between a curious user and an artificial "
                 "intelligence assistant. The assistant gives helpful, "
                 "detailed, and polite answers to the user's questions.")
IMAGE_TOKEN = "<image>"


def _placed(model, device):
    """`model` on `device` when it is a module (a protocol stand-in that
    has no `.to` is used as it is)."""
    return model.to(device) if hasattr(model, "to") else model


def _remote_code(loader: str, pretrained: str, device):
    """(tokenizer, model) of a remote-code checkpoint, fp32 on `device`."""
    import torch
    hf = import_transformers()
    tokenizer = hf.AutoTokenizer.from_pretrained(pretrained,
                                                 trust_remote_code=True)
    model = getattr(hf, loader).from_pretrained(
        pretrained, dtype=torch.float32,
        trust_remote_code=True).eval().to(device)
    return tokenizer, model


class LlavaHFLMM(HFVision2SeqLMM):
    """`lmms_eval/models/llava_hf.py` parity on top of the generic
    vision2seq mechanics."""

    def _chat(self, content: str, continuation: str | None = None) -> str:
        tok = getattr(self.processor, "tokenizer", self.processor)
        tmpl = getattr(tok, "chat_template", None)
        if tmpl:
            messages = [{"role": "user", "content": content}]
            if continuation is None:
                return tok.apply_chat_template(messages, tokenize=False,
                                               add_generation_prompt=True)
            messages.append({"role": "assistant",
                             "content": continuation})
            return tok.apply_chat_template(messages, tokenize=False,
                                           add_generation_prompt=False)
        # vicuna fallback (llava_hf.py:24): "...USER: {c} ASSISTANT:"
        base = f"{VICUNA_SYSTEM} USER: {content} ASSISTANT:"
        if continuation is None:
            return base
        eos = getattr(tok, "eos_token", "") or ""
        return f"{base} {continuation}{eos}"

    def _format(self, context: str, n_images: int) -> str:
        # MME-style prompts carry no image token; prepend one per image
        # (llava_hf.py:275-279)
        if IMAGE_TOKEN not in context and n_images:
            toks = " ".join([IMAGE_TOKEN] * n_images)
            context = f"{toks}\n{context}"
        return context

    def generate_until(self, requests: List[Instance]) -> List[str]:
        import torch
        out = []
        for r in requests:
            n = len(r.visual or [])
            text = self._chat(self._format(r.args[0], n))
            # ALL visuals go to the processor — _format emits one
            # '<image>' per visual and modern processors assert the
            # placeholder/image counts match (llava_hf.py:283 flattens
            # the full visual list)
            inputs = self._inputs(
                text=text, images=list(r.visual) if n else None)
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            with torch.no_grad():
                ids = self.model.generate(
                    **inputs, do_sample=False,
                    max_new_tokens=gen_kwargs.get("max_new_tokens",
                                                  self.max_new_tokens))
            ans = self.processor.batch_decode(
                ids[:, inputs["input_ids"].shape[1]:],
                skip_special_tokens=True)[0].strip()
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in ans:
                    ans = ans.split(stop)[0]
            out.append(ans.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """llava_hf.py:183-230: context = template(ctx)+generation prompt,
        joint = template(ctx, continuation); continuation tokens are the
        joint encoding's suffix past the context encoding."""
        import torch
        out = []
        for r in requests:
            n = len(r.visual or [])
            ctx = self._format(r.args[0], n)
            prompt = self._chat(ctx)
            joint = self._chat(ctx, continuation=r.args[1])
            images = list(r.visual) if n else None
            # BOTH encodings go through the processor (llava_hf.py:205-207):
            # it expands each '<image>' into num_patches image-token ids, so
            # a raw-tokenizer context length would overshoot the
            # continuation slice by (num_patches-1) per image
            ctx_ids = self._inputs(
                text=prompt, images=images)["input_ids"][0].tolist()
            inputs = self._inputs(text=joint, images=images)
            full_ids = inputs["input_ids"][0].tolist()
            k = len(full_ids) - len(ctx_ids)
            if k <= 0:
                out.append((0.0, True))
                continue
            with torch.no_grad():
                logits = self.model(**inputs).logits
            lp = torch.log_softmax(logits[0, -k - 1:-1].float(), dim=-1)
            tgt = torch.tensor(full_ids[-k:], dtype=torch.long,
                               device=lp.device)
            token_lp = lp.gather(1, tgt[:, None])[:, 0]
            greedy = bool((lp.argmax(-1) == tgt).all())
            out.append((float(token_lp.sum()), greedy))
        return out


class InstructBlipLMM(HFVision2SeqLMM):
    """`lmms_eval/models/instructblip.py` parity: the '<image>' tag is
    stripped (the Q-Former takes pixels out of band); prompts otherwise
    reach the text encoder verbatim."""

    @staticmethod
    def _format(context: str) -> str:
        return context.replace(IMAGE_TOKEN, "").strip()

    def generate_until(self, requests: List[Instance]) -> List[str]:
        import torch
        out = []
        for r in requests:
            inputs = self._inputs(
                text=self._format(r.args[0]),
                images=r.visual[0] if r.visual else None)
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            with torch.no_grad():
                ids = self.model.generate(
                    **inputs, do_sample=False,
                    max_new_tokens=gen_kwargs.get("max_new_tokens",
                                                  self.max_new_tokens))
            # instructblip.py:205-210: outputs do not echo the prompt
            ans = self.processor.batch_decode(
                ids, skip_special_tokens=True)[0].strip()
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in ans:
                    ans = ans.split(stop)[0]
            out.append(ans.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        cleaned = [Instance(r.request_type, r.doc, r.doc_id, r.task_name,
                            (self._format(r.args[0]), r.args[1]), r.visual)
                   for r in requests]
        return super().loglikelihood(cleaned)


class FuyuLMM(HFVision2SeqLMM):
    """`lmms_eval/models/fuyu.py` parity. The Fuyu processor appends the
    beginning-of-answer control token (\\x04) after the prompt, so the
    generated continuation IS the text past the prompt ids — the
    reference decodes the whole stream and splits on '\\x04'
    (`fuyu.py:186-209`); slicing the output ids at the prompt length is
    the same cut, robust to tokenizers that render \\x04 differently.

    Prompt protocol (`fuyu.py:186`): the raw context with a trailing
    newline — no chat template, no image token (pixels ride as patch
    embeddings keyed off the processor's |SPEAKER| placeholders)."""

    def __init__(self, pretrained: str | None = None,
                 max_new_tokens: int = 256, model=None, processor=None,
                 device="cuda", **kw):
        if model is not None:
            self.device = resolve_device(device)
            self.model = _placed(model, self.device)
            self.processor = processor
            self.max_new_tokens = max_new_tokens
        else:
            super().__init__(pretrained, max_new_tokens=max_new_tokens,
                             device=device, **kw)

    @staticmethod
    def _format(context: str) -> str:
        # fuyu.py:186: f"{context}\n" — the model was trained with the
        # question ending in a newline before the BOA token
        return f"{context.replace(IMAGE_TOKEN, '').strip()}\n"

    def generate_until(self, requests: List[Instance]) -> List[str]:
        import torch
        out = []
        for r in requests:
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            inputs = self._inputs(
                text=self._format(r.args[0]),
                images=r.visual[0] if r.visual else None)
            with torch.no_grad():
                ids = self.model.generate(
                    **inputs, do_sample=False,
                    max_new_tokens=gen_kwargs.get("max_new_tokens",
                                                  self.max_new_tokens))
            # fuyu.py:208-209: split at BOA, strip spaces and newlines
            ans = self.processor.batch_decode(
                ids[:, inputs["input_ids"].shape[1]:],
                skip_special_tokens=True)[0]
            if "\x04" in ans:
                ans = ans.split("\x04", 1)[1]
            ans = ans.strip(" ").strip("\n")
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in ans:
                    ans = ans.split(stop)[0]
            out.append(ans.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """fuyu.py:221-253 protocol: context f"{ctx}\\n", joint
        f"{ctx}\\n{cont}", score the continuation suffix. Two deliberate
        deviations, both toward the lm-eval convention the rest of the
        zoo follows: (1) the context length is measured WITH the image
        stream (the reference encodes it text-only, so its slice start
        is offset by the image-placeholder run); (2) we return the
        summed continuation logprob, not `outputs.loss` (a mean CE whose
        label mask indexes batch rows, `fuyu.py:239-240`)."""
        import torch
        out = []
        for r in requests:
            img = r.visual[0] if r.visual else None
            ctx_inputs = self._inputs(text=self._format(r.args[0]),
                                      images=img)
            joint = self._format(r.args[0]) + r.args[1]
            inputs = self._inputs(text=joint, images=img)
            k = (inputs["input_ids"].shape[1]
                 - ctx_inputs["input_ids"].shape[1])
            if k <= 0:
                out.append((0.0, True))
                continue
            with torch.no_grad():
                logits = self.model(**inputs).logits
            lp = torch.log_softmax(logits[0, -k - 1:-1].float(), dim=-1)
            tgt = inputs["input_ids"][0, -k:]
            token_lp = lp.gather(1, tgt[:, None])[:, 0]
            out.append((float(token_lp.sum()),
                        bool((lp.argmax(-1) == tgt).all())))
        return out


class Idefics2LMM(HFVision2SeqLMM):
    """`lmms_eval/models/idefics2.py:171-215` parity: one {type:image}
    content entry per visual, then the context text, rendered through the
    processor's chat template with a generation prompt. Checkpoints ship
    the template; `build_prompt` falls back to the rendered idefics2
    form ('User:<image>…<end_of_utterance>\\nAssistant:') when a local
    snapshot lacks one."""

    def __init__(self, pretrained: str | None = None,
                 max_new_tokens: int = 64, model=None, processor=None,
                 device="cuda", **kw):
        if model is not None:
            self.device = resolve_device(device)
            self.model = _placed(model, self.device)
            self.processor = processor
            self.max_new_tokens = max_new_tokens
        else:
            super().__init__(pretrained, max_new_tokens=max_new_tokens,
                             device=device, **kw)

    def build_prompt(self, context: str, n_images: int) -> str:
        # idefics2.py:200-209: images first, context verbatim
        content = [{"type": "image"}] * n_images
        content.append({"type": "text", "text": context})
        messages = [{"role": "user", "content": content}]
        try:
            return self.processor.apply_chat_template(
                messages, add_generation_prompt=True)
        except ValueError:
            imgs = IMAGE_TOKEN * n_images
            return f"User:{imgs}{context}<end_of_utterance>\nAssistant:"

    def generate_until(self, requests: List[Instance]) -> List[str]:
        import torch
        out = []
        for r in requests:
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            visuals = list(r.visual or [])
            prompt = self.build_prompt(r.args[0], len(visuals))
            inputs = self._inputs(text=prompt, images=visuals or None)
            with torch.no_grad():
                ids = self.model.generate(
                    **inputs, do_sample=False,
                    max_new_tokens=gen_kwargs.get("max_new_tokens",
                                                  self.max_new_tokens))
            ans = self.processor.batch_decode(
                ids[:, inputs["input_ids"].shape[1]:],
                skip_special_tokens=True)[0].strip()
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in ans:
                    ans = ans.split(stop)[0]
            out.append(ans.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        # idefics2.py:161-162 parity: the reference adapter does not
        # implement loglikelihood for this model either
        raise NotImplementedError(
            "Loglikelihood is not implemented for Idefics2 model")


class QwenVLLMM(LMM):
    """`lmms_eval/models/qwen_vl.py` parity. The checkpoint ships its own
    modeling/tokenizer code (trust_remote_code); the prompt protocol is
    `tokenizer.from_list_format` over interleaved {image:path}/{text}
    entries. `build_query` is separated out so the format is testable
    without the 9B checkpoint."""

    def __init__(self, pretrained: str | None = None,
                 max_new_tokens: int = 1024, model=None, tokenizer=None,
                 device="cuda", **_):
        self.device = resolve_device(device)
        if model is not None:
            self.model = _placed(model, self.device)
            self.tokenizer = tokenizer
        else:
            self.tokenizer, self.model = _remote_code(
                "AutoModelForCausalLM", pretrained, self.device)
        self.max_new_tokens = max_new_tokens
        self._tmp = tempfile.mkdtemp(prefix="qwen_vl_")

    def build_query(self, context: str, visuals) -> List[dict]:
        """qwen_vl.py:241-251: image entries (as temp file paths) then the
        text; '<image>' placeholders are dropped from the text."""
        query = []
        for i, vis in enumerate(visuals or []):
            path = os.path.join(self._tmp, f"v{i}.png")
            vis.save(path)
            query.append({"image": path})
        query.append({"text": context.replace(IMAGE_TOKEN, "").strip()})
        return query

    def generate_until(self, requests: List[Instance]) -> List[str]:
        """qwen_vl.py:252-283: tokenized from_list_format query through
        model.generate — greedy at temperature 0, gen_kwargs'
        max_new_tokens honored (default 1024), eod as eos/pad."""
        import torch
        out = []
        for r in requests:
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            questions = self.tokenizer.from_list_format(
                self.build_query(r.args[0], r.visual))
            inputs = {k: v.to(self.device) for k, v in self.tokenizer(
                questions, return_tensors="pt").items()}
            temperature = gen_kwargs.get("temperature", 0)
            eod = getattr(self.tokenizer, "eod_id", None)
            pad = getattr(self.tokenizer, "pad_token_id", None)
            with torch.no_grad():
                ids = self.model.generate(
                    inputs["input_ids"],
                    attention_mask=inputs.get("attention_mask"),
                    eos_token_id=eod,
                    pad_token_id=pad if pad is not None else eod,
                    do_sample=temperature > 0,
                    temperature=temperature if temperature > 0 else None,
                    num_beams=gen_kwargs.get("num_beams", 1),
                    max_new_tokens=gen_kwargs.get("max_new_tokens",
                                                  self.max_new_tokens))
            ans = self.tokenizer.decode(
                ids[0, inputs["input_ids"].shape[1]:],
                skip_special_tokens=True)
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in ans:
                    ans = ans.split(stop)[0]
            out.append(ans.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """qwen_vl.py:135-180: logprob of the continuation appended to the
        from_list_format context under the chat wrapping."""
        import torch
        out = []
        for r in requests:
            ctx_q = self.build_query(r.args[0], r.visual)
            full_q = list(ctx_q[:-1]) + [
                {"text": ctx_q[-1]["text"] + r.args[1]}]
            ctx_ids = self.tokenizer(
                self.tokenizer.from_list_format(ctx_q))["input_ids"]
            full_text = self.tokenizer.from_list_format(full_q)
            full = {k: v.to(self.device) for k, v in self.tokenizer(
                full_text, return_tensors="pt").items()}
            k = full["input_ids"].shape[1] - len(ctx_ids)
            if k <= 0:
                out.append((0.0, True))
                continue
            with torch.no_grad():
                logits = self.model(**full).logits
            lp = torch.log_softmax(logits[0, -k - 1:-1].float(), dim=-1)
            tgt = full["input_ids"][0, -k:]
            token_lp = lp.gather(1, tgt[:, None])[:, 0]
            out.append((float(token_lp.sum()),
                        bool((lp.argmax(-1) == tgt).all())))
        return out


class MiniCPMVLMM(LMM):
    """`lmms_eval/models/minicpm_v.py:182-215` parity: '<image>' stripped,
    single image via the checkpoint's `model.chat(image=..., msgs=[user],
    context=None, tokenizer=..., sampling=False)` remote-code API."""

    def __init__(self, pretrained: str | None = None,
                 max_new_tokens: int = 1024, model=None, tokenizer=None,
                 device="cuda", **_):
        self.device = resolve_device(device)
        if model is not None:
            self.model = _placed(model, self.device)
            self.tokenizer = tokenizer
        else:
            self.tokenizer, self.model = _remote_code(
                "AutoModel", pretrained, self.device)
        self.max_new_tokens = max_new_tokens

    def generate_until(self, requests: List[Instance]) -> List[str]:
        out = []
        for r in requests:
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            context = r.args[0].replace(IMAGE_TOKEN, "").strip()
            response, _ctx, _ = self.model.chat(
                image=r.visual[0] if r.visual else None,
                msgs=[{"role": "user", "content": context}],
                context=None, tokenizer=self.tokenizer, sampling=False,
                temperature=0,
                max_new_tokens=gen_kwargs.get("max_new_tokens",
                                              self.max_new_tokens))
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in response:
                    response = response.split(stop)[0]
            out.append(response.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        raise NotImplementedError(
            "minicpm_v exposes only the chat API (the reference adapter "
            "has the same limitation, `minicpm_v.py:120-140`)")


class Phi3VLMM(HFVision2SeqLMM):
    """`lmms_eval/models/phi3v.py:180-230` parity: '<image>' becomes
    '<|image_1|>' (prepended when absent), chat template applied, one
    image per prompt through the remote-code processor."""

    def __init__(self, pretrained: str, max_new_tokens: int = 1024,
                 device="cuda", **_):
        import torch
        hf = import_transformers()
        self.device = resolve_device(device)
        self.processor = hf.AutoProcessor.from_pretrained(
            pretrained, trust_remote_code=True)
        self.model = hf.AutoModelForCausalLM.from_pretrained(
            pretrained, dtype=torch.float32,
            trust_remote_code=True).eval().to(self.device)
        self.max_new_tokens = max_new_tokens

    def _format(self, context: str, has_image: bool = True) -> str:
        if not has_image:
            # text-only request: an unmatched '<|image_1|>' placeholder
            # with images=None makes the remote-code processor raise
            query = context.replace(IMAGE_TOKEN, "").strip()
        elif IMAGE_TOKEN in context:
            query = context.replace(IMAGE_TOKEN, "<|image_1|>")
        else:
            query = f"<|image_1|>\n{context}"
        tok = getattr(self.processor, "tokenizer", self.processor)
        return tok.apply_chat_template(
            [{"role": "user", "content": query}], tokenize=False,
            add_generation_prompt=True)

    def generate_until(self, requests: List[Instance]) -> List[str]:
        import torch
        out = []
        for r in requests:
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            inputs = self._inputs(
                text=self._format(r.args[0], has_image=bool(r.visual)),
                images=[r.visual[0]] if r.visual else None)
            with torch.no_grad():
                ids = self.model.generate(
                    **inputs, do_sample=False,
                    max_new_tokens=gen_kwargs.get("max_new_tokens",
                                                  self.max_new_tokens))
            ans = self.processor.batch_decode(
                ids[:, inputs["input_ids"].shape[1]:],
                skip_special_tokens=True)[0].strip()
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in ans:
                    ans = ans.split(stop)[0]
            out.append(ans.strip())
        return out


class XComposer2LMM(LMM):
    """`lmms_eval/models/xcomposer2_4KHD.py:142-200` parity: the
    [UNUSED_TOKEN_146]user/assistant wrapper, then the checkpoint's own
    chat API (its remote code owns the HD patch transform the reference
    re-implements inline)."""

    TMPL = ("[UNUSED_TOKEN_146]user\n{q}[UNUSED_TOKEN_145]\n"
            "[UNUSED_TOKEN_146]assistant\n")

    def __init__(self, pretrained: str | None = None,
                 max_new_tokens: int = 1024, model=None, tokenizer=None,
                 device="cuda", **_):
        self.device = resolve_device(device)
        if model is not None:
            self.model = _placed(model, self.device)
            self.tokenizer = tokenizer
        else:
            self.tokenizer, self.model = _remote_code(
                "AutoModel", pretrained, self.device)
        self.max_new_tokens = max_new_tokens

    def generate_until(self, requests: List[Instance]) -> List[str]:
        out = []
        for r in requests:
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            context = r.args[0].replace(IMAGE_TOKEN, "").strip()
            if "[UNUSED_TOKEN_146]" not in context:
                context = self.TMPL.format(q=context)
            response, _ = self.model.chat(
                self.tokenizer, query=context,
                image=r.visual[0] if r.visual else None,
                do_sample=False,
                max_new_tokens=gen_kwargs.get("max_new_tokens",
                                              self.max_new_tokens))
            for stop in gen_kwargs.get("until", []) or []:
                if stop and stop in response:
                    response = response.split(stop)[0]
            out.append(response.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        raise NotImplementedError(
            "xcomposer2 exposes only the chat API (the reference adapter "
            "scores generate-only tasks)")


# named registrations override the generic aliases
LMM_REGISTRY["fuyu"] = FuyuLMM
LMM_REGISTRY["idefics2"] = Idefics2LMM
LMM_REGISTRY["llava_hf"] = LlavaHFLMM
LMM_REGISTRY["instructblip"] = InstructBlipLMM
LMM_REGISTRY["qwen_vl"] = QwenVLLMM
LMM_REGISTRY["minicpm_v"] = MiniCPMVLMM
LMM_REGISTRY["phi3v"] = Phi3VLMM
LMM_REGISTRY["xcomposer2_4khd"] = XComposer2LMM
LMM_REGISTRY["xcomposer2"] = XComposer2LMM
