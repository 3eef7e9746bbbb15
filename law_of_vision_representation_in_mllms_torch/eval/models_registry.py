"""Eval model registry (`lmms_eval/api/registry.py` + the per-model adapter
zoo `lmms_eval/models/`); counterpart of the JAX package's
`eval/models_registry.py`.

`register_lmm` adds a builder keyed by name; `build_lmm_by_name(name, ...)`
resolves it. "llava" is the port's own `LlavaLMM` on an explicit `device`;
"hf-vision2seq" wraps any local HF vision2seq checkpoint through PyTorch (the
generic stand-in for the reference's fuyu / idefics2 / instructblip /
qwen_vl adapters, all of which evaluate THIRD-PARTY models); "openai-api"
is a stdlib chat-completions client. The local-model adapters take a
`device` that defaults to the card, as every entry point of the port does,
and run in fp32; without a card they raise unless `device="cpu"` is given.
`transformers` is imported only when such an adapter is built, and its
absence raises an `ImportError` that names it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from .api import Instance, LMM

LMM_REGISTRY: Dict[str, Callable] = {}


def register_lmm(name: str):
    def deco(builder):
        LMM_REGISTRY[name] = builder
        return builder
    return deco


def build_lmm_by_name(name: str, **kwargs) -> LMM:
    from . import hf_adapters  # noqa: F401 — named-adapter registrations
    if name not in LMM_REGISTRY:
        raise KeyError(f"unknown LMM '{name}'; have {sorted(LMM_REGISTRY)}")
    return LMM_REGISTRY[name](**kwargs)


def resolve_device(device):
    """The requested torch device; a CUDA request without a card raises
    instead of falling back to the CPU."""
    import torch
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "adapter on the CPU")
    return device


def import_transformers():
    """The `transformers` module, or an ImportError that names it: the
    local-model adapters need it, and the card's machine may lack it."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError(
            f"the HF adapters need the `transformers` package, which is not "
            f"installed ({e})") from None
    return transformers


def vision2seq_class(hf):
    """`AutoModelForVision2Seq`, or where a newer `transformers` has dropped
    it (5.x), `AutoModelForImageTextToText`, which maps the same
    architectures (LLaVA, InstructBLIP, Fuyu, Idefics2)."""
    return getattr(hf, "AutoModelForVision2Seq", None) or \
        hf.AutoModelForImageTextToText


@register_lmm("llava")
def _build_llava(*, params, device="cuda", **kwargs) -> LMM:
    """The port's `LlavaLMM` over `params` moved to `device`."""
    from .llava_adapter import LlavaLMM
    return LlavaLMM(params.to(resolve_device(device)), **kwargs)


@register_lmm("hf-vision2seq")
class HFVision2SeqLMM(LMM):
    """Generic HF adapter: local AutoModelForVision2Seq + AutoProcessor in
    fp32 on `device`. Network-free: pass a local snapshot path."""

    def __init__(self, pretrained: str, max_new_tokens: int = 16,
                 device="cuda", **_):
        import torch
        hf = import_transformers()
        self.device = resolve_device(device)
        self.processor = hf.AutoProcessor.from_pretrained(pretrained)
        self.model = vision2seq_class(hf).from_pretrained(
            pretrained, dtype=torch.float32).eval().to(self.device)
        self.max_new_tokens = max_new_tokens

    def _inputs(self, **kwargs):
        """The processor's tensors on the adapter's device."""
        return self.processor(return_tensors="pt", **kwargs).to(self.device)

    def generate_until(self, requests: List[Instance]) -> List[str]:
        import torch
        out = []
        for r in requests:
            inputs = self._inputs(
                text=r.args[0], images=r.visual[0] if r.visual else None)
            with torch.no_grad():
                ids = self.model.generate(
                    **inputs,
                    max_new_tokens=r.args[1].get("max_new_tokens",
                                                 self.max_new_tokens))
            text = self.processor.batch_decode(
                ids[:, inputs["input_ids"].shape[1]:],
                skip_special_tokens=True)[0]
            out.append(text.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        """Continuation logprob + greedy-match flag, lm-eval convention:
        the continuation tokens are `enc(ctx+cont)[len(enc(ctx)):]` — the
        SUFFIX of the joint encoding, not an independent `enc(cont)`
        (BPE can merge across the boundary; the reference slices the same
        way, `lmms_eval/models/llava.py:217-283`)."""
        import torch
        tok = getattr(self.processor, "tokenizer", self.processor)
        out = []
        for r in requests:
            ctx, cont = r.args[0], r.args[1]
            ctx_ids = tok(ctx)["input_ids"]
            full_ids = tok(ctx + cont)["input_ids"]
            cont_ids = full_ids[len(ctx_ids):]
            inputs = self._inputs(
                text=ctx + cont, images=r.visual[0] if r.visual else None)
            k = len(cont_ids)
            with torch.no_grad():
                logits = self.model(**inputs).logits
            lp = torch.log_softmax(logits[0, -k - 1:-1].float(), dim=-1)
            tgt = torch.tensor(cont_ids, dtype=torch.long, device=lp.device)
            token_lp = lp.gather(1, tgt[:, None])[:, 0]
            greedy = bool((lp.argmax(-1) == tgt).all())
            out.append((float(token_lp.sum()), greedy))
        return out


@register_lmm("openai-api")
class OpenAIAPILMM(LMM):
    """OpenAI-compatible chat-completions adapter — the reference's API
    model zoo (`lmms_eval/models/gpt4v.py`, `qwen_vl_api.py`,
    `batch_gpt4.py`): text is split on the '<image>' token, images ride as
    base64 PNG data URLs, failures retry with a sleep and fall back to ''.

    Network-free stdlib client (urllib): point `api_url` at any
    OpenAI-style endpoint (tests use a local stub server). It runs nothing
    on a device.
    """

    IMAGE_TOKEN = "<image>"

    def __init__(self, model_version: str = "gpt-4-vision-preview",
                 api_url: str | None = None, api_key: str | None = None,
                 max_new_tokens: int = 1024, retries: int = 5,
                 retry_sleep: float = 5.0, timeout: float = 120.0, **_):
        import os
        self.model_version = model_version
        self.api_url = api_url or os.getenv(
            "OPENAI_API_URL", "https://api.openai.com/v1/chat/completions")
        self.api_key = api_key or os.getenv("OPENAI_API_KEY", "YOUR_API_KEY")
        self.max_new_tokens = max_new_tokens
        self.retries = retries
        self.retry_sleep = retry_sleep
        self.timeout = timeout

    @staticmethod
    def encode_image(image) -> str:
        import base64
        from io import BytesIO
        buf = BytesIO()
        image.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode("utf-8")

    def _payload(self, context: str, visuals, gen_kwargs) -> dict:
        # gpt4v.py:80-110: interleave text segments with the images
        imgs = [self.encode_image(v) for v in (visuals or [])]
        content = []
        segments = (context.split(self.IMAGE_TOKEN)
                    if self.IMAGE_TOKEN in context else [context])
        for i, seg in enumerate(segments):
            if seg:
                content.append({"type": "text", "text": seg})
            if i < len(imgs):
                content.append({"type": "image_url", "image_url": {
                    "url": f"data:image/png;base64,{imgs[i]}"}})
        content += [{"type": "image_url", "image_url": {
            "url": f"data:image/png;base64,{b}"}}
            for b in imgs[len(segments):]]
        return {"model": self.model_version,
                "messages": [{"role": "user", "content": content}],
                "max_tokens": gen_kwargs.get("max_new_tokens",
                                             self.max_new_tokens),
                "temperature": gen_kwargs.get("temperature", 0)}

    def _post(self, payload: dict) -> str:
        import json as _json
        import urllib.request
        req = urllib.request.Request(
            self.api_url, data=_json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json",
                     "Authorization": f"Bearer {self.api_key}"})
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = _json.loads(resp.read().decode("utf-8"))
        # content may legally be null (refusal / tool-call responses)
        return body["choices"][0]["message"]["content"] or ""

    def generate_until(self, requests: List[Instance]) -> List[str]:
        import time
        out = []
        for r in requests:
            gen_kwargs = r.args[1] if len(r.args) > 1 else {}
            text = ""
            for attempt in range(self.retries):
                try:
                    text = self._post(self._payload(r.args[0], r.visual,
                                                    gen_kwargs))
                    break
                except Exception:  # noqa: BLE001 — gpt4v.py retries all
                    if attempt + 1 < self.retries:
                        time.sleep(self.retry_sleep)
            out.append(text.strip())
        return out

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        raise NotImplementedError(
            "chat-completions APIs expose no vision loglikelihoods "
            "(the reference's gpt4v adapter has the same limitation)")


# reference adapter names that resolve to the API client with their model
for _name, _version in (("gpt4v", "gpt-4-vision-preview"),
                        ("qwen-vl-api", "qwen-vl-plus")):
    LMM_REGISTRY[_name] = (
        lambda _v=_version, **kw: OpenAIAPILMM(
            **{"model_version": _v, **kw}))

# Reference local-model adapter names (`lmms_eval/models/*.py`): all get
# named adapters with the reference's prompt formats in `hf_adapters.py`
# (registered on the first `build_lmm_by_name` call, overriding these
# Auto-loading fallbacks).
for _name in ("llava_hf", "instructblip", "fuyu", "idefics2"):
    LMM_REGISTRY[_name] = HFVision2SeqLMM
