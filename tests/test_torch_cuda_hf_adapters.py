"""The port's HF adapters on the card, with the `transformers` that machine
has: a tiny offline LLaVA-HF snapshot through `llava_hf` and
`hf-vision2seq` on `device="cuda"` against the same adapters on the CPU.

Marked `cuda` (the `cuda_device` fixture skips without a card). Run on a
GPU machine with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_hf_adapters.py

TF32 is off, so both sides compute in full fp32: the texts must be equal
and the loglikelihoods within 1e-3.
"""

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.eval.api import Instance
from law_of_vision_representation_in_mllms_torch.eval.models_registry import (
    build_lmm_by_name)

pytestmark = pytest.mark.cuda

WORDS = ("<unk> <pad> </s> a chat between curious user and an artificial "
         "intelligence assistant the gives helpful detailed polite answers "
         "to questions what is this cat dog red blue USER ASSISTANT describe "
         "image of").split()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _snapshot(folder) -> str:
    """A 2-layer CLIP tower + 2-layer Llama LLaVA-HF with a word-level
    tokenizer, saved with its processor."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import (CLIPImageProcessor, CLIPVisionConfig,
                              LlamaConfig, LlavaConfig,
                              LlavaForConditionalGeneration, LlavaProcessor,
                              PreTrainedTokenizerFast)
    t = Tokenizer(models.WordLevel(vocab={w: i for i, w in enumerate(WORDS)},
                                   unk_token="<unk>"))
    t.pre_tokenizer = pre_tokenizers.Whitespace()
    tok = PreTrainedTokenizerFast(
        tokenizer_object=t, unk_token="<unk>", pad_token="<pad>",
        eos_token="</s>", model_input_names=["input_ids", "attention_mask"])
    tok.add_special_tokens({"additional_special_tokens": ["<image>"]})
    cfg = LlavaConfig(
        vision_config=CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=7),
        text_config=LlamaConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4,
            vocab_size=len(tok) + len(tok.all_special_tokens)),
        image_token_index=tok.convert_tokens_to_ids("<image>"),
        vision_feature_select_strategy="default", vision_feature_layer=-2)
    torch.manual_seed(0)
    path = str(folder / "llava_hf")
    LlavaForConditionalGeneration(cfg).eval().save_pretrained(path)
    LlavaProcessor(
        image_processor=CLIPImageProcessor(
            size={"shortest_edge": 28},
            crop_size={"height": 28, "width": 28}),
        tokenizer=tok, patch_size=7, num_additional_image_tokens=1,
        vision_feature_select_strategy="default").save_pretrained(path)
    return path


@pytest.mark.parametrize("name", ["llava_hf", "hf-vision2seq"])
def test_hf_adapter_on_the_card_matches_the_cpu(cuda_device, tmp_path, name):
    from PIL import Image
    snap = _snapshot(tmp_path)
    img = Image.new("RGB", (28, 28), (120, 40, 200))
    tagged = name == "hf-vision2seq"     # the generic adapter adds no tag
    prompts = ["what is this", "describe the image"]
    if tagged:
        prompts = [f"<image>\n{p}" for p in prompts]
    gen = [Instance("generate_until", {}, i, "t",
                    (p, {"max_new_tokens": 4}), [img])
           for i, p in enumerate(prompts)]
    ll = [Instance("loglikelihood", {}, i, "t", (p, " a red cat"), [img])
          for i, p in enumerate(prompts)]
    out = []
    for device in ("cpu", "cuda"):
        lmm = build_lmm_by_name(name, pretrained=snap, device=device)
        assert next(lmm.model.parameters()).device.type == device
        assert next(lmm.model.parameters()).dtype == torch.float32
        out.append((lmm.generate_until(gen), lmm.loglikelihood(ll)))
    (cpu_texts, cpu_ll), (card_texts, card_ll) = out
    assert card_texts == cpu_texts
    for (lp, greedy), (want, want_greedy) in zip(card_ll, cpu_ll):
        assert np.isfinite(lp) and abs(lp - want) < 1e-3
        assert greedy == want_greedy
