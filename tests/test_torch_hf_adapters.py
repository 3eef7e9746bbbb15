"""The port's HF adapters (`eval/hf_adapters.py`, `eval/models_registry.py`)
against the JAX package's, on the CPU (`device="cpu"`).

The tiny offline HF checkpoints of `tests/test_hf_adapters.py` (LLaVA-HF,
InstructBLIP as saved snapshots; Fuyu, Idefics2 in memory), each built once
for the module, go through both packages' adapters: the generated texts and
the loglikelihoods must be equal (the same fp32 PyTorch model on the same
inputs). The remote-code adapters (Qwen-VL, MiniCPM-V, XComposer2, Phi-3-V)
meet recording stand-ins, as in the JAX tests, and must hand them the same
calls. Both registries know the same names; an adapter without
`transformers` raises an ImportError naming it, and one asked for the card
without a card raises.
"""

import sys

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.eval import (
    hf_adapters as jhf, models_registry as jreg)
from law_of_vision_representation_in_mllms_tpu.eval.api import (
    Instance as JInstance)
from law_of_vision_representation_in_mllms_torch.eval import (
    hf_adapters as thf, models_registry as treg)
from law_of_vision_representation_in_mllms_torch.eval.api import Instance
from test_hf_adapters import (_img, _tiny_fuyu, _tiny_idefics2,
                              _tiny_llava_hf, _word_tokenizer)

torch.set_num_threads(1)


def _reqs(cls, prompts, kind="generate_until", n_images=1):
    img = _img()
    return [cls(kind, {}, i, "t", p, [img] * n_images)
            for i, p in enumerate(prompts)]


GEN = [("what is this", {"max_new_tokens": 3}),
       ("<image>\ndescribe the image", {"max_new_tokens": 4,
                                         "until": ["cat"]})]
LL = [("what is this", " a cat"), ("describe the image", " red dog")]


def _both(name, gen=GEN, ll=LL, **kw):
    """(port's answers and loglikelihoods, JAX's) of the adapter `name`
    built with `kw`; loglikelihoods None where the adapter has none."""
    out = []
    for reg, cls, extra in ((treg, Instance, {"device": "cpu"}),
                            (jreg, JInstance, {})):
        lmm = reg.build_lmm_by_name(name, **kw, **extra)
        texts = lmm.generate_until(_reqs(cls, gen))
        lls = lmm.loglikelihood(_reqs(cls, ll, "loglikelihood")) \
            if ll else None
        out.append((texts, lls))
    return out


@pytest.fixture(scope="module")
def llava_snapshot(tmp_path_factory):
    return _tiny_llava_hf(tmp_path_factory.mktemp("llava_hf"))[0]


@pytest.fixture(scope="module")
def instructblip_snapshot(tmp_path_factory):
    from transformers import (Blip2QFormerConfig, BlipImageProcessor,
                              InstructBlipConfig,
                              InstructBlipForConditionalGeneration,
                              InstructBlipProcessor,
                              InstructBlipVisionConfig, OPTConfig)
    tok, qtok = _word_tokenizer(), _word_tokenizer()
    cfg = InstructBlipConfig(
        vision_config=InstructBlipVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=7).to_dict(),
        qformer_config=Blip2QFormerConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=1,
            num_attention_heads=4, encoder_hidden_size=32,
            vocab_size=len(tok)).to_dict(),
        text_config=OPTConfig(hidden_size=32, ffn_dim=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              vocab_size=len(tok),
                              word_embed_proj_dim=32).to_dict(),
        num_query_tokens=4,
        image_token_index=tok.convert_tokens_to_ids("<image>"))
    torch.manual_seed(1)
    d = tmp_path_factory.mktemp("iblip") / "snap"
    InstructBlipForConditionalGeneration(cfg).eval().save_pretrained(d)
    InstructBlipProcessor(
        image_processor=BlipImageProcessor(size={"height": 28,
                                                 "width": 28}),
        tokenizer=tok, qformer_tokenizer=qtok,
        num_query_tokens=4).save_pretrained(d)
    return str(d)


def _assert_equal(port, jax):
    (t_texts, t_lls), (j_texts, j_lls) = port, jax
    assert t_texts == j_texts
    assert all(isinstance(t, str) for t in t_texts)
    assert t_lls == j_lls
    for lp, greedy in t_lls or []:
        assert np.isfinite(lp) and isinstance(greedy, bool)


def test_llava_hf_matches_jax(llava_snapshot):
    _assert_equal(*_both("llava_hf", pretrained=llava_snapshot))


def test_hf_vision2seq_matches_jax(llava_snapshot):
    gen = [("<image>\nwhat is this", {"max_new_tokens": 3})]
    ll = [("<image>\nwhat is this", " a cat")]
    _assert_equal(*_both("hf-vision2seq", gen, ll, pretrained=llava_snapshot,
                         max_new_tokens=5))


def test_instructblip_matches_jax(instructblip_snapshot):
    _assert_equal(*_both("instructblip", pretrained=instructblip_snapshot))


def test_fuyu_matches_jax():
    model, proc = _tiny_fuyu()
    ll = [("describe this image", "a red cat"), ("what is this", " a dog")]
    _assert_equal(*_both("fuyu", ll=ll, model=model, processor=proc))


def test_idefics2_matches_jax():
    model, proc = _tiny_idefics2()
    # the prompt carries one image token a visual: no '<image>' in the text
    gen = [("what is this", {"max_new_tokens": 3}),
           ("describe the image", {"max_new_tokens": 4, "until": ["cat"]})]
    got = _both("idefics2", gen, None, model=model, processor=proc)
    _assert_equal(*got)
    lmm = treg.build_lmm_by_name("idefics2", model=model, processor=proc,
                                 device="cpu")
    assert lmm.build_prompt("what is this", 1) == \
        "User:<image>what is this<end_of_utterance>\nAssistant:"
    with pytest.raises(NotImplementedError):
        lmm.loglikelihood([])


class _Recorder:
    """Stand-in tokenizer and model of the remote-code adapters: records
    every call and answers from the arguments."""

    eod_id = 151643
    pad_token_id = None

    def __init__(self):
        self.calls = []

    # Qwen-VL's tokenizer
    def from_list_format(self, entries):
        self.calls.append(("from_list_format", [sorted(e) for e in entries],
                           [e.get("text") for e in entries]))
        return "".join(f"<img>{i}</img>" if "image" in e else e["text"]
                       for i, e in enumerate(entries))

    def __call__(self, text, return_tensors=None):
        ids = [ord(c) % 50 for c in text][:16]
        if return_tensors == "pt":
            return {"input_ids": torch.tensor([ids]),
                    "attention_mask": torch.ones((1, len(ids)),
                                                 dtype=torch.long)}
        return {"input_ids": ids}

    def decode(self, ids, skip_special_tokens=True):
        self.calls.append(("decode", [int(i) for i in ids]))
        return "a cat. more"

    # Qwen-VL's model
    def generate(self, input_ids, attention_mask=None, **kw):
        self.calls.append(("generate", input_ids.tolist(), sorted(kw.items())))
        return torch.cat([input_ids, torch.tensor([[1, 2, 3]])], dim=1)

    # MiniCPM-V's and XComposer2's chat APIs
    def chat(self, *args, **kw):
        self.calls.append(("chat", [a for a in args if isinstance(a, str)],
                           sorted((k, v) for k, v in kw.items()
                                  if k not in ("image", "tokenizer"))))
        if "msgs" in kw:
            return "a dog! yes", kw["context"], None
        return "blue.", None


@pytest.mark.parametrize("name", ["qwen_vl", "minicpm_v", "xcomposer2",
                                  "xcomposer2_4khd"])
def test_remote_code_protocols_match_jax(name):
    gen = [("<image>\nwhat animal?", {"until": ["!", "."],
                                      "max_new_tokens": 7}),
           ("what color?", {})]
    seen = []
    for reg, cls, extra in ((treg, Instance, {"device": "cpu"}),
                            (jreg, JInstance, {})):
        rec = _Recorder()
        lmm = reg.build_lmm_by_name(name, model=rec, tokenizer=rec, **extra)
        texts = lmm.generate_until(_reqs(cls, gen))
        seen.append((texts, rec.calls))
        if name != "qwen_vl":
            with pytest.raises(NotImplementedError):
                lmm.loglikelihood([])
    assert seen[0] == seen[1]
    assert all(t for t in seen[0][0])


def test_phi3v_format_matches_jax():
    class Tok:
        def apply_chat_template(self, messages, tokenize=False,
                                add_generation_prompt=True):
            return f"<|user|>{messages[0]['content']}<|assistant|>"

    class Proc:
        tokenizer = Tok()
    out = []
    for cls in (thf.Phi3VLMM, jhf.Phi3VLMM):
        lmm = cls.__new__(cls)
        lmm.processor = Proc()
        out.append([lmm._format(c, has_image=h) for c in (
            "<image>\nwhat?", "no tag here", "<image> text only")
            for h in (True, False)])
    assert out[0] == out[1]
    assert out[0][0] == "<|user|><|image_1|>\nwhat?<|assistant|>"


def test_registries_know_the_same_names():
    names = sorted(treg.LMM_REGISTRY)
    assert names == sorted(jreg.LMM_REGISTRY)
    for name in names:
        t, j = treg.LMM_REGISTRY[name], jreg.LMM_REGISTRY[name]
        assert t.__name__ == j.__name__, name
    for name in ("llava_hf", "instructblip", "qwen_vl", "fuyu", "idefics2",
                 "minicpm_v", "phi3v", "xcomposer2_4khd", "xcomposer2"):
        assert treg.LMM_REGISTRY[name] is getattr(
            thf, jreg.LMM_REGISTRY[name].__name__)
    with pytest.raises(KeyError, match="unknown LMM 'no-such-model'"):
        treg.build_lmm_by_name("no-such-model")
    with pytest.raises(KeyError, match="unknown LMM 'no-such-model'"):
        jreg.build_lmm_by_name("no-such-model")


@pytest.mark.parametrize("name", ["hf-vision2seq", "llava_hf", "phi3v",
                                  "qwen_vl", "minicpm_v", "xcomposer2"])
def test_adapter_without_transformers_names_it(monkeypatch, name):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        treg.build_lmm_by_name(name, pretrained="/no/such/snapshot",
                               device="cpu")


def test_adapters_default_to_the_card(llava_snapshot):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.build_lmm_by_name("llava_hf", pretrained=llava_snapshot)
    model, proc = _tiny_fuyu()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.build_lmm_by_name("fuyu", model=model, processor=proc)
