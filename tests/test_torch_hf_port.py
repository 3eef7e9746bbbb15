"""The port's HF porters (`io/hf_port.py`) against the JAX package's, and
its towers on the ported weights against HF's own forward, on the CPU.

Each HF model is a `transformers` tiny config with seeded random weights.
Each porter's tree must equal the JAX porter's exactly (same keys, dtypes
and bits: both are the same numpy operations on the same tensors) and load
`strict=True` into the port's module; the towers then hold every HF
hidden state at the JAX golden tests' 1e-4 / 1e-3 (fp32, sums in another
order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.io import hf_port as TH
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_tpu.io import hf_port as JH
from law_of_vision_representation_in_mllms_tpu.models import vit as JV

from chip_smoke import flat_tree as flat

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

TINY = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=3,
            num_heads=4, intermediate_size=64)
ATOL, RTOL = 1e-4, 1e-3


def assert_trees_equal(got, want) -> None:
    """Same keys, dtypes and shapes, bit-equal arrays."""
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def jax_cfg(cfg: TV.ViTConfig) -> JV.ViTConfig:
    return JV.ViTConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(TV.ViTConfig)})


def tower_states(tree, cfg: TV.ViTConfig, pixels) -> list:
    """The port's ViTEncoder on `tree` (loaded strict): the output after 0,
    1, ..., L blocks (HF's `hidden_states`)."""
    enc = TV.ViTEncoder(cfg, FP32_PRECISION)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in
                         from_jax.vit_state_dict({"encoder": tree}).items()})
    blocks = enc.blocks
    out = []
    with torch.no_grad():
        for n in range(len(blocks) + 1):
            enc.blocks = blocks[:n]
            out.append(enc(torch.from_numpy(pixels)).numpy())
    enc.blocks = blocks
    return out


def _pixels(cfg, seed):
    return np.random.RandomState(seed).randn(
        2, cfg.image_size, cfg.image_size, 3).astype(np.float32)


def _hf_vit(family: str, seed: int, **kw):
    """A tiny HF vision model and the port's ViTConfig for it."""
    torch.manual_seed(seed)
    common = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                  num_attention_heads=4, patch_size=7)
    if family == "clip":
        act = kw.get("act", "quick_gelu")
        hf = transformers.CLIPVisionModel(transformers.CLIPVisionConfig(
            image_size=28, hidden_act=act, **common))
        cfg = TV.ViTConfig(hidden_act=act, **TINY)
    elif family == "siglip":
        hf = transformers.SiglipVisionModel(transformers.SiglipVisionConfig(
            image_size=28, **common))
        cfg = TV.ViTConfig(hidden_act="gelu_tanh", layer_norm_eps=1e-6,
                           use_class_token=False, use_pre_layernorm=False,
                           patch_bias=True, **TINY)
    else:
        common.pop("intermediate_size")
        hf = transformers.Dinov2Model(transformers.Dinov2Config(
            image_size=kw.get("trained_at", 28), mlp_ratio=2, **common))
        cfg = TV.ViTConfig(hidden_act="gelu", layer_norm_eps=1e-6,
                           use_class_token=True, use_pre_layernorm=False,
                           patch_bias=True,
                           use_layerscale=kw.get("layerscale", False), **TINY)
        # LayerScale holds 1.0 at init: move it, so that the fold shows
        with torch.no_grad():
            for name, p in hf.named_parameters():
                if "lambda1" in name:
                    p.add_(0.3 * torch.randn(p.shape))
    return hf.eval(), cfg


VIT_CASES = {
    "clip_quick_gelu": ("clip", {}),
    "clip_gelu": ("clip", {"act": "gelu"}),
    "siglip": ("siglip", {}),
    "dinov2_fold": ("dinov2", {}),
    "dinov2_layerscale": ("dinov2", {"layerscale": True}),
    # trained at a 2 x 2 grid, ported to 4 x 4 (bicubic interpolation)
    "dinov2_interp": ("dinov2", {"trained_at": 14}),
}


@pytest.mark.parametrize("case", sorted(VIT_CASES))
def test_vit_porter_matches_jax_and_hf(case):
    family, kw = VIT_CASES[case]
    hf, cfg = _hf_vit(family, seed=sorted(VIT_CASES).index(case), **kw)
    sd = hf.state_dict()
    tree = TH.VIT_PORTERS[family](sd, cfg)
    assert_trees_equal(tree, JH.VIT_PORTERS[family](sd, jax_cfg(cfg)))
    pixels = _pixels(cfg, seed=len(case))
    with torch.no_grad():
        want = hf(torch.from_numpy(pixels).permute(0, 3, 1, 2),
                  output_hidden_states=True).hidden_states
    got = tower_states(tree, cfg, pixels)
    assert len(got) == len(want) == cfg.num_layers + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL, rtol=RTOL)


def test_siglip_porter_takes_a_bare_vision_tower():
    """SigLIP's keys without the `vision_model.` prefix (a vision tower
    saved on its own) port as with it."""
    hf, cfg = _hf_vit("siglip", seed=7)
    sd = {k[len("vision_model."):]: v for k, v in hf.state_dict().items()}
    tree = TH.port_siglip_vision(sd, cfg)
    assert_trees_equal(tree, JH.port_siglip_vision(sd, jax_cfg(cfg)))
    assert_trees_equal(tree, TH.port_siglip_vision(hf.state_dict(), cfg))


@pytest.mark.parametrize("num_blocks", [None, 2, 0])
def test_port_vit_keeps_a_block_prefix(num_blocks):
    hf, cfg = _hf_vit("clip", seed=3)
    sd = hf.state_dict()
    tree = TH.port_vit("clip", sd, cfg, num_blocks=num_blocks)
    assert_trees_equal(tree, JH.port_vit("clip", sd, jax_cfg(cfg),
                                         num_blocks=num_blocks))
    assert sum(k.startswith("block_") for k in tree) == (
        cfg.num_layers if num_blocks is None else num_blocks)


def test_llama_porter_matches_jax_and_hf():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False)
    torch.manual_seed(1)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    with torch.no_grad():       # RMSNorm weights off 1
        for name, p in hf.named_parameters():
            if "norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    cfg = TL.LlamaConfig(vocab_size=128, hidden_size=64,
                         intermediate_size=128, num_layers=2, num_heads=4,
                         num_kv_heads=2, rms_eps=hf_cfg.rms_norm_eps)
    sd = hf.state_dict()
    tree = TH.port_llama(sd, cfg)
    assert_trees_equal(tree, JH.port_llama(sd, cfg))
    model = TL.LlamaModel(cfg, FP32_PRECISION)
    model.load_state_dict(from_jax.llama_state_dict(tree))
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (1, 6)))
    with torch.no_grad():
        h, _ = model(TL.embed_tokens(model, ids), torch.arange(6)[None])
        got = TL.logits_fn(model, h).numpy()
        want = hf(ids).logits.numpy()
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=RTOL)


def test_clip_vision_pooled_porter_matches_jax_and_hf():
    torch.manual_seed(4)
    hf = transformers.CLIPVisionModelWithProjection(
        transformers.CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=28, patch_size=7,
            projection_dim=24)).eval()
    cfg = TV.ViTConfig(**{**TINY, "num_layers": 2})
    sd = hf.state_dict()
    tree = TH.port_clip_vision_pooled(sd, cfg)
    assert_trees_equal(tree, JH.port_clip_vision_pooled(sd, jax_cfg(cfg)))
    pooled = TV.CLIPVisionPooled(cfg, 24, FP32_PRECISION)
    pooled.load_state_dict({
        k[len("image_encoder."):]: v for k, v in
        from_jax.featurizer_state_dict(
            {"vae": {}, "backbone": {}, "image_encoder": tree}).items()})
    pixels = _pixels(cfg, seed=4)
    with torch.no_grad():
        got = pooled(torch.from_numpy(pixels)).numpy()
        want = hf(torch.from_numpy(pixels).permute(0, 3, 1, 2)).image_embeds
    np.testing.assert_allclose(got, want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("window,global_idx", [(2, (1,)), (4, (0, 1))])
def test_sam_porter_matches_jax(window, global_idx):
    """`port_sam` on a tiny `SamModel` gives the JAX porter's tree, and
    `sam_config_from_hf` on its config.json the JAX config's fields; the
    tree loads strictly into the port's `SamModel` (the forward is held
    in tests/test_torch_sam.py)."""
    import json

    from law_of_vision_representation_in_mllms_torch.models import sam as TS
    from test_sam import _tiny_hf
    hf, _ = _tiny_hf(seed=5, window=window, global_idx=global_idx)
    cfg = TH.sam_config_from_hf(json.loads(hf.config.to_json_string()))
    jcfg = JH.sam_config_from_hf(hf.config)
    got = dataclasses.asdict(cfg)
    assert got.pop("attention_downsample_rate") == 2
    assert got == dataclasses.asdict(jcfg)
    tree = TH.port_sam(hf.state_dict(), cfg)
    assert_trees_equal(tree, JH.port_sam(hf.state_dict(), jcfg))
    TS.SamModel(cfg).load_state_dict(from_jax.sam_state_dict(tree))
