"""The port's CLIP text encoder (`models/text_encoder.py`) against the JAX
one and against HF's CLIPTextModel(WithProjection), on the CPU in fp32.

One HF tiny config with seeded random weights is ported by both packages'
`port_clip_text` (bit-equal trees); the JAX `CLIPTextEncoder` runs that
tree, the port's runs it through `io.from_jax.text_encoder_state_dict`
(loaded strict). Hidden states (the last and hidden_states[-2] without the
final LayerNorm) and the pooled output, with and without the projection,
are held at the JAX golden tests' 5e-5 / 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import (
    text_encoder as TT)
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import (
    text_encoder as JT)
from test_torch_hf_port import assert_trees_equal

transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)

ATOL, RTOL = 5e-5, 1e-3
EOS = 98


def _tiny(proj: int, seed: int):
    cls = (transformers.CLIPTextModelWithProjection if proj
           else transformers.CLIPTextModel)
    torch.manual_seed(seed)
    hf = cls(transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64,
        num_hidden_layers=3, num_attention_heads=4,
        max_position_embeddings=16, eos_token_id=EOS, bos_token_id=97,
        projection_dim=proj or 32)).eval()
    kw = dict(vocab_size=99, hidden_size=32, num_layers=3, num_heads=4,
              intermediate_size=64, max_positions=16, eos_token_id=EOS,
              projection_dim=proj)
    return hf, TT.TextConfig(**kw), JT.TextConfig(**kw)


def _ids(seed: int):
    ids = np.random.RandomState(seed).randint(1, 96, size=(2, 10))
    ids[0, -1] = EOS
    ids[1, 6] = EOS             # the first eos is pooled, not the last
    ids[1, 9] = EOS
    return ids


@pytest.mark.parametrize("proj", [0, 16])
def test_text_encoder_matches_jax_and_hf(proj):
    hf, cfg, jcfg = _tiny(proj, seed=proj)
    sd = hf.state_dict()
    tree = TT.port_clip_text(sd, cfg)
    assert_trees_equal(tree, JT.port_clip_text(sd, jcfg))
    enc = TT.CLIPTextEncoder(cfg, FP32_PRECISION)
    enc.load_state_dict(from_jax.text_encoder_state_dict(tree))
    jenc = JT.CLIPTextEncoder(jcfg, J_FP32)
    ids = _ids(proj)
    tids = torch.from_numpy(ids)
    with torch.no_grad():
        out = hf(tids, output_hidden_states=True)
        hidden, pooled = enc(tids, want_pooled=True)
        penult, none = enc(tids, num_blocks=cfg.num_layers - 1)
    assert none is None
    j_hidden, j_pooled = jenc.apply({"params": tree}, jnp.asarray(ids),
                                    want_pooled=True)
    j_penult, _ = jenc.apply({"params": tree}, jnp.asarray(ids),
                             num_blocks=cfg.num_layers - 1)
    want_pooled = out.text_embeds if proj else out.pooler_output
    for got, jax_out, hf_out in (
            (hidden, j_hidden, out.last_hidden_state),
            (penult, j_penult, out.hidden_states[-2]),
            (pooled, j_pooled, want_pooled)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_out),
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(got.numpy(), hf_out.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_legacy_eos_id_pools_at_the_highest_id_as_hf():
    """A config with `eos_token_id` 2 (the published CLIP-L and SD3 text
    encoders): HF pools at each row's highest id, and so does the port.
    The JAX encoder pools at the first id 2 (position 0 where there is
    none), a difference that stands (ROADMAP, queue 3)."""
    torch.manual_seed(5)
    hf = transformers.CLIPTextModelWithProjection(transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16, eos_token_id=2, bos_token_id=0,
        projection_dim=8)).eval()
    cfg = TT.TextConfig(vocab_size=99, hidden_size=32, num_layers=2,
                        num_heads=4, intermediate_size=64, max_positions=16,
                        eos_token_id=2, projection_dim=8)
    enc = TT.CLIPTextEncoder(cfg, FP32_PRECISION)
    tree = TT.port_clip_text(hf.state_dict(), cfg)
    enc.load_state_dict(from_jax.text_encoder_state_dict(tree))
    ids = np.random.RandomState(5).randint(3, 90, size=(2, 10))
    ids[0, 4] = ids[1, 7] = 98          # CLIP's eos is the highest id
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).text_embeds
        _, got = enc(torch.from_numpy(ids), want_pooled=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    _, j_pooled = JT.CLIPTextEncoder(JT.TextConfig(**{
        f: getattr(cfg, f) for f in cfg.__dataclass_fields__}), J_FP32).apply(
        {"params": tree}, jnp.asarray(ids), want_pooled=True)
    assert not np.allclose(np.asarray(j_pooled), want.numpy(), atol=1e-2)


def test_penultimate_tree_runs_in_a_prefix_encoder():
    """`port_clip_text(num_blocks=L-1)` (the SDXL / SD3 port) loads into an
    encoder of L-1 blocks, which gives hidden_states[-2] and refuses a
    deeper run."""
    hf, cfg, jcfg = _tiny(16, seed=3)
    sd = hf.state_dict()
    tree = TT.port_clip_text(sd, cfg, num_blocks=cfg.num_layers - 1)
    assert_trees_equal(tree, JT.port_clip_text(
        sd, jcfg, num_blocks=cfg.num_layers - 1))
    enc = TT.CLIPTextEncoder(cfg, FP32_PRECISION,
                             num_blocks=cfg.num_layers - 1)
    enc.load_state_dict(from_jax.text_encoder_state_dict(tree))
    ids = torch.from_numpy(_ids(3))
    with torch.no_grad():
        want = hf(ids, output_hidden_states=True).hidden_states[-2]
        got, _ = enc(ids, num_blocks=cfg.num_layers - 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="blocks"):
        enc(ids)


def test_penultimate_with_pooled_matches_hf_as_sd3_encodes():
    """SD3's encode (`num_blocks=L-1, want_pooled=True`, diffusers'
    `_get_clip_prompt_embeds`): hidden is HF's hidden_states[-2], without
    the final LayerNorm, and pooled is `text_embeds`, from the whole stack.
    The JAX encoder gives final_ln(hidden_states[-2]) and pools after L-1
    blocks there, a difference that stands (ROADMAP, queue 3)."""
    hf, cfg, jcfg = _tiny(16, seed=4)
    sd = hf.state_dict()
    tree = TT.port_clip_text(sd, cfg)
    enc = TT.CLIPTextEncoder(cfg, FP32_PRECISION)
    enc.load_state_dict(from_jax.text_encoder_state_dict(tree))
    ids = _ids(4)
    with torch.no_grad():
        out = hf(torch.from_numpy(ids), output_hidden_states=True)
        hidden, pooled = enc(torch.from_numpy(ids),
                             num_blocks=cfg.num_layers - 1, want_pooled=True)
    for got, want in ((hidden, out.hidden_states[-2]),
                      (pooled, out.text_embeds)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL,
                                   rtol=RTOL)
    j_hidden, j_pooled = JT.CLIPTextEncoder(jcfg, J_FP32).apply(
        {"params": tree}, jnp.asarray(ids), num_blocks=cfg.num_layers - 1,
        want_pooled=True)
    for got, want in ((j_hidden, out.hidden_states[-2]),
                      (j_pooled, out.text_embeds)):
        assert not np.allclose(np.asarray(got), want.numpy(), atol=1e-2)


def test_causal_block_takes_kernel_two_whatever_the_route(monkeypatch):
    """A causal ViTBlock calls `flash_attention(..., causal=True)` under
    every `attn_impl`; a non-causal one keeps its route."""
    calls = []

    def spy(q, k, v, *, causal=False, **kw):
        calls.append(causal)
        return q
    monkeypatch.setattr(TV, "flash_attention", spy)
    x = torch.randn(1, 5, 32)
    for impl in ("auto", "encoder", "flash", "xla"):
        cfg = TV.ViTConfig(hidden_size=32, num_heads=4,
                           intermediate_size=64, attn_impl=impl)
        blk = TV.ViTBlock(cfg, FP32_PRECISION, causal=True)
        for p in blk.parameters():
            p.data.normal_()
        blk(x)
    assert calls == [True] * 4
    TV.ViTBlock(TV.ViTConfig(hidden_size=32, num_heads=4,
                             intermediate_size=64, attn_impl="flash"),
                FP32_PRECISION)(x)
    assert calls == [True] * 4 + [False]
