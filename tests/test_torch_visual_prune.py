"""`LlavaConfig.visual_keep` pruning of the port against the JAX package
(the counterparts of `tests/test_visual_prune.py`), on the CPU in fp32.

The top-K projected image tokens by the tower's CLS attention (from the
last block that ran, `models.facet.cls_scores_from_qk` on its q and k) or
by the token norm, in their original order; `visual_keep=None` or K at the
full count changes nothing. Equal scores keep the lower index, as
`lax.top_k` does; `torch.topk` promises no order, so the port sorts
stably. Greedy tokens with pruning through both packages' adapters are in
`tests/test_torch_variant_paths.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import facet as JF
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models.vit import (
    ViTEncoder as JViTEncoder)
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import facet as TF
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM

torch.set_num_threads(1)

TOWER = "debug/tiny-vit"
FEATURE = "runwayml/stable-diffusion-v1-5_feature"


def _pair(spec=TOWER, seed=0, **kw):
    jcfg = JM.LlavaConfig.build(spec, decoder=JL.tiny(), **kw)
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg, J_FP32)
    tcfg = TM.LlavaConfig.build(spec, decoder=TL.tiny(), **kw)
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(from_jax.llava_state_dict(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, tcfg, params


def _pixels(cfg, b=2, seed=0):
    e = cfg.tower_spec.entries[0]
    rng = np.random.RandomState(seed)
    return rng.randn(b, e.vit_config.image_size, e.vit_config.image_size,
                     3).astype(np.float32)


def _encode(tcfg, params, px):
    return TM.encode_images(params, tcfg, [torch.from_numpy(px)]).detach()


def test_keep_equal_full_is_noop():
    _, _, cfg0, params = _pair()
    cfgk = TM.LlavaConfig.build(TOWER, decoder=TL.tiny(),
                                visual_keep=cfg0.num_patches)
    px = _pixels(cfg0)
    assert cfgk.num_patches == cfg0.num_patches == 16
    assert torch.equal(_encode(cfgk, params, px), _encode(cfg0, params, px))


@pytest.mark.parametrize("score,keep", [("saliency", 3), ("auto", 8),
                                        ("norm", 5)])
def test_pruned_tokens_match_jax(score, keep):
    """The kept tokens equal the JAX function's and form an ordered
    subsequence of the unpruned tokens: the top K by the score."""
    jcfg, jparams, tcfg, params = _pair(visual_keep=keep, prune_score=score)
    px = _pixels(tcfg, seed=1)
    want = np.asarray(jax.jit(lambda p, x: JM.encode_images(
        p, jcfg, [x], J_FP32))(jparams, jnp.asarray(px)))
    got = _encode(tcfg, params, px)
    assert got.shape == want.shape == (2, keep, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    full = _encode(TM.LlavaConfig.build(TOWER, decoder=TL.tiny()), params,
                   px)
    if score == "norm":
        scores = full.norm(dim=-1)
    else:
        tower = params.towers[0]
        scores = TF.cls_attention_scores(
            tower.encoder, torch.from_numpy(px),
            layer=len(tower.encoder.blocks) - 1)
    idx = np.sort(np.argsort(-scores.numpy(), axis=-1, kind="stable")
                  [:, :keep], axis=-1)
    assert torch.equal(got, torch.gather(
        full, 1, torch.from_numpy(idx)[..., None].expand(-1, -1, 64)))


def test_cls_attention_scores_match_jax():
    jcfg, jparams, _, params = _pair(seed=2)
    px = _pixels(jcfg, b=3, seed=2)
    e = jcfg.tower_spec.entries[0]
    enc = JViTEncoder(e.vit_config, J_FP32)
    tower = params.towers[0]
    for layer in (0, len(tower.encoder.blocks) - 1):
        want = np.asarray(JF.cls_attention_scores(
            enc, {"params": jparams["towers"][0]["encoder"]},
            jnp.asarray(px), layer=layer))
        got = TF.cls_attention_scores(tower.encoder, torch.from_numpy(px),
                                      layer=layer)
        assert got.dtype == torch.float32 and got.shape == (3, 16)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        # a softmax row without its CLS column
        assert ((got > 0) & (got.sum(-1, keepdim=True) < 1)).all()


def test_ties_keep_the_lower_index():
    """Equal scores: the lower index wins, as `lax.top_k` has it."""
    tokens = torch.arange(2 * 8 * 3, dtype=torch.float32).reshape(2, 8, 3)
    scores = torch.tensor([[1., 2., 2., 0., 2., 2., 1., 0.],
                           [5., 5., 5., 5., 5., 5., 5., 5.]])
    got = TM.prune_visual_tokens(tokens, scores, 3)
    _, jidx = jax.lax.top_k(jnp.asarray(scores.numpy()), 3)
    want = np.take_along_axis(tokens.numpy(),
                              np.sort(np.asarray(jidx), -1)[..., None], 1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got[0], tokens[0, [1, 2, 4]])
    assert torch.equal(got[1], tokens[1, [0, 1, 2]])


def test_norm_fallback_and_saliency_errors():
    """A feature tower has no CLS attention: `auto` falls back to the norm
    (as the JAX function does); `saliency` raises there and under a
    perceiver, whose tokens are not the tower's patches."""
    jcfg, jparams, tcfg, params = _pair(FEATURE, seed=1, visual_keep=4)
    e = tcfg.tower_spec.entries[0]
    feats = np.random.RandomState(2).randn(
        1, e.num_patches, e.hidden_size).astype(np.float32)
    want = np.asarray(JM.encode_images(jparams, jcfg, [jnp.asarray(feats)],
                                       J_FP32))
    got = TM.encode_images(params, tcfg, [torch.from_numpy(feats)])
    assert got.shape == want.shape == (1, 4, 64)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    cfg_s = TM.LlavaConfig.build(FEATURE, decoder=TL.tiny(), visual_keep=4,
                                 prune_score="saliency")
    with pytest.raises(ValueError, match="saliency"):
        TM.encode_images(params, cfg_s, [torch.from_numpy(feats)])
    cfg_p = TM.LlavaConfig.build(TOWER, decoder=TL.tiny(), visual_keep=8,
                                 projector_type="perceiver2x",
                                 prune_score="saliency")
    params_p = TM.init_params(torch.Generator().manual_seed(4), cfg_p,
                              FP32_PRECISION, "cpu")
    with pytest.raises(ValueError, match="saliency"):
        TM.encode_images(params_p, cfg_p,
                         [torch.from_numpy(_pixels(cfg_p))])


def test_loss_with_pruning_matches_jax():
    """The stage-2 loss through pruned tokens (the splice sees K), and the
    projector's gradient through the gather."""
    jcfg, jparams, tcfg, params = _pair(visual_keep=5)
    rng = np.random.RandomState(3)
    ids = rng.randint(3, 250, size=(2, 12)).astype(np.int32)
    ids[:, 1] = -200
    labels = ids.copy()
    labels[:, :2] = -100
    mask = np.ones((2, 12), bool)
    px = _pixels(tcfg, seed=3)

    def jloss(projector):
        return JM.loss_fn(dict(jparams, projector=projector), jcfg, {
            "input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels),
            "text_mask": jnp.asarray(mask),
            "pixel_values": [jnp.asarray(px)]}, J_FP32)
    want, g = jax.jit(jax.value_and_grad(jloss))(jparams["projector"])
    for p in params.projector.parameters():
        p.requires_grad_(True)
    loss = TM.loss_fn(params, tcfg, {
        "input_ids": torch.from_numpy(ids).long(),
        "labels": torch.from_numpy(labels).long(),
        "text_mask": torch.from_numpy(mask),
        "pixel_values": [torch.from_numpy(px)]})
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    want_g = from_jax.projector_state_dict(jax.tree.map(np.asarray, g))
    for name, p in params.projector.named_parameters():
        w = want_g[name]
        assert (p.grad - w).abs().max().item() <= 1e-4 * w.abs().max().item()
