"""The port's one-step featurizers (`models/featurizer.py`,
`models/tower_runtime.py`, `io/featurizer_bundle.py`) against the JAX
package's, on the CPU in fp32, and a tiny diffusion tower under LLaVA.

Every tower's parameters are the JAX modules' trees (seeded, `flax_params`)
carried across by `io.from_jax.featurizer_state_dict`; the configurations
cross as bundle sidecars (`config_to_dict` / `config_from_dict`). Features
are held within 1e-4 relative (fp32, sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION as T_FP32)
from law_of_vision_representation_in_mllms_torch.io import (
    featurizer_bundle as TFB)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import (
    featurizer as TF)
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import (
    tower_runtime as TR)
from law_of_vision_representation_in_mllms_torch.models import towers as TT
from law_of_vision_representation_in_mllms_torch.models import vit as TVIT
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.io import (
    featurizer_bundle as JFB)
from law_of_vision_representation_in_mllms_tpu.models import featurizer as JF
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import (
    tower_runtime as JR)
from law_of_vision_representation_in_mllms_tpu.models import towers as JT
from law_of_vision_representation_in_mllms_tpu.models import unet as JU
from law_of_vision_representation_in_mllms_tpu.models import vae as JV
from law_of_vision_representation_in_mllms_tpu.models import vit as JVIT
from law_of_vision_representation_in_mllms_tpu.models.splice import (
    IGNORE_INDEX, IMAGE_TOKEN_INDEX)
import test_torch_dit_mmdit as DM
from test_torch_diffusion_blocks import close, flax_params, rand, t

torch.set_num_threads(1)

IMG = 32
PROMPT_LEN = 5
# the imsd conditioner: a tiny CLIP vision tower at 224 px (7 x 7 patches)
CLIP_TINY = dict(image_size=224, patch_size=32, hidden_size=32, num_layers=2,
                 num_heads=2, intermediate_size=64)
UNETS = {
    # head size 10 (not a multiple of 16); attention in block 0 only
    "sd": JU.UNetConfig(block_out_channels=(20, 40), layers_per_block=1,
                        cross_attention_dim=16, num_heads=(2, None),
                        transformer_depth=(1, 0), norm_groups=4),
    # no attention in block 0, depth 2, linear projections
    "sdxl": JU.UNetConfig(block_out_channels=(16, 40), layers_per_block=1,
                          cross_attention_dim=16, num_heads=(None, 2),
                          transformer_depth=(0, 2), norm_groups=4,
                          use_linear_projection=True,
                          addition_embed_type="text_time"),
}
UNETS["imsd"] = UNETS["sd"]


def jax_config(family: str, **kw) -> JF.FeaturizerConfig:
    kw = {"t": 261, "up_ft_index": 0, **kw}
    return JF.FeaturizerConfig(
        family=family, img_size=IMG, unet=UNETS[family],
        vae=JV.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                         latent_channels=4, norm_groups=4), **kw)


def port_config(jcfg: JF.FeaturizerConfig) -> TF.FeaturizerConfig:
    """The JAX configuration through the sidecar format."""
    return TF.config_from_dict(JF.config_to_dict(jcfg))


def jax_tree(jcfg: JF.FeaturizerConfig, seed: int) -> dict:
    px = jnp.zeros((1, IMG, IMG, 3))
    latent = jnp.zeros((1, IMG // 2, IMG // 2, 4))
    tree = {"vae": flax_params(JV.VAEEncoder(jcfg.vae, J_FP32), seed, px),
            "backbone": flax_params(
                JU.UNetHarvest(jcfg.unet, (1,), J_FP32), seed + 1, latent,
                jcfg.t, jnp.zeros((1, PROMPT_LEN,
                                   jcfg.unet.cross_attention_dim)))}
    if jcfg.family == "imsd":
        tree["image_encoder"] = flax_params(
            JVIT.CLIPVisionPooled(JVIT.ViTConfig(**CLIP_TINY), 16, J_FP32),
            seed + 2, jnp.zeros((1, 224, 224, 3)))
    else:
        tree["prompt_embeds"] = rand(seed + 3, 1, PROMPT_LEN,
                                     jcfg.unet.cross_attention_dim)
    return tree


def port_params(tree, cfg: TF.FeaturizerConfig):
    return TF.FeaturizerParams.for_state_dict(
        from_jax.featurizer_state_dict(tree), cfg, T_FP32,
        image_encoder=TVIT.ViTConfig(**CLIP_TINY))


def jax_features(tree, jcfg, px, **kw):
    embed = None
    if jcfg.family == "imsd":
        embed = JR.make_image_embed_fn(JVIT.ViTConfig(**CLIP_TINY), 16,
                                       J_FP32)
    return JF.extract_features(
        jax.tree.map(jnp.asarray, tree), jcfg, jnp.asarray(px),
        deterministic=True, precision=J_FP32, image_embed_fn=embed, **kw)


def pixels(seed: int, b: int = 2):
    return np.tanh(rand(seed, b, IMG, IMG, 3))


@pytest.mark.parametrize("ensemble", [1, 2])
@pytest.mark.parametrize("family", ["sd", "imsd", "sdxl"])
def test_extract_features_deterministic(family, ensemble):
    """Up block 1 of a 2-block UNet (0 for the ensemble case) from a bundle
    tree built through up block 1."""
    up = 1 if ensemble == 1 else 0
    jcfg = jax_config(family, ensemble_size=ensemble, up_ft_index=up)
    tree = jax_tree(jcfg, 50)
    # two images, or one repeated twice: the towers see a batch of 2 either
    # way (the JAX side compiles each op once a shape)
    b = 2 // ensemble
    px = pixels(51, b)
    want = jax_features(tree, jcfg, px)
    got = TF.extract_features(port_params(tree, port_config(jcfg)),
                              port_config(jcfg), t(px), deterministic=True)
    grid = TF.feature_grid(port_config(jcfg))
    assert got.shape == (b, grid * grid, TF.feature_dim(port_config(jcfg)))
    close(got, want)


def test_non_deterministic_draws_repeat_with_the_seed():
    """The posterior sample and the noise come from the generator: one seed
    gives the same bits, another seed other features, and neither is the
    deterministic (posterior mean, no noise) result."""
    jcfg = jax_config("sd", t=500)
    cfg = port_config(jcfg)
    params = port_params(jax_tree(jcfg, 60), cfg)
    px = t(pixels(61))

    def run(seed):
        return TF.extract_features(params, cfg, px,
                                   torch.Generator().manual_seed(seed))
    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    det = TF.extract_features(params, cfg, px, deterministic=True)
    assert not torch.allclose(a, det)
    assert torch.isfinite(a).all()


def test_feature_grid_and_dim():
    for family in ("sd", "sdxl"):
        for up in (0, 1):
            jcfg = jax_config(family, up_ft_index=up)
            assert TF.feature_grid(port_config(jcfg)) == JF.feature_grid(jcfg)
            assert TF.feature_dim(port_config(jcfg)) == JF.feature_dim(jcfg)
    presets = {n: TF.FEATURIZER_PRESETS[n]() for n in TF.FEATURIZER_PRESETS}
    assert set(presets) == set(JF.FEATURIZER_PRESETS)
    sd15 = presets["runwayml/stable-diffusion-v1-5"]
    assert TF.feature_grid(sd15) == 24 and TF.feature_dim(sd15) == 1280
    sdxl = presets["stabilityai/stable-diffusion-xl-base-1.0"]
    assert TF.feature_grid(sdxl) == 32 and TF.feature_dim(sdxl) == 1280
    for name in ("runwayml/stable-diffusion-v1-5",
                 "stabilityai/stable-diffusion-2-1",
                 "lambdalabs/sd-image-variations-diffusers",
                 "stabilityai/stable-diffusion-xl-base-1.0"):
        want = JF.config_to_dict(JF.FEATURIZER_PRESETS[name]())
        assert TF.config_to_dict(presets[name]) == want
        assert TF.config_to_dict(TF.config_from_dict(want)) == want
        # the tower registry's grid, width and image size agree
        for up in (0, 1):
            te = TT.parse_tower_spec(name, up_ft_index=up).entries[0]
            je = JT.parse_tower_spec(name, up_ft_index=up).entries[0]
            assert (te.kind, te.num_patches, te.hidden_size, te.img_size) \
                == (je.kind, je.num_patches, je.hidden_size, je.img_size)


@pytest.mark.parametrize("family", ["dit", "sd3"])
def test_dit_and_sd3_run_through_the_registry_and_the_featurizer(family):
    """The two transformer towers, refused until they were ported, now
    resolve through the tower registry and `tower_runtime` and featurize as
    the JAX package does (`test_torch_dit_mmdit.py` holds the pieces)."""
    name = {"dit": DM.DIT, "sd3": DM.SD3}[family]
    entry = TT.parse_tower_spec(name).entries[0]
    assert (entry.kind, entry.num_patches) == ("diffusion", 256)
    preset = TR.resolve_featurizer_config(entry)
    assert preset.family == family and TF.feature_grid(preset) == 16
    jcfg = DM.jax_config(family)
    cfg = port_config(jcfg)
    tree = DM.jax_tree(jcfg, 95)
    entry = TT.TowerEntry(name=name, kind="diffusion",
                          hidden_size=TF.feature_dim(cfg), num_patches=9,
                          img_size=DM.IMG, t=jcfg.t, up_ft_index=-1)
    apply = TR.make_diffusion_apply(config_overrides={name: cfg})
    px = DM.pixels(96)
    close(apply(DM.port_params(tree, cfg), entry, t(px)),
          DM.jax_features(tree, jcfg, px))


def test_bundle_round_trip_both_ways(tmp_path):
    """A JAX bundle loads into the port, and a bundle the port writes from
    its own seeded modules loads into the JAX package; each gives the other
    package's features."""
    jcfg = jax_config("sd")
    tree = jax_tree(jcfg, 70)
    px = pixels(71)
    path = JFB.save_featurizer_bundle(str(tmp_path / "jax"), tree, jcfg)
    loaded, cfg = TFB.load_featurizer_bundle(path)
    assert TF.config_to_dict(cfg) == JF.config_to_dict(jcfg)
    params = port_params(loaded, cfg)
    close(TF.extract_features(params, cfg, t(px), deterministic=True),
          jax_features(tree, jcfg, px))

    own = TF.FeaturizerParams(cfg, T_FP32, prompt_len=PROMPT_LEN)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    init_weights(own, torch.Generator().manual_seed(72))
    own.prompt_embeds.normal_(generator=torch.Generator().manual_seed(73))
    path = TFB.save_featurizer_bundle(str(tmp_path / "port"), own, cfg)
    jtree, jcfg2 = JFB.load_featurizer_bundle(path)
    assert JF.config_to_dict(jcfg2) == JF.config_to_dict(jcfg)
    close(TF.extract_features(own.eval(), cfg, t(px), deterministic=True),
          jax_features(jtree, jcfg2, px))
    # and back: the port's tree maps onto the same state dict
    sd = from_jax.featurizer_state_dict(jtree)
    assert all(torch.equal(sd[k], v) for k, v in own.state_dict().items())


def test_bundle_round_trip_imsd(tmp_path):
    jcfg = jax_config("imsd")
    tree = jax_tree(jcfg, 80)
    params = port_params(tree, port_config(jcfg))
    path = TFB.save_featurizer_bundle(str(tmp_path / "imsd"), params,
                                      port_config(jcfg))
    back, _ = JFB.load_featurizer_bundle(path)
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for k, v in flat:
        np.testing.assert_array_equal(got[k], v)


def test_diffusion_apply_resolves_the_entry_and_refuses_no_params():
    jcfg = jax_config("sd")
    cfg = port_config(jcfg)
    entry = TT.TowerEntry(name="tiny-sd", kind="diffusion", hidden_size=40,
                          num_patches=64, img_size=IMG, t=261)
    params = port_params(jax_tree(jcfg, 90), cfg)
    apply = TR.make_diffusion_apply(config_overrides={"tiny-sd": cfg})
    px = t(pixels(91))
    assert torch.equal(apply(params, entry, px),
                       TF.extract_features(params, cfg, px,
                                           deterministic=True))
    with pytest.raises(ValueError, match="has no params"):
        apply(torch.nn.Identity(), entry, px)


def _tiny_llava(jcfg, tree, seed=0):
    """The JAX and port LLaVAs over one tiny diffusion tower ("tiny-sd"),
    the port's weights from the JAX tree (towers included)."""
    grid, dim = JF.feature_grid(jcfg), JF.feature_dim(jcfg)
    img = jcfg.img_size
    dec = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=4, intermediate_size=64)
    jentry = JT.TowerEntry(name="tiny-sd", kind="diffusion", hidden_size=dim,
                           num_patches=grid * grid, img_size=img, t=jcfg.t,
                           up_ft_index=jcfg.up_ft_index)
    jm = JM.LlavaConfig(tower_spec=JT.TowerSpec(entries=[jentry],
                                                join="single"),
                        decoder=JL.tiny(**dec))
    jparams = JM.init_params(jax.random.PRNGKey(seed), jm, J_FP32,
                             init_towers=False)
    jparams["towers"] = [jax.tree.map(jnp.asarray, tree)]
    tentry = TT.TowerEntry(name="tiny-sd", kind="diffusion", hidden_size=dim,
                           num_patches=grid * grid, img_size=img, t=jcfg.t,
                           up_ft_index=jcfg.up_ft_index)
    cfg = port_config(jcfg)
    tm = TM.LlavaConfig(tower_spec=TT.TowerSpec(entries=[tentry],
                                                join="single"),
                        decoder=TL.tiny(**dec),
                        featurizer_overrides={"tiny-sd": cfg})
    params = TM.LlavaParams(tm, T_FP32)
    params.towers[0] = TF.FeaturizerParams.for_state_dict(
        from_jax.featurizer_state_dict(tree), cfg, T_FP32)
    params.load_state_dict(from_jax.llava_state_dict(
        jax.tree.map(np.asarray, jparams)))
    return jm, jparams, tm, params.eval()


@pytest.mark.parametrize("family", ["sd", "dit", "sd3"])
def test_llava_with_a_diffusion_tower_matches_jax(family):
    """`encode_images` and `loss_fn` over a tiny SD, DiT or SD3 tower (the
    diffLVLM path), both packages on the same weights; the tower takes no
    gradient."""
    if family == "sd":
        jcfg = jax_config("sd")
        tree = jax_tree(jcfg, 100)
        px = pixels(101)
    else:
        jcfg = DM.jax_config(family)
        tree = DM.jax_tree(jcfg, 100)
        px = DM.pixels(101)
    jm, jparams, tm, params = _tiny_llava(jcfg, tree)
    japply = JR.make_diffusion_apply(deterministic=True, precision=J_FP32,
                                     config_overrides={"tiny-sd": jcfg})
    rng = np.random.RandomState(2)
    b, l = 2, 6
    ids = rng.randint(1, 60, size=(b, l)).astype(np.int32)
    ids[:, 0] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :2] = IGNORE_INDEX
    want = JM.encode_images(jparams, jm, [jnp.asarray(px)], J_FP32, japply)
    with torch.no_grad():
        got = TM.encode_images(params, tm, [t(px)])
        own = params.projector(TF.extract_features(
            params.towers[0], TR.resolve_featurizer_config(
                tm.tower_spec.entries[0], tm.featurizer_overrides["tiny-sd"]),
            t(px), deterministic=True))
    close(got, want)
    assert torch.equal(got, own)      # the override's config, deterministic

    jbatch = {"input_ids": jnp.asarray(ids), "labels": jnp.asarray(labels),
              "text_mask": jnp.ones((b, l), bool),
              "pixel_values": [jnp.asarray(px)]}
    tbatch = {"input_ids": torch.from_numpy(ids).long(),
              "labels": torch.from_numpy(labels).long(),
              "text_mask": torch.ones(b, l, dtype=torch.bool),
              "pixel_values": [t(px)]}
    want = float(JM.loss_fn(jparams, jm, jbatch, J_FP32,
                            diffusion_apply=japply))
    for p in params.parameters():
        p.requires_grad_(True)
    loss = TM.loss_fn(params, tm, tbatch)
    assert abs(float(loss.detach()) - want) <= 1e-5 * max(1.0, abs(want))
    loss.backward()
    assert all(p.grad is None for p in params.towers.parameters())
    assert params.projector.layers[0].weight.grad.abs().sum() > 0
