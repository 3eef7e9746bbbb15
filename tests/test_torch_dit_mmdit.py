"""The port's DiT-XL/2 and SD3-MMDiT featurizers (`models/dit.py`,
`models/mmdit.py` and their branches of `models/featurizer.py`,
`io/from_jax.py`, `io/featurizer_bundle.py` and `models/towers.py`) against
the JAX package's, on the CPU in fp32.

The JAX side's params are its modules' trees filled from a seeded numpy
generator (`test_torch_diffusion_blocks.flax_params`), carried across by
`io.from_jax`; the configurations cross as bundle sidecars. The JAX modules
run their default exact `mha`. Features and hidden states are held within
`close`'s 1e-4 relative (fp32 on both sides, sums in another order); the
pure reshapes and the numpy position embedding are held to equality.
"""

import dataclasses

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
from law_of_vision_representation_in_mllms_torch.models import dit as TDT
from law_of_vision_representation_in_mllms_torch.models import (
    featurizer as TF)
from law_of_vision_representation_in_mllms_torch.models import mmdit as TMM
from law_of_vision_representation_in_mllms_torch.models import towers as TT
from law_of_vision_representation_in_mllms_torch.models.layers import (
    init_weights)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.io import (
    featurizer_bundle as JFB)
from law_of_vision_representation_in_mllms_tpu.models import dit as JDT
from law_of_vision_representation_in_mllms_tpu.models import featurizer as JF
from law_of_vision_representation_in_mllms_tpu.models import mmdit as JMM
from law_of_vision_representation_in_mllms_tpu.models import towers as JT
from law_of_vision_representation_in_mllms_tpu.models import vae as JV
from test_torch_diffusion_blocks import close, flax_params, port, rand, t

torch.set_num_threads(1)

DIT = "facebook/DiT-XL-2-512"
SD3 = "stabilityai/stable-diffusion-3-medium-diffusers"
# 24 px through a two-block VAE: a 12 x 12 latent, a 6 x 6 token grid (DiT's
# native grid is 4: its position embedding is rescaled; MMDiT's 8 x 8
# position table is centre-cropped), 3 x 3 tokens after the 2x2 unfold
IMG = 24
PROMPT_LEN = 5


def jax_config(family: str, **kw) -> JF.FeaturizerConfig:
    """A tiny DiT or SD3 featurizer: the JAX `TINY_TEST_CONFIG`s over a
    two-block VAE (SD3's without `quant_conv`, with its shift)."""
    kw = {"t": 261, "up_ft_index": -1, "img_size": IMG, **kw}
    vae = JV.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                       latent_channels=4, norm_groups=4)
    if family == "dit":
        return JF.FeaturizerConfig(
            family="dit", dit=JDT.TINY_TEST_CONFIG, vae=vae,
            beta_schedule="linear", beta_start=0.0001, beta_end=0.02, **kw)
    vae = dataclasses.replace(vae, scaling_factor=1.5305, shift_factor=0.0609,
                              use_quant_conv=False)
    return JF.FeaturizerConfig(family="sd3", mmdit=JMM.TINY_TEST_CONFIG,
                               vae=vae, **kw)


def port_config(jcfg: JF.FeaturizerConfig) -> TF.FeaturizerConfig:
    return TF.config_from_dict(JF.config_to_dict(jcfg))


def _backbone(jcfg):
    up = (jcfg.up_ft_index,)
    if jcfg.family == "dit":
        return JDT.DiTHarvest(jcfg.dit, up, J_FP32)
    return JMM.MMDiTHarvest(jcfg.mmdit, up, J_FP32)


def _backbone_args(jcfg, latent: int):
    lat = jnp.zeros((1, latent, latent, 4))
    if jcfg.family == "dit":
        return lat, jcfg.t
    m = jcfg.mmdit
    return (lat, jcfg.t, jnp.zeros((1, PROMPT_LEN, m.context_dim)),
            jnp.zeros((1, m.pooled_dim)))


def jax_tree(jcfg: JF.FeaturizerConfig, seed: int) -> dict:
    latent = jcfg.img_size // 2
    tree = {"vae": flax_params(JV.VAEEncoder(jcfg.vae, J_FP32), seed,
                               jnp.zeros((1, jcfg.img_size, jcfg.img_size,
                                          3))),
            "backbone": flax_params(_backbone(jcfg), seed + 1,
                                    *_backbone_args(jcfg, latent))}
    if jcfg.family == "sd3":
        tree["prompt_embeds"] = rand(seed + 2, 1, PROMPT_LEN,
                                     jcfg.mmdit.context_dim)
        tree["pooled"] = rand(seed + 3, 1, jcfg.mmdit.pooled_dim)
    return tree


def port_params(tree, cfg: TF.FeaturizerConfig):
    return TF.FeaturizerParams.for_state_dict(
        from_jax.featurizer_state_dict(tree), cfg, T_FP32)


def jax_features(tree, jcfg, px):
    return JF.extract_features(jax.tree.map(jnp.asarray, tree), jcfg,
                               jnp.asarray(px), deterministic=True,
                               precision=J_FP32)


def pixels(seed: int, b: int = 2):
    return np.tanh(rand(seed, b, IMG, IMG, 3))


# --- the pieces ------------------------------------------------------------

@pytest.mark.parametrize("grid,base", [(4, 4), (6, 4), (3, 5)])
def test_sincos_pos_embed_2d_matches_jax(grid, base):
    """The native grid and two rescaled ones (larger and smaller than the
    base), and what `DiTHarvest` adds."""
    for scale in (False, True):
        np.testing.assert_array_equal(
            TDT.sincos_pos_embed_2d(16, grid, grid, base, scale_by_base=scale),
            JDT.sincos_pos_embed_2d(16, grid, grid, base,
                                    scale_by_base=scale))
    got = TDT._pos_embed(16, grid, grid, base, torch.device("cpu"),
                         torch.float32)
    np.testing.assert_array_equal(got.numpy(), JDT.sincos_pos_embed_2d(
        16, grid, grid, base, scale_by_base=grid != base))


def test_unfold_tokens_2x2_matches_jax():
    """A pure reshape: equal values; channel (x_off * 2 + y_off) * C + c."""
    x = rand(1, 2, 36, 5)
    got = TDT.unfold_tokens_2x2(t(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JDT.unfold_tokens_2x2(
                                      jnp.asarray(x))))
    grid = x.reshape(2, 6, 6, 5)
    # token (1, 2) of the 3 x 3 grid, offset x 1 y 0: row 2, column 5
    np.testing.assert_array_equal(got[:, 1 * 3 + 2, 2 * 5:3 * 5].numpy(),
                                  grid[:, 2, 5])


@pytest.mark.parametrize("step", [0, 1, 261])
def test_flow_match_add_noise_matches_jax(step):
    """The raw integer t: t = 1 returns the clean latents, t = 0 the
    noise."""
    x0, eps = rand(2, 2, 4, 4, 3), rand(3, 2, 4, 4, 3)
    got = TMM.flow_match_add_noise(t(x0), t(eps), step)
    close(got, JMM.flow_match_add_noise(jnp.asarray(x0), jnp.asarray(eps),
                                        step))
    if step == 1:
        assert torch.equal(got, t(x0))


# --- the backbones ---------------------------------------------------------

@pytest.mark.parametrize("latent", [8, 12])
def test_dit_harvest_matches_jax(latent):
    """Blocks 1 and -1 (= 2) of the three, at the native grid (latent 8:
    4 x 4 tokens) and a rescaled one (12: 6 x 6)."""
    cfg = JDT.TINY_TEST_CONFIG
    up = (1, -1)
    lat = rand(10 + latent, 2, latent, latent, 4)
    jmod = JDT.DiTHarvest(cfg, up, J_FP32)
    tree = flax_params(jmod, 20, jnp.zeros((1, latent, latent, 4)), 7)
    want = jmod.apply({"params": tree}, jnp.asarray(lat), 7)
    mod = port(TDT.DiTHarvest(TDT.TINY_TEST_CONFIG, up, T_FP32), tree)
    got = mod(t(lat), 7)
    assert sorted(got) == sorted(want) == [-1, 1]
    for i in up:
        close(got[i], want[i])
    # a module built through block 1 runs block 1 and refuses block 2
    short = TDT.DiTHarvest(TDT.TINY_TEST_CONFIG, (1,), T_FP32)
    short.load_state_dict({k: v for k, v in mod.state_dict().items()
                           if "_2." not in k})
    close(short(t(lat), 7)[1], want[1])
    with pytest.raises(ValueError, match="built through block 1"):
        short(t(lat), 7, up_ft_indices=(-1,))


@pytest.mark.parametrize("latent", [12, 16])
def test_mmdit_harvest_matches_jax(latent):
    """Blocks 0 and -1 (the last, `context_pre_only`), with the position
    table cropped (latent 12: 6 x 6 of 8 x 8) and whole (16)."""
    cfg = JMM.TINY_TEST_CONFIG
    up = (0, -1)
    lat = rand(30 + latent, 2, latent, latent, 4)
    ctx = rand(31, 2, PROMPT_LEN, cfg.context_dim)
    pooled = rand(32, 2, cfg.pooled_dim)
    jmod = JMM.MMDiTHarvest(cfg, up, J_FP32)
    tree = flax_params(jmod, 40, jnp.zeros((1, latent, latent, 4)), 5,
                       jnp.zeros((1, PROMPT_LEN, cfg.context_dim)),
                       jnp.zeros((1, cfg.pooled_dim)))
    assert "norm1_context_linear" in tree["block_1"]
    assert "ff_context" not in tree["block_1"]
    want = jmod.apply({"params": tree}, jnp.asarray(lat), 5,
                      jnp.asarray(ctx), jnp.asarray(pooled))
    mod = port(TMM.MMDiTHarvest(TMM.TINY_TEST_CONFIG, up, T_FP32), tree)
    got = mod(t(lat), 5, t(ctx), t(pooled))
    assert sorted(got) == sorted(want) == [-1, 0]
    for i in up:
        close(got[i], want[i])


# --- the featurizers -------------------------------------------------------

@pytest.mark.parametrize("ensemble", [1, 2])
@pytest.mark.parametrize("family", ["dit", "sd3"])
def test_extract_features_deterministic(family, ensemble):
    jcfg = jax_config(family, ensemble_size=ensemble)
    tree = jax_tree(jcfg, 50)
    b = 2 // ensemble
    px = pixels(51, b)
    cfg = port_config(jcfg)
    got = TF.extract_features(port_params(tree, cfg), cfg, t(px),
                              deterministic=True)
    grid = TF.feature_grid(cfg)
    assert got.shape == (b, grid * grid, TF.feature_dim(cfg)) == (b, 9, 64)
    close(got, jax_features(tree, jcfg, px))


def test_sd3_at_t_1_runs_on_the_clean_latents():
    """The flow-match quirk end to end: at t = 1 a noisy draw gives the
    deterministic features, the posterior sample aside (its eps comes from
    the generator, the noise's weight is 1 - t = 0)."""
    jcfg = jax_config("sd3", t=1)
    cfg = port_config(jcfg)
    params = port_params(jax_tree(jcfg, 55), cfg)
    px = t(pixels(56))
    # a posterior of (almost) no variance (log-variance channels 4-7 at
    # -1e4, clamped to -30): the sample is the mean
    params.vae.conv_out.conv.bias.data[4:] = -1e4
    a = TF.extract_features(params, cfg, px, torch.Generator().manual_seed(3))
    b = TF.extract_features(params, cfg, px, deterministic=True)
    close(a, b)


def test_feature_grid_dim_presets_and_tower_specs():
    for family in ("dit", "sd3"):
        for img in (24, 32):
            jcfg = jax_config(family, img_size=img)
            assert TF.feature_grid(port_config(jcfg)) == JF.feature_grid(jcfg)
            assert TF.feature_dim(port_config(jcfg)) == JF.feature_dim(jcfg)
    for name, grid, dim in ((DIT, 16, 4608), (SD3, 16, 6144)):
        cfg = TF.FEATURIZER_PRESETS[name]()
        assert (TF.feature_grid(cfg), TF.feature_dim(cfg)) == (grid, dim)
        want = JF.config_to_dict(JF.FEATURIZER_PRESETS[name]())
        assert TF.config_to_dict(cfg) == want
        assert TF.config_to_dict(TF.config_from_dict(want)) == want
        for kw in ({}, {"img_size": 768}, {"up_ft_index": 3}):
            te = TT.parse_tower_spec(name, **kw).entries[0]
            je = JT.parse_tower_spec(name, **kw).entries[0]
            assert (te.kind, te.num_patches, te.hidden_size, te.img_size) \
                == (je.kind, je.num_patches, je.hidden_size, je.img_size)
        assert (te.kind, TT.parse_tower_spec(name).entries[0].num_patches,
                te.hidden_size) == ("diffusion", 256, dim)


@pytest.mark.parametrize("family", ["dit", "sd3"])
def test_bundle_round_trip_both_ways(tmp_path, family):
    """A JAX bundle loads into the port and back with equal arrays (SD3's
    `pooled` and the VAE without `quant_conv` included); a bundle the port
    writes from its own seeded modules loads into the JAX package and gives
    the port's features there."""
    jcfg = jax_config(family)
    tree = jax_tree(jcfg, 70)
    path = JFB.save_featurizer_bundle(str(tmp_path / "jax"), tree, jcfg)
    loaded, cfg = TFB.load_featurizer_bundle(path)
    assert TF.config_to_dict(cfg) == JF.config_to_dict(jcfg)
    params = port_params(loaded, cfg)
    assert ("pooled" in dict(params.named_buffers())) == (family == "sd3")
    assert not any("quant_conv" in k for k in params.state_dict()) \
        or family == "dit"
    back, _ = JFB.load_featurizer_bundle(TFB.save_featurizer_bundle(
        str(tmp_path / "back"), params, cfg))
    flat = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(got)
    for k, v in flat:
        np.testing.assert_array_equal(got[k], v)

    n_blocks = jcfg.dit.num_layers if family == "dit" \
        else jcfg.mmdit.num_layers
    own = TF.FeaturizerParams(cfg, T_FP32, n_blocks=n_blocks,
                              prompt_len=PROMPT_LEN)
    gen = torch.Generator().manual_seed(72)
    init_weights(own, gen)
    for buf in own.buffers():
        buf.normal_(generator=gen)
    if family == "sd3":
        own.backbone.pos_embed.data.normal_(generator=gen)
    path = TFB.save_featurizer_bundle(str(tmp_path / "port"), own, cfg)
    jtree, jcfg2 = JFB.load_featurizer_bundle(path)
    assert JF.config_to_dict(jcfg2) == JF.config_to_dict(jcfg)
    px = pixels(73)
    close(TF.extract_features(own.eval(), cfg, t(px), deterministic=True),
          jax_features(jtree, jcfg2, px))
    sd = from_jax.featurizer_state_dict(jtree)
    assert sd.keys() == own.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in own.state_dict().items())
