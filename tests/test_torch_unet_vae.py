"""The port's `UNetHarvest` and `VAEEncoder` against the JAX package's, on the
CPU in fp32, at tiny SD1.5-, SD2.1- and SDXL-style configurations with
the Flax modules' parameter trees (seeded, `flax_params`) carried across by
`io.from_jax`.

Head sizes are 20 and 10, not multiples of 16, as SD1.5's 40 and 80 are
not. The JAX UNet runs under both `set_attn_impl(None)` (exact softmax) and
`"flash"` (its Pallas kernel, interpret mode off the TPU).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION as T_FP32)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import unet as TU
from law_of_vision_representation_in_mllms_torch.models import vae as TV
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import unet as JU
from law_of_vision_representation_in_mllms_tpu.models import vae as JV
from test_torch_diffusion_blocks import close, flax_params, jax_attn, rand, t

torch.set_num_threads(1)

UNET_STYLES = {
    # conv projections; attention in all but the last block; head sizes 20
    # and 40
    "sd15": JU.UNetConfig(block_out_channels=(40, 80, 80), layers_per_block=1,
                          cross_attention_dim=16, num_heads=(2, 2, None),
                          transformer_depth=(1, 1, 0), norm_groups=4),
    # linear projections, upcast attention, head size 10 throughout
    "sd21": JU.UNetConfig(block_out_channels=(20, 40, 40), layers_per_block=2,
                          cross_attention_dim=24, num_heads=(2, 4, None),
                          transformer_depth=(1, 1, 0), norm_groups=4,
                          use_linear_projection=True, upcast_attention=True),
    # no attention in block 0, transformer depth 2, linear projections
    "sdxl": JU.UNetConfig(block_out_channels=(16, 40, 80), layers_per_block=1,
                          cross_attention_dim=12, num_heads=(None, 2, 4),
                          transformer_depth=(0, 2, 2), norm_groups=4,
                          use_linear_projection=True,
                          addition_embed_type="text_time"),
}


def port_unet_config(cfg) -> TU.UNetConfig:
    return TU.UNetConfig(**dataclasses.asdict(cfg))


def port_vae_config(cfg) -> TV.VAEConfig:
    return TV.VAEConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name", ["sd15_unet", "sd21_unet", "sdxl_unet"])
def test_unet_presets_match(name):
    assert dataclasses.asdict(getattr(TU, name)()) == \
        dataclasses.asdict(getattr(JU, name)())


@pytest.mark.parametrize("name", ["sd_vae", "sdxl_vae", "sd3_vae"])
def test_vae_presets_match(name):
    assert dataclasses.asdict(getattr(TV, name)()) == \
        dataclasses.asdict(getattr(JV, name)())


def _unet_pair(style: str, seed: int):
    jcfg = UNET_STYLES[style]
    sample = rand(seed, 2, 8, 8, 4)
    ctx = rand(seed + 1, 2, 5, jcfg.cross_attention_dim)
    jmod = JU.UNetHarvest(jcfg, (0, 1), J_FP32, pre_up_indices=(0,))
    tree = flax_params(jmod, seed, jnp.asarray(sample), 261, jnp.asarray(ctx))
    tmod = TU.UNetHarvest(port_unet_config(jcfg), (0, 1), T_FP32,
                          pre_up_indices=(0,))
    tmod.load_state_dict(from_jax.flax_state_dict(tree))
    return jmod, tree, tmod.eval(), sample, ctx


@pytest.mark.parametrize("impl", [None, "flash"])
@pytest.mark.parametrize("style", list(UNET_STYLES))
def test_unet_harvest(style, impl):
    """Up blocks 0 and 1 and the `pre0` tap (up block 0 before its
    upsampler)."""
    jmod, tree, tmod, sample, ctx = _unet_pair(style, 10)
    with jax_attn(impl):
        want = jmod.apply({"params": tree}, jnp.asarray(sample), 261,
                          jnp.asarray(ctx))
    with torch.no_grad():
        got = tmod(t(sample), 261, t(ctx))
    assert set(got) == set(want) == {0, 1, "pre0"}
    for key in got:
        close(got[key], want[key])
    n = len(UNET_STYLES[style].block_out_channels)
    assert got[0].shape[1] == 8 >> (n - 2)     # mid grid, upsampled once


def test_unet_runs_only_the_blocks_asked_for():
    jmod, tree, tmod, sample, ctx = _unet_pair("sd15", 20)
    with torch.no_grad():
        both = tmod(t(sample), 1, t(ctx))
        first = tmod(t(sample), 1, t(ctx), up_ft_indices=(0,),
                     pre_up_indices=())
    assert set(first) == {0}
    assert torch.equal(first[0], both[0])
    with pytest.raises(ValueError, match="up block 2"):
        tmod(t(sample), 1, t(ctx), up_ft_indices=(2,))
    # a module built for up block 0 has no up block 1 at all
    small = TU.UNetHarvest(port_unet_config(UNET_STYLES["sd15"]), (0,),
                           T_FP32)
    assert not any(k.startswith("up_1") for k in small.state_dict())


VAE_STYLES = {
    "two_blocks": JV.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                               latent_channels=4, norm_groups=4),
    "three_blocks": JV.VAEConfig(block_out_channels=(8, 16, 16),
                                 layers_per_block=2, latent_channels=4,
                                 norm_groups=4, scaling_factor=0.13025),
    "no_quant_conv": JV.VAEConfig(block_out_channels=(8, 16),
                                  layers_per_block=1, latent_channels=16,
                                  norm_groups=4, scaling_factor=1.5305,
                                  shift_factor=0.0609, use_quant_conv=False),
}


@pytest.mark.parametrize("style", list(VAE_STYLES))
def test_vae_encoder(style):
    jcfg = VAE_STYLES[style]
    px = np.tanh(rand(30, 2, 16, 16, 3))
    jmod = JV.VAEEncoder(jcfg, J_FP32)
    tree = flax_params(jmod, 31, jnp.asarray(px))
    tmod = TV.VAEEncoder(port_vae_config(jcfg), T_FP32)
    tmod.load_state_dict(from_jax.flax_state_dict(tree))
    with torch.no_grad():
        got = tmod.eval()(t(px))
    want = jmod.apply({"params": tree}, jnp.asarray(px))
    close(got, want)
    f = 2 ** (len(jcfg.block_out_channels) - 1)
    assert got.shape == (2, 16 // f, 16 // f, 2 * jcfg.latent_channels)


def test_sample_latents():
    """The posterior sample from an explicit generator: the formula of the
    JAX `sample_latents` on the same eps, and a repeat of the seed gives
    the same bits."""
    cfg = port_vae_config(VAE_STYLES["no_quant_conv"])
    moments = t(rand(40, 2, 4, 4, 32)) * 20     # log-variances past the clip
    z1 = TV.sample_latents(moments, torch.Generator().manual_seed(3), cfg)
    z2 = TV.sample_latents(moments, torch.Generator().manual_seed(3), cfg)
    assert torch.equal(z1, z2)
    eps = torch.randn(2, 4, 4, 16, generator=torch.Generator().manual_seed(3))
    mean, logvar = moments.chunk(2, dim=-1)
    want = (mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps
            - cfg.shift_factor) * cfg.scaling_factor
    close(z1, want.numpy())
