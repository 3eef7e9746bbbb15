"""The port's diffusers porters (`io/diffusers_port.py`) against the JAX
package's, on the CPU.

diffusers is not installed, so the state dicts are written by hand with the
key names the JAX porters read (`diffusers_state_dict`): the JAX porter is
first run on a probe that holds every key and answers each read with a
tensor carrying the read's number, which ties every leaf of its tree to the
diffusers key (and the layout) it came from; the seeded JAX-layout tree of
the port's module (`random_tree`) is then written back under those keys in
the torch layout. Both packages' porters must give bit-equal trees, equal
to that tree, which loads `strict=True` into the port's module (SDXL's
addition embedding, which no featurizer runs, through the bundle loader's
`from_jax.featurizer_state_dict`, which drops it).
"""

import dataclasses

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import (
    diffusers_port as TD)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import dit as TDT
from law_of_vision_representation_in_mllms_torch.models import mmdit as TMM
from law_of_vision_representation_in_mllms_torch.models import unet as TU
from law_of_vision_representation_in_mllms_torch.models import vae as TV
from law_of_vision_representation_in_mllms_tpu.io import diffusers_port as JD
from law_of_vision_representation_in_mllms_tpu.models import dit as JDT
from law_of_vision_representation_in_mllms_tpu.models import mmdit as JMM
from law_of_vision_representation_in_mllms_tpu.models import unet as JU
from law_of_vision_representation_in_mllms_tpu.models import vae as JV
from chip_smoke import diffusers_snapshot
from test_torch_hf_port import assert_trees_equal, flat

torch.set_num_threads(1)


def random_tree(module: torch.nn.Module, seed: int) -> dict:
    """The JAX-layout tree (`from_jax.flax_tree`) of `module`'s state dict
    filled from a seeded numpy generator: no bias of zeros or scale of ones
    can hide a mapping fault."""
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(
        np.float32)) for k, v in module.state_dict().items()}
    return from_jax.flax_tree(sd)


def diffusers_state_dict(jax_porter, tree: dict) -> dict:
    """The fp32 diffusers-keyed state dict from which `jax_porter(sd)`
    gives `tree` (`chip_smoke.diffusers_snapshot`: each leaf under the key
    the porter read for it; the keys it reads only where they exist, a
    bias, a time projection, a shortcut, only where `tree` has the leaf)."""
    return diffusers_snapshot(jax_porter, tree, half=False)[0]


def jax_config(cls, cfg):
    return cls(**dataclasses.asdict(cfg))


UNETS = {
    # conv projections, attention in block 0 only
    "sd15": TU.UNetConfig(block_out_channels=(8, 16), layers_per_block=1,
                          cross_attention_dim=16, num_heads=(2, None),
                          transformer_depth=(1, 0), norm_groups=4),
    # linear projections, two resnets a block
    "sd21": TU.UNetConfig(block_out_channels=(8, 16), layers_per_block=2,
                          cross_attention_dim=12, num_heads=(2, 4),
                          transformer_depth=(1, 1), norm_groups=4,
                          use_linear_projection=True, upcast_attention=True),
    # SDXL: no attention in block 0, depth 2, the text-time embedding
    "sdxl": TU.UNetConfig(block_out_channels=(8, 16, 16), layers_per_block=1,
                          cross_attention_dim=12, num_heads=(None, 2, 2),
                          transformer_depth=(0, 2, 2), norm_groups=4,
                          use_linear_projection=True,
                          addition_embed_type="text_time",
                          addition_time_embed_dim=8, addition_pooled_dim=12),
}


@pytest.mark.parametrize("name,up", [("sd15", 0), ("sd15", 1), ("sd21", 1),
                                     ("sdxl", 2)])
def test_unet_porter_matches_jax(name, up):
    cfg = UNETS[name]
    module = TU.UNetHarvest(cfg, (up,), FP32_PRECISION)
    tree = random_tree(module, seed=up)
    if cfg.addition_embed_type == "text_time":
        # ported by both packages, run by no featurizer: the port's module
        # has none, and `from_jax.featurizer_state_dict` drops it
        tree["add_embedding"] = random_tree(
            TU.TimestepEmbedMLP(6 * cfg.addition_time_embed_dim
                                + cfg.addition_pooled_dim,
                                cfg.time_embed_dim, FP32_PRECISION), seed=9)
    jcfg = jax_config(JU.UNetConfig, cfg)
    sd = diffusers_state_dict(lambda s: JD.port_unet(s, jcfg, (up,)), tree)
    got = TD.port_unet(sd, cfg, (up,))
    assert_trees_equal(got, JD.port_unet(sd, jcfg, (up,)))
    assert_trees_equal(got, tree)
    module.load_state_dict({
        k[len("backbone."):]: v for k, v in from_jax.featurizer_state_dict(
            {"vae": {}, "backbone": got}).items()})


VAES = {
    "sd": TV.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                       latent_channels=4, norm_groups=4),
    "sd3": TV.VAEConfig(block_out_channels=(8, 16, 16), layers_per_block=2,
                        latent_channels=16, norm_groups=4,
                        scaling_factor=1.5305, shift_factor=0.0609,
                        use_quant_conv=False),
}


@pytest.mark.parametrize("name", sorted(VAES))
def test_vae_encoder_porter_matches_jax(name):
    cfg = VAES[name]
    module = TV.VAEEncoder(cfg, FP32_PRECISION)
    tree = random_tree(module, seed=len(name))
    jcfg = jax_config(JV.VAEConfig, cfg)
    sd = diffusers_state_dict(lambda s: JD.port_vae_encoder(s, jcfg), tree)
    got = TD.port_vae_encoder(sd, cfg)
    assert_trees_equal(got, JD.port_vae_encoder(sd, jcfg))
    assert_trees_equal(got, tree)
    assert ("quant_conv" in got) == cfg.use_quant_conv
    module.load_state_dict(from_jax.flax_state_dict(got))


@pytest.mark.parametrize("up", [0, -1])
def test_dit_porter_matches_jax(up):
    cfg = TDT.TINY_TEST_CONFIG
    module = TDT.DiTHarvest(cfg, (up,), FP32_PRECISION)
    tree = random_tree(module, seed=3)
    jcfg = jax_config(JDT.DiTConfig, cfg)
    sd = diffusers_state_dict(lambda s: JD.port_dit(s, jcfg, (up,)), tree)
    # the class-label embedding a DiT snapshot holds is not read
    sd["transformer_blocks.0.norm1.emb.class_embedder.embedding_table."
       "weight"] = torch.ones(1001, cfg.hidden_size)
    got = TD.port_dit(sd, cfg, (up,))
    assert_trees_equal(got, JD.port_dit(sd, jcfg, (up,)))
    assert_trees_equal(got, tree)
    assert sum(k.startswith("block_") for k in got) == up % cfg.num_layers + 1
    module.load_state_dict(from_jax.flax_state_dict(got))


@pytest.mark.parametrize("up", [0, -1])
def test_mmdit_porter_matches_jax(up):
    """Up to block 0 (a joint block), and the whole stack (its last block
    is context-pre-only)."""
    cfg = TMM.TINY_TEST_CONFIG
    module = TMM.MMDiTHarvest(cfg, (up,), FP32_PRECISION)
    tree = random_tree(module, seed=4)
    jcfg = jax_config(JMM.MMDiTConfig, cfg)
    sd = diffusers_state_dict(lambda s: JD.port_mmdit(s, jcfg, (up,)), tree)
    got = TD.port_mmdit(sd, cfg, (up,))
    assert_trees_equal(got, JD.port_mmdit(sd, jcfg, (up,)))
    assert_trees_equal(got, tree)
    last = got[f"block_{up % cfg.num_layers}"]
    assert ("norm1_context_linear" in last) == (up == -1)
    module.load_state_dict(from_jax.flax_state_dict(got))
