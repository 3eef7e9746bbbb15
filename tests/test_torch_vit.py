"""The port's ViT towers and projector against the JAX package's, on the
same weights (converted by `io.from_jax`) and seeded inputs, in fp32.

The JAX towers run `attn_impl="encoder"` (the Pallas `encoder_mha` in
interpret mode), the counterpart of the port's kernel 1. Tolerance: 1e-4
relative to the largest output magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import projector as JP
from law_of_vision_representation_in_mllms_tpu.models import vit as JV
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.io.param_io import (
    load_params)
from law_of_vision_representation_in_mllms_torch.models import projector as TP
from law_of_vision_representation_in_mllms_torch.models import vit as TV

# One intra-op thread: with two, the first multi-threaded fp32 call in a
# loaded process has been seen to come out ~5e-5 off its fp64 value, over
# the tolerances below; on one thread it stays at ~5e-7.
torch.set_num_threads(1)

TOWERS = {
    # CLIP-like: class token, pre-LN, quick-GELU, no patch bias
    "clip": (JV.ViTConfig(image_size=28, patch_size=7, hidden_size=32,
                          num_layers=3, num_heads=2, intermediate_size=64,
                          attn_impl="encoder"), "patch"),
    # SigLIP-like: no class token, patch bias, tanh-GELU, no pre-LN
    "siglip": (JV.ViTConfig(image_size=28, patch_size=7, hidden_size=32,
                            num_layers=3, num_heads=2, intermediate_size=64,
                            hidden_act="gelu_tanh", layer_norm_eps=1e-6,
                            use_class_token=False, use_pre_layernorm=False,
                            patch_bias=True, attn_impl="encoder"),
               "cls_patch"),
    # DINOv2-like: LayerScale, exact GELU, overlapping patches (stride 5)
    "dino": (JV.ViTConfig(image_size=28, patch_size=7, hidden_size=32,
                          num_layers=2, num_heads=2, intermediate_size=64,
                          hidden_act="gelu", use_pre_layernorm=False,
                          patch_bias=True, use_layerscale=True, stride=5,
                          attn_impl="encoder"), "cls_patch"),
}


def _perturbed(params, seed):
    """Init params plus noise, so no LayerNorm, bias or class token sits at
    a trivial value that would hide a conversion mistake."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.1 * rng.randn(*x.shape).astype(
            np.float32), params)


def _port_cfg(jcfg):
    fields = {f.name for f in dataclasses.fields(TV.ViTConfig)}
    return TV.ViTConfig(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                           if k in fields})


def _rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("name", sorted(TOWERS))
def test_vit_tower_matches_jax(name):
    jcfg, select = TOWERS[name]
    jmod = JV.ViTTower(jcfg, -2, select, J_FP32)
    px = np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(px))
                        ["params"], 2)
    want = jmod.apply({"params": params}, jnp.asarray(px))

    tower = TV.ViTTower(_port_cfg(jcfg), -2, select, FP32_PRECISION)
    assert len(tower.encoder.blocks) == jcfg.num_layers - 1
    tower.load_state_dict(from_jax.vit_state_dict(params))
    got = tower(torch.from_numpy(px))
    _rel_close(got, want)


def test_vit_tower_weights_through_npz(tmp_path):
    """JAX `param_io.save_params` -> port `load_params` -> `from_jax`."""
    jcfg, select = TOWERS["clip"]
    jmod = JV.ViTTower(jcfg, -2, select, J_FP32)
    px = np.random.RandomState(3).randn(1, 28, 28, 3).astype(np.float32)
    params = _perturbed(jmod.init(jax.random.PRNGKey(1), jnp.asarray(px))
                        ["params"], 4)
    path = str(tmp_path / "tower.npz")
    jio.save_params(path, params)
    tower = TV.ViTTower(_port_cfg(jcfg), -2, select, FP32_PRECISION)
    tower.load_state_dict(from_jax.vit_state_dict(load_params(path)))
    _rel_close(tower(torch.from_numpy(px)),
               jmod.apply({"params": params}, jnp.asarray(px)))


@pytest.mark.parametrize("proj_type", ["mlp2x_gelu", "mlp3x_gelu", "linear",
                                       "identity"])
def test_projector_matches_jax(proj_type):
    din = 32 if proj_type == "identity" else 24
    params = JP.init_projector(jax.random.PRNGKey(5), proj_type, din, 32)
    params = _perturbed(params, 6)
    feats = np.random.RandomState(7).randn(2, 5, din).astype(np.float32)
    want = JP.apply_projector(params, jnp.asarray(feats), J_FP32)
    proj = TP.Projector(proj_type, din, 32, FP32_PRECISION)
    proj.load_state_dict(from_jax.projector_state_dict(params))
    _rel_close(proj(torch.from_numpy(feats)), want)


def test_presets_match_jax():
    for name, make in JV.VIT_PRESETS.items():
        jcfg = make()
        tcfg = TV.VIT_PRESETS[name]()
        assert _port_cfg(jcfg) == tcfg, name
        assert tcfg.num_patches == jcfg.num_patches
        assert tcfg.resolve_layer(-2) == jcfg.resolve_layer(-2)
