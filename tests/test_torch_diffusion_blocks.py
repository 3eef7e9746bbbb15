"""The port's diffusion blocks (`models/diffusion_blocks.py`) against the JAX
package's, block by block, on the CPU in fp32.

Each case: seeded numpy inputs, the params tree of the block's Flax `init`
with a seeded key, filled from a seeded numpy generator (`flax_params`),
`io.from_jax.flax_state_dict` to carry it across, and the two forwards held
within `RTOL` / `ATOL`.
Where the JAX block reaches `flash_mha`, it runs in interpret mode off the
TPU, as the JAX package's own tests run it.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION as T_FP32)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import (
    diffusion_blocks as TB)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import (
    diffusion_blocks as JB)

torch.set_num_threads(1)

# fp32 on both sides, sums in another order: relative to the output's scale
RTOL, ATOL = 1e-4, 1e-5


def flax_params(module, seed: int, *args):
    """The params tree of `module.init(PRNGKey(seed), *args)` (its
    structure and shapes, by `jax.eval_shape`: an eager Flax init of a UNet
    takes ~20 s on the CPU) filled from a numpy generator seeded with
    `seed`: kernels N(0, 1 / fan_in), norm scales 1 + N(0, 0.01), biases
    and the other leaves N(0, 0.01), so that no scale of ones or bias of
    zeros can hide a mapping fault."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(seed), *args)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        x = rng.standard_normal(shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        else:
            x = 0.1 * x
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def port(module, tree):
    """`module` (a port block) with the Flax tree loaded, strictly."""
    module.load_state_dict(from_jax.flax_state_dict(tree))
    return module.eval()


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


@contextlib.contextmanager
def jax_attn(impl):
    """The JAX package's diffusion attention route for the duration."""
    JB.set_attn_impl(impl)
    try:
        yield
    finally:
        JB.set_attn_impl(None)


def rand(seed: int, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("flip", [True, False])
def test_timestep_embedding(flip):
    ts = np.array([0, 1, 261, 999], np.float32)
    want = JB.timestep_embedding(jnp.asarray(ts), 32, flip_sin_to_cos=flip)
    got = TB.timestep_embedding(t(ts), 32, flip_sin_to_cos=flip)
    close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("schedule,beta", [("scaled_linear", (0.00085, 0.012)),
                                           ("linear", (0.0001, 0.02))])
def test_ddim_schedule_and_add_noise(schedule, beta):
    want = JB.ddim_alphas_cumprod(beta_start=beta[0], beta_end=beta[1],
                                  schedule=schedule)
    got = TB.ddim_alphas_cumprod(beta_start=beta[0], beta_end=beta[1],
                                 schedule=schedule)
    close(got, want, rtol=1e-5, atol=1e-7)
    x, n = rand(0, 2, 4, 4, 3), rand(1, 2, 4, 4, 3)
    for step in (1, 261, 999):
        close(TB.add_noise(t(x), t(n), step, got),
              JB.add_noise(jnp.asarray(x), jnp.asarray(n), step, want))
    with pytest.raises(ValueError):
        TB.ddim_alphas_cumprod(schedule="cosine")


def test_group_norm_and_conv():
    x = rand(0, 2, 6, 5, 8)
    jgn = JB.GroupNorm(4, 1e-6, J_FP32)
    tree = flax_params(jgn, 1, jnp.asarray(x))
    close(port(TB.GroupNorm(8, 4, 1e-6, T_FP32), tree)(t(x)),
          jgn.apply({"params": tree}, jnp.asarray(x)))
    jconv = JB.Conv(12, precision=J_FP32)
    tree = flax_params(jconv, 2, jnp.asarray(x))
    close(port(TB.Conv(8, 12, T_FP32), tree)(t(x)),
          jconv.apply({"params": tree}, jnp.asarray(x)))


@pytest.mark.parametrize("cout,temb", [(8, True), (12, True), (12, False)])
def test_resnet_block(cout, temb):
    x, e = rand(0, 2, 6, 6, 8), rand(1, 2, 16)
    jmod = JB.ResnetBlock(cout, groups=4, use_temb=temb, precision=J_FP32)
    args = (jnp.asarray(x), jnp.asarray(e) if temb else None)
    tree = flax_params(jmod, 3, *args)
    tmod = port(TB.ResnetBlock(8, cout, T_FP32, groups=4,
                               temb_dim=16 if temb else None), tree)
    close(tmod(t(x), t(e) if temb else None),
          jmod.apply({"params": tree}, *args))


@pytest.mark.parametrize("asymmetric", [True, False])
@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_downsample(asymmetric, hw):
    x = rand(0, 2, *hw, 8)
    jmod = JB.Downsample(8, asymmetric_pad=asymmetric, precision=J_FP32)
    tree = flax_params(jmod, 4, jnp.asarray(x))
    tmod = port(TB.Downsample(8, 8, T_FP32, asymmetric_pad=asymmetric), tree)
    close(tmod(t(x)), jmod.apply({"params": tree}, jnp.asarray(x)))


def test_upsample():
    x = rand(0, 2, 3, 4, 8)
    jmod = JB.Upsample(8, precision=J_FP32)
    tree = flax_params(jmod, 5, jnp.asarray(x))
    close(port(TB.Upsample(8, 8, T_FP32), tree)(t(x)),
          jmod.apply({"params": tree}, jnp.asarray(x)))


@pytest.mark.parametrize("impl", [None, "flash"])
@pytest.mark.parametrize("upcast", [False, True])
@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention(impl, upcast, cross):
    """Self and cross attention (Skv = 7 against Sq = 30), head size 20 (not
    a multiple of 16, as SD1.5's 40 and 80 are not), upcast on and off,
    the JAX route `None` (exact softmax) and `flash` (its Pallas kernel)."""
    x, ctx = rand(0, 2, 30, 40), rand(1, 2, 7, 24)
    jmod = JB.CrossAttention(40, 2, 20, context_dim=24 if cross else None,
                             upcast=upcast, precision=J_FP32)
    args = (jnp.asarray(x), jnp.asarray(ctx) if cross else None)
    tree = flax_params(jmod, 6, *args)
    tmod = port(TB.CrossAttention(40, 2, 20, T_FP32,
                                  context_dim=24 if cross else None,
                                  upcast=upcast), tree)
    with jax_attn(impl):
        want = jmod.apply({"params": tree}, *args)
    close(tmod(t(x), t(ctx) if cross else None), want)


def test_feed_forward_geglu():
    x = rand(0, 2, 5, 16)
    jmod = JB.FeedForwardGEGLU(16, precision=J_FP32)
    tree = flax_params(jmod, 7, jnp.asarray(x))
    close(port(TB.FeedForwardGEGLU(16, T_FP32), tree)(t(x)),
          jmod.apply({"params": tree}, jnp.asarray(x)))


@pytest.mark.parametrize("linear", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_transformer(linear, depth):
    """Conv (SD1.5) and linear (SD2.1 / XL) projections; depth 2 as SDXL's
    blocks have."""
    x, ctx = rand(0, 2, 4, 5, 16), rand(1, 2, 6, 12)
    jmod = JB.SpatialTransformer(16, 2, 8, depth, 12,
                                 use_linear_projection=linear, groups=4,
                                 precision=J_FP32)
    tree = flax_params(jmod, 8, jnp.asarray(x), jnp.asarray(ctx))
    tmod = port(TB.SpatialTransformer(16, 2, 8, depth, 12, T_FP32,
                                      use_linear_projection=linear,
                                      groups=4), tree)
    close(tmod(t(x), t(ctx)),
          jmod.apply({"params": tree}, jnp.asarray(x), jnp.asarray(ctx)))


@pytest.mark.parametrize("chunk_bytes", [None, 4 * 2 * 7 * 20])
def test_vae_self_attention(chunk_bytes, monkeypatch):
    """The plain single-head attention, whole and in 7-row query chunks
    (a last chunk of 6 rows)."""
    if chunk_bytes:
        monkeypatch.setattr(TB, "VAE_ATTN_BYTES", chunk_bytes)
    x = rand(0, 2, 4, 5, 16)
    jmod = JB.VAESelfAttention(16, groups=4, precision=J_FP32)
    tree = flax_params(jmod, 9, jnp.asarray(x))
    close(port(TB.VAESelfAttention(16, T_FP32, groups=4), tree)(t(x)),
          jmod.apply({"params": tree}, jnp.asarray(x)))


def test_attention_routes():
    """Every JAX route name is accepted (each runs kernel 2: `CrossAttention`
    calls it whatever the name); an unknown name raises ValueError."""
    for impl in TB.ATTN_IMPLS:
        TB.check_attn_impl(impl)
    for impl in ("xla_blocked", "pallas", "Flash"):
        with pytest.raises(ValueError, match="diffusion_attn_impl"):
            TB.check_attn_impl(impl)
