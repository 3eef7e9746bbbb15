"""The port's LLaMA decoder against the JAX package's, on the same weights
(converted by `io.from_jax`) and seeded inputs, in fp32.

The JAX side runs its Pallas paths in interpret mode: `use_flash=True`
(`flash_mha_trainable`) for the prefill and `decode_attn="pallas"`
(`decode_attention`) for the decode steps, the counterparts of the port's
kernels 2 and 3. Tolerance: 1e-4 relative to the largest hidden magnitude.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL

# One intra-op thread: with two, the first multi-threaded fp32 call in a
# loaded process has been seen to come out ~5e-5 off its fp64 value, over
# the tolerances below; on one thread it stays at ~5e-7.
torch.set_num_threads(1)

# GQA (4 query heads on 2 kv heads), head_dim 16
JCFG = JL.tiny(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=96)


def _rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    params = JL.init_params(jax.random.PRNGKey(0), JCFG)
    rng = np.random.RandomState(1)
    # move the RMSNorm weights off 1 so a mapping mistake shows
    params = jax.tree.map(np.asarray, params)
    for name in ("rms1", "rms2"):
        params["layers"][name] = params["layers"][name] + 0.1 * rng.randn(
            *params["layers"][name].shape).astype(np.float32)
    params["final_norm"] = params["final_norm"] + 0.1 * rng.randn(
        *params["final_norm"].shape).astype(np.float32)
    tcfg = TL.LlamaConfig(**{f.name: getattr(JCFG, f.name)
                             for f in dataclasses.fields(TL.LlamaConfig)})
    model = TL.LlamaModel(tcfg, FP32_PRECISION)
    model.load_state_dict(from_jax.llama_state_dict(params))
    return params, model


def _batch(b=2, s=10):
    rng = np.random.RandomState(2)
    embeds = rng.randn(b, s, JCFG.hidden_size).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[1, 7:] = False                                # right padding
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    return embeds, mask, positions


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_without_cache_matches_jax(models, use_flash):
    params, model = models
    embeds, mask, positions = _batch()
    want, _ = JL.forward(params, JCFG, jnp.asarray(embeds),
                         jnp.asarray(positions), attn_mask=jnp.asarray(mask),
                         precision=J_FP32, use_flash=use_flash)
    got, _ = model(torch.from_numpy(embeds),
                   torch.from_numpy(positions).long(),
                   attn_mask=torch.from_numpy(mask), use_flash=use_flash)
    _rel_close(got, want)


def test_prefill_then_decode_steps_match_jax(models):
    """Prefill into a cache (flash, slot 0), then 3 decode steps whose mask
    has holes at the prompt's pad slots."""
    params, model = models
    embeds, mask, positions = _batch()
    b, s = mask.shape
    n_gen = 3
    jcfg = dataclasses.replace(JCFG, decode_attn="pallas")
    slot_valid = np.concatenate([mask, np.zeros((b, n_gen), bool)], axis=1)
    jcache = JL.init_cache(jcfg, b, s + n_gen, jnp.float32)
    tcache = TL.init_cache(model.cfg, b, s + n_gen, torch.float32)

    want, jcache = JL.forward(params, jcfg, jnp.asarray(embeds),
                              jnp.asarray(positions),
                              attn_mask=jnp.asarray(slot_valid), cache=jcache,
                              cache_index=0, precision=J_FP32, use_flash=True)
    got, tcache = model(torch.from_numpy(embeds),
                        torch.from_numpy(positions).long(),
                        attn_mask=torch.from_numpy(slot_valid), cache=tcache,
                        cache_index=0, use_flash=True)
    valid = mask[..., None]
    _rel_close(got.numpy() * valid, np.asarray(want) * valid)

    pos = mask.sum(axis=1)
    rng = np.random.RandomState(3)
    for t in range(n_gen):
        slot_valid[:, s + t] = True
        emb = rng.randn(b, 1, JCFG.hidden_size).astype(np.float32)
        want, jcache = JL.forward(params, jcfg, jnp.asarray(emb),
                                  jnp.asarray(pos[:, None]),
                                  attn_mask=jnp.asarray(slot_valid),
                                  cache=jcache, cache_index=s + t,
                                  precision=J_FP32)
        got, tcache = model(torch.from_numpy(emb),
                            torch.from_numpy(pos[:, None]).long(),
                            attn_mask=torch.from_numpy(slot_valid),
                            cache=tcache, cache_index=s + t)
        _rel_close(got, want)
        pos = pos + 1
    # the cache holds the same K/V in the same [B, T, KV, Dh] layout
    for i, (ck, _) in enumerate(tcache):
        _rel_close(ck.numpy()[:, s:], np.asarray(jcache["k"][i])[:, s:])


def test_embed_and_logits_match_jax(models):
    params, model = models
    ids = np.array([[1, 5, -200, 63, 0]], np.int32)
    want = JL.embed_tokens(params, jnp.asarray(ids), J_FP32)
    got = TL.embed_tokens(model, torch.from_numpy(ids).long())
    _rel_close(got, want)
    h = np.random.RandomState(4).randn(1, 3, 64).astype(np.float32)
    _rel_close(TL.logits_fn(model, torch.from_numpy(h)),
               JL.logits_fn(params, jnp.asarray(h), J_FP32))


def test_rms_norm_and_rope_match_jax():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 3, 4, 16).astype(np.float32)
    w = rng.randn(16).astype(np.float32)
    _rel_close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
               JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    cfg = dataclasses.replace(JCFG, hidden_size=64, num_heads=4)
    pos = np.array([[0, 5, 300], [7, 7, 1]], np.int32)
    jcos, jsin = JL.rope_tables(cfg, jnp.asarray(pos))
    tcfg = TL.tiny(hidden_size=64, num_heads=4)
    tcos, tsin = TL.rope_tables(tcfg, torch.from_numpy(pos).long())
    _rel_close(tcos, jcos)
    _rel_close(tsin, jsin)
    _rel_close(TL.apply_rope(torch.from_numpy(x), tcos, tsin),
               JL.apply_rope(jnp.asarray(x), jcos, jsin))
