"""The port's sampling (`models/sampling.py`, `llava.generate_sample`)
against the JAX package's, in fp32 on the CPU.

The two frameworks' generators give different numbers from one seed, so the
Gumbel noise is drawn by JAX exactly as its functions draw it
(`jax.random.split` / `jax.random.gumbel`, `models/llava.py:318, 371-372`,
`models/sampling.py:60`) and handed to the port: then `top_p_mask`,
`sample_token` and `generate_sample` must agree exactly. The port's own
generator is held to the softmax distribution and to its seed. Also the
adapter's `do_sample` / `temperature` / `top_p` routing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import sampling as JS
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import sampling as TS

from test_torch_decode import jax_args, port_args, ragged_batch, tiny_models

torch.set_num_threads(1)


def test_top_p_mask_matches_jax():
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 50).astype(np.float32) * 3
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    sorted_probs = -np.sort(-probs, axis=-1)
    for top_p in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        want = np.asarray(JS.top_p_mask(jnp.asarray(sorted_probs), top_p))
        got = TS.top_p_mask(torch.from_numpy(sorted_probs), top_p).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(top_p))
        assert got[:, 0].all()             # the top token always survives


@pytest.mark.parametrize("temperature", [-1.0, 0.0, 0.3, 1.0, 4.0])
def test_sample_token_matches_jax_on_its_noise(temperature):
    rng = np.random.RandomState(1)
    logits = rng.randn(8, 100).astype(np.float32) * 2
    logits[0, :3] = logits[0, 3]         # ties keep their vocabulary order
    for seed, top_p in enumerate((1e-9, 0.5, 0.9, 1.0)):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JS.sample_token(jnp.asarray(logits), key,
                                          temperature, top_p))
        noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
        got = TS.sample_token(torch.from_numpy(logits), None, temperature,
                              top_p, noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"top_p {top_p}")
    if temperature <= 0:
        np.testing.assert_array_equal(want, logits.argmax(-1))


def test_sample_token_generator_matches_softmax_and_its_seed():
    """Empirical frequencies of the generator's Gumbel-max draws follow the
    softmax at the temperature (V = 8, 4,000 draws); top_p keeps the
    support to the nucleus; one seed gives one draw."""
    logits = torch.tensor([0.5, 2.0, -1.0, 0.0, 1.0, -2.0, 0.2, 1.5])
    rows = logits.expand(4000, 8)
    draws = TS.sample_token(rows, torch.Generator().manual_seed(2), 0.7)
    freq = torch.bincount(draws, minlength=8).float() / 4000
    want = torch.softmax(logits / 0.7, dim=-1)
    assert (freq - want).abs().max() < 0.03
    again = TS.sample_token(rows, torch.Generator().manual_seed(2), 0.7)
    assert torch.equal(draws, again)
    nucleus = TS.sample_token(rows, torch.Generator().manual_seed(3), 1.0,
                              top_p=0.5)
    order = torch.argsort(-logits)
    cum = torch.cumsum(torch.softmax(logits, -1)[order], 0)
    kept = set(order[:int((cum - torch.softmax(logits, -1)[order]
                           <= 0.5).sum())].tolist())
    assert set(nucleus.tolist()) <= kept and len(kept) < 8


def jax_gumbel_draws(seed, b, vocab, max_new):
    """The noise JAX `generate_greedy(rng=...)` draws: `first_key` for the
    prefill's token, `keys[t]` for step t's."""
    rng = jax.random.PRNGKey(seed)
    rng, first_key = jax.random.split(rng)
    keys = jax.random.split(rng, max_new)
    draws = [jax.random.gumbel(first_key, (b, vocab), jnp.float32)]
    draws += [jax.random.gumbel(keys[t], (b, vocab), jnp.float32)
              for t in range(max_new - 1)]
    return torch.from_numpy(np.stack([np.asarray(d) for d in draws]))


@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.9), (1.5, 1.0)])
def test_generate_sample_matches_jax(temperature, top_p):
    jcfg, jparams, tcfg, params = tiny_models(seed=9)
    batch = ragged_batch(seed=10)
    max_new = 6
    want = np.asarray(JM.generate_sample(
        jparams, jcfg, *jax_args(batch), max_new_tokens=max_new, eos_id=-1,
        rng=jax.random.PRNGKey(11), temperature=temperature, top_p=top_p,
        precision=J_FP32, use_flash=True))
    noise = jax_gumbel_draws(11, 3, tcfg.decoder.vocab_size, max_new)
    got = TM.generate_sample(params, tcfg, *port_args(batch),
                             max_new_tokens=max_new, eos_id=-1,
                             temperature=temperature, top_p=top_p,
                             noise=noise)
    np.testing.assert_array_equal(got.numpy(), want)
    greedy = TM.generate_greedy(params, tcfg, *port_args(batch),
                                max_new_tokens=max_new, eos_id=-1)
    assert not torch.equal(got, greedy)
    # temperature 0 is greedy whatever the generator
    cold = TM.generate_sample(params, tcfg, *port_args(batch),
                              max_new_tokens=max_new, eos_id=-1,
                              generator=torch.Generator().manual_seed(0),
                              temperature=0.0)
    assert torch.equal(cold, greedy)


def test_adapter_sampling_kwargs(monkeypatch):
    """`do_sample=False` is a greedy override, `temperature > 0` samples
    from the adapter's generator with `top_p` (None -> 1.0, an explicit 0.0
    kept), as the JAX adapter routes them."""
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval import (
        llava_adapter as adapter)
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    lmm = build_lmm(RunConfig.from_dict(
        {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit",
                   "sample_seed": 5},
         "train": {"bf16": False}}), device="cpu")
    calls = []
    real = adapter.M.generate_sample

    def spy(*args, **kw):
        calls.append((kw["temperature"], kw["top_p"], kw["generator"]))
        return real(*args, **kw)
    monkeypatch.setattr(adapter.M, "generate_sample", spy)

    def ask(**kw):
        return lmm.generate_until([Instance(
            "generate_until", {}, 0, "t",
            ("what is it", dict(max_new_tokens=4, **kw)), [])])[0]
    greedy = ask()
    assert ask(temperature=0.8, do_sample=False) == greedy
    assert ask(temperature=0) == greedy and not calls
    ask(temperature=0.8)
    ask(temperature=0.8, top_p=None)
    ask(temperature=0.8, top_p=0.0)
    assert [c[:2] for c in calls] == [(0.8, 1.0), (0.8, 1.0), (0.8, 0.0)]
    assert all(c[2] is lmm._generator for c in calls)
    # the generator is seeded by model.sample_seed: a fresh adapter repeats
    # the first draw
    fresh = build_lmm(RunConfig.from_dict(
        {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit",
                   "sample_seed": 5},
         "train": {"bf16": False}}), device="cpu")
    inst = Instance("generate_until", {}, 0, "t",
                    ("what is it", {"max_new_tokens": 4,
                                    "temperature": 0.8}), [])
    first = fresh.generate_until([inst])[0]
    fresh2 = build_lmm(RunConfig.from_dict(
        {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit",
                   "sample_seed": 5},
         "train": {"bf16": False}}), device="cpu")
    assert fresh2.generate_until([inst])[0] == first
