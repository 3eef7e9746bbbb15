"""The port's beam search (`llava.generate_beam`) against the JAX
`generate_beam`, token for token, in fp32 on the CPU: k in {2, 3} and
length_penalty in {0.5, 1, 2}, on a ragged batch with an eos that the greedy
path reaches (candidates finish on it or on the last step, so the finished
pool and its merge take part in every case). The
JAX function is itself golden-tested against HF `generate(num_beams=k)`
(`tests/test_beam.py`). Also the adapter's `num_beams` routing.
"""

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_torch.models import llava as TM

from test_torch_decode import (jax_args, port_args, port_greedy,
                               ragged_batch, tiny_models)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    return tiny_models(seed=12)


@pytest.mark.parametrize("k,penalty", [(2, 0.5), (3, 0.5), (2, 1.0),
                                       (3, 1.0), (2, 2.0), (3, 2.0)])
def test_beam_matches_jax(tiny, k, penalty):
    jcfg, jparams, tcfg, params = tiny
    batch = ragged_batch(seed=13)
    max_new = 6
    # an eos the greedy path reaches at step 2 of row 0, so beams finish
    eos = int(port_greedy(tcfg, params, batch, 3, -1)[0, 2])
    want = np.asarray(JM.generate_beam(
        jparams, jcfg, *jax_args(batch), max_new_tokens=max_new, eos_id=eos,
        num_beams=k, length_penalty=penalty, precision=J_FP32,
        use_flash=True))
    got, scores = TM.generate_beam(params, tcfg, *port_args(batch),
                                   max_new_tokens=max_new, eos_id=eos,
                                   num_beams=k, length_penalty=penalty,
                                   return_scores=True)
    np.testing.assert_array_equal(got.numpy(), want)
    # the pool is full after the last step (every running beam finishes
    # there), best first
    assert scores.shape == (3, k) and torch.isfinite(scores).all()
    assert (scores[:, :-1] >= scores[:, 1:]).all()


def test_beam_int8_cache_and_one_step(tiny):
    """An int8 KV cache repeated and reordered like the dense one; one new
    token (no step after the prefill's bookkeeping)."""
    jcfg, jparams, tcfg, params = tiny_models(seed=14, kv_quant="int8")
    batch = ragged_batch(seed=15)
    for max_new in (1, 5):
        want = np.asarray(JM.generate_beam(
            jparams, jcfg, *jax_args(batch), max_new_tokens=max_new,
            eos_id=-1, num_beams=2, precision=J_FP32, use_flash=True))
        got = TM.generate_beam(params, tcfg, *port_args(batch),
                               max_new_tokens=max_new, eos_id=-1,
                               num_beams=2)
        np.testing.assert_array_equal(got.numpy(), want)


def test_adapter_num_beams(monkeypatch):
    """num_beams > 1 routes to `generate_beam` (and wins over a
    temperature), num_beams 1 is the default path, as in the JAX adapter."""
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval import (
        llava_adapter as adapter)
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    lmm = build_lmm(RunConfig.from_dict(
        {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit"},
         "train": {"bf16": False}}), device="cpu")
    calls = []
    real = adapter.M.generate_beam

    def spy(*args, **kw):
        calls.append(kw["num_beams"])
        return real(*args, **kw)
    monkeypatch.setattr(adapter.M, "generate_beam", spy)

    def ask(**kw):
        return lmm.generate_until([Instance(
            "generate_until", {}, i, "t",
            (p, dict(max_new_tokens=5, **kw)), [])
            for i, p in enumerate(("describe it", "what colour"))])
    base = ask()
    assert ask(num_beams=1) == base and not calls
    three = ask(num_beams=3, temperature=0.9)
    assert calls == [3] and len(three) == 2
    ids, mask, pixels = lmm._encode_batch([Instance(
        "generate_until", {}, i, "t", (p, {}), [])
        for i, p in enumerate(("describe it", "what colour"))])
    toks = real(lmm.params, lmm.cfg, ids, mask, pixels, max_new_tokens=5,
                eos_id=lmm.tok.eos_token_id, num_beams=3)
    assert three == [lmm.tok.decode(
        row[:row.index(lmm.tok.eos_token_id)]
        if lmm.tok.eos_token_id in row else row).strip()
        for row in toks.tolist()]
