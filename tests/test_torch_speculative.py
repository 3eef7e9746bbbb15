"""The port's prompt-lookup speculation (`models/speculative.py`,
`llava.generate_speculative`) against the JAX package's, in fp32 on the
CPU: tokens equal to greedy's and to JAX's, the same number of verification
rounds, on random and on repetitive prompts (which accept drafts), with the
dense and the int8 cache. Also the eval adapter's `gen_backend`s against
the JAX adapter's, on the same weights.

On the CPU a verify round runs eagerly; on the card the same round
function is captured as a CUDA graph and replayed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import (
    speculative as JSP)
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import (
    speculative as TSP)

from test_torch_decode import (jax_args, port_args, port_greedy,
                               ragged_batch, tiny_models)
from test_torch_near_tie import check_answers, use_crc_ids

torch.set_num_threads(1)


def test_bigram_draft_and_pad_after_eos_match_jax():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 5, size=(4, 30)).astype(np.int32)
    for cur_len in (2, 3, 9, 20, 30):
        for g in (1, 4, 8):
            want = np.asarray(JSP.bigram_draft(jnp.asarray(toks), cur_len, g))
            got = TSP.bigram_draft(torch.from_numpy(toks).long(),
                                   torch.tensor(cur_len), g)
            np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(JSP.pad_after_eos(jnp.asarray(toks), 3))
    np.testing.assert_array_equal(
        TSP.pad_after_eos(torch.from_numpy(toks).long(), 3).numpy(), want)


def _decoder(seed):
    cfg = JL.tiny(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                  num_kv_heads=4, intermediate_size=64)
    jparams = JL.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tcfg = TL.tiny(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
                   num_kv_heads=4, intermediate_size=64)
    model = TL.LlamaModel(tcfg, FP32_PRECISION)
    model.load_state_dict(from_jax.llama_state_dict(jparams))
    return cfg, jparams, model.eval()


@pytest.mark.parametrize("repetitive,kv_quant", [(False, None),
                                                 (True, None),
                                                 (True, "int8")])
def test_decode_prompt_lookup_matches_jax(repetitive, kv_quant):
    cfg, jparams, model = _decoder(3)
    rng = np.random.RandomState(1)
    if repetitive:       # a looped 8-gram: the continuation finds bigrams
        ids = np.tile(rng.randint(3, 97, size=8), 6)[None].astype(np.int32)
    else:
        ids = rng.randint(3, 97, size=(2, 12)).astype(np.int32)
    want, want_rounds = JSP.decode_prompt_lookup(
        jparams, cfg, jnp.asarray(ids), max_new_tokens=16, draft_len=8,
        eos_id=5, precision=J_FP32, kv_quant=kv_quant)
    got, rounds = TSP.decode_prompt_lookup(
        model, torch.from_numpy(ids).long(), max_new_tokens=16, draft_len=8,
        eos_id=5, kv_quant=kv_quant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert rounds == int(want_rounds)
    if repetitive:
        assert rounds < 15, f"no draft accepted ({rounds} rounds)"


@pytest.mark.parametrize("kv_quant,draft_len", [(None, 4), (None, 8),
                                                ("int8", 4)])
def test_generate_speculative_matches_greedy_and_jax(kv_quant, draft_len):
    """The full LLaVA path on a ragged batch, with an eos one row emits:
    the tokens of greedy and of the JAX function, and JAX's round count."""
    jcfg, jparams, tcfg, params = tiny_models(seed=16, kv_quant=kv_quant)
    batch = ragged_batch(seed=17)
    max_new = 12
    eos = int(port_greedy(tcfg, params, batch, 5, -1)[1, 4])
    want, want_rounds = JM.generate_speculative(
        jparams, jcfg, *jax_args(batch), max_new_tokens=max_new, eos_id=eos,
        draft_len=draft_len, precision=J_FP32, use_flash=True)
    got, rounds = TM.generate_speculative(
        params, tcfg, *port_args(batch), max_new_tokens=max_new, eos_id=eos,
        draft_len=draft_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), port_greedy(tcfg, params, batch, max_new, eos))
    assert rounds == int(want_rounds)


def test_generate_speculative_accepts_on_a_repetitive_prompt():
    """The tiny model's greedy continuation of a looped prompt repeats
    itself: drafts are accepted, fewer rounds than tokens, same tokens."""
    jcfg, jparams, tcfg, params = tiny_models(seed=18)
    ids, mask, px = ragged_batch(seed=19, b=2, l=24, same_rows=True)
    ids[:, 2:] = np.tile(ids[0, 2:6], 6)[None, :22]
    batch = (ids, mask, px)
    want, want_rounds = JM.generate_speculative(
        jparams, jcfg, *jax_args(batch), max_new_tokens=16, eos_id=-1,
        draft_len=6, precision=J_FP32, use_flash=True)
    got, rounds = TM.generate_speculative(
        params, tcfg, *port_args(batch), max_new_tokens=16, eos_id=-1,
        draft_len=6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), port_greedy(tcfg, params, batch, 16, -1))
    assert rounds == int(want_rounds) and rounds < 15


def test_speculative_decoder_reuses_and_bounds_keys():
    """One `SpeculativeDecoder` over three keys and back: the tokens and
    round counts of a one-off `generate_speculative` each time (a reused
    key's cache is zeroed by the prefill, its history reloaded), at most
    `max_keys` keys kept, the most recent ones."""
    from law_of_vision_representation_in_mllms_torch.models.decode import (
        SpeculativeDecoder)
    _, _, tcfg, params = tiny_models(seed=21)
    dec = SpeculativeDecoder(params, tcfg, eos_id=-1, draft_len=4)
    a, b, c = (ragged_batch(seed=22, l=8), ragged_batch(seed=23, l=12),
               ragged_batch(seed=24, b=2, l=8))
    rounds_run = 0
    for batch, max_new in ((a, 9), (b, 9), (a, 9), (c, 6), (b, 9)):
        got, rounds = dec.generate(*port_args(batch), max_new_tokens=max_new)
        want, want_rounds = TM.generate_speculative(
            params, tcfg, *port_args(batch), max_new_tokens=max_new,
            eos_id=-1, draft_len=4)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert rounds == want_rounds
        rounds_run += rounds
    assert list(dec._keys) == [(2, 8, 6), (3, 12, 9)]
    assert dec.replays == rounds_run and dec.captures == 0


def test_adapter_backends_match_jax_adapter(tmp_path):
    """Each `gen_backend`, and `num_beams`, through the port's adapter and
    the JAX one on the same weights (a JAX `.npz` checkpoint): the same
    answers; the three backends give greedy's."""
    from law_of_vision_representation_in_mllms_tpu.core.config import (
        RunConfig as JRunConfig)
    from law_of_vision_representation_in_mllms_tpu.eval.api import (
        Instance as JInstance)
    from law_of_vision_representation_in_mllms_tpu.eval.runner import (
        build_lmm as j_build_lmm)
    from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    model = {"decoder": "tiny", "vision_tower": "debug/tiny-vit",
             "decode_chunk": 4, "draft_len": 4}
    jlmm = j_build_lmm(JRunConfig.from_dict(
        {"model": model, "train": {"bf16": False}}))
    jlmm.batch_size = 2
    path = str(tmp_path / "llava.npz")
    jio.save_params(path, jlmm.params)
    lmm = build_lmm(RunConfig.from_dict(
        {"model": dict(model, checkpoint=path), "train": {"bf16": False}}),
        device="cpu")
    from PIL import Image
    rng = np.random.RandomState(20)
    images = [Image.fromarray(rng.randint(0, 255, (32, 40, 3), np.uint8))
              for _ in range(2)]

    def requests(cls, **kw):
        return [cls("generate_until", {}, i, "t",
                    (p, dict(max_new_tokens=7, **kw)), [im])
                for i, (p, im) in enumerate(zip(
                    ("describe the image", "what is shown here"), images))]
    # CRC ids (the same prompts in every process); a differing answer must
    # part from the JAX one at a near tie of the JAX logits
    use_crc_ids(jlmm, lmm)
    answers = {}
    for backend in ("greedy", "chunked", "speculative"):
        jlmm.gen_backend = lmm.gen_backend = backend
        want = jlmm.generate_until(requests(JInstance))
        got = lmm.generate_until(requests(Instance))
        check_answers(jlmm, requests(JInstance), want, got)
        answers[backend] = (want, got)
    # each package's backends give its greedy answers
    for side in (0, 1):
        assert answers["chunked"][side] == answers["speculative"][side] \
            == answers["greedy"][side]
    assert lmm._chunked_dec is not None and lmm._chunked_dec.chunk == 4
    assert lmm._spec_dec is not None and lmm._spec_dec.draft_len == 4
    # beam search: the CRC ids make this one fixed comparison in every
    # process
    want = jlmm.generate_until(requests(JInstance, num_beams=2))
    assert lmm.generate_until(requests(Instance, num_beams=2)) == want


def test_adapter_greedy_on_the_card_takes_the_chunked_decoder(monkeypatch):
    """Greedy decoding on a card device runs the adapter's chunked decoder
    whether the backend says `greedy` or `chunked` (same tokens); on the CPU
    `greedy` stays the eager `generate_greedy`. The card is stood in for by
    the adapter's device alone: the tensors stay on the CPU, where the
    decoder runs its chunks eagerly."""
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    lmm = build_lmm(RunConfig.from_dict(
        {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit",
                   "decode_chunk": 4}, "train": {"bf16": False}}),
        device="cpu")
    batch = port_args(ragged_batch(seed=25, l=8))
    kwargs = {"max_new_tokens": 6}
    want = TM.generate_greedy(lmm.params, lmm.cfg, *batch, max_new_tokens=6,
                              eos_id=lmm.tok.eos_token_id)
    got = lmm._generate(*batch, kwargs)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert lmm._chunked_dec is None
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: "pool")
    lmm.device = torch.device("cuda")
    for backend, replays in (("greedy", 2), ("chunked", 4)):
        lmm.gen_backend = backend
        got = lmm._generate(*batch, kwargs)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert lmm._chunked_dec.replays == replays
    assert lmm._chunked_dec._pool == "pool"
    lmm.gen_backend = "speculative"
    np.testing.assert_array_equal(lmm._generate(*batch, kwargs).numpy(),
                                  want.numpy())
    assert lmm._spec_dec._pool == "pool" and lmm._chunked_dec.replays == 4
