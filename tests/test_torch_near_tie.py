"""Token comparisons between code paths that give the same answer in every
process, and that tell a near tie from a fault.

Both packages' `SimpleTokenizer` hashes each word with Python's `hash`,
which is salted per process, so a test's prompts would draw other token ids
in every run. `CrcTokenizer` takes the ids from a CRC of each word instead
(as `chip_smoke.py` phase 3c does), and `use_crc_ids` puts it into the
adapters under test.

Two paths of one model can still part where the reference's top two logits
nearly tie: rounding that the paths do differently (the int8 cache, int4
weights, another summation order) may flip the pick. `check_tokens` compares
tokens exactly; where a row differs, the reference's logits, computed along
the reference's own tokens, must show a top-2 gap under `NEAR_TIE` at the
first step that differs, and the test fails otherwise (the rule of
`chip_smoke.py`'s `near_tie_gaps` / `check_tokens`).
"""

import re
import zlib

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.data.preprocess import (
    SimpleTokenizer)

torch.set_num_threads(1)

NEAR_TIE = 1e-3


class CrcTokenizer(SimpleTokenizer):
    """Stable ids: a CRC of each word; a word `t<id>`, as `decode` writes
    it, is that id."""

    def encode(self, text, add_special_tokens=False):
        ids = [int(w[1:]) if re.fullmatch(r"t\d+", w)
               else 3 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
               for w in text.split()]
        return [self.bos_token_id] + ids if add_special_tokens else ids


def use_crc_ids(*lmms) -> None:
    """Gives each adapter a `CrcTokenizer` of its tokenizer's vocab."""
    for lmm in lmms:
        lmm.tok = CrcTokenizer(vocab_size=lmm.tok.vocab_size)


def answer_ids(text: str, n: int, eos: int) -> list:
    """The token ids of a `generate_until` answer of the hash or CRC
    tokenizer (its words are `t<id>`), eos-padded to `n`."""
    ids = [int(w[1:]) for w in text.split()]
    return ids + [eos] * (n - len(ids))


def first_differences(want, got) -> dict:
    """{row: first step where `got` differs from `want`}."""
    want, got = np.asarray(want), np.asarray(got)
    diff = want != got
    return {r: int(np.nonzero(diff[r])[0][0]) for r in range(len(diff))
            if diff[r].any()}


def check_tokens(want, got, forced_logits) -> list:
    """`got` [B, n] must equal the reference's tokens `want` [B, n], or part
    from them only at a near tie. `forced_logits(want)` gives the
    reference's logits [B, n, V] along its own tokens (step t's row picks
    token t); it is called only when a row differs. Returns [(row, step,
    gap)] of the rows that differ."""
    first = first_differences(want, got)
    if not first:
        return []
    logits = np.asarray(forced_logits(np.asarray(want)), np.float64)
    gaps = []
    for r, step in first.items():
        top2 = np.sort(logits[r, step])[-2:]
        gap = float(top2[1] - top2[0])
        assert gap < NEAR_TIE, (
            f"row {r} differs at step {step} ({np.asarray(got)[r].tolist()} "
            f"against the reference's {np.asarray(want)[r].tolist()}) where "
            f"the reference's top-2 logit gap is {gap:.3e}, not a near tie "
            f"(< {NEAR_TIE})")
        gaps.append((r, step, gap))
    return gaps


def port_forced_logits(params, cfg, ids, mask, pixels, tokens):
    """The port's eager logits [B, n, V] along `tokens` [B, n]: the prefill's,
    then one `decode_step` a token."""
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    tokens = torch.as_tensor(np.asarray(tokens)).long()
    n = tokens.shape[1]
    pre = M.prefill(params, cfg, ids, mask, pixels, max_new_tokens=n)
    out = [pre.logits]
    for t in range(n - 1):
        out.append(M.decode_step(params, pre, tokens[:, t], t))
    return torch.stack(out, dim=1).numpy()


def jax_forced_logits(params, cfg, ids, mask, pixels, tokens, precision,
                      diffusion_apply=None):
    """The JAX package's logits [B, n, V] along `tokens` [B, n]: its
    `generate_greedy` (no flash, as it runs off the TPU) with each step fed
    the given token."""
    import jax.numpy as jnp
    from law_of_vision_representation_in_mllms_tpu.models import llama as JL
    from law_of_vision_representation_in_mllms_tpu.models import llava as JM
    from law_of_vision_representation_in_mllms_tpu.models.splice import (
        IGNORE_INDEX, splice_embeds, splice_plan)
    tokens = jnp.asarray(np.asarray(tokens), jnp.int32)
    b, n = tokens.shape
    dparams = params["decoder"]
    plan = splice_plan(ids, jnp.full_like(ids, IGNORE_INDEX), mask,
                       cfg.num_patches)
    img = JM.encode_images(params, cfg, pixels, precision, diffusion_apply)
    embeds = splice_embeds(plan, JL.embed_tokens(dparams, ids, precision),
                           img)
    l_out = embeds.shape[1]
    cache = JL.init_cache(cfg.decoder, b, l_out + n, precision.compute_dtype,
                          quant=cfg.kv_quant)
    valid = jnp.concatenate([plan.attn_mask, jnp.zeros((b, n), bool)], 1)
    h, cache = JL.forward(dparams, cfg.decoder, embeds, plan.positions,
                          attn_mask=valid, cache=cache, cache_index=0,
                          precision=precision, use_flash=False)
    pos = jnp.sum(plan.attn_mask, axis=1)
    h_last = jnp.take_along_axis(h, jnp.maximum(pos - 1, 0)[:, None, None],
                                 axis=1)
    out = [JL.logits_fn(dparams, h_last, precision)[:, -1]]
    for t in range(n - 1):
        valid = jnp.concatenate([plan.attn_mask, jnp.broadcast_to(
            jnp.arange(n) <= t, (b, n))], axis=1)
        h, cache = JL.forward(dparams, cfg.decoder,
                              JL.embed_tokens(dparams, tokens[:, t:t + 1],
                                              precision),
                              pos[:, None], attn_mask=valid, cache=cache,
                              cache_index=l_out + t, precision=precision)
        out.append(JL.logits_fn(dparams, h, precision)[:, -1])
        pos = pos + 1
    return np.stack([np.asarray(x, np.float32) for x in out], axis=1)


def check_answers(jlmm, jrequests, want, got) -> list:
    """`generate_until` answers of the port (`got`) against the JAX
    adapter's (`want`) on the same requests (`jrequests`, the JAX
    `Instance`s), with `check_tokens`'s rule: the JAX model's logits along
    its own answer decide whether a differing answer parted at a near tie.
    Every request has the first request's `max_new_tokens`."""
    if got == want:
        return []
    n = jrequests[0].args[1].get("max_new_tokens", 16)
    eos = jlmm.tok.eos_token_id
    want_ids = [answer_ids(t, n, eos) for t in want]
    got_ids = [answer_ids(t, n, eos) for t in got]
    ids, mask, pixels = jlmm._encode_batch(jrequests)
    return check_tokens(want_ids, got_ids, lambda toks: jax_forced_logits(
        jlmm.params, jlmm.cfg, ids, mask, pixels, toks, jlmm.precision,
        jlmm.diffusion_apply))


def test_crc_ids_are_fixed():
    """The ids are a CRC of each word, not Python's salted `hash`: the
    same in every process, and `t<id>` words round-trip."""
    tok = CrcTokenizer(vocab_size=256)
    assert tok.encode("describe the image") == [
        3 + zlib.crc32(w) % 253 for w in (b"describe", b"the", b"image")]
    assert tok.encode("describe the image", add_special_tokens=True)[0] == 1
    assert tok.encode(tok.decode([7, 250, 3])) == [7, 250, 3]
    assert answer_ids(tok.decode([7, 250]), 4, eos=2) == [7, 250, 2, 2]


@pytest.mark.parametrize("gap, passes", [(8.3e-5, True), (9e-4, True),
                                         (2e-3, False), (0.5, False)])
def test_check_tokens_allows_only_near_ties(gap, passes):
    """A row that parts from the reference passes only where the
    reference's top two logits lay under `NEAR_TIE` apart; equal tokens
    never ask for the reference's logits."""
    want = np.array([[5, 6, 7, 2], [4, 4, 4, 4]])
    got = np.array([[5, 6, 9, 2], [4, 4, 4, 4]])
    logits = np.zeros((2, 4, 10), np.float32)
    logits[0, 2, 7] = 1.0
    logits[0, 2, 9] = 1.0 - gap

    def forced(tokens):
        np.testing.assert_array_equal(tokens, want)
        return logits
    assert check_tokens(want, want, lambda _: pytest.fail("called")) == []
    if passes:
        ((row, step, seen),) = check_tokens(want, got, forced)
        assert (row, step) == (0, 2) and seen == pytest.approx(gap, rel=1e-3)
    else:
        with pytest.raises(AssertionError, match="not a near tie"):
            check_tokens(want, got, forced)
