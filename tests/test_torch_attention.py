"""The port's three attention ops (their plain versions, which the wrappers
run for CPU tensors) against the JAX package's Pallas kernels in interpret
mode, on the same seeded numpy inputs in fp32. Tolerance: 1e-5 absolute
(fp32 on both sides; only the summation order differs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.ops import (
    decode_attention as jdec, encoder_attention as jenc,
    flash_attention as jflash)
from law_of_vision_representation_in_mllms_torch.ops import attention as tatt
from law_of_vision_representation_in_mllms_torch.ops.decode_attention import (
    decode_attention)
from law_of_vision_representation_in_mllms_torch.ops.encoder_attention import (
    encoder_attention)
from law_of_vision_representation_in_mllms_torch.ops.flash_attention import (
    flash_attention)

# One intra-op thread: with two, the first multi-threaded fp32 call in a
# loaded process has been seen to come out ~5e-5 off its fp64 value, over
# the tolerances below; on one thread it stays at ~5e-7.
torch.set_num_threads(1)
ATOL = 1e-5


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("s,d", [(77, 16), (130, 32), (127, 16), (128, 16),
                                 (129, 32)])
def test_encoder_attention_matches_encoder_mha(s, d):
    """S not a multiple of 128: the JAX kernel pads and subtracts the pad
    mass; the port masks the ragged edge (127, 128, 129: the edges of the
    card's 128-key tiles)."""
    q, k, v = (_randn(i, 2, s, 4, d) for i in range(3))
    want = jenc.encoder_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            interpret=True)
    got = encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    _close(got, want)


def _fold_padded(x, s_pad):
    """[B, S, H, D] -> [B * H, s_pad, D], zero rows past S: the JAX kernel's
    callers pad to whole blocks (keys past kv_len are masked, padded query
    rows are dropped)."""
    b, s, h, d = x.shape
    x = np.pad(x, ((0, 0), (0, s_pad - s), (0, 0), (0, 0)))
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s_pad, d))


@pytest.mark.parametrize("causal,kv_len,sq,skv", [
    (True, 100, 128, 128), (False, 75, 128, 128), (True, 128, 128, 128),
    # the edges of the card's 128-row and 128-key tiles, Sq != Skv
    # (top-left causal), kv_len tails
    (True, 100, 127, 129), (False, 120, 129, 127), (True, 129, 128, 129),
    (False, 127, 129, 128), (True, 100, 129, 127)])
def test_flash_attention_matches_fwd_lse_kernel(causal, kv_len, sq, skv):
    """Output and LSE against `_flash_fwd_lse` with a kv_len tail."""
    b, h, d = 2, 2, 16
    q = _randn(10, b, sq, h, d)
    k, v = (_randn(11 + i, b, skv, h, d) for i in range(2))
    sq_pad, skv_pad = -(-sq // 64) * 64, -(-skv // 64) * 64
    out, lse = jflash._flash_fwd_lse(
        _fold_padded(q, sq_pad), _fold_padded(k, skv_pad),
        _fold_padded(v, skv_pad), None, scale=d ** -0.5, causal=causal,
        kv_len=kv_len, block_q=64, block_k=64, interpret=True)
    got, got_lse = flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        kv_len=kv_len, return_lse=True)
    _close(got.numpy().transpose(0, 2, 1, 3).reshape(b * h, sq, d),
           np.asarray(out)[:, :sq])
    _close(got_lse.reshape(b * h, sq), np.asarray(lse)[:, :sq, 0])


def test_flash_attention_gqa_matches_repeated_kv():
    """Query head h reads kv head h // G in the port; the JAX prefill
    repeats K/V before `flash_mha_trainable` (`llama.py:373-376`)."""
    b, s, h, kvh, d = 2, 70, 4, 2, 16
    q = _randn(20, b, s, h, d)
    k, v = _randn(21, b, s, kvh, d), _randn(22, b, s, kvh, d)
    want = jflash.flash_mha_trainable(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), h // kvh, axis=2),
        jnp.repeat(jnp.asarray(v), h // kvh, axis=2), causal=True,
        interpret=True)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=True)
    _close(got, want)


def _decode_mask(b, t, seed):
    mask = np.random.RandomState(seed).rand(b, t) < 0.6   # holes
    mask[:, 128:256] = False                  # one fully masked 128-slot tile
    mask[:, :3] = True
    return mask


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
def test_decode_attention_matches_pallas_decode(h, kvh):
    b, t, d = 2, 300, 16
    q = _randn(30, b, 1, h, d)
    k, v = _randn(31, b, t, kvh, d), _randn(32, b, t, kvh, d)
    mask = _decode_mask(b, t, 33)
    want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(mask),
                                 interpret=True)
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    _close(got, want)


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2)])
def test_decode_attention_matches_stacked_pallas_decode(h, kvh):
    """`decode_attn="pallas_stacked"`: the TPU kernel indexes the layer
    inside the stacked [L, B, T, KV, Dh] cache; the port's per-layer cache
    tensor is that slice, so kernel 3's wrapper gets `cache[layer]`. Holes
    and a fully masked tile, never a fully masked row."""
    layers, b, t, d = 3, 2, 300, 16
    q = _randn(50, b, 1, h, d)
    ck, cv = _randn(51, layers, b, t, kvh, d), _randn(52, layers, b, t, kvh, d)
    mask = _decode_mask(b, t, 53)
    for layer in (0, 2):
        want = jdec.decode_attention_stacked(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), layer,
            jnp.asarray(mask), interpret=True)
        got = decode_attention(torch.from_numpy(q),
                               torch.from_numpy(ck)[layer],
                               torch.from_numpy(cv)[layer],
                               torch.from_numpy(mask))
        _close(got, want)


def _ragged_mask(b, t, seed):
    """A masked stretch that does not line up with the 128-slot tiles (nor
    with kernel 3's 32-slot ones), and a row whose only visible slot is the
    last."""
    mask = np.random.RandomState(seed).rand(b, t) < 0.6
    mask[:, 70:250] = False
    mask[:, 0] = True
    mask[-1] = False
    mask[-1, -1] = True
    return mask


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
def test_decode_attention_ragged_mask_matches_pallas_decode(h, kvh, stacked):
    b, t, d = 3, 300, 16
    q = _randn(70, b, 1, h, d)
    k, v = _randn(71, b, t, kvh, d), _randn(72, b, t, kvh, d)
    mask = _ragged_mask(b, t, 73)
    if stacked:     # layer 1 of a [L, B, T, KV, Dh] cache
        want = jdec.decode_attention_stacked(
            jnp.asarray(q), jnp.stack([jnp.zeros_like(k), k]),
            jnp.stack([jnp.zeros_like(v), v]), 1, jnp.asarray(mask),
            interpret=True)
    else:
        want = jdec.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(mask),
                                     interpret=True)
    got = decode_attention(*(torch.from_numpy(x) for x in (q, k, v, mask)))
    _close(got, want)
    # the last row attends to its last slot alone: its value rows
    rep = h // kvh
    np.testing.assert_allclose(
        got[-1, 0].numpy(), np.repeat(v[-1, -1], rep, axis=0), atol=1e-6)


@pytest.mark.parametrize("kw", [{}, {"pretransposed": False},
                                {"pad_d": 128}, {"head_block": 2}])
def test_encoder_attention_matches_encoder_mha_v2(kw):
    """`tower_attn_impl="encoder2*"`: the per-head 2-D-dot TPU kernel and its
    layout options compute kernel 1's function."""
    q, k, v = (_randn(60 + i, 2, 77, 4, 16) for i in range(3))
    want = jenc.encoder_mha_v2(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True, **kw)
    got = encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    _close(got, want)


@pytest.mark.parametrize("s", [77, 130])
def test_flash_attention_matches_flash_mha_noncausal(s):
    """`tower_attn_impl="flash"`: the TPU kernel `flash_attention_bhsd`
    (through `flash_mha`, non-causal, no ALiBi) against the port's kernel-2
    wrapper with `causal=False` and `kv_len = S`."""
    q, k, v = (_randn(70 + i, 2, s, 4, 16) for i in range(3))
    want = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, interpret=True)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          causal=False)
    _close(got, want)


def test_decode_attention_rejects_quantized_cache():
    """An int8 cache is taken with both of its scales in the cache's
    [B, T, KV] shape (tests/test_torch_quant.py holds the values); half a
    pair or another shape is refused."""
    q = torch.zeros(1, 1, 2, 8)
    kv = torch.zeros(1, 4, 2, 8, dtype=torch.int8)
    scales = torch.ones(1, 4, 2)
    mask = torch.ones(1, 4, dtype=torch.bool)
    assert decode_attention(q, kv, kv, mask, scales, scales).shape == q.shape
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        decode_attention(q, kv, kv, mask, scales, None)
    with pytest.raises(ValueError, match="v_scale must be"):
        decode_attention(q, kv, kv, mask, scales, scales[..., :1])


def test_plain_mha_and_causal_mask_match_jax():
    from law_of_vision_representation_in_mllms_tpu.ops import attention as ja
    q, k, v = (_randn(40 + i, 2, 9, 3, 8) for i in range(3))
    mask = np.array(ja.causal_mask(9, 9))[None, None]
    np.testing.assert_array_equal(tatt.causal_mask(9, 9).numpy(), mask[0, 0])
    want = ja.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=jnp.asarray(mask))
    got = tatt.mha(*(torch.from_numpy(x) for x in (q, k, v)),
                   mask=torch.from_numpy(mask))
    _close(got, want)


# ---- ALiBi (MPT): the bias the TPU kernels build from per-head slopes ----
# Tolerance 3e-5 absolute: the JAX package's own tolerance for its in-kernel
# bias against the biased `mha` (tests/test_flash_attention.py); the bias
# reaches -slope * (S - 1), where fp32 resolves less than at the unbiased
# logits' size.
ALIBI_ATOL = 3e-5


def _slopes(h):
    from law_of_vision_representation_in_mllms_torch.models.mpt import (
        alibi_slopes)
    return alibi_slopes(h)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,h", [(130, 4), (77, 6)])
def test_flash_attention_alibi_matches_flash_mha_and_biased_mha(causal, s,
                                                                h):
    """The plain version with the materialised bias against the TPU kernel's
    in-kernel bias (`flash_mha(alibi_slopes=...)`, interpret mode) and
    against both packages' biased `mha`; S not a block multiple, H = 6 with
    interleaved slopes."""
    from law_of_vision_representation_in_mllms_tpu.models import mpt as jmpt
    from law_of_vision_representation_in_mllms_tpu.ops import attention as ja
    from law_of_vision_representation_in_mllms_torch.models import mpt as tmpt
    b, d = 2, 16
    q, k, v = (_randn(80 + i, b, s, h, d) for i in range(3))
    want = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, alibi_slopes=jmpt.alibi_slopes(h),
                            block_q=128, block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal,
                          alibi_slopes=_slopes(h))
    _close(got, want, ALIBI_ATOL)
    jmask = ja.causal_mask(s, s)[None, None] if causal else None
    want_mha = ja.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      bias=jmpt.alibi_bias(h, s)[None], mask=jmask)
    _close(got, want_mha, ALIBI_ATOL)
    tmask = tatt.causal_mask(s, s)[None, None] if causal else None
    got_mha = tatt.mha(tq, tk, tv, bias=tmpt.alibi_bias(h, s)[None],
                       mask=tmask)
    _close(got_mha, want_mha, ALIBI_ATOL)
    # the bias is really there
    assert (got - flash_attention(tq, tk, tv, causal=causal)).abs().max() \
        > 1e-2


@pytest.mark.parametrize("causal,kv_len", [(True, 100), (False, 75),
                                           (True, 128)])
def test_flash_attention_alibi_lse_matches_fwd_lse_kernel(causal, kv_len):
    """Output and LSE against `_flash_fwd_lse` with slopes and a kv_len
    tail: the LSE is that of the biased logits, offset -slope * (kv_len - 1)
    included (it is what the backward subtracts). [B, H] slopes that differ
    by batch row, as `flash_attention_bhsd` takes them."""
    b, s, h, d = 2, 128, 2, 16
    q, k, v = (_randn(90 + i, b, s, h, d) for i in range(3))
    slopes = np.array([[0.5, 0.0625], [0.25, 0.7]], np.float32)

    def fold(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))
    slopes8 = jnp.broadcast_to(jnp.asarray(slopes.reshape(b * h))[:, None],
                               (b * h, 8))
    out, lse = jflash._flash_fwd_lse(
        fold(q), fold(k), fold(v), slopes8, scale=d ** -0.5, causal=causal,
        kv_len=kv_len, block_q=64, block_k=64, interpret=True)
    got, got_lse = flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        kv_len=kv_len, return_lse=True,
        alibi_slopes=torch.from_numpy(slopes))
    _close(got.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d), out,
           ALIBI_ATOL)
    _close(got_lse.reshape(b * h, s), np.asarray(lse)[..., 0], ALIBI_ATOL)
    # the offset is in the LSE: it differs from the unbiased one
    _, plain_lse = flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        kv_len=kv_len, return_lse=True)
    assert (got_lse - plain_lse).abs().max() > 1.0


def test_flash_attention_alibi_rows_without_keys_and_sq_ne_skv():
    """Sq != Skv with a kv_len tail, non-causal and causal: the bias counts
    from kv_len - 1, not from Skv - 1; under causality with kv_len = 0 no
    row sees a key and output and LSE stay 0."""
    b, sq, skv, h, d, kv_len = 1, 20, 50, 4, 8, 37
    q = torch.from_numpy(_randn(100, b, sq, h, d))
    k, v = (torch.from_numpy(_randn(101 + i, b, skv, h, d)) for i in (0, 1))
    sl = _slopes(h)
    got, lse = flash_attention(q, k, v, kv_len=kv_len, return_lse=True,
                               alibi_slopes=sl)
    dist = torch.arange(kv_len, dtype=torch.float32) - (kv_len - 1)
    want = tatt.mha(q, k[:, :kv_len], v[:, :kv_len],
                    bias=(sl[:, None, None] * dist)[None])
    _close(got, want, ALIBI_ATOL)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k[:, :kv_len]) * d ** -0.5 \
        + sl[None, :, None, None] * dist
    _close(lse, torch.logsumexp(logits, dim=-1), ALIBI_ATOL)
    out0, lse0 = flash_attention(q, k, v, causal=True, kv_len=0,
                                 return_lse=True, alibi_slopes=sl)
    assert (out0 == 0).all() and (lse0 == 0).all()


def test_flash_attention_alibi_slopes_are_checked():
    q = torch.zeros(2, 8, 4, 8)
    sl = _slopes(4)
    assert flash_attention(q, q, q, alibi_slopes=sl).shape == q.shape
    assert flash_attention(q, q, q,
                           alibi_slopes=sl[None].repeat(2, 1)).shape == q.shape
    for bad in (sl[:3], sl.double(), sl[None].repeat(3, 1), [0.5] * 4):
        with pytest.raises(ValueError, match="alibi_slopes"):
            flash_attention(q, q, q, alibi_slopes=bad)
