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


@pytest.mark.parametrize("s,d", [(77, 16), (130, 32)])
def test_encoder_attention_matches_encoder_mha(s, d):
    """S not a multiple of 128: the JAX kernel pads and subtracts the pad
    mass; the port masks the ragged edge."""
    q, k, v = (_randn(i, 2, s, 4, d) for i in range(3))
    want = jenc.encoder_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            interpret=True)
    got = encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    _close(got, want)


@pytest.mark.parametrize("causal,kv_len", [(True, 100), (False, 75),
                                           (True, 128)])
def test_flash_attention_matches_fwd_lse_kernel(causal, kv_len):
    """Output and LSE against `_flash_fwd_lse` with a kv_len tail."""
    b, s, h, d = 2, 128, 2, 16
    q, k, v = (_randn(10 + i, b, s, h, d) for i in range(3))

    def fold(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))
    out, lse = jflash._flash_fwd_lse(
        fold(q), fold(k), fold(v), None, scale=d ** -0.5, causal=causal,
        kv_len=kv_len, block_q=64, block_k=64, interpret=True)
    got, got_lse = flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        kv_len=kv_len, return_lse=True)
    _close(got.numpy().transpose(0, 2, 1, 3).reshape(b * h, s, d), out)
    _close(got_lse.reshape(b * h, s), np.asarray(lse)[..., 0])


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


def test_decode_attention_rejects_quantized_cache():
    q = torch.zeros(1, 1, 2, 8)
    kv = torch.zeros(1, 4, 2, 8)
    scales = torch.ones(1, 4, 2)
    with pytest.raises(NotImplementedError):
        decode_attention(q, kv, kv, torch.ones(1, 4, dtype=torch.bool),
                         scales, scales)


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
