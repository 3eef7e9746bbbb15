"""The port's flash-attention backward (the plain version beside kernels 5
and 6, which `FlashAttention` runs for CPU tensors) against `jax.grad`
through the JAX package's `flash_mha_trainable` with its Pallas backward
kernels in interpret mode, on the same seeded numpy inputs in fp32; a fp64
`gradcheck` of the `FlashAttention` Function; and the forward-only kernel
wrappers refusing to cut a graph.

Tolerance against JAX: 1e-5 absolute plus 1e-4 relative (fp32 on both
sides, the same formulas; only the summation order differs, and the JAX
kernel sums over 128-padded blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.ops import (
    flash_attention as jflash)
from law_of_vision_representation_in_mllms_torch.ops import (
    decode_attention as tdec, encoder_attention as tenc,
    flash_attention as tflash)

# One intra-op thread: with two, the first multi-threaded fp32 call in a
# loaded process has been seen to come out ~5e-5 off its fp64 value, over
# the tolerances below; on one thread it stays at ~5e-7.
torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4


def _randn(seed, *shape, dtype=np.float32):
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def _jax_grads(q, k, v, do, causal):
    """(out, dq, dk, dv) of `flash_mha_trainable` with K/V repeated to the
    query heads, as the JAX decoder does (`models/llama.py:373-377`): the
    dk/dv of a kv head come back summed through the repeat's transpose."""
    g = q.shape[2] // k.shape[2]

    def f(q, k, v):
        return jflash.flash_mha_trainable(
            q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2),
            causal=causal, interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out),) + tuple(np.asarray(x) for x in
                                      vjp(jnp.asarray(do)))


@pytest.mark.parametrize("causal,s,h,kvh", [
    (True, 70, 4, 4),      # S not a multiple of the block
    (False, 70, 4, 4),
    (True, 130, 4, 2),     # GQA, S past one 128 block
    (False, 33, 8, 1),     # MQA
])
def test_bwd_plain_matches_jax_flash_vjp(causal, s, h, kvh):
    b, d = 2, 16
    q = _randn(0, b, s, h, d)
    k, v = _randn(1, b, s, kvh, d), _randn(2, b, s, kvh, d)
    do = _randn(3, b, s, h, d)
    want_out, *want = _jax_grads(q, k, v, do, causal)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tflash.flash_attention_plain(tq, tk, tv, causal=causal,
                                            return_lse=True)
    np.testing.assert_allclose(out.numpy(), want_out, atol=ATOL, rtol=RTOL)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                           causal=causal)
    for name, g_got, g_want in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g_got.numpy(), g_want, atol=ATOL,
                                   rtol=RTOL, err_msg=name)


def test_function_grads_match_jax_flash_vjp():
    """Autograd through `flash_attention` (the Function) on the CPU."""
    b, s, h, kvh, d = 2, 45, 4, 2, 8
    q = _randn(10, b, s, h, d)
    k, v = _randn(11, b, s, kvh, d), _randn(12, b, s, kvh, d)
    do = _randn(13, b, s, h, d)
    _, *want = _jax_grads(q, k, v, do, True)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=True)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    for name, t, g_want in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), g_want, atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal,kv_len,h,kvh", [
    (True, None, 4, 2), (False, 6, 2, 2), (True, 3, 4, 1)])
def test_flash_attention_function_gradcheck(causal, kv_len, h, kvh):
    """fp64 finite differences through `FlashAttention` (forward: plain
    kernel-2 version; backward: the plain kernels 5/6 formulas), including
    a kv_len tail whose rows past it see no key at all."""
    g = torch.Generator().manual_seed(0)
    b, s, d = 2, 9, 4
    q = torch.randn(b, s, h, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    k = torch.randn(b, s, kvh, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    v = torch.randn(b, s, kvh, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tflash.flash_attention(q, k, v, causal=causal,
                                               kv_len=kv_len),
        (q, k, v))


def test_bwd_wrappers_take_plain_path_on_cpu():
    """Kernels 5 and 6's wrappers return their parts of the plain backward
    for CPU tensors and count no launch; a row past kv_len gets zero grads."""
    b, s, h, kvh, d = 1, 12, 4, 2, 8
    q = torch.from_numpy(_randn(20, b, s, h, d))
    k = torch.from_numpy(_randn(21, b, s, kvh, d))
    v = torch.from_numpy(_randn(22, b, s, kvh, d))
    do = torch.from_numpy(_randn(23, b, s, h, d))
    out, lse = tflash.flash_attention(q, k, v, causal=False, kv_len=7,
                                      return_lse=True)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    want = tflash.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            causal=False, kv_len=7)
    before = (tflash.flash_attention_bwd_dq.launches,
              tflash.flash_attention_bwd_dkv.launches)
    dq = tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, delta,
                                       causal=False, kv_len=7)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, delta,
                                            causal=False, kv_len=7)
    assert torch.equal(dq, want[0])
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    assert (dk[:, 7:] == 0).all() and (dv[:, 7:] == 0).all()
    assert (tflash.flash_attention_bwd_dq.launches,
            tflash.flash_attention_bwd_dkv.launches) == before


def test_forward_only_wrappers_refuse_grad():
    """Kernels 1 and 3 have no backward: under grad mode with an input that
    requires grad their wrappers raise instead of returning a result with
    no grad_fn; under no_grad (the towers, generation) they run."""
    q = torch.randn(2, 10, 2, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tenc.encoder_attention(q, q, q)
    qd = torch.randn(2, 1, 2, 8, requires_grad=True)
    kv = torch.randn(2, 10, 2, 8)
    mask = torch.ones(2, 10, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="forward-only"):
        tdec.decode_attention(qd, kv, kv, mask)
    with torch.no_grad():
        assert tenc.encoder_attention(q, q, q).shape == q.shape
        assert tdec.decode_attention(qd, kv, kv, mask).shape == qd.shape
    plain = torch.randn(2, 10, 2, 8)
    assert tenc.encoder_attention(plain, plain, plain).shape == plain.shape
