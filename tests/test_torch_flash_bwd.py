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


def test_bwd_dq_delta_forms_on_cpu():
    """Kernel 5's wrapper (on the card the kernel forms δ and writes it for
    kernel 6) returns, with `return_delta=True`, the plain dq and
    δ = rowsum(dO·O) [B, H, Sq]; a given δ is not read; kernel 6's wrapper
    takes the δ so returned."""
    b, s, h, kvh, d = 2, 11, 4, 2, 8
    q = torch.from_numpy(_randn(30, b, s, h, d))
    k = torch.from_numpy(_randn(31, b, s, kvh, d))
    v = torch.from_numpy(_randn(32, b, s, kvh, d))
    do = torch.from_numpy(_randn(33, b, s, h, d))
    out, lse = tflash.flash_attention(q, k, v, causal=True, return_lse=True)
    want = tflash.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            causal=True)
    dq, delta = tflash.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                              causal=True, return_delta=True)
    assert torch.equal(dq, want[0])
    assert delta.shape == (b, h, s)
    assert torch.allclose(delta, (do * out).sum(-1).transpose(1, 2),
                          rtol=0, atol=1e-6)
    assert torch.equal(tflash.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                                     causal=True), dq)
    given = torch.zeros(b, h, s)
    dq_given, delta_given = tflash.flash_attention_bwd_dq(
        q, k, v, out, lse, do, given, causal=True, return_delta=True)
    assert torch.equal(dq_given, dq) and torch.equal(delta_given, delta)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, delta,
                                            causal=True)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])


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


# ---- ALiBi: kernels 5 and 6 recompute P with the bias ----
# Tolerance: the JAX package's own for its ALiBi backward against XLA
# (tests/test_flash_attention.py): 5e-5 absolute plus 1e-3 relative.
ALIBI_TOL = dict(atol=5e-5, rtol=1e-3)


def _jax_alibi_grads(q, k, v, do, causal, slopes):
    g = q.shape[2] // k.shape[2]

    def f(q, k, v):
        return jflash.flash_mha_trainable(
            q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2),
            causal=causal, alibi_slopes=jnp.asarray(slopes), block_q=128,
            block_k=128, interpret=True)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out),) + tuple(np.asarray(x) for x in
                                      vjp(jnp.asarray(do)))


def _slopes(h):
    from law_of_vision_representation_in_mllms_torch.models.mpt import (
        alibi_slopes)
    return alibi_slopes(h)


@pytest.mark.parametrize("causal,s,h,kvh", [
    (True, 96, 4, 4),
    (True, 70, 6, 6),      # interleaved slopes, S not a block multiple
    (False, 70, 4, 4),
    (True, 130, 4, 2),     # GQA: the slope is the query head's
    (False, 33, 8, 1),     # MQA
])
def test_bwd_plain_alibi_matches_jax_flash_vjp(causal, s, h, kvh):
    """The plain biased backward against `jax.grad` through
    `flash_mha_trainable(alibi_slopes=...)` (Pallas backward kernels in
    interpret mode). Under GQA the JAX side repeats K/V to the query heads,
    so each repeated head meets its own slope and dk/dv come back summed:
    the repeated-heads formulation."""
    b, d = 2, 16
    q = _randn(30, b, s, h, d)
    k, v = _randn(31, b, s, kvh, d), _randn(32, b, s, kvh, d)
    do = _randn(33, b, s, h, d)
    sl = _slopes(h)
    want_out, *want = _jax_alibi_grads(q, k, v, do, causal, sl.numpy())
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = tflash.flash_attention_plain(tq, tk, tv, causal=causal,
                                            return_lse=True, alibi_slopes=sl)
    np.testing.assert_allclose(out.numpy(), want_out, **ALIBI_TOL)
    got = tflash.flash_attention_bwd_plain(tq, tk, tv, out, lse, tdo,
                                           causal=causal, alibi_slopes=sl)
    for name, g_got, g_want in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g_got.numpy(), g_want, err_msg=name,
                                   **ALIBI_TOL)
    # the explicit formulas agree with autograd through the plain forward
    # with the materialised bias (they share no backward code)
    lq, lk, lv = (t.clone().requires_grad_() for t in (tq, tk, tv))
    tflash.flash_attention_plain(lq, lk, lv, causal=causal,
                                 alibi_slopes=sl).backward(tdo)
    for name, g_got, leaf in zip(("dq", "dk", "dv"), got, (lq, lk, lv)):
        np.testing.assert_allclose(g_got.numpy(), leaf.grad.numpy(),
                                   err_msg=name, atol=ATOL, rtol=RTOL)


def test_function_alibi_grads_match_jax_flash_vjp():
    """Autograd through `flash_attention(alibi_slopes=...)` on the CPU; the
    slopes take no gradient."""
    b, s, h, kvh, d = 2, 45, 4, 2, 8
    q = _randn(40, b, s, h, d)
    k, v = _randn(41, b, s, kvh, d), _randn(42, b, s, kvh, d)
    do = _randn(43, b, s, h, d)
    sl = _slopes(h)
    _, *want = _jax_alibi_grads(q, k, v, do, True, sl.numpy())
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tflash.flash_attention(tq, tk, tv, causal=True, alibi_slopes=sl)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    assert sl.grad is None
    for name, t, g_want in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), g_want, err_msg=name,
                                   **ALIBI_TOL)


@pytest.mark.parametrize("causal,kv_len,h,kvh", [
    (True, None, 4, 2), (False, 6, 2, 2), (True, 3, 6, 1)])
def test_flash_attention_function_alibi_gradcheck(causal, kv_len, h, kvh):
    """fp64 finite differences through `FlashAttention` with slopes (fp32,
    as the wrapper demands; the plain versions lift them to fp64)."""
    g = torch.Generator().manual_seed(1)
    b, s, d = 2, 9, 4
    q = torch.randn(b, s, h, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    k = torch.randn(b, s, kvh, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    v = torch.randn(b, s, kvh, d, generator=g, dtype=torch.float64,
                    requires_grad=True)
    sl = _slopes(h)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tflash.flash_attention(q, k, v, causal=causal,
                                               kv_len=kv_len,
                                               alibi_slopes=sl),
        (q, k, v))


def test_bwd_wrappers_alibi_take_plain_path_on_cpu():
    b, s, h, kvh, d = 1, 12, 4, 2, 8
    q = torch.from_numpy(_randn(50, b, s, h, d))
    k = torch.from_numpy(_randn(51, b, s, kvh, d))
    v = torch.from_numpy(_randn(52, b, s, kvh, d))
    do = torch.from_numpy(_randn(53, b, s, h, d))
    sl = _slopes(h)
    out, lse = tflash.flash_attention(q, k, v, causal=True, kv_len=7,
                                      return_lse=True, alibi_slopes=sl)
    delta = (do * out).sum(-1).transpose(1, 2).contiguous()
    want = tflash.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                            causal=True, kv_len=7,
                                            alibi_slopes=sl)
    nobias = tflash.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                              causal=True, kv_len=7)
    assert not torch.allclose(want[0], nobias[0], atol=1e-3)
    dq = tflash.flash_attention_bwd_dq(q, k, v, out, lse, do, delta,
                                       causal=True, kv_len=7,
                                       alibi_slopes=sl)
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, out, lse, do, delta,
                                            causal=True, kv_len=7,
                                            alibi_slopes=sl)
    assert torch.equal(dq, want[0])
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
