"""The port's ring attention (`ops/ring_attention.py`) against the JAX
package's `make_ring_attention` on a 4-device mesh of the 8 host devices.

The port's `ring_attention` runs the 4 ranks of a `LocalRing` in one
process: at step t rank r takes the block of rank (r - t) mod 4, as a
group's ring hands it over. Both routes are checked, forward and q / k / v
gradients:

- plain (`ring_attention_plain`, gradients by autograd through the
  rotation): fp32 tolerance, the JAX test's atol 2e-5, rtol 1e-4, at every
  row;
- flash (`RingFlashAttention`: kernels 2, 5 and 6 through their plain
  versions on the CPU, the partials merged in fp32, dK / dV travelling
  with their blocks): the same tolerance at valid rows. The flash route
  takes no key mask (the padding contract of right-padded batches): only a
  pad query differs from the masked JAX ring, so dO is zero at pad rows, as
  the ignored labels make it in training, and out / dq are compared at
  valid rows.

Cases: causal with a right-padded row, non-causal without padding, GQA (4
query heads over 2 kv heads) throughout; the plain route also non-causal
with the padded row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from law_of_vision_representation_in_mllms_tpu.ops.ring_attention import (
    make_ring_attention)
from law_of_vision_representation_in_mllms_torch.ops import ring_attention as R

torch.set_num_threads(1)

N = 4                       # ring shards
B, S, H, KV, D = 2, 32, 4, 2, 16
PAD = 7                     # row 1's last PAD tokens are padding
TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(padded: bool):
    rng = np.random.RandomState(5)
    q, k, v, do = (rng.randn(*shape).astype(np.float32)
                   for shape in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                                 (B, S, H, D)))
    mask = np.ones((B, S), bool)
    if padded:
        mask[1, -PAD:] = False
    return q, k, v, do, mask


@functools.lru_cache(maxsize=None)
def _jax_ring(causal: bool, padded: bool, zero_pad_do: bool):
    """JAX forward and (dq, dk, dv) of sum(out * dO) on a 4-device ring."""
    q, k, v, do, mask = _inputs(padded)
    if zero_pad_do:
        do = do * mask[:, :, None, None]
    mesh = Mesh(np.array(jax.devices()[:N]), ("seq",))
    ring = make_ring_attention(mesh, axis_name="seq", causal=causal,
                               with_mask=True)

    def loss(q_, k_, v_):
        return jnp.sum(ring(q_, k_, v_, jnp.asarray(mask)) * do)
    out = jax.jit(ring)(q, k, v, jnp.asarray(mask))
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _shards(x):
    """The N ranks' shards of x [B, S, ...] along the sequence."""
    return list(x.chunk(N, dim=1))


def _local_ring(q, k, v, causal, *, mask=None, flash=False):
    """`ring_attention` over a `LocalRing` of N: the whole output."""
    outs = R.ring_attention(_shards(q), _shards(k), _shards(v),
                            ring=R.LocalRing(N), causal=causal,
                            kv_masks=None if mask is None else _shards(mask),
                            flash=flash)
    return torch.cat(outs, 1)


@pytest.mark.parametrize("causal,padded", [(True, True), (False, False),
                                           (False, True)])
def test_plain_ring_matches_jax(causal, padded):
    """The plain route's forward and gradients at fp32 tolerance."""
    q, k, v, do, mask = _inputs(padded)
    want_out, want_grads = _jax_ring(causal, padded, False)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = _local_ring(qt, kt, vt, causal, mask=torch.from_numpy(mask))
    np.testing.assert_allclose(out.detach().numpy(), want_out, **TOL)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("causal,padded", [(True, True), (False, False)])
def test_flash_ring_matches_jax_at_valid_rows(causal, padded):
    """`RingFlashAttention` (the kernels' plain versions), out and dq at
    valid rows, dk and dv at every key, against the masked JAX ring, with
    dO zero at pad rows."""
    q, k, v, do, mask = _inputs(padded)
    do = do * mask[:, :, None, None]
    want_out, (w_dq, w_dk, w_dv) = _jax_ring(causal, padded, True)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = _local_ring(qt, kt, vt, causal, flash=True)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    out = out.detach()
    np.testing.assert_allclose(out.numpy()[mask], want_out[mask], **TOL)
    np.testing.assert_allclose(dq.numpy()[mask], w_dq[mask], **TOL)
    np.testing.assert_allclose(dk.numpy(), w_dk, **TOL)
    np.testing.assert_allclose(dv.numpy(), w_dv, **TOL)


def test_flash_ring_skips_blocks_above_the_diagonal():
    """A causal ring of 4 launches 10 blocks (1 + 2 + 3 + 4), 4 of them
    causal; a non-causal one all 16."""
    launched = [(src, r) for r in range(N) for src in range(N)
                if R.block_launched(src, r, True)]
    assert len(launched) == 10
    assert sum(src == r for src, r in launched) == N
    assert sum(R.block_launched(s, r, False) for r in range(N)
               for s in range(N)) == N * N


def test_merge_of_two_halves_is_the_whole():
    """`merge_blocks` of a causal first half and a non-causal second half
    of the keys is kernel 2's plain version over all of them."""
    q, k, v, _, _ = _inputs(False)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    half = S // 2
    qs = q[:, half:]
    o_a, l_a = R.flash_block_forward(qs, k[:, :half], v[:, :half],
                                     causal=False)
    o_b, l_b = R.flash_block_forward(qs, k[:, half:], v[:, half:],
                                     causal=True)
    out, lse = R.merge_blocks(*R.merge_blocks(None, None, o_a, l_a), o_b,
                              l_b)
    assert lse.is_contiguous() and lse.dtype == torch.float32
    from law_of_vision_representation_in_mllms_torch.ops.flash_attention \
        import flash_attention_plain
    want, want_lse = flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    np.testing.assert_allclose(out.numpy(), want[:, half:].numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse[:, :, half:].numpy(),
                               **TOL)
