"""The port's MPT decoder against the JAX package's `models/mpt.py` on the
same weights (carried across with `io.from_jax`) and the same seeded numpy
ids, in fp32 on the CPU; `port_mpt` against HF `MptForCausalLM`.

The JAX flash route runs its Pallas kernels (in-kernel ALiBi, forward and
backward) in interpret mode; the port's flash route runs the plain versions
of kernels 2, 5 and 6 with the materialised bias, as every wrapper does for a
CPU tensor.

Tolerances: slopes and bias 1e-6 absolute (the JAX package's own against
HF); logits 3e-5 absolute + 1e-4 relative and gradients 5e-5 absolute + 2e-3
relative, the JAX package's own between its two routes (tests/test_mpt.py);
HF logits 3e-4 absolute + 1e-3 relative, as the JAX golden test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import mpt as JM
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import mpt as TM
from law_of_vision_representation_in_mllms_torch.ops import (
    flash_attention as tflash)

torch.set_num_threads(1)
LOGIT_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=2e-3)


@pytest.mark.parametrize("h", [4, 6, 8, 32])
def test_alibi_slopes_and_bias_match_jax(h):
    """H = 6 is no power of two: the slopes of 8 heads interleave."""
    np.testing.assert_allclose(TM.alibi_slopes(h).numpy(),
                               np.asarray(JM.alibi_slopes(h)), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(TM.alibi_slopes(h, 4.0).numpy(),
                               np.asarray(JM.alibi_slopes(h, 4.0)),
                               atol=1e-6, rtol=1e-6)
    got = TM.alibi_bias(h, 12)
    assert got.shape == (h, 1, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(JM.alibi_bias(h, 12)),
                               atol=1e-6)


def test_alibi_bias_matches_hf():
    tf = pytest.importorskip("transformers")
    from transformers.models.mpt.modeling_mpt import build_mpt_alibi_tensor
    del tf
    for h in (4, 6, 8):
        np.testing.assert_allclose(TM.alibi_bias(h, 12).numpy(),
                                   build_mpt_alibi_tensor(h, 12).numpy(),
                                   atol=1e-6)


def _pair(seed=1, **kw):
    """(JAX cfg, JAX params, port cfg, port model) from one JAX init."""
    kw = dict(dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4),
              **kw)
    jcfg, tcfg = JM.tiny(**kw), TM.tiny(**kw)
    assert jcfg.__dict__ == tcfg.__dict__
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    model = TM.MptModel(tcfg, FP32_PRECISION)
    model.load_state_dict(from_jax.mpt_state_dict(
        jax.tree.map(np.asarray, jparams)))
    return jcfg, jparams, tcfg, model


def _ids(seed, b=2, s=9, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, size=(b, s))


@pytest.mark.parametrize("heads", [4, 6])
@pytest.mark.parametrize("use_flash", [False, True])
def test_mpt_logits_and_grads_match_jax(use_flash, heads):
    """Logits and EVERY parameter gradient, on both attention routes; with
    6 heads (hidden 48) the interleaved slopes."""
    jcfg, jparams, tcfg, model = _pair(hidden_size=8 * heads,
                                       num_heads=heads)
    ids = _ids(2)
    ids[0, 3] = 1000           # clipped into the vocabulary on both sides

    def jloss(p):
        lg = JM.forward(p, jcfg, jnp.asarray(ids), precision=J_FP32,
                        use_flash=use_flash)
        return jnp.mean(jax.nn.log_softmax(lg)[:, :-1, 0]), lg
    (_, want), g_want = jax.value_and_grad(jloss, has_aux=True)(jparams)

    for p in model.parameters():
        p.requires_grad_(True)
    before = tflash.flash_attention.launches
    logits = model(torch.from_numpy(ids), use_flash=use_flash)
    assert tflash.flash_attention.launches == before     # no card here
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               **LOGIT_TOL)
    torch.log_softmax(logits, -1)[:, :-1, 0].mean().backward()
    want_sd = from_jax.mpt_state_dict(jax.tree.map(np.asarray, g_want))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want_sd)
    for name, g in want_sd.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_mpt_routes_agree_and_default_route_is_plain_on_cpu():
    _, _, _, model = _pair(3)
    ids = torch.from_numpy(_ids(4, s=13))
    with torch.no_grad():
        plain = model(ids, use_flash=False)
        flash = model(ids, use_flash=True)
        default = model(ids)
    np.testing.assert_allclose(flash.numpy(), plain.numpy(), **LOGIT_TOL)
    assert torch.equal(default, plain)


def test_mpt_attn_mask_matches_jax_on_the_plain_route():
    """`attn_mask` (left or right padding) is honoured on the plain route;
    the flash route assumes right padding and does not read it, as the JAX
    one: with right padding the valid rows agree across routes."""
    jcfg, jparams, _, model = _pair(5)
    ids = _ids(6, s=10)
    mask = np.ones((2, 10), bool)
    mask[0, :3] = False            # left padding
    mask[1, 7:] = False            # right padding
    want = JM.forward(jparams, jcfg, jnp.asarray(ids),
                      attn_mask=jnp.asarray(mask), precision=J_FP32,
                      use_flash=False)
    with torch.no_grad():
        got = model(torch.from_numpy(ids),
                    attn_mask=torch.from_numpy(mask), use_flash=False)
        flash = model(torch.from_numpy(ids), use_flash=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(flash[1, :7].numpy(), got[1, :7].numpy(),
                               **LOGIT_TOL)


def test_mpt_tree_round_trips_bit_for_bit():
    _, jparams, _, model = _pair(7)
    tree = jax.tree.map(np.asarray, jparams)
    back = from_jax.mpt_tree(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # and the JAX forward takes the tree that came back
    ids = _ids(8)
    lg = JM.forward(jax.tree.map(jnp.asarray, back), JM.tiny(vocab_size=64),
                    jnp.asarray(ids), precision=J_FP32, use_flash=False)
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(lg), **LOGIT_TOL)


def test_mpt_init_params_is_seeded_and_bf16_computes_in_bf16():
    cfg = TM.tiny()
    g = torch.Generator().manual_seed(3)
    a = TM.init_params(g, cfg, FP32_PRECISION)
    b = TM.init_params(torch.Generator().manual_seed(3), cfg, FP32_PRECISION)
    c = TM.init_params(torch.Generator().manual_seed(4), cfg, FP32_PRECISION)
    for (n, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), n
        if "ln" not in n:
            assert not torch.equal(x, z), n
            assert abs(x.std().item() - 0.02) < 0.004, n
        else:
            assert (x == 1).all(), n
    ids = torch.from_numpy(_ids(9, vocab=cfg.vocab_size))
    default = TM.init_params(torch.Generator().manual_seed(3), cfg)
    with torch.no_grad():
        lg = default(ids)
    assert lg.dtype == torch.float32 and torch.isfinite(lg).all()
    with torch.no_grad():
        ref = a(ids)
    # bf16 compute: a few bf16 ulps of logits of size ~0.1
    assert (lg - ref).abs().max() < 2e-2


def test_port_mpt_matches_hf():
    pytest.importorskip("transformers")
    from transformers import MptConfig as HFMptConfig, MptForCausalLM
    hf_cfg = HFMptConfig(d_model=32, n_heads=4, n_layers=2, vocab_size=128,
                         max_seq_len=64)
    torch.manual_seed(0)
    hf = MptForCausalLM(hf_cfg).eval()
    cfg = TM.tiny(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4)
    model = TM.MptModel(cfg, FP32_PRECISION)
    model.load_state_dict(TM.port_mpt(hf.state_dict(), cfg))
    ids = torch.from_numpy(_ids(0, s=10, vocab=128))
    with torch.no_grad():
        ref = hf(ids).logits
        for use_flash in (False, True):
            got = model(ids, use_flash=use_flash)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=3e-4,
                                       rtol=1e-3)
    # the same state dict through the JAX port gives the same tree
    jtree = JM.port_mpt(hf.state_dict(), JM.tiny(vocab_size=128))
    back = from_jax.mpt_tree(model.state_dict())
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
