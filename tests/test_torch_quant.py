"""The port's quantised serving path against the JAX package: weight-only
int8/int4 (`ops/quant.py`, kernel 10's plain version), the int8 KV cache
(`quantize_kv`, kernel 3's int8 branch in its plain version), the quantised
decoder, `from_jax` on quantised trees, the runners' knobs and stage-1
training through a quantised frozen decoder. Same seeded numpy inputs on
both sides, fp32 on the CPU, one intra-op thread; the JAX Pallas kernels run
in interpret mode.

Layouts differ by design (the port keeps `Dense`'s [out, in] and its own
nibble order), so codes are compared after unpacking and through
`io.from_jax`, which must carry a JAX leaf into the port's layout exactly.

Tolerances: codes and scales are equal (the same IEEE operations on the same
fp32 numbers); matmuls and attention 1e-5 absolute + 1e-4 relative (fp32
sums in another order); the kernel-arithmetic plain versions against the
Pallas kernels 2e-5 (both round x to bf16 and sum exact products in fp32);
decoder hidden states and logits 1e-4 of the largest magnitude.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.eval.runner import (
    build_lmm as j_build_lmm)
from law_of_vision_representation_in_mllms_tpu.io import checkpoint as jckpt
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.ops import (
    decode_attention as JD)
from law_of_vision_representation_in_mllms_tpu.ops import int4_kernel as JK
from law_of_vision_representation_in_mllms_tpu.ops import quant as JQ
from law_of_vision_representation_in_mllms_tpu.train import runner as jrunner
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.eval.runner import build_lmm
from law_of_vision_representation_in_mllms_torch.io import checkpoint as tckpt
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models.layers import (
    Dense, QuantDense)
from law_of_vision_representation_in_mllms_torch.models.splice import (
    IMAGE_TOKEN_INDEX)
from law_of_vision_representation_in_mllms_torch.ops import (
    decode_attention as TD)
from law_of_vision_representation_in_mllms_torch.ops import int4_matmul as TK
from law_of_vision_representation_in_mllms_torch.ops import quant as TQ
from law_of_vision_representation_in_mllms_torch.train import runner

from test_torch_near_tie import check_answers, use_crc_ids

torch.set_num_threads(1)

CLOSE = dict(atol=1e-5, rtol=1e-4)
# hidden 128 and intermediate 256: whole 128-element tiles, so the int4 words
# are in the kernel's fragment order (G = 1 and G = 2); GQA 4 heads on 2
JCFG = JL.tiny(vocab_size=64, hidden_size=128, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=256)


def _rel_close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jax_codes(leaf):
    """Signed int4 codes [in, out] of a JAX leaf."""
    return np.asarray(JQ._unpack_int4(leaf["q4"], leaf["scale"].shape[-2],
                                      jnp.int8))


# --- codes and scales ------------------------------------------------------

def test_quantize_int8_matches_jax():
    w = np.random.RandomState(0).randn(48, 40).astype(np.float32)  # [in, out]
    w[:, 3] = 0.0                                   # an all-zero channel
    want = JQ.quantize_int8(jnp.asarray(w))
    got = TQ.quantize_int8(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"]).T)
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"])[0])
    np.testing.assert_array_equal(
        TQ.dequantize_int8(got).numpy(), np.asarray(JQ.dequantize_int8(want)).T)
    assert TQ.is_quantized(got) and not TQ.is_quantized(got["q8"])


@pytest.mark.parametrize("di,group", [(256, 128), (128, 128), (64, 128),
                                      (96, 32), (256, None), (48, 4)])
def test_quantize_int4_matches_jax(di, group):
    """Equal scales and equal codes after unpacking, for contraction dims in
    the kernel's fragment order (multiples of 128) and in natural order; and
    `from_jax` turns the JAX bytes into the port's words bit for bit."""
    w = np.random.RandomState(di).randn(di, 24).astype(np.float32) * 0.05
    w[:, 5] = 0.0
    want = JQ.quantize_int4(jnp.asarray(w), group_size=group)
    got = TQ.quantize_int4(torch.from_numpy(w.T.copy()), group_size=group)
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        TQ._unpack_int4(got["q4"], torch.int8).numpy(), _jax_codes(want).T)
    np.testing.assert_array_equal(
        TQ.dequantize_int4(got).numpy(),
        np.asarray(JQ.dequantize_int4(want)).T)
    sd = {}
    from_jax._quant_leaf({k: np.asarray(v) for k, v in want.items()}, "w", sd)
    assert torch.equal(sd["w.q4"], got["q4"])
    assert torch.equal(sd["w.scale"], got["scale"])
    back = from_jax._llama_dense_tree(sd, "w")
    np.testing.assert_array_equal(back["q4"], np.asarray(want["q4"]))


def test_int4_nibbles_sign_extend_in_every_position():
    """-7, -1, 0 and 7 survive pack/unpack in each of the 8 nibbles of a
    word, the top one (the int32's sign bit) included."""
    vals = torch.tensor([-7, -1, 0, 7, 1, -6, 3, -2], dtype=torch.int8)
    for di in (8, 128):
        codes = torch.stack([vals.roll(r).repeat(di // 8) for r in range(8)])
        packed = TQ.pack_int4(codes)
        assert packed.dtype == torch.int32 and packed.shape == (8, di // 8)
        assert torch.equal(TQ._unpack_int4(packed, torch.int8), codes)
    assert (TQ.pack_int4(torch.full((1, 8), 7)) < 0).all()    # 0xFFFFFFFF
    order = TQ.int4_k_order(256)
    assert sorted(order.tolist()) == list(range(256))
    assert order[:8].tolist() == [0, 8, 16, 24, 1, 9, 17, 25]
    assert TQ.int4_k_order(96).tolist() == list(range(96))
    with pytest.raises(ValueError, match="even contraction dim"):
        TQ.quantize_int4(torch.zeros(4, 13))
    with pytest.raises(ValueError, match="group_size"):
        TQ.quantize_int4(torch.zeros(4, 96), group_size=64)


@pytest.mark.parametrize("di,group", [(6, None), (6, 2), (12, 128),
                                      (12, 4), (1004, None), (1004, 502)])
def test_int4_odd_contraction_dims_match_jax(di, group):
    """Contraction dims that 8 does not divide, which the JAX packing takes
    (an even dim, an even group that divides it, or one group): equal codes
    and scales, the same dense weight, the product of the JAX XLA route
    (fp32), and `from_jax` both ways. The port's words hold every group
    zero-padded to whole 128-element tiles, so kernel 10 takes the weight
    (`chip_smoke.py` launches it at K = 1,004)."""
    rng = np.random.RandomState(di + (group or 0))
    w = rng.randn(di, 24).astype(np.float32) * 0.05
    x = rng.randn(2, 3, di).astype(np.float32)
    want = JQ.quantize_int4(jnp.asarray(w), group_size=group)
    got = TQ.quantize_int4(torch.from_numpy(w.T.copy()), group_size=group)
    ng = got["scale"].shape[0]
    stored = TQ.stored_width(di, ng)
    assert stored % 128 == 0 and got["q4"].shape == (24, stored // 8)
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    codes = TQ._unpack_int4(got["q4"], torch.int8)
    np.testing.assert_array_equal(TQ.unpad_groups(codes, ng, di).numpy(),
                                  _jax_codes(want).T)
    assert torch.equal(TQ.pad_groups(TQ.unpad_groups(codes, ng, di), ng,
                                     stored), codes)       # zero padding
    np.testing.assert_array_equal(
        TQ.dequantize_int4(got, di=di).numpy(),
        np.asarray(JQ.dequantize_int4(want)).T)
    y = TQ.quant_matmul(torch.from_numpy(x), got)
    np.testing.assert_allclose(y.numpy(), np.asarray(JQ.int4_matmul(
        jnp.asarray(x), want)), **CLOSE)
    assert TK.kernel_supported(got["q4"], got["scale"])
    sd = {}
    from_jax._quant_leaf({k: np.asarray(v) for k, v in want.items()}, "w", sd)
    assert torch.equal(sd["w.q4"], got["q4"])
    back = from_jax._llama_dense_tree(sd, "w", di)
    np.testing.assert_array_equal(back["q4"], np.asarray(want["q4"]))


def test_quantize_kv_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 2, 16).astype(np.float32)
    x[0, 3] = 0.0                         # a pad row: amax 0, codes 0
    wc, ws = JQ.quantize_kv(jnp.asarray(x))
    gc, gs = TQ.quantize_kv(torch.from_numpy(x))
    assert gc.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    assert (gc[0, 3] == 0).all() and gc.abs().max() == 127


# --- matmuls ---------------------------------------------------------------

def test_int8_matmul_matches_jax():
    rng = np.random.RandomState(2)
    w = rng.randn(64, 40).astype(np.float32) * 0.05
    x = rng.randn(2, 3, 64).astype(np.float32)
    want = JQ.int8_matmul(jnp.asarray(x), JQ.quantize_int8(jnp.asarray(w)))
    leaf = TQ.quantize_int8(torch.from_numpy(w.T.copy()))
    got = TQ.quant_matmul(torch.from_numpy(x), leaf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)


@pytest.mark.parametrize("di,group", [(256, 128), (256, None), (64, 128),
                                      (96, 32)])
def test_int4_matmul_matches_jax_xla_route(di, group):
    """The CPU route in fp32 against the JAX XLA formulation (what the JAX
    package runs wherever its TPU kernel does not), G > 1 and G == 1."""
    rng = np.random.RandomState(3)
    w = rng.randn(di, 40).astype(np.float32) * 0.05
    x = rng.randn(2, 3, di).astype(np.float32)
    want = JQ.int4_matmul(jnp.asarray(x),
                          JQ.quantize_int4(jnp.asarray(w), group_size=group))
    leaf = TQ.quantize_int4(torch.from_numpy(w.T.copy()), group_size=group)
    got = TQ.quant_matmul(torch.from_numpy(x), leaf)
    assert got.dtype == torch.float32 and got.shape == (2, 3, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)


@pytest.mark.parametrize("m,do", [(3, 256), (16, 256), (96, 128)])
def test_int4_plain_matches_pallas_kernel(m, do):
    """Kernel 10's plain version against the TPU kernel in interpret mode,
    at decode-sized M (3, and 16: the card's decode body's largest) and a
    prefill-sized M (the TPU body branches at 64 rows). x is not
    bf16-representable: both sides round it."""
    rng = np.random.RandomState(4 + m)
    w = rng.randn(256, do).astype(np.float32) * 0.05
    x = rng.randn(m, 256).astype(np.float32)
    jleaf = JQ.quantize_int4(jnp.asarray(w), group_size=128)
    assert JK.kernel_supported(jleaf["q4"], jleaf["scale"])
    want = JK.int4_matmul_kernel(jnp.asarray(x), jleaf["q4"], jleaf["scale"],
                                 interpret=True)
    leaf = TQ.quantize_int4(torch.from_numpy(w.T.copy()))
    assert TK.kernel_supported(leaf["q4"], leaf["scale"])
    got = TK.int4_matmul_kernel(torch.from_numpy(x), leaf["q4"],
                                leaf["scale"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    assert TK.int4_matmul_kernel.launches == 0
    # and it differs from the fp32 route by x's bf16 rounding only
    exact = TQ.int4_matmul(torch.from_numpy(x), leaf)
    assert 1e-5 < (got - exact).abs().max() < 2e-2


def test_int4_kernel_gate_and_shape_errors():
    leaf = TQ.quantize_int4(torch.zeros(16, 64))           # in = 64: no tile
    assert not TK.kernel_supported(leaf["q4"], leaf["scale"])
    leaf = TQ.quantize_int4(torch.zeros(12, 128))          # out % 8 != 0
    assert not TK.kernel_supported(leaf["q4"], leaf["scale"])
    leaf = TQ.quantize_int4(torch.zeros(16, 256), group_size=None)
    assert TK.kernel_supported(leaf["q4"], leaf["scale"])  # one 256 group
    with pytest.raises(ValueError, match="do not belong together"):
        TK.int4_matmul_plain(torch.zeros(2, 256), leaf["q4"],
                             torch.zeros(1, 8))


@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("m,di,do", [(6, 256, 128), (40, 512, 256)])
def test_int4_matmul_gradient_matches_jax_vjp(m, di, do, group):
    """dL/dx through the frozen int4 weight: the port's CPU route under
    autograd, the `Int4Matmul` backward formula and `int4_matmul_dx_plain`
    (the transposed kernel's plain version) against `jax.vjp` of the JAX
    custom-VJP product (kernel in interpret mode), fp32."""
    rng = np.random.RandomState(13 + m + group)
    w = rng.randn(di, do).astype(np.float32) * 0.05
    x = np.asarray(jnp.asarray(rng.randn(m, di).astype(np.float32)
                               ).astype(jnp.bfloat16)).astype(np.float32)
    t = rng.randn(m, do).astype(np.float32)
    jleaf = JQ.quantize_int4(jnp.asarray(w), group_size=group)
    _, vjp = jax.vjp(lambda xv: JQ._int4_kernel_mm(
        xv, jleaf["q4"], jleaf["scale"], True), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(t))
    leaf = TQ.quantize_int4(torch.from_numpy(w.T.copy()), group_size=group)
    xt = torch.from_numpy(x).requires_grad_()
    (TQ.int4_matmul(xt, leaf) * torch.from_numpy(t)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **CLOSE)

    class Ctx:
        saved_tensors = (leaf["q4"], leaf["scale"])
    dx, dq, ds = TK.Int4Matmul.backward(Ctx, torch.from_numpy(t))
    assert dq is None and ds is None
    np.testing.assert_allclose(dx.numpy(), np.asarray(want), **CLOSE)
    plain = TK.int4_matmul_dx(torch.from_numpy(t), leaf["q4"], leaf["scale"])
    _rel_close(plain.numpy(), want, rel=1e-5)
    assert TK.int4_matmul_dx.launches == 0


# --- kernel 3's int8 branch ------------------------------------------------

def _decode_case(seed, b, t, h, kvh, dh):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, h, dh).astype(np.float32)
    k = rng.randn(b, t, kvh, dh).astype(np.float32)
    v = rng.randn(b, t, kvh, dh).astype(np.float32)
    mask = rng.rand(b, t) < 0.7
    mask[:, 0] = True                      # never a fully masked row
    mask[:, 130:150] = False               # a hole across a 128-slot tile
    return q, k, v, mask


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
def test_decode_attention_int8_plain_matches_jax_kernels(h, kvh):
    """Codes and scales from `quantize_kv` through the port's wrapper (plain
    version on the CPU) against the TPU kernel and its stacked form, both in
    interpret mode; T = 200 is ragged against the 128-slot tile."""
    q, k, v, mask = _decode_case(20 + h + kvh, 2, 200, h, kvh, 16)
    kc, ks = TQ.quantize_kv(torch.from_numpy(k))
    vc, vs = TQ.quantize_kv(torch.from_numpy(v))
    got = TD.decode_attention(torch.from_numpy(q), kc, vc,
                              torch.from_numpy(mask), ks, vs)
    assert TD.decode_attention_int8.launches == 0
    assert torch.equal(got, TD.decode_attention_plain(
        torch.from_numpy(q), kc, vc, torch.from_numpy(mask), ks, vs))
    jkc, jks = JQ.quantize_kv(jnp.asarray(k))
    jvc, jvs = JQ.quantize_kv(jnp.asarray(v))
    want = JD.decode_attention(jnp.asarray(q), jkc, jvc, jnp.asarray(mask),
                               jks, jvs, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    # the stacked form reads layer 1 of a [L, B, T, KV, Dh] cache
    zeros = jnp.zeros_like
    stacked = JD.decode_attention_stacked(
        jnp.asarray(q), jnp.stack([zeros(jkc), jkc]),
        jnp.stack([zeros(jvc), jvc]), 1, jnp.asarray(mask),
        jnp.stack([zeros(jks), jks]), jnp.stack([zeros(jvs), jvs]),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(stacked), **CLOSE)
    # against the dense attention on the dequantised cache
    dense = TD.decode_attention(
        torch.from_numpy(q), kc.float() * ks[..., None],
        vc.float() * vs[..., None], torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **CLOSE)


@pytest.mark.parametrize("h,kvh", [(4, 4), (4, 2), (8, 1)])
def test_decode_attention_int8_ragged_mask_matches_jax_kernels(h, kvh):
    """The int8 branch with a masked stretch that lines up with neither the
    TPU kernel's 128-slot tiles nor kernel 3's 32-slot ones, and a row whose
    only visible slot is the last, against both TPU kernels in interpret
    mode."""
    q, k, v, mask = _decode_case(40 + h + kvh, 3, 300, h, kvh, 16)
    mask[:, 70:250] = False
    mask[-1] = False
    mask[-1, -1] = True
    kc, ks = TQ.quantize_kv(torch.from_numpy(k))
    vc, vs = TQ.quantize_kv(torch.from_numpy(v))
    got = TD.decode_attention(torch.from_numpy(q), kc, vc,
                              torch.from_numpy(mask), ks, vs)
    jkc, jks = JQ.quantize_kv(jnp.asarray(k))
    jvc, jvs = JQ.quantize_kv(jnp.asarray(v))
    want = JD.decode_attention(jnp.asarray(q), jkc, jvc, jnp.asarray(mask),
                               jks, jvs, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CLOSE)
    stacked = JD.decode_attention_stacked(
        jnp.asarray(q), jkc[None], jvc[None], 0, jnp.asarray(mask),
        jks[None], jvs[None], interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(stacked), **CLOSE)
    # the last row is its last slot's dequantised value row
    last = (vc[-1, -1].float() * vs[-1, -1, :, None]).repeat_interleave(
        h // kvh, dim=0)
    np.testing.assert_allclose(got[-1, 0].numpy(), last.numpy(), **CLOSE)


def test_decode_attention_int8_argument_errors():
    q, k, v, mask = (torch.from_numpy(x) for x in _decode_case(1, 1, 8, 2, 2,
                                                               16))
    kc, ks = TQ.quantize_kv(k)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        TD.decode_attention(q, kc, kc, mask, ks, None)
    with pytest.raises(ValueError, match="k_scale must be"):
        TD.decode_attention(q, kc, kc, mask, ks[:, :4], ks)
    with pytest.raises(RuntimeError, match="forward-only"):
        TD.decode_attention(q.clone().requires_grad_(), kc, kc, mask, ks, ks)


# --- the quantised decoder -------------------------------------------------

def _decoder_pair(bits, seed=0):
    """(JAX quantised tree, the port's decoder quantised by its own
    `quantize_decoder` from the same dense weights)."""
    params = jax.tree.map(np.asarray,
                          JL.init_params(jax.random.PRNGKey(seed), JCFG))
    tcfg = TL.LlamaConfig(**{f.name: getattr(JCFG, f.name)
                             for f in dataclasses.fields(TL.LlamaConfig)})
    model = TL.LlamaModel(tcfg, FP32_PRECISION)
    model.load_state_dict(from_jax.llama_state_dict(params))
    dense_bytes = TQ.quantized_bytes(model)
    assert TQ.quantize_decoder(model, bits=bits) is model
    assert TQ.quantized_bytes(model) < dense_bytes / 2
    jq = jax.tree.map(np.asarray, JQ.quantize_decoder(params, bits=bits))
    return jq, model.eval()


@pytest.mark.parametrize("bits", [8, 4])
def test_from_jax_carries_a_quantised_tree(bits):
    """`quantize_decoder` on each side and `from_jax` in between give the
    same buffers, bit for bit; no dense weight is left; the tree goes back."""
    jq, model = _decoder_pair(bits)
    sd = model.state_dict()
    kind = "q4" if bits == 4 else "q8"
    assert f"layers.0.wq.{kind}" in sd and f"lm_head.{kind}" in sd
    assert not any(k.endswith("wq.weight") or k == "lm_head.weight"
                   for k in sd)
    assert all(isinstance(getattr(model.layers[1], n), QuantDense)
               for n in TQ.DECODER_TARGETS)
    carried = from_jax.llama_state_dict(jq)
    assert set(carried) == set(sd)
    for name, t in sd.items():
        assert carried[name].dtype == t.dtype, name
        assert torch.equal(carried[name], t), name
    model.load_state_dict(carried)
    back = from_jax.llama_tree(sd)
    for name in ("wq", "down"):
        for key, arr in jq["layers"][name].items():
            np.testing.assert_array_equal(back["layers"][name][key], arr)
    np.testing.assert_array_equal(back["lm_head"][kind], jq["lm_head"][kind])
    # quantising twice changes nothing; a bad width raises
    TQ.quantize_decoder(model, bits=bits)
    assert torch.equal(model.state_dict()[f"layers.0.wq.{kind}"],
                       sd[f"layers.0.wq.{kind}"])
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        TQ.quantize_decoder(model, bits=3)


def _batch(b=2, s=10):
    rng = np.random.RandomState(2)
    embeds = rng.randn(b, s, JCFG.hidden_size).astype(np.float32)
    mask = np.ones((b, s), bool)
    mask[1, 7:] = False                                # right padding
    positions = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    return embeds, mask, positions


@pytest.mark.parametrize("use_flash", [True, False])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantised_prefill_and_decode_logits_match_jax(bits, kv_quant,
                                                       use_flash):
    """Prefill into the cache and 3 decode steps, logits at every step, for
    both weight widths, both caches and both prefill routes: the flash route
    attends over the fresh K/V, the plain one over the (quantised) cache.
    The JAX decode steps run the Pallas decode kernel in interpret mode."""
    jq, model = _decoder_pair(bits)
    embeds, mask, positions = _batch()
    b, s = mask.shape
    n_gen = 3
    jcfg = dataclasses.replace(JCFG, decode_attn="pallas")
    slot_valid = np.concatenate([mask, np.zeros((b, n_gen), bool)], axis=1)
    jcache = JL.init_cache(jcfg, b, s + n_gen, jnp.float32, quant=kv_quant)
    tcache = TL.init_cache(model.cfg, b, s + n_gen, torch.float32,
                           quant=kv_quant)
    assert len(tcache[0]) == (4 if kv_quant else 2)

    want, jcache = JL.forward(jq, jcfg, jnp.asarray(embeds),
                              jnp.asarray(positions),
                              attn_mask=jnp.asarray(slot_valid), cache=jcache,
                              cache_index=0, precision=J_FP32,
                              use_flash=use_flash)
    with torch.no_grad():
        got, tcache = model(torch.from_numpy(embeds),
                            torch.from_numpy(positions).long(),
                            attn_mask=torch.from_numpy(slot_valid),
                            cache=tcache, cache_index=0, use_flash=use_flash)
    valid = mask[..., None]
    _rel_close(got.numpy() * valid, np.asarray(want) * valid)
    _rel_close(TL.logits_fn(model, got).numpy() * valid,
               np.asarray(JL.logits_fn(jq, want, J_FP32)) * valid)

    pos = mask.sum(axis=1)
    rng = np.random.RandomState(3)
    for t in range(n_gen):
        slot_valid[:, s + t] = True
        emb = rng.randn(b, 1, JCFG.hidden_size).astype(np.float32)
        want, jcache = JL.forward(jq, jcfg, jnp.asarray(emb),
                                  jnp.asarray(pos[:, None]),
                                  attn_mask=jnp.asarray(slot_valid),
                                  cache=jcache, cache_index=s + t,
                                  precision=J_FP32)
        with torch.no_grad():
            got, tcache = model(torch.from_numpy(emb),
                                torch.from_numpy(pos[:, None]).long(),
                                attn_mask=torch.from_numpy(slot_valid),
                                cache=tcache, cache_index=s + t)
        _rel_close(TL.logits_fn(model, got),
                   JL.logits_fn(jq, want, J_FP32))
        pos = pos + 1
    if kv_quant:
        # the cache holds the same codes and scales, pad rows included
        for i, (ck, cv, ks, vs) in enumerate(tcache):
            assert ck.dtype == torch.int8 and ks.dtype == torch.float32
            diff = np.abs(ck.numpy().astype(np.int32)
                          - np.asarray(jcache["k"][i]).astype(np.int32))
            # a division that lands within an ulp of .5 may round the
            # other way: at most one step, on at most 1 code in 1000
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            np.testing.assert_allclose(ks.numpy(),
                                       np.asarray(jcache["k_scale"][i]),
                                       rtol=1e-5)
    with pytest.raises(ValueError, match="unknown kv cache quant"):
        TL.init_cache(model.cfg, 1, 4, quant="int4")


# --- LLaVA level: generation, runners --------------------------------------

TINY = {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit"},
        "train": {"bf16": False}}


def _representable(params, bits):
    """Round every decoder matmul weight to its own quantisation grid, so
    quantising is exact and tokens can be compared bit for bit."""
    def rt(w):
        if bits == 8:
            return JQ.dequantize_int8(JQ.quantize_int8(w))
        return JQ.dequantize_int4(JQ.quantize_int4(w), jnp.float32)
    dec = dict(params["decoder"])
    dec["layers"] = dict(dec["layers"])
    for t in JQ.DECODER_TARGETS:
        dec["layers"][t] = rt(dec["layers"][t])
    dec["lm_head"] = rt(dec["lm_head"])
    return dict(params, decoder=dec)


def _llava_batch():
    rng = np.random.RandomState(0)
    ids = rng.randint(3, 250, size=(2, 8)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    mask = np.ones((2, 8), bool)
    mask[1, 5:] = False
    ids[1, 5:] = 0
    return ids, mask, rng.randn(2, 28, 28, 3).astype(np.float32)


@pytest.mark.parametrize("kv_quant,decode_attn", [
    (None, "pallas"), ("int8", "pallas"), ("int8", "pallas_stacked")])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantised_generate_greedy_matches_jax(bits, kv_quant, decode_attn):
    """Tokens of the port's quantised tiny LLaVA equal the JAX package's, on
    weights that lie on the quantisation grid; with the bf16-exact cache
    they also equal the dense model's (quantising such weights is exact).
    Under `pallas_stacked` the JAX side reads the int8 cache through its
    stacked decode kernel, the port through the same int8 branch."""
    jcfg = JM.LlavaConfig.build(
        "debug/tiny-vit", kv_quant=kv_quant,
        decoder=dataclasses.replace(JL.tiny(), decode_attn=decode_attn))
    jparams = _representable(
        JM.init_params(jax.random.PRNGKey(1), jcfg, J_FP32), bits)
    jq = dict(jparams, decoder=JQ.quantize_decoder(jparams["decoder"],
                                                   bits=bits))
    tcfg = TM.LlavaConfig.build(
        "debug/tiny-vit", kv_quant=kv_quant,
        decoder=dataclasses.replace(TL.tiny(), decode_attn=decode_attn))
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(from_jax.llava_state_dict(
        jax.tree.map(np.asarray, jparams)))
    ids, mask, px = _llava_batch()

    def port_tokens(p):
        return TM.generate_greedy(
            p.eval(), tcfg, torch.from_numpy(ids).long(),
            torch.from_numpy(mask), [torch.from_numpy(px)], max_new_tokens=6,
            eos_id=-1).numpy()
    dense = port_tokens(params)
    TQ.quantize_decoder(params.decoder, bits=bits)
    got = port_tokens(params)
    want = np.asarray(JM.generate_greedy(
        jq, jcfg, jnp.asarray(ids), jnp.asarray(mask), [jnp.asarray(px)],
        max_new_tokens=6, eos_id=-1, precision=J_FP32, use_flash=True))
    np.testing.assert_array_equal(got, want)
    if kv_quant is None:
        np.testing.assert_array_equal(got, dense)
    # a quantised LLaVA tree crosses `from_jax` whole
    carried = from_jax.llava_state_dict(jax.tree.map(np.asarray, jq))
    for name, t in params.state_dict().items():
        assert torch.equal(carried[name], t), name


def test_build_lmm_quantisation_knobs(tmp_path):
    """`model.quantize` and `model.kv_quant` through `build_lmm` on both
    sides from one weight file: same answers; unknown values raise as in the
    JAX package."""
    from law_of_vision_representation_in_mllms_tpu.eval.api import (
        Instance as JInstance)
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    knobs = {"quantize": "int4", "kv_quant": "int8"}
    jlmm = j_build_lmm(JRunConfig.from_dict(
        {"model": dict(TINY["model"], decode_attn="pallas", **knobs),
         "train": TINY["train"]}))
    assert "q4" in jlmm.params["decoder"]["layers"]["wq"]
    path = str(tmp_path / "llava.npz")
    dense = j_build_lmm(JRunConfig.from_dict(TINY))
    jio.save_params(path, dense.params)
    lmm = build_lmm(RunConfig.from_dict(
        {"model": dict(TINY["model"], checkpoint=path, **knobs),
         "train": TINY["train"]}), device="cpu")
    assert lmm.cfg.kv_quant == "int8"
    assert isinstance(lmm.params.decoder.lm_head, QuantDense)
    assert lmm.params.decoder.layers[0].wq.kind == "q4"
    assert isinstance(lmm.params.projector.layers[0], Dense)
    rng = np.random.RandomState(5)
    images = [Image.fromarray(rng.randint(0, 255, (40, 32, 3),
                                          dtype=np.uint8)) for _ in range(2)]

    def reqs(cls):
        return [cls("generate_until", {}, i, "t",
                    (p, {"max_new_tokens": 5}), [im])
                for i, (p, im) in enumerate(zip(
                    ["describe the image", "what color is it"], images))]
    # CRC ids: the same prompts in every process; a differing answer must
    # part from the JAX one at a near tie of the JAX logits (int4 weights
    # and the int8 cache round differently in the two packages)
    use_crc_ids(jlmm, lmm)
    check_answers(jlmm, reqs(JInstance), jlmm.generate_until(reqs(JInstance)),
                  lmm.generate_until(reqs(Instance)))
    lls = lmm.loglikelihood([Instance("loglikelihood", {}, 0, "t",
                                      ("what is it", " a dog"), [images[0]])])
    assert np.isfinite(lls[0][0])
    int8 = build_lmm(RunConfig.from_dict(
        {"model": dict(TINY["model"], quantize="int8"),
         "train": TINY["train"]}), device="cpu")
    assert int8.params.decoder.layers[1].down.kind == "q8"
    assert int8.cfg.kv_quant is None
    for key, value in (("quantize", "int2"), ("kv_quant", "fp8")):
        with pytest.raises(ValueError, match=f"unknown model.{key}"):
            build_lmm(RunConfig.from_dict(
                {"model": dict(TINY["model"], **{key: value}),
                 "train": TINY["train"]}), device="cpu")
    with pytest.raises(ValueError, match="unknown model.quantize"):
        j_build_lmm(JRunConfig.from_dict(
            {"model": dict(TINY["model"], quantize="int2"),
             "train": TINY["train"]}))


@pytest.mark.parametrize("from_checkpoint", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantised_build_matches_build_then_quantize(tmp_path, bits,
                                                     from_checkpoint):
    """`build_model(quantize_bits=...)` builds the decoder block by block on
    the `meta` device and quantises each block as it is made: every tensor,
    codes and scales included, is torch.equal to the dense build followed
    by `quantize_decoder`, from the seeded init and from a JAX `.npz`."""
    model = dict(TINY["model"])
    if from_checkpoint:
        path = str(tmp_path / "llava.npz")
        jio.save_params(path, j_build_lmm(JRunConfig.from_dict(
            dict(TINY, train={"bf16": False, "seed": 3}))).params)
        model["checkpoint"] = path
    cfg = RunConfig.from_dict({"model": model, "train": TINY["train"]})
    _, dense = runner.build_model(cfg, device="cpu")
    TQ.quantize_decoder(dense.decoder, bits=bits)
    _, layered = runner.build_model(cfg, device="cpu", quantize_bits=bits)
    want, got = dense.state_dict(), layered.state_dict()
    assert list(got) == list(want)
    assert any(k.endswith(".q4" if bits == 4 else ".q8") for k in got)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert not any(t.is_meta for t in got.values())
    if from_checkpoint:
        assert torch.equal(got["decoder.embed"], from_jax.load_llava_npz(
            model["checkpoint"])["decoder.embed"])


@pytest.mark.parametrize("base", ["int4", "int8"])
def test_run_training_quantize_base_matches_jax(tmp_path, base):
    """Stage 1 through a quantised frozen decoder (`train.quantize_base`):
    the port's runner against the JAX runner from the same initial weights,
    per-step losses and the saved projector. lr 1e-3 and 3 steps keep Adam's
    amplification of the gradients' rounding under the tolerance
    (test_torch_train.py has the derivation)."""
    feats = tmp_path / "feats"
    os.makedirs(feats)
    rng = np.random.RandomState(0)
    for i in range(3):
        np.save(feats / f"img{i}.npy",
                rng.randn(576, 1280).astype(np.float32))
    words = "a red house near the river with two trees and a dog".split()
    recs = [{"image": f"img{i % 3}.png", "conversations": [
        {"from": "human", "value": "<image>\ndescribe the picture"},
        {"from": "gpt", "value": " ".join(rng.choice(words, 3 + i % 5))}]}
        for i in range(6)]
    with open(tmp_path / "data.json", "w") as f:
        json.dump(recs, f)
    raw = {"model": {"vision_tower": "runwayml/stable-diffusion-v1-5_feature",
                     "decoder": "tiny"},
           "train": {"stage": 1, "batch_size": 2, "epochs": 1, "bf16": False,
                     "max_length": 64, "learning_rate": 1e-3,
                     "warmup_ratio": 0.0, "quantize_base": base,
                     "output_dir": str(tmp_path / "out"), "save_steps": 1000},
           "data": {"data_path": str(tmp_path / "data.json"),
                    "feature_folder": str(feats)},
           "parallel": {"n_data": 1, "n_model": 1}}
    jcfg = JRunConfig.from_dict(raw)
    _, jparams = jrunner.build_model(jcfg)
    init = str(tmp_path / "init.npz")
    jio.save_params(init, jax.tree.map(np.asarray, jparams))
    assert jrunner.run_training(jcfg) == 0
    want = jckpt.load_projector(raw["train"]["output_dir"])
    traw = json.loads(json.dumps(raw))
    traw["train"]["output_dir"] += "_port"
    traw["model"]["checkpoint"] = init
    traw["parallel"] = {}
    run = runner.run_training(RunConfig.from_dict(traw), device="cpu")
    dec = run.state["params"].decoder
    assert dec.layers[0].gate.kind == ("q4" if base == "int4" else "q8")
    assert all(n.startswith("projector.") for n, _ in run.opt.named_params)

    def logs(d):
        return [json.loads(ln) for ln in open(os.path.join(d, "train.jsonl"))
                if ln.strip()]
    jl, tl = logs(raw["train"]["output_dir"]), logs(
        traw["train"]["output_dir"])
    assert len(tl) == len(jl) == 3
    for r, jr in zip(tl, jl):
        np.testing.assert_allclose(r["loss"], jr["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], jr["grad_norm"], rtol=1e-4)
    got = tckpt.load_projector(traw["train"]["output_dir"])
    for i, layer in enumerate(want["layers"]):
        # 3 steps of at most lr each: 2e-5 absolute is 0.7 % of that range
        np.testing.assert_allclose(got[f"layers.{i}.weight"].numpy(),
                                   layer["kernel"].T, atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(got[f"layers.{i}.bias"].numpy(),
                                   layer["bias"], atol=2e-5, rtol=1e-4)
    # a mid-run checkpoint of the quantised model writes the JAX leaves
    tckpt.save_train_state(str(tmp_path / "ck"), run.state["params"], run.opt,
                           3)
    tree = jio.load_params(str(tmp_path / "ck" / "checkpoint-3" /
                               "params.npz"))
    assert ("q4" if base == "int4" else "q8") in tree["decoder"]["layers"][
        "wq"]
    for bad, err in (({"stage": 2}, "frozen decoder"),
                     ({"quantize_base": "int2"}, "int4/int8")):
        cfg = json.loads(json.dumps(traw))
        cfg["train"].update(bad)
        with pytest.raises(ValueError, match=err):
            runner.run_training(RunConfig.from_dict(cfg), device="cpu")
