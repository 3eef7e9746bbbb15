"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test asks for the `cuda_device` fixture, which skips when
no CUDA device is present (so these count as skips on a CPU-only machine).
On a GPU machine without JAX, run them with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(the repository's conftest imports JAX). TF32 is off so the plain versions
run in full fp32. Tolerances: inputs are bf16 N(0,1); the kernels round P to
bf16 before P·V and both versions round the output to bf16 (one ulp is 2^-7
relative), so the error may reach ~2.5 ulps of the largest output: 2 % of
max|plain|, at least 2e-2 absolute (the same rule as chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.ops.a_score import (
    a_score_plain, max_cos)
from law_of_vision_representation_in_mllms_torch.ops.decode_attention import (
    decode_attention, decode_attention_int8, decode_attention_plain)
from law_of_vision_representation_in_mllms_torch.ops.encoder_attention import (
    encoder_attention, encoder_attention_plain)
from law_of_vision_representation_in_mllms_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_plain, flash_attention_plain, last_block_rows)
from law_of_vision_representation_in_mllms_torch.ops.int4_matmul import (
    int4_matmul_dx, int4_matmul_dx_plain, int4_matmul_kernel,
    int4_matmul_plain)
from law_of_vision_representation_in_mllms_torch.ops.quant import (
    dequantize_int4, int4_matmul, pad_groups, quantize_int4, quantize_kv)

pytestmark = pytest.mark.cuda
TOL = 2e-2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err <= TOL * max(1.0, want.float().abs().max().item())


# the forward loop's tile edges: 64-row blocks (one consumer warpgroup: B x
# H x ceil(S / 128) under 132) and 128-row ones (two, ping-pong), keys in
# tiles of 128
TILE_EDGES = (1, 63, 64, 65, 127, 128, 129, 257, 577)


@pytest.mark.parametrize("b,s,h,d", [
    (2, 77, 4, 64), (4, 577, 16, 64), (1, 200, 2, 128),
    *((1, s, 2, 64) for s in TILE_EDGES),
    *((3, s, 48, 128) for s in TILE_EDGES)])
def test_encoder_kernel(cuda_device, b, s, h, d):
    q, k, v = (_randn((b, s, h, d), i, cuda_device) for i in range(3))
    before = encoder_attention.launches
    got = encoder_attention(q, k, v)
    torch.cuda.synchronize()
    assert encoder_attention.launches == before + 1
    assert _close(got, encoder_attention_plain(q, k, v))
    assert torch.equal(got, encoder_attention(q, k, v))    # same bits


@pytest.mark.parametrize("b,sq,skv,causal,kv_len,h,kvh,d", [
    (2, 190, 190, True, None, 4, 4, 64), (2, 190, 190, True, 150, 8, 2, 128),
    (2, 190, 190, False, 100, 4, 1, 64), (2, 640, 640, True, 600, 32, 32, 128),
    # tile edges, 64-row blocks at D = 128 and 64, then 128-row blocks
    *((2, s, s, True, None, 4, 4, 128) for s in TILE_EDGES),
    *((2, s, s, False, None, 4, 2, 64) for s in (1, 64, 129, 577)),
    *((5, s, s, True, None, 32, 8, 128) for s in (63, 65, 127, 129, 257,
                                                  577)),
    # Sq != Skv (top-left causal), both ways, with and without a tail
    (2, 129, 300, True, 250, 8, 8, 128), (2, 300, 129, True, None, 8, 8, 128),
    (2, 129, 300, False, None, 8, 8, 64), (5, 300, 129, False, 100, 32, 32,
                                           128),
    # kv_len 0 (every row fully masked), 1, a tail no tile divides
    (2, 190, 190, True, 0, 4, 4, 128), (2, 190, 190, False, 0, 4, 4, 64),
    (2, 190, 190, True, 1, 4, 4, 128), (5, 384, 384, False, 300, 32, 8, 128),
    # GQA 32/8 and 32/1
    (2, 333, 333, True, None, 32, 8, 128), (4, 333, 333, True, None, 32, 1,
                                            128)])
def test_flash_kernel(cuda_device, b, sq, skv, causal, kv_len, h, kvh, d):
    q = _randn((b, sq, h, d), 0, cuda_device)
    k = _randn((b, skv, kvh, d), 1, cuda_device)
    v = _randn((b, skv, kvh, d), 2, cuda_device)
    got, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               return_lse=True)
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           kv_len=kv_len, return_lse=True)
    torch.cuda.synchronize()
    assert _close(got, want)
    assert (lse - want_lse).abs().max().item() < 1e-2
    if kv_len == 0:                      # rows that see no key: 0 and LSE 0
        assert (got == 0).all() and (lse == 0).all()
    got2, lse2 = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                                 return_lse=True)
    assert torch.equal(got, got2) and torch.equal(lse, lse2)


# the UNets' head sizes 40, 80 and 160 (a tile of D rounded up to 64; TMA
# reads the columns past D as zeros and clips the store): self attention at
# the tile edges and cross attention (Skv = 77, the text context) with
# Sq != Skv; SD1.5's own shapes at B = 1; the LSE of the same call
UNET_CASES = [(2, s, s, 8, d) for d in (40, 80, 160)
              for s in (1, 63, 65, 128, 129, 300)] + [
    (2, s, 77, 8, d) for d in (40, 80, 160) for s in (1, 64, 200, 577)] + [
    (1, 9216, 9216, 8, 40), (1, 9216, 77, 8, 40), (1, 2304, 2304, 8, 80),
    (1, 2304, 77, 8, 80), (1, 576, 576, 8, 160), (1, 144, 77, 8, 160)]


@pytest.mark.parametrize("b,sq,skv,h,d", UNET_CASES)
def test_flash_kernel_unet_head_dims(cuda_device, b, sq, skv, h, d):
    q = _randn((b, sq, h, d), 0, cuda_device)
    k = _randn((b, skv, h, d), 1, cuda_device)
    v = _randn((b, skv, h, d), 2, cuda_device)
    before = flash_attention.launches
    got, lse = flash_attention(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want, want_lse = flash_attention_plain(q, k, v, return_lse=True)
    assert _close(got, want)
    assert (lse - want_lse).abs().max().item() < 1e-2
    assert torch.equal(got, flash_attention(q, k, v))       # same bits


# SD1.5's block-0 attentions (D = 40) at the feature extraction's batch of
# 16 images, where the launcher takes 128-row blocks on 132 SMs (64-row ones
# at B <= 4, above); the plain version one image at a time
@pytest.mark.parametrize("skv", [9216, 77])
def test_flash_kernel_unet_extraction_batch(cuda_device, skv):
    b, sq, h, d = 16, 9216, 8, 40
    q = _randn((b, sq, h, d), 0, cuda_device)
    k = _randn((b, skv, h, d), 1, cuda_device)
    v = _randn((b, skv, h, d), 2, cuda_device)
    got = flash_attention(q, k, v)
    for i in range(b):
        assert _close(got[i:i + 1], flash_attention_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1]))
    assert torch.equal(got, flash_attention(q, k, v))       # same bits


# DiT-XL/2's head size 72 (1,152 channels over 16 heads; the Dp = 128 tile,
# five k16 steps of Q·Kᵀ with columns 72-79 zero) at the tile edges, and the
# two transformer towers' own attentions at 512 px: DiT's S = 1,024, H = 16,
# D = 72 and SD3's joint [latent, context] S = 1,024 + 333 = 1,357, H = 24,
# D = 64, at one image and at the extraction's batch of 16 (the plain
# version one image at a time)
TRANSFORMER_CASES = [(2, s, s, 4, 72) for s in (1, 63, 65, 128, 129, 300)] \
    + [(b, s, s, h, d) for b in (1, 16)
       for s, h, d in ((1024, 16, 72), (1357, 24, 64))]


@pytest.mark.parametrize("b,sq,skv,h,d", TRANSFORMER_CASES)
def test_flash_kernel_dit_and_sd3_shapes(cuda_device, b, sq, skv, h, d):
    q = _randn((b, sq, h, d), 0, cuda_device)
    k = _randn((b, skv, h, d), 1, cuda_device)
    v = _randn((b, skv, h, d), 2, cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    for i in range(b):
        assert _close(got[i:i + 1], flash_attention_plain(
            q[i:i + 1], k[i:i + 1], v[i:i + 1]))
    assert torch.equal(got, flash_attention(q, k, v))       # same bits


# the CLIP text encoders' attention: kernel 2's causal form at S = 77,
# D = 64, with the 12, 16 and 20 heads of SD1.5's CLIP-L, SD2.1's
# OpenCLIP-H and SDXL / SD3's bigG, one prompt and a batch of three
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("h", [12, 16, 20])
def test_flash_kernel_text_encoder_causal(cuda_device, b, h):
    q, k, v = (_randn((b, 77, h, 64), i, cuda_device) for i in range(3))
    before = flash_attention.launches
    got, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want, want_lse = flash_attention_plain(q, k, v, causal=True,
                                           return_lse=True)
    assert _close(got, want)
    # row by row: a late row averages many keys and is small beside row 0
    rows = ((got.float() - want.float()).abs().amax(-1)
            / want.float().abs().amax(-1))
    assert rows.max().item() <= TOL
    assert (lse - want_lse).abs().max().item() < 1e-2
    assert torch.equal(got, flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("penultimate, pooled",
                         [(False, True), (True, False), (True, True)])
def test_text_encoder_bf16_on_the_card(cuda_device, penultimate, pooled):
    """SD1.5's CLIP-L text encoder at full width (two of its 12 blocks,
    seeded random weights) on the empty prompt, whole with the pooled
    output, penultimate (SDXL) and penultimate with the pooled output of
    the whole stack (SD3): the card in bf16 compute (kernel 2, causal, one
    launch a block run) against the CPU in fp32, as ||card - CPU|| /
    ||CPU|| (bf16 rounding of every activation; the pooled output through
    the final LayerNorm)."""
    import dataclasses

    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.io.featurizer_bundle \
        import _empty_prompt_ids
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.models.text_encoder \
        import CLIPTextEncoder, clip_l_text
    cfg = dataclasses.replace(clip_l_text(), num_layers=2)
    cpu = CLIPTextEncoder(cfg, FP32_PRECISION)
    init_weights(cpu, torch.Generator().manual_seed(0))
    card = CLIPTextEncoder(cfg, DEFAULT_PRECISION, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(_empty_prompt_ids()).long()
    n = cfg.num_layers - 1 if penultimate else None
    before = flash_attention.launches
    with torch.no_grad():
        got, got_pooled = card(ids.to(cuda_device), num_blocks=n,
                               want_pooled=pooled)
        torch.cuda.synchronize()
        want, want_pooled = cpu(ids, num_blocks=n, want_pooled=pooled)
    blocks = cfg.num_layers if pooled else n
    assert flash_attention.launches == before + blocks
    assert got.dtype == torch.bfloat16 and got.shape == (1, 77, 768)
    pairs = [(got, want)] + ([(got_pooled, want_pooled)] if pooled else [])
    for g, w in pairs:
        rel = ((g.float().cpu() - w).norm() / w.norm()).item()
        assert rel <= 2e-2, rel


# (B, S, H, D) -> the block rows `launch_flash_fwd` documents: at Dp = 128 a
# grid of 64-row blocks that fits in one wave takes them, a larger one
# 128-row blocks; Dp = 192 always takes 64
BLOCK_ROWS_CASES = [((1, 64, 2, 72), 64), ((16, 1024, 16, 72), 128),
                    ((16, 576, 8, 160), 64)]


@pytest.mark.parametrize("shape,rows", BLOCK_ROWS_CASES)
def test_flash_kernel_reports_its_block_rows(cuda_device, shape, rows):
    q = _randn(shape, 0, cuda_device)
    flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert last_block_rows() == rows


@pytest.mark.parametrize("d", [32, 48, 56, 96, 192])
def test_flash_kernel_other_head_dims_raise(cuda_device, d):
    q = _randn((1, 16, 2, d), 0, cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):   # causal: 64, 128
        flash_attention(_randn((1, 16, 2, 40), 0, cuda_device),
                        _randn((1, 16, 2, 40), 1, cuda_device),
                        _randn((1, 16, 2, 40), 2, cuda_device), causal=True)


@pytest.mark.parametrize("h,kvh,d,t", [(4, 4, 64, 300), (32, 32, 128, 700),
                                       (32, 8, 128, 513)])
def test_decode_kernel(cuda_device, h, kvh, d, t):
    b = 3
    q = _randn((b, 1, h, d), 0, cuda_device)
    k = _randn((b, t, kvh, d), 1, cuda_device)
    v = _randn((b, t, kvh, d), 2, cuda_device)
    rng = np.random.RandomState(3)
    mask = rng.rand(b, t) < 0.7                       # holes everywhere
    mask[:, 128:256] = False                          # a fully masked stretch
    mask[:, 0] = True
    mask = torch.from_numpy(mask).to(cuda_device)
    got = decode_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert _close(got, decode_attention_plain(q, k, v, mask))


@pytest.mark.parametrize("h,kvh,d,t", [(4, 4, 64, 300), (32, 32, 128, 700),
                                       (32, 8, 128, 513)])
def test_decode_kernel_int8_cache(cuda_device, h, kvh, d, t):
    """Kernel 3's int8 branch on `quantize_kv` codes and scales, against the
    plain version on the same codes; the dense counter stays put."""
    b = 3
    q = _randn((b, 1, h, d), 0, cuda_device)
    kc, ks = quantize_kv(_randn((b, t, kvh, d), 1, cuda_device))
    vc, vs = quantize_kv(_randn((b, t, kvh, d), 2, cuda_device))
    rng = np.random.RandomState(3)
    mask = rng.rand(b, t) < 0.7
    mask[:, 128:256] = False
    mask[:, 0] = True
    mask = torch.from_numpy(mask).to(cuda_device)
    before = (decode_attention.launches, decode_attention_int8.launches)
    got = decode_attention(q, kc, vc, mask, ks, vs)
    torch.cuda.synchronize()
    assert (decode_attention.launches, decode_attention_int8.launches) == (
        before[0], before[1] + 1)
    assert _close(got, decode_attention_plain(q, kc, vc, mask, ks, vs))
    with pytest.raises(ValueError, match="k must be"):
        decode_attention(q, kc.float(), vc, mask, ks, vs)


def _decode_mask(b, t, kind, device):
    """"holes": random holes and a masked stretch [T/8, T/2) that covers
    whole splits of the cluster; "edges": row 0 sees only its last slot,
    row 1 nothing (its output must be exactly 0), later rows only their
    second half."""
    rng = np.random.RandomState(b * 7919 + t)
    if kind == "holes":
        mask = rng.rand(b, t) < 0.7
        mask[:, t // 8:t // 2] = False
        mask[:, 0] = True
    else:
        mask = np.zeros((b, t), bool)
        mask[2:, t // 2:] = True
        mask[0, -1] = True
    return torch.from_numpy(mask).to(device)


# kernel 3 at its edges: T below one 32-slot tile, not a multiple of it,
# and across the cluster's splits (from 8 at B x KV = 8 down to 1 at
# B x KV = 1,024); G = H / KV from 1 to 8, head size 64 and 128
DECODE_EDGES = [(b, t, 8 // g, g, d) for b in (1, 4, 16)
                for t in (2, 100, 129, 704, 2048) for g in (1, 2, 4, 8)
                for d in (64, 128)] + [
    (4, 704, 32, 1, 128), (16, 704, 32, 1, 128), (32, 704, 32, 1, 128),
    (4, 2048, 8, 4, 128)]


@pytest.mark.parametrize("kind", ["holes", "edges"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,t,kvh,g,d", DECODE_EDGES)
def test_decode_kernel_edges(cuda_device, b, t, kvh, g, d, int8, kind):
    """Both branches against the plain version, a repeat's bits, and exact
    zeros for a row with no visible slot."""
    gen = torch.Generator(device=cuda_device).manual_seed(t * 31 + b)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device,
                           dtype=torch.bfloat16)
               for shape in ((b, 1, kvh * g, d), (b, t, kvh, d),
                             (b, t, kvh, d)))
    mask = _decode_mask(b, t, kind, cuda_device)
    if int8:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        args = (q, k, v, mask, ks, vs)
    else:
        args = (q, k, v, mask)
    counter = decode_attention_int8 if int8 else decode_attention
    before = counter.launches
    got = decode_attention(*args)
    again = decode_attention(*args)
    torch.cuda.synchronize()
    assert counter.launches == before + 2
    assert torch.equal(got, again)
    assert _close(got, decode_attention_plain(*args))
    blind = ~mask.any(dim=1)
    assert bool((got[blind] == 0).all())


@pytest.mark.parametrize("m,di,do,group", [
    (1, 128, 8, 128), (4, 4096, 4096, 128), (7, 512, 1000, 128),
    (13, 1024, 264, 256), (16, 11008, 512, 128), (17, 256, 72, 128),
    (300, 4096, 1024, 128), (129, 768, 1000, None)])
def test_int4_matmul_kernel(cuda_device, m, di, do, group):
    """Kernel 10 against its plain version: both bodies (M <= 16 with 8 and
    16 rows, M > 16), ragged M and channel counts no tile divides, groups of
    one and several k-tiles. The sums are exact products in fp32 in another
    order, the outputs bf16: 2 bf16 ulps of the largest output."""
    rng = np.random.RandomState(m + di)
    w = torch.from_numpy(rng.randn(do, di).astype(np.float32) * 0.05)
    leaf = {k: v.to(cuda_device)
            for k, v in quantize_int4(w, group_size=group).items()}
    x = _randn((m, di), 1, cuda_device)
    before = int4_matmul_kernel.launches
    got = int4_matmul_kernel(x, leaf["q4"], leaf["scale"])
    torch.cuda.synchronize()
    assert int4_matmul_kernel.launches == before + 1
    want = int4_matmul_plain(x, leaf["q4"], leaf["scale"])
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -6 * max(1.0, want.float().abs().max().item())
    assert torch.equal(got, int4_matmul_kernel(x, leaf["q4"], leaf["scale"]))


@pytest.mark.parametrize("m,di,group", [(4, 1004, None), (3, 12, None),
                                        (20, 1004, 502)])
def test_int4_matmul_odd_contraction_dims(cuda_device, m, di, group):
    """A contraction dim that 8 does not divide: the words hold each group
    zero-padded to whole tiles, `quant.int4_matmul` pads x the same way and
    launches kernel 10 (both bodies), held to its plain version."""
    rng = np.random.RandomState(di + m)
    w = torch.from_numpy(rng.randn(64, di).astype(np.float32) * 0.05)
    leaf = {k: v.to(cuda_device)
            for k, v in quantize_int4(w, group_size=group).items()}
    x = _randn((m, di), 1, cuda_device)
    before = int4_matmul_kernel.launches
    got = int4_matmul(x, leaf)
    torch.cuda.synchronize()
    assert int4_matmul_kernel.launches == before + 1 and got.shape == (m, 64)
    xp = pad_groups(x, leaf["scale"].shape[0], leaf["q4"].shape[1] * 8)
    want = int4_matmul_plain(xp, leaf["q4"], leaf["scale"])
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -6 * max(1.0, want.float().abs().max().item())


def _int4_leaf(seed, do, di, group, device):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.randn(do, di).astype(np.float32) * 0.05)
    return {k: v.to(device)
            for k, v in quantize_int4(w, group_size=group).items()}


@pytest.mark.parametrize("n", [128, 11008])
@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("m", [17, 64, 200, 2812])
def test_int4_matmul_wgmma_body(cuda_device, m, group, n):
    """Kernel 10's wgmma body (M > 16) against its plain version: M from
    just past the small body to a prefill's 2,812 (ragged against the
    128-row tile), groups of one and two stored tiles, one and 86 column
    tiles; a second run gives the same bits."""
    leaf = _int4_leaf(m + group + n, n, 1024, group, cuda_device)
    x = _randn((m, 1024), m, cuda_device)
    before = int4_matmul_kernel.launches
    got = int4_matmul_kernel(x, leaf["q4"], leaf["scale"])
    torch.cuda.synchronize()
    assert int4_matmul_kernel.launches == before + 1
    want = int4_matmul_plain(x, leaf["q4"], leaf["scale"])
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -6 * max(1.0, want.float().abs().max().item())
    assert torch.equal(got, int4_matmul_kernel(x, leaf["q4"], leaf["scale"]))


@pytest.mark.parametrize("m,di,do,group", [
    (17, 256, 72, 128), (300, 1024, 1000, 256), (2812, 4096, 4096, 128),
    (129, 768, 11008, 128)])
def test_int4_matmul_dx_kernel(cuda_device, m, di, do, group):
    """The transposed form, dx = dy @ W with W = bf16(code * bf16(scale)),
    against `dy @ dequantize_int4(..., bfloat16)`: the same weights, sums in
    another order, bf16 out (2 ulps of the largest output); contraction
    dims no 64-row stage divides; a second run gives the same bits."""
    leaf = _int4_leaf(m + di, do, di, group, cuda_device)
    dy = _randn((m, do), m + 1, cuda_device)
    before = int4_matmul_dx.launches
    got = int4_matmul_dx(dy, leaf["q4"], leaf["scale"])
    torch.cuda.synchronize()
    assert int4_matmul_dx.launches == before + 1
    want = dy @ dequantize_int4(leaf, torch.bfloat16)
    assert torch.equal(want, int4_matmul_dx_plain(dy, leaf["q4"],
                                                  leaf["scale"]))
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2 ** -6 * max(1.0, want.float().abs().max().item())
    assert torch.equal(got, int4_matmul_dx(dy, leaf["q4"], leaf["scale"]))


def test_int4_matmul_dx_rejects_what_it_does_not_take(cuda_device):
    leaf = _int4_leaf(0, 64, 256, 128, cuda_device)
    dy = _randn((5, 64), 1, cuda_device)
    small = _int4_leaf(1, 16, 64, 128, cuda_device)        # in = 64: no tile
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        int4_matmul_dx(_randn((5, 16), 2, cuda_device), small["q4"],
                       small["scale"])
    odd = _int4_leaf(2, 12, 128, 128, cuda_device)         # out % 8 != 0
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        int4_matmul_dx(_randn((5, 12), 3, cuda_device), odd["q4"],
                       odd["scale"])
    with pytest.raises(ValueError, match="bfloat16"):
        int4_matmul_dx(dy.float(), leaf["q4"], leaf["scale"])
    with pytest.raises(ValueError, match="bfloat16"):
        int4_matmul_dx(dy[:, :32].contiguous(), leaf["q4"], leaf["scale"])


def test_int4_matmul_kernel_gradient_and_errors(cuda_device):
    """Autograd through kernel 10 gives dx = dy @ dequant(W), through its
    transposed form; shapes the kernel does not take raise on a CUDA tensor
    instead of falling back."""
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(64, 256).astype(np.float32) * 0.05)
    leaf = {k: v.to(cuda_device) for k, v in quantize_int4(w).items()}
    x = _randn((5, 256), 1, cuda_device).requires_grad_()
    dy = _randn((5, 64), 2, cuda_device)
    y = int4_matmul_kernel(x, leaf["q4"], leaf["scale"])
    before = int4_matmul_dx.launches
    (dx,) = torch.autograd.grad(y, x, dy)
    assert int4_matmul_dx.launches == before + 1
    want = dy.float() @ dequantize_int4(leaf)
    assert _close(dx, want)
    small = {k: v.to(cuda_device)
             for k, v in quantize_int4(torch.zeros(16, 64)).items()}
    with pytest.raises(ValueError, match="CUDA kernel needs"):
        int4_matmul_kernel(_randn((2, 64), 3, cuda_device), small["q4"],
                           small["scale"])
    with pytest.raises(ValueError, match="bfloat16"):
        int4_matmul_kernel(x.detach().float(), leaf["q4"], leaf["scale"])


def _check_backward(q, k, v, do, causal, kv_len, slopes=None):
    """Autograd through `flash_attention` (kernel 2 forward, kernels 5 and 6
    backward, one launch each) against the plain backward on the same bf16
    inputs, saved output and LSE; δ as kernel 5 writes it against
    rowsum(dO·O) in fp32; a repeat gives the same bits."""
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kw = dict(causal=causal, kv_len=kv_len, alibi_slopes=slopes)
    launches = (flash_attention_bwd_dq.launches,
                flash_attention_bwd_dkv.launches)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (launches[0] + 1,
                                                  launches[1] + 1)
    grads = (q.grad, k.grad, v.grad)
    q, k, v, out = q.detach(), k.detach(), v.detach(), out.detach()
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16
        assert _close(got, w)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do,
                                       return_delta=True, **kw)
    want_delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    assert torch.allclose(delta, want_delta, rtol=1e-4, atol=1e-4)
    dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, do, delta, **kw)
    for again, got in zip((dq, dk, dv), grads):             # same bits
        assert torch.equal(again, got)


# kernels 5 and 6 walk tiles of 64 in blocks of 128: S around both, Sq !=
# Skv both ways, kv_len 0 / 1 / a tail no tile divides, GQA 32/8 and 32/1,
# D = 64 and 128, causal and not
BWD_EDGES = (1, 63, 64, 65, 127, 128, 129, 257, 639)


@pytest.mark.parametrize("b,sq,skv,causal,kv_len,h,kvh,d", [
    (2, 190, 190, True, None, 4, 4, 64), (2, 190, 190, True, 150, 8, 2, 128),
    (2, 100, 100, False, 75, 4, 1, 64), (2, 639, 639, True, None, 32, 8, 128),
    *((2, s, s, True, None, 4, 4, 128) for s in BWD_EDGES),
    *((2, s, s, False, None, 4, 2, 64) for s in (1, 64, 129, 257)),
    (2, 129, 300, True, 250, 8, 8, 128), (2, 300, 129, True, None, 8, 8, 128),
    (2, 129, 300, False, None, 8, 8, 64), (2, 300, 129, False, 100, 8, 8,
                                           128),
    (2, 190, 190, True, 0, 4, 4, 128), (2, 190, 190, False, 0, 4, 4, 64),
    (2, 190, 190, True, 1, 4, 4, 128), (2, 384, 384, False, 300, 8, 8, 128),
    (2, 333, 333, True, None, 32, 8, 128), (2, 333, 333, True, None, 32, 1,
                                            128)])
def test_flash_function_backward(cuda_device, b, sq, skv, causal, kv_len, h,
                                 kvh, d):
    """Kernels 5 and 6 at their tile edges (see `_check_backward`)."""
    q = _randn((b, sq, h, d), 0, cuda_device)
    k = _randn((b, skv, kvh, d), 1, cuda_device)
    v = _randn((b, skv, kvh, d), 2, cuda_device)
    _check_backward(q, k, v, _randn((b, sq, h, d), 3, cuda_device), causal,
                    kv_len)


def _alibi_case(device, s, h, kvh, d, b=2):
    from law_of_vision_representation_in_mllms_torch.models.mpt import (
        alibi_slopes)
    q = _randn((b, s, h, d), 0, device)
    k = _randn((b, s, kvh, d), 1, device)
    v = _randn((b, s, kvh, d), 2, device)
    return q, k, v, alibi_slopes(h, device=device)


# MPT-7B's shape, a ragged S, H = 6 (interleaved slopes) at D = 64, GQA
# (the slope is the query head's), non-causal with a kv_len tail; the
# forward loop's tile edges in 64-row blocks (S = 129) and 128-row ones
# (B = 2, H = 32: 128 and 129 rows past one tile)
ALIBI_CASES = [(True, None, 2048, 32, 32, 128), (True, None, 333, 8, 8, 128),
               (True, None, 190, 6, 6, 64), (True, 150, 190, 8, 2, 128),
               (False, 100, 130, 4, 1, 64), (True, None, 129, 4, 4, 64),
               (True, None, 257, 32, 32, 128), (False, 200, 257, 32, 8, 128)]


@pytest.mark.parametrize("causal,kv_len,s,h,kvh,d", ALIBI_CASES)
def test_flash_kernel_alibi(cuda_device, causal, kv_len, s, h, kvh, d):
    """Kernel 2 with the in-kernel ALiBi bias against the plain version with
    the materialised bias; the LSE is that of the biased logits (at
    S = 2,048 it reaches -1,700, where fp32 resolves 1.2e-4)."""
    q, k, v, slopes = _alibi_case(cuda_device, s, h, kvh, d)
    before = flash_attention.launches
    got, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               return_lse=True, alibi_slopes=slopes)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want, want_lse = flash_attention_plain(
        q, k, v, causal=causal, kv_len=kv_len, return_lse=True,
        alibi_slopes=slopes)
    assert _close(got, want)
    assert (lse - want_lse).abs().max().item() < 1e-2
    assert torch.equal(got, flash_attention(                 # same bits
        q, k, v, causal=causal, kv_len=kv_len, alibi_slopes=slopes))
    # the bias is really there: without it the output differs
    plain_nobias = flash_attention_plain(q, k, v, causal=causal,
                                         kv_len=kv_len)
    assert not _close(got, plain_nobias)
    # [B, H] slopes that differ by batch row
    sl2 = torch.stack([slopes, slopes.flip(0)])
    got2 = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                           alibi_slopes=sl2)
    assert _close(got2, flash_attention_plain(
        q, k, v, causal=causal, kv_len=kv_len, alibi_slopes=sl2))


# the backward's tile edges with the bias: S around 64 and 128, GQA 32/1,
# kv_len 1, D = 64 non-causal
ALIBI_BWD_CASES = ALIBI_CASES + [
    (True, None, 1, 4, 4, 128), (True, None, 63, 4, 4, 128),
    (True, None, 65, 4, 4, 128), (True, None, 639, 32, 1, 128),
    (True, 1, 190, 4, 4, 128), (False, 70, 129, 4, 2, 64)]


@pytest.mark.parametrize("causal,kv_len,s,h,kvh,d", ALIBI_BWD_CASES)
def test_flash_function_backward_alibi(cuda_device, causal, kv_len, s, h,
                                       kvh, d):
    """Kernels 5 and 6 recompute P with the bias: autograd through
    `flash_attention(alibi_slopes=...)` against the plain biased backward
    on the same bf16 inputs, saved output and LSE (see `_check_backward`)."""
    q, k, v, slopes = _alibi_case(cuda_device, s, h, kvh, d)
    _check_backward(q, k, v, _randn(q.shape, 3, cuda_device), causal, kv_len,
                    slopes)


def test_flash_alibi_rejects_bad_slopes(cuda_device):
    q, k, v, slopes = _alibi_case(cuda_device, 64, 4, 4, 64)
    with pytest.raises(ValueError, match="alibi_slopes"):
        flash_attention(q, k, v, alibi_slopes=slopes.cpu())
    with pytest.raises(ValueError, match="alibi_slopes"):
        flash_attention(q, k, v, alibi_slopes=slopes[:3])
    with pytest.raises(ValueError, match="alibi_slopes"):
        flash_attention(q, k, v, alibi_slopes=slopes.double())


A_TOL = 1e-5      # fp32 in, fp32 sums over D; cosines lie in [-1, 1]


def _a_inputs(n, st, sa, d, dtype, device, masks):
    rng = np.random.RandomState(7)
    t = torch.from_numpy(rng.randn(n, st, d).astype(np.float32))
    a = torch.from_numpy(rng.randn(n, sa, d).astype(np.float32))
    tm = am = None
    if masks:
        tm = torch.from_numpy(rng.rand(n, st) < 0.7)
        am = torch.from_numpy(rng.rand(n, sa) < 0.6)
        tm[-1] = False                     # an image with no valid target row
        am[:, 0] = True                    # never a row with no valid anchor
        tm, am = tm.to(device), am.to(device)
    return t.to(device, dtype), a.to(device, dtype), tm, am


@pytest.mark.parametrize("n,st,sa,d,dtype,masks", [
    (100, 576, 576, 4096, torch.float32, False),
    (100, 576, 256, 4096, torch.float32, False),
    (5, 150, 77, 1000, torch.float32, True),
    (3, 65, 130, 37, torch.float32, True),        # D no vector load divides
    (4, 576, 256, 4096, torch.bfloat16, True),
    (2, 100, 64, 256, torch.float16, False)])
def test_a_score_kernel(cuda_device, n, st, sa, d, dtype, masks):
    t, a, tm, am = _a_inputs(n, st, sa, d, dtype, cuda_device, masks)
    before, wgmma = max_cos.launches, max_cos.wgmma_launches
    got = max_cos(t, a, tm, am)
    again = max_cos(t, a, tm, am)
    torch.cuda.synchronize()
    assert max_cos.launches == before + 2
    # the 3xTF32 body takes fp32 with D % 4 == 0, the SIMT body the rest
    tf32 = dtype == torch.float32 and d % 4 == 0
    assert max_cos.wgmma_launches == wgmma + (2 if tf32 else 0)
    assert got.shape == (n,) and got.dtype == torch.float32
    assert torch.equal(got, again)                 # fixed-order sums
    want = a_score_plain(t, a, tm, am)
    assert (got - want).abs().max().item() <= A_TOL
    if masks:
        assert got[-1].item() == 0.0


def test_a_score_kernel_self_anchor(cuda_device):
    t, _, _, _ = _a_inputs(6, 200, 200, 512, torch.float32, cuda_device,
                           False)
    got = max_cos(t, t.clone())
    assert (got - 1.0).abs().max().item() <= A_TOL


# the 3xTF32 body's edges: 128-row target and anchor blocks, the 64-wide
# products of a last anchor block, a warpgroup past St
A_EDGES = (1, 63, 65, 127, 129, 191, 193, 577)


def _a_check(t, a, tm=None, am=None):
    """Kernel 9 against its plain version (A_TOL) and a repeat (same bits);
    returns the kernel's scores."""
    got = max_cos(t, a, tm, am)
    again = max_cos(t, a, tm, am)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - a_score_plain(t, a, tm, am)).abs().max().item() <= A_TOL
    return got


@pytest.mark.parametrize("st", A_EDGES)
@pytest.mark.parametrize("sa", A_EDGES)
def test_a_score_wgmma_edges(cuda_device, st, sa):
    t, a, _, _ = _a_inputs(2, st, sa, 96, torch.float32, cuda_device, False)
    wgmma = max_cos.wgmma_launches
    _a_check(t, a)
    assert max_cos.wgmma_launches == wgmma + 2


@pytest.mark.parametrize("n,st,sa,d", [
    (1, 576, 576, 4096),      # one image
    (3, 100, 100, 256),       # a 128-row box would cross into the next image
    (2, 130, 70, 1000),       # D tails that leave a zero-filled chunk
    (2, 70, 130, 4100)])
def test_a_score_wgmma_shapes(cuda_device, n, st, sa, d):
    t, a, tm, am = _a_inputs(n, st, sa, d, torch.float32, cuda_device, True)
    # images far apart: a row read from the next image would show
    t = t + torch.arange(n, device=cuda_device)[:, None, None] * 3.0
    _a_check(t, a)
    _a_check(t, a, tm, am)


def test_a_score_wgmma_negative_cosines(cuda_device):
    """Every valid anchor points away from every target (cosines ~ -0.9): a
    zero-filled column past Sa (cosine 0) or a masked column (cosine
    ~ +0.9) must not win the row max."""
    rng = np.random.RandomState(13)
    base = rng.randn(512).astype(np.float32)

    def rows(sign, s):
        x = sign * base + 0.3 * rng.randn(2, s, 512).astype(np.float32)
        return torch.from_numpy(x).to(cuda_device)
    t, a = rows(1.0, 150), rows(-1.0, 65)
    assert _a_check(t, a).max().item() < -0.5
    am = torch.ones(2, 65, dtype=torch.bool, device=cuda_device)
    am[:, ::3] = False
    a[:, ::3] = rows(1.0, 65)[:, ::3]
    assert _a_check(t, a, None, am).max().item() < -0.5


def _structured(n, st, sa, d, seed, device):
    """Embeddings as towers give them: a mean that every row shares, 8
    outlier channels 60 times the rest, and anchors that are the targets
    with 5 % noise, so that cosines lie near 1."""
    rng = np.random.RandomState(seed)
    mean = rng.randn(d).astype(np.float32)
    t = mean + rng.randn(n, st, d).astype(np.float32)
    t[..., rng.choice(d, 8, replace=False)] *= 60
    a = t[:, np.arange(sa) % st] * (1 + 0.05 * rng.randn(n, sa, d))
    return (torch.from_numpy(t).to(device),
            torch.from_numpy(a.astype(np.float32)).to(device))


@pytest.mark.parametrize("sa", [576, 256])
def test_a_score_wgmma_structured(cuda_device, sa):
    """Cosines near 1, where one TF32 product alone errs by ~1e-5: the three
    products stay within A_TOL, and target = anchor within A_TOL of 1."""
    t, a = _structured(8, 576, sa, 4096, 11, cuda_device)
    # rows past Sa have no near-duplicate among the anchors (~0.9)
    assert _a_check(t, a).min().item() > (0.99 if sa >= 576 else 0.9)
    got = _a_check(t, t.clone())
    assert (got - 1.0).abs().max().item() <= A_TOL


def test_a_score_wgmma_low_bits(cuda_device):
    """Every element with its 13 bits below TF32 set (the rounding of hi
    goes up, lo is negative), target = anchor and against a second draw."""
    g = torch.Generator(device=cuda_device).manual_seed(12)

    def draw():
        x = torch.randn(4, 256, 512, generator=g, device=cuda_device)
        return (x.view(torch.int32) | 0x1FFF).view(torch.float32)
    t, a = draw(), draw()
    _a_check(t, a)
    got = _a_check(t, t.clone())
    assert (got - 1.0).abs().max().item() <= A_TOL


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("value", [float("nan"), float("inf")])
@pytest.mark.parametrize("where", ["target", "anchor"])
@pytest.mark.parametrize("dtype,d", [(torch.float32, 256),     # wgmma
                                     (torch.bfloat16, 256),    # SIMT
                                     (torch.float32, 37)])     # SIMT
def test_a_score_kernel_non_finite(cuda_device, dtype, d, where, value,
                                   masked):
    """A NaN or Inf in a valid target or anchor row gives NaN, as the plain
    version (`torch.amax`) does; in a masked-out row it changes nothing, not
    a bit."""
    t, a, tm, am = _a_inputs(3, 130, 70, d, dtype, cuda_device, True)
    tm[-1] = True
    x, mask, row = (t, tm, 5) if where == "target" else (a, am, 7)
    mask[1, row] = not masked
    wgmma = max_cos.wgmma_launches
    before = max_cos(t, a, tm, am)
    x[1, row, 3] = value
    got = max_cos(t, a, tm, am)
    torch.cuda.synchronize()
    assert max_cos.wgmma_launches == wgmma + (2 if d == 256 and
                                              dtype == torch.float32 else 0)
    want = a_score_plain(t, a, tm, am)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[1])) != masked
    assert not bool(torch.isnan(got[[0, 2]]).any())
    finite = ~torch.isnan(want)
    assert (got[finite] - want[finite]).abs().max().item() <= A_TOL
    if masked:
        assert torch.equal(got, before)


def test_a_score_kernel_rejects_bad_inputs(cuda_device):
    t, a, _, _ = _a_inputs(2, 10, 12, 16, torch.float32, cuda_device, False)
    with pytest.raises(ValueError):
        max_cos(t, a.to(torch.bfloat16))
    with pytest.raises(ValueError):
        max_cos(t.transpose(1, 2), a)
    with pytest.raises(ValueError):
        max_cos(t, a, torch.ones(2, 10, device=cuda_device))
    with pytest.raises(RuntimeError):
        max_cos(t.requires_grad_(), a)


@pytest.mark.parametrize("impl,counter", [("flash", flash_attention),
                                          ("encoder2", encoder_attention),
                                          ("tpu_flash", encoder_attention)])
def test_tower_routes(cuda_device, impl, counter):
    """`tower_attn_impl` routes on the card: a narrow 336 px tower (S = 577,
    head_dim 64) in bf16 through kernel 2 non-causal (`flash`) or kernel 1,
    against the same weights on the CPU in fp32 (plain attention)."""
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTConfig, ViTTower)
    cfg = ViTConfig(image_size=336, patch_size=14, hidden_size=256,
                    num_layers=3, num_heads=4, intermediate_size=512,
                    attn_impl=impl)
    cpu = ViTTower(cfg, -2, "patch", FP32_PRECISION)
    init_weights(cpu, torch.Generator().manual_seed(0))
    gpu = ViTTower(cfg, -2, "patch", BF16_PRECISION, device=cuda_device)
    gpu.load_state_dict(cpu.state_dict())
    px = torch.from_numpy(
        np.random.RandomState(1).randn(2, 336, 336, 3).astype(np.float32))
    before = counter.launches
    with torch.no_grad():
        got = gpu(px.to(cuda_device))
        want = cpu(px)
    torch.cuda.synchronize()
    assert counter.launches == before + 2          # one per block run
    err = (got.float().cpu() - want).abs().max().item()
    assert err <= 5e-2 * want.abs().max().item()


def test_kernels_reject_bad_inputs(cuda_device):
    q = _randn((1, 16, 2, 32), 0, cuda_device)        # head_dim 32
    with pytest.raises(ValueError):
        encoder_attention(q, q, q)
    with pytest.raises(ValueError):
        encoder_attention(q.float(), q.float(), q.float())


def _narrow_llava(device, quantize, kv_quant):
    """A narrow LLaVA in bf16 on the card: a 2-layer 112 px tower
    (head_dim 64), 2 decoder layers of head_dim 128 with GQA (group 2) and
    an intermediate size kernel 10 takes whole (768)."""
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llama as L
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        TowerEntry, TowerSpec)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTConfig)
    from law_of_vision_representation_in_mllms_torch.ops.quant import (
        quantize_decoder)
    vit = ViTConfig(image_size=112, patch_size=14, hidden_size=128,
                    num_layers=2, num_heads=2, intermediate_size=256)
    entry = TowerEntry(name="narrow-clip-112", kind="vit", vit_config=vit,
                       vit_family="clip", hidden_size=128,
                       num_patches=vit.num_patches, img_size=112)
    cfg = M.LlavaConfig(
        tower_spec=TowerSpec(entries=[entry], join="single"),
        decoder=L.LlamaConfig(vocab_size=1000, hidden_size=256,
                              intermediate_size=768, num_layers=2,
                              num_heads=2, num_kv_heads=1),
        kv_quant=kv_quant)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           BF16_PRECISION, device)
    if quantize:
        quantize_decoder(params.decoder, bits=4)
    rng = np.random.RandomState(1)
    ids = rng.randint(3, 1000, size=(3, 20))
    ids[:, 1] = -200
    mask = np.ones((3, 20), bool)
    mask[1, 14:] = False
    mask[2, 9:] = False
    px = rng.randn(3, 112, 112, 3).astype(np.float32)
    inputs = (torch.from_numpy(ids).to(device),
              torch.from_numpy(mask).to(device),
              [torch.from_numpy(px).to(device)])
    return cfg, params, inputs


@pytest.mark.parametrize("quantize,kv_quant", [(None, None),
                                               ("int4", "int8")])
def test_captured_chunk_equals_eager_steps(cuda_device, quantize, kv_quant):
    """`ChunkedGreedyDecoder` on the card: each chunk of 4 steps is one
    replayed CUDA graph with kernel 3 (its int8 branch over the int8 cache)
    and kernel 10 recorded in it. At equal T (8 new tokens, 2 chunks) its
    tokens and the cache it wrote are the eager steps' bit for bit, and a
    second `generate` replays the same graphs to the same bits."""
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.decode import (
        ChunkedGreedyDecoder)
    cfg, params, inputs = _narrow_llava(cuda_device, quantize, kv_quant)
    n_new, layers = 8, cfg.decoder.num_layers
    # the eager steps: the prefill, then the greedy token of each step fed
    # to the next (7 forwards; the chunk also forwards the 8th token)
    pre = M.prefill(params, cfg, *inputs, max_new_tokens=n_new)
    tok = pre.logits.argmax(-1)
    want = [tok]
    for t in range(n_new - 1):
        tok = M.decode_step(params, pre, tok, t).argmax(-1)
        want.append(tok)
    want = torch.stack(want, dim=1)
    assert torch.equal(want, M.generate_greedy(
        params, cfg, *inputs, max_new_tokens=n_new, eos_id=-1))

    dec = ChunkedGreedyDecoder(params, cfg, eos_id=-1, chunk=4)
    got = dec.generate(*inputs, max_new_tokens=n_new)
    torch.cuda.synchronize()
    assert dec.captures == 1 and dec.replays == 2
    assert torch.equal(got, want)
    (st,) = dec._keys.values()
    written = slice(0, pre.l_out + n_new - 1)
    for layer_want, layer_got in zip(pre.cache, st.cache):
        for x_want, x_got in zip(layer_want, layer_got):
            assert torch.equal(x_got[:, written], x_want[:, written])
    name = "decode_attention_int8" if kv_quant else "decode_attention"
    recorded = st.step.launches
    assert recorded[name] == 4 * layers
    assert recorded["int4_matmul"] == (4 * (7 * layers + 1)
                                       if quantize else 0)
    assert dec.graph_launches()[name] == 2 * 4 * layers

    before = {k: v for k, v in recorded.items()}
    again = dec.generate(*inputs, max_new_tokens=n_new)
    torch.cuda.synchronize()
    assert dec.captures == 1 and dec.replays == 4
    assert torch.equal(again, want)
    assert st.step.launches == before


def test_chunked_decoder_drops_old_keys_on_the_card(cuda_device):
    """With `max_keys=1` each new key drops the last one's graph and static
    tensors: three rounds over two keys capture a graph each time, give the
    first round's tokens bit for bit, and leave the allocated memory where
    the second round left it."""
    from law_of_vision_representation_in_mllms_torch.models.decode import (
        ChunkedGreedyDecoder)
    cfg, params, inputs = _narrow_llava(cuda_device, None, None)
    pair = (inputs[0][:2], inputs[1][:2], [inputs[2][0][:2]])
    dec = ChunkedGreedyDecoder(params, cfg, eos_id=-1, chunk=4)
    dec.max_keys = 1
    seen, allocated = [], []
    for _ in range(3):
        seen.append((dec.generate(*inputs, max_new_tokens=8).cpu(),
                     dec.generate(*pair, max_new_tokens=8).cpu()))
        torch.cuda.synchronize()
        assert list(dec._keys) == [(2, 20, 8)]
        allocated.append(torch.cuda.memory_allocated(cuda_device))
    assert dec.captures == 6
    for three, two in seen[1:]:
        assert torch.equal(three, seen[0][0]) and torch.equal(two, seen[0][1])
    assert allocated[2] == allocated[1]


def test_captured_verify_round_equals_eager_rounds(cuda_device, monkeypatch):
    """`SpeculativeDecoder` on the card: the verify round, captured once and
    replayed, gives the tokens and the round count of the same rounds run
    eagerly on the card, bit for bit; a second `generate` on the key replays
    the same graph to the same result."""
    from law_of_vision_representation_in_mllms_torch.models import decode as D
    cfg, params, inputs = _narrow_llava(cuda_device, None, None)
    dec = D.SpeculativeDecoder(params, cfg, eos_id=-1, draft_len=4)
    got, rounds = dec.generate(*inputs, max_new_tokens=12)
    assert dec.captures == 1 and dec.replays == rounds
    again, again_rounds = dec.generate(*inputs, max_new_tokens=12)
    assert dec.captures == 1 and dec.replays == 2 * rounds
    assert torch.equal(again, got) and again_rounds == rounds
    eager = D.SpeculativeDecoder(params, cfg, eos_id=-1, draft_len=4)

    def run_eagerly(st, fn, device):
        st.step = D.Replayable(fn, torch.device("cpu"))   # no graph
        return False
    monkeypatch.setattr(eager, "_capture", run_eagerly)
    want, want_rounds = eager.generate(*inputs, max_new_tokens=12)
    assert eager.captures == 0
    assert torch.equal(got, want) and rounds == want_rounds


@pytest.mark.parametrize("quantize,kv_quant", [(None, None),
                                               ("int4", "int8")])
def test_inflight_captured_chunk_equals_eager_chunk(cuda_device, quantize,
                                                    kv_quant, monkeypatch):
    """`InflightEngine` on the card: 3 requests of different lengths through
    2 slots (the third joins a freed slot beside a decoding one), each chunk
    of 4 steps one replayed CUDA graph with kernel 3 (its int8 branch over
    the int8 cache) and kernel 10 recorded in it, give the tokens of the
    same engine whose chunks run eagerly on the card, bit for bit; so does a
    sampled request alone (the sampling chunk's sort inside the graph)."""
    from law_of_vision_representation_in_mllms_torch.models import decode as D
    from law_of_vision_representation_in_mllms_torch.models.inflight import (
        InflightEngine)
    cfg, params, (ids, mask, px) = _narrow_llava(cuda_device, quantize,
                                                 kv_quant)
    ids, mask, px = ids.cpu().numpy(), mask.cpu().numpy(), px[0].cpu().numpy()
    reqs = [(ids[i:i + 1, :n], np.ones((1, n), bool), [px[i:i + 1]])
            for i, n in enumerate(mask.sum(1))]
    budgets = [6, 12, 12]
    layers = cfg.decoder.num_layers
    name = "decode_attention_int8" if kv_quant else "decode_attention"

    def run(eager, reqs, budgets, n_slots=2, **kw):
        eng = InflightEngine(params, cfg, eos_id=-1, n_slots=n_slots,
                             prompt_cap=32, gen_cap=12, chunk=4,
                             sample_seed=5)
        if eager:
            def run_eagerly(st, fn, device):
                st.step = D.Replayable(fn, torch.device("cpu"))  # no graph
                return False
            monkeypatch.setattr(eng, "_capture", run_eagerly)
        try:
            hs = [eng.submit(*r, m, **kw) for r, m in zip(reqs, budgets)]
            return [h.result(timeout=300).tolist() for h in hs], eng
        finally:
            eng.shutdown()
    # one sampled request alone: the same chunks draw the same noise from
    # the seeded generator, captured (the sort inside the graph) or not
    sampled = [run(eager, reqs[:1], [12], n_slots=1, temperature=0.8,
                   top_p=0.9)[0] for eager in (True, False)]
    assert sampled[0] == sampled[1] and len(sampled[0][0]) == 12
    want, eager = run(True, reqs, budgets)
    got, eng = run(False, reqs, budgets)
    assert eager.captures == 0 and eng.captures == 1
    assert eng.replays == eng.dispatches >= 3
    assert [len(t) for t in got] == budgets and got == want
    ((_, chunk),) = eng._keys.items()
    assert chunk.step.launches[name] == 4 * layers
    assert chunk.step.launches["int4_matmul"] == (4 * (7 * layers + 1)
                                                  if quantize else 0)
    assert eng.graph_launches()[name] == eng.replays * 4 * layers


def test_captured_decode_of_1024_tokens_equals_eager(cuda_device,
                                                     monkeypatch):
    """The eval zoo's long generations on the card: `ChunkedGreedyDecoder`
    at `max_new_tokens=1024` (64 replays of a 16-step chunk over a cache of
    l_out + 1,024 slots, the eager path's T) gives eager `generate_greedy`'s
    1,024 tokens bit for bit. Kernel 3's shapes in the captured chunk (T >
    1,024) are recorded and each held to its plain version on random inputs
    with masked slots."""
    from law_of_vision_representation_in_mllms_torch.models import llama
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.decode import (
        ChunkedGreedyDecoder)
    cfg, params, inputs = _narrow_llava(cuda_device, None, None)
    n_new = 1024
    want = M.generate_greedy(params, cfg, *inputs, max_new_tokens=n_new,
                             eos_id=-1)
    shapes = set()
    kernel = llama.decode_attention

    def spy(q, k, v, mask, *rest):
        shapes.add((q.shape[0], k.shape[1], q.shape[2], k.shape[2],
                    q.shape[3]))
        return kernel(q, k, v, mask, *rest)
    monkeypatch.setattr(llama, "decode_attention", spy)
    dec = ChunkedGreedyDecoder(params, cfg, eos_id=-1, chunk=16)
    got = dec.generate(*inputs, max_new_tokens=n_new)
    torch.cuda.synchronize()
    assert dec.captures == 1 and dec.replays == n_new // 16
    assert torch.equal(got, want)
    l_out = inputs[0].shape[1] + cfg.num_patches - 1
    assert shapes == {(3, l_out + n_new, 2, 1, 128)}
    for b, t, h, kvh, d in shapes:
        q = _randn((b, 1, h, d), t, cuda_device)
        k = _randn((b, t, kvh, d), t + 1, cuda_device)
        v = _randn((b, t, kvh, d), t + 2, cuda_device)
        mask = torch.from_numpy(
            np.random.RandomState(t).rand(b, t) < 0.8).to(cuda_device)
        mask[:, 0] = True
        mask[-1] = False
        mask[-1, t - 1] = True
        assert _close(decode_attention(q, k, v, mask),
                      decode_attention_plain(q, k, v, mask))
