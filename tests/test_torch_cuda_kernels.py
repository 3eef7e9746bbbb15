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

from law_of_vision_representation_in_mllms_torch.ops.decode_attention import (
    decode_attention, decode_attention_plain)
from law_of_vision_representation_in_mllms_torch.ops.encoder_attention import (
    encoder_attention, encoder_attention_plain)
from law_of_vision_representation_in_mllms_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq,
    flash_attention_bwd_plain, flash_attention_plain)

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


@pytest.mark.parametrize("b,s,h,d", [(2, 77, 4, 64), (4, 577, 16, 64),
                                     (1, 200, 2, 128)])
def test_encoder_kernel(cuda_device, b, s, h, d):
    q, k, v = (_randn((b, s, h, d), i, cuda_device) for i in range(3))
    before = encoder_attention.launches
    got = encoder_attention(q, k, v)
    torch.cuda.synchronize()
    assert encoder_attention.launches == before + 1
    assert _close(got, encoder_attention_plain(q, k, v))


@pytest.mark.parametrize("causal,kv_len,h,kvh,d", [
    (True, None, 4, 4, 64), (True, 150, 8, 2, 128), (False, 100, 4, 1, 64),
    (True, 600, 32, 32, 128)])
def test_flash_kernel(cuda_device, causal, kv_len, h, kvh, d):
    b, s = 2, 640 if h == 32 else 190
    q = _randn((b, s, h, d), 0, cuda_device)
    k = _randn((b, s, kvh, d), 1, cuda_device)
    v = _randn((b, s, kvh, d), 2, cuda_device)
    got, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               return_lse=True)
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           kv_len=kv_len, return_lse=True)
    torch.cuda.synchronize()
    assert _close(got, want)
    assert (lse - want_lse).abs().max().item() < 1e-2


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


@pytest.mark.parametrize("causal,kv_len,s,h,kvh,d", [
    (True, None, 190, 4, 4, 64), (True, 150, 190, 8, 2, 128),
    (False, 75, 100, 4, 1, 64), (True, None, 639, 32, 8, 128)])
def test_flash_function_backward(cuda_device, causal, kv_len, s, h, kvh, d):
    """Autograd through `flash_attention` on the card: kernel 2 forward,
    kernels 5 and 6 backward, against the plain backward on the same bf16
    inputs, saved output and LSE."""
    b = 2
    q, k, v = (_randn((b, s, n, d), i, cuda_device).requires_grad_()
               for i, n in enumerate((h, kvh, kvh)))
    do = _randn((b, s, h, d), 3, cuda_device)
    launches = (flash_attention_bwd_dq.launches,
                flash_attention_bwd_dkv.launches)
    out, lse = flash_attention(q, k, v, causal=causal, kv_len=kv_len,
                               return_lse=True)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (launches[0] + 1,
                                                  launches[1] + 1)
    want = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                     out.detach(), lse, do, causal=causal,
                                     kv_len=kv_len)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == torch.bfloat16
        assert _close(got, w)


def test_kernels_reject_bad_inputs(cuda_device):
    q = _randn((1, 16, 2, 32), 0, cuda_device)        # head_dim 32
    with pytest.raises(ValueError):
        encoder_attention(q, q, q)
    with pytest.raises(ValueError):
        encoder_attention(q.float(), q.float(), q.float())
