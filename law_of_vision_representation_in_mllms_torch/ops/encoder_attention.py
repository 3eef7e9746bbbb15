"""Kernel 1: fused non-causal attention for the ViT towers.

Replaces the TPU kernel `ops/encoder_attention.py` `encoder_mha` (`_call` ->
`pl.pallas_call`, body `_kernel`) of the JAX package. Source:
`csrc/encoder_attention.cu` on kernel 2's forward loop,
`csrc/flash_fwd_hopper.cuh`, non-causal and without the LSE.

What bounds it on the H100: at CLIP-L/14-336 (B = 4, S = 577, H = 16, D = 64)
a layer is 5.5 GFLOP of attention over 19 MB of Q, K, V and O: the tensor
cores (0.0055 ms) and HBM (0.0056 ms) set the same floor, and a launch is a
few microseconds, so the loop's fill and drain count. The plain path instead
writes and re-reads [B, H, S, S] fp32 logits (~85 MB a layer). The kernel
keeps scores in registers (wgmma, online softmax, fp32 statistics), brings
Q, K and V by TMA, which reads rows past S as zeros, and masks only the tail
tile, so there is no host-side padding or transpose. The one-image calls of
the embedding dumps run in 64-row blocks where those fit in one wave.

`encoder_attention` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

from . import _build
from .attention import mha


def encoder_attention_plain(q, k, v):
    """softmax(q·kᵀ/√D)·v in fp32; q, k, v [B, S, H, D] -> q.dtype."""
    return mha(q.float(), k.float(), v.float()).to(q.dtype)


def encoder_attention(q, k, v):
    """Non-causal attention, q, k, v [B, S, H, D] -> [B, S, H, D]."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"encoder_attention: q, k, v must share a "
                         f"[B, S, H, D] shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _build.forbid_grad("encoder_attention", q, k, v)
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    b, s, h, d = q.shape
    _build.check_inputs("encoder_attention", {"q": q, "k": k, "v": v}, d)
    out = q.new_empty(q.shape)
    lib = _build.library()
    err = lib.lvr_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, s, h, d, d ** -0.5, _build.stream_handle(q.device))
    _build.check(err, "encoder_attention")
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
