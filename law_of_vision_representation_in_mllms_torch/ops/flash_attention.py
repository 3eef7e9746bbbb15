"""Kernel 2: flash-attention forward for the decoder prefill (GQA in-kernel).

Replaces the TPU kernel `ops/flash_attention.py` `_flash_fwd_lse` (the
forward `pl.pallas_call` of `flash_attention_trainable`, body
`_fwd_lse_kernel`) of the JAX package, which the prefill reaches through
`flash_mha_trainable`; the backward kernels are not ported yet. Source:
`csrc/flash_attention.cu` on the tile loop of `csrc/attention_common.cuh`.

What bounds it on the H100: at the Vicuna-7B prefill (B = 4, S ~ 700,
H = 32, D = 128) a causal layer is ~16 GFLOP against ~92 MB of Q, K, V and
O, near the bf16 ridge point. The kernel never writes logits, skips causal
tiles past each query tile, and maps query head h to kv head h // (H / KV)
itself, so K and V are read at their true size instead of repeated.

Padding contract (kept from the JAX flash prefill, `models/llama.py`): the
kernel takes no key-padding mask, only causality and a `kv_len` tail. A
prefill batch must be RIGHT-padded: every row's valid tokens come first, so a
valid query never sees a pad key. The splice guarantees it (text is
right-padded, the image is spliced before the pad).

`flash_attention` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          kv_len: int | None = None,
                          return_lse: bool = False):
    """fp32 reference. q [B, Sq, H, D]; k, v [B, Skv, KV, D]. Key j is
    visible to query i iff j < kv_len and (not causal or j <= i). A row that
    sees no key gives 0 and LSE 0, as the TPU kernel does."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if kv_len is None:
        kv_len = skv
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * d ** -0.5
    j = torch.arange(skv, device=q.device)
    visible = (j < kv_len)[None, :].expand(sq, skv)
    if causal:
        visible = visible & (j[None, :] <= torch.arange(sq, device=q.device)
                             [:, None])
    logits = logits.masked_fill(~visible, float("-inf"))
    any_visible = visible.any(dim=-1)                        # [Sq]
    lse = torch.logsumexp(logits, dim=-1)                    # [B, H, Sq]
    lse = torch.where(any_visible, lse, torch.zeros_like(lse))
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if return_lse:
        return out, lse
    return out


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_len: int | None = None, return_lse: bool = False):
    """q [B, Sq, H, D]; k, v [B, Skv, KV, D] with H % KV == 0. Returns
    [B, Sq, H, D] (and the fp32 natural-log LSE [B, H, Sq] if asked)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("flash_attention: q [B,Sq,H,D], k/v [B,Skv,KV,D]")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"flash_attention: incompatible shapes "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if kv_len is None:
        kv_len = skv
    if not 0 <= kv_len <= skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[0, {skv}]")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _build.check_inputs("flash_attention", {"q": q, "k": k, "v": v}, d)
    out = q.new_empty(q.shape)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.library()
    err = lib.lvr_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, sq, skv, h, kvh, d, int(kv_len), int(bool(causal)), d ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    if return_lse:
        return out, lse
    return out


flash_attention.launches = 0
