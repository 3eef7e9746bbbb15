"""Kernel 3: flash-decode attention, q_len = 1, over the KV cache in place.

Replaces the TPU kernel `ops/decode_attention.py` `decode_attention`
(`pl.pallas_call` body `_kernel`, dense-cache branch) of the JAX package.
Source: `csrc/decode_attention.cu`.

What bounds it on the H100: a decode step is a matvec per head, ~0.1 FLOP
per cache byte, so the floor is one HBM read of the visible cache (Vicuna-7B,
B = 4, T ~ 700: ~46 MB a layer, ~14 us at 3.35 TB/s). The kernel reads the
cache in its stored [B, T, KV, Dh] layout (no transpose copy), one block per
(kv head, batch row) with several coalesced row loads in flight per warp;
masked slots are never loaded, and query heads of one kv head share each K/V
row read (GQA).

The int8 cache with per-(slot, head) scales (`kv_quant`) is not ported yet:
the wrapper raises when scales are passed.

`decode_attention` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build


def decode_attention_plain(q, k, v, mask):
    """fp32 reference. q [B, 1, H, Dh]; k, v [B, T, KV, Dh]; mask [B, T]
    bool. A row with no visible slot gives 0."""
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q[:, 0].float().reshape(b, kvh, g, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * dh ** -0.5
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    out = torch.where(den > 0, out / den.clamp_min(1e-30),
                      torch.zeros_like(out))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def decode_attention(q, k, v, mask, k_scale=None, v_scale=None):
    """q [B, 1, H, Dh]; k, v [B, T, KV, Dh]; mask [B, T] bool. Returns
    [B, 1, H, Dh] in q.dtype."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "decode_attention: the int8 KV cache (model.kv_quant) is not "
            "ported yet (ROADMAP, queue 2)")
    b, s_q, h, dh = q.shape
    if s_q != 1:
        raise ValueError(f"decode_attention: q_len must be 1, got {s_q}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"decode_attention: incompatible q {tuple(q.shape)}"
                         f" and cache {tuple(k.shape)}")
    t, kvh = k.shape[1], k.shape[2]
    if tuple(mask.shape) != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"decode_attention: mask must be bool [{b}, {t}], "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    _build.forbid_grad("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _build.check_inputs("decode_attention", {"q": q, "k": k, "v": v}, dh)
    if h // kvh not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention: group size {h // kvh} not in "
                         f"(1, 2, 4, 8)")
    if mask.device != q.device:
        raise ValueError("decode_attention: mask on another device")
    mask = mask.contiguous()
    out = q.new_empty(q.shape)
    lib = _build.library()
    err = lib.lvr_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b, t, h, kvh, dh, dh ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
