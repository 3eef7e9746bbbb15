"""Kernel 3: flash-decode attention, q_len = 1, over the KV cache in place.

Replaces the TPU kernel `ops/decode_attention.py` `decode_attention`
(`pl.pallas_call` body `_kernel`, the dense-cache and the int8-cache branch)
of the JAX package. Source: `csrc/decode_attention.cu`.

What bounds it on the H100: a decode step is a matvec per head, ~0.1 FLOP
per cache byte, so the floor is one HBM read of the visible cache (Vicuna-7B,
B = 4, T = 704: 46 MB a layer, 0.0138 ms at 3.35 TB/s). The kernel reads the
cache in its stored [B, T, KV, Dh] layout (no transpose copy). The slots of
one (kv head, batch row) are split over a thread-block cluster of up to 8
blocks, the split chosen from B, KV, the group size and T alone (never from
the mask or anything read back from the card, so a launch can be captured in
a CUDA graph): a grid of ~256 blocks, all resident at once. In each block
two warps copy the visible rows of a 32-slot tile into a shared-memory ring
by 16-byte `cp.async` (no tensor map, nothing encoded on the host); a tile
with no visible slot is never copied. Four warps read the rows 16 bytes a
lane and keep an online softmax; the blocks' partials merge through
distributed shared memory in a fixed order, so a repeat gives the same bits.
Query heads of one kv head share each K/V row read (GQA). A launch the card
refuses (the cluster, the shared memory) raises.

The int8 cache (`model.kv_quant=int8`, `ops.quant.quantize_kv`) holds codes
[B, T, KV, Dh] and one fp32 scale per (slot, kv head), `k_scale`/`v_scale`
[B, T, KV]: half the bytes a step reads. The K scale multiplies the slot's
logit after the q.k sum, the softmax denominator adds up the raw
probabilities and the V scale enters the numerator only. It is the same
kernel with the cache type as a template parameter; the wrapper counts its
launches apart (`decode_attention_int8.launches`), so a run can show which
branch it took.

`decode_attention` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build


def decode_attention_plain(q, k, v, mask, k_scale=None, v_scale=None):
    """fp32 reference. q [B, 1, H, Dh]; k, v [B, T, KV, Dh] (values, or int8
    codes with `k_scale`, `v_scale` [B, T, KV]); mask [B, T] bool. A row
    with no visible slot gives 0."""
    b, _, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q[:, 0].float().reshape(b, kvh, g, dh)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * dh ** -0.5
    if k_scale is not None:
        s = s * k_scale.float().transpose(1, 2)[:, :, None, :]
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)           # the raw probabilities
    if v_scale is not None:
        p = p * v_scale.float().transpose(1, 2)[:, :, None, :]
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    out = torch.where(den > 0, out / den.clamp_min(1e-30),
                      torch.zeros_like(out))
    return out.reshape(b, 1, h, dh).to(q.dtype)


def _check_shapes(q, k, v, mask):
    b, s_q, h, dh = q.shape
    if s_q != 1:
        raise ValueError(f"decode_attention: q_len must be 1, got {s_q}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"decode_attention: incompatible q {tuple(q.shape)}"
                         f" and cache {tuple(k.shape)}")
    t = k.shape[1]
    if tuple(mask.shape) != (b, t) or mask.dtype != torch.bool:
        raise ValueError(f"decode_attention: mask must be bool [{b}, {t}], "
                         f"got {mask.dtype} {tuple(mask.shape)}")


def _check_cuda(q, k, mask):
    b, _, h, dh = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if h // k.shape[2] not in (1, 2, 4, 8):
        raise ValueError(f"decode_attention: group size {h // k.shape[2]} "
                         f"not in (1, 2, 4, 8)")
    if mask.device != q.device:
        raise ValueError("decode_attention: mask on another device")


def decode_attention(q, k, v, mask, k_scale=None, v_scale=None):
    """q [B, 1, H, Dh]; k, v [B, T, KV, Dh]; mask [B, T] bool. With
    `k_scale` and `v_scale` (fp32 [B, T, KV]) k and v are int8 codes and the
    int8 branch runs. Returns [B, 1, H, Dh] in q.dtype."""
    if k_scale is not None or v_scale is not None:
        return decode_attention_int8(q, k, v, mask, k_scale, v_scale)
    _check_shapes(q, k, v, mask)
    _build.forbid_grad("decode_attention", q, k, v)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask)
    _check_cuda(q, k, mask)
    b, _, h, dh = q.shape
    _build.check_inputs("decode_attention", {"q": q, "k": k, "v": v}, dh)
    mask = mask.contiguous()
    out = q.new_empty(q.shape)
    err = _build.library().lvr_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), b, k.shape[1], h, k.shape[2], dh, dh ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention_int8(q, k, v, mask, k_scale, v_scale):
    """The int8-cache branch: k, v int8 codes [B, T, KV, Dh], `k_scale` and
    `v_scale` fp32 [B, T, KV]."""
    _check_shapes(q, k, v, mask)
    if k_scale is None or v_scale is None:
        raise ValueError("decode_attention: an int8 cache needs both k_scale "
                         "and v_scale")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if tuple(t.shape) != tuple(k.shape[:3]):
            raise ValueError(f"decode_attention: {name} must be "
                             f"{tuple(k.shape[:3])}, got {tuple(t.shape)}")
    _build.forbid_grad("decode_attention", q)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask, k_scale, v_scale)
    _check_cuda(q, k, mask)
    b, _, h, dh = q.shape
    _build.check_inputs("decode_attention", {"q": q}, dh)
    for name, t, dtype in (("k", k, torch.int8), ("v", v, torch.int8),
                           ("k_scale", k_scale, torch.float32),
                           ("v_scale", v_scale, torch.float32)):
        if t.dtype != dtype or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be a contiguous "
                             f"16-byte aligned {dtype} tensor on {q.device}")
    mask = mask.contiguous()
    out = q.new_empty(q.shape)
    err = _build.library().lvr_decode_attention_int8(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), mask.data_ptr(), out.data_ptr(), b, k.shape[1],
        h, k.shape[2], dh, dh ** -0.5, _build.stream_handle(q.device))
    _build.check(err, "decode_attention_int8")
    decode_attention_int8.launches += 1
    return out


decode_attention.launches = 0
decode_attention_int8.launches = 0
