"""Kernels 2, 5 and 6: flash attention for the decoder, forward and backward
(GQA in-kernel).

Replaces the TPU kernels of `flash_attention_trainable` in the JAX package's
`ops/flash_attention.py`, which the prefill and training reach through
`flash_mha_trainable`:
- kernel 2, `_flash_fwd_lse` (forward + LSE, body `_fwd_lse_kernel`):
  `csrc/flash_attention.cu` on the forward loop of
  `csrc/flash_fwd_hopper.cuh`;
- kernel 5, the dq `pl.pallas_call` of `_bwd` (`_bwd_dq_kernel`) and
  kernel 6, the dk/dv one (`_bwd_dkv_kernel`): `csrc/flash_attention_bwd.cu`.

`FlashAttention` is the `torch.autograd.Function` around them (the JAX
`custom_vjp`): its forward is kernel 2 with the LSE, its backward launches
kernel 5, which also forms δ = rowsum(dO·O) in fp32 from its own O and dO
tiles (the JAX `_bwd` computes it outside any kernel) and writes it for
kernel 6, then kernel 6. `flash_attention` goes through it whenever grad
mode is on and an input requires grad.

What bounds them on the H100: at the Vicuna-7B prefill (B = 4, S = 640,
kv_len 600, H = 32, D = 128) a causal layer is 13.4 GFLOP against 81 MB of
Q, K, V and O, so HBM sets the forward's floor (0.0243 ms); at MPT-7B's
B = 2, S = 2,048 the tensor cores do (68.7 GFLOP, 0.0695 ms). The backward
kernels each do 1.5 × (kernel 5) or 2 × (kernel 6) the forward's FLOPs over
1.5 × its bytes: at a stage-1 step's B = 16, S = 639 HBM sets both floors
(505 MB, 0.151 ms, against 80 and 107 GFLOP), at MPT-7B's shape the tensor
cores (103 and 137.5 GFLOP, 0.104 and 0.139 ms). No kernel writes logits or
probabilities; causal tiles past the diagonal are skipped; query head h
reads kv head h // (H / KV) itself, so K and V are read at their true size
instead of repeated, and kernel 6 sums a group's dk/dv in registers. All
three are Hopper loops: every operand by TMA into an mbarrier ring, every
product on `wgmma` with P (and dS) kept in registers as the next product's
A operand, two warpgroups sharing each loaded tile, the mask only on the
diagonal and tail tiles (`csrc/flash_fwd_hopper.cuh`,
`csrc/flash_attention_bwd.cu`).

ALiBi (MPT, the TPU kernels' `alibi` flag): with `alibi_slopes` (fp32 [H]
or [B, H], the slope of each QUERY head) logit (i, j) gains
slope[b, h] * (j - (kv_len - 1)) before the mask, inside all three kernels;
no [Sq, Skv] bias tensor exists on the card. The kernels add the bias in
exactly that form, as one fused multiply-add onto the scaled score in fp32
(in base 2: slope and scale are taken times log2(e)). The per-row constant
-slope * (kv_len - 1) cancels in the softmax but is kept, because the LSE is
an output and must be the LSE of the biased logits, which is also what the
JAX kernel returns and what kernels 5 and 6 subtract from the same
expression. Its price is resolution: at S = 2,048 and slope 2^-0.25 the bias
reaches -1,721, where one fp32 ulp is 1.2e-4, so P carries a relative error
of that size, the same as in the JAX kernels and well under bf16's rounding
of P (3.9e-3). The slopes take no gradient (the JAX `_bwd` returns zeros).

Padding contract (kept from the JAX flash prefill, `models/llama.py`): the
kernels take no key-padding mask, only causality and a `kv_len` tail. A batch
must be RIGHT-padded: every row's valid tokens come first, so a valid query
never sees a pad key. The splice guarantees it (text is right-padded, the
image is spliced before the pad); a pad row's labels are ignored, so its dO
is zero.

Head sizes: 64 and 128 in every form; the forward's non-causal form without
ALiBi also takes 40, 72, 80 and 160 (`DIFFUSION_HEAD_DIMS`), the diffusion
towers' attention (the JAX `flash_mha` -> `flash_attention_bhsd`: the UNets'
40, 80 and 160, DiT-XL/2's 72), on a tile of D rounded up to 64 whose columns
past D TMA reads as zeros. Any other head size
raises on CUDA; the backward kernels take 64 and 128 only.

Every wrapper takes the plain version only for CPU tensors; for CUDA tensors
it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build


def _visible(sq: int, skv: int, kv_len: int, causal: bool, device):
    """[Sq, Skv] bool: key j is visible to query i iff j < kv_len and (not
    causal or j <= i)."""
    j = torch.arange(skv, device=device)
    visible = (j < kv_len)[None, :].expand(sq, skv)
    if causal:
        visible = visible & (j[None, :] <= torch.arange(sq, device=device)
                             [:, None])
    return visible


def _slopes_bh(name: str, alibi_slopes, b: int, h: int, device):
    """`alibi_slopes` [H] or [B, H] -> contiguous fp32 [B, H] (None stays
    None). The slopes must already lie on the inputs' device."""
    if alibi_slopes is None:
        return None
    sl = alibi_slopes
    if not isinstance(sl, torch.Tensor) or sl.dtype != torch.float32:
        raise ValueError(f"{name}: alibi_slopes must be an fp32 tensor")
    if sl.device != device:
        raise ValueError(f"{name}: alibi_slopes is on {sl.device}, not "
                         f"{device}")
    if tuple(sl.shape) == (h,):
        sl = sl[None].expand(b, h)
    elif tuple(sl.shape) != (b, h):
        raise ValueError(f"{name}: alibi_slopes must be [{h}] or "
                         f"[{b}, {h}], got {tuple(sl.shape)}")
    return sl.contiguous()


def _alibi_bias(slopes, skv: int, kv_len: int, acc):
    """The materialised bias [B, H, 1, Skv] of slopes [B, H]:
    slope * (j - (kv_len - 1))."""
    dist = torch.arange(skv, device=slopes.device) - (kv_len - 1)
    return slopes.to(acc)[:, :, None, None] * dist.to(acc)


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          kv_len: int | None = None,
                          return_lse: bool = False, alibi_slopes=None):
    """Reference in fp32 (fp64 for fp64 inputs). q [B, Sq, H, D]; k, v
    [B, Skv, KV, D]. Key j is visible to query i iff j < kv_len and (not
    causal or j <= i). `alibi_slopes` [H] or [B, H] adds the materialised
    bias slope * (j - (kv_len - 1)) to the scaled logits. A row that sees no
    key gives 0 and LSE 0, as the TPU kernel does."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if kv_len is None:
        kv_len = skv
    acc = torch.promote_types(q.dtype, torch.float32)
    kf = k.to(acc).repeat_interleave(g, dim=2)
    vf = v.to(acc).repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kf) * d ** -0.5
    slopes = _slopes_bh("flash_attention_plain", alibi_slopes, b, h, q.device)
    if slopes is not None:
        logits = logits + _alibi_bias(slopes, skv, kv_len, acc)
    visible = _visible(sq, skv, kv_len, causal, q.device)
    logits = logits.masked_fill(~visible, float("-inf"))
    any_visible = visible.any(dim=-1)                        # [Sq]
    lse = torch.logsumexp(logits, dim=-1)                    # [B, H, Sq]
    lse = torch.where(any_visible, lse, torch.zeros_like(lse))
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if return_lse:
        return out, lse
    return out


def _delta_plain(out, do, acc):
    """δ = rowsum(dO·O) [B, H, Sq] in the dtype `acc`: the JAX `_bwd`'s
    expression, which kernel 5 forms on the card."""
    return (do.to(acc) * out.to(acc)).sum(dim=-1).transpose(1, 2)


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, causal: bool = False,
                              kv_len: int | None = None, alibi_slopes=None):
    """The explicit backward formulas of the JAX `_bwd` / `_recompute_p`, in
    fp32 (fp64 for fp64 inputs). q, do, out [B, Sq, H, D]; k, v
    [B, Skv, KV, D]; lse [B, H, Sq]. Query head h reads kv head h // G;
    dk and dv of a kv head sum over its group's G query heads. With
    `alibi_slopes` P is recomputed from the biased logits (the LSE is the
    biased forward's). Returns (dq, dk, dv) in the dtypes of q, k, v."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if kv_len is None:
        kv_len = skv
    scale = d ** -0.5
    acc = torch.promote_types(q.dtype, torch.float32)
    qf, dof = q.to(acc), do.to(acc)
    kf = k.to(acc).repeat_interleave(g, dim=2)
    vf = v.to(acc).repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    slopes = _slopes_bh("flash_attention_bwd_plain", alibi_slopes, b, h,
                        q.device)
    if slopes is not None:
        s = s + _alibi_bias(slopes, skv, kv_len, acc)
    visible = _visible(sq, skv, kv_len, causal, q.device)
    # masked slots are never exponentiated: P = 0 there even where LSE = 0
    p = torch.exp((s - lse.to(acc)[..., None]).masked_fill(~visible,
                                                           float("-inf")))
    delta = _delta_plain(out, do, acc)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, skv, kvh, g, d).sum(dim=3)
    dv = dv.reshape(b, skv, kvh, g, d).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(name: str, q, k, v, kv_len):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B,Sq,H,D], k/v [B,Skv,KV,D]")
    b, _, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"{name}: incompatible shapes {tuple(q.shape)} vs "
                         f"{tuple(k.shape)}")
    if kv_len is None:
        kv_len = skv
    if not 0 <= kv_len <= skv:
        raise ValueError(f"{name}: kv_len {kv_len} outside [0, {skv}]")
    return int(kv_len)


# head sizes of kernel 2's non-causal, unbiased form: the decoder's 64 and
# 128 (and SD3's joint attention), the diffusion UNets' 40, 80 and 160
# (SD1.5's 8 heads over 320, 640 and 1280 channels) and DiT-XL/2's 72 (1,152
# channels over 16 heads), which run on a tile of D rounded up to 64
DIFFUSION_HEAD_DIMS = (40, 64, 72, 80, 128, 160)


def _flash_forward(q, k, v, causal: bool, kv_len: int, return_lse: bool,
                   slopes=None):
    """Kernel 2 (or its plain version for CPU tensors), no autograd.
    `slopes`: None or fp32 [B, H] from `_slopes_bh`."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     return_lse=return_lse,
                                     alibi_slopes=slopes)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    plain_form = not causal and slopes is None
    _build.check_inputs("flash_attention", {"q": q, "k": k, "v": v}, d,
                        DIFFUSION_HEAD_DIMS if plain_form else (64, 128))
    out = q.new_empty(q.shape)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = _build.library()
    err = lib.lvr_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        slopes.data_ptr() if slopes is not None else None,
        b, sq, skv, h, kvh, d, kv_len, int(bool(causal)), d ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    flash_attention.alibi_launches += slopes is not None
    if return_lse:
        return out, lse
    return out


def _check_bwd_inputs(name: str, q, k, v, out, do, lse, delta):
    """`out` is checked where the kernel reads it (kernel 5), `delta` where
    it does (kernel 6)."""
    d = q.shape[3]
    tensors = {"q": q, "k": k, "v": v, "do": do}
    if out is not None:
        tensors["out"] = out
    _build.check_inputs(name, tensors, d)
    b, sq, h, _ = q.shape
    for arg, t in (("do", do), ("out", out)):
        if t is not None and t.shape != q.shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} != q "
                             f"{tuple(q.shape)}")
    for arg, t in (("lse", lse), ("delta", delta)):
        if t is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous() or t.device != q.device
                or t.data_ptr() % 16):
            raise ValueError(f"{name}: {arg} must be contiguous fp32 "
                             f"[{b}, {h}, {sq}] on {q.device}, 16-byte "
                             f"aligned")


def flash_attention_bwd_dq(q, k, v, out, lse, do, delta=None, *,
                           causal: bool = False, kv_len: int | None = None,
                           alibi_slopes=None, return_delta: bool = False):
    """Kernel 5: dq [B, Sq, H, D] from the forward's inputs, its output
    `out` and LSE, and dO; `alibi_slopes` as in the forward.

    The kernel forms δ = rowsum(dO·O) (fp32 [B, H, Sq]) from its own O and
    dO tiles and writes it into a new buffer; `return_delta=True` returns
    (dq, δ), the δ that kernel 6's wrapper takes. `delta` is accepted, so
    that both wrappers take the same arguments, and never read: on either
    device δ is formed from `out` and `do`."""
    kv_len = _check_shapes("flash_attention_bwd_dq", q, k, v, kv_len)
    slopes = _slopes_bh("flash_attention_bwd_dq", alibi_slopes, q.shape[0],
                        q.shape[2], q.device)
    if q.device.type == "cpu":
        dq = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal,
                                       kv_len=kv_len,
                                       alibi_slopes=slopes)[0]
        if not return_delta:
            return dq
        return dq, _delta_plain(out, do,
                                torch.promote_types(do.dtype, torch.float32))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dq: unsupported device "
                         f"{q.device}")
    _check_bwd_inputs("flash_attention_bwd_dq", q, k, v, out, do, lse, None)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq = q.new_empty(q.shape)
    err = _build.library().lvr_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        slopes.data_ptr() if slopes is not None else None, b, sq, skv, h, kvh,
        d, kv_len, int(bool(causal)), d ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    flash_attention_bwd_dq.alibi_launches += slopes is not None
    return (dq, delta) if return_delta else dq


def flash_attention_bwd_dkv(q, k, v, out, lse, do, delta, *,
                            causal: bool = False, kv_len: int | None = None,
                            alibi_slopes=None):
    """Kernel 6: (dk, dv) [B, Skv, KV, D], each summed over its group's query
    heads; `alibi_slopes` (per query head) as in the forward. On CUDA it
    reads `delta` [B, H, Sq] fp32 (kernel 5's, `return_delta=True`)."""
    kv_len = _check_shapes("flash_attention_bwd_dkv", q, k, v, kv_len)
    slopes = _slopes_bh("flash_attention_bwd_dkv", alibi_slopes, q.shape[0],
                        q.shape[2], q.device)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, kv_len=kv_len,
                                         alibi_slopes=slopes)[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_dkv: unsupported device "
                         f"{q.device}")
    if delta is None:
        raise ValueError("flash_attention_bwd_dkv: needs delta on CUDA (from "
                         "flash_attention_bwd_dq(..., return_delta=True))")
    _check_bwd_inputs("flash_attention_bwd_dkv", q, k, v, None, do, lse,
                      delta)
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    dk, dv = k.new_empty(k.shape), v.new_empty(v.shape)
    err = _build.library().lvr_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        slopes.data_ptr() if slopes is not None else None, b, sq, skv, h, kvh,
        d, kv_len, int(bool(causal)), d ** -0.5,
        _build.stream_handle(q.device))
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    flash_attention_bwd_dkv.alibi_launches += slopes is not None
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                        kv_len: int | None = None, alibi_slopes=None):
    """(dq, dk, dv): the plain backward for CPU tensors, else kernel 5
    (which forms δ) and kernel 6."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do,
                                         causal=causal, kv_len=kv_len,
                                         alibi_slopes=alibi_slopes)
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, do, causal=causal,
                                       kv_len=kv_len,
                                       alibi_slopes=alibi_slopes,
                                       return_delta=True)
    dk, dv = flash_attention_bwd_dkv(q, k, v, out, lse, do, delta,
                                     causal=causal, kv_len=kv_len,
                                     alibi_slopes=alibi_slopes)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: kernel 2 forward (with LSE), kernels
    5 and 6 backward. Returns (out, lse); the LSE takes no gradient, nor
    do the ALiBi slopes (None or fp32 [B, H]), which are saved for the
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kv_len: int, slopes=None):
        out, lse = _flash_forward(q, k, v, causal, kv_len, True, slopes)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.kv_len, ctx.slopes = causal, kv_len, slopes
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, d_out, _d_lse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         d_out.contiguous(),
                                         causal=ctx.causal,
                                         kv_len=ctx.kv_len,
                                         alibi_slopes=ctx.slopes)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    kv_len: int | None = None, return_lse: bool = False,
                    alibi_slopes=None):
    """q [B, Sq, H, D]; k, v [B, Skv, KV, D] with H % KV == 0. Returns
    [B, Sq, H, D] (and the fp32 natural-log LSE [B, H, Sq] if asked).
    `alibi_slopes`: optional fp32 [H] or [B, H] on the inputs' device, the
    ALiBi slope of each query head (`models.mpt.alibi_slopes`): logit (i, j)
    gains slope * (j - (kv_len - 1)), and the LSE is that of the biased
    logits (see the module docstring). Differentiable in q, k and v through
    `FlashAttention`; the slopes take no gradient."""
    kv_len = _check_shapes("flash_attention", q, k, v, kv_len)
    slopes = _slopes_bh("flash_attention", alibi_slopes, q.shape[0],
                        q.shape[2], q.device)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out, lse = FlashAttention.apply(q, k, v, bool(causal), kv_len,
                                        slopes)
        return (out, lse) if return_lse else out
    return _flash_forward(q, k, v, causal, kv_len, return_lse, slopes)


def last_block_rows() -> int:
    """The query rows a block of kernel 2's last forward launch took: 64 or
    128, as `launch_flash_fwd` chose them from the grid (0 before the first
    launch). A report of the card's launches: it builds the library."""
    return _build.library().lvr_flash_attention_block_rows()


# `launches` counts every launch of a wrapper's kernel, `alibi_launches` those
# of them that ran its ALiBi instantiation
for _wrapper in (flash_attention, flash_attention_bwd_dq,
                 flash_attention_bwd_dkv):
    _wrapper.launches = 0
    _wrapper.alibi_launches = 0
