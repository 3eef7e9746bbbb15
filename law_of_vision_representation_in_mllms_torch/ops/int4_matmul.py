"""Kernel 10: W4A16 grouped matmul, `x [M, in] bf16 @ dequant(q4, scale).T`.

Replaces the TPU kernel `ops/int4_kernel.py` `int4_matmul_kernel`
(`pl.pallas_call` body `_kernel`) of the JAX package. Source:
`csrc/int4_matmul.cu`.

What bounds it on the H100: at a decode step's M (the batch, <= 16 rows) the
packed weight is read once and used once, ~M FLOP a byte, so HBM bandwidth is
the floor (a 4096 x 4096 weight is 8.4 MB of nibbles, ~2.6 us at 3.35 TB/s;
the same weight in bf16 is four times that). At a prefill's M (B*S ~ 2,800)
it is the tensor cores' bf16 rate. The kernel reads the packed words straight
from HBM, one 16-byte load a lane, turns each pair of nibbles into two bf16
values in a register (`0x4300 | nibble` is 128 + nibble in bf16, minus 136
gives the signed code exactly) and feeds `mma.sync.m16n8k16` with fp32
accumulation; no dequantised weight is ever written anywhere. The scale
multiplies each 128-element partial dot in fp32. Two bodies share that inner
step: M <= 16 splits the contraction over the eight warps of a block that
owns 16 output channels (no shared memory but for the final sum; activations
come through L1), larger M tiles 128 x 64 outputs a block with the
activations staged in shared memory.

`int4_matmul_kernel` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises. It is differentiable in `x`
(`dx = dy @ dequant(W)`, plain PyTorch, as the JAX custom VJP is plain XLA);
the packed weight is frozen storage.
"""

from __future__ import annotations

import torch

from . import _build

TILE = 128      # contraction elements per k-tile (and per stored nibble tile)


def _groups(q4, scale):
    if q4.dim() != 2 or scale.dim() != 2 or scale.shape[1] != q4.shape[0] \
            or (q4.shape[1] * 8) % scale.shape[0]:
        raise ValueError(f"int4_matmul: q4 {tuple(q4.shape)} and scale "
                         f"{tuple(scale.shape)} do not belong together")
    return q4.shape[0], q4.shape[1] * 8, scale.shape[0]


def int4_matmul_plain(x, q4, scale):
    """The kernel's arithmetic in plain PyTorch: x rounded to bf16, exact
    integer codes, every group's partial dot summed in fp32 and multiplied
    by its fp32 scale, the sum over groups in fp32, output in `x.dtype`."""
    from .quant import _unpack_int4
    do, di, ng = _groups(q4, scale)
    xb = x.to(torch.bfloat16).float().reshape(-1, ng, di // ng)
    w = _unpack_int4(q4, torch.float32).reshape(do, ng, di // ng)
    part = torch.einsum("mGg,oGg->mGo", xb, w)
    return (part * scale.float()).sum(dim=1).to(x.dtype)


def kernel_supported(q4, scale) -> bool:
    """Shapes the CUDA kernel takes: whole 128-element k-tiles, a group size
    that is a multiple of the tile, output channels in multiples of 8."""
    if q4.dim() != 2 or scale.dim() != 2:
        return False
    do, di = q4.shape[0], q4.shape[1] * 8
    ng = scale.shape[0]
    return (di % TILE == 0 and di % ng == 0 and (di // ng) % TILE == 0
            and do % 8 == 0)


def _launch(x, q4, scale):
    do, di, ng = _groups(q4, scale)
    if not kernel_supported(q4, scale):
        raise ValueError(
            f"int4_matmul: the CUDA kernel needs a contraction dim and a "
            f"group size that {TILE} divides and output channels in "
            f"multiples of 8; got in={di}, groups={ng}, out={do}")
    if x.dtype != torch.bfloat16 or x.dim() != 2 or x.shape[1] != di:
        raise ValueError(f"int4_matmul: x must be bfloat16 [M, {di}] on "
                         f"CUDA, got {x.dtype} {tuple(x.shape)}")
    if q4.dtype != torch.int32 or scale.dtype != torch.float32:
        raise ValueError(f"int4_matmul: q4 must be int32 and scale float32, "
                         f"got {q4.dtype} and {scale.dtype}")
    for name, t in (("x", x), ("q4", q4), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: {name} is on {t.device}, not "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"int4_matmul: {name} must be contiguous and "
                             f"16-byte aligned")
    m = x.shape[0]
    out = x.new_empty((m, do))
    if m == 0:
        return out
    err = _build.library().lvr_int4_matmul(
        x.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(),
        m, di, do, ng, _build.stream_handle(x.device))
    _build.check(err, "int4_matmul")
    int4_matmul_kernel.launches += 1
    return out


class Int4Matmul(torch.autograd.Function):
    """Kernel 10 forward; `dx = dy @ dequant(W)` in plain PyTorch. The packed
    words and the scales get no gradient."""

    @staticmethod
    def forward(ctx, x, q4, scale):
        ctx.save_for_backward(q4, scale)
        return _launch(x, q4, scale)

    @staticmethod
    def backward(ctx, dy):
        from .quant import dequantize_int4
        q4, scale = ctx.saved_tensors
        w = dequantize_int4({"q4": q4, "scale": scale}, dy.dtype)
        return dy @ w, None, None


def int4_matmul_kernel(x, q4, scale):
    """x [M, in]; q4 int32 [out, in / 8] and scale fp32 [G, out] as
    `ops.quant.quantize_int4` packs them. Returns [M, out] in `x.dtype`."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return Int4Matmul.apply(x, q4, scale)
    return _launch(x, q4, scale)


int4_matmul_kernel.launches = 0
