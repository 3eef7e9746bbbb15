"""Kernel 10: W4A16 grouped matmul, `x [M, in] bf16 @ dequant(q4, scale).T`,
and its transposed form for the input gradient, `dy @ dequant(q4, scale)`.

Replaces the TPU kernel `ops/int4_kernel.py` `int4_matmul_kernel`
(`pl.pallas_call` body `_kernel`) of the JAX package, and the XLA product of
its custom VJP (`ops/quant.py` `_int4_kernel_mm_bwd`). Source:
`csrc/int4_matmul.cu` (PTX helpers in `csrc/hopper_common.cuh`).

What bounds it on the H100: at a decode step's M (the batch, <= 16 rows) the
packed weight is read once and used once, ~M FLOP a byte, so HBM bandwidth is
the floor (a 4096 x 4096 weight is 8.4 MB of nibbles, ~2.6 us at 3.35 TB/s;
the same weight in bf16 is four times that). At a prefill's or a training
step's M (B*S ~ 2,800 to 11,000) it is the tensor cores' bf16 rate. Nibbles
become bf16 without a convert (`0x4300 | nibble` is 128 + nibble in bf16,
minus 136 gives the signed code exactly); no dequantised weight is ever
written to device memory. Two bodies:

- M <= 16 (a decode step): the same swapped product, out^T = W x^T, on
  `mma.sync.m16n8k16` with x^T as B (no padded row of x enters a product),
  fed by a TMA ring of stages of two k-tiles a block of 128 channels (their
  words, x's M rows, the scales), each stage issued once the one before
  has landed; the k-tiles of a channel tile are split over a thread-block
  cluster of up to 8 blocks, chosen from N, K, the SM count and what fits
  on the card at once (`last_small_split` reads the choice back), whose
  partials meet in distributed shared memory in a fixed order; launched
  with programmatic dependent launch: a block copies its first words and
  scales before the launch it follows has finished, and x after;
- M > 16: a block owns 128 channels x 128 rows of x. One thread copies x, the
  packed words and the scales of each 128-deep stage by TMA into a ring of
  five; two warpgroups compute out^T = W x^T with `wgmma.mma_async`, the
  weight as the A operand in registers (each lane turns its channels' words
  into bf16 fragments: the stored order is the fragment order), x as B from
  shared memory, taking turns so that one scales and dequantises while the
  other's products run.

Both multiply each group's fp32 partial dot by its fp32 scale. The transposed
form (`int4_matmul_dx`, dx = dy @ W) needs W as wgmma's B, which is read from
shared memory only: two producer warpgroups form bf16(code * bf16(scale))
there, K contiguous (wgmma's transposed B), bit-equal to
`dequantize_int4(..., bfloat16)`, from words and scales that TMA brings with
dy.

`int4_matmul_kernel` and `int4_matmul_dx` take the plain version only for CPU
tensors; for CUDA tensors they launch the kernel or raise. Kernel 10 is
differentiable in `x` (`Int4Matmul`, whose backward is `int4_matmul_dx`); the
packed weight is frozen storage.
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


def int4_matmul_dx_plain(dy, q4, scale):
    """The input gradient of `x @ dequant(W).T`: `dy [M, out] @ W [out, in]`
    with W dequantised in `dy.dtype` (the JAX custom VJP's formula)."""
    from .quant import dequantize_int4
    return dy @ dequantize_int4({"q4": q4, "scale": scale}, dy.dtype)


def kernel_supported(q4, scale) -> bool:
    """Shapes the CUDA kernels take: whole 128-element k-tiles, a group size
    that is a multiple of the tile, output channels in multiples of 8."""
    if q4.dim() != 2 or scale.dim() != 2:
        return False
    do, di = q4.shape[0], q4.shape[1] * 8
    ng = scale.shape[0]
    return (di % TILE == 0 and di % ng == 0 and (di // ng) % TILE == 0
            and do % 8 == 0)


def _launch(fn_name, counter, a, width, out_width, q4, scale):
    """Checks shared by both entry points, then one launch of `fn_name` on
    `a [M, width]` into a new `[M, out_width]` tensor."""
    name = counter.__name__
    do, di, ng = _groups(q4, scale)
    if not kernel_supported(q4, scale):
        raise ValueError(
            f"{name}: the CUDA kernel needs a contraction dim and a group "
            f"size that {TILE} divides and output channels in multiples of "
            f"8; got in={di}, groups={ng}, out={do}")
    if a.dtype != torch.bfloat16 or a.dim() != 2 or a.shape[1] != width:
        raise ValueError(f"{name}: the activations must be bfloat16 [M, "
                         f"{width}] on CUDA, got {a.dtype} {tuple(a.shape)}")
    if q4.dtype != torch.int32 or scale.dtype != torch.float32:
        raise ValueError(f"{name}: q4 must be int32 and scale float32, "
                         f"got {q4.dtype} and {scale.dtype}")
    for arg, t in (("activations", a), ("q4", q4), ("scale", scale)):
        if t.device != a.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not "
                             f"{a.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte "
                             f"aligned")
    m = a.shape[0]
    out = a.new_empty((m, out_width))
    if m == 0:
        return out
    err = getattr(_build.library(), fn_name)(
        a.data_ptr(), q4.data_ptr(), scale.data_ptr(), out.data_ptr(), m, di,
        do, ng, _build.stream_handle(a.device))
    _build.check(err, name)
    counter.launches += 1
    return out


class Int4Matmul(torch.autograd.Function):
    """Kernel 10 forward, its transposed form backward. The packed words and
    the scales get no gradient."""

    @staticmethod
    def forward(ctx, x, q4, scale):
        ctx.save_for_backward(q4, scale)
        return _forward(x, q4, scale)

    @staticmethod
    def backward(ctx, dy):
        q4, scale = ctx.saved_tensors
        return int4_matmul_dx(dy.contiguous(), q4, scale), None, None


def _forward(x, q4, scale):
    do, di, _ = _groups(q4, scale)
    return _launch("lvr_int4_matmul", int4_matmul_kernel, x, di, do, q4,
                   scale)


def int4_matmul_kernel(x, q4, scale):
    """x [M, in]; q4 int32 [out, in / 8] and scale fp32 [G, out] as
    `ops.quant.quantize_int4` packs them. Returns [M, out] in `x.dtype`."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return Int4Matmul.apply(x, q4, scale)
    return _forward(x, q4, scale)


def int4_matmul_dx(dy, q4, scale):
    """dy [M, out] @ dequant(q4, scale) [out, in] -> [M, in] in `dy.dtype`:
    kernel 10's input gradient. A CUDA tensor runs the transposed kernel
    (bf16 only) or raises."""
    if dy.device.type == "cpu":
        return int4_matmul_dx_plain(dy, q4, scale)
    if dy.device.type != "cuda":
        raise ValueError(f"int4_matmul_dx: unsupported device {dy.device}")
    do, di, _ = _groups(q4, scale)
    return _launch("lvr_int4_matmul_dx", int4_matmul_dx, dy, do, di, q4,
                   scale)


def last_small_split() -> int:
    """The blocks (one thread-block cluster) that the last M <= 16 launch of
    `int4_matmul_kernel` split each channel tile's contraction over, as the
    launcher chose them from N, K and the SM count (0 before the first). A
    report of the card's launches: it builds the library."""
    return _build.library().lvr_int4_matmul_small_split()


int4_matmul_kernel.launches = 0
int4_matmul_dx.launches = 0
