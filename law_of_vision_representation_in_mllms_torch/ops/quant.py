"""Weight-only int8/int4 quantisation and the int8 KV cache for serving
(counterpart of the JAX package's `ops/quant.py`).

A decode step is bound by the bytes it reads: every matmul weight once, and
the visible KV cache once. Storing the weights in 8 or 4 bits with scales,
and the cache as int8 codes with one scale per (slot, head), cuts those bytes
while every product still runs on bf16 operands with fp32 sums.

Layouts. The port's `Dense` weight is [out, in] (a Flax kernel transposed),
and the quantised leaves keep that orientation:

- int8: `{"q8": int8 [out, in], "scale": fp32 [out]}`, symmetric per output
  channel, `scale = max|w| / 127`. The matmul is `(x @ q8.T) * scale`; the
  int8 -> compute-dtype cast of `q8` is a plain PyTorch op, which writes a
  converted copy of the weight at every call (the JAX package leaves this
  product to XLA, which fuses the cast; `chip_smoke.py` times what it costs
  here).
- int4: `{"q4": int32 [out, in / 8], "scale": fp32 [G, out]}`, symmetric in
  [-7, 7] with one scale per group of `group_size` contraction elements
  (128 by default, clamped to `in`). Eight 4-bit codes fill a word, stored
  offset-binary (`code + 8`). Which contraction index each nibble holds is
  `int4_k_order`: inside every tile of 128 the order is the one in which a
  warp's lanes consume B operands of `mma.m16n8k16`, so kernel 10
  (`ops/int4_matmul.py`) feeds the tensor cores from one 16-byte load a
  lane; a stored width that 128 does not divide (tiny models) is stored in
  natural order and served by the plain path only. A contraction dim that
  8 does not divide (the JAX package takes any even one) is stored with
  every group zero-padded at its end to whole tiles of 128 (zero codes),
  and `int4_matmul` pads x the same way, so kernel 10 takes such a weight
  too; `dequantize_int4(..., di=...)` drops the padding. `io/from_jax.py`
  carries a JAX `{"q4", "scale"}` leaf (rows j and j + 64 of a group sharing
  a byte) into this layout exactly: the codes and scales are the same
  numbers.

`quantize_decoder` replaces the decoder's `Dense` modules by `QuantDense`
one at a time, so the dense weight of each is freed before the next is
quantised.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from . import int4_matmul as _k10

# decoder matmul weights worth quantising (embed stays dense: it is a
# gather, not a matmul)
DECODER_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")

Leaf = Dict[str, torch.Tensor]


def quantize_int8(w) -> Leaf:
    """Symmetric per-output-channel int8 codes of a [out, in] weight."""
    wf = w.detach().float()
    amax = wf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q8": q, "scale": scale[..., 0]}


def dequantize_int8(qw: Leaf, dtype=torch.float32):
    return qw["q8"].to(dtype) * qw["scale"].to(dtype)[..., None]


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and "scale" in leaf and (
        "q8" in leaf or "q4" in leaf)


def quantize_kv(x):
    """Per-(token, head) symmetric int8 codes of a fresh K or V block
    [..., Dh] on its way into the cache: `(codes int8 [..., Dh], scale fp32
    [...])` with `scale = max|x| / 127` over the head dim (no clip: the
    largest magnitude rounds to exactly +-127)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-20) / 127.0
    codes = torch.round(xf / scale[..., None]).to(torch.int8)
    return codes, scale


def int8_matmul(x, qw: Leaf):
    """`x @ dequant(qw).T`, the per-channel scale applied after the dot."""
    y = torch.nn.functional.linear(x, qw["q8"].to(x.dtype))
    return y * qw["scale"].to(x.dtype)


@functools.lru_cache(maxsize=None)
def _k_order_cached(di: int):
    if di % _k10.TILE:
        return torch.arange(di)
    # stored nibble n = tile*128 + t*32 + j*8 + p, p = e*4 + sl*2 + half,
    # holds k = tile*128 + 16*(2j + sl) + 8*half + 2t + e: lane t of a quad
    # owns 16 bytes of a tile, word j of them feeds mma steps 2j and 2j + 1,
    # and (word >> 4*(sl*2 + half)) & 0x000F000F is the pair (e = 0, 1) that
    # step's B register `half` wants
    n = torch.arange(_k10.TILE)
    t, j, p = n // 32, n // 8 % 4, n % 8
    e, sl, half = p // 4, p // 2 % 2, p % 2
    inner = 16 * (2 * j + sl) + 8 * half + 2 * t + e
    tiles = torch.arange(di // _k10.TILE)[:, None] * _k10.TILE
    return (tiles + inner[None]).reshape(-1)


def int4_k_order(di: int, device=None):
    """Contraction index held by each stored nibble of a row, [di]."""
    return _k_order_cached(di).to(device)


def stored_width(di: int, groups: int = 1) -> int:
    """Contraction elements a row of int4 words holds for a contraction dim
    `di` in `groups` groups: `di` where 8 divides it, else every group
    zero-padded to whole tiles of 128."""
    if di % 8 == 0:
        return di
    return groups * (-(-(di // groups) // _k10.TILE) * _k10.TILE)


def pad_groups(x, groups: int, stored: int):
    """x [..., di] -> [..., stored]: each of the `groups` groups zero-padded
    at its end to `stored / groups` (x itself where the widths agree)."""
    di = x.shape[-1]
    if di == stored:
        return x
    xg = x.reshape(*x.shape[:-1], groups, di // groups)
    return torch.nn.functional.pad(
        xg, (0, (stored - di) // groups)).reshape(*x.shape[:-1], stored)


def unpad_groups(x, groups: int, di: int):
    """Inverse of `pad_groups`: [..., stored] -> [..., di]."""
    stored = x.shape[-1]
    if di == stored:
        return x
    xg = x.reshape(*x.shape[:-1], groups, stored // groups)
    return xg[..., :di // groups].reshape(*x.shape[:-1], di)


def pack_int4(codes, groups: int = 1):
    """Signed codes [..., out, in] in [-7, 7], in `groups` groups along
    `in` -> int32 [..., out, stored_width(in, groups) / 8]."""
    di = stored_width(codes.shape[-1], groups)
    codes = pad_groups(codes, groups, di)
    u = (codes.to(torch.int64) + 8)[..., int4_k_order(di, codes.device)]
    u = u.reshape(*codes.shape[:-1], di // 8, 8)
    shifts = 4 * torch.arange(8, device=codes.device)
    word = (u << shifts).sum(dim=-1)                # < 2**32, exact in int64
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _unpack_int4(packed, dtype=torch.float32):
    """int32 [..., out, in / 8] -> signed codes [..., out, in] in `dtype`.
    The nibbles are taken from an int64 copy masked to 32 bits, so no shift
    ever meets a sign bit."""
    word = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = 4 * torch.arange(8, device=packed.device)
    u = (word[..., None] >> shifts) & 0xF
    di = packed.shape[-1] * 8
    stored = (u - 8).reshape(*packed.shape[:-1], di)
    out = torch.empty_like(stored)
    out[..., int4_k_order(di, packed.device)] = stored
    return out.to(dtype)


def quantize_int4(w, group_size: Optional[int] = 128) -> Leaf:
    """Symmetric int4 codes of a [out, in] weight with one scale per group
    of `group_size` contraction elements (`None`: one per output channel).
    The range is [-7, 7]: -8 is left out so the grid is symmetric."""
    wf = w.detach().float()
    do, di = wf.shape[-2], wf.shape[-1]
    if di % 2:
        raise ValueError(f"int4 packing needs an even contraction dim, "
                         f"got {di}")
    # a group can never exceed the contraction dim (tiny models keep the
    # production default of 128)
    g = di if group_size is None else min(int(group_size), di)
    if di % g or g % 2:
        raise ValueError(f"group_size {g} must be even and divide di={di}")
    lead = wf.shape[:-2]
    wg = wf.reshape(*lead, do, di // g, g)
    amax = wg.abs().amax(dim=-1, keepdim=True)             # [..., out, G, 1]
    scale = amax.clamp_min(1e-12) / 7.0
    q = torch.round(wg / scale).clamp(-7, 7).reshape(*lead, do, di)
    return {"q4": pack_int4(q, di // g),
            "scale": scale[..., 0].transpose(-1, -2).contiguous()}


def dequantize_int4(qw: Leaf, dtype=torch.float32, di: Optional[int] = None):
    """The dense [out, in] weight the codes stand for. `di` is the
    contraction dim of a weight that 8 does not divide (its words hold
    zero-padded groups, `stored_width`); by default the stored width."""
    q, scale = qw["q4"], qw["scale"]
    do, stored = q.shape[-2], q.shape[-1] * 8
    ng = scale.shape[-2]
    w = _unpack_int4(q, dtype).reshape(*q.shape[:-2], do, ng, stored // ng)
    s = scale.transpose(-1, -2).to(dtype)[..., None]        # [..., out, G, 1]
    w = (w * s).reshape(*q.shape[:-2], do, stored)
    return w if di is None else unpad_groups(w, ng, di)


def int4_matmul(x, qw: Leaf):
    """`x @ dequant(qw).T` with the grouped scales applied after per-group
    partial dots: y = sum_G scale[G] * (x_G @ q_G.T).

    A CUDA tensor goes through kernel 10, which reads the packed words and
    unpacks them in registers (differentiable in `x`: the frozen-base
    training path); it raises on a shape the kernel does not take. A CPU
    tensor takes the formulation below in `x.dtype`, the one the JAX package
    runs wherever its TPU kernel does not: for G == 1 the int8 path's
    post-dot scaling, for G > 1 one batched dot with G as the batch dim.
    Where the words hold zero-padded groups (a contraction dim that 8 does
    not divide), x is padded with zeros the same way first."""
    q, scale = qw["q4"], qw["scale"]
    do, di = q.shape[-2], q.shape[-1] * 8
    x = pad_groups(x, scale.shape[-2], di)
    if x.device.type != "cpu":
        y = _k10.int4_matmul_kernel(x.reshape(-1, di), q, scale)
        return y.reshape(*x.shape[:-1], do)
    ng = scale.shape[-2]
    s = scale.to(x.dtype)
    w = _unpack_int4(q, x.dtype)
    if ng == 1:
        return torch.nn.functional.linear(x, w) * s[0]
    xg = x.reshape(*x.shape[:-1], ng, di // ng)
    y = torch.einsum("...Gg,oGg->...Go", xg, w.reshape(do, ng, di // ng))
    return (y * s).sum(dim=-2)


def quant_matmul(x, qw: Leaf):
    """Dispatch on the quantised-leaf format (int8 or int4)."""
    return int4_matmul(x, qw) if "q4" in qw else int8_matmul(x, qw)


def _quantizer(bits: int, group_size: Optional[int]):
    if bits == 8:
        return quantize_int8
    if bits == 4:
        return functools.partial(quantize_int4, group_size=group_size)
    raise ValueError(f"bits must be 4 or 8, got {bits}")


def _quantize_children(owner, names, qfn) -> None:
    """Replace each `Dense` child of `owner` in `names` by a `QuantDense` of
    its weight; the dense weight goes with the old module."""
    from ..models.layers import Dense, QuantDense
    for name in names:
        dense = getattr(owner, name, None)
        if isinstance(dense, Dense):
            setattr(owner, name, QuantDense(qfn(dense.weight),
                                            dense.precision))


@torch.no_grad()
def quantize_decoder(decoder, targets=DECODER_TARGETS,
                     quantize_lm_head: bool = True, bits: int = 8,
                     group_size: Optional[int] = 128):
    """Replace a `LlamaModel`'s matmul weights by quantised ones IN PLACE
    (embed and norms stay dense) and return it. One `Dense` at a time: its
    weight is quantised on its own device and dropped before the next, so
    the build never holds two copies of the decoder."""
    qfn = _quantizer(bits, group_size)
    for layer in decoder.layers:
        _quantize_children(layer, targets, qfn)
    if quantize_lm_head:
        _quantize_children(decoder, ("lm_head",), qfn)
    return decoder


@torch.no_grad()
def materialize_quantized(decoder, generator, device, *, bits: int,
                          dense_weights=None):
    """Build a `LlamaModel` constructed on the `meta` device on `device`,
    quantised as it goes: its own weights (embed, final norm), then each
    block, then `lm_head`, each allocated (`to_empty`), drawn from
    `generator` in `models.layers.init_weights`' order, given its matmul
    weights from `dense_weights` (a decoder state dict, optional) and
    quantised before the next is allocated. So the codes and scales are
    those of a dense build followed by `quantize_decoder`, and the dense
    decoder is never whole on the device: at most one block's (or
    `lm_head`'s) dense weights at a time."""
    from ..models.layers import init_weights
    qfn = _quantizer(bits, 128)

    def build(owner, names, prefix, quantized):
        for name in names:
            module = getattr(owner, name)
            module.to_empty(device=device)
            init_weights(module, generator)
            key = f"{prefix}{name}.weight"
            if name in quantized and dense_weights is not None \
                    and key in dense_weights:
                module.weight.copy_(dense_weights[key])
        _quantize_children(owner, [n for n in names if n in quantized], qfn)

    decoder.to_empty(device=device, recurse=False)
    decoder.reset_parameters(generator)
    for i, layer in enumerate(decoder.layers):
        # the block's own parameters (the norms) first, as in
        # `init_weights`' pre-order walk, then its children in order
        layer.to_empty(device=device, recurse=False)
        layer.reset_parameters(generator)
        build(layer, [n for n, _ in layer.named_children()], f"layers.{i}.",
              DECODER_TARGETS)
    build(decoder, ("lm_head",), "", ("lm_head",))


def quantized_bytes(module) -> int:
    """Resident bytes of a (possibly partially quantised) module's
    parameters and buffers."""
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))
