"""Kernel 9: masked mean-of-row-max cosine similarity, the A score's hot op.

Replaces the TPU kernel `ops/a_score_pallas.py` `max_cos_pallas`
(`pl.pallas_call` body `_kernel`) of the JAX package, and takes the validity
masks of `metrics/a_score.py` `max_cos_similarity`, which that kernel lacks
(so the JAX runner never reaches it). Source: `csrc/a_score.cu`.

Per image n, target [N, St, D] against anchor [N, Sa, D], fp32 math:

    out[n] = sum over valid t of  max over valid a of
             <t, a> / ((|t| + 1e-10) (|a| + 1e-10))   /  max(#valid t, 1)

What bounds it on the H100: at the protocol shape (N = 100, St = Sa = 576,
D = 4096, fp32) a call is 272 GFLOP over 1.89 GB of inputs, so operations,
not HBM (~0.56 ms), set the floor: ~4.1 ms at the 67 TFLOP/s of plain fp32
FMAs, 1.65 ms for the three TF32 tensor-core products of an fp32-accurate
product (495 TFLOP/s). No body writes the [St, Sa] matrix, the norms or a
normalised or split copy to global memory; per-block partials are reduced
in a fixed order, so a call is bitwise repeatable.

Two hand-written bodies, chosen by `a_score_body` from dtype and shape alone
(both count in `max_cos.launches`; the first also in
`max_cos.wgmma_launches`):

- "wgmma": fp32 inputs with D % 4 == 0 and both bases 16-byte aligned (what
  TMA takes). 3xTF32 `wgmma` fed by TMA: each operand split as hi + lo in
  TF32, three products a k8 step (hi lo + lo hi + hi hi); a block computes
  one [128 target, 128 anchor] tile of an image with the norms on chip and
  writes its row maxima to a [N, ceil(Sa / 128), St] scratch, which a
  second kernel reduces.
- "simt": bf16 and fp16 inputs, and fp32 that TMA cannot take (D % 4 != 0
  or a misaligned base). fp32 FMAs, a 64 x 64 tile of dot products in
  registers a block.

`max_cos` takes the plain version only for CPU tensors; for CUDA tensors it
launches its body or raises.
"""

from __future__ import annotations

import torch

from . import _build

EPS = 1e-10
SIMT_TILE = 64     # target rows a block of the SIMT body (csrc kTile)
TF32_TILE = 128    # anchor rows a block of the wgmma body (csrc kCols)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def a_score_plain(target, anchor, target_mask=None, anchor_mask=None):
    """The same function in plain PyTorch, fp32: [N, St, D], [N, Sa, D] and
    optional bool [N, St], [N, Sa] -> [N] fp32. A row whose anchors are all
    masked gives -inf."""
    t = target.float()
    a = anchor.float()
    dot = torch.einsum("ntd,nad->nta", t, a)
    tn = torch.linalg.vector_norm(t, dim=-1) + EPS
    an = torch.linalg.vector_norm(a, dim=-1) + EPS
    cos = dot / (tn[:, :, None] * an[:, None, :])
    if anchor_mask is not None:
        cos = cos.masked_fill(~anchor_mask[:, None, :], float("-inf"))
    row_max = cos.amax(dim=-1)
    if target_mask is None:
        return row_max.mean(dim=-1)
    row_max = torch.where(target_mask, row_max, torch.zeros_like(row_max))
    return row_max.sum(dim=-1) / target_mask.sum(dim=-1).clamp_min(1)


def a_score_body(dtype, d: int, target_ptr: int, anchor_ptr: int) -> str:
    """Which body `max_cos` launches for inputs of `dtype` with row width
    `d` at these base addresses: "wgmma" for fp32 with d % 4 == 0 and both
    bases 16-byte aligned, else "simt"."""
    if dtype == torch.float32 and d % 4 == 0 \
            and target_ptr % 16 == 0 and anchor_ptr % 16 == 0:
        return "wgmma"
    return "simt"


def _check_mask(name: str, mask, n: int, s: int, device):
    if mask is None:
        return None
    if mask.dtype != torch.bool or tuple(mask.shape) != (n, s):
        raise ValueError(f"max_cos: {name} must be bool [{n}, {s}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if mask.device != device:
        raise ValueError(f"max_cos: {name} is on {mask.device}, not {device}")
    return mask.contiguous()


def max_cos(target, anchor, target_mask=None, anchor_mask=None):
    """target [N, St, D], anchor [N, Sa, D] (fp32, bf16 or fp16, the same
    dtype), optional bool validity masks [N, St] and [N, Sa]. Returns [N]
    fp32: per image, the mean over valid target rows of the max cosine over
    valid anchor rows."""
    if target.dim() != 3 or anchor.dim() != 3 \
            or target.shape[0] != anchor.shape[0] \
            or target.shape[2] != anchor.shape[2]:
        raise ValueError(f"max_cos: target [N, St, D] and anchor [N, Sa, D] "
                         f"expected, got {tuple(target.shape)} and "
                         f"{tuple(anchor.shape)}")
    n, st, d = target.shape
    sa = anchor.shape[1]
    if min(n, st, sa, d) < 1:
        raise ValueError(f"max_cos: empty input {tuple(target.shape)}, "
                         f"{tuple(anchor.shape)}")
    if anchor.device != target.device:
        raise ValueError(f"max_cos: anchor is on {anchor.device}, target on "
                         f"{target.device}")
    target_mask = _check_mask("target_mask", target_mask, n, st, target.device)
    anchor_mask = _check_mask("anchor_mask", anchor_mask, n, sa, target.device)
    _build.forbid_grad("max_cos", target, anchor)
    if target.device.type == "cpu":
        return a_score_plain(target, anchor, target_mask, anchor_mask)
    if target.device.type != "cuda":
        raise ValueError(f"max_cos: unsupported device {target.device}")
    if target.dtype not in _DTYPE_CODES or anchor.dtype != target.dtype:
        raise ValueError(f"max_cos: target and anchor must share one of "
                         f"fp32, bf16, fp16; got {target.dtype} and "
                         f"{anchor.dtype}")
    if not (target.is_contiguous() and anchor.is_contiguous()):
        raise ValueError("max_cos: target and anchor must be contiguous")
    if n > 65535:
        raise ValueError(f"max_cos: at most 65535 images a call, got {n}")
    body = a_score_body(target.dtype, d, target.data_ptr(),
                        anchor.data_ptr())
    out = torch.empty((n,), dtype=torch.float32, device=target.device)
    masks = (target_mask.data_ptr() if target_mask is not None else None,
             anchor_mask.data_ptr() if anchor_mask is not None else None)
    lib, stream = _build.library(), _build.stream_handle(target.device)
    if body == "wgmma":
        row_max = torch.empty((n, -(-sa // TF32_TILE), st),
                              dtype=torch.float32, device=target.device)
        err = lib.lvr_a_score_tf32(
            target.data_ptr(), anchor.data_ptr(), *masks, row_max.data_ptr(),
            out.data_ptr(), n, st, sa, d, stream)
    else:
        partial = torch.empty((2, n, -(-st // SIMT_TILE)),
                              dtype=torch.float32, device=target.device)
        vec_bytes = 4 * target.element_size()
        vec = int(d % 4 == 0 and target.data_ptr() % vec_bytes == 0
                  and anchor.data_ptr() % vec_bytes == 0)
        err = lib.lvr_a_score(
            target.data_ptr(), anchor.data_ptr(), *masks,
            partial[0].data_ptr(), partial[1].data_ptr(), out.data_ptr(),
            n, st, sa, d, _DTYPE_CODES[target.dtype], vec, stream)
    _build.check(err, "max_cos")
    max_cos.launches += 1
    if body == "wgmma":
        max_cos.wgmma_launches += 1
    return out


max_cos.launches = 0
max_cos.wgmma_launches = 0
