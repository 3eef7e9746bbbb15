"""SAM (Segment Anything), box-prompted segmentation (counterpart of the
JAX package's `models/sam.py`).

GeoAware-SC's foreground masks (`C_score/preprocess_mask_sam.py`) come
from a SamPredictor with ONE box prompt an image and one mask out: the ViT
image encoder, the box prompt encoder and the two-way mask decoder, which
is what this module holds (no point, mask or automatic-generator prompts).

The weights live in the JAX tree's layout: a linear's `w` is [in, out], the
patch embedding a [p * p * 3, D] matrix over the NHWC unfold, the neck's
3x3 conv HWIO, the transposed convs of the upscaler [kh, kw, out, in]. So a
module's state dict is the JAX tree with '.' for '/' (`io.from_jax.
sam_state_dict` / `sam_tree`) and `io.hf_port.port_sam` gives both
packages the same tree. Activations are NHWC throughout, as in the JAX
file.

SAM has no Pallas kernel in the JAX package and none here: its attention
adds the decomposed relative-position bias to the logits before an fp32
softmax (not a shape of kernel 1 or 2), written in plain PyTorch as the JAX
file writes it in `jnp`. Everything computes in fp32, as
`pipeline/sam_masks` runs it.

`postprocess_mask` upsamples the 4G x 4G logits to the model frame, crops
the padded part and resizes to the original size. `jax.image.resize`
antialiases when it shrinks, so the second resize (1,024 -> 960 in
GeoAware) is an antialiased bilinear resize here too; upsampling is plain
bilinear with half-pixel centres (`align_corners=False`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SamVisionCfg:
    image_size: int = 1024
    patch_size: int = 16
    hidden_size: int = 768               # vit-b
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class SamConfig:
    vision: SamVisionCfg = dataclasses.field(default_factory=SamVisionCfg)
    prompt_hidden: int = 256             # == out_chans
    num_pos_feats: int = 128
    decoder_heads: int = 8
    decoder_layers: int = 2
    decoder_mlp_dim: int = 2048
    iou_head_hidden: int = 256
    iou_head_depth: int = 3
    num_multimask_outputs: int = 3
    # the coordinate frame boxes are given in (SamPredictor input size)
    input_image_size: int = 1024
    # the token <-> image attentions' inner width is hidden / this (the JAX
    # file reads it off the weights)
    attention_downsample_rate: int = 2

    @property
    def embed_size(self) -> int:
        return self.vision.grid                     # 64 for vit-b/1024


def sam_vit_b() -> SamConfig:
    return SamConfig()


def sam_vit_h() -> SamConfig:
    return SamConfig(vision=SamVisionCfg(
        hidden_size=1280, num_layers=32, num_heads=16, mlp_dim=5120,
        global_attn_indexes=(7, 15, 23, 31)))


def sam_vit_l() -> SamConfig:
    return SamConfig(vision=SamVisionCfg(
        hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
        global_attn_indexes=(5, 11, 17, 23)))


# ---------------------------------------------------------------------------
# primitives (the JAX tree's leaves, fp32 storage)
# ---------------------------------------------------------------------------

def _param(*shape, device=None):
    return nn.Parameter(torch.empty(*shape, device=device),
                        requires_grad=False)


class _Linear(nn.Module):
    """y = x @ w + b, w [in, out]."""

    def __init__(self, din: int, dout: int, *, bias: bool = True,
                 device=None):
        super().__init__()
        self.w = _param(din, dout, device=device)
        self.b = _param(dout, device=device) if bias else None

    def forward(self, x):
        y = x @ self.w
        return y if self.b is None else y + self.b


class _LN(nn.Module):
    """LayerNorm over the last axis."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.w = _param(dim, device=device)
        self.b = _param(dim, device=device)

    def forward(self, x):
        m = x.mean(dim=-1, keepdim=True)
        v = x.var(dim=-1, keepdim=True, unbiased=False)
        return (x - m) * torch.rsqrt(v + self.eps) * self.w + self.b


def _gelu(x):
    return F.gelu(x)


def _rel_pos_table(rel_pos, size: int):
    """`get_rel_pos` for q_size == k_size: the (L, head_dim) table resized
    to 2 * size - 1 rows when it has another length (linear, half-pixel,
    antialiased when shrinking, as `jax.image.resize`), then gathered at
    [q - k + size - 1] -> [size, size, head_dim]."""
    max_rel = 2 * size - 1
    if rel_pos.shape[0] != max_rel:
        rel_pos = F.interpolate(
            rel_pos.t()[None, :, :, None], size=(max_rel, 1),
            mode="bilinear", align_corners=False,
            antialias=max_rel < rel_pos.shape[0])[0, :, :, 0].t()
    q = np.arange(size)[:, None]
    k = np.arange(size)[None, :]
    idx = torch.from_numpy((q - k) + size - 1).to(rel_pos.device)
    return rel_pos[idx]                            # [size, size, head_dim]


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

class _RelPosAttention(nn.Module):
    """Attention over a [B', side, side, C] block (a window or the whole
    grid) with the decomposed rel-pos bias (`modeling_sam.py`
    SamVisionAttention)."""

    def __init__(self, cfg: SamVisionCfg, side: int, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        self.qkv = _Linear(d, 3 * d, device=device)
        self.proj = _Linear(d, d, device=device)
        self.rel_pos_h = _param(2 * side - 1, hd, device=device)
        self.rel_pos_w = _param(2 * side - 1, hd, device=device)

    def forward(self, x):
        b, h, w, c = x.shape
        nh, hd = self.cfg.num_heads, self.cfg.head_dim
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(b, h * w, 3, nh, hd)
        q, k, v = qkv.unbind(dim=2)                 # [B, HW, nh, hd]
        logits = torch.einsum("bqnd,bknd->bnqk", q, k) * hd ** -0.5
        rh = _rel_pos_table(self.rel_pos_h, h)              # [h, h, hd]
        rw = _rel_pos_table(self.rel_pos_w, w)
        qg = q.reshape(b, h, w, nh, hd)
        rel_h = torch.einsum("bhwnc,hkc->bnhwk", qg, rh)
        rel_w = torch.einsum("bhwnc,wkc->bnhwk", qg, rw)
        bias = rel_h[..., :, None] + rel_w[..., None, :]   # [B,nh,h,w,h,w]
        logits = logits + bias.reshape(b, nh, h * w, h * w)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(
            b, h * w, nh * hd)
        return self.proj(out).reshape(b, h, w, c)


class _VisionLayer(nn.Module):
    """One SamVisionLayer: windowed (`window` > 0) or global rel-pos
    attention, then the MLP."""

    def __init__(self, cfg: SamVisionCfg, window: int, device=None):
        super().__init__()
        self.window = window
        d = cfg.hidden_size
        self.ln1 = _LN(d, cfg.layer_norm_eps, device)
        self.attn = _RelPosAttention(cfg, window or cfg.grid, device)
        self.ln2 = _LN(d, cfg.layer_norm_eps, device)
        self.mlp1 = _Linear(d, cfg.mlp_dim, device=device)
        self.mlp2 = _Linear(cfg.mlp_dim, d, device=device)

    def forward(self, x):
        b, h, w, c = x.shape
        win = self.window
        res = x
        x = self.ln1(x)
        if win > 0:
            pad_h = (win - h % win) % win
            pad_w = (win - w % win) % win
            xp = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            ph, pw = h + pad_h, w + pad_w
            xp = xp.reshape(b, ph // win, win, pw // win, win, c)
            xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c)
            xp = self.attn(xp)
            xp = xp.reshape(b, ph // win, pw // win, win, win, c)
            xp = xp.permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, c)
            x = xp[:, :h, :w]
        else:
            x = self.attn(x)
        x = res + x
        return x + self.mlp2(_gelu(self.mlp1(self.ln2(x))))


class SamVisionEncoder(nn.Module):
    def __init__(self, cfg: SamVisionCfg, device=None):
        super().__init__()
        self.cfg = cfg
        d, p, g, oc = cfg.hidden_size, cfg.patch_size, cfg.grid, cfg.out_chans
        self.patch_w = _param(p * p * 3, d, device=device)
        self.patch_b = _param(d, device=device)
        self.pos_embed = _param(1, g, g, d, device=device)
        self.layers = nn.ModuleList(
            _VisionLayer(cfg, 0 if i in cfg.global_attn_indexes
                         else cfg.window_size, device)
            for i in range(cfg.num_layers))
        self.neck_conv1 = _param(d, oc, device=device)
        self.neck_ln1 = _LN(oc, LN_EPS, device)
        self.neck_conv2 = _param(3, 3, oc, oc, device=device)
        self.neck_ln2 = _LN(oc, LN_EPS, device)


# ---------------------------------------------------------------------------
# prompt encoder + mask decoder
# ---------------------------------------------------------------------------

class _Prompt(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.point_embed = _param(4, c, device=device)
        self.not_a_point = _param(c, device=device)
        self.no_mask = _param(c, device=device)


class _Attention(nn.Module):
    """SamAttention: q, k, v projected to `inner` channels over `heads`."""

    def __init__(self, c: int, inner: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.q = _Linear(c, inner, device=device)
        self.k = _Linear(c, inner, device=device)
        self.v = _Linear(c, inner, device=device)
        self.out = _Linear(inner, c, device=device)

    def forward(self, q, k, v):
        qh, kh, vh = self.q(q), self.k(k), self.v(v)
        d = qh.shape[-1] // self.heads

        def split(t):
            return t.reshape(t.shape[0], -1, self.heads, d).transpose(1, 2)
        o = torch.softmax(split(qh) @ split(kh).transpose(-1, -2)
                          / math.sqrt(d), dim=-1)
        o = (o @ split(vh)).transpose(1, 2).reshape(q.shape[0], -1,
                                                    self.heads * d)
        return self.out(o)


class _TwoWayLayer(nn.Module):
    def __init__(self, cfg: SamConfig, device=None):
        super().__init__()
        c, h = cfg.prompt_hidden, cfg.decoder_heads
        inner = c // cfg.attention_downsample_rate
        self.self_attn = _Attention(c, c, h, device)
        self.t2i = _Attention(c, inner, h, device)
        self.i2t = _Attention(c, inner, h, device)
        for i in range(1, 5):
            setattr(self, f"ln{i}", _LN(c, LN_EPS, device))
        self.mlp1 = _Linear(c, cfg.decoder_mlp_dim, device=device)
        self.mlp2 = _Linear(cfg.decoder_mlp_dim, c, device=device)


class _FeedForward(nn.Module):
    """SamFeedForward: in, (depth - 2) mid layers, out; ReLU between."""

    def __init__(self, din: int, hidden: int, dout: int, depth: int,
                 device=None):
        super().__init__()
        setattr(self, "in", _Linear(din, hidden, device=device))
        self.mid = nn.ModuleList(_Linear(hidden, hidden, device=device)
                                 for _ in range(depth - 2))
        self.out = _Linear(hidden, dout, device=device)

    def forward(self, x):
        x = torch.relu(getattr(self, "in")(x))
        for lin in self.mid:
            x = torch.relu(lin(x))
        return self.out(x)


class SamMaskDecoder(nn.Module):
    def __init__(self, cfg: SamConfig, device=None):
        super().__init__()
        c = cfg.prompt_hidden
        n_mask = cfg.num_multimask_outputs + 1
        self.iou_token = _param(c, device=device)
        self.mask_tokens = _param(n_mask, c, device=device)
        self.layers = nn.ModuleList(_TwoWayLayer(cfg, device)
                                    for _ in range(cfg.decoder_layers))
        self.final_t2i = _Attention(c, c // cfg.attention_downsample_rate,
                                    cfg.decoder_heads, device)
        self.final_ln = _LN(c, LN_EPS, device)
        self.up1_w = _param(2, 2, c // 4, c, device=device)
        self.up1_b = _param(c // 4, device=device)
        self.up_ln = _LN(c // 4, LN_EPS, device)
        self.up2_w = _param(2, 2, c // 8, c // 4, device=device)
        self.up2_b = _param(c // 8, device=device)
        self.hyper = nn.ModuleList(_FeedForward(c, c, c // 8, 3, device)
                                   for _ in range(n_mask))
        self.iou_head = _FeedForward(c, cfg.iou_head_hidden, n_mask,
                                     cfg.iou_head_depth, device)


def _conv_transpose_2x2(x, w, b):
    """NHWC x through a stride-2 2x2 transposed conv whose kernel is stored
    [kh, kw, out, in] (the JAX `conv_transpose(..., transpose_kernel=
    True)` layout)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                           stride=2)
    return y.permute(0, 2, 3, 1)


class SamModel(nn.Module):
    """The encoder, prompt and decoder weights of one SAM (`pe`, `vision`,
    `prompt`, `decoder`: the JAX tree's top level)."""

    def __init__(self, cfg: SamConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.pe = _param(2, cfg.num_pos_feats, device=device)
        self.vision = SamVisionEncoder(cfg.vision, device)
        self.prompt = _Prompt(cfg.prompt_hidden, device)
        self.decoder = SamMaskDecoder(cfg, device)

    def encode_image(self, pixel_values):
        """pixel_values [B, S, S, 3] (normalized) -> [B, G, G, out_chans]
        (`modeling_sam.py` SamVisionEncoder: the patch embedding as an
        unfold and a matmul, the absolute position table, windowed layers
        but `global_attn_indexes`, the neck's 1x1 conv, LN, 3x3 conv,
        LN)."""
        v, vp = self.cfg.vision, self.vision
        b, s = pixel_values.shape[:2]
        p = v.patch_size
        g = s // p
        x = pixel_values.float().reshape(b, g, p, g, p, 3).permute(
            0, 1, 3, 2, 4, 5).reshape(b, g, g, p * p * 3)
        x = x @ vp.patch_w + vp.patch_b + vp.pos_embed
        for layer in vp.layers:
            x = layer(x)
        x = vp.neck_ln1(x @ vp.neck_conv1)
        x = F.conv2d(x.permute(0, 3, 1, 2), vp.neck_conv2.permute(
            3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
        return vp.neck_ln2(x)

    def _fourier_pe(self, coords):
        """SamPositionalEmbedding: coords in [0, 1] -> [..., 2 * feats]."""
        c = (2.0 * coords.float() - 1.0) @ self.pe
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def image_wide_pe(self):
        """SamModel.get_image_wide_positional_embeddings, channels last:
        [1, G, G, C]."""
        size = self.cfg.embed_size
        grid = np.ones((size, size), np.float32)
        y = (grid.cumsum(axis=0) - 0.5) / size
        x = (grid.cumsum(axis=1) - 0.5) / size
        coords = torch.from_numpy(np.stack([x, y], axis=-1)).to(
            self.pe.device)
        return self._fourier_pe(coords)[None]

    def embed_boxes(self, boxes):
        """SamPromptEncoder._embed_boxes: boxes [B, NB, 4] (x0, y0, x1, y1
        in the `input_image_size` frame) -> sparse embeddings
        [B, NB, 2, C]."""
        b, nb, _ = boxes.shape
        pts = (boxes.float() + 0.5).reshape(b, nb, 2, 2) \
            / self.cfg.input_image_size
        corner = self.prompt.point_embed[2:4]
        return self._fourier_pe(pts) + corner[None, None]

    def decode_masks(self, image_embeddings, sparse_embeddings,
                     multimask_output: bool = False):
        """SamMaskDecoder.forward for box prompts (the dense prompt is the
        no-mask embedding). image_embeddings [B, G, G, C].
        Returns (mask logits [B, NB, n_out, 4G, 4G], iou [B, NB, n_out])."""
        cfg, dp = self.cfg, self.decoder
        b, g, _, c = image_embeddings.shape
        nb = sparse_embeddings.shape[1]
        n_mask = cfg.num_multimask_outputs + 1

        out_tokens = torch.cat([dp.iou_token[None], dp.mask_tokens], dim=0)
        out_tokens = out_tokens[None, None].expand(b, nb, n_mask + 1, c)
        tokens = torch.cat([out_tokens, sparse_embeddings], dim=2)
        img = image_embeddings + self.prompt.no_mask
        img = img.repeat_interleave(nb, dim=0).reshape(b * nb, g * g, c)
        img_pe = self.image_wide_pe().reshape(1, g * g, c).expand(
            b * nb, g * g, c)

        queries = tokens.reshape(b * nb, -1, c)
        keys = img
        point_pe = queries
        for i, lp in enumerate(dp.layers):
            if i == 0:
                # skip_first_layer_pe: the self-attention output REPLACES
                # the queries (no residual)
                queries = lp.self_attn(queries, queries, queries)
            else:
                q = queries + point_pe
                queries = queries + lp.self_attn(q, q, queries)
            queries = lp.ln1(queries)
            q, k = queries + point_pe, keys + img_pe
            queries = lp.ln2(queries + lp.t2i(q, k, keys))
            queries = lp.ln3(queries + lp.mlp2(torch.relu(lp.mlp1(queries))))
            q, k = queries + point_pe, keys + img_pe
            keys = lp.ln4(keys + lp.i2t(k, q, queries))
        q, k = queries + point_pe, keys + img_pe
        queries = dp.final_ln(queries + dp.final_t2i(q, k, keys))

        iou_tok = queries[:, 0]
        mask_toks = queries[:, 1:1 + n_mask]
        # upscale the image embeddings 4x with two stride-2 transposed convs
        up = _conv_transpose_2x2(keys.reshape(b * nb, g, g, c), dp.up1_w,
                                 dp.up1_b)
        up = _gelu(dp.up_ln(up))
        up = _gelu(_conv_transpose_2x2(up, dp.up2_w, dp.up2_b))
        hyper = torch.stack([dp.hyper[i](mask_toks[:, i])
                             for i in range(n_mask)], dim=1)
        up_flat = up.reshape(b * nb, (4 * g) * (4 * g), -1)
        masks = (hyper @ up_flat.transpose(1, 2)).reshape(
            b, nb, n_mask, 4 * g, 4 * g)
        iou = dp.iou_head(iou_tok).reshape(b, nb, n_mask)
        sl = slice(1, None) if multimask_output else slice(0, 1)
        return masks[:, :, sl], iou[:, :, sl]


@torch.no_grad()
def segment(model: SamModel, pixel_values, boxes,
            multimask_output: bool = False):
    """Normalized pixels [B, S, S, 3] + boxes [B, NB, 4] -> (low-res mask
    logits, iou): what `sam-masks` runs an image."""
    emb = model.encode_image(pixel_values)
    return model.decode_masks(emb, model.embed_boxes(boxes),
                              multimask_output)


def mask_logits(low_res_logits, input_hw: Tuple[int, int],
                original_hw: Tuple[int, int], image_size: int = 1024):
    """SamPredictor's upscale of low-res logits [h, w] to `original_hw`
    (fp32 logits): bilinear to the image_size x image_size model frame,
    the crop to input_hw (the pre-padding size inside that frame), then a
    bilinear resize, antialiased where it shrinks."""
    m = F.interpolate(low_res_logits.float()[None, None],
                      size=(image_size, image_size), mode="bilinear",
                      align_corners=False)
    m = m[..., :input_hw[0], :input_hw[1]]
    shrink = original_hw[0] < m.shape[-2] or original_hw[1] < m.shape[-1]
    m = F.interpolate(m, size=tuple(original_hw), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return m[0, 0]


def postprocess_mask(low_res_logits, input_hw: Tuple[int, int],
                     original_hw: Tuple[int, int], image_size: int = 1024):
    """The boolean mask at `original_hw`: `mask_logits` > 0."""
    return mask_logits(low_res_logits, input_hw, original_hw,
                       image_size) > 0.0
