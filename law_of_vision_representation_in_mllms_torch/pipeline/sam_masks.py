"""GeoAware-SC foreground masks with the port's SAM (counterpart of the JAX
package's `pipeline/sam_masks.py`).

The reference's `C_score/preprocess_mask_sam.py:1-78` walks a dataset
directory, square-pads every image to ANNO_SIZE = 960, box-prompts a
SamPredictor with the annotation's box and writes `{name}_mask.png` and
its mirror `{name}_mask_flip.png` into a parallel `features/` tree: the
files `pipeline/geoware` (`--mask-dir`) and the flip evaluation read. Here
the SAM is `models.sam.SamModel` on the model's device (plain PyTorch:
SAM has no Pallas kernel to port), in fp32 as the JAX pipeline runs it.
`sam-masks` is the CLI.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from ..models import sam as S
from .geoware import load_square

# SamProcessor's normalization (ImageNet mean / std in 0-255 units), what
# SamPredictor.set_image applies before the encoder
_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
_STD = np.array([58.395, 57.12, 57.375], np.float32)


def pad_box(box_xyxy, orig_wh: Tuple[int, int], target: int):
    """`preprocess_kps_pad` for a corner box: scale by target / max(w, h),
    shift by the centring offset of `geoware.load_square`."""
    w, h = orig_wh
    scale = target / max(w, h)
    b = np.asarray(box_xyxy, np.float32) * scale
    if h < w:
        b[[1, 3]] += (target - int(np.around(target * h / w))) // 2
    elif w < h:
        b[[0, 2]] += (target - int(np.around(target * w / h))) // 2
    return b


def segment_box(model: S.SamModel, canvas: np.ndarray, box: np.ndarray):
    """The box-prompted mask logits of one square uint8 image
    (SamPredictor's predict(box=..., multimask_output=False) before its
    > 0): [anno, anno] fp32 numpy."""
    from PIL import Image
    cfg = model.cfg
    dev = model.pe.device
    anno = canvas.shape[0]
    size = cfg.vision.image_size
    img = Image.fromarray(canvas).resize((size, size), Image.BILINEAR)
    px = (np.asarray(img, np.float32) - _MEAN) / _STD
    bx = box * (cfg.input_image_size / anno)
    masks, _iou = S.segment(model, torch.from_numpy(px[None]).to(dev),
                            torch.from_numpy(bx[None, None]).to(dev),
                            multimask_output=False)
    return S.mask_logits(masks[0, 0, 0], input_hw=(size, size),
                         original_hw=(anno, anno),
                         image_size=size).cpu().numpy()


def run_sam_masks(model: S.SamModel, base_dir: str, *, anno_size: int = 960,
                  spair: bool = False, limit: int | None = None) -> int:
    """Walk `base_dir` for .jpg files (the `preprocess_mask_sam.py` loop),
    writing {features}/{name}_mask.png and _mask_flip.png (the path with
    JPEGImages -> features). An image's box is its annotation json's
    (JPEGImages -> ImageAnnotation): SPair's corner `bndbox` with `spair`,
    else an x, y, w, h `bbox`. Returns the count."""
    from PIL import Image

    files = sorted(
        os.path.join(sub, f) for sub, _dirs, fs in os.walk(base_dir)
        for f in fs if f.endswith(".jpg"))
    if limit:
        files = files[:limit]
    n = 0
    for path in files:
        pil = Image.open(path).convert("RGB")
        w, h = pil.size
        canvas = load_square(pil, anno_size)
        jpath = path.replace(".jpg", ".json").replace("JPEGImages",
                                                      "ImageAnnotation")
        with open(jpath) as f:
            data = json.load(f)
        box = np.asarray(data["bndbox" if spair else "bbox"], np.float32)
        if not spair:
            box[2:] += box[:2]                     # xywh -> xyxy
        box = pad_box(box, (w, h), anno_size)
        mask = segment_box(model, canvas, box) > 0.0

        out_dir = os.path.dirname(path).replace("JPEGImages", "features")
        os.makedirs(out_dir, exist_ok=True)
        base = os.path.splitext(os.path.basename(path))[0]
        arr = (np.clip(mask, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(out_dir,
                                               f"{base}_mask.png"))
        Image.fromarray(arr[:, ::-1]).save(
            os.path.join(out_dir, f"{base}_mask_flip.png"))
        n += 1
    return n
