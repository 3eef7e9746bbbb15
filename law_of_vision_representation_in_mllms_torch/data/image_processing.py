"""Host-side image preprocessing per tower.

Replaces the HF image processors the reference instantiates per tower plus
its `DiffImageProcessor` (`diffusion_encoder.py:30-41`) and the
`expand2square` mean-padding used in training (`train.py:708-721`,
`--image_aspect_ratio pad`). Output: NHWC float32 numpy, ready for
device upload.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class ImageProcessorConfig:
    mode: str                       # "clip" | "diff"
    size: int = 224                 # shortest-edge (clip) / square (diff)
    crop: int = 224
    mean: Tuple[float, float, float] = CLIP_MEAN
    std: Tuple[float, float, float] = CLIP_STD


def processor_for_tower(name: str, img_size: Optional[int] = None
                        ) -> ImageProcessorConfig:
    if name == "debug/tiny-vit":
        return ImageProcessorConfig("clip", size=28, crop=28)
    if name.startswith("openai/clip") or name.startswith("laion/"):
        s = 336 if "336" in name else 224
        return ImageProcessorConfig("clip", size=s, crop=s)
    if "siglip" in name:
        return ImageProcessorConfig("clip", size=224, crop=224,
                                    mean=SIGLIP_MEAN, std=SIGLIP_STD)
    if "dinov2" in name:
        s = 336 if name.endswith("-336") else 224
        return ImageProcessorConfig("clip", size=max(s, 256) if s == 224
                                    else s, crop=s, mean=IMAGENET_MEAN,
                                    std=IMAGENET_STD)
    # diffusion towers: plain resize + [-1, 1]
    return ImageProcessorConfig("diff", size=img_size or 768,
                                crop=img_size or 768)


def expand2square(img, background: Tuple[int, int, int]):
    """Pad a PIL image to a square with the given background color
    (`train.py:708-718`)."""
    from PIL import Image
    w, h = img.size
    if w == h:
        return img
    s = max(w, h)
    canvas = Image.new(img.mode, (s, s), background)
    canvas.paste(img, ((s - w) // 2, (s - h) // 2))
    return canvas


def preprocess_image(img, cfg: ImageProcessorConfig, *,
                     pad_square: bool = False) -> np.ndarray:
    """PIL image -> HWC float32."""
    from PIL import Image
    img = img.convert("RGB")
    if pad_square:
        bg = tuple(int(255 * m) for m in cfg.mean)
        img = expand2square(img, bg)
    if cfg.mode == "diff":
        img = img.resize((cfg.size, cfg.size))
        x = np.asarray(img, np.float32) / 255.0
        return (x - 0.5) * 2.0
    # clip-style: bicubic shortest-edge resize then center crop
    w, h = img.size
    scale = cfg.size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    img = img.resize((nw, nh), Image.Resampling.BICUBIC)
    left = (nw - cfg.crop) // 2
    top = (nh - cfg.crop) // 2
    img = img.crop((left, top, left + cfg.crop, top + cfg.crop))
    x = np.asarray(img, np.float32) / 255.0
    return (x - np.asarray(cfg.mean, np.float32)) / np.asarray(
        cfg.std, np.float32)
