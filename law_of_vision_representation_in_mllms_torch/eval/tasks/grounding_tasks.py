"""RefCOCO grounding tasks (`lmms_eval/tasks/refcoco{,+,g}`).

Two protocols per split family:

- **region caption** (refcoco_bbox): the ground-truth box is drawn onto the
  image in red, the model describes the region, scored with corpus CIDEr-D
  (`refcoco/utils.py:13-78`; the reference runs the full pycocoevalcap
  scorer set — CIDEr is the headline number).
- **referring-expression comprehension** (refcoco_bbox_rec): the model
  emits normalized ``[x0, y0, x1, y1]`` coordinates for a described
  region, scored by IoU / ACC@t / center accuracy
  (`refcoco/utils_rec.py:52-185`).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

from ..task import register_function

REC_PROMPT = (
    "Bounding box coordinates are specified in the format (top-left x, "
    "top-left y, bottom-right x, bottom-right y). All values are floating "
    "point numbers bounded between 0 and 1. Please provide the bounding "
    "box coordinate of the region this sentence describes: ")

_BOX_RE = re.compile(
    r"\[\s*(-?\d+(?:\.\d+)?),\s*(-?\d+(?:\.\d+)?),"
    r"\s*(-?\d+(?:\.\d+)?),\s*(-?\d+(?:\.\d+)?)\s*\]")


@register_function("refcoco.doc_to_visual")
def refcoco_doc_to_visual(doc: Dict, image_root: str) -> List:
    """Load the image and draw the ground-truth region in red
    (`refcoco/utils.py:13-20`; bbox is COCO [x, y, w, h])."""
    if not doc.get("image"):
        return []
    from PIL import Image, ImageDraw
    with Image.open(os.path.join(image_root, doc["image"])) as im:
        img = im.convert("RGB")
    if doc.get("bbox"):
        x, y, w, h = doc["bbox"]
        ImageDraw.Draw(img).rectangle([x, y, x + w, y + h], outline="red")
    return [img]


@register_function("refcoco.doc_to_text")
def refcoco_doc_to_text(doc):
    # fixed region-caption prompt (`refcoco/utils.py:31-34`)
    return "Provide a short description for this region."


@register_function("refcoco.process_results")
def refcoco_process_results(doc, prediction, task):
    # corpus CIDEr-D at aggregation time, like the caption family
    ans = doc.get("answers", doc.get("answer"))
    refs = ans if isinstance(ans, list) else [ans]
    return {"references": [str(r) for r in refs]}


# ---- REC: referring-expression comprehension -> bbox ------------------------

def parse_box(text: str) -> List[float]:
    """First ``[x0, y0, x1, y1]`` float sequence, else the null box
    (`utils_rec.py:57-79`)."""
    m = _BOX_RE.search(text)
    return [float(m.group(i)) for i in range(1, 5)] if m \
        else [0.0, 0.0, 0.0, 0.0]


def box_iou(box1: List[float], box2: List[float]) -> float:
    """IoU of two [x0, y0, x1, y1] boxes (`utils_rec.py:96-126`)."""
    xl, yt = max(box1[0], box2[0]), max(box1[1], box2[1])
    xr, yb = min(box1[2], box2[2]), min(box1[3], box2[3])
    inter = max(0.0, xr - xl) * max(0.0, yb - yt)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def center_acc(pred: List[float], gt: List[float]) -> float:
    """1 if the predicted box's center falls inside the gt box
    (`utils_rec.py:145-161`)."""
    cx = (pred[0] + pred[2]) / 2
    cy = (pred[1] + pred[3]) / 2
    return float(gt[0] <= cx <= gt[2] and gt[1] <= cy <= gt[3])


@register_function("refcoco_rec.doc_to_text")
def refcoco_rec_doc_to_text(doc):
    # the referring expression rides in doc['answer'] (`utils_rec.py:52-54`)
    return REC_PROMPT + str(doc["answer"])


@register_function("refcoco_rec.process_results")
def refcoco_rec_process_results(doc, prediction, task):
    """Score = ACC@0.5 (the REC headline); IoU and center accuracy are
    recorded per sample for the full metric table."""
    pred = parse_box(prediction)
    gt = [float(v) for v in doc["bbox"]]  # [x0, y0, x1, y1], normalized
    iou = box_iou(pred, gt)
    return {"score": float(iou >= 0.5), "iou": iou,
            "center_acc": center_acc(pred, gt)}


def rec_metric_table(records) -> Dict[str, float]:
    """The reference's COCO_REC_METRICS table over logged samples
    (`utils_rec.py:7,164-185`)."""
    import numpy as np
    ious = np.asarray([r["iou"] for r in records], np.float64)
    table = {"IoU": float(ious.mean()) if len(ious) else 0.0}
    for t in (0.1, 0.3, 0.5, 0.7, 0.9):
        table[f"ACC@{t}"] = float((ious >= t).mean()) if len(ious) else 0.0
    cen = [r["center_acc"] for r in records]
    table["Center_ACC"] = float(np.mean(cen)) if cen else 0.0
    return table


# ---- screenspot: GUI grounding (click/box from an instruction) --------------

SCREENSPOT_REC_PROMPT = (
    "Bounding box coordinates are specified in the format (top-left x, "
    "top-left y, bottom-right x, bottom-right y). All values are floating "
    "point numbers bounded between 0 and 1 with two decimal places of "
    "precision (e.g., 0.15). Please provide the bounding box coordinates "
    "of the region that corresponds to the command: ")


@register_function("screenspot_rec.doc_to_text")
def screenspot_rec_doc_to_text(doc):
    # instruction-driven REC (`screenspot/utils_rec.py:17-18`)
    return SCREENSPOT_REC_PROMPT + str(doc["instruction"])


@register_function("screenspot_rec.process_results")
def screenspot_rec_process_results(doc, prediction, task):
    """Same box parsing/IoU table as refcoco REC
    (`screenspot/utils_rec.py:21-126` duplicates those helpers)."""
    pred = parse_box(prediction)
    gt = [float(v) for v in doc["bbox"]]
    iou = box_iou(pred, gt)
    return {"score": float(iou >= 0.5), "iou": iou,
            "center_acc": center_acc(pred, gt),
            "data_type": doc.get("data_type", "")}
