"""SPair-71k / AP-10k / PF-Pascal data loading for the C score (a copy of
the JAX package's `metrics/spair.py`, which imports no JAX; the port keeps
its own so that it imports nothing of that package).

Host-side (numpy + json): mirrors `C_score/utils/utils_dataset.py`
(`load_spair_data` :208-276, `preprocess_kps_pad` :13-35) and the category
loop of `C_score/pck_train.py:315-387`. Keypoints are rescaled onto a square
`anno_size` canvas (aspect-preserving resize + center padding); the PCK
threshold is the max side of the target bounding box times the resize scale.

Geo-aware subset tables (keypoint symmetry groups per category) come from
`metrics/data/geoware_annotations.json` — annotation data from GeoAware-SC
("Telling Left from Right", `C_score/utils/utils_geoware.py`).

Device work (similarity, flow, PCK) is batched in `metrics/c_score.py`; this
module only shapes data: one category's pairs become fixed-shape arrays.
`load_spair_data` and `load_ap10k_data` reseed numpy's global RNG, as the
reference does, so that `subsample` draws the reference's pairs.
"""

from __future__ import annotations

import dataclasses
import json
import os
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

SPAIR_CATEGORIES = [
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "dog", "horse", "motorbike", "person", "pottedplant",
    "sheep", "train", "tvmonitor"]

_DATA = os.path.join(os.path.dirname(__file__), "data",
                     "geoware_annotations.json")


def load_geoware_tables() -> Dict:
    with open(_DATA) as f:
        return json.load(f)


def preprocess_kps_pad(kps: np.ndarray, w: int, h: int, size: int):
    """kps [K,3] (x, y, vis) -> canvas coords; returns (kps, scale)."""
    kps = kps.copy().astype(np.float64)
    scale = size / max(w, h)
    kps[:, :2] *= scale
    if h < w:
        new_h = int(np.around(size * h / w))
        kps[:, 1] += int((size - new_h) / 2)
    elif w < h:
        new_w = int(np.around(size * w / h))
        kps[:, 0] += int((size - new_w) / 2)
    kps *= kps[:, 2:3]  # zero out invisible
    return kps, scale


@dataclasses.dataclass
class SPairPairs:
    """One category's pairs, canvas-space."""
    files: List[str]              # 2N paths (src, trg interleaved)
    kps: np.ndarray               # [2N, K, 3]
    thresholds: np.ndarray        # [N]
    used_kps: np.ndarray          # original keypoint indices kept


def load_spair_data(path: str, category: str, split: str = "test",
                    size: int = 840, subsample: Optional[int] = None,
                    seed: int = 42) -> SPairPairs:
    np.random.seed(seed)
    pairs = sorted(glob(f"{path}/PairAnnotation/{split}/*:{category}.json"))
    if subsample:
        pairs = [pairs[i] for i in np.random.choice(len(pairs), subsample)]
    cat_files = sorted(glob(f"{path}/ImageAnnotation/{category}/*.json"))
    with open(cat_files[0]) as f:
        num_kps = len(json.load(f)["kps"])

    files, kps, thresholds = [], [], []
    for pair in pairs:
        with open(pair) as f:
            data = json.load(f)
        assert data["category"] == category
        entries = []
        for side in ("src", "trg"):
            fn = f'{path}/JPEGImages/{category}/{data[side + "_imname"]}'
            anno = fn.replace("JPEGImages", "ImageAnnotation"
                              ).replace("jpg", "json")
            with open(anno) as f:
                kp_raw = json.load(f)["kps"]
            arr = np.zeros((num_kps, 3))
            for i in range(num_kps):
                pt = kp_raw.get(str(i))
                if pt is not None:
                    arr[i, :2] = pt
                    arr[i, 2] = 1
            w, h = data[side + "_imsize"][:2]
            arr, scale = preprocess_kps_pad(arr, w, h, size)
            entries.append((fn, arr, scale))
        (sfn, skps, _), (tfn, tkps, tscale) = entries
        bbox = np.asarray(data["trg_bndbox"])
        thresholds.append(max(bbox[3] - bbox[1], bbox[2] - bbox[0]) * tscale)
        files += [sfn, tfn]
        kps += [skps, tkps]

    kps = np.stack(kps)                                      # [2N, K, 3]
    used = np.where(kps[:, :, 2].any(axis=0))[0]
    return SPairPairs(files=files, kps=kps[:, used],
                      thresholds=np.asarray(thresholds, np.float32),
                      used_kps=used)


def geo_aware_masks(pairs: SPairPairs, category: str,
                    tables: Optional[Dict] = None) -> np.ndarray:
    """[N, K] mask of geo-aware keypoints per pair (`pck_train.py:68-94,
    169-186`): a used keypoint is geo-aware for a pair when it is mutually
    visible and belongs to a symmetry group with >=2 members visible in the
    target image."""
    tables = tables or load_geoware_tables()
    groups_raw = tables["SPAIR_GEO_AWARE"].get(category)
    if groups_raw is None:
        return np.zeros((len(pairs.thresholds), pairs.kps.shape[1]), bool)
    used = list(pairs.used_kps)
    groups = []
    for item in groups_raw:
        item = [item] if isinstance(item, int) else item
        kept = [used.index(i) for i in item if i in used]
        if kept:
            groups.append(kept)

    n = len(pairs.thresholds)
    out = np.zeros((n, pairs.kps.shape[1]), bool)
    for p in range(n):
        vis = (pairs.kps[2 * p, :, 2] * pairs.kps[2 * p + 1, :, 2]) > 0
        vis2 = pairs.kps[2 * p + 1, :, 2] > 0
        for grp in groups:
            both = [i for i in grp if vis[i]]
            tgt = [i for i in grp if vis2[i]]
            if len(tgt) >= 2 and len(both) >= 1:
                out[p, both] = True
    return out


def batch_pairs(pairs: SPairPairs, feats: np.ndarray, max_kps: int):
    """Assemble fixed-shape arrays for `compute_pck_batch`.

    feats: [2N, P, C] descriptors aligned with pairs.files order.
    Returns dict of numpy arrays (desc1, desc2, kps1, kps2, vis, thresholds).
    """
    n = len(pairs.thresholds)
    k = pairs.kps.shape[1]
    pad_k = max(max_kps, k)
    kps1 = np.zeros((n, pad_k, 2), np.float32)
    kps2 = np.zeros((n, pad_k, 2), np.float32)
    vis = np.zeros((n, pad_k), bool)
    for p in range(n):
        s, t = pairs.kps[2 * p], pairs.kps[2 * p + 1]
        v = (s[:, 2] * t[:, 2]) > 0
        kps1[p, :k] = s[:, :2]
        kps2[p, :k] = t[:, :2]
        vis[p, :k] = v
    return {
        "desc1": feats[0::2], "desc2": feats[1::2],
        "kps1": kps1, "kps2": kps2, "vis": vis,
        "thresholds": pairs.thresholds,
    }


def weighted_aggregate(per_cat: Sequence[Dict]) -> Dict:
    """Weighted PCK across categories (`C_score/utils/logger.py:61-110`):
    keypoint-level PCK weighted by keypoint counts, image-level by pair
    counts."""
    out = {}
    for level, wkey in (("per_kpt", "n_kpts"), ("per_img", "n_pairs")):
        w = np.asarray([c[wkey] for c in per_cat], np.float64)
        v = np.stack([np.asarray(c[level]) for c in per_cat])
        out[level] = (v * w[:, None]).sum(0) / max(w.sum(), 1)
    return out


def load_ap10k_data(path: str, category: str, split: str = "test",
                    size: int = 840, subsample: Optional[int] = 20,
                    seed: int = 42) -> SPairPairs:
    """AP-10k pair loader (`utils_dataset.py:151-207`): per-pair json with
    src/trg annotation paths; keypoint visibility halved (2 -> 1); PCK
    threshold = max(bbox w, h) * scale (bbox is l,t,w,h)."""
    np.random.seed(seed)
    pairs = sorted(glob(f"{path}/PairAnnotation/{split}/*:{category}.json"))
    if subsample:
        pairs = [pairs[i] for i in np.random.choice(len(pairs), subsample)]
    files, kps, thresholds = [], [], []
    for pair in pairs:
        with open(pair) as f:
            data = json.load(f)
        for side in ("src", "trg"):
            anno_path = data[f"{side}_json_path"]
            with open(anno_path) as f:
                anno = json.load(f)
            arr = np.asarray(anno["keypoints"], np.float64).reshape(-1, 3)
            arr[:, 2] /= 2.0
            arr, scale = preprocess_kps_pad(arr, anno["width"],
                                            anno["height"], size)
            kps.append(arr)
            files.append(anno_path.replace("json", "jpg")
                         .replace("ImageAnnotation", "JPEGImages"))
            if side == "trg":
                bbox = np.asarray(anno["bbox"])      # l, t, w, h
                thresholds.append(max(bbox[3], bbox[2]) * scale)
    kps = np.stack(kps)
    used = np.where(kps[:, :, 2].any(axis=0))[0]
    return SPairPairs(files=files, kps=kps[:, used],
                      thresholds=np.asarray(thresholds, np.float32),
                      used_kps=used)


def load_pascal_data(path: str, category: str, split: str = "test",
                     size: int = 256) -> SPairPairs:
    """PF-Pascal pair loader (`utils_dataset.py:304-371`): CSV pair list
    with ';'-separated keypoint coords, up to 20 kps, no bbox thresholds
    (PCK threshold = image size, alphas (0.10, 0.05, 0.15))."""
    import csv as _csv

    classes = ["aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor"]
    cat_id = classes.index(category) + 1
    files, kps = [], []
    with open(f"{path}/{split}_pairs_pf_pascal.csv") as f:
        rows = list(_csv.reader(f))
    header, rows = rows[0], rows[1:]
    for row in rows:
        if int(row[2]) != cat_id:
            continue
        src_fn = f"{path}/../{row[0]}"
        trg_fn = f"{path}/../{row[1]}"
        from PIL import Image
        for fn, (xs, ys) in ((src_fn, (row[3], row[4])),
                             (trg_fn, (row[5], row[6]))):
            x = np.fromstring(xs, sep=";")
            y = np.fromstring(ys, sep=";")
            arr = np.zeros((20, 3))
            arr[:len(x), 0] = x
            arr[:len(x), 1] = y
            arr[:len(x), 2] = 1
            w, h = Image.open(fn).size
            arr, _ = preprocess_kps_pad(arr, w, h, size)
            kps.append(arr)
            files.append(fn)
    kps = np.stack(kps)
    used = np.where(kps[:, :, 2].any(axis=0))[0]
    n_pairs = len(files) // 2
    return SPairPairs(files=files, kps=kps[:, used],
                      thresholds=np.full(n_pairs, float(size), np.float32),
                      used_kps=used)
