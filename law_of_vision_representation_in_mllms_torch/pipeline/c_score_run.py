"""C-score runner: per-category SPair PCK over cached features
(`C_score/pck_train.py:315-387` zero-shot path + `utils/logger.py` weighted
aggregation), optionally the two-feature concat variant
(`pck_train_two.py`); counterpart of the JAX package's
`pipeline/c_score_run.py`.

Per category: the pairs' json and `.npy` files are read on the host, the
similarity, flow and PCK run on `device` (`metrics.c_score`), and the
geo-aware subset and the weighted aggregate are numpy on the host.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..metrics import spair as S
from ..metrics.c_score import compute_pck_batch, concat_two_features


def _load_features(files: Sequence[str], feature_dir: str, suffix: str
                   ) -> np.ndarray:
    # one np.load a file; the JAX package's threaded reader
    # (`io/native_cache.batch_load`) waits in ROADMAP, queue 1: 4
    return np.stack([np.load(os.path.join(
        feature_dir,
        f"{os.path.splitext(os.path.basename(f))[0]}{suffix}.npy"))
        for f in files])


def run_c_score(spair_dir: str, feature_dir: str, *, device,
                suffix: str = "", suffix2: Optional[str] = None,
                num_patches: int, anno_size: int = 840, window: int = 5,
                categories: Optional[Sequence[str]] = None,
                subsample: Optional[int] = None,
                dataset: str = "spair",
                compute_geo: bool = True) -> Dict:
    """Returns {'per_kpt': [PCK@.1,.05,.01], 'per_img': ..., 'geo': ...,
    'categories': {...}} — `per_img` PCK@0.10 is the paper's C score
    ('corres' column); `geo` is 'geo_corres'.

    dataset: "spair" (default; paper C score) | "ap10k" | "pascal"
    (`utils_dataset.py:115-150` eval dispatch). Non-SPair datasets need
    explicit `categories` and skip the SPair geo-aware masks."""
    device = torch.device(device)
    categories = list(categories or
                      (S.SPAIR_CATEGORIES if dataset == "spair" else ()))
    if not categories:
        raise ValueError(f"dataset '{dataset}' needs explicit categories")
    if dataset != "spair":
        compute_geo = False
    per_cat = []
    details = {}
    for cat in categories:
        if dataset == "spair":
            pairs = S.load_spair_data(spair_dir, cat, size=anno_size,
                                      subsample=subsample)
        elif dataset == "ap10k":
            pairs = S.load_ap10k_data(spair_dir, cat, size=anno_size,
                                      subsample=subsample)
        elif dataset == "pascal":
            pairs = S.load_pascal_data(spair_dir, cat, size=anno_size)
        else:
            raise ValueError(dataset)
        feats = torch.from_numpy(
            _load_features(pairs.files, feature_dir, suffix)).to(device)
        if suffix2:
            feats2 = torch.from_numpy(
                _load_features(pairs.files, feature_dir, suffix2)).to(device)
            feats = concat_two_features(feats, feats2)
        batch = S.batch_pairs(pairs, feats, max_kps=pairs.kps.shape[1])
        res, _ = compute_pck_batch(
            batch["desc1"], batch["desc2"],
            *(torch.from_numpy(batch[k]).to(device)
              for k in ("kps1", "kps2", "vis", "thresholds")),
            num_patches=num_patches, anno_size=anno_size, window=window)
        rec = {"per_kpt": res.per_kpt.tolist(),
               "per_img": res.per_img.tolist(),
               "n_kpts": int(res.n_kpts),
               "n_pairs": int(len(pairs.thresholds))}
        if compute_geo:
            geo_mask = S.geo_aware_masks(pairs, cat)
            correct = res.correct.cpu().numpy()        # [A, B, K]
            gm = geo_mask & batch["vis"]
            n_geo = max(int(gm.sum()), 1)
            geo_pck = correct[:, gm].sum(axis=1) / n_geo
            rec["geo_per_kpt"] = geo_pck.tolist()
            rec["n_geo_kpts"] = int(gm.sum())
        details[cat] = rec
        per_cat.append(rec)
    agg = S.weighted_aggregate(per_cat)
    out = {"per_kpt": agg["per_kpt"].tolist(),
           "per_img": agg["per_img"].tolist(),
           "categories": details}
    if compute_geo:
        w = np.asarray([c["n_geo_kpts"] for c in per_cat], np.float64)
        v = np.stack([np.asarray(c["geo_per_kpt"]) for c in per_cat])
        out["geo"] = ((v * w[:, None]).sum(0) / max(w.sum(), 1)).tolist()
    return out
