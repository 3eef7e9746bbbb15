"""A-score runner: the `A_score/compute.py` loop over dumped embeddings
(counterpart of the JAX package's `pipeline/a_score_run.py`).

Directory protocol matches the reference (`run_embed_extract.sh:28-35` +
`A_score/compute.py:7-31`): `<base>/<rep>/tensor_{1..N}.npy` per benchmark,
anchors 'clip336' and 'clip224'. The two anchors are loaded, padded and moved
to the device once and reused for every rep; each rep is two launches of
kernel 9 (one per anchor).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..metrics.a_score import a_score, pad_stack


def _load_dir(path: str, n: int = 100) -> Optional[List[np.ndarray]]:
    out = []
    for i in range(1, n + 1):
        p = os.path.join(path, f"tensor_{i}.npy")
        if not os.path.exists(p):
            return None
        out.append(np.load(p))
    return out


def compute_a_scores(base_folder: str, reps: Sequence[str], *,
                     anchors=("clip336", "clip224"), n_images: int = 100,
                     device) -> Dict[str, float]:
    """{rep: A score} for every rep whose `n_images` files exist under
    `base_folder` (a rep with a missing file is skipped; a missing anchor
    raises). `device` is explicit: "cuda" runs kernel 9, "cpu" its plain
    version."""
    device = torch.device(device)
    a336 = _load_dir(os.path.join(base_folder, anchors[0]), n_images)
    a224 = _load_dir(os.path.join(base_folder, anchors[1]), n_images)
    if a336 is None or a224 is None:
        raise FileNotFoundError(
            f"anchor embeddings missing under {base_folder}")
    a336, am336 = pad_stack(a336, device)
    a224, am224 = pad_stack(a224, device)
    results = {}
    for rep in reps:
        target = _load_dir(os.path.join(base_folder, rep), n_images)
        if target is None:
            continue
        t, tm = pad_stack(target, device)
        results[rep] = float(a_score(t, a336, a224, target_mask=tm,
                                     anchor336_mask=am336,
                                     anchor224_mask=am224))
    return results
