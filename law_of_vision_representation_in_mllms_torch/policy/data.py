"""AC-policy data table.

Schema follows `policy/ablations_t.csv` (header row: model, 8 benchmark
columns, per-benchmark A columns `<bench>_average`, and the C column
`corres`). Our pipeline writes the same schema (eval harness -> benchmark
scores; metrics.a_score -> A; metrics.c_score -> C), so the policy layer
consumes either the reference CSV or a freshly produced one.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

BENCHMARKS = ["mmbench_en", "mme", "mmmu_val", "ok_vqa", "textvqa_val",
              "vizwiz_vqa_val", "scienceqa_img", "seed_image"]

ALL_MODELS = ["CLIP336", "CLIP224", "OpenCLIP", "DINOv2", "SDim", "SD1.5",
              "SDXL", "DiT", "SD3", "SD2.1", "SigLIP", "CLIP224+DINOv2",
              "CLIP336+DINOv2"]

# known optimal representation per benchmark (`policy/validate_run.py:14`)
OPTIMAL = {"mmbench_en": "CLIP224+DINOv2", "mme": "CLIP336",
           "mmmu_val": "OpenCLIP", "ok_vqa": "CLIP336+DINOv2",
           "textvqa_val": "CLIP336+DINOv2", "vizwiz_vqa_val": "CLIP336",
           "scienceqa_img": "CLIP336", "seed_image": "CLIP336+DINOv2"}


@dataclasses.dataclass
class ACTable:
    models: List[str]
    perf: Dict[str, np.ndarray]      # benchmark -> [n_models]
    a: Dict[str, np.ndarray]         # benchmark -> [n_models] (raw A)
    c: np.ndarray                    # [n_models] (raw C, 'corres')

    def normed(self, benchmark: str):
        """Min-max normalized (a, c, perf) over ALL rows
        (`policy/fit.py:33-45` normalizes before sub-setting)."""
        def mm(x):
            lo, hi = x.min(), x.max()
            rng = hi - lo
            if rng <= 0:                 # degenerate column: all equal
                return np.zeros_like(x)
            return (x - lo) / rng
        return (mm(self.a[benchmark]), mm(self.c), mm(self.perf[benchmark]))

    def rows(self, models: Sequence[str]) -> np.ndarray:
        idx = {m: i for i, m in enumerate(self.models)}
        return np.asarray([idx[m] for m in models])


def load_ac_csv(path: str) -> ACTable:
    with open(path) as f:
        rows = list(csv.DictReader(f))
    models = [r["model"] for r in rows]
    perf = {b: np.asarray([float(r[b]) for r in rows]) for b in BENCHMARKS}
    a = {b: np.asarray([float(r[f"{b}_average"]) for r in rows])
         for b in BENCHMARKS}
    c = np.asarray([float(r["corres"]) for r in rows])
    return ACTable(models=models, perf=perf, a=a, c=c)


def write_ac_csv(path: str, table: ACTable) -> None:
    cols = ["model"] + BENCHMARKS + [f"{b}_average" for b in BENCHMARKS] + [
        "corres"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i, m in enumerate(table.models):
            row = [m] + [table.perf[b][i] for b in BENCHMARKS] + \
                  [table.a[b][i] for b in BENCHMARKS] + [table.c[i]]
            w.writerow(row)
