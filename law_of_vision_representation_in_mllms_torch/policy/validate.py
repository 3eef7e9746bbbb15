"""validate_run (`policy/validate_run.py:10-54`): fit the AC polynomial on a
training subset, predict over all 13 representations, and report whether the
known-optimal representation lands in the top-k predictions."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .data import ACTable, ALL_MODELS, OPTIMAL
from .fit import fit_policy


def validate_run(table: ACTable, benchmark: str,
                 train_models: Sequence[str], top: int = 1
                 ) -> Tuple[bool, List[str]]:
    fit = fit_policy(table, benchmark, train_models=train_models)
    a, c, _ = table.normed(benchmark)
    pred = fit.predict(np.stack([a, c], 1))
    top_models = [table.models[i] for i in np.argsort(pred)[-top:]]
    return OPTIMAL[benchmark] in top_models, top_models
