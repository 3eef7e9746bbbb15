"""Exhaustive train-subset search (`policy/prediction.py:24-79`): for every
subset of the 13 representations, fit the AC polynomial and check whether the
argmax of the held-out predictions is the known-optimal representation."""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np

from .data import ACTable, ALL_MODELS, BENCHMARKS, OPTIMAL
from .fit import fit_policy, poly_features


def _predict_for(table: ACTable, benchmark: str, fitres, models):
    a, c, _ = table.normed(benchmark)
    idx = table.rows(models)
    x = np.stack([a[idx], c[idx]], 1)
    return fitres.predict(x)


def subset_search(table: ACTable, *, sizes=range(2, 14),
                  benchmarks: Optional[Sequence[str]] = None,
                  models: Optional[Sequence[str]] = None) -> List[Dict]:
    """Returns one record per (subset, benchmark) where the held-out argmax
    matches the optimal representation."""
    models = list(models or ALL_MODELS)
    benchmarks = list(benchmarks or BENCHMARKS)
    hits = []
    for k in sizes:
        for train in itertools.combinations(models, k):
            test = [m for m in models if m not in set(train)]
            if not test:
                continue
            for b in benchmarks:
                fit = fit_policy(table, b, train_models=train)
                pred = _predict_for(table, b, fit, test)
                if test[int(np.argmax(pred))] == OPTIMAL[b]:
                    hits.append({"benchmark": b, "train": train,
                                 "test_argmax": OPTIMAL[b]})
    return hits


def prediction_accuracy(table: ACTable, *, k: int, data: str = "AC",
                        model: str = "polynomial", n_draws: int = 500,
                        top: int = 1, seed: int = 0,
                        benchmarks: Optional[Sequence[str]] = None) -> float:
    """Monte-Carlo version of the headline policy accuracy
    (`visualizations/bar.py:7-8`: Random 45.09 / A 76.56 / C 56.91 /
    AC 95.72): draw k training reps, fit, predict over ALL reps
    (`validate_run.py:18-20` uses the full model list as test set), check
    the optimal is in the top-`top`."""
    rng = np.random.default_rng(seed)
    benchmarks = list(benchmarks or BENCHMARKS)
    hit = total = 0
    for _ in range(n_draws):
        train = list(rng.choice(ALL_MODELS, size=k, replace=False))
        for b in benchmarks:
            fit = fit_policy(table, b, data=data, model=model,
                             train_models=train, rng=rng)
            a, c, _ = table.normed(b)
            x = np.stack([a, c], 1) if data == "AC" else None
            if x is None:
                from .fit import _design
                x = _design(a, c, data, model, rng)
            pred = fit.predict(x)
            top_models = [table.models[i]
                          for i in np.argsort(pred)[-top:]]
            hit += OPTIMAL[b] in top_models
            total += 1
    return hit / max(total, 1)
