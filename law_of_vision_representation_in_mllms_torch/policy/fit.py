"""AC -> performance polynomial regression (`policy/fit.py:74-100`).

Degree-2 polynomial least squares in pure numpy; feature order matches
sklearn's PolynomialFeatures(degree=2) on (a, c): [1, a, c, a², ac, c²],
golden-tested against sklearn.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .data import ACTable


def poly_features(x: np.ndarray, degree: int = 2) -> np.ndarray:
    """x: [n, d] -> sklearn-ordered polynomial features [n, n_feats]."""
    n, d = x.shape
    feats = [np.ones((n, 1))]
    if degree >= 1:
        feats.append(x)
    if degree >= 2:
        cols = []
        for i in range(d):
            for j in range(i, d):
                cols.append(x[:, i] * x[:, j])
        feats.append(np.stack(cols, axis=1))
    if degree > 2:
        raise NotImplementedError(degree)
    return np.concatenate(feats, axis=1)


@dataclasses.dataclass
class PolicyFit:
    coef: np.ndarray
    degree: int
    r2: float
    mse: float

    def predict(self, x: np.ndarray) -> np.ndarray:
        return poly_features(x, self.degree) @ self.coef


def _design(a, c, data: str, model: str, rng=None):
    if data == "AC":
        x = np.stack([a, c], 1)
    elif data == "A":
        x = np.stack([a, a], 1) if model == "polynomial" else a[:, None]
    elif data == "C":
        x = np.stack([c, c], 1) if model == "polynomial" else c[:, None]
    elif data == "random":
        rng = rng or np.random.default_rng(0)
        cols = 2 if model == "polynomial" else 1
        x = rng.random((len(a), cols))
    elif data == "Ar":
        rng = rng or np.random.default_rng(0)
        x = np.stack([a, rng.random(len(a))], 1)
    else:
        raise ValueError(data)
    return x


def fit_policy(table: ACTable, benchmark: str, *, data: str = "AC",
               model: str = "polynomial",
               train_models: Optional[Sequence[str]] = None,
               rng=None) -> PolicyFit:
    a, c, y = table.normed(benchmark)
    x = _design(a, c, data, model, rng)
    if train_models is not None:
        idx = table.rows(train_models)
        x, y = x[idx], y[idx]
    degree = 2 if model == "polynomial" else 1
    f = poly_features(x, degree)
    coef, *_ = np.linalg.lstsq(f, y, rcond=None)
    pred = f @ coef
    mse = float(np.mean((pred - y) ** 2))
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    return PolicyFit(coef=coef, degree=degree, r2=r2, mse=mse)
