"""Figures and CSV artifacts (a copy of the JAX package's
`visualizations/plots.py`; the reference's `visualizations/`: `draw_law.py`
scatter and fit, `bar.py` policy-accuracy bar, radar charts,
`AC_sample.py` / `plot_line.py` sampling curves, `AC_score.csv`).

matplotlib with the Agg backend, imported here and by no other module of
the port; every function takes data and a save path, no hardcoded user-home
paths (`draw_law.py:12` et al).
"""

from __future__ import annotations

import csv
from typing import Dict, Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from ..policy.data import ACTable, BENCHMARKS  # noqa: E402
from ..policy.fit import fit_policy  # noqa: E402


def plot_law_scatter(table: ACTable, benchmark: str, out_path: str,
                     grid_n: int = 60) -> str:
    """The 'law' figure (`draw_law.py`): per-representation (A, C) points
    colored by benchmark performance over the fitted degree-2 surface."""
    a, c, y = table.normed(benchmark)
    fit = fit_policy(table, benchmark)
    ga, gc = np.meshgrid(np.linspace(0, 1, grid_n),
                         np.linspace(0, 1, grid_n))
    z = fit.predict(np.stack([ga.ravel(), gc.ravel()], 1)).reshape(ga.shape)

    fig, ax = plt.subplots(figsize=(6, 5))
    cs = ax.contourf(ga, gc, z, levels=14, cmap="viridis", alpha=0.75)
    fig.colorbar(cs, ax=ax, label="predicted (normalized)")
    sc = ax.scatter(a, c, c=y, cmap="viridis", edgecolor="k", s=60)
    for i, m in enumerate(table.models):
        ax.annotate(m, (a[i], c[i]), fontsize=6, alpha=0.8)
    ax.set_xlabel("A score (normalized)")
    ax.set_ylabel("C score (normalized)")
    ax.set_title(f"Law of Vision Representation — {benchmark} "
                 f"(R²={fit.r2:.3f})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_policy_bar(accuracies: Dict[str, float], out_path: str) -> str:
    """Policy-accuracy bar chart (`bar.py:7-8`: Random/A/C/AC)."""
    names = list(accuracies)
    vals = [100 * accuracies[n] if accuracies[n] <= 1 else accuracies[n]
            for n in names]
    fig, ax = plt.subplots(figsize=(5, 4))
    bars = ax.bar(names, vals, color=["#999", "#7aa6c2", "#c2a47a",
                                      "#6fbf73"][:len(names)])
    for b, v in zip(bars, vals):
        ax.annotate(f"{v:.1f}", (b.get_x() + b.get_width() / 2, v),
                    ha="center", va="bottom", fontsize=9)
    ax.set_ylabel("optimal-representation prediction accuracy (%)")
    ax.set_ylim(0, 105)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_radar(table: ACTable, models: Sequence[str], out_path: str
               ) -> str:
    """Radar chart of per-benchmark performance for selected models."""
    angles = np.linspace(0, 2 * np.pi, len(BENCHMARKS), endpoint=False)
    angles = np.concatenate([angles, angles[:1]])
    fig, ax = plt.subplots(figsize=(6, 6),
                           subplot_kw={"projection": "polar"})
    for m in models:
        i = table.models.index(m)
        vals = []
        for b in BENCHMARKS:
            y = table.perf[b]
            vals.append((y[i] - y.min()) / (y.max() - y.min()))
        vals = vals + vals[:1]
        ax.plot(angles, vals, label=m, linewidth=1.5)
        ax.fill(angles, vals, alpha=0.08)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(BENCHMARKS, fontsize=7)
    ax.legend(loc="upper right", bbox_to_anchor=(1.3, 1.1), fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def plot_sampling_curve(ks: Sequence[int], accs: Sequence[float],
                        out_path: str, label: str = "AC policy") -> str:
    """Accuracy vs number of sampled training runs (`AC_sample.py`)."""
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.plot(list(ks), [100 * a for a in accs], marker="o", label=label)
    ax.set_xlabel("k (training runs sampled)")
    ax.set_ylabel("prediction accuracy (%)")
    ax.grid(alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def write_ac_score_csv(path: str, models: Sequence[str],
                       a_scores: Dict[str, Dict[str, float]],
                       c_scores: Dict[str, float],
                       geo_c: Optional[Dict[str, float]] = None) -> str:
    """`visualizations/AC_score.csv` equivalent: per-model normalized A per
    benchmark + C columns."""
    benches = sorted({b for per in a_scores.values() for b in per})
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["model"] + benches + ["corres"] +
                   (["geo_corres"] if geo_c else []))
        for m in models:
            row = [m] + [a_scores.get(m, {}).get(b, "") for b in benches]
            row.append(c_scores.get(m, ""))
            if geo_c:
                row.append(geo_c.get(m, ""))
            w.writerow(row)
    return path
