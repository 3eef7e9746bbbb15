"""Supervised-correspondence training runner (counterpart of the JAX
package's `train/c_score_runner.py`; the train path of `C_score/
pck_train.py`: SPair trn pairs and cached features, AdamW steps, PCK
evaluations, the best checkpoint by PCK@0.10).

The batches come from the same `np.random.default_rng(seed)` calls, in the
same order, as the JAX runner's, so the two runs take the same steps; the
network's initial weights come from a `torch.Generator` seeded with
`seed` (the JAX runner draws them from `PRNGKey(seed)`, other numbers).
`best.npz` / `last.npz` hold the JAX tree (`io.from_jax.aggregation_tree`),
so either package loads the other's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..io.from_jax import aggregation_tree
from ..io.param_io import save_params
from ..metrics import spair as S
from ..metrics.aggregation import AggregationNetwork
from ..metrics.c_score import compute_pck_batch
from .c_score_train import CTrainConfig, init_c_train, make_c_train_step


def _pair_samples(pairs: S.SPairPairs, feats: np.ndarray,
                  num_patches: int, anno_size: int, max_kps: int):
    """Per-pair training arrays: grids, keypoint patch indices, gt flow."""
    n = len(pairs.thresholds)
    g = num_patches
    c = feats.shape[-1]
    scale = num_patches / anno_size
    out = {
        "feat1": feats[0::2].reshape(n, g, g, c),
        "feat2": feats[1::2].reshape(n, g, g, c),
        "kp_idx1": np.zeros((n, max_kps), np.int32),
        "kp_idx2": np.zeros((n, max_kps), np.int32),
        "kp_valid": np.zeros((n, max_kps), np.float32),
        "gt_flow": np.zeros((n, max_kps, 2), np.float32),
    }
    k = pairs.kps.shape[1]
    for p in range(n):
        s_kp, t_kp = pairs.kps[2 * p], pairs.kps[2 * p + 1]
        vis = (s_kp[:, 2] * t_kp[:, 2]) > 0
        sx, sy = s_kp[:, 0] * scale, s_kp[:, 1] * scale
        tx, ty = t_kp[:, 0] * scale, t_kp[:, 1] * scale
        idx1 = (num_patches * sy.astype(np.int32)
                + sx.astype(np.int32)).clip(0, g * g - 1)
        idx2 = (num_patches * ty.astype(np.int32)
                + tx.astype(np.int32)).clip(0, g * g - 1)
        out["kp_idx1"][p, :k] = idx1
        out["kp_idx2"][p, :k] = idx2
        out["kp_valid"][p, :k] = vis
        # the dense objective's target: from the source patch to the
        # (float) target position, in patch units
        out["gt_flow"][p, :k, 0] = tx - (idx1 % num_patches)
        out["gt_flow"][p, :k, 1] = ty - (idx1 // num_patches)
    return out


def run_c_training(spair_dir: str, feature_dir: str, *,
                   feature_dims: Sequence[int], num_patches: int, device,
                   anno_size: int = 840, suffix: str = "",
                   categories: Optional[Sequence[str]] = None,
                   projection_dim: int = 128, steps: int = 200,
                   batch_size: int = 4, learning_rate: float = 5e-4,
                   out_dir: str = "c_train_out", seed: int = 0,
                   window: int = 0) -> Dict:
    """Returns {'best_pck': float, 'history': [...]}, training on `device`
    (fp32). The feature caches hold [P, C_cat] stacked per-layer features
    an image (`<stem><suffix>.npy`, as `pipeline/c_score_run.py` reads
    them)."""
    from ..pipeline.c_score_run import _load_features

    device = torch.device(device)
    categories = list(categories or S.SPAIR_CATEGORIES)
    net = AggregationNetwork(feature_dims=tuple(feature_dims),
                             projection_dim=projection_dim,
                             num_norm_groups=4).to(device)
    cfg = CTrainConfig(learning_rate=learning_rate, total_steps=steps,
                       num_patches=num_patches, window=window)

    train_samples, eval_samples = [], []
    for cat in categories:
        for split, bucket in (("trn", train_samples),
                              ("test", eval_samples)):
            try:
                pairs = S.load_spair_data(spair_dir, cat, split=split,
                                          size=anno_size)
            except (FileNotFoundError, IndexError, ValueError):
                continue   # no such split for this category
            if not len(pairs.thresholds):
                continue
            feats = _load_features(pairs.files, feature_dir, suffix)
            bucket.append((pairs, _pair_samples(
                pairs, feats, num_patches, anno_size,
                max_kps=pairs.kps.shape[1])))
    if not train_samples:
        # train on the eval pairs when no trn split exists (smoke runs)
        train_samples = eval_samples

    opt = init_c_train(net, cfg,
                       torch.Generator(device=device).manual_seed(seed))
    step_fn = make_c_train_step(net, cfg, opt)

    @torch.no_grad()
    def eval_pck():
        scores, weights = [], []
        for pairs, sample in (eval_samples or train_samples):
            f1 = net(torch.from_numpy(sample["feat1"]).to(device))
            f2 = net(torch.from_numpy(sample["feat2"]).to(device))
            n, g, _, c = f1.shape
            batch = S.batch_pairs(pairs, np.zeros((2 * n, 1, 1)),
                                  max_kps=pairs.kps.shape[1])
            res, _ = compute_pck_batch(
                f1.reshape(n, g * g, c), f2.reshape(n, g * g, c),
                *(torch.from_numpy(batch[k]).to(device) for k in
                  ("kps1", "kps2", "vis", "thresholds")),
                num_patches=num_patches, anno_size=anno_size,
                window=window)
            scores.append(float(res.per_img[0]))
            weights.append(len(pairs.thresholds))
        return float(np.average(scores, weights=weights))

    def save(name):
        save_params(os.path.join(out_dir, name),
                    aggregation_tree(net.state_dict()))

    rng = np.random.default_rng(seed)
    best, history = -1.0, []
    os.makedirs(out_dir, exist_ok=True)
    eval_every = max(1, steps // 5)
    for step in range(steps):
        pairs, sample = train_samples[rng.integers(len(train_samples))]
        n = sample["feat1"].shape[0]
        idx = rng.integers(0, n, size=min(batch_size, n))
        batch = {k: torch.from_numpy(v[idx]).to(device)
                 for k, v in sample.items()}
        metrics = step_fn(batch)
        if (step + 1) % eval_every == 0:
            pck = eval_pck()
            history.append({"step": step + 1,
                            "loss": float(metrics["loss"]), "pck": pck})
            save("last.npz")
            if pck > best:
                best = pck
                save("best.npz")
    return {"best_pck": best, "history": history}
