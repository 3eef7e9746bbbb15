"""The port's supervised C-score training (`metrics/c_losses.py`,
`train/c_score_{train,runner}.py`, the `c-train` command) and the
adaptive-flip primitives (`metrics/flip_eval.py`) against the JAX
package's, on the CPU in fp32, on the JAX tests' tiny shapes.

Both runners start from the same weights (the JAX `init_c_train`'s,
carried across by `io.from_jax.aggregation_state_dict`) and take the same
batches (`np.random.default_rng(seed)` in the same order), so their
evaluations and last weights are compared. Tolerances: losses and
descriptors within 1e-5 relative (fp32 sums in another order); the trained
runs' losses and PCKs within 1e-4, the weights within 1e-4 of their
largest (Adam divides each update by a running gradient scale, which
amplifies the first steps' rounding).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.io.param_io import (
    load_params)
from law_of_vision_representation_in_mllms_torch.metrics import (
    aggregation as TA, c_losses as TL, flip_eval as TFE)
from law_of_vision_representation_in_mllms_torch.train import (
    c_score_runner as TR, c_score_train as TT)
from law_of_vision_representation_in_mllms_tpu.metrics import (
    aggregation as JA, c_losses as JL, flip_eval as JFE)
from law_of_vision_representation_in_mllms_tpu.train import (
    c_score_runner as JR, c_score_train as JT)
from test_spair import _make_synthetic_spair

torch.set_num_threads(1)

TOL = 1e-5
TRAIN_TOL = 1e-4


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def _unit(rng, *shape):
    x = rng.randn(*shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_clip_and_dense_epe_losses_match_jax():
    rng = np.random.RandomState(90)
    d1, d2 = _unit(rng, 6, 8), _unit(rng, 6, 8)
    scale = np.float32(np.log(1 / 0.07))
    close(TL.clip_loss(torch.from_numpy(d1), torch.from_numpy(d2),
                       torch.tensor(scale)),
          JL.clip_loss(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(scale)))
    n = 5
    p1, p2 = _unit(rng, n * n, 8), _unit(rng, n * n, 8)
    idx = rng.randint(0, n * n, 7)
    flow = rng.randn(7, 2).astype(np.float32)
    for window in (0, 2):
        close(TL.dense_epe_loss(torch.from_numpy(p1), torch.from_numpy(p2),
                                torch.from_numpy(idx), torch.from_numpy(flow),
                                n, window=window),
              JL.dense_epe_loss(jnp.asarray(p1), jnp.asarray(p2),
                                jnp.asarray(idx), jnp.asarray(flow), n,
                                window=window))


def test_self_contrastive_loss_on_the_jax_draws():
    x = np.random.RandomState(91).randn(2, 6, 5, 4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = JL.self_contrastive_loss(jnp.asarray(x), key)
    # the draws the JAX function makes from `key`, handed to the port
    k1, k2 = jax.random.split(key)
    hw = jnp.asarray([6, 5])
    pairs = tuple(np.array(jax.random.randint(k, (30, 2), 0, hw))
                  for k in (k1, k2))
    close(TL.self_contrastive_loss(torch.from_numpy(x), pairs=pairs), want)
    drawn = TL.self_contrastive_loss(
        torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn)


@pytest.mark.parametrize("total", [10, 250])
def test_lr_schedule_matches_optax(total):
    cfg = TT.CTrainConfig(learning_rate=3e-3, total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-3, max(1, total // 100),
                                               total)
    for k in range(total + 2):
        assert abs(TT.lr_at(cfg, k) - float(sched(k))) <= 1e-7 * 3e-3 + 1e-9


def _jax_init(dims, n, cfg, seed):
    net = JA.AggregationNetwork(feature_dims=dims, projection_dim=8,
                                num_norm_groups=4)
    state, opt = JT.init_c_train(net, cfg, jax.random.PRNGKey(seed),
                                 (n, n, sum(dims)))
    return net, state, opt


def _port_net(dims, params, projection_dim=8):
    net = TA.AggregationNetwork(feature_dims=dims,
                                projection_dim=projection_dim,
                                num_norm_groups=4)
    net.load_state_dict(from_jax.aggregation_state_dict(
        jax.tree.map(np.asarray, params)))
    return net


def test_first_step_keeps_the_weights_and_decays_every_leaf():
    """optax's first update has learning rate 0; later ones decay
    `self_logit_scale`, which no loss reads, as every other leaf."""
    dims, n = (8, 16), 4
    cfg = TT.CTrainConfig(learning_rate=3e-3, weight_decay=0.1,
                          total_steps=100, num_patches=n)
    net = TA.AggregationNetwork(feature_dims=dims, projection_dim=8,
                                num_norm_groups=4)
    step = TT.make_c_train_step(net, cfg, TT.init_c_train(
        net, cfg, torch.Generator().manual_seed(0)))
    init = {k: v.clone() for k, v in net.state_dict().items()}
    rng = np.random.RandomState(92)
    batch = {
        "feat1": torch.from_numpy(rng.randn(2, n, n, 24).astype(np.float32)),
        "feat2": torch.from_numpy(rng.randn(2, n, n, 24).astype(np.float32)),
        "kp_idx1": torch.from_numpy(rng.randint(0, n * n, (2, 5))),
        "kp_idx2": torch.from_numpy(rng.randint(0, n * n, (2, 5))),
        "kp_valid": torch.ones(2, 5),
        "gt_flow": torch.from_numpy(rng.randn(2, 5, 2).astype(np.float32))}
    step(batch)
    for name, v in net.state_dict().items():
        assert torch.equal(v, init[name]), name
    step(batch)
    lr = TT.lr_at(cfg, 1)
    want = init["self_logit_scale"] * (1 - lr * cfg.weight_decay)
    assert torch.allclose(net.self_logit_scale, want, rtol=1e-7, atol=0)
    assert step.count == 2


def _spair_features(root, feat_dir, g, dims, n_pairs=3):
    _make_synthetic_spair(root, n_pairs=n_pairs)
    os.makedirs(feat_dir)
    rng = np.random.RandomState(93)
    for i in range(2 * n_pairs):
        np.save(os.path.join(feat_dir, f"img{i}.npy"),
                rng.randn(g * g, sum(dims)).astype(np.float32))


def test_run_c_training_matches_jax_step_by_step(tmp_path, monkeypatch):
    """The two runners from the JAX init, 10 steps of 2 pairs: each
    evaluation's loss and PCK, the last weights; both best.npz files load
    into either package."""
    root, feats = str(tmp_path / "SPair-71k"), str(tmp_path / "feats")
    g, dims = 4, (8, 8)
    _spair_features(root, feats, g, dims)
    kw = dict(feature_dims=dims, num_patches=g, anno_size=64,
              categories=["cat"], projection_dim=8, steps=10, batch_size=2,
              learning_rate=3e-3)
    want = JR.run_c_training(root, feats, out_dir=str(tmp_path / "jax"),
                             **kw)
    _, state, _ = _jax_init(dims, g, JT.CTrainConfig(total_steps=10,
                                                     num_patches=g), 0)
    start = from_jax.aggregation_state_dict(
        jax.tree.map(np.asarray, state["params"]))
    monkeypatch.setattr(TT, "init_aggregation",
                        lambda net, gen: net.load_state_dict(start))
    got = TR.run_c_training(root, feats, device="cpu",
                            out_dir=str(tmp_path / "port"), **kw)
    assert [h["step"] for h in got["history"]] == [2, 4, 6, 8, 10]
    assert [h["step"] for h in got["history"]] == \
        [h["step"] for h in want["history"]]
    for h, w in zip(got["history"], want["history"]):
        assert abs(h["loss"] - w["loss"]) <= TRAIN_TOL * abs(w["loss"])
        assert abs(h["pck"] - w["pck"]) <= TRAIN_TOL
    assert abs(got["best_pck"] - want["best_pck"]) <= TRAIN_TOL
    last = {side: from_jax.aggregation_state_dict(load_params(
        str(tmp_path / side / "last.npz"))) for side in ("jax", "port")}
    assert sorted(last["port"]) == sorted(last["jax"])
    for name, w in last["jax"].items():
        close(last["port"][name], w.numpy(), TRAIN_TOL)
    # each package's best.npz is the JAX tree: the other loads it
    for side in ("jax", "port"):
        tree = load_params(str(tmp_path / side / "best.npz"))
        _port_net(dims, tree)
        x = jnp.zeros((1, g, g, sum(dims)))
        JA.AggregationNetwork(feature_dims=dims, projection_dim=8,
                              num_norm_groups=4).apply({"params": tree}, x)


def test_c_train_cli(tmp_path):
    root, feats = str(tmp_path / "SPair-71k"), str(tmp_path / "feats")
    _spair_features(root, feats, 4, (8, 8))
    out = str(tmp_path / "out")
    assert cli.main(["c-train", "--spair-dir", root, "--feature-dir", feats,
                     "--feature-dims", "8", "8", "--num-patches", "4",
                     "--anno-size", "64", "--categories", "cat",
                     "--steps", "5", "--out-dir", out,
                     "--device", "cpu"]) == 0
    assert os.path.exists(os.path.join(out, "best.npz"))
    assert os.path.exists(os.path.join(out, "last.npz"))


def test_seeded_init_is_flax_like():
    net = TA.AggregationNetwork(feature_dims=(8, 16), projection_dim=8,
                                num_norm_groups=4)
    TT.init_aggregation(net, torch.Generator().manual_seed(1))
    w = net.bottlenecks[1].conv1.conv.weight
    std = 16 ** -0.5
    assert w.abs().max() <= 2 * std / TT._TRUNC_STD
    assert torch.equal(net.mixing_weights, torch.ones(2))
    again = TA.AggregationNetwork(feature_dims=(8, 16), projection_dim=8,
                                  num_norm_groups=4)
    TT.init_aggregation(again, torch.Generator().manual_seed(1))
    for (k, a), b in zip(net.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# adaptive flip
# ---------------------------------------------------------------------------

def test_flip_eval_matches_jax():
    flip_list = [[0, 1], 2, [3, 4, 5]]
    for vis in (None, [True] * 6, [True, True, True, False, True, True]):
        assert TFE.permute_indices(flip_list, vis) == \
            JFE.permute_indices(flip_list, vis)
    rng = np.random.RandomState(94)
    kps = np.concatenate([rng.rand(6, 2) * 64, rng.rand(6, 1) > 0.3],
                         axis=1).astype(np.float32)
    perm = TFE.permute_indices(flip_list)
    np.testing.assert_array_equal(TFE.flip_keypoints(kps, 64, perm),
                                  JFE.flip_keypoints(kps, 64, perm))
    kps2 = kps[::-1].copy()
    pred, pred_flip = rng.rand(6, 2), rng.rand(6, 2)
    vis = kps[:, 2] > 0
    for fd, od in ((0.1, 0.5), (0.5, 0.1)):
        np.testing.assert_array_equal(
            TFE.select_flip_predictions(pred, pred_flip, kps, kps2, fd, od,
                                        vis, flip_list, 64),
            JFE.select_flip_predictions(pred, pred_flip, kps, kps2, fd, od,
                                        vis, flip_list, 64))
    d1 = rng.randn(20, 6).astype(np.float32)
    d2 = np.concatenate([d1[:12] + 0.01 * rng.randn(12, 6),
                         rng.randn(8, 6)]).astype(np.float32)
    close(TFE.mutual_nn_distance(torch.from_numpy(d1), torch.from_numpy(d2)),
          JFE.mutual_nn_distance(jnp.asarray(d1), jnp.asarray(d2)))
