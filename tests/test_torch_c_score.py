"""The port's C-score metrics (`metrics/c_score.py`,
`metrics/aggregation.py`, `io.from_jax.aggregation_*`) and its runner
(`pipeline/c_score_run.run_c_score`, the `c-score` command) against the JAX
package, on the same seeded numpy inputs, on the CPU in fp32.

Tolerances: flows within 1e-5 patch units (fp32 softmax sums in another
order), predicted pixels within 1e-5 patch strides, masks and per-keypoint
correctness exactly equal where the argmax has a clear margin; aggregates
within 1e-6 (fp32 sums of at most a few hundred terms in another order);
resized grids within 1e-5; aggregation networks within 1e-5 of the largest
output (fp32 convolutions in another order, GroupNorm's variance formed
another way).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.metrics import (
    aggregation as JA, c_score as J)
from law_of_vision_representation_in_mllms_tpu.pipeline.c_score_run import (
    run_c_score as j_run_c_score)
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.metrics import (
    aggregation as TA, c_score as T)
from law_of_vision_representation_in_mllms_torch.pipeline.c_score_run import (
    run_c_score)

torch.set_num_threads(1)

FLOW_TOL = 1e-5
AGG_TOL = 1e-6


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _sim(seed, b, n):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, n * n, n * n) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("window", [2, 5, 0, -3])
def test_soft_argmax_flow_matches_jax(window):
    """Hard window (> 0), plain soft-argmax (0) and gaussian (< 0)."""
    n = 8
    sim = _sim(window + 10, 3, n)
    got = T.soft_argmax_flow(*_t(sim), n, window=window).numpy()
    want = np.asarray(J.soft_argmax_flow(*_j(sim), n, window=window))
    assert got.shape == want.shape == (3, n * n, 2)
    np.testing.assert_allclose(got, want, atol=FLOW_TOL, rtol=0)


def test_masks_match_jax():
    n = 7
    sim = _sim(1, 2, n)
    # a row of ties: the argmax is the first of the equal values
    sim[0, 3, :] = 0.5
    for w in (1, 3):
        got = T.window_mask(*_t(sim), n, w).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(J.window_mask(*_j(sim), n, w)))
    got = T.gaussian_kernel_mask(*_t(sim), n, 2.0).numpy()
    want = np.asarray(J.gaussian_kernel_mask(*_j(sim), n, 2.0))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_window_zeros_outside_not_minus_inf():
    """Outside the window the similarity is zeroed: each zero adds exp(0) to
    the softmax denominator. With the window's values near 0 the zeros pull
    the flow toward the grid's middle, which a -inf mask would not do."""
    n, w = 8, 1
    rng = np.random.RandomState(2)
    sim = (0.01 * rng.rand(1, n * n, n * n)).astype(np.float32)
    sim[0, :, 0] = 0.02                      # argmax in the top-left corner
    got = T.soft_argmax_flow(*_t(sim), n, window=w)
    want = np.asarray(J.soft_argmax_flow(*_j(sim), n, window=w))
    np.testing.assert_allclose(got.numpy(), want, atol=FLOW_TOL, rtol=0)
    # the same flow with the outside at -inf
    s = torch.from_numpy(sim)
    inside = T.window_mask(s, n, w) != 0
    masked = s.masked_fill(~inside, float("-inf"))
    probs = torch.softmax(masked / 0.02, -1).reshape(1, n * n, n, n)
    lin = torch.linspace(-1, 1, n)
    fx = ((probs.sum(-2) * lin).sum(-1) + 1) * (n - 1) / 2
    assert (got[..., 0] - fx).abs().max() > 1.0


def test_kpts_to_patch_idx_matches_jax():
    n, anno = 12, 100
    rng = np.random.RandomState(3)
    kps = (rng.rand(4, 9, 2) * (anno + 20) - 10).astype(np.float32)
    kps[0, :3] = [[0, 0], [anno / n * 5, anno / n * 7], [99.99, 0.01]]
    got = T.kpts_to_patch_idx(*_t(kps), n, anno).numpy()
    want = np.asarray(J.kpts_to_patch_idx(*_j(kps), n, anno))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("soft_eval", [True, False])
@pytest.mark.parametrize("batched", [True, False])
def test_transfer_keypoints_matches_jax(soft_eval, batched):
    n, anno = 8, 70                         # stride 8.75: stride // 2 = 4.0
    sim = _sim(4, 2, n)
    rng = np.random.RandomState(5)
    kps = (rng.rand(2, 6, 2) * (anno - 1)).astype(np.float32)
    if not batched:
        sim, kps = sim[0], kps[0]
    got = T.transfer_keypoints(*_t(sim, kps), n, anno,
                               soft_eval=soft_eval).numpy()
    want = np.asarray(J.transfer_keypoints(*_j(sim, kps), n, anno,
                                           soft_eval=soft_eval))
    np.testing.assert_allclose(got, want, atol=FLOW_TOL * anno / n, rtol=0)


def test_pck_matches_jax():
    rng = np.random.RandomState(6)
    b, k = 5, 8
    gt = (rng.rand(b, k, 2) * 64).astype(np.float32)
    pred = gt + (rng.randn(b, k, 2) * 4).astype(np.float32)
    vis = rng.rand(b, k) < 0.7
    vis[2] = False                           # a pair with no visible keypoint
    thr = (rng.rand(b) * 40 + 20).astype(np.float32)
    got = T.pck(*_t(pred, gt, vis, thr))
    want = J.pck(*_j(pred, gt, vis, thr))
    np.testing.assert_array_equal(got.correct.numpy(),
                                  np.asarray(want.correct))
    assert int(got.n_kpts) == int(want.n_kpts) == vis.sum()
    for name in ("per_kpt", "per_img"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=AGG_TOL, rtol=0)


def _permuted_pairs(seed, b=4, n=8, c=16, k=7, anno=64):
    """desc2 is a patch permutation of desc1 plus small noise, and kps2 sits
    at the permuted patch's centre: a clear argmax and many correct
    keypoints."""
    rng = np.random.RandomState(seed)
    p = n * n
    desc1 = rng.randn(b, p, c).astype(np.float32)
    perm = rng.permutation(p)
    desc2 = desc1[:, perm] + 0.01 * rng.randn(b, p, c).astype(np.float32)
    kps1 = (rng.rand(b, k, 2) * (anno - 1)).astype(np.float32)
    stride = anno / n
    src = (kps1 * n / anno).astype(np.int32)
    dst = np.argsort(perm)[src[..., 1] * n + src[..., 0]]
    kps2 = np.stack([dst % n, dst // n], -1) * stride + stride / 2
    kps2 = (kps2 + rng.randn(b, k, 2) * 2).astype(np.float32)
    vis = rng.rand(b, k) < 0.8
    thr = np.full(b, 40.0, np.float32)
    return desc1, desc2, kps1, kps2, vis, thr


@pytest.mark.parametrize("window", [5, 0])
def test_compute_pck_batch_matches_jax(window):
    n, anno = 8, 64
    arrays = _permuted_pairs(7)
    got, gpred = T.compute_pck_batch(*_t(*arrays), num_patches=n,
                                     anno_size=anno, window=window)
    want, wpred = J.compute_pck_batch(*_j(*arrays), num_patches=n,
                                      anno_size=anno, window=window)
    np.testing.assert_allclose(gpred.numpy(), np.asarray(wpred),
                               atol=FLOW_TOL * anno / n, rtol=0)
    np.testing.assert_array_equal(got.correct.numpy(),
                                  np.asarray(want.correct))
    assert got.per_kpt[0] > 0.5              # the test has teeth
    for name in ("per_kpt", "per_img"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=AGG_TOL, rtol=0)


def test_chunking_changes_no_bit(monkeypatch):
    """Chunks of one pair and one chunk of all pairs give the same bits."""
    arrays = _t(*_permuted_pairs(8, b=5))
    p = arrays[0].shape[1]
    out = []
    for pairs_a_chunk in (1, 2, 5):
        monkeypatch.setattr(T, "CHUNK_BYTES", 4 * p * p * pairs_a_chunk)
        out.append(T.compute_pck_batch(*arrays, num_patches=8,
                                       anno_size=64))
    for res, pred in out[1:]:
        assert torch.equal(pred, out[0][1])
        for a, b in zip(res, out[0][0]):
            assert torch.equal(a, b)


def test_concat_two_features_matches_jax():
    rng = np.random.RandomState(9)
    a = rng.randn(2, 10, 4).astype(np.float32)
    b = rng.randn(2, 10, 6).astype(np.float32)
    got = T.concat_two_features(*_t(a, b)).numpy()
    want = np.asarray(J.concat_two_features(*_j(a, b)))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("grids", [(24, 60), (60, 24), (16, 24), (37, 24),
                                   (4, 4)])
def test_resize_feature_grid_matches_jax(grids):
    """jax.image.resize antialiases when it shrinks; so does the port."""
    g, out_grid = grids
    x = np.random.RandomState(g).randn(2, g * g, 3).astype(np.float32)
    got = T.resize_feature_grid(*_t(x), out_grid).numpy()
    want = np.asarray(J.resize_feature_grid(*_j(x), out_grid))
    assert got.shape == want.shape == (2, out_grid * out_grid, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---- aggregation networks -------------------------------------------------

def _perturbed(params, seed):
    import jax
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.1 * np.asarray(
        rng.randn(*np.shape(x)), np.float32), params)


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("in_ch", [16, 32])   # with and without a shortcut
def test_bottleneck_block_matches_flax(in_ch):
    import jax
    x = np.random.RandomState(10).randn(2, 5, 6, in_ch).astype(np.float32)
    jblock = JA.BottleneckBlock(8, 32, num_groups=4)
    params = _perturbed(jblock.init(jax.random.PRNGKey(0), x)["params"], 11)
    want = jblock.apply({"params": params}, x)
    block = TA.BottleneckBlock(in_ch, 8, 32, num_groups=4)
    block.load_state_dict(from_jax.aggregation_state_dict(params))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    _close(got.numpy(), want)
    back = from_jax.aggregation_tree(block.state_dict())
    assert sorted(back) == sorted(params)


def test_aggregation_network_matches_flax():
    import jax
    dims = (12, 20, 8)
    x = np.random.RandomState(12).randn(2, 6, 6, sum(dims)).astype(
        np.float32)
    jnet = JA.AggregationNetwork(feature_dims=dims, projection_dim=32,
                                 num_norm_groups=8)
    params = _perturbed(jnet.init(jax.random.PRNGKey(1), x)["params"], 13)
    want = jnet.apply({"params": params}, x)
    net = TA.AggregationNetwork(dims, projection_dim=32, num_norm_groups=8)
    net.load_state_dict(from_jax.aggregation_state_dict(params))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got.numpy(), want)
    # both ways: the tree comes back leaf for leaf
    back = from_jax.aggregation_tree(net.state_dict())
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(jax.tree_util.tree_leaves(back)) == len(flat)
    for path, leaf in flat:
        node = back
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node, leaf)
    # the initial scalars are Flax's
    fresh = jnet.init(jax.random.PRNGKey(2), x)["params"]
    for name in ("mixing_weights", "logit_scale", "self_logit_scale"):
        np.testing.assert_allclose(getattr(TA.AggregationNetwork(
            dims, 32, 8), name).detach().numpy(), fresh[name], rtol=1e-6)


def test_dummy_aggregation_and_displacement_match_jax():
    x = np.random.RandomState(14).randn(2, 4, 3).astype(np.float32)
    dummy = TA.DummyAggregation()
    with torch.no_grad():
        dummy.dummy.fill_(1.5)
    want = JA.DummyAggregation().apply({"params": {"dummy": jnp.float32(
        1.5)}}, x)
    np.testing.assert_allclose(dummy(torch.from_numpy(x)).detach().numpy(),
                               want, atol=1e-7)
    sim = _sim(15, 2, 6)
    for w in (3, 0):
        got = TA.soft_argmax_displacement(*_t(sim), 6, window=w).numpy()
        want = np.asarray(JA.soft_argmax_displacement(*_j(sim), 6,
                                                      window=w))
        np.testing.assert_allclose(got, want, atol=FLOW_TOL, rtol=0)


# ---- run_c_score and the c-score command ----------------------------------

CATS = ("cat", "dog")
NUM_PATCHES, ANNO = 6, 84


def _spair_tree(root, n_pairs=6, num_kps=16, seed=0):
    """A synthetic SPair tree over two categories whose keypoints meet their
    geo-aware groups, and two feature sets (suffixes "" and "_b")."""
    from test_spair import _make_synthetic_spair

    for i, cat in enumerate(CATS):
        _make_synthetic_spair(root, category=cat, n_pairs=n_pairs,
                              num_kps=num_kps)
        # the helper numbers images img0..; give each category its own
        for name in os.listdir(f"{root}/PairAnnotation/test"):
            if name.endswith(f":{cat}.json"):
                path = f"{root}/PairAnnotation/test/{name}"
                data = json.load(open(path))
                for side in ("src", "trg"):
                    data[f"{side}_imname"] = f"{cat}_" + data[
                        f"{side}_imname"]
                json.dump(data, open(path, "w"))
        adir = f"{root}/ImageAnnotation/{cat}"
        for name in os.listdir(adir):
            if not name.startswith(f"{cat}_"):
                os.rename(f"{adir}/{name}", f"{adir}/{cat}_{name}")
    feats = f"{root}/feats"
    os.makedirs(feats)
    rng = np.random.RandomState(seed)
    for cat in CATS:
        for i in range(2 * n_pairs):
            for suffix, c in (("", 12), ("_b", 5)):
                np.save(f"{feats}/{cat}_img{i}{suffix}.npy",
                        rng.randn(NUM_PATCHES ** 2, c).astype(np.float32))
    return feats


def _same_result(got, want):
    assert sorted(got) == sorted(want)
    for key in ("per_kpt", "per_img", "geo"):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], atol=AGG_TOL)
    assert sorted(got["categories"]) == sorted(want["categories"])
    for cat, rec in want["categories"].items():
        mine = got["categories"][cat]
        assert sorted(mine) == sorted(rec)
        for key, value in rec.items():
            if isinstance(value, list):
                np.testing.assert_allclose(mine[key], value, atol=AGG_TOL)
            else:
                assert mine[key] == value, (cat, key)


@pytest.mark.parametrize("variant", ["geo", "no_geo", "suffix2",
                                     "subsample"])
def test_run_c_score_matches_jax(tmp_path, variant):
    root = str(tmp_path / "SPair-71k")
    feats = _spair_tree(root)
    kw = dict(num_patches=NUM_PATCHES, anno_size=ANNO, categories=CATS,
              compute_geo=variant != "no_geo")
    if variant == "suffix2":
        kw["suffix2"] = "_b"
    if variant == "subsample":
        kw["subsample"] = 4
    got = run_c_score(root, feats, device="cpu", **kw)
    want = j_run_c_score(root, feats, **kw)
    _same_result(got, want)
    assert ("geo" in got) == (variant != "no_geo")
    if variant == "geo":
        assert all(rec["n_geo_kpts"] > 0
                   for rec in got["categories"].values())


def test_c_score_command_matches_jax(tmp_path, capsys):
    root = str(tmp_path / "SPair-71k")
    feats = _spair_tree(root, seed=1)
    args = ["c-score", "--spair-dir", root, "--feature-dir", feats,
            "--num-patches", str(NUM_PATCHES), "--anno-size", str(ANNO),
            "--window", "2", "--categories", *CATS]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert sorted(got) == sorted(want) == ["geo_pck", "per_img_pck",
                                           "per_kpt_pck"]
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=AGG_TOL)
    with pytest.raises(ValueError, match="categories"):
        run_c_score(root, feats, device="cpu", num_patches=NUM_PATCHES,
                    dataset="ap10k")
