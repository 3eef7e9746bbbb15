"""The port's SPair / AP-10k / PF-Pascal loaders (`metrics/spair.py`) against
the JAX package's on the synthetic trees of `tests/test_spair.py`: equal
arrays, exactly (the same numpy and json code on the same files)."""

import json
import os

import numpy as np
import pytest

from law_of_vision_representation_in_mllms_tpu.metrics import spair as JS
from law_of_vision_representation_in_mllms_torch.metrics import spair as TS
from test_spair import _make_synthetic_spair


def _same_pairs(got, want):
    assert got.files == want.files
    for name in ("kps", "thresholds", "used_kps"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_geoware_tables_are_a_byte_copy():
    assert open(TS._DATA, "rb").read() == open(JS._DATA, "rb").read()
    assert TS._DATA != JS._DATA
    assert TS.load_geoware_tables() == JS.load_geoware_tables()
    assert TS.SPAIR_CATEGORIES == JS.SPAIR_CATEGORIES


@pytest.mark.parametrize("subsample", [None, 5])
@pytest.mark.parametrize("size", [64, 840])
def test_load_spair_data_matches_jax(tmp_path, subsample, size):
    root = str(tmp_path / "SPair-71k")
    _make_synthetic_spair(root, n_pairs=8, num_kps=16)
    got = TS.load_spair_data(root, "cat", size=size, subsample=subsample)
    # another draw in between: both loaders reseed numpy's global RNG
    np.random.rand(7)
    want = JS.load_spair_data(root, "cat", size=size, subsample=subsample)
    _same_pairs(got, want)
    assert len(got.files) == 2 * (subsample or 8)
    for tables in (None, JS.load_geoware_tables()):
        np.testing.assert_array_equal(
            TS.geo_aware_masks(got, "cat", tables),
            JS.geo_aware_masks(want, "cat", tables))
    assert TS.geo_aware_masks(got, "cat").any()
    feats = np.random.RandomState(0).randn(
        len(got.files), 16, 3).astype(np.float32)
    for max_kps in (0, got.kps.shape[1] + 3):
        a = TS.batch_pairs(got, feats, max_kps=max_kps)
        b = JS.batch_pairs(want, feats, max_kps=max_kps)
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_geo_aware_masks_of_a_category_without_groups():
    kps = np.ones((4, 3, 3))
    pairs = TS.SPairPairs(files=["a"] * 4, kps=kps,
                          thresholds=np.ones(2, np.float32),
                          used_kps=np.arange(3))
    tables = {"SPAIR_GEO_AWARE": {}}
    got = TS.geo_aware_masks(pairs, "cat", tables)
    np.testing.assert_array_equal(got, JS.geo_aware_masks(pairs, "cat",
                                                          tables))
    assert got.shape == (2, 3) and not got.any()


def test_weighted_aggregate_matches_jax():
    rng = np.random.RandomState(1)
    per_cat = [{"per_kpt": list(rng.rand(3)), "per_img": list(rng.rand(3)),
                "n_kpts": int(rng.randint(1, 50)),
                "n_pairs": int(rng.randint(1, 9))} for _ in range(5)]
    got, want = TS.weighted_aggregate(per_cat), JS.weighted_aggregate(per_cat)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def _ap10k_tree(root, n_pairs=6):
    os.makedirs(f"{root}/PairAnnotation/test", exist_ok=True)
    os.makedirs(f"{root}/ImageAnnotation/cat", exist_ok=True)
    rng = np.random.RandomState(0)
    for idx in range(2 * n_pairs):
        anno = {"width": int(rng.randint(60, 120)),
                "height": int(rng.randint(60, 120)),
                "bbox": [5, 5, int(rng.randint(20, 50)),
                         int(rng.randint(20, 50))],
                "keypoints": [float(v) for kp in range(5)
                              for v in (rng.randint(0, 100),
                                        rng.randint(0, 80),
                                        2 * rng.randint(0, 2))]}
        with open(f"{root}/ImageAnnotation/cat/img{idx}.json", "w") as f:
            json.dump(anno, f)
    for p in range(n_pairs):
        pair = {"src_json_path": f"{root}/ImageAnnotation/cat/img{2*p}.json",
                "trg_json_path":
                    f"{root}/ImageAnnotation/cat/img{2*p+1}.json"}
        with open(f"{root}/PairAnnotation/test/{p:06d}:cat.json", "w") as f:
            json.dump(pair, f)


@pytest.mark.parametrize("subsample", [None, 4])
def test_load_ap10k_data_matches_jax(tmp_path, subsample):
    root = str(tmp_path / "ap-10k")
    _ap10k_tree(root)
    got = TS.load_ap10k_data(root, "cat", size=64, subsample=subsample)
    want = JS.load_ap10k_data(root, "cat", size=64, subsample=subsample)
    _same_pairs(got, want)
    assert got.kps[..., 2].max() == 1.0


def test_load_pascal_data_matches_jax(tmp_path):
    from PIL import Image
    root = tmp_path / "PF-dataset-PASCAL"
    os.makedirs(root)
    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    for n, size in (("a.jpg", (60, 40)), ("b.jpg", (30, 50)),
                    ("c.jpg", (44, 44))):
        Image.new("RGB", size).save(img_dir / n)
    with open(root / "test_pairs_pf_pascal.csv", "w") as f:
        f.write("source_image,target_image,class,XA,YA,XB,YB\n")
        f.write("imgs/a.jpg,imgs/b.jpg,8,10;20;30,5;15;25,12;22;32,"
                "6;16;26\n")
        f.write("imgs/c.jpg,imgs/a.jpg,8,1;2,3;4,5;6,7;8\n")
        f.write("imgs/b.jpg,imgs/c.jpg,12,1;2,3;4,5;6,7;8\n")
    for cat in ("cat", "dog"):
        got = TS.load_pascal_data(str(root), cat, size=64)
        want = JS.load_pascal_data(str(root), cat, size=64)
        _same_pairs(got, want)
