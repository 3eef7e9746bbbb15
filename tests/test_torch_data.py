"""The port's training data path against the JAX package's, element for
element: `preprocess_sources` over every template, `collate_batch`,
`_bucket_len`, `length_grouped_indices`, and `SupervisedDataset` /
`FeatureDataset` items. Both sides are host-side numpy, so every comparison
is exact (no tolerance). The hash tokenizer's ids come from Python's `hash`,
which agrees between the two packages within one process.
"""

import json

import numpy as np
import pytest
from PIL import Image

from law_of_vision_representation_in_mllms_tpu.data import (
    conversation as jconv, datasets as jds, preprocess as jpre)
from law_of_vision_representation_in_mllms_tpu.models import towers as jtowers
from law_of_vision_representation_in_mllms_torch.data import (
    conversation as tconv, datasets as tds, preprocess as tpre)
from law_of_vision_representation_in_mllms_torch.models import (
    towers as ttowers)

TEMPLATES = ["plain", "v1", "vicuna_v1", "llama_2", "mpt", "v0"]
WORDS = ("a red house near the river with two trees and a dog on grass "
         "under clouds").split()


def _conversation(rng, n_turns, image=True):
    conv = []
    for t in range(n_turns):
        human = " ".join(rng.choice(WORDS, 2 + t))
        if image and t == 0:
            # '<image>' at the end of the turn: the normalisation moves it
            human = human + " <image>"
        conv.append({"from": "human", "value": human})
        conv.append({"from": "gpt", "value": " ".join(rng.choice(WORDS,
                                                                 3 + t))})
    return conv


@pytest.mark.parametrize("template", TEMPLATES)
@pytest.mark.parametrize("image,max_length", [(True, None), (False, None),
                                              (True, 9)])
def test_preprocess_sources_matches_jax(template, image, max_length):
    rng = np.random.RandomState(len(template))
    jtok, ttok = jpre.SimpleTokenizer(500), tpre.SimpleTokenizer(500)
    for n_turns in (1, 2, 3):
        conv = _conversation(rng, n_turns, image)
        if n_turns == 3:           # a leading gpt turn is dropped
            conv = [{"from": "gpt", "value": "hello"}] + conv
        want = jpre.preprocess_sources(
            conv, jconv.get_template(template), jtok, has_image=image,
            max_length=max_length)
        got = tpre.preprocess_sources(
            conv, tconv.get_template(template), ttok, has_image=image,
            max_length=max_length)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)


def test_bucket_len_matches_jax():
    for n in range(1, 600):
        assert tds._bucket_len(n) == jds._bucket_len(n)
        assert tds._bucket_len(n, 16) == jds._bucket_len(n, 16)


def _samples(seed, n, towers=1):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        k = int(rng.randint(1, 90))
        out.append({"input_ids": rng.randint(0, 99, k).astype(np.int32),
                    "labels": rng.randint(-100, 99, k).astype(np.int32),
                    "pixel_values": [rng.randn(4, 4, 3).astype(np.float32)
                                     for _ in range(towers)],
                    "has_image": bool(i % 2)})
    return out


@pytest.mark.parametrize("kw", [dict(), dict(bucket=False),
                                dict(max_length=48), dict(max_length=100),
                                dict(pad_id=7, bucket=False, max_length=20)])
def test_collate_batch_matches_jax(kw):
    for seed, towers in ((0, 1), (1, 2)):
        samples = _samples(seed, 5, towers)
        want = jds.collate_batch(samples, **kw)
        got = tds.collate_batch(samples, **kw)
        assert set(got) == set(want)
        for key in ("input_ids", "labels", "text_mask"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        assert len(got["pixel_values"]) == len(want["pixel_values"])
        for g, w in zip(got["pixel_values"], want["pixel_values"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mix", ["mixed", "images_only", "text_only"])
@pytest.mark.parametrize("batch_size,world_size", [(4, 1), (3, 2), (5, 1)])
def test_length_grouped_indices_matches_jax(mix, batch_size, world_size):
    rng = np.random.RandomState(batch_size * world_size)
    lengths = rng.randint(1, 400, size=37)
    if mix == "mixed":
        lengths[rng.rand(37) < 0.4] *= -1
    elif mix == "text_only":
        lengths = -lengths
    for seed in (0, 1, 5):
        for by_modality in (True, False):
            want = jds.length_grouped_indices(
                lengths, batch_size, world_size, seed=seed,
                group_by_modality=by_modality)
            got = tds.length_grouped_indices(
                lengths, batch_size, world_size, seed=seed,
                group_by_modality=by_modality)
            np.testing.assert_array_equal(got, want)
            assert sorted(got.tolist()) == list(range(37))


def _records(tmp_path, rng):
    recs = []
    for i in range(4):
        rec = {"conversations": _conversation(rng, 1 + i % 2, image=i != 3)}
        if i != 3:                     # the last record is text-only
            rec["image"] = f"img{i}.png"
        recs.append(rec)
    path = tmp_path / "data.json"
    path.write_text(json.dumps(recs))
    return str(path)


def _assert_items_equal(got, want):
    assert set(got) == set(want)
    assert got["has_image"] == want["has_image"]
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    assert len(got["pixel_values"]) == len(want["pixel_values"])
    for g, w in zip(got["pixel_values"], want["pixel_values"]):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("template", ["plain", "v1"])
def test_supervised_dataset_matches_jax(tmp_path, template):
    rng = np.random.RandomState(3)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (20 + 9 * i, 31, 3),
                                    dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    data = _records(tmp_path, rng)
    spec = "debug/tiny-vit"
    want = jds.SupervisedDataset(data, str(tmp_path),
                                 jtowers.parse_tower_spec(spec),
                                 jconv.get_template(template),
                                 jpre.SimpleTokenizer(300), max_length=40)
    got = tds.SupervisedDataset(data, str(tmp_path),
                                ttowers.parse_tower_spec(spec),
                                tconv.get_template(template),
                                tpre.SimpleTokenizer(300), max_length=40)
    assert len(got) == len(want) == 4
    np.testing.assert_array_equal(got.lengths(), want.lengths())
    for i in range(4):
        _assert_items_equal(got[i], want[i])


def test_feature_dataset_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    for i in range(3):
        np.save(tmp_path / f"img{i}.npy",
                rng.randn(6, 5).astype(np.float16))
    data = _records(tmp_path, rng)
    args = (data, str(tmp_path))
    kw = dict(feature_shape=(6, 5), max_length=30)
    want = jds.FeatureDataset(*args, jconv.get_template("plain"),
                              jpre.SimpleTokenizer(300), **kw)
    got = tds.FeatureDataset(*args, tconv.get_template("plain"),
                             tpre.SimpleTokenizer(300), **kw)
    for i in range(4):
        _assert_items_equal(got[i], want[i])
    # packed_cache: the same items out of one .lvrpack (fp32 items, as the
    # pack is read), through each package's loader
    from law_of_vision_representation_in_mllms_torch.io import native_cache
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"f32_{i}.npy"))
        np.save(paths[-1], np.load(tmp_path / f"img{i}.npy").astype(
            np.float32))
    native_cache.pack(paths, (6, 5), str(tmp_path / "feats.lvrpack"))
    kw["packed_cache"] = str(tmp_path / "feats.lvrpack")
    want = jds.FeatureDataset(*args, jconv.get_template("plain"),
                              jpre.SimpleTokenizer(300), **kw)
    got = tds.FeatureDataset(*args, tconv.get_template("plain"),
                             tpre.SimpleTokenizer(300), **kw)
    for i in range(4):
        _assert_items_equal(got[i], want[i])
