"""The port's native feature loader (`io/native_cache.py`) against its numpy
readers and the JAX package's `io/native_cache.py`: the library's build into
`build/torch_native/`, `batch_load`, packs written by either package read by
the other, `FeatureDataset(packed_cache=...)` and `run_c_score`'s reads
(`tests/test_native_cache.py`'s cases on the port)."""

import json
from pathlib import Path

import numpy as np
import pytest

from law_of_vision_representation_in_mllms_tpu.io import native_cache as jnc
from law_of_vision_representation_in_mllms_torch.io import native_cache as nc

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    """Seven fp32 [6, 16] files and three fp16 [4, 3, 5] files."""
    d = tmp_path_factory.mktemp("feats")
    rng = np.random.RandomState(0)
    out = {}
    for name, shape, dtype, n in (("f32", (6, 16), np.float32, 7),
                                  ("f16", (4, 3, 5), np.float16, 3)):
        paths, ref = [], []
        for i in range(n):
            a = rng.randn(*shape).astype(dtype)
            paths.append(str(d / f"{name}_{i}.npy"))
            np.save(paths[-1], a)
            ref.append(a)
        out[name] = (paths, np.stack(ref))
    return out


def test_library_builds_into_build_dir():
    assert nc.native_available()
    path = nc.build()
    assert path == nc.library_path() and path.is_file()
    assert path.parent == REPO / "build" / "torch_native"
    assert nc.SOURCE == REPO / "native" / "lvr_loader.cpp"
    # another source or other flags give another file name
    assert path.name.startswith("liblvr_loader_") and len(path.stem) == 30


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(nc, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(nc, "CXX_FLAGS",
                        nc.CXX_FLAGS + ("-DLVR_BROKEN", "-include",
                                        str(tmp_path / "missing.h")))
    with pytest.raises(RuntimeError, match="missing.h"):
        nc.build()
    assert not list(tmp_path.glob("*.so"))


@pytest.mark.parametrize("name", ["f32", "f16"])
def test_batch_load_matches_numpy_and_jax(npy_files, name):
    paths, ref = npy_files[name]
    shape, dtype = ref.shape[1:], ref.dtype
    got = nc.batch_load(paths, shape, dtype, n_threads=3)
    assert got.dtype == dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, nc.numpy_batch_load(paths, shape,
                                                           dtype))
    np.testing.assert_array_equal(got, jnc.batch_load(paths, shape, dtype))
    assert nc.batch_load([], shape, dtype).shape == (0, *shape)


def test_batch_load_missing_file_raises(npy_files, tmp_path):
    paths, ref = npy_files["f32"]
    with pytest.raises(IOError, match="1 of 3 files"):
        nc.batch_load(paths[:2] + [str(tmp_path / "nope.npy")], (6, 16))


@pytest.mark.parametrize("name", ["f32", "f16"])
def test_packs_read_in_both_packages(npy_files, tmp_path, name):
    """A pack the port writes is the JAX package's pack byte for byte, and
    each package gathers the other's items."""
    paths, ref = npy_files[name]
    shape, dtype = ref.shape[1:], ref.dtype
    mine, theirs = str(tmp_path / "port.lvrpack"), str(tmp_path /
                                                        "jax.lvrpack")
    nc.pack(paths, shape, mine, dtype)
    jnc.pack(paths, shape, theirs, dtype)
    raw = Path(mine).read_bytes()
    assert raw == Path(theirs).read_bytes()
    assert np.frombuffer(raw[:24], "<u8").tolist() == [
        nc.MAGIC, len(paths), ref[0].nbytes]
    idx = [len(paths) - 1, 0, 1, 0]
    for path, other in ((mine, jnc), (theirs, nc)):
        cache = other.PackedCache(path, shape, dtype)
        assert cache.count == len(paths)
        np.testing.assert_array_equal(cache.gather(idx), ref[idx])
        cache.close()
        np.testing.assert_array_equal(
            nc.numpy_gather(path, idx, shape, dtype), ref[idx])


def test_packed_cache_refuses_what_it_cannot_read(npy_files, tmp_path):
    paths, ref = npy_files["f32"]
    path = str(tmp_path / "c.lvrpack")
    nc.pack(paths, (6, 16), path)
    with pytest.raises(ValueError, match="bytes"):
        nc.PackedCache(path, (6, 8))
    cache = nc.PackedCache(path, (6, 16))
    with pytest.raises(IOError, match="gather failed"):
        cache.gather([0, 7])
    cache.close()
    cache.close()                      # a second close is a no-op
    with pytest.raises(IOError, match="cannot open"):
        nc.PackedCache(paths[0], (6, 16))     # an .npy, not a pack


def test_feature_dataset_packed_cache_matches_jax(tmp_path):
    """`FeatureDataset(packed_cache=...)`, with the default index (the
    records' order of first mention) and an explicit one, gives the JAX
    dataset's items and the per-file dataset's features."""
    from law_of_vision_representation_in_mllms_tpu.data import (
        FeatureDataset as JFeatureDataset)
    from law_of_vision_representation_in_mllms_tpu.data import (
        SimpleTokenizer as JTokenizer)
    from law_of_vision_representation_in_mllms_tpu.data import (
        get_template as j_template)
    from law_of_vision_representation_in_mllms_torch.data import (
        FeatureDataset, SimpleTokenizer, get_template)

    rng = np.random.RandomState(1)
    feats = [rng.randn(8, 16).astype(np.float32) for _ in range(3)]
    paths = []
    for i, f in enumerate(feats):
        paths.append(str(tmp_path / f"s{i}.npy"))
        np.save(paths[-1], f)
    images = ["s1.jpg", "s0.jpg", None, "s1.jpg", "s2.jpg"]
    recs = [{"conversations": [{"from": "human", "value": "<image>\nq"
                                if im else "q"},
                               {"from": "gpt", "value": "a"}],
             **({"image": im} if im else {})} for im in images]
    (tmp_path / "d.json").write_text(json.dumps(recs))
    data = str(tmp_path / "d.json")
    order = [1, 0, 2]                         # first mention: s1, s0, s2
    pack = str(tmp_path / "train.lvrpack")
    nc.pack([paths[i] for i in order], (8, 16), pack)
    kw = dict(feature_shape=(8, 16), packed_cache=pack)
    got = FeatureDataset(data, "", get_template("v1"), SimpleTokenizer(),
                         **kw)
    want = JFeatureDataset(data, "", j_template("v1"), JTokenizer(), **kw)
    per_file = FeatureDataset(data, str(tmp_path), get_template("v1"),
                              SimpleTokenizer(), feature_shape=(8, 16))
    for i in range(len(recs)):
        g, w = got[i], want[i]
        np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
        np.testing.assert_array_equal(g["pixel_values"][0],
                                      w["pixel_values"][0])
        np.testing.assert_array_equal(g["pixel_values"][0],
                                      per_file[i]["pixel_values"][0])
        assert g["pixel_values"][0].dtype == np.float32
    # an explicit stem -> row index
    nc.pack(paths, (8, 16), pack)
    index = {"s0": 0, "s1": 1, "s2": 2}
    got = FeatureDataset(data, "", get_template("v1"), SimpleTokenizer(),
                         pack_index=index, **kw)
    for i in (0, 1, 4):
        np.testing.assert_array_equal(got[i]["pixel_values"][0],
                                      per_file[i]["pixel_values"][0])


def test_run_c_score_reads_through_batch_load(tmp_path, monkeypatch):
    """`run_c_score` reads each category's features with one `batch_load`
    call a feature set, and its result is the JAX runner's."""
    from law_of_vision_representation_in_mllms_tpu.pipeline.c_score_run \
        import run_c_score as j_run_c_score
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        c_score_run)
    from test_torch_c_score import (ANNO, CATS, NUM_PATCHES, _same_result,
                                    _spair_tree)
    root = str(tmp_path / "SPair-71k")
    feats = _spair_tree(root)
    calls = []

    def spy(paths, shape, dtype, **kw):
        calls.append((len(paths), shape, dtype))
        got = nc.batch_load(paths, shape, dtype, **kw)
        np.testing.assert_array_equal(
            got, nc.numpy_batch_load(paths, shape, dtype))
        return got
    monkeypatch.setattr(c_score_run, "batch_load", spy)
    kw = dict(num_patches=NUM_PATCHES, anno_size=ANNO, categories=CATS,
              suffix2="_b")
    got = c_score_run.run_c_score(root, feats, device="cpu", **kw)
    _same_result(got, j_run_c_score(root, feats, **kw))
    # two categories x two feature sets, each of a category's 12 images
    assert len(calls) == 4 and all(c[0] == 12 for c in calls)
    assert {c[1] for c in calls} == {(NUM_PATCHES ** 2, 12),
                                     (NUM_PATCHES ** 2, 5)}
    assert all(c[2] == np.float32 for c in calls)
