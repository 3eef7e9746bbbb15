"""The port's feature extraction (`pipeline/features.py`,
`pipeline/runner.run_feature_extraction`, the `extract-features` command)
against the JAX package's on `debug/tiny-vit`, with the JAX weights carried
across, on the CPU in fp32.

Tolerance: each `.npy` within 1e-4 of the largest feature magnitude, the
bound `tests/test_torch_vit.py` holds the tower to; file names and
manifests equal.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.data.image_processing import (
    processor_for_tower as j_processor_for_tower)
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import vit as JV
from law_of_vision_representation_in_mllms_tpu.pipeline import (
    features as jfeat)
from law_of_vision_representation_in_mllms_tpu.pipeline.runner import (
    run_feature_extraction as j_run_feature_extraction)
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    DEFAULT_PRECISION, FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.data.image_processing import (
    processor_for_tower)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_torch.pipeline import (
    extract_tower_features, make_vit_extractor)
from law_of_vision_representation_in_mllms_torch.pipeline.runner import (
    run_feature_extraction)

torch.set_num_threads(1)

REL_TOL = 1e-4
TINY = {"model": {"vision_tower": "debug/tiny-vit", "decoder": "tiny"},
        "train": {"bf16": False}}


def _images(folder, n, seed=0):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        h, w = 20 + 7 * i, 50 - 4 * i
        path = os.path.join(folder, f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(path)
        paths.append(path)
    return paths


def _same_dumps(got_dir, want_dir):
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names
    n_npy = 0
    for name in names:
        if name.endswith(".json"):
            assert json.load(open(os.path.join(got_dir, name))) == \
                json.load(open(os.path.join(want_dir, name)))
            continue
        got = np.load(os.path.join(got_dir, name))
        want = np.load(os.path.join(want_dir, name))
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
        n_npy += 1
    return n_npy


def _jax_tower(seed=0):
    cfg = JV.ViTConfig(image_size=28, patch_size=7, hidden_size=32,
                       num_layers=3, num_heads=2, intermediate_size=64,
                       attn_impl="encoder")
    tower = JV.ViTTower(cfg, -2, "patch", J_FP32)
    params = tower.init(jax.random.PRNGKey(seed),
                        np.zeros((1, 28, 28, 3), np.float32))["params"]
    rng = np.random.RandomState(seed)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.1 * rng.randn(
        *x.shape).astype(np.float32), params)
    return cfg, params


@pytest.mark.parametrize("as_module", [False, True])
@pytest.mark.parametrize("pad_square", [False, True])
def test_extract_tower_features_matches_jax(tmp_path, as_module, pad_square):
    """5 images in batches of 2 (a padded tail), the same weights."""
    jcfg, params = _jax_tower()
    paths = _images(str(tmp_path / "imgs"), 5)
    jproc = j_processor_for_tower("debug/tiny-vit")
    want = str(tmp_path / "jax")
    jfn = jfeat.make_vit_extractor(jcfg, params, select_layer=-2,
                                   precision=J_FP32)
    jfeat.extract_tower_features(jfn, paths, jproc, want, batch_size=2,
                                 suffix="_t", pad_square=pad_square)

    cfg = TV.ViTConfig(image_size=28, patch_size=7, hidden_size=32,
                       num_layers=3, num_heads=2, intermediate_size=64)
    state = from_jax.vit_state_dict(params)
    source = state
    if as_module:
        # a whole tower: blocks past the selected layer are left out
        source = TV.ViTTower(cfg, -1, "patch", FP32_PRECISION)
        source.load_state_dict({**source.state_dict(), **state})
    fn = make_vit_extractor(cfg, source, select_layer=-2,
                            precision=FP32_PRECISION, device="cpu")
    got = str(tmp_path / "torch")
    written = extract_tower_features(
        fn, paths, processor_for_tower("debug/tiny-vit"), got, batch_size=2,
        suffix="_t", pad_square=pad_square)
    assert [os.path.basename(p) for p in written] == [
        f"im{i}_t.npy" for i in range(5)]
    assert _same_dumps(got, want) == 5
    assert np.load(written[0]).shape == (16, 32)


@pytest.mark.parametrize("select_layer,precision,as_is", [
    (-2, FP32_PRECISION, True),
    (-1, FP32_PRECISION, False),
    (-2, DEFAULT_PRECISION, False)])
def test_extractor_uses_a_fitting_tower_as_is(select_layer, precision,
                                               as_is):
    """A tower built with the extractor's arguments runs as it is; any
    other is copied into a tower of its own, with the same features as
    the JAX extractor's."""
    jcfg, params = _jax_tower(2)
    cfg = TV.ViTConfig(image_size=28, patch_size=7, hidden_size=32,
                       num_layers=3, num_heads=2, intermediate_size=64)
    source = TV.ViTTower(cfg, select_layer, "patch", precision)
    own = source.state_dict()
    source.load_state_dict({**own, **{
        k: v for k, v in from_jax.vit_state_dict(params).items()
        if k in own}})
    calls = []
    source.register_forward_hook(lambda *a: calls.append(1))
    fn = make_vit_extractor(cfg, source, select_layer=-2,
                            precision=FP32_PRECISION, device="cpu")
    pixels = np.random.RandomState(2).randn(3, 28, 28, 3).astype(np.float32)
    got = fn(pixels).numpy()
    assert len(calls) == (1 if as_is else 0)
    want = np.asarray(jfeat.make_vit_extractor(
        jcfg, params, select_layer=-2, precision=J_FP32)(pixels))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()


def test_extractor_shards_by_process(tmp_path):
    _, params = _jax_tower(1)
    cfg = TV.ViTConfig(image_size=28, patch_size=7, hidden_size=32,
                       num_layers=3, num_heads=2, intermediate_size=64)
    fn = make_vit_extractor(cfg, from_jax.vit_state_dict(params),
                            precision=FP32_PRECISION, device="cpu")
    paths = _images(str(tmp_path / "imgs"), 5, seed=1)
    proc = processor_for_tower("debug/tiny-vit")
    whole = extract_tower_features(fn, paths, proc, str(tmp_path / "a"),
                                   batch_size=4)
    parts = [extract_tower_features(fn, paths, proc, str(tmp_path / "b"),
                                    batch_size=4, process_index=i,
                                    process_count=2) for i in range(2)]
    assert [len(p) for p in parts] == [3, 2]
    assert json.load(open(tmp_path / "b" / "manifest_1.json")) == {
        "count": 2, "suffix": ""}
    for path in whole:
        other = str(tmp_path / "b" / os.path.basename(path))
        # another batch composition, the same tower: fp32 rounding only
        np.testing.assert_allclose(np.load(other), np.load(path),
                                   atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The tiny LLaVA the JAX runner builds from TINY's seed, saved as a
    `param_io` .npz for the port's `model.checkpoint`."""
    from law_of_vision_representation_in_mllms_tpu.train.runner import (
        build_model)
    _, params = build_model(JRunConfig.from_dict(TINY))
    path = str(tmp_path_factory.mktemp("ckpt") / "llava.npz")
    jio.save_params(path, params)
    return path


def test_run_feature_extraction_matches_jax(tmp_path, jax_checkpoint):
    folder = str(tmp_path / "imgs")
    _images(os.path.join(folder, "sub"), 3)
    Image.new("RGB", (31, 17), (9, 80, 200)).save(f"{folder}/a.jpg")
    want = str(tmp_path / "jax")
    assert j_run_feature_extraction(JRunConfig.from_dict(TINY), folder,
                                    want, batch_size=3) == 4
    cfg = RunConfig.from_dict({"model": dict(TINY["model"],
                                             checkpoint=jax_checkpoint),
                               "train": TINY["train"]})
    got = str(tmp_path / "torch")
    assert run_feature_extraction(cfg, folder, got, device="cpu",
                                  batch_size=3) == 4
    assert _same_dumps(got, want) == 4
    # a json list of paths, in its own order
    listing = str(tmp_path / "list.json")
    with open(listing, "w") as f:
        json.dump([f"{folder}/sub/im2.png", f"{folder}/a.jpg"], f)
    assert run_feature_extraction(cfg, listing, str(tmp_path / "l"),
                                  device="cpu", suffix="_x") == 2
    assert sorted(os.listdir(tmp_path / "l")) == [
        "a_x.npy", "im2_x.npy", "manifest_0.json"]


def test_unsupported_towers_raise(tmp_path):
    # every diffusion tower is ported (tests/test_torch_diffusion_cli.py,
    # tests/test_torch_dit_mmdit.py); without a bundle in
    # model.tower_weights it has no weights and refuses to run
    folder = str(tmp_path / "imgs")
    _images(folder, 1, seed=3)
    for name in ("facebook/DiT-XL-2-512",
                 "stabilityai/stable-diffusion-3-medium-diffusers"):
        with pytest.raises(ValueError, match="has no params"):
            run_feature_extraction(RunConfig.from_dict({"model": {
                "vision_tower": name, "decoder": "tiny"},
                "train": {"bf16": False}}),
                folder, str(tmp_path / "o"), device="cpu")
    with pytest.raises(ValueError, match="precomputed-feature"):
        run_feature_extraction(RunConfig.from_dict({"model": {
            "vision_tower": "runwayml/stable-diffusion-v1-5_feature",
            "decoder": "tiny"}, "train": {"bf16": False}}),
            str(tmp_path), str(tmp_path / "o"), device="cpu")


def test_extract_features_command_matches_jax(tmp_path, jax_checkpoint,
                                              capsys):
    folder = str(tmp_path / "imgs")
    _images(folder, 3, seed=2)
    config = str(tmp_path / "run.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(TINY, f)
    want = str(tmp_path / "jax")
    assert jcli.main(["extract-features", "--config", config, "--images",
                      folder, "--out-dir", want, "--batch-size", "2"]) == 0
    assert capsys.readouterr().out.strip() == \
        f"extracted 3 feature files to {want}"
    got = str(tmp_path / "torch")
    assert cli.main(["extract-features", "--config", config, "--images",
                     folder, "--out-dir", got, "--batch-size", "2",
                     "--set", f"model.checkpoint={jax_checkpoint}",
                     "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == \
        f"extracted 3 feature files to {got}"
    assert _same_dumps(got, want) == 3
