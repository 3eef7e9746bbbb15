"""A diffusion tower (UNet family, DiT, SD3) through the port's commands,
against the JAX package's commands on the same featurizer bundle, on the CPU
in fp32
(`tests/test_diffusion_cli.py` with a bundle of the JAX modules' own
parameters in place of a diffusers snapshot).

- `extract-features` + `c-score` on a synthetic SPair tree: every feature
  file within 1e-4 of the largest feature magnitude, the C scores within
  `C_TOL`;
- `eval` on a tiny multiple-choice task: the same score;
- stage-1 training from images: the runners' losses, gradient norms and
  projectors as `tests/test_torch_train.py` holds them.

The port takes the JAX model's projector and decoder as a `param_io` .npz
(`model.checkpoint`), as the port's other CLI tests do, and the tower from
the bundle in `model.tower_weights`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.eval.tasks import (
    task_yaml as j_task_yaml)
from law_of_vision_representation_in_mllms_tpu.io import (
    featurizer_bundle as JFB)
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import featurizer as JF
from law_of_vision_representation_in_mllms_tpu.train import (
    runner as jrunner)
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.models import (
    featurizer as TF, llava as TM)
from law_of_vision_representation_in_mllms_torch.train import runner
from test_spair import _make_synthetic_spair
import test_torch_dit_mmdit as DM
from test_torch_featurizer import jax_config, jax_tree
from test_torch_train import _check_run, _jax_tree_np, _run_both, _write_data

torch.set_num_threads(1)

SD15 = "runwayml/stable-diffusion-v1-5"
IMG = 16                         # latent 8, up block 0 at 8 x 8: 64 tokens
FEAT_REL_TOL = 1e-4
# PCK over the same correctness, fp32 aggregates in another order
C_TOL = 1e-6


# tower name -> its tiny stand-in (head size 10 throughout)
TOWERS = {
    SD15: lambda: jax_config("sd"),
    # linear projections and upcast attention, as SD2.1's UNet
    "stabilityai/stable-diffusion-2-1": lambda: dataclasses.replace(
        jax_config("sd"), unet=dataclasses.replace(
            jax_config("sd").unet, use_linear_projection=True,
            upcast_attention=True)),
    "stabilityai/stable-diffusion-xl-base-1.0": lambda: jax_config("sdxl"),
    # the JAX tiny DiT and MMDiT (head size 8) at 32 px: 4 x 4 tokens after
    # the 2x2 unfold
    DM.DIT: lambda: DM.jax_config("dit", img_size=32),
    DM.SD3: lambda: DM.jax_config("sd3", img_size=32),
}
# the towers of the eval and train tests: a UNet, DiT and SD3
EVAL_TOWERS = [SD15, DM.DIT, DM.SD3]


def _jcfg(name=SD15):
    """`name`'s tiny stand-in: the UNets at 16 px (8 x 8 tokens)."""
    jcfg = TOWERS[name]()
    if jcfg.family in ("dit", "sd3"):
        return jcfg
    return dataclasses.replace(jcfg, img_size=IMG)


def _bundle(folder, name=SD15):
    """A JAX featurizer bundle (`save_featurizer_bundle`) of `name`'s tiny
    stand-in."""
    jcfg = _jcfg(name)
    tree = (DM.jax_tree if jcfg.family in ("dit", "sd3") else jax_tree)(
        jcfg, 7)
    return JFB.save_featurizer_bundle(str(folder / "tower"), tree, jcfg)


def _raw(bundle, name=SD15, **sections):
    raw = {"model": {"vision_tower": name, "decoder": "tiny",
                     "tower_weights": [bundle]},
           "train": {"bf16": False}}
    for key, value in sections.items():
        raw.setdefault(key, {}).update(value)
    return raw


def _checkpoint(folder, raw):
    """The JAX model of `raw` (its seed, the bundle's tower) as a
    `param_io` .npz for the port's `model.checkpoint`."""
    _, params = jrunner.build_model(JRunConfig.from_dict(raw))
    path = str(folder / "llava.npz")
    jio.save_params(path, _jax_tree_np(params))
    return path


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return _bundle(tmp_path_factory.mktemp("bundle"))


def _yaml(path, raw):
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return str(path)


def test_build_model_takes_the_bundle(bundle):
    """The sidecar's configuration sets the entry's grid and width, the
    tower is the bundle's, and a tower without one refuses to run."""
    model_cfg, params = runner.build_model(
        RunConfig.from_dict(_raw(bundle)), device="cpu")
    e = model_cfg.tower_spec.entries[0]
    assert (e.kind, e.num_patches, e.hidden_size, e.img_size) == (
        "diffusion", 64, 40, IMG)
    assert isinstance(params.towers[0], TF.FeaturizerParams)
    fcfg = model_cfg.featurizer_overrides[SD15]
    assert TF.feature_grid(fcfg) ** 2 == e.num_patches
    raw = _raw(bundle)
    del raw["model"]["tower_weights"]
    model_cfg, params = runner.build_model(RunConfig.from_dict(raw),
                                           device="cpu")
    assert model_cfg.tower_spec.entries[0].num_patches == 576
    with pytest.raises(ValueError, match="has no params"):
        TM.encode_images(params, model_cfg, [torch.zeros(1, 768, 768, 3)])
    raw["model"]["diffusion_attn_impl"] = "xla_blocked"
    with pytest.raises(ValueError, match="diffusion_attn_impl"):
        runner.build_model(RunConfig.from_dict(raw), device="cpu")


@pytest.mark.parametrize("name", list(TOWERS))
def test_extract_features_and_c_score_match_jax(tmp_path, name, capsys):
    bundle = _bundle(tmp_path, name)
    jax_checkpoint = _checkpoint(tmp_path, _raw(bundle, name))
    root = str(tmp_path / "SPair-71k")
    _make_synthetic_spair(root, n_pairs=3)
    img_dir = f"{root}/JPEGImages/cat"
    for idx in range(6):
        Image.new("RGB", (64, 48), (10 * idx, 80, 30)).save(
            f"{img_dir}/img{idx}.jpg")
    config = _yaml(tmp_path / "run.yaml", _raw(bundle, name))
    want = str(tmp_path / "jax")
    assert jcli.main(["extract-features", "--config", config, "--images",
                      img_dir, "--out-dir", want, "--batch-size", "4"]) == 0
    got = str(tmp_path / "torch")
    assert cli.main(["extract-features", "--config", config, "--images",
                     img_dir, "--out-dir", got, "--batch-size", "4",
                     "--set", f"model.checkpoint={jax_checkpoint}",
                     "--device", "cpu"]) == 0
    files = sorted(n for n in os.listdir(want) if n.endswith(".npy"))
    assert files == sorted(n for n in os.listdir(got) if n.endswith(".npy"))
    assert len(files) == 6
    jcfg = _jcfg(name)
    grid, dim = JF.feature_grid(jcfg), JF.feature_dim(jcfg)
    for f in files:
        a, b = np.load(f"{got}/{f}"), np.load(f"{want}/{f}")
        assert a.shape == b.shape == (grid * grid, dim)
        assert np.abs(a - b).max() <= FEAT_REL_TOL * np.abs(b).max()
    # deterministic featurization: a second run gives the same bits
    again = str(tmp_path / "torch2")
    assert cli.main(["extract-features", "--config", config, "--images",
                     img_dir, "--out-dir", again, "--batch-size", "4",
                     "--device", "cpu"]) == 0
    for f in files:
        np.testing.assert_array_equal(np.load(f"{again}/{f}"),
                                      np.load(f"{got}/{f}"))
    capsys.readouterr()
    scores = []
    for main, feats, extra in ((jcli.main, want, []),
                               (cli.main, got, ["--device", "cpu"])):
        assert main(["c-score", "--spair-dir", root, "--feature-dir", feats,
                     "--num-patches", str(grid), "--anno-size", "64",
                     "--categories", "cat", *extra]) == 0
        scores.append(json.loads(capsys.readouterr().out))
    want_s, got_s = scores
    assert sorted(got_s) == sorted(want_s)
    for key in want_s:
        np.testing.assert_allclose(got_s[key], want_s[key], atol=C_TOL)


@pytest.mark.parametrize("name", EVAL_TOWERS)
def test_eval_matches_jax(tmp_path, name):
    bundle = _bundle(tmp_path, name)
    jax_checkpoint = _checkpoint(tmp_path, _raw(bundle, name))
    tokens = JF.feature_grid(_jcfg(name)) ** 2
    docs = [{"question": "Shape?", "options": ["circle", "square"],
             "answer": "A"},
            {"question": "Color?", "options": ["red", "blue"],
             "answer": "B"}]
    d = tmp_path / "t"
    os.makedirs(d)
    with open(d / "q.json", "w") as f:
        json.dump(docs, f)
    with open(j_task_yaml("mmbench_en")) as f:
        tcfg = yaml.safe_load(f)
    tcfg["dataset_path"] = str(d / "q.json")
    tcfg["image_root"] = str(d)
    task = _yaml(d / "task.yaml", tcfg)
    config = _yaml(tmp_path / "run.yaml", _raw(bundle, name))
    out = {}
    for tag, main, extra in (
            ("jax", jcli.main, []),
            ("torch", cli.main, ["--set",
                                 f"model.checkpoint={jax_checkpoint}",
                                 "--device", "cpu"])):
        out[tag] = str(tmp_path / f"{tag}.json")
        assert main(["eval", "--config", config, "--tasks", task,
                     "--output", out[tag], *extra]) == 0
    want = json.load(open(out["jax"]))["mmbench_en"]
    got = json.load(open(out["torch"]))["mmbench_en"]
    assert got["value"] == want["value"] and got["n"] == want["n"] == 2
    # the A-score embedding dump of the same docs
    dumps = {}
    for tag, main, extra in (
            ("jax", jcli.main, []),
            ("torch", cli.main, ["--set",
                                 f"model.checkpoint={jax_checkpoint}",
                                 "--device", "cpu"])):
        dumps[tag] = str(tmp_path / f"{tag}_embeds")
        assert main(["extract-embeds", "--config", config, "--task", task,
                     "--out-dir", dumps[tag], "--limit", "2", *extra]) == 0
    for i in (1, 2):
        a = np.load(f"{dumps['torch']}/tensor_{i}.npy")
        b = np.load(f"{dumps['jax']}/tensor_{i}.npy")
        assert a.shape == b.shape == (tokens, 64)
        assert np.abs(a - b).max() <= FEAT_REL_TOL * np.abs(b).max()


@pytest.mark.parametrize("name", EVAL_TOWERS)
def test_train_stage1_matches_jax(tmp_path, name):
    """Stage 1 from PNGs through the frozen tower: both runners from the JAX
    runner's weights, 3 steps."""
    bundle = _bundle(tmp_path, name)
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (30 + 6 * i, 28, 3),
                                    dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    raw = _raw(bundle, name,
               train={"stage": 1, "batch_size": 2, "epochs": 1,
                      "max_length": 64, "learning_rate": 1e-2,
                      "output_dir": str(tmp_path / "out"),
                      "save_steps": 1000},
               data={"data_path": _write_data(tmp_path),
                     "image_folder": str(tmp_path)},
               parallel={"n_data": 1, "n_model": 1})
    _check_run(*_run_both(tmp_path, raw))
