"""The port's SAM (`models/sam.py`), its porter (`io.hf_port.port_sam`,
`sam_config_from_hf` on a snapshot's config.json) and `sam-masks`
(`pipeline/sam_masks.py`) against the JAX package's and transformers'
`SamModel`, on the CPU in fp32, on the JAX tests' tiny configs.

The tiny models' weights are drawn anew from a seeded numpy generator
(transformers initialises SAM's with a std of 1e-10, which leaves logits of
~1e-5). Tolerances: the port against the JAX functions within 1e-5 of the
largest value (fp32 sums in another order); against transformers at the
JAX golden tests' 2e-4 / 5e-4 (its attention sums in another way); masks
equal to the JAX ones but at pixels whose logit lies within 1e-4 of 0.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.io import hf_port as TH
from law_of_vision_representation_in_mllms_torch.models import sam as TS
from law_of_vision_representation_in_mllms_torch.pipeline import (
    geoware as TG, sam_masks as TP)
from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.io import hf_port as JH
from law_of_vision_representation_in_mllms_tpu.models import sam as JS
from test_sam import _tiny_hf

pytest.importorskip("transformers")

torch.set_num_threads(1)

TOL = 1e-5
LOGIT_TIE = 1e-4


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


def tiny(seed: int, window: int = 2, global_idx=(1,)):
    """(HF SamModel with seeded N(0, 0.1)-scale weights, its config.json
    dict, the JAX config, the port's config)."""
    model, _ = _tiny_hf(seed=seed, window=window, global_idx=global_idx)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.state_dict().items():
            x = rng.standard_normal(p.shape).astype(np.float32)
            if "norm" in name and name.endswith("weight"):
                x = 1.0 + 0.1 * x
            elif p.dim() >= 2:
                x = x / np.sqrt(np.prod(p.shape[1:]))
            else:
                x = 0.1 * x
            p.copy_(torch.from_numpy(x))
    config = json.loads(model.config.to_json_string())
    return (model.eval(), config, JH.sam_config_from_hf(model.config),
            TH.sam_config_from_hf(config))


def port_model(tree, cfg) -> TS.SamModel:
    model = TS.SamModel(cfg)
    model.load_state_dict(from_jax.sam_state_dict(tree))
    return model.eval()


@pytest.mark.parametrize("window,global_idx", [(2, (1,)), (4, (0, 1))])
def test_sam_encoder_matches_jax_and_hf(window, global_idx):
    """Windowed + global layers, and both global with another window
    size (the rel-pos tables of either kind)."""
    hf, _, jcfg, tcfg = tiny(80 + window, window, global_idx)
    tree = JH.port_sam(hf.state_dict(), jcfg)
    px = np.random.RandomState(81).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        got = port_model(tree, tcfg).encode_image(torch.from_numpy(px))
        want_hf = hf.get_image_embeddings(
            torch.from_numpy(px).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, jax.jit(lambda t, x: JS.encode_image(t, jcfg, x))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(px)))
    np.testing.assert_allclose(got.numpy(), want_hf.numpy(), atol=2e-4,
                               rtol=1e-3)


@pytest.mark.parametrize("multimask", [False, True])
def test_sam_segment_matches_jax_and_hf(multimask):
    hf, _, jcfg, tcfg = tiny(82)
    tree = JH.port_sam(hf.state_dict(), jcfg)
    px = np.random.RandomState(83).randn(1, 64, 64, 3).astype(np.float32)
    boxes = np.array([[[4.0, 6.0, 40.0, 50.0], [10.0, 10.0, 30.0, 28.0]]],
                     np.float32)
    masks, iou = TS.segment(port_model(tree, tcfg), torch.from_numpy(px),
                            torch.from_numpy(boxes), multimask)
    jm, ji = jax.jit(lambda t, x, b: JS.segment(
        t, jcfg, x, b, multimask_output=multimask))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(px), jnp.asarray(boxes))
    assert masks.shape == (1, 2, 3 if multimask else 1, 32, 32)
    close(masks, jm)
    close(iou, ji)
    with torch.no_grad():
        out = hf(pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2),
                 input_boxes=torch.from_numpy(boxes),
                 multimask_output=multimask)
    np.testing.assert_allclose(masks.numpy(), out.pred_masks.numpy(),
                               atol=5e-4, rtol=1e-3)
    np.testing.assert_allclose(iou.numpy(), out.iou_scores.numpy(),
                               atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("input_hw,original_hw", [
    ((48, 32), (96, 64)),       # the crop, then an upsample
    ((64, 64), (60, 60)),       # a shrink (GeoAware's 1,024 -> 960)
    ((64, 64), (40, 80)),       # one axis shrinks, one grows
])
def test_postprocess_mask_matches_jax(input_hw, original_hw):
    low = np.random.RandomState(84).randn(32, 32).astype(np.float32)
    want = np.asarray(JS.postprocess_mask(jnp.asarray(low), input_hw,
                                          original_hw, image_size=64))
    logits = TS.mask_logits(torch.from_numpy(low), input_hw, original_hw,
                            image_size=64)
    got = TS.postprocess_mask(torch.from_numpy(low), input_hw, original_hw,
                              image_size=64).numpy()
    assert got.shape == tuple(original_hw) and got.dtype == bool
    np.testing.assert_array_equal(got, logits.numpy() > 0)
    differ = got != want
    assert np.all(np.abs(logits.numpy()[differ]) < LOGIT_TIE)


def test_sam_config_and_state_dict_round_trip():
    hf, config, jcfg, tcfg = tiny(85)
    got = dataclasses.asdict(tcfg)
    assert got.pop("attention_downsample_rate") == 2
    assert got == dataclasses.asdict(jcfg)
    # a config.json that leaves keys out takes transformers' defaults
    assert TH.sam_config_from_hf({}) == TS.sam_vit_b()
    tree = TH.port_sam(hf.state_dict(), tcfg)
    back = from_jax.sam_tree(port_model(tree, tcfg).state_dict())
    from chip_smoke import flat_tree
    want, got = flat_tree(tree), flat_tree(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def _dataset(root):
    """Two images (landscape, portrait) with SPair `bndbox` annotations."""
    from PIL import Image
    rng = np.random.RandomState(86)
    for name, (w, h) in (("a0", (80, 60)), ("a1", (50, 70))):
        for sub in ("JPEGImages", "ImageAnnotation"):
            os.makedirs(root / sub / "cat", exist_ok=True)
        coarse = rng.randint(0, 256, (6, 6, 3), np.uint8)
        Image.fromarray(coarse).resize((w, h)).save(
            root / "JPEGImages" / "cat" / f"{name}.jpg")
        with open(root / "ImageAnnotation" / "cat" / f"{name}.json",
                  "w") as f:
            json.dump({"bndbox": [5, 8, w - 10, h - 6]}, f)


def test_sam_masks_cli_matches_jax(tmp_path):
    """`sam-masks` of both packages on one snapshot: the same files, masks
    equal but at near-zero logits, each flip the mirror."""
    from PIL import Image
    hf, _, _, tcfg = tiny(87)
    snap = tmp_path / "snap"
    hf.save_pretrained(snap)
    data = {}
    for name in ("jax", "port"):
        _dataset(tmp_path / name)
        data[name] = tmp_path / name
    argv = ["sam-masks", "--snapshot", str(snap), "--anno-size", "64",
            "--spair"]
    assert jcli.main(argv + ["--images",
                             str(data["jax"] / "JPEGImages")]) == 0
    assert cli.main(argv + ["--images", str(data["port"] / "JPEGImages"),
                            "--device", "cpu"]) == 0
    model = port_model(TH.port_sam(hf.state_dict(), tcfg), tcfg)
    for stem in ("a0", "a1"):
        feats = {k: v / "features" / "cat" for k, v in data.items()}
        got = np.asarray(Image.open(feats["port"] / f"{stem}_mask.png"))
        want = np.asarray(Image.open(feats["jax"] / f"{stem}_mask.png"))
        assert got.shape == (64, 64) and set(np.unique(got)) <= {0, 255}
        np.testing.assert_array_equal(
            np.asarray(Image.open(feats["port"] / f"{stem}_mask_flip.png")),
            got[:, ::-1])
        # the port's logits of this image, through the pipeline's steps
        img = Image.open(data["port"] / "JPEGImages" / "cat" / f"{stem}.jpg")
        canvas = TG.load_square(img, 64)
        with open(data["port"] / "ImageAnnotation" / "cat"
                  / f"{stem}.json") as f:
            box = TP.pad_box(json.load(f)["bndbox"], img.size, 64)
        logits = TP.segment_box(model, canvas, box)
        np.testing.assert_array_equal((logits > 0) * 255, got)
        assert np.all(np.abs(logits[got != want]) < LOGIT_TIE)
    shutil.rmtree(snap)


def test_chip_smoke_sam_snapshot_has_hf_keys():
    """`chip_smoke.sam_snapshot_tensors` (phase 16's SAM ViT-H snapshot)
    writes transformers' key names and shapes, and `port_sam` reads it."""
    from chip_smoke import _Init, sam_snapshot_tensors
    hf, config, _, tcfg = tiny(88)
    sd = sam_snapshot_tensors(config, _Init(torch.device("cpu"), 0))
    want = hf.state_dict()
    assert sorted(sd) == sorted(want)
    for k, v in want.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    port_model(TH.port_sam(sd, tcfg), tcfg)
