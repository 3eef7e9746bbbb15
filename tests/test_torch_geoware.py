"""The port's GeoAware-SC pieces against the JAX package's, on the CPU in
fp32 on the same seeded numpy inputs: the multi-scale SD harvest
(`models.featurizer.extract_multiscale_features`), the DINOv2 facets
(`models/facet.py`), co-PCA and the pose protocol
(`metrics/geoware_extras.py`), the `preprocess-map` and `pose-awareness`
commands end to end (`pipeline/geoware.py`), and deformable attention
(`ops/deformable_attention.py`).

Tolerances: maps, facets and descriptors within 1e-5 of the largest value
(fp32 sums in another order), the commands' files within 1e-5 in norm and
1e-4 of the largest value (the JAX command jit-compiles: XLA fuses and
reorders the sums of a VAE and a UNet); co-PCA components carry an SVD's
sign, so it is held by its sign-free distances (within 1e-5 relative);
distances and the pose results within 1e-5, masks and votes exactly.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as TF

from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION as T_FP32)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.metrics import (
    geoware_extras as TG)
from law_of_vision_representation_in_mllms_torch.models import facet as TFa
from law_of_vision_representation_in_mllms_torch.models import (
    featurizer as TFe)
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_torch.ops import (
    deformable_attention as TD)
from law_of_vision_representation_in_mllms_torch.pipeline import (
    geoware as TP)
from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.io.featurizer_bundle import (
    save_featurizer_bundle)
from law_of_vision_representation_in_mllms_tpu.io.param_io import (
    save_params)
from law_of_vision_representation_in_mllms_tpu.metrics import (
    geoware_extras as JG)
from law_of_vision_representation_in_mllms_tpu.models import facet as JFa
from law_of_vision_representation_in_mllms_tpu.models import (
    featurizer as JFe)
from law_of_vision_representation_in_mllms_tpu.models import unet as JU
from law_of_vision_representation_in_mllms_tpu.models import vae as JVAE
from law_of_vision_representation_in_mllms_tpu.models import vit as JV
from law_of_vision_representation_in_mllms_tpu.ops import (
    deformable_attention as JD)
from law_of_vision_representation_in_mllms_tpu.pipeline import (
    geoware as JP)
from test_deformable_attention import _torch_oracle
from test_torch_diffusion_blocks import flax_params, rand

torch.set_num_threads(1)

TOL = 1e-5
SD_IMG = 32                 # latent 16: s5 / s4 / s3 grids 4 / 8 / 16
DINO_TOWER = "debug/tiny-vit-112"       # a 16 x 16 grid at patch 7
TINY_VIT = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=3,
                num_heads=4, intermediate_size=64)


def close_norm(got, want, tol=TOL):
    """||got - want|| / ||want|| within `tol`, and every value within 10 x
    `tol` of the largest: a whole map through a VAE and a UNet, where one
    of thousands of values may carry a few more fp32 roundings."""
    want = np.asarray(want, np.float64)
    diff = np.asarray(got, np.float64) - want
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.linalg.norm(diff) <= tol * np.linalg.norm(want)
    assert np.abs(diff).max() <= 10 * tol * np.abs(want).max()


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(1.0, np.abs(want).max()))


# ---------------------------------------------------------------------------
# the tiny SD featurizer (three resolutions) and DINO tower
# ---------------------------------------------------------------------------

def sd_config() -> JFe.FeaturizerConfig:
    return JFe.FeaturizerConfig(
        family="sd", t=1, up_ft_index=2, img_size=SD_IMG,
        unet=JU.UNetConfig(block_out_channels=(8, 16, 16),
                           layers_per_block=1, cross_attention_dim=16,
                           num_heads=(2, None, None),
                           transformer_depth=(1, 0, 0), norm_groups=4),
        vae=JVAE.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                           latent_channels=4, norm_groups=4))


@functools.lru_cache(maxsize=None)
def sd_tree(seed: int = 60) -> dict:
    cfg = sd_config()
    latent = jnp.zeros((1, SD_IMG // 2, SD_IMG // 2, 4))
    return {
        "vae": flax_params(JVAE.VAEEncoder(cfg.vae, J_FP32), seed,
                           jnp.zeros((1, SD_IMG, SD_IMG, 3))),
        "backbone": flax_params(
            JU.UNetHarvest(cfg.unet, up_ft_indices=(), precision=J_FP32,
                           pre_up_indices=(0, 1, 2)), seed + 1, latent, 1,
            jnp.zeros((1, 5, 16))),
        "prompt_embeds": rand(seed + 2, 1, 5, 16)}


@functools.lru_cache(maxsize=None)
def dino_tree(seed: int = 61) -> dict:
    cfg = JV.VIT_PRESETS[DINO_TOWER]()
    return flax_params(JV.ViTEncoder(cfg, J_FP32), seed,
                       jnp.zeros((1, cfg.image_size, cfg.image_size, 3)))


def port_encoder(tree, cfg: TV.ViTConfig) -> TV.ViTEncoder:
    enc = TV.ViTEncoder(cfg, T_FP32)
    enc.load_state_dict({k[len("encoder."):]: v for k, v in
                         from_jax.vit_state_dict(tree).items()})
    return enc.eval()


def port_vit_config(jcfg) -> TV.ViTConfig:
    return TV.ViTConfig(**{k: getattr(jcfg, k) for k in
                           TV.ViTConfig.__dataclass_fields__})


def test_extract_multiscale_features_matches_jax():
    jcfg = sd_config()
    tcfg = TFe.config_from_dict(JFe.config_to_dict(jcfg))
    tree = sd_tree()
    px = np.tanh(rand(62, 2, SD_IMG, SD_IMG, 3))
    want = jax.jit(lambda tr, x: JFe.extract_multiscale_features(
        tr, jcfg, x, deterministic=True, precision=J_FP32))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(px))
    params = TFe.FeaturizerParams.for_state_dict(
        from_jax.featurizer_state_dict(tree), tcfg, T_FP32)
    got = TFe.extract_multiscale_features(params, tcfg, torch.from_numpy(px),
                                          deterministic=True)
    assert [tuple(got[k].shape) for k in ("s5", "s4", "s3")] == [
        (2, 4, 4, 16), (2, 8, 8, 16), (2, 16, 16, 8)]
    for k in ("s3", "s4", "s5"):
        close(got[k], want[k])
    with pytest.raises(ValueError, match="UNet-family"):
        TFe.extract_multiscale_features(
            params, TFe.FeaturizerConfig(family="dit"), None)


# ---------------------------------------------------------------------------
# facets
# ---------------------------------------------------------------------------

FACET_VIT = JV.ViTConfig(hidden_act="gelu", layer_norm_eps=1e-6,
                         use_class_token=True, use_pre_layernorm=False,
                         patch_bias=True, use_layerscale=True, **TINY_VIT)


@functools.lru_cache(maxsize=None)
def facet_tree(seed: int = 63) -> dict:
    return flax_params(JV.ViTEncoder(FACET_VIT, J_FP32), seed,
                       jnp.zeros((1, 28, 28, 3)))


@pytest.mark.parametrize("log_bin", [False, True])
@pytest.mark.parametrize("facet", ["token", "query", "key", "value"])
def test_facet_descriptors_match_jax(facet, log_bin):
    jcfg, tree = FACET_VIT, facet_tree()
    px = rand(64, 2, 28, 28, 3)
    want = JFa.facet_descriptors(JV.ViTEncoder(jcfg, J_FP32),
                                 {"params": tree}, jnp.asarray(px), layer=1,
                                 facet=facet, log_bin=log_bin)
    with torch.no_grad():
        got = TFa.facet_descriptors(port_encoder(tree, port_vit_config(jcfg)),
                                    torch.from_numpy(px), layer=1,
                                    facet=facet, log_bin=log_bin)
    close(got, want)


def test_attention_facet_and_saliency_match_jax():
    jcfg = JV.ViTConfig(**TINY_VIT)
    tree = flax_params(JV.ViTEncoder(jcfg, J_FP32), 65,
                       jnp.zeros((1, 28, 28, 3)))
    px = rand(66, 2, 28, 28, 3)
    jenc, enc = JV.ViTEncoder(jcfg, J_FP32), port_encoder(
        tree, port_vit_config(jcfg))
    with torch.no_grad():
        close(TFa.attention_maps(enc, torch.from_numpy(px), layer=2),
              JFa.attention_maps(jenc, {"params": tree}, jnp.asarray(px),
                                 layer=2))
        close(TFa.extract_saliency_maps(enc, torch.from_numpy(px),
                                        head_idxs=(0, 2)),
              JFa.extract_saliency_maps(jenc, {"params": tree},
                                        jnp.asarray(px), head_idxs=(0, 2)))
        with pytest.raises(ValueError, match="out of range"):
            TFa.extract_saliency_maps(enc, torch.from_numpy(px),
                                      head_idxs=(4,))


def test_log_bin_and_stride_override_match_jax():
    x = rand(67, 2, 2, 4 * 5, 3)
    close(TFa._log_bin(torch.from_numpy(x), (4, 5)),
          JFa._log_bin(jnp.asarray(x), (4, 5)))
    # an overlapping patch stride: 1 + (28 - 7) // 3 = 8 a side
    jcfg = JV.ViTConfig(image_size=28, patch_size=7, stride=3,
                        hidden_size=32, num_layers=1, num_heads=4,
                        intermediate_size=64)
    tree = flax_params(JV.ViTEncoder(jcfg, J_FP32), 68,
                       jnp.zeros((1, 28, 28, 3)))
    px = rand(69, 1, 28, 28, 3)
    want = JFa.facet_descriptors(JV.ViTEncoder(jcfg, J_FP32),
                                 {"params": tree}, jnp.asarray(px), layer=0,
                                 facet="key", log_bin=True)
    with torch.no_grad():
        got = TFa.facet_descriptors(port_encoder(tree, port_vit_config(jcfg)),
                                    torch.from_numpy(px), layer=0,
                                    facet="key", log_bin=True)
    assert got.shape == (1, 1, 64, 32 * 17)
    close(got, want)


# ---------------------------------------------------------------------------
# co-PCA, distances, the pose protocol
# ---------------------------------------------------------------------------

def _feats(seed, c=(12, 10, 6)):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(1, g, g, ch).astype(np.float32)
            for k, g, ch in zip(("s5", "s4", "s3"), (2, 4, 8), c)}


def _pair_dists(a, b):
    a, b = np.asarray(a).reshape(-1, a.shape[-1]), \
        np.asarray(b).reshape(-1, b.shape[-1])
    return np.linalg.norm(a[:, None] - b[None], axis=-1)


def test_co_pca_and_pair_distance_match_jax():
    f1, f2 = _feats(70), _feats(71)
    dims = (5, 4, 3)
    j1, j2 = JG.co_pca({k: jnp.asarray(v) for k, v in f1.items()},
                       {k: jnp.asarray(v) for k, v in f2.items()}, dims)
    t1, t2 = TG.co_pca({k: torch.from_numpy(v) for k, v in f1.items()},
                       {k: torch.from_numpy(v) for k, v in f2.items()}, dims)
    assert t1.shape == (1, 8, 8, 12)
    # each block's cross-image distances (blind to a component's sign; the
    # blocks' widths differ, so this also pins the s3, s4, s5 order)
    for lo, hi in ((0, 3), (3, 7), (7, 12)):
        close(_pair_dists(t1.numpy()[..., lo:hi], t2.numpy()[..., lo:hi]),
              _pair_dists(np.asarray(j1)[..., lo:hi],
                          np.asarray(j2)[..., lo:hi]))
    rng = np.random.RandomState(72)
    d1 = rng.randn(1, 1, 64, 7).astype(np.float32)
    d2 = rng.randn(1, 1, 64, 7).astype(np.float32)
    mask = (rng.rand(16, 16) > 0.3).astype(np.float32)
    want = JP.pair_distance(
        {k: jnp.asarray(v) for k, v in f1.items()}, jnp.asarray(d1),
        {k: jnp.asarray(v) for k, v in f2.items()}, jnp.asarray(d2), mask,
        res=16, dims=dims)
    got = TP.pair_distance(
        {k: torch.from_numpy(v) for k, v in f1.items()}, torch.from_numpy(d1),
        {k: torch.from_numpy(v) for k, v in f2.items()}, torch.from_numpy(d2),
        torch.from_numpy(mask), res=16, dims=dims)
    assert abs(got - want) <= TOL * abs(want)


@pytest.mark.parametrize("res", [4, 11])
def test_masked_nn_mean_distance_matches_jax(res):
    rng = np.random.RandomState(73 + res)
    src = rng.randn(1, 1, 16, 6).astype(np.float32)
    tgt = rng.randn(1, 1, 16, 6).astype(np.float32)
    mask = (rng.rand(res, res) > 0.4).astype(np.float32)
    want = float(JG.masked_nn_mean_distance(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(mask), grid=4,
        res=res))
    got = float(TG.masked_nn_mean_distance(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(mask),
        grid=4, res=res))
    assert abs(got - want) <= TOL * abs(want)
    fused = TG.fuse_descriptors(torch.from_numpy(src), torch.from_numpy(tgt))
    close(fused, JG.fuse_descriptors(jnp.asarray(src), jnp.asarray(tgt)))


def test_pose_protocol_and_masks_match_jax(tmp_path):
    rng = np.random.RandomState(75)
    rows = rng.rand(9, 12)
    poses = list("bflrbflrb")
    assert TG.pose_awareness_eval(rows, poses) == \
        JG.pose_awareness_eval(rows, poses)
    for row in rows:
        assert TG.classify_pose(row) == JG.classify_pose(row)
    m = (rng.rand(9, 13) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(TG.resize_mask_nearest(m, 11),
                                  JG.resize_mask_nearest(m, 11))
    ref = TF.interpolate(torch.from_numpy(m)[None, None], size=(11, 11),
                         mode="nearest")[0, 0].numpy()
    np.testing.assert_array_equal(TG.resize_mask_nearest(m, 11), ref)
    # the mask files `sam-masks` (a {0, 255} PNG) and ODISE (.npy) write
    from PIL import Image
    big = rng.rand(96, 96) > 0.6
    Image.fromarray((big * 255).astype(np.uint8), mode="L").save(
        tmp_path / "a_mask.png")
    np.save(tmp_path / "b_mask.npy", big.astype(np.float32))
    for stem in ("a", "b", "missing"):
        np.testing.assert_array_equal(TP._load_mask(str(tmp_path), stem, 24),
                                      JP._load_mask(str(tmp_path), stem, 24))


def test_panoptic_to_binary_mask_matches_jax():
    classes = ["person", "potted plant", "tv", "dog"]
    seg = np.array([[0, 1, 1], [2, 2, 3], [3, 3, 0]])
    info = [{"id": 1, "category_id": 3}, {"id": 2, "category_id": 0},
            {"id": 3, "category_id": 2}]
    for cat in ("dog", "tvmonitor", ["person", "dog"], "zebra", "tv",
                "pottedplant"):
        np.testing.assert_array_equal(
            TP.panoptic_to_binary_mask(seg, info, classes, cat),
            JP.panoptic_to_binary_mask(seg, info, classes, cat))


def test_duplicate_stems_are_refused(tmp_path):
    with pytest.raises(ValueError, match="duplicate image stem"):
        TP.preprocess_maps(["a/x.png", "b/x.jpg"], str(tmp_path), None,
                           None, device="cpu")


# ---------------------------------------------------------------------------
# preprocess-map + pose-awareness, both packages on the same bundles
# ---------------------------------------------------------------------------

def _images(root):
    from PIL import Image
    rng = np.random.RandomState(76)
    tdir, gdir = root / "images" / "templates", root / "images" / "targets"
    tdir.mkdir(parents=True), gdir.mkdir()
    for i in range(12):
        Image.fromarray(rng.randint(0, 255, (40, 36, 3), np.uint8)).save(
            tdir / f"t{i:02d}.png")
    labels = {}
    for i, pose in enumerate("lrf"):
        Image.fromarray(rng.randint(0, 255, (36, 44, 3), np.uint8)).save(
            gdir / f"img{i}.jpg")
        labels[f"img{i}.jpg"] = pose
    (root / "labels.json").write_text(json.dumps(labels))
    masks = root / "masks"
    masks.mkdir()
    Image.fromarray(((rng.rand(40, 40) > 0.5) * 255).astype(np.uint8),
                    mode="L").save(masks / "img0_mask.png")
    return tdir, gdir, masks


def test_preprocess_map_and_pose_awareness_cli_match_jax(tmp_path,
                                                        monkeypatch):
    tdir, gdir, masks = _images(tmp_path)
    bundle = save_featurizer_bundle(str(tmp_path / "sd.npz"), sd_tree(),
                                    sd_config())
    dino = str(tmp_path / "dino.npz")
    save_params(dino, dino_tree())
    # the JAX command computes in bf16 by default; both sides in fp32 here
    monkeypatch.setattr(JP, "make_geoware_extractors", functools.partial(
        JP.make_geoware_extractors, precision=J_FP32))
    common = ["--sd-bundle", bundle, "--dino-bundle", dino,
              "--dino-tower", DINO_TOWER, "--real-size", str(SD_IMG),
              "--dino-size", "112", "--layer", "1"]
    out = {}
    for name, main, dev in (("jax", jcli.main, []),
                            ("port", cli.main, ["--device", "cpu"])):
        feats = str(tmp_path / f"feats_{name}")
        # both image sets in one call (the directory is walked)
        assert main(["preprocess-map", str(tmp_path / "images"), feats]
                    + common + dev) == 0
        res = tmp_path / f"pose_{name}.json"
        assert main(["pose-awareness", str(tdir), str(gdir),
                     str(tmp_path / "labels.json"), feats, "--mask-dir",
                     str(masks), "--res", "16", "--output", str(res)]
                    + dev) == 0
        out[name] = (feats, json.loads(res.read_text()))
    (jfeats, jres), (tfeats, tres) = out["jax"], out["port"]
    files = sorted(os.listdir(jfeats))
    assert files == sorted(os.listdir(tfeats))
    assert len(files) == 4 * 15
    assert "img0_sd_flip.npz" in files and "t00_dino_flip.npy" in files
    for f in files:
        if f.endswith(".npy"):
            close_norm(np.load(os.path.join(tfeats, f)),
                       np.load(os.path.join(jfeats, f)))
            continue
        with np.load(os.path.join(tfeats, f)) as got, \
                np.load(os.path.join(jfeats, f)) as want:
            assert sorted(got.files) == ["s3", "s4", "s5"]
            for k in want.files:
                close_norm(got[k], want[k])
    assert tres["targets"] == jres["targets"] == ["img0.jpg", "img1.jpg",
                                                  "img2.jpg"]
    assert tres["results"] == jres["results"]
    close(np.asarray(tres["rows"]), np.asarray(jres["rows"]))


# ---------------------------------------------------------------------------
# deformable attention
# ---------------------------------------------------------------------------

def test_bilinear_sample_matches_jax():
    rng = np.random.RandomState(77)
    val = rng.randn(5, 7, 3).astype(np.float32)
    xs = (rng.rand(2, 11) * 9 - 1).astype(np.float32)     # some outside
    ys = (rng.rand(2, 11) * 7 - 1).astype(np.float32)
    close(TD.bilinear_sample(*(torch.from_numpy(a) for a in (val, xs, ys))),
          JD.bilinear_sample(*(jnp.asarray(a) for a in (val, xs, ys))))


def test_ms_deform_attn_matches_jax_and_grid_sample():
    rng = np.random.RandomState(78)
    b, m, cv, q, p = 2, 2, 4, 6, 3
    shapes = [(4, 6), (2, 3)]
    value = rng.randn(b, sum(h * w for h, w in shapes), m, cv).astype(
        np.float32)
    locs = (rng.rand(b, q, m, len(shapes), p, 2) * 1.2 - 0.1).astype(
        np.float32)
    w = rng.rand(b, q, m, len(shapes), p).astype(np.float32)
    w /= w.sum(axis=(-2, -1), keepdims=True)
    got = TD.ms_deform_attn(torch.from_numpy(value), shapes,
                            torch.from_numpy(locs), torch.from_numpy(w))
    close(got, JD.ms_deform_attn(jnp.asarray(value), shapes,
                                 jnp.asarray(locs), jnp.asarray(w)))
    close(got, _torch_oracle(torch.from_numpy(value), shapes,
                             torch.from_numpy(locs), torch.from_numpy(w)))
