"""Snapshot reading and `port_component` / `main` of the port's
`io/port_cli.py` against the JAX package's, on the CPU; and the projector
files' precedence in `io.checkpoint.load_pretrained`.

The port reads `.safetensors` with its own reader (the card's machine has
no `safetensors` package); it is held to `safetensors.torch.load_file` for
every dtype it takes, a sharded directory included. Each of the 14 porter
kinds ports one tiny snapshot directory in both packages (the port's
through `main(argv)`); the two .npz files must hold the same keys and
bit-equal arrays (the zip bytes carry timestamps, so their contents are
compared). The kinds built on a full-size preset (the UNets, VAEs, DiT,
MMDiT, the pooled CLIP-L/14) run on a tiny configuration patched into that
preset in both packages, on a state dict written with diffusers' key names
(`test_torch_diffusers_port.diffusers_state_dict`).
"""

import contextlib
import io
import os
import types

import jax
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import checkpoint as TC
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.io import port_cli as TP
from law_of_vision_representation_in_mllms_torch.models import dit as TDT
from law_of_vision_representation_in_mllms_torch.models import mmdit as TMM
from law_of_vision_representation_in_mllms_torch.models import (
    projector as TPR)
from law_of_vision_representation_in_mllms_torch.models import unet as TU
from law_of_vision_representation_in_mllms_torch.models import vae as TVA
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_tpu.io import checkpoint as JC
from law_of_vision_representation_in_mllms_tpu.io import port_cli as JP
from law_of_vision_representation_in_mllms_tpu.models import dit as JDT
from law_of_vision_representation_in_mllms_tpu.models import mmdit as JMM
from law_of_vision_representation_in_mllms_tpu.models import unet as JU
from law_of_vision_representation_in_mllms_tpu.models import vae as JVA
from law_of_vision_representation_in_mllms_tpu.models import vit as JV
from test_torch_diffusers_port import (UNETS, VAES, diffusers_state_dict,
                                       jax_config, random_tree)

safetensors_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

torch.set_num_threads(1)


def _tensors(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, 2, 3, generator=g).half(),
        "bf16": torch.randn(7, generator=g).bfloat16(),
        "i64": torch.randint(-2 ** 40, 2 ** 40, (2, 3), generator=g),
        "i32": torch.randint(-2 ** 30, 2 ** 30, (5,), generator=g,
                             dtype=torch.int32),
        "i8": torch.randint(-128, 128, (3, 3), generator=g,
                            dtype=torch.int8),
        "u8": torch.randint(0, 256, (6,), generator=g, dtype=torch.uint8),
        "bool": torch.rand(2, 4, generator=g) < 0.5,
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 3),
    }


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert torch.equal(got[k], w), k


def test_safetensors_reader_matches_the_package(tmp_path):
    want = _tensors(0)
    path = str(tmp_path / "model.safetensors")
    safetensors_torch.save_file(want, path, metadata={"format": "pt"})
    got = TP.load_safetensors(path)
    _assert_same(got, safetensors_torch.load_file(path))
    _assert_same(got, want)


def test_sharded_directory_reads_every_shard_in_order(tmp_path):
    """Shards in sorted order (a later shard's key wins, as in the JAX
    reader), the index file ignored."""
    first, second = _tensors(1), _tensors(2)
    second = {"f32": second["f32"], "extra": second["i8"]}
    safetensors_torch.save_file(
        first, str(tmp_path / "model-00001-of-00002.safetensors"))
    safetensors_torch.save_file(
        second, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    got = TP.load_torch_state_dict(str(tmp_path))
    _assert_same(got, {**first, **second})
    _assert_same(got, JP.load_torch_state_dict(str(tmp_path)))


def test_safetensors_reader_refuses_a_dtype_it_does_not_take(tmp_path):
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file({"w": torch.zeros(2, dtype=torch.float64)},
                                path)
    with pytest.raises(ValueError, match="F64"):
        TP.load_safetensors(path)


def test_bin_snapshots_load_through_torch_load(tmp_path):
    sd = {k: v for k, v in _tensors(3).items() if k != "empty"}
    torch.save(dict(list(sd.items())[:4]),
               tmp_path / "pytorch_model-00001.bin")
    torch.save(dict(list(sd.items())[4:]),
               tmp_path / "diffusion_pytorch_model.bin")
    got = TP.load_torch_state_dict(str(tmp_path))
    _assert_same(got, sd)
    _assert_same(got, JP.load_torch_state_dict(str(tmp_path)))
    with pytest.raises(FileNotFoundError):
        TP.load_torch_state_dict(str(tmp_path / "missing"))


# --- port_component / main over the 14 kinds --------------------------------

TINY_VIT = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=2,
                num_heads=4, intermediate_size=64)


def _hf_snapshot(kind: str, path) -> str:
    vision = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                  num_attention_heads=4, image_size=28, patch_size=7)
    T = transformers
    torch.manual_seed(sorted(KINDS).index(kind))
    if kind == "clip_vision":
        model = T.CLIPVisionModel(T.CLIPVisionConfig(**vision))
    elif kind == "siglip_vision":
        model = T.SiglipVisionModel(T.SiglipVisionConfig(**vision))
    elif kind == "dinov2":
        vision.pop("intermediate_size")
        model = T.Dinov2Model(T.Dinov2Config(mlp_ratio=2, **vision))
    elif kind == "clip_vision_pooled":
        vision["num_hidden_layers"] = TINY_VIT["num_layers"]
        model = T.CLIPVisionModelWithProjection(
            T.CLIPVisionConfig(projection_dim=24, **vision))
    elif kind == "clip_text":
        model = T.CLIPTextModelWithProjection(T.CLIPTextConfig(
            vocab_size=99, hidden_size=32, intermediate_size=64,
            num_hidden_layers=3, num_attention_heads=4,
            max_position_embeddings=16, projection_dim=16))
    else:
        model = T.LlamaForCausalLM(T.LlamaConfig(
            vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, tie_word_embeddings=False))
    model.eval().save_pretrained(str(path))
    return str(path)


def _diffusers_snapshot(module, jax_porter, path) -> str:
    """A diffusers-keyed .safetensors of `module`'s seeded weights."""
    os.makedirs(path)
    sd = diffusers_state_dict(jax_porter, random_tree(module, seed=5))
    safetensors_torch.save_file(
        sd, os.path.join(path, "diffusion_pytorch_model.safetensors"))
    return str(path)


KINDS = {
    "clip_vision": ["--image-size", "28", "--select-layer", "-2"],
    "siglip_vision": ["--select-layer", "-1"],
    # trained at 28 px, ported to 42 (position interpolation)
    "dinov2": ["--image-size", "42"],
    "clip_text": [],
    "clip_text_penultimate": ["--penultimate"],
    "llama": [],
    "clip_vision_pooled": [],
    "unet_sd15": ["--up-ft-index", "1"],
    "unet_sd21": [],
    "unet_sdxl": ["--up-ft-index", "2"],
    "vae_sd": [],
    "vae_sdxl": [],
    "vae_sd3": [],
    "dit": ["--up-ft-index", "-1"],
    "mmdit": [],
}


def _tiny_presets(monkeypatch) -> None:
    """The full-size presets the porters read, tiny in both packages."""
    vit = TV.ViTConfig(**TINY_VIT)
    monkeypatch.setattr(TV, "clip_l14", lambda *a, **k: vit)
    monkeypatch.setattr(JV, "clip_l14", lambda *a, **k: jax_config(
        JV.ViTConfig, vit))
    for name, cfg in (("sd15_unet", UNETS["sd15"]), ("sd21_unet",
                                                     UNETS["sd21"]),
                      ("sdxl_unet", UNETS["sdxl"])):
        monkeypatch.setattr(TU, name, lambda c=cfg: c)
        monkeypatch.setattr(JU, name, lambda c=cfg: jax_config(
            JU.UNetConfig, c))
    for name, cfg in (("sd_vae", VAES["sd"]), ("sdxl_vae", VAES["sd"]),
                      ("sd3_vae", VAES["sd3"])):
        monkeypatch.setattr(TVA, name, lambda c=cfg: c)
        monkeypatch.setattr(JVA, name, lambda c=cfg: jax_config(
            JVA.VAEConfig, c))
    for tmod, jmod, name, jcls in ((TDT, JDT, "dit_xl_2", JDT.DiTConfig),
                                   (TMM, JMM, "sd3_medium",
                                    JMM.MMDiTConfig)):
        monkeypatch.setattr(tmod, name, lambda m=tmod: m.TINY_TEST_CONFIG)
        monkeypatch.setattr(jmod, name, lambda m=tmod, c=jcls: jax_config(
            c, m.TINY_TEST_CONFIG))


def _snapshot(kind: str, path) -> str:
    from law_of_vision_representation_in_mllms_tpu.io import (
        diffusers_port as JD)
    if kind in ("unet_sd15", "unet_sd21", "unet_sdxl"):
        cfg = UNETS[kind[5:]]
        up = {"unet_sd15": 1, "unet_sd21": 0, "unet_sdxl": 2}[kind]
        tree = random_tree(TU.UNetHarvest(cfg, (up,), FP32_PRECISION), 5)
        if cfg.addition_embed_type:
            tree["add_embedding"] = random_tree(TU.TimestepEmbedMLP(
                6 * cfg.addition_time_embed_dim + cfg.addition_pooled_dim,
                cfg.time_embed_dim, FP32_PRECISION), 6)
        os.makedirs(path)
        sd = diffusers_state_dict(lambda s: JD.port_unet(
            s, jax_config(JU.UNetConfig, cfg), (up,)), tree)
        safetensors_torch.save_file(
            sd, os.path.join(path, "diffusion_pytorch_model.safetensors"))
        return str(path)
    if kind.startswith("vae_"):
        cfg = VAES["sd3" if kind == "vae_sd3" else "sd"]
        return _diffusers_snapshot(
            TVA.VAEEncoder(cfg, FP32_PRECISION),
            lambda s: JD.port_vae_encoder(s, jax_config(JVA.VAEConfig, cfg)),
            path)
    if kind in ("dit", "mmdit"):
        tmod, harvest, porter, jcls = (
            (TDT, TDT.DiTHarvest, JD.port_dit, JDT.DiTConfig) if kind == "dit"
            else (TMM, TMM.MMDiTHarvest, JD.port_mmdit, JMM.MMDiTConfig))
        cfg = tmod.TINY_TEST_CONFIG
        return _diffusers_snapshot(
            harvest(cfg, (-1,), FP32_PRECISION),
            lambda s: porter(s, jax_config(jcls, cfg), (-1,)), path)
    return _hf_snapshot(kind, path)


@pytest.mark.parametrize("case", sorted(KINDS))
def test_port_component_matches_jax(case, tmp_path, monkeypatch):
    _tiny_presets(monkeypatch)
    kind = "clip_text" if case.startswith("clip_text") else case
    snap = _snapshot(kind, tmp_path / "snap")
    flags = KINDS[case]
    out = str(tmp_path / "port" / "out.npz")
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        assert TP.main([kind, snap, out] + flags) == 0
    assert said.getvalue().strip() == f"ported {kind} from {snap} -> {out}"
    jout = str(tmp_path / "jax.npz")
    with contextlib.redirect_stdout(io.StringIO()):
        assert JP.main([kind, snap, jout] + flags) == 0
    with np.load(out) as got, np.load(jout) as want:
        assert sorted(got.files) == sorted(want.files) and got.files
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k


def test_port_component_writes_a_tower_the_port_loads(tmp_path):
    """A `clip_vision` .npz (`--select-layer -2`: L-1 blocks, the encoder's
    tree without the `encoder` level the JAX `model.tower_weights` wants)
    goes into the port's `model.tower_weights` as it is."""
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.io.param_io import (
        load_params)
    from law_of_vision_representation_in_mllms_torch.train import runner
    torch.manual_seed(0)
    T = transformers
    snap = str(tmp_path / "snap")
    T.CLIPVisionModel(T.CLIPVisionConfig(   # the `debug/tiny-vit` shape
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=28, patch_size=7)
    ).eval().save_pretrained(snap)
    out = TP.port_component("clip_vision", snap,
                            str(tmp_path / "clip.npz"), select_layer=-2)
    tree = load_params(out)
    assert "encoder" not in tree and sum(
        k.startswith("block_") for k in tree) == 1
    _, params = runner.build_model(RunConfig.from_dict({"model": {
        "vision_tower": "debug/tiny-vit", "decoder": "tiny",
        "tower_weights": [out]}}), device="cpu", precision=FP32_PRECISION)
    got = params.towers[0].state_dict()
    want = from_jax.vit_state_dict(tree)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k


# --- projector precedence ---------------------------------------------------

def test_projector_bin_wins_over_npz_in_both_packages(tmp_path):
    """With `mm_projector.npz` and `mm_projector.bin` in one directory (of
    different weights), both packages load the `.bin`'s."""
    def projector(seed):
        g = torch.Generator().manual_seed(seed)
        p = TPR.Projector("mlp2x_gelu", 8, 12, FP32_PRECISION)
        for t in p.parameters():
            t.data.normal_(generator=g)
        return p
    stale, ref = projector(0), projector(1)
    TC.save_projector(str(tmp_path), stale)
    torch.save(TC.export_projector_torch_sd(ref),
               tmp_path / "mm_projector.bin")
    got = types.SimpleNamespace(projector=projector(2))
    TC.load_pretrained(str(tmp_path), got)
    jgot = JC.load_pretrained(str(tmp_path), {"projector": None})
    jsd = from_jax.projector_state_dict(
        jax.tree.map(np.asarray, jgot["projector"]))
    for n, w in ref.state_dict().items():
        assert torch.equal(got.projector.state_dict()[n], w), n
        assert torch.equal(jsd[n], w), n
        assert not torch.equal(stale.state_dict()[n], w), n
