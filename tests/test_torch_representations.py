"""`core/representations.py` and `make-config` of the port against the JAX
package's: the same YAML text for each of the paper's 13 representations,
both stages, plain, `--lora` and `--qlora`; each loads into the port's
`RunConfig`.
"""

import contextlib
import io

import pytest
import yaml

from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core import (
    representations as TR)
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.core import (
    representations as JR)

VARIANTS = ({}, {"lora": True}, {"qlora": "int4"}, {"qlora": "int8"},
            {"output_dir": "out/x", "data_path": "d.json",
             "image_folder": "imgs", "n_data": 4, "n_model": 2, "zero": 3,
             "tokenizer": "/tok", "pretrain_mm_mlp_adapter": "stage1/x"})


def test_registry_matches_jax():
    assert list(TR.REPRESENTATIONS) == list(JR.REPRESENTATIONS)
    assert len(TR.REPRESENTATIONS) == 13
    for name, rep in TR.REPRESENTATIONS.items():
        j = JR.REPRESENTATIONS[name]
        assert (rep.name, rep.tower, rep.img_size, rep.bundle_kinds,
                rep.notes) == (j.name, j.tower, j.img_size, j.bundle_kinds,
                               j.notes)


@pytest.mark.parametrize("rep", list(JR.REPRESENTATIONS))
def test_render_config_matches_jax_and_loads(rep):
    for stage in (1, 2):
        for kw in VARIANTS:
            text = TR.render_config(rep, stage, **kw)
            assert text == JR.render_config(rep, stage, **kw), (stage, kw)
            cfg = RunConfig.from_dict(yaml.safe_load(text))
            assert cfg.model.vision_tower == TR.REPRESENTATIONS[rep].tower
            assert cfg.train.stage == stage
    with pytest.raises(ValueError, match="qlora"):
        TR.render_config(rep, 2, qlora="int2")


@pytest.mark.parametrize("argv", [
    ["list"], ["SD1.5", "--stage", "2", "--lora"],
    ["CLIP336+DINOv2", "--qlora", "int4", "--zero", "3", "--n-data", "2"]])
def test_make_config_cli_matches_jax(argv):
    outs = []
    for main in (cli.main, jcli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["make-config"] + argv) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and outs[0]
