"""The port's host tools against the JAX package, on the CPU: anyres
(`tests/test_anyres.py`'s four cases, the masked splice through the port's
`splice_plan`), `apply-delta` / `make-delta` / `consolidate` (both
packages' CLIs on the same files, equal arrays; the JAX runner's orbax
train state through both packages' `consolidate` and the port's
`model.checkpoint` and `load_pretrained`), `clean_conversations`, the
figures and `AC_score.csv`, the phase timers and the torch profiler's
trace, and the burner on the CPU.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.data import clean as jclean
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import anyres as JA
from law_of_vision_representation_in_mllms_tpu.models import splice as JS
from law_of_vision_representation_in_mllms_tpu.policy import data as JPD
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.data import clean as tclean
from law_of_vision_representation_in_mllms_torch.io import (
    checkpoint as tckpt, delta as tdelta, from_jax)
from law_of_vision_representation_in_mllms_torch.models import anyres as TA
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import splice as TS
from law_of_vision_representation_in_mllms_torch.policy import data as TPD
from law_of_vision_representation_in_mllms_torch.train import runner
from law_of_vision_representation_in_mllms_torch.utils import (
    burner, phase_timer, trace_profile)

torch.set_num_threads(1)

PINPOINTS = [(336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008)]


# ---- anyres ---------------------------------------------------------------

@pytest.mark.parametrize("size", [(300, 900), (900, 300), (600, 600),
                                  (333, 333)])
def test_select_best_resolution_and_grid_match_jax(size):
    assert TA.select_best_resolution(size, PINPOINTS) == \
        JA.select_best_resolution(size, PINPOINTS)
    assert TA.get_anyres_image_grid_shape(size, PINPOINTS, 336) == \
        JA.get_anyres_image_grid_shape(size, PINPOINTS, 336)
    assert TA.select_best_resolution((300, 900), PINPOINTS) == (336, 1008)
    assert TA.get_anyres_image_grid_shape((600, 600), PINPOINTS,
                                          336) == (2, 2)


@pytest.mark.parametrize("grid,size", [((2, 2), (200, 100)),
                                       ((2, 2), (100, 200)),
                                       ((3, 1), (900, 300))])
def test_unpad_valid_mask_matches_jax(grid, size):
    got = TA.unpad_valid_mask(grid, 4, size)
    np.testing.assert_array_equal(got, JA.unpad_valid_mask(grid, 4, size))
    assert got.any() and got.dtype == bool


def test_assemble_and_masked_splice_match_jax():
    rng = np.random.RandomState(0)
    p, d, g = 4, 8, 2
    base = rng.randn(p, d).astype(np.float32)
    crops = rng.randn(4, p, d).astype(np.float32)
    tokens, valid = TA.assemble_anyres_tokens(base, crops, (2, 2),
                                              (200, 100), g)
    jt, jv = JA.assemble_anyres_tokens(base, crops, (2, 2), (200, 100), g)
    np.testing.assert_array_equal(tokens, jt)
    np.testing.assert_array_equal(valid, jv)
    assert valid[:p].all() and valid.sum() < len(valid)
    ids = np.asarray([[5, JS.IMAGE_TOKEN_INDEX, 7, 8]], np.int64)
    labels = np.full_like(ids, JS.IGNORE_INDEX)
    mask = np.ones_like(ids, bool)
    want = JS.splice_plan(jnp.asarray(ids, jnp.int32), jnp.asarray(labels,
                                                                   jnp.int32),
                          jnp.asarray(mask), p + 16,
                          image_valid=jnp.asarray(valid[None]))
    got = TS.splice_plan(torch.from_numpy(ids), torch.from_numpy(labels),
                         torch.from_numpy(mask), p + 16,
                         image_valid=torch.from_numpy(valid[None]))
    np.testing.assert_array_equal(got.attn_mask.numpy(),
                                  np.asarray(want.attn_mask))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(want.positions))
    assert int(got.attn_mask.sum()) == 3 + int(valid.sum())


# ---- delta weights and consolidate -------------------------------------

def _write(path, **arrays):
    np.savez(path, **arrays)
    return str(path)


def _read(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _both(argv_of, tmp_path, name):
    """Run one command through both CLIs; returns (JAX, port) arrays."""
    outs = []
    for main, tag in ((jcli.main, "j"), (cli.main, "t")):
        out = str(tmp_path / f"{name}_{tag}.npz")
        assert main(argv_of(out)) == 0
        outs.append(_read(out))
    return outs


def test_apply_and_make_delta_match_jax(tmp_path):
    """The vocabulary-extension case (the base adds into the leading slice
    of a longer embedding), a delta-only key passed through, and the round
    trip make-delta -> apply-delta back to the target."""
    rng = np.random.RandomState(0)
    base = _write(tmp_path / "base.npz",
                  embed=rng.randn(10, 4).astype(np.float32),
                  w=rng.randn(4, 4).astype(np.float32))
    target = _write(tmp_path / "target.npz",
                    embed=rng.randn(12, 4).astype(np.float32),
                    w=rng.randn(4, 4).astype(np.float32),
                    mm_projector=rng.randn(4, 3).astype(np.float32))
    want, got = _both(lambda out: ["make-delta", "--base", base, "--target",
                                   target, "--delta", out], tmp_path, "delta")
    assert set(got) == set(want) == {"embed", "w", "mm_projector"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    delta = str(tmp_path / "delta_t.npz")
    want, got = _both(lambda out: ["apply-delta", "--base", base, "--delta",
                                   delta, "--target", out], tmp_path, "apply")
    tgt = _read(target)
    for k in tgt:
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_allclose(got[k], tgt[k], atol=1e-6)
    assert got["embed"].shape == (12, 4)


def test_delta_missing_keys_and_bad_shapes_raise_in_both(tmp_path):
    base = _write(tmp_path / "base.npz", a=np.ones(3, np.float32),
                  b=np.ones(3, np.float32))
    short = _write(tmp_path / "short.npz", a=np.ones(3, np.float32))
    narrow = _write(tmp_path / "narrow.npz", a=np.ones(2, np.float32),
                    b=np.ones(3, np.float32))
    from law_of_vision_representation_in_mllms_tpu.io import delta as jdelta
    for mod in (jdelta, tdelta):
        with pytest.raises(ValueError, match="missing"):
            mod.apply_delta(base, short, str(tmp_path / "x.npz"))
        with pytest.raises(ValueError, match="does not extend"):
            mod.make_delta(base, narrow, str(tmp_path / "x.npz"))


def test_consolidate_a_port_run_for_the_jax_loader(tmp_path):
    """`consolidate` of a run directory the port's runner wrote (its newest
    `checkpoint-{step}`) gives the flat `param_io` file that the JAX
    `load_params` reads, equal to the saved parameters."""
    cfg = TM.LlavaConfig.build("debug/tiny-vit", decoder=TL.tiny(),
                               projector_type="perceiver2x")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            FP32_PRECISION, "cpu")
    opt = torch.optim.SGD(params.projector.parameters(), lr=0.1)
    run = str(tmp_path / "run")
    tckpt.save_train_state(run, params, opt, 1)
    with torch.no_grad():
        params.projector.latents.add_(1.0)
    tckpt.save_train_state(run, params, opt, 3)
    out = str(tmp_path / "flat.npz")
    assert cli.main(["consolidate", "--checkpoint", run, "--output",
                     out]) == 0
    tree = jio.load_params(out)
    want = from_jax.llava_tree(params)
    assert sorted(tree) == sorted(want)
    np.testing.assert_array_equal(tree["projector"]["latents"],
                                  want["projector"]["latents"])
    sd = from_jax.llava_state_dict(tree)
    for k, v in params.state_dict().items():
        assert torch.equal(sd[k], v), k
    # a params.npz file is taken as it is
    assert tdelta.consolidate(os.path.join(run, "checkpoint-1",
                                           "params.npz"),
                              str(tmp_path / "one.npz")) == len(
        np.load(out).files)


def test_orbax_train_state_is_refused(tmp_path):
    """A JAX runner's orbax `checkpoint-{step}` (stage 2, two steps of the
    tiny LLaVA: params, optimizer state and step) through the port's
    reader: the CLI `consolidate` of the run directory and of the
    checkpoint writes, array for array and bit for bit, the JAX
    `consolidate`'s file; `model.checkpoint` and `load_pretrained` give the
    model those arrays (the JAX ones read this save only template-free: its
    `restore_train_state(path, {"params": ...})` refuses a tree that also
    holds the optimizer state)."""
    import test_torch_lora as lora_test
    from law_of_vision_representation_in_mllms_tpu.core.config import (
        RunConfig as JRunConfig)
    from law_of_vision_representation_in_mllms_tpu.io import (
        delta as jdelta)
    from law_of_vision_representation_in_mllms_tpu.train import (
        runner as jrunner)
    raw = lora_test._feature_run(tmp_path, batch_size=6, epochs=2)
    assert jrunner.run_training(JRunConfig.from_dict(raw)) == 0
    run = raw["train"]["output_dir"]
    ckpt = os.path.join(run, "checkpoint-2")
    assert tdelta.is_orbax_checkpoint(ckpt)
    want_path = str(tmp_path / "jax.npz")
    n = jdelta.consolidate(ckpt, want_path)
    want = np.load(want_path)
    for src in (run, ckpt):
        out = str(tmp_path / "port.npz")
        assert cli.main(["consolidate", "--checkpoint", src, "--output",
                         out]) == 0
        got = np.load(out)
        assert sorted(got.files) == sorted(want.files) and len(want.files) \
            == n
        for k in want.files:
            assert got[k].dtype == want[k].dtype and \
                got[k].tobytes() == want[k].tobytes(), k
    sd = from_jax.llava_state_dict(jio.load_params(want_path))
    raw["model"]["checkpoint"] = run
    _, params = runner.build_model(RunConfig.from_dict(raw), device="cpu",
                                   precision=FP32_PRECISION)
    assert {k: v for k, v in params.state_dict().items()}.keys() == sd.keys()
    for k, v in params.state_dict().items():
        assert torch.equal(v, sd[k]), k
    raw["model"]["checkpoint"] = None
    _, fresh = runner.build_model(RunConfig.from_dict(raw), device="cpu",
                                  precision=FP32_PRECISION)
    assert not torch.equal(fresh.projector.state_dict()["layers.0.weight"],
                           sd["projector.layers.0.weight"])
    tckpt.load_pretrained(run, fresh)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k


# ---- clean, figures, timers, burner ------------------------------------

def test_clean_conversations_matches_jax(tmp_path):
    def turn(who, text):
        return {"from": who, "value": text}
    records = [
        {"id": 0, "conversations": [turn("human", "hi"), turn("gpt", "yo")]},
        {"id": 1, "conversations": [turn("human", "hi")]},
        {"id": 2, "conversations": [turn("human", " "), turn("gpt", "x")]},
        {"id": 3, "conversations": [turn("gpt", "a"), turn("human", "b")]},
        {"id": 4},
        {"id": 5, "conversations": [turn("human", "q"), turn("gpt", "a"),
                                    turn("human", "q2"), turn("gpt", "a2")]},
    ]
    assert tclean.clean_conversations(records) == \
        jclean.clean_conversations(records)
    with open(tmp_path / "in.json", "w") as f:
        json.dump(records, f)
    report = tclean.clean_file(str(tmp_path / "in.json"),
                               str(tmp_path / "out.json"))
    jreport = jclean.clean_file(str(tmp_path / "in.json"),
                                str(tmp_path / "jout.json"))
    assert report == jreport and report["kept"] == 2
    assert (tmp_path / "out.json").read_bytes() == \
        (tmp_path / "jout.json").read_bytes()


def _table(mod):
    rng = np.random.default_rng(0)
    n = len(mod.ALL_MODELS)
    a = {b: rng.random(n) for b in mod.BENCHMARKS}
    c = rng.random(n)
    perf = {b: 2 * a[b] ** 2 + a[b] * c + 0.5 * c
            + 0.05 * rng.standard_normal(n) for b in mod.BENCHMARKS}
    return mod.ACTable(models=list(mod.ALL_MODELS), perf=perf, a=a, c=c)


def test_figures_and_ac_csv(tmp_path):
    from law_of_vision_representation_in_mllms_tpu import (
        visualizations as jviz)
    from law_of_vision_representation_in_mllms_torch import (
        visualizations as tviz)
    args = (["m1", "m2", "m3"],
            {"m1": {"mme": 0.9, "gqa": 0.2}, "m2": {"mme": 0.1}},
            {"m1": 15.0, "m3": 3.0}, {"m2": 1.5})
    t = tviz.write_ac_score_csv(str(tmp_path / "t.csv"), *args)
    j = jviz.write_ac_score_csv(str(tmp_path / "j.csv"), *args)
    assert open(t, "rb").read() == open(j, "rb").read()
    table = _table(TPD)
    assert table.models == _table(JPD).models
    paths = [
        tviz.plot_law_scatter(table, "mme", str(tmp_path / "law.png"),
                              grid_n=12),
        tviz.plot_policy_bar({"Random": 0.45, "A": 0.77, "C": 0.57,
                              "AC": 0.96}, str(tmp_path / "bar.png")),
        tviz.plot_radar(table, ["CLIP336", "DINOv2", "SD1.5"],
                        str(tmp_path / "radar.png")),
        tviz.plot_sampling_curve([2, 4, 8], [0.5, 0.7, 0.9],
                                 str(tmp_path / "curve.png"))]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
        assert os.path.getsize(p) > 1000


def test_phase_timer_and_trace_profile(tmp_path):
    timer = phase_timer()
    for _ in range(2):
        with timer("encode"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with timer("decode"):
        pass
    report = timer.report()
    assert list(report) == ["encode", "decode"]
    assert report["encode"] > report["decode"] >= 0.0
    with trace_profile(None) as prof:
        assert prof is None
    with trace_profile(str(tmp_path / "trace")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_burner_on_the_cpu(capsys):
    tflops = burner.burn(seconds=0.05, size=64, device="cpu")
    assert tflops > 0.0
    assert "TFLOP/s sustained" in capsys.readouterr().out
