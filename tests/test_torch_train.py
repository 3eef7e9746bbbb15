"""The port's training path against the JAX package: a tiny LLaVA (2-block
14 px ViT + mlp2x_gelu + a 2-layer GQA decoder) on the same weights (carried
across with `io.from_jax`) and the same seeded numpy batches, in fp32.

Covered: `loss_fn` value and gradients (plain attention and the flash route,
whose JAX side runs its Pallas kernels in interpret mode), the schedule and
`FusedAdamW` over 3 steps with a NaN batch, stage-1/stage-2
`make_train_step` over 3 steps, the torch.optim oracle against the optax
chain, remat and grad accumulation, `run_training` (feature-cached and with
PIL images) against the JAX runner, checkpoints both ways, the CLI, and the
ROADMAP pointers of the port's not-ported errors.

Tolerances (fp32 on both sides, same formulas, summation order differs):
loss 1e-5 relative; gradients 1e-6 absolute + 1e-4 relative; parameters
after 3 AdamW steps 1e-6 absolute + 1e-4 relative (Adam divides by
sqrt(v), which amplifies a gradient's rounding where v is tiny).
The runner tests (`_check_run`) add that amplification to the parameter
tolerance entry by entry: their captions go through the hash tokenizer,
whose ids change with the process, so each run trains on other ids and now
and then meets an entry whose gradient is ~100 times smaller than the rest.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.io import checkpoint as jckpt
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import towers as JT
from law_of_vision_representation_in_mllms_tpu.models import vit as JV
from law_of_vision_representation_in_mllms_tpu.train import runner as jrunner
from law_of_vision_representation_in_mllms_tpu.train import train_step as JS
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import checkpoint as tckpt
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import towers as TT
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_torch.models.splice import (
    IGNORE_INDEX, IMAGE_TOKEN_INDEX)
from law_of_vision_representation_in_mllms_torch.train import runner
from law_of_vision_representation_in_mllms_torch.train import train_step as TS

# One intra-op thread: with two, the first multi-threaded fp32 call in a
# loaded process has been seen to come out ~5e-5 off its fp64 value, over
# the tolerances below; on one thread it stays at ~5e-7.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=1e-6, rtol=1e-4)
PARAM_TOL = dict(atol=1e-6, rtol=1e-4)
# the two packages' gradients differ in their last bits (other summation
# orders); the largest entries are ~1, so 1e-7 is about two fp32 ulps of them
GRAD_ROUNDING = 1e-7


def _configs(seed=0):
    """(JAX cfg, JAX params, port cfg, port params) of the tiny LLaVA."""
    def entry(vit_mod, tower_mod, cfg_cls):
        vit = cfg_cls(image_size=14, patch_size=7, hidden_size=16,
                      num_layers=2, num_heads=2, intermediate_size=32)
        return tower_mod.TowerEntry(name="tiny", kind="vit", vit_config=vit,
                                    vit_family="clip", hidden_size=16,
                                    num_patches=vit.num_patches)
    dec = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
               num_kv_heads=2, intermediate_size=64)
    jcfg = JM.LlavaConfig(
        tower_spec=JT.TowerSpec(entries=[entry(JV, JT, JV.ViTConfig)],
                                join="single"),
        decoder=JL.tiny(**dec))
    tcfg = TM.LlavaConfig(
        tower_spec=TT.TowerSpec(entries=[entry(TV, TT, TV.ViTConfig)],
                                join="single"),
        decoder=TL.tiny(**dec))
    jparams = JM.init_params(jax.random.PRNGKey(seed), jcfg, J_FP32)
    return jcfg, jparams, tcfg, _port_params(tcfg, jparams)


def _port_params(tcfg, jparams):
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(from_jax.llava_state_dict(
        jax.tree.map(np.asarray, jparams)))
    return params


def _batch(seed, b=4, l=10):
    """Right-padded rows of different lengths, image at slot 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 60, size=(b, l)).astype(np.int32)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :2] = IGNORE_INDEX
    mask = np.ones((b, l), bool)
    for r in range(1, b):
        n = l - 2 * r
        mask[r, n:] = False
        ids[r, n:] = 0
        labels[r, n:] = IGNORE_INDEX
    px = rng.randn(b, 14, 14, 3).astype(np.float32)
    return {"input_ids": ids, "labels": labels, "text_mask": mask,
            "pixel_values": [px]}


def _jax_batch(batch):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
                else jnp.asarray(v)) for k, v in batch.items()}


def _port_batch(batch):
    return runner.batch_to_device(batch, "cpu")


def _jax_tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params_close(params, jparams, tol=PARAM_TOL):
    want = from_jax.llava_state_dict(_jax_tree_np(jparams))
    got = params.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_and_grads_match_jax(use_flash):
    jcfg, jparams, tcfg, params = _configs(0)
    batch = _batch(0)

    def jloss(projector, decoder):
        p = dict(jparams, projector=projector, decoder=decoder)
        return JM.loss_fn(p, jcfg, _jax_batch(batch), J_FP32,
                          use_flash=use_flash)
    want, (g_proj, g_dec) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jparams["projector"], jparams["decoder"])
    TS.apply_freeze(params, stage=2)
    loss = TM.loss_fn(params, tcfg, _port_batch(batch), use_flash=use_flash)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    grads = {n: p.grad for n, p in params.named_parameters()
             if p.grad is not None}
    assert not any(n.startswith("towers.") for n in grads)
    want_g = from_jax.projector_state_dict(_jax_tree_np(g_proj),
                                           "projector.")
    want_g.update(from_jax.llama_state_dict(_jax_tree_np(g_dec), "decoder."))
    assert set(grads) == set(want_g)
    for name, g in want_g.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)


def test_schedule_matches_optax():
    """Tolerance 1e-5 relative: optax evaluates the schedule in fp32 (each
    product and the cosine round at ~6e-8 relative; the sums reach ~2.4e-6
    over the decay), the port in Python floats."""
    for kw in (dict(total_steps=20, warmup_ratio=0.1),
               dict(total_steps=7, warmup_ratio=0.0),
               dict(total_steps=1000, warmup_ratio=0.03)):
        tcfg = TS.TrainConfig(learning_rate=2e-3, **kw)
        jsched = JS._make_schedule(JS.TrainConfig(learning_rate=2e-3, **kw))
        sched = TS.make_schedule(tcfg)
        for c in list(range(0, 25)) + [kw["total_steps"] + 5]:
            np.testing.assert_allclose(sched(c), float(jsched(c)),
                                       rtol=1e-5, atol=1e-12)


def _run_steps(stage, batches, *, fused=True, **kw):
    """3 steps on each side from the same weights; returns both params and
    the per-step metrics."""
    jcfg, jparams, tcfg, params = _configs(7)
    opts = dict(stage=stage, learning_rate=1e-3, weight_decay=0.01,
                total_steps=20, warmup_ratio=0.1, fused_optimizer=fused,
                **kw)
    jtc = JS.TrainConfig(**opts)
    jstate, jopt = JS.init_train_state(jparams, jtc)
    jstep = jax.jit(JS.make_train_step(jcfg, jtc, jopt, J_FP32))
    ttc = TS.TrainConfig(**opts)
    state, opt = TS.init_train_state(params, ttc)
    step = TS.make_train_step(tcfg, ttc, opt)
    jm, tm = [], []
    for b in batches:
        jstate, m = jstep(jstate, _jax_batch(b))
        jm.append({k: float(v) for k, v in m.items()})
        state, m = step(state, _port_batch(b))
        tm.append({k: float(v) for k, v in m.items()})
    return jstate["params"], params, jm, tm


def _poisoned(seed):
    b = _batch(seed)
    b["pixel_values"][0][0, 0, 0, 0] = np.nan
    return b


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_matches_jax(stage):
    jparams, params, jm, tm = _run_steps(stage, [_batch(i) for i in (1, 2,
                                                                     3)])
    for a, b in zip(jm, tm):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=1e-4)
        assert b["skipped_nonfinite"] == a["skipped_nonfinite"] == 0.0
        assert b["step"] == a["step"]
    _assert_params_close(params, jparams)
    if stage == 1:      # decoder and towers bitwise untouched
        fresh = _configs(7)[3].state_dict()
        for name, p in params.state_dict().items():
            if not name.startswith("projector."):
                assert torch.equal(p, fresh[name]), name


@pytest.mark.parametrize("fused", [True, False])
def test_optimizer_with_nan_batch_matches_jax(fused):
    """FusedAdamW (and the torch.optim oracle against the optax chain) over
    3 steps whose second batch holds a NaN: the NaN step is skipped on both
    sides, leaves the parameters unchanged and still advances the count."""
    batches = [_batch(4), _poisoned(5), _batch(6)]
    jparams, params, jm, tm = _run_steps(2, batches, fused=fused)
    assert [m["skipped_nonfinite"] for m in tm] == [0.0, 1.0, 0.0]
    assert [m["skipped_nonfinite"] for m in jm] == [0.0, 1.0, 0.0]
    for a, b in zip(jm, tm):
        if a["skipped_nonfinite"] == 0.0:
            np.testing.assert_allclose(b["loss"], a["loss"], rtol=LOSS_RTOL)
    _assert_params_close(params, jparams)


@pytest.mark.parametrize("policy", ["block", "dots"])
def test_remat_matches_no_remat(policy):
    """Gradient checkpointing changes memory, not math: the same loss and
    parameters after 2 stage-2 steps (through the flash route's Function
    too, whose forward the checkpoint re-runs)."""
    results = []
    for remat in (False, True):
        _, _, tcfg, params = _configs(3)
        ttc = TS.TrainConfig(stage=2, learning_rate=1e-3, total_steps=10,
                             remat=remat, remat_policy=policy,
                             use_flash=True)
        state, opt = TS.init_train_state(params, ttc)
        step = TS.make_train_step(tcfg, ttc, opt)
        losses = [float(step(state, _port_batch(_batch(s)))[1]["loss"])
                  for s in (8, 9)]
        results.append((losses, params.state_dict()))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    for name, p in results[0][1].items():
        np.testing.assert_allclose(results[1][1][name].numpy(), p.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_unknown_remat_policy_raises():
    _, _, tcfg, params = _configs(3)
    with pytest.raises(ValueError, match="remat_policy"):
        TM.loss_fn(params, tcfg, _port_batch(_batch(1)), remat=True,
                   remat_policy="nope")


def test_grad_accum_matches_single_batch():
    """grad_accum=2 over a duplicated batch gives the loss and update of
    grad_accum=1 over the single batch (mean of microbatch means)."""
    one = _batch(10)
    two = {k: ([np.concatenate([x, x]) for x in v] if isinstance(v, list)
               else np.concatenate([v, v])) for k, v in one.items()}
    results = []
    for accum, batch in ((1, one), (2, two)):
        _, _, tcfg, params = _configs(0)
        ttc = TS.TrainConfig(stage=2, learning_rate=1e-3, total_steps=10,
                             grad_accum=accum)
        state, opt = TS.init_train_state(params, ttc)
        _, m = TS.make_train_step(tcfg, ttc, opt)(state, _port_batch(batch))
        results.append((float(m["loss"]), params.state_dict()))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    for name, p in results[0][1].items():
        np.testing.assert_allclose(results[1][1][name].numpy(), p.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def _records(n, image=True):
    rng = np.random.RandomState(0)
    words = "a red house near the river with two trees and a dog".split()
    return [{"image": f"img{i % 3}.png"} if image else {} for i in range(n)], [
        [{"from": "human", "value": "<image>\ndescribe the picture"},
         {"from": "gpt", "value": " ".join(rng.choice(words, 3 + i % 5))}]
        for i in range(n)]


def _write_data(tmp_path, n=6):
    heads, convs = _records(n)
    recs = [dict(h, conversations=c) for h, c in zip(heads, convs)]
    with open(tmp_path / "data.json", "w") as f:
        json.dump(recs, f)
    return str(tmp_path / "data.json")


def _run_both(tmp_path, raw):
    """The JAX runner and the port's runner on one RunConfig dict, from the
    JAX runner's initial weights (handed to the port as a param .npz).
    Returns (JAX projector tree, port TrainRun)."""
    jcfg = JRunConfig.from_dict(raw)
    _, jparams = jrunner.build_model(jcfg)
    init = str(tmp_path / "init.npz")
    jio.save_params(init, _jax_tree_np(jparams))
    assert jrunner.run_training(jcfg) == 0
    want = jckpt.load_projector(raw["train"]["output_dir"])
    traw = json.loads(json.dumps(raw))
    traw["train"]["output_dir"] += "_port"
    traw["model"]["checkpoint"] = init
    traw["parallel"] = {}
    run = runner.run_training(RunConfig.from_dict(traw), device="cpu")
    return want, run, traw["train"]["output_dir"]


def _logs(out_dir):
    lines = open(os.path.join(out_dir, "train.jsonl")).read().split("\n")
    return [json.loads(ln) for ln in lines if ln]


def _adam_tolerance(run, name, w):
    """Entry-wise bound on |port - JAX| for a trained parameter: PARAM_TOL
    plus what Adam makes of the gradients' rounding. An update is
    lr * m_hat / (sqrt(v_hat) + eps), so a gradient off by GRAD_ROUNDING
    moves it by about lr * GRAD_ROUNDING / sqrt(v_hat): next to nothing where
    the gradient is of ordinary size, up to the whole step (lr) where it is
    near zero. Summed over the steps taken and capped at 2 * lr a step. A
    wrong schedule, weight decay or layout moves the ordinary entries by
    ~lr * 1e-2 or more, far outside it."""
    opt = run.opt
    nu = dict(zip((n for n, _ in opt.named_params), opt.nu))[name]
    v_hat = nu.float().numpy() / (1.0 - opt.cfg.b2 ** opt.count)
    lr = opt.cfg.learning_rate
    amplified = opt.count * lr * np.minimum(
        GRAD_ROUNDING / (np.sqrt(v_hat) + 1e-8), 2.0)
    return PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(w) + amplified


def _check_run(want, run, out_dir):
    logs = _logs(out_dir)
    assert len(logs) == run.state["step"] >= 2
    assert all(np.isfinite(r["loss"]) and r["skipped_nonfinite"] == 0.0
               for r in logs)
    # step by step against the JAX runner's log: from step 2 on the loss and
    # the gradient norm depend on every update before them
    jlogs = _logs(out_dir[:-len("_port")])
    assert len(jlogs) == len(logs)
    for r, jr in zip(logs, jlogs):
        np.testing.assert_allclose(r["loss"], jr["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], jr["grad_norm"],
                                   rtol=GRAD_TOL["rtol"])
    for f in ("mm_projector.npz", "mm_projector.bin", "config.json"):
        assert os.path.exists(os.path.join(out_dir, f))
    got = tckpt.load_projector(out_dir)
    assert torch.equal(got["layers.0.weight"],
                       run.state["params"].projector.layers[0].weight)
    n_tight = n_all = 0
    for i, layer in enumerate(want["layers"]):
        for name, w in (("weight", layer["kernel"].T),
                        ("bias", layer["bias"])):
            key = f"layers.{i}.{name}"
            diff = np.abs(got[key].numpy() - w)
            tol = _adam_tolerance(run, f"projector.{key}", w)
            assert (diff <= tol).all(), (key, float((diff - tol).max()))
            n_tight += int((diff <= PARAM_TOL["atol"]
                            + PARAM_TOL["rtol"] * np.abs(w)).sum())
            n_all += diff.size
    # the amplified entries are the exception: PARAM_TOL alone holds for
    # all but a few in ten thousand
    assert n_tight >= 0.999 * n_all, (n_tight, n_all)


def test_run_training_feature_cached_matches_jax(tmp_path):
    """Mirrors the JAX `test_train_runner_stage1_feature_cached`: stage 1
    through the feature pseudo-tower, 3 steps; the saved projector equals
    the JAX runner's."""
    feats = tmp_path / "feats"
    os.makedirs(feats)
    rng = np.random.RandomState(0)
    for i in range(3):
        np.save(feats / f"img{i}.npy",
                rng.randn(576, 1280).astype(np.float32))
    raw = {"model": {"vision_tower": "runwayml/stable-diffusion-v1-5_feature",
                     "decoder": "tiny"},
           "train": {"stage": 1, "batch_size": 2, "epochs": 1,
                     "bf16": False, "max_length": 64, "learning_rate": 1e-2,
                     "warmup_ratio": 0.0, "weight_decay": 0.1,
                     "output_dir": str(tmp_path / "out"), "save_steps": 1000},
           "data": {"data_path": _write_data(tmp_path),
                    "feature_folder": str(feats)},
           "parallel": {"n_data": 1, "n_model": 1}}
    _check_run(*_run_both(tmp_path, raw))


def test_run_training_images_matches_jax(tmp_path):
    """Stage 1 through `SupervisedDataset` with PNGs decoded by PIL and the
    tiny debug tower, grouped by modality length, with a mid-run
    `checkpoint-{step}` save pruned to the newest one."""
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (30 + 6 * i, 28, 3),
                                    dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    raw = {"model": {"vision_tower": "debug/tiny-vit", "decoder": "tiny"},
           "train": {"stage": 1, "batch_size": 2, "epochs": 2,
                     "bf16": False, "max_length": 64, "learning_rate": 1e-2,
                     "group_by_modality_length": True, "save_steps": 2,
                     "save_total_limit": 1,
                     "output_dir": str(tmp_path / "out")},
           "data": {"data_path": _write_data(tmp_path),
                    "image_folder": str(tmp_path)},
           "parallel": {"n_data": 1, "n_model": 1}}
    want, run, out_dir = _run_both(tmp_path, raw)
    _check_run(want, run, out_dir)
    assert sorted(os.listdir(out_dir)).count("checkpoint-6") == 1
    assert not any(d in os.listdir(out_dir) for d in ("checkpoint-2",
                                                      "checkpoint-4"))


def test_projector_checkpoint_round_trips_with_jax(tmp_path):
    _, jparams, tcfg, params = _configs(1)
    tckpt.save_projector(str(tmp_path / "port"), params.projector,
                         proj_type="mlp2x_gelu")
    back = jckpt.load_projector(str(tmp_path / "port"))
    for i, layer in enumerate(back["layers"]):
        w = params.projector.layers[i]
        np.testing.assert_array_equal(layer["kernel"], w.weight.numpy().T)
        np.testing.assert_array_equal(layer["bias"], w.bias.numpy())
    from law_of_vision_representation_in_mllms_tpu.models.projector import (
        export_projector_torch_sd)
    want_bin = export_projector_torch_sd(_jax_tree_np(jparams["projector"]))
    got_bin = torch.load(str(tmp_path / "port" / "mm_projector.bin"))
    assert set(got_bin) == set(want_bin)
    for k in want_bin:
        assert torch.equal(got_bin[k], want_bin[k]), k

    jckpt.save_projector(str(tmp_path / "jax"),
                         _jax_tree_np(jparams["projector"]))
    sd = tckpt.load_projector(str(tmp_path / "jax" / "mm_projector.npz"))
    for name, p in params.projector.state_dict().items():
        assert torch.equal(sd[name], p), name


def test_train_state_checkpoint_round_trips(tmp_path):
    """`params.npz` is the JAX params tree in the flat param_io layout: the
    JAX reader rebuilds the JAX tree, and `build_model` with the directory
    as `model.checkpoint` loads the newest one."""
    _, jparams, tcfg, params = _configs(2)
    ttc = TS.TrainConfig(stage=1, total_steps=10)
    state, opt = TS.init_train_state(params, ttc)
    TS.make_train_step(tcfg, ttc, opt)(state, _port_batch(_batch(1)))
    for step in (1, 2, 3):
        tckpt.save_train_state(str(tmp_path), params, opt, step, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2", "checkpoint-3"]
    assert tckpt.latest_checkpoint(str(tmp_path)).endswith("checkpoint-3")
    tree = jio.load_params(str(tmp_path / "checkpoint-3" / "params.npz"))
    assert jax.tree.structure(tree) == jax.tree.structure(
        _jax_tree_np(jparams))
    sd = from_jax.llava_state_dict(tree)
    for name, p in params.state_dict().items():
        assert torch.equal(sd[name], p), name
    opt_state = torch.load(str(tmp_path / "checkpoint-3" / "opt_state.pt"))
    assert opt_state["count"] == 1
    assert set(opt_state["mu"]) == {n for n, _ in opt.named_params}


def test_train_cli_from_yaml(tmp_path):
    """`train --config run.yaml --set ... --device cpu` runs to the end and
    a stage-2 run reads the stage-1 projector back through
    `train.pretrain_mm_mlp_adapter`."""
    import yaml
    feats = tmp_path / "feats"
    os.makedirs(feats)
    for i in range(3):
        np.save(feats / f"img{i}.npy", np.ones((576, 1280), np.float32))
    raw = {"model": {"vision_tower": "runwayml/stable-diffusion-v1-5_feature",
                     "decoder": "tiny"},
           "train": {"batch_size": 2, "bf16": False, "max_length": 64,
                     "output_dir": str(tmp_path / "s1")},
           "data": {"data_path": _write_data(tmp_path, 4),
                    "feature_folder": str(feats)}}
    with open(tmp_path / "run.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    assert cli.main(["train", "--config", str(tmp_path / "run.yaml"),
                     "--set", "train.epochs=2", "--device", "cpu"]) == 0
    s1 = tckpt.load_projector(str(tmp_path / "s1"))
    assert cli.main([
        "train", "--config", str(tmp_path / "run.yaml"), "--device", "cpu",
        "--set", "train.stage=2", "--set", "train.learning_rate=0",
        "--set", f"train.output_dir={tmp_path / 's2'}",
        "--set", f"train.pretrain_mm_mlp_adapter={tmp_path / 's1'}"]) == 0
    tree = jio.load_params(str(tmp_path / "s2" / "checkpoint-2" /
                               "params.npz"))
    sd = from_jax.projector_state_dict(tree["projector"])
    for name, w in s1.items():
        assert torch.equal(sd[name], w), name


def test_unported_training_options_raise():
    """Every training option of the JAX package runs on the port (tensor
    and pipeline parallelism of a quantised decoder and of the variants
    too: tests/test_torch_parallel_train.py); what stays refused is a
    variant without its weights, and a pipeline with LoRA, with the JAX
    words."""
    base = {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit"},
            "train": {"bf16": False}}
    for parallel in ({"n_model": 2}, {"pipeline": 2}):
        raw = json.loads(json.dumps(base))
        raw["parallel"] = parallel
        raw["train"]["quantize_base"] = "int4"
        assert runner.plan_mesh(RunConfig.from_dict(raw),
                                world_size=2).size == 2
    from law_of_vision_representation_in_mllms_torch.models.lora import (
        LoraConfig, init_lora)
    _, _, tcfg, params = _configs(0)
    with pytest.raises(ValueError, match="params.lora is None"):
        TS.init_train_state(params, TS.TrainConfig(lora_rank=8))
    params.lora = init_lora(torch.Generator().manual_seed(0), tcfg.decoder,
                            LoraConfig(rank=4, alpha=8.0), FP32_PRECISION)
    with pytest.raises(ValueError, match=r"not with cp or LoRA \(v1\)"):
        TM.loss_fn(params, tcfg, _port_batch(_batch(0)), pp=object())


def _queue1_headings():
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    q1 = text.split("### Queue 1", 1)[1].split("### Queue 2", 1)[0]
    return {int(n): title.lower() for n, title in
            re.findall(r"^(\d+)\. \*\*(.+?)\*\*", q1, flags=re.M)}


def test_not_ported_errors_point_at_roadmap_items():
    """Every `ROADMAP, queue 1: N, title` in the port names a queue-1 item
    of ROADMAP.md whose heading starts with that title and does not say
    DONE."""
    headings = _queue1_headings()
    assert len(headings) >= 9
    pkg = os.path.join(REPO, "law_of_vision_representation_in_mllms_torch")
    found = []
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                found += re.findall(r"(\d+), ([A-Za-z][A-Za-z -]*)\"", src)
                found += re.findall(r"queue 1: (\d+), ([A-Za-z][A-Za-z -]*)",
                                    src)
    # no citation is left: the last refusals (item 10's TP and pipeline of
    # a quantised decoder and TP of the variants; item 12's orbax train
    # states) went when those ran. A citation that comes back must name an
    # item still to do, under its heading
    for n, title in found:
        assert int(n) in headings, (n, title)
        assert headings[int(n)].startswith(title.strip().lower()), (
            n, title, headings[int(n)])
        assert "done" not in headings[int(n)], (n, headings[int(n)])
