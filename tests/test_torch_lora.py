"""The port's training variants (LoRA, QLoRA, switch) against the JAX
package on the tiny LLaVA of tests/test_torch_train.py: the same weights
(carried across with `io.from_jax`), the same seeded numpy batches, fp32 on
the CPU.

Covered: `init_lora` / `merge_lora` / the freeze labels, `loss_fn` and its
gradients with adapters on a dense and on an int4 base, `apply_switch` /
`switch_loss_fn`, three `make_train_step` steps per variant, `run_training`
with `lora_enable`, `switch_enable` and QLoRA against the JAX runner, the
saved `lora_adapters.npz` / `switch.npz` both ways, and `load_pretrained`.

Tolerances are those of tests/test_torch_train.py (loss 1e-5 relative,
gradients 1e-6 + 1e-4 relative, parameters PARAM_TOL plus Adam's
amplification of the gradients' rounding, entry by entry). The adapters make
that amplification the rule rather than the exception: B starts at 0, so A's
gradient is exactly 0 at step 1 and of size lr at step 2, where Adam divides
it by its own size; `_check_trained` therefore holds every entry to the
amplified bound and asks only that most entries meet PARAM_TOL alone.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as base
from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.io import checkpoint as jckpt
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import lora as JLora
from law_of_vision_representation_in_mllms_tpu.models import switch as JSwitch
from law_of_vision_representation_in_mllms_tpu.ops import quant as JQ
from law_of_vision_representation_in_mllms_tpu.train import runner as jrunner
from law_of_vision_representation_in_mllms_tpu.train import train_step as JS
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    DEFAULT_PRECISION, FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import checkpoint as tckpt
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import lora as TLora
from law_of_vision_representation_in_mllms_torch.models import switch as TSwitch
from law_of_vision_representation_in_mllms_torch.models.layers import (
    QuantDense)
from law_of_vision_representation_in_mllms_torch.ops import quant as TQ
from law_of_vision_representation_in_mllms_torch.train import runner
from law_of_vision_representation_in_mllms_torch.train import train_step as TS

torch.set_num_threads(1)
LOSS_RTOL, GRAD_TOL, PARAM_TOL = base.LOSS_RTOL, base.GRAD_TOL, base.PARAM_TOL
RANK, ALPHA = 4, 12.0           # scaling 3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_lora(jcfg, seed, nonzero_b=True, rank=RANK, alpha=ALPHA):
    lcfg = JLora.LoraConfig(rank=rank, alpha=alpha)
    lora = JLora.init_lora(jax.random.PRNGKey(seed), jcfg.decoder, lcfg)
    if nonzero_b:
        rng = np.random.RandomState(seed)
        lora = {k: (jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.05)
                    if k.endswith("_b") else v) for k, v in lora.items()}
    return lora


def _carry_lora(tcfg, jlora, rank=RANK, alpha=ALPHA):
    lora = TLora.LoraAdapters(tcfg.decoder,
                              TLora.LoraConfig(rank=rank, alpha=alpha),
                              FP32_PRECISION)
    lora.load_state_dict(from_jax.lora_state_dict(_np_tree(jlora)))
    return lora


def _lora_pair(seed, bits=None, nonzero_b=True):
    """The tiny LLaVA of both packages with the same adapters; with `bits`
    each side quantises its decoder with its own `quantize_decoder` (equal
    codes: tests/test_torch_quant.py)."""
    jcfg, jparams, tcfg, params = base._configs(seed)
    jlora = _jax_lora(jcfg, seed + 1, nonzero_b)
    if bits:
        jparams = dict(jparams, decoder=JQ.quantize_decoder(
            jparams["decoder"], bits=bits))
        TQ.quantize_decoder(params.decoder, bits=bits)
    params.lora = _carry_lora(tcfg, jlora)
    return jcfg, dict(jparams, lora=jlora), tcfg, params


# --- the adapters ----------------------------------------------------------

def test_lora_config_and_init_match_jax_layout():
    cfg = TL.tiny()
    lcfg = TLora.LoraConfig(rank=4, alpha=8.0)
    assert lcfg.scaling == JLora.LoraConfig(rank=4, alpha=8.0).scaling == 2.0
    assert TLora.LORA_TARGETS == JLora.LORA_TARGETS
    assert TLora.LoraConfig() == TLora.LoraConfig(
        rank=JLora.LoraConfig().rank, alpha=JLora.LoraConfig().alpha)
    g = torch.Generator().manual_seed(0)
    lora = TLora.init_lora(g, cfg, lcfg, FP32_PRECISION)
    jlora = JLora.init_lora(jax.random.PRNGKey(0), JL.tiny(),
                            JLora.LoraConfig(rank=4, alpha=8.0))
    tree = from_jax.lora_tree(lora.state_dict())
    assert set(tree) == set(jlora)
    for k, v in jlora.items():
        assert tree[k].shape == v.shape, k
        if k.endswith("_b"):
            assert (tree[k] == 0).all()
        else:   # A ~ 0.01 * N(0, 1) on both sides
            assert abs(tree[k].std() - 0.01) < 0.002
            assert abs(float(np.asarray(v).std()) - 0.01) < 0.002
    again = TLora.init_lora(torch.Generator().manual_seed(0), cfg, lcfg,
                            FP32_PRECISION)
    for (n, a), b in zip(lora.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
    # bf16 default precision keeps fp32 master adapters
    assert TLora.init_lora(torch.Generator().manual_seed(0), cfg, lcfg,
                           DEFAULT_PRECISION).layers[0].wq_a.dtype \
        == torch.float32


def test_lora_tree_round_trips_bit_for_bit():
    jcfg, jparams, tcfg, params = _lora_pair(0)
    tree = _np_tree(jparams["lora"])
    back = from_jax.lora_tree(params.lora.state_dict())
    assert set(back) == set(tree)
    for k in tree:
        np.testing.assert_array_equal(back[k], tree[k])
    whole = from_jax.llava_tree(params)
    assert jax.tree.structure(whole) == jax.tree.structure(_np_tree(jparams))
    sd = from_jax.llava_state_dict(whole)
    assert set(sd) == set(params.state_dict())
    for name, t in params.state_dict().items():
        assert torch.equal(sd[name], t), name


def _decoder_hidden(params, tcfg, lora, scaling, seed=3):
    rng = np.random.RandomState(seed)
    embeds = torch.from_numpy(rng.randn(2, 7, tcfg.decoder.hidden_size)
                              .astype(np.float32))
    pos = torch.arange(7)[None].expand(2, 7)
    with torch.no_grad():
        return params.decoder(embeds, pos, lora=lora,
                              lora_scaling=scaling)[0], embeds, pos


def test_zero_init_is_a_noop_and_nonzero_adapters_change_the_output():
    _, _, tcfg, params = base._configs(0)
    lcfg = TLora.LoraConfig(rank=RANK, alpha=ALPHA)
    fresh = TLora.init_lora(torch.Generator().manual_seed(1), tcfg.decoder,
                            lcfg, FP32_PRECISION)
    plain, _, _ = _decoder_hidden(params, tcfg, None, 1.0)
    zero, _, _ = _decoder_hidden(params, tcfg, fresh, lcfg.scaling)
    assert torch.equal(zero, plain)
    with torch.no_grad():
        for layer in fresh.layers:
            layer.wo_a.normal_(0, 1.0)
            layer.wo_b.normal_(0, 1.0)
    moved, _, _ = _decoder_hidden(params, tcfg, fresh, lcfg.scaling)
    assert (moved - plain).abs().amax(-1).min() > 1e-1


def test_merge_lora_equals_the_adapted_forward():
    """Port against port and against the JAX `merge_lora`; a quantised base
    refuses the merge."""
    jcfg, jparams, tcfg, params = _lora_pair(2)
    lcfg = TLora.LoraConfig(rank=RANK, alpha=ALPHA)
    adapted, embeds, pos = _decoder_hidden(params, tcfg, params.lora,
                                           lcfg.scaling)
    before = {n: p.clone() for n, p in params.decoder.state_dict().items()}
    assert TLora.merge_lora(params.decoder, params.lora) is params.decoder
    with torch.no_grad():
        merged = params.decoder(embeds, pos)[0]
    np.testing.assert_allclose(merged.numpy(), adapted.numpy(), atol=2e-6,
                               rtol=1e-5)
    want = from_jax.llama_state_dict(_np_tree(JLora.merge_lora(
        jparams["decoder"], jparams["lora"],
        JLora.LoraConfig(rank=RANK, alpha=ALPHA))))
    for name, w in want.items():
        np.testing.assert_allclose(
            params.decoder.state_dict()[name].numpy(), w.numpy(), atol=1e-7,
            rtol=1e-6, err_msg=name)
    assert not torch.equal(before["layers.0.wq.weight"],
                           params.decoder.layers[0].wq.weight)
    assert torch.equal(before["embed"], params.decoder.embed)
    _, _, _, q = _lora_pair(2, bits=4)
    with pytest.raises(ValueError, match="quantised"):
        TLora.merge_lora(q.decoder, q.lora)


def _jax_labels(jparams, stage):
    """The JAX label tree as {port parameter name: label}."""
    labels = JS._freeze_labels(jparams, stage)
    flat = {}
    for sub, conv in (("projector", from_jax.projector_state_dict),
                      ("decoder", from_jax.llama_state_dict),
                      ("lora", from_jax.lora_state_dict),
                      ("switch", from_jax.switch_state_dict)):
        if sub not in jparams:
            continue
        as_num = jax.tree.map(
            lambda lab, p: np.full(np.shape(p), lab == "train"),
            labels[sub], jparams[sub])
        for name, t in conv(_np_tree(as_num), f"{sub}.").items():
            flat[name] = "train" if bool(t.all()) else "freeze"
    return flat


@pytest.mark.parametrize("variant,stage", [
    ("plain", 1), ("plain", 2), ("lora", 1), ("lora", 2), ("switch", 2)])
def test_freeze_labels_match_jax(variant, stage):
    jcfg, jparams, tcfg, params = base._configs(0)
    if variant == "lora":
        jcfg, jparams, tcfg, params = _lora_pair(0)
    if variant == "switch":
        jparams = dict(jparams, switch=JSwitch.init_switch(
            jax.random.PRNGKey(2), jcfg.decoder.hidden_size))
        params.switch = TSwitch.Switch(tcfg.decoder.hidden_size,
                                       FP32_PRECISION)
    got = TS._freeze_labels(params, stage)
    assert all(v == "freeze" for k, v in got.items()
               if k.startswith("towers."))
    want = _jax_labels(jparams, stage)
    assert {k: v for k, v in got.items()
            if not k.startswith("towers.")} == want
    trainable = {n.split(".")[0] for n, _ in TS.apply_freeze(params, stage)}
    assert trainable == {("plain", 1): {"projector"},
                         ("plain", 2): {"projector", "decoder"},
                         ("lora", 1): {"projector", "lora"},
                         ("lora", 2): {"projector", "lora"},
                         ("switch", 2): {"switch"}}[(variant, stage)]


@pytest.mark.parametrize("bits,use_flash", [(None, False), (None, True),
                                            (4, False), (8, False)])
def test_lora_loss_and_grads_match_jax(bits, use_flash):
    """Adapters from `init_lora` with a non-zero B, on a dense base (both
    attention routes) and on an int4 / int8 base (the QLoRA forward: dense
    deltas on top of the quantised product)."""
    jcfg, jparams, tcfg, params = _lora_pair(0, bits=bits)
    batch = base._batch(0)
    scaling = ALPHA / RANK

    def jloss(projector, lora):
        p = dict(jparams, projector=projector, lora=lora)
        return JM.loss_fn(p, jcfg, base._jax_batch(batch), J_FP32,
                          use_flash=use_flash, lora_scaling=scaling)
    want, (g_proj, g_lora) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jparams["projector"], jparams["lora"])
    TS.apply_freeze(params, stage=2)
    if bits:
        assert isinstance(params.decoder.layers[0].wq, QuantDense)
    loss = TM.loss_fn(params, tcfg, base._port_batch(batch),
                      use_flash=use_flash, lora_scaling=scaling)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    no_lora = TM.loss_fn(base._configs(0)[3], tcfg, base._port_batch(batch))
    if not bits:
        assert abs(no_lora.item() - loss.item()) > 1e-4
    grads = {n: p.grad for n, p in params.named_parameters()
             if p.grad is not None}
    want_g = from_jax.projector_state_dict(_np_tree(g_proj), "projector.")
    want_g.update(from_jax.lora_state_dict(_np_tree(g_lora), "lora."))
    assert set(grads) == set(want_g)
    for name, g in want_g.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD_TOL)


# --- the switch ------------------------------------------------------------

def _switch_pair(seed):
    jcfg, jparams, tcfg, params = base._configs(seed)
    jsw = JSwitch.init_switch(jax.random.PRNGKey(seed + 2),
                              jcfg.decoder.hidden_size)
    params.switch = TSwitch.Switch(tcfg.decoder.hidden_size, FP32_PRECISION)
    params.switch.load_state_dict(from_jax.switch_state_dict(_np_tree(jsw)))
    return jcfg, dict(jparams, switch=jsw), tcfg, params


def test_apply_switch_and_init_match_jax():
    jcfg, jparams, tcfg, params = _switch_pair(0)
    h = np.random.RandomState(0).randn(2, 5, 32).astype(np.float32)
    for sigma in (1.0, 0.3):
        want = JSwitch.apply_switch(jparams["switch"], jnp.asarray(h), sigma)
        got = TSwitch.apply_switch(params.switch, torch.from_numpy(h), sigma)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)
    sw = TSwitch.init_switch(torch.Generator().manual_seed(0), 64,
                             FP32_PRECISION)
    assert sw.w.shape == (64, 64) and abs(sw.w.std().item() - 0.02) < 0.002
    np.testing.assert_array_equal(
        from_jax.switch_tree(params.switch.state_dict())["w"],
        np.asarray(jparams["switch"]["w"]))


@pytest.mark.parametrize("use_flash", [False, True])
def test_switch_loss_and_grad_match_jax(use_flash):
    """The JAX `switch_loss_fn` runs its plain attention; the port's flash
    route (the plain version of kernel 2 here) computes the same loss."""
    jcfg, jparams, tcfg, params = _switch_pair(1)
    batch = base._batch(1)
    sigma = 0.7

    def jloss(sw):
        return JSwitch.switch_loss_fn(dict(jparams, switch=sw), jcfg,
                                      base._jax_batch(batch), sigma, J_FP32)
    want, g_want = jax.value_and_grad(jloss)(jparams["switch"])
    trainable = TS.apply_freeze(params, stage=2)
    assert [n for n, _ in trainable] == ["switch.w"]
    loss = TSwitch.switch_loss_fn(params, tcfg, base._port_batch(batch),
                                  sigma, use_flash=use_flash)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(params.switch.w.grad.numpy(),
                               np.asarray(g_want["w"]), **GRAD_TOL)
    assert all(p.grad is None for n, p in params.named_parameters()
               if n != "switch.w")


# --- train steps -----------------------------------------------------------

def _adam_bound(opt, name, w):
    return base._adam_tolerance(types.SimpleNamespace(opt=opt), name, w)


def _check_trained(opt, got_sd, want_sd, min_tight=0.9):
    """Every trained entry within PARAM_TOL plus the Adam bound; at least
    `min_tight` of them within PARAM_TOL alone."""
    n_tight = n_all = 0
    for name, w in want_sd.items():
        w = w.numpy()
        diff = np.abs(got_sd[name].detach().numpy() - w)
        tol = _adam_bound(opt, name, w)
        assert (diff <= tol).all(), (name, float((diff - tol).max()))
        n_tight += int((diff <= PARAM_TOL["atol"]
                        + PARAM_TOL["rtol"] * np.abs(w)).sum())
        n_all += diff.size
    assert n_tight >= min_tight * n_all, (n_tight, n_all)


@pytest.mark.parametrize("variant", ["lora", "qlora", "switch"])
def test_variant_train_step_matches_jax(variant):
    """Three `make_train_step` steps from the same state: per-step loss and
    gradient norm, the trained leaves, and everything frozen bitwise
    untouched. The adapters start as `init_lora` leaves them (B = 0)."""
    if variant == "switch":
        jcfg, jparams, tcfg, params = _switch_pair(7)
        extra = dict(switch_sigma=0.5)
    else:
        jcfg, jparams, tcfg, params = _lora_pair(
            7, bits=4 if variant == "qlora" else None, nonzero_b=False)
        extra = dict(lora_rank=RANK, lora_alpha=ALPHA)
    opts = dict(stage=2, learning_rate=1e-3, weight_decay=0.01,
                total_steps=20, warmup_ratio=0.1, **extra)
    jtc, ttc = JS.TrainConfig(**opts), TS.TrainConfig(**opts)
    assert ttc.lora_scaling == jtc.lora_scaling
    jstate, jopt = JS.init_train_state(jparams, jtc)
    jstep = jax.jit(JS.make_train_step(jcfg, jtc, jopt, J_FP32))
    frozen = {n: p.clone() for n, p in params.state_dict().items()}
    state, opt = TS.init_train_state(params, ttc)
    step = TS.make_train_step(tcfg, ttc, opt)
    for i in (1, 2, 3):
        b = base._batch(i)
        jstate, jm = jstep(jstate, base._jax_batch(b))
        state, tm = step(state, base._port_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        assert float(tm["skipped_nonfinite"]) == 0.0
    trained = {n for n, _ in opt.named_params}
    assert {n.split(".")[0] for n in trained} == (
        {"switch"} if variant == "switch" else {"projector", "lora"})
    jp = _np_tree(jstate["params"])
    want = {}
    if variant == "switch":
        want.update(from_jax.switch_state_dict(jp["switch"], "switch."))
    else:
        want.update(from_jax.projector_state_dict(jp["projector"],
                                                  "projector."))
        want.update(from_jax.lora_state_dict(jp["lora"], "lora."))
    assert set(want) == trained
    sd = params.state_dict()
    _check_trained(opt, sd, want)
    for name, p in sd.items():
        if name in trained:
            assert not torch.equal(p, frozen[name]), name
        else:
            assert torch.equal(p, frozen[name]), name


def test_train_state_needs_matching_variant_params():
    _, _, tcfg, params = base._configs(0)
    with pytest.raises(ValueError, match="params.lora"):
        TS.init_train_state(params, TS.TrainConfig(lora_rank=8))
    with pytest.raises(ValueError, match="params.switch"):
        TS.init_train_state(params, TS.TrainConfig(switch_sigma=1.0))
    params.switch = TSwitch.Switch(tcfg.decoder.hidden_size, FP32_PRECISION)
    with pytest.raises(ValueError, match="params.switch"):
        TS.init_train_state(params, TS.TrainConfig())


# --- run_training ----------------------------------------------------------

def _feature_run(tmp_path, **train):
    feats = tmp_path / "feats"
    os.makedirs(feats)
    rng = np.random.RandomState(0)
    for i in range(3):
        np.save(feats / f"img{i}.npy",
                rng.randn(576, 1280).astype(np.float32))
    return {"model": {"vision_tower": "runwayml/stable-diffusion-v1-5_feature",
                      "decoder": "tiny"},
            "train": dict({"stage": 2, "batch_size": 2, "epochs": 1,
                           "bf16": False, "max_length": 64,
                           "learning_rate": 1e-3, "warmup_ratio": 0.0,
                           "output_dir": str(tmp_path / "out"),
                           "save_steps": 1000}, **train),
            "data": {"data_path": base._write_data(tmp_path),
                     "feature_folder": str(feats)},
            "parallel": {"n_data": 1, "n_model": 1}}


def _run_both(tmp_path, raw, monkeypatch):
    """The JAX runner, then the port's runner from the JAX runner's initial
    weights, adapters and switch matrix: the JAX runner draws those from
    PRNGKey(seed + 1) / PRNGKey(seed + 2), so the same leaves are handed to
    the port in place of its own seeded init."""
    jcfg = JRunConfig.from_dict(raw)
    model_cfg, jparams = jrunner.build_model(jcfg)
    init = str(tmp_path / "init.npz")
    jio.save_params(init, _np_tree(jparams))
    assert jrunner.run_training(jcfg) == 0
    seed = jcfg.train.seed

    def carried_lora(generator, cfg, lora_cfg, precision, device):
        jl = JLora.init_lora(jax.random.PRNGKey(seed + 1), model_cfg.decoder,
                             JLora.LoraConfig(rank=lora_cfg.rank,
                                              alpha=lora_cfg.alpha))
        lora = TLora.LoraAdapters(cfg, lora_cfg, precision, device=device)
        lora.load_state_dict(from_jax.lora_state_dict(_np_tree(jl)))
        return lora

    def carried_switch(generator, hidden_size, precision, device):
        sw = TSwitch.Switch(hidden_size, precision, device=device)
        sw.load_state_dict(from_jax.switch_state_dict(_np_tree(
            JSwitch.init_switch(jax.random.PRNGKey(seed + 2), hidden_size))))
        return sw
    monkeypatch.setattr(runner, "init_lora", carried_lora)
    monkeypatch.setattr(runner, "init_switch", carried_switch)
    traw = json.loads(json.dumps(raw))
    traw["train"]["output_dir"] += "_port"
    traw["model"]["checkpoint"] = init
    traw["parallel"] = {}
    run = runner.run_training(RunConfig.from_dict(traw), device="cpu")
    return run, raw["train"]["output_dir"], traw["train"]["output_dir"]


def _check_logs(jdir, tdir, n=3):
    jl, tl = base._logs(jdir), base._logs(tdir)
    assert len(jl) == len(tl) == n
    for r, jr in zip(tl, jl):
        assert r["skipped_nonfinite"] == 0.0
        np.testing.assert_allclose(r["loss"], jr["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], jr["grad_norm"],
                                   rtol=GRAD_TOL["rtol"])


@pytest.mark.parametrize("base_quant", [None, "int4"])
def test_run_training_lora_matches_jax(tmp_path, monkeypatch, base_quant):
    """Stage 2 with `train.lora_enable` (and `train.quantize_base=int4`:
    QLoRA) against the JAX runner: per-step loss and gradient norm, the
    saved adapters and projector; each package loads the other's files."""
    extra = {"quantize_base": base_quant} if base_quant else {}
    raw = _feature_run(tmp_path, lora_enable=True, lora_r=4, lora_alpha=8.0,
                       **extra)
    run, jdir, tdir = _run_both(tmp_path, raw, monkeypatch)
    _check_logs(jdir, tdir)
    params = run.state["params"]
    assert {n.split(".")[0] for n, _ in run.opt.named_params} == {
        "projector", "lora"}
    assert run.train_cfg.lora_rank == 4 and run.train_cfg.lora_scaling == 2.0
    if base_quant:
        assert params.decoder.layers[0].down.kind == "q4"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "config.json", "lora_adapters.npz", "mm_projector.npz",
        "train.jsonl"]
    assert json.load(open(os.path.join(tdir, "config.json"))) == json.load(
        open(os.path.join(jdir, "config.json"))) == {"lora_r": 4,
                                                     "lora_alpha": 8.0}
    # the JAX reader takes the port's files, the port's reader the JAX ones
    want_lora = jio.load_params(os.path.join(jdir, "lora_adapters.npz"))
    got_lora = jio.load_params(os.path.join(tdir, "lora_adapters.npz"))
    assert jax.tree.structure(got_lora) == jax.tree.structure(want_lora)
    back = from_jax.lora_state_dict(got_lora)
    for name, t in params.lora.state_dict().items():
        assert torch.equal(back[name], t), name
    assert all((got_lora[k] != 0).any() for k in got_lora
               if k.endswith("_b"))
    want = from_jax.lora_state_dict(want_lora, "lora.")
    want.update(from_jax.projector_state_dict(
        jckpt.load_projector(jdir), "projector."))
    got = dict(params.state_dict())
    _check_trained(run.opt, got, want)
    proj = tckpt.load_projector(jdir)
    assert set(proj) == set(params.projector.state_dict())


def test_run_training_switch_matches_jax(tmp_path, monkeypatch):
    raw = _feature_run(tmp_path, switch_enable=True, switch_sigma=0.5)
    run, jdir, tdir = _run_both(tmp_path, raw, monkeypatch)
    _check_logs(jdir, tdir)
    assert [n for n, _ in run.opt.named_params] == ["switch.w"]
    assert run.train_cfg.switch_sigma == 0.5
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "switch.npz", "train.jsonl"]
    want = jio.load_params(os.path.join(jdir, "switch.npz"))
    got = jio.load_params(os.path.join(tdir, "switch.npz"))
    assert set(got) == set(want) == {"w"}
    assert torch.equal(from_jax.switch_state_dict(got)["w"],
                       run.state["params"].switch.w)
    _check_trained(run.opt, {"switch.w": run.state["params"].switch.w},
                   from_jax.switch_state_dict(want, "switch."))
    # only W moved: the rest equals the initial weights bit for bit
    init = from_jax.load_llava_npz(str(tmp_path / "init.npz"))
    for name, t in run.state["params"].state_dict().items():
        if name != "switch.w":
            assert torch.equal(t, init[name]), name


def test_variant_runner_options_are_checked(tmp_path):
    raw = _feature_run(tmp_path, quantize_base="int4")
    with pytest.raises(ValueError, match="stage 1 or lora_enable"):
        runner.run_training(RunConfig.from_dict(raw), device="cpu")
    with pytest.raises(ValueError, match="stage 1 or lora_enable"):
        jrunner.run_training(JRunConfig.from_dict(raw))


def test_train_cli_runs_the_variants(tmp_path):
    """`train --set train.lora_enable=true` (with `train.quantize_base`:
    QLoRA) and `--set train.switch_enable=true` through the CLI, as the JAX
    `train` command takes them: from the RunConfig alone."""
    from law_of_vision_representation_in_mllms_torch import cli
    raw = _feature_run(tmp_path)
    raw["parallel"] = {}
    import yaml
    with open(tmp_path / "run.yaml", "w") as f:
        yaml.safe_dump(raw, f)
    for name, sets in (("qlora", ["train.lora_enable=true", "train.lora_r=2",
                                  "train.quantize_base=int8"]),
                       ("switch", ["train.switch_enable=true"])):
        out = tmp_path / name
        args = ["train", "--config", str(tmp_path / "run.yaml"), "--device",
                "cpu", "--set", f"train.output_dir={out}"]
        for kv in sets:
            args += ["--set", kv]
        assert cli.main(args) == 0
        want = {"qlora": ["config.json", "lora_adapters.npz",
                          "mm_projector.npz", "train.jsonl"],
                "switch": ["switch.npz", "train.jsonl"]}[name]
        assert sorted(os.listdir(out)) == want
        assert all(np.isfinite(r["loss"]) for r in base._logs(str(out)))
    lora = jio.load_params(str(tmp_path / "qlora" / "lora_adapters.npz"))
    assert lora["wq_a"].shape[-1] == 2


# --- load_pretrained -------------------------------------------------------

@pytest.mark.parametrize("name", ["lora_adapters.npz", "lora.npz"])
def test_load_pretrained_merges_trained_adapters(tmp_path, name):
    """Two LoRA steps through the port's runner, then `load_pretrained` on
    the output directory over the base model: the decoder equals
    `merge_lora` of the trained adapters and the projector is the trained
    one. The JAX `load_pretrained` looks for `lora.npz`, a name no runner
    writes (ROADMAP, queue 3); the port reads `lora_adapters.npz` and takes
    `lora.npz` too."""
    raw = _feature_run(tmp_path, lora_enable=True, lora_r=4, lora_alpha=12.0)
    raw["data"]["data_path"] = base._write_data(tmp_path, 4)
    raw["parallel"] = {}
    cfg = RunConfig.from_dict(raw)
    run = runner.run_training(cfg, device="cpu")
    assert run.state["step"] == 2
    out = raw["train"]["output_dir"]
    if name != "lora_adapters.npz":
        os.rename(os.path.join(out, "lora_adapters.npz"),
                  os.path.join(out, name))
    trained = run.state["params"]
    _, fresh = runner.build_model(cfg, device="cpu",
                                  precision=FP32_PRECISION)
    for n, p in fresh.decoder.state_dict().items():     # the frozen base
        assert torch.equal(p, trained.decoder.state_dict()[n]), n
    assert tckpt.load_pretrained(out, fresh) is fresh
    assert fresh.lora is None
    TLora.merge_lora(trained.decoder, trained.lora)
    for n, p in trained.decoder.state_dict().items():
        assert torch.equal(fresh.decoder.state_dict()[n], p), n
    assert not torch.equal(
        fresh.decoder.layers[0].wq.weight,
        runner.build_model(cfg, device="cpu", precision=FP32_PRECISION
                           )[1].decoder.layers[0].wq.weight)
    for n, p in trained.projector.state_dict().items():
        assert torch.equal(fresh.projector.state_dict()[n], p), n
    # alpha came from config.json (12 / 4 = 3, not LoraConfig()'s 2); an
    # explicit lora_cfg wins
    _, other = runner.build_model(cfg, device="cpu",
                                  precision=FP32_PRECISION)
    tckpt.load_pretrained(out, other, lora_cfg=TLora.LoraConfig(rank=4,
                                                                alpha=4.0))
    assert not torch.equal(other.decoder.layers[0].wq.weight,
                           fresh.decoder.layers[0].wq.weight)


def test_load_pretrained_prefers_a_full_checkpoint(tmp_path):
    _, _, tcfg, params = base._configs(3)
    ttc = TS.TrainConfig(stage=2, total_steps=10)
    state, opt = TS.init_train_state(params, ttc)
    TS.make_train_step(tcfg, ttc, opt)(state, base._port_batch(base._batch(1)))
    tckpt.save_train_state(str(tmp_path), params, opt, 1)
    _, _, _, fresh = base._configs(4)
    tckpt.load_pretrained(str(tmp_path), fresh)
    for n, p in params.state_dict().items():
        assert torch.equal(fresh.state_dict()[n], p), n
    # the reference's torch projector file alone
    proj_dir = tmp_path / "proj"
    tckpt.save_projector(str(proj_dir), params.projector,
                         proj_type="mlp2x_gelu")
    os.remove(proj_dir / "mm_projector.npz")
    _, _, _, other = base._configs(5)
    tckpt.load_pretrained(str(proj_dir), other)
    for n, p in params.projector.state_dict().items():
        assert torch.equal(other.projector.state_dict()[n], p), n
    assert not torch.equal(other.decoder.embed, params.decoder.embed)
