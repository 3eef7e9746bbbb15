"""The port's pipeline parallelism (`parallel/pipeline.py`) against the JAX
package's, in one process:

- the GPipe loss of `llava.loss_fn(pp=...)`, every stage run here through
  `LocalHandoff`, against the JAX `loss_fn(pp=...)` (its
  `forward_pipelined`) on a (data 2, stage 2) mesh of the host devices: the
  loss (rtol 1e-5) and every trainable leaf's gradient (atol 3e-5, rtol
  1e-3, `tests/test_context_parallel.py`'s) of stage 2 at M = 2 and 4
  microbatches and with `remat_ticks` and block remat, fp32;
- a stage's held layers and its leaves' plans (`init_sharded_train_state(
  pipeline=True)` on a plan mesh);
- `pp_layer_specs`, `memory_report` and `derived_state_specs` of the 7B
  tree with stage-sharded layers, equal to the JAX functions';
- every refusal of context and pipeline parallelism through
  `plan_mesh(world_size=...)`, with the JAX words, and the variants'
  combinations it accepts.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import test_torch_train as base
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import towers as JT
from law_of_vision_representation_in_mllms_tpu.models import vit as JV
from law_of_vision_representation_in_mllms_tpu.ops.ring_attention import (
    ContextParallel as JContextParallel)
from law_of_vision_representation_in_mllms_tpu.parallel import fsdp as jfsdp
from law_of_vision_representation_in_mllms_tpu.parallel import (
    make_mesh as jmake_mesh)
from law_of_vision_representation_in_mllms_tpu.parallel import (
    pipeline as jpipeline)
from law_of_vision_representation_in_mllms_tpu.train import train_step as JS
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import towers as TT
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_torch.parallel import (
    fsdp, make_mesh, pipeline)
from law_of_vision_representation_in_mllms_torch.train import runner
from law_of_vision_representation_in_mllms_torch.train import train_step as TS

torch.set_num_threads(1)

DEC = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
           num_kv_heads=2, intermediate_size=64)
GRAD_TOL = dict(atol=3e-5, rtol=1e-3)


def _entry(tower_mod, cfg_cls):
    vit = cfg_cls(image_size=14, patch_size=7, hidden_size=16, num_layers=2,
                  num_heads=2, intermediate_size=32)
    return tower_mod.TowerEntry(name="tiny", kind="vit", vit_config=vit,
                                vit_family="clip", hidden_size=16,
                                num_patches=vit.num_patches)


@functools.lru_cache(maxsize=None)
def _models():
    """(JAX cfg, JAX params, port cfg, port initial state dict): the port's
    seeded weights carried to the JAX tree."""
    jcfg = JM.LlavaConfig(tower_spec=JT.TowerSpec(
        entries=[_entry(JT, JV.ViTConfig)], join="single"),
        decoder=JL.tiny(**DEC))
    tcfg = TM.LlavaConfig(tower_spec=TT.TowerSpec(
        entries=[_entry(TT, TV.ViTConfig)], join="single"),
        decoder=TL.tiny(**DEC))
    params = TM.init_params(torch.Generator().manual_seed(11), tcfg,
                            FP32_PRECISION)
    jparams = jax.tree.map(jax.numpy.asarray, from_jax.llava_tree(params))
    return jcfg, jparams, tcfg, params.state_dict()


def _port_params():
    _, _, tcfg, sd = _models()
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(sd)
    return params.eval()


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(micro, remat_ticks, remat):
    jcfg, jparams, _, _ = _models()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "stage"))
    pp = jpipeline.PipelineParallel(mesh, microbatches=micro,
                                    remat_ticks=remat_ticks)
    batch = base._jax_batch(base._batch(3))
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JM.loss_fn(p, jcfg, batch, J_FP32, pp=pp,
                                 remat=remat)))(jparams)
    return float(loss), from_jax.llava_state_dict(base._jax_tree_np(grads))


@pytest.mark.parametrize("micro,remat_ticks,remat", [
    (2, False, False), (4, False, False), (4, True, True)])
def test_gpipe_loss_matches_jax(micro, remat_ticks, remat):
    """Stage 2 (projector and decoder train) over 2 stages of 2 layers."""
    want_loss, want = _jax_loss_and_grads(micro, remat_ticks, remat)
    _, _, tcfg, _ = _models()
    params = _port_params()
    trainable = TS.apply_freeze(params, 2)
    pp = pipeline.PipelineParallel(make_mesh(n_stage=2, world_size=2),
                                   microbatches=micro,
                                   remat_ticks=remat_ticks,
                                   handoff=pipeline.LocalHandoff(2))
    loss = TM.loss_fn(params, tcfg, base._port_batch(base._batch(3)), pp=pp,
                      remat=remat)
    grads = torch.autograd.grad(loss, [p for _, p in trainable])
    loss = float(loss.detach())
    np.testing.assert_allclose(loss, want_loss, rtol=base.LOSS_RTOL)
    for (name, _), g in zip(trainable, grads):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL)
    # the unpipelined loss of the same weights, for good measure
    flat = TM.loss_fn(params, tcfg, base._port_batch(base._batch(3)),
                      remat=remat)
    np.testing.assert_allclose(loss, float(flat.detach()), rtol=1e-6)


def test_a_stage_holds_its_layers():
    """Stage 1 of 2 keeps layers 2 and 3; their leaves are planned as held
    by a stage, the others whole on every stage."""
    _, _, tcfg, _ = _models()
    params = _port_params()
    mesh = make_mesh(n_data=1, n_stage=2, world_size=2, rank=1)
    assert mesh.coord("stage") == 1
    _, opt = TS.init_sharded_train_state(
        params, TS.TrainConfig(stage=2, total_steps=10), tcfg, mesh, zero=2,
        min_size=0, pipeline=True)
    assert params.decoder.held == range(2, 4)
    held = {n.split(".")[2] for n, _ in params.named_parameters()
            if n.startswith("decoder.layers.")}
    assert held == {"2", "3"}
    assert {p.staged for p in opt.plans if p.name.startswith(
        "decoder.layers.")} == {True}
    assert not any(p.staged for p in opt.plans
                   if not p.name.startswith("decoder.layers."))
    assert TS._stage_names("decoder.layers.3.wq.weight", range(2, 4), 2) == \
        ["decoder.layers.1.wq.weight", "decoder.layers.3.wq.weight"]
    with pytest.raises(ValueError, match=r"zero<=2"):
        TS.init_sharded_train_state(_port_params(), TS.TrainConfig(stage=2),
                                    tcfg, mesh, zero=3, pipeline=True)


@pytest.fixture(scope="module")
def tree7b_pp():
    """The JAX 7B LLaVA's shapes and moments' shapes with its ZeRO-2 spec
    tree under a pipeline, on a (data 4, stage 2) mesh."""
    mesh = jmake_mesh(n_data=4, n_stage=2, n_model=1)
    cfg = JM.LlavaConfig.build("openai/clip-vit-large-patch14-336",
                               decoder=JL.vicuna_7b())
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    opt = JS.make_optimizer(shapes, JS.TrainConfig(stage=2,
                                                   total_steps=100))
    o_shapes = jax.eval_shape(opt.init, shapes)
    specs = JS.param_partition_tree(shapes, cfg, mesh, zero=2, pipeline=True)
    return mesh, shapes, o_shapes, specs


def test_stage_sharded_specs_and_memory_match_jax(tree7b_pp):
    """`pp_layer_specs`, and `memory_report` / `derived_state_specs` of
    stage-sharded layers, give the JAX answers."""
    jmesh, shapes, o_shapes, jspecs = tree7b_pp
    dec = JL.param_partition_specs(JL.vicuna_7b())
    want = jpipeline.pp_layer_specs(dec)
    got = pipeline.pp_layer_specs(
        {"layers": {k: fsdp.P(*s) for k, s in dec["layers"].items()}})
    assert {k: tuple(s) for k, s in got.items()} == \
        {k: tuple(s) for k, s in want.items()}
    pmesh = make_mesh(n_data=4, n_stage=2, world_size=8)
    specs = jax.tree.map(lambda s: fsdp.P(*s), jspecs,
                         is_leaf=lambda x: isinstance(x, jax.sharding.
                                                      PartitionSpec))
    assert fsdp.memory_report(shapes, specs, pmesh) == \
        jfsdp.memory_report(shapes, jspecs, jmesh)
    want_o = jfsdp.derived_state_specs(o_shapes, jspecs, jmesh)
    got_o = fsdp.derived_state_specs(o_shapes, specs, pmesh)
    assert [tuple(s) for s in fsdp.tree_leaves(got_o)] == [
        tuple(s) for s in jax.tree.leaves(
            want_o, is_leaf=lambda x: isinstance(x, jax.sharding.
                                                 PartitionSpec))]
    assert fsdp.memory_report(o_shapes, got_o, pmesh) == \
        jfsdp.memory_report(o_shapes, want_o, jmesh)


def _raw(**parallel):
    return {"model": {"decoder": "tiny"},
            "train": {"batch_size": 8, "grad_accum": 1},
            "parallel": parallel}


def test_plan_mesh_accepts_seq_and_pipeline():
    mesh = runner.plan_mesh(RunConfig.from_dict(_raw(
        n_data=2, seq=2, n_model=2)), world_size=8)
    assert mesh.shape == {"data": 2, "seq": 2, "model": 2}
    mesh = runner.plan_mesh(RunConfig.from_dict(_raw(
        n_data=2, pipeline=2, pp_microbatches=4)), world_size=4)
    assert mesh.shape == {"data": 2, "stage": 2, "model": 1}


@pytest.mark.parametrize("parallel,train", [
    (dict(pipeline=2), dict(quantize_base="int4")),
    (dict(n_model=2), dict(stage=2, lora_enable=True,
                           quantize_base="int8")),
    (dict(seq=2), dict(stage=2, switch_enable=True)),
    (dict(pipeline=2, n_model=2), dict(stage=2, switch_enable=True)),
])
def test_plan_mesh_accepts_the_variants(parallel, train):
    """A quantised decoder in a pipeline or tensor-parallel, and the switch
    with `seq` or a pipeline, plan their mesh (the gloo world of
    tests/test_torch_parallel_train.py trains them)."""
    raw = _raw(**parallel)
    raw["train"].update(train)
    mesh = runner.plan_mesh(RunConfig.from_dict(raw), world_size=4)
    assert {k: mesh.n(k) for k in ("stage", "seq", "model")} == {
        "stage": parallel.get("pipeline", 1), "seq": parallel.get("seq", 1),
        "model": parallel.get("n_model", 1)}


def _jax_loss_fn_refusal():
    """The JAX `loss_fn`'s words for a pipeline with cp."""
    jcfg, jparams, _, _ = _models()
    mesh = jmake_mesh(n_data=1, n_stage=2, n_seq=2,
                      devices=jax.devices()[:4])
    with pytest.raises(ValueError) as e:
        JM.loss_fn(jparams, jcfg, base._jax_batch(base._batch(3)), J_FP32,
                   cp=JContextParallel(mesh),
                   pp=jpipeline.PipelineParallel(mesh))
    return str(e.value)


def _jax_zero3_refusal():
    jcfg, jparams, _, _ = _models()
    with pytest.raises(ValueError) as e:
        JS.param_partition_tree(jparams, jcfg, jmake_mesh(
            n_data=2, n_stage=2, devices=jax.devices()[:4]), zero=3,
            pipeline=True)
    return str(e.value)


@pytest.mark.parametrize("parallel,train,exc,words", [
    # the JAX runner's (train/runner.py:172-185)
    (dict(pipeline=4), {}, ValueError,
     "decoder layers 2 must divide over 4 pipeline stages"),
    (dict(pipeline=2, pp_microbatches=3), {}, ValueError,
     "batch_size 8 must divide into 3 pipeline microbatches (x grad_accum)"),
    (dict(pipeline=2), dict(grad_accum=8), ValueError,
     "batch_size 8 must divide into 2 pipeline microbatches (x grad_accum)"),
    # the JAX loss_fn's and param_partition_tree's
    (dict(pipeline=2, seq=2), {}, ValueError, "loss_fn"),
    (dict(pipeline=2), dict(lora_enable=True), ValueError, "loss_fn"),
    (dict(pipeline=2, zero=3), {}, ValueError, "zero3"),
    # the port's own
    (dict(n_data=4, pipeline=2, pp_microbatches=4), {}, ValueError,
     "pipeline microbatch 2 must divide over the data axis (4 ways)"),
])
def test_plan_mesh_refusals(parallel, train, exc, words):
    if words == "loss_fn":
        words = _jax_loss_fn_refusal()
    elif words == "zero3":
        words = _jax_zero3_refusal()
    raw = _raw(**parallel)
    raw["train"].update(train)
    world = 1
    for key in ("n_data", "pipeline", "seq", "n_model"):
        world *= parallel.get(key, 1)
    with pytest.raises(exc) as e:
        runner.plan_mesh(RunConfig.from_dict(raw), world_size=world)
    assert str(e.value) == words
