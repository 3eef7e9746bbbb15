"""The port's `parallel/` against the JAX package's, without a spawned world:
`fsdp_spec`, `derived_state_specs` and `memory_report` on the same shapes
(the 7B tree from `jax.eval_shape` among them), `make_mesh`'s shapes and
errors, `process_shard`, the batch rows a data rank holds, each bundled
config's mesh plan, the TP specs, one process's sharded step against the
plain step, and `init_distributed` over a one-process gloo group. All
exact: these are the same functions of the same integers.
"""

import os
import socket

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import test_torch_train as base
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.parallel import fsdp as jfsdp
from law_of_vision_representation_in_mllms_tpu.parallel import (
    make_mesh as jmake_mesh, process_shard as jprocess_shard)
from law_of_vision_representation_in_mllms_tpu.train import train_step as JS
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    DEFAULT_PRECISION)
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.parallel import (
    comm, data_rows, fsdp, init_distributed, make_mesh, process_shard)
from law_of_vision_representation_in_mllms_torch.train import runner
from law_of_vision_representation_in_mllms_torch.train import train_step as TS

torch.set_num_threads(1)


def _t(spec):
    return tuple(spec)


@pytest.mark.parametrize("shape,base_spec,n,min_size", [
    ((32, 4096, 4096), (None, None, "model"), 8, 0),
    ((32, 4096), (None, "data"), 8, 0),
    ((4,), None, 8, fsdp.MIN_SIZE_TO_SHARD),
    ((33, 35), None, 8, 0),
    ((32000, 4096), ("model", None), 8, 0),
    ((4096, 11008), (None, "model"), 4, fsdp.MIN_SIZE_TO_SHARD),
    ((11008, 4096), (None, ("model", "seq")), 2, 0),
    ((64, 3, 14, 14), None, 4, 0),
    ((256,), None, 4, 1 << 10),
    ((8, 16), (None,), 4, 0),
])
def test_fsdp_spec_matches_jax(shape, base_spec, n, min_size):
    want = jfsdp.fsdp_spec(shape, None if base_spec is None else
                           JP(*base_spec), n, min_size=min_size)
    got = fsdp.fsdp_spec(shape, base_spec, n, min_size=min_size)
    assert _t(got) == _t(want)


@pytest.fixture(scope="module")
def tree7b(mesh8):
    """The JAX 7B LLaVA's shapes, its FusedAdamW state's and its ZeRO-3 and
    TP-only spec trees."""
    cfg = JM.LlavaConfig.build("openai/clip-vit-large-patch14-336",
                               decoder=JL.vicuna_7b())
    shapes = jax.eval_shape(lambda k: JM.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    opt = JS.make_optimizer(shapes, JS.TrainConfig(stage=2,
                                                   total_steps=100))
    o_shapes = jax.eval_shape(opt.init, shapes)
    specs = {z: JS.param_partition_tree(shapes, cfg, mesh8, zero=z)
             for z in (0, 3)}
    return shapes, o_shapes, specs


def _port_specs(jspecs):
    return jax.tree.map(lambda s: fsdp.P(*s), jspecs,
                        is_leaf=lambda x: isinstance(x, JP))


def _flat(tree, is_leaf):
    return [(jax.tree_util.keystr(p), _t(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]]


@pytest.mark.parametrize("zero", [0, 3])
def test_derived_state_specs_and_memory_report_match_jax(tree7b, mesh8,
                                                         zero):
    shapes, o_shapes, specs = tree7b
    pmesh = make_mesh(4, 2, world_size=8)
    shard = zero >= 2
    want = jfsdp.derived_state_specs(o_shapes, specs[zero], mesh8,
                                     shard_derived=shard)
    got = fsdp.derived_state_specs(o_shapes, _port_specs(specs[zero]),
                                   pmesh, shard_derived=shard)
    assert _flat(got, lambda x: isinstance(x, fsdp.P)) == _flat(
        want, lambda x: isinstance(x, JP))
    assert fsdp.memory_report(shapes, _port_specs(specs[zero]), pmesh) == \
        jfsdp.memory_report(shapes, specs[zero], mesh8)
    assert fsdp.memory_report(o_shapes, got, pmesh) == \
        jfsdp.memory_report(o_shapes, want, mesh8)


@pytest.mark.parametrize("dims", [
    dict(n_data=4, n_model=2), dict(n_data=None, n_model=2),
    dict(n_data=None), dict(n_data=2, n_model=2, n_seq=2),
    dict(n_data=2, n_model=1, n_stage=2, n_seq=2),
    dict(n_data=1, n_model=8)])
def test_make_mesh_matches_jax(dims):
    want = jmake_mesh(**dims)
    got = make_mesh(world_size=8, **dims)
    assert list(got.shape.items()) == list(dict(want.shape).items())
    # rank r sits where the JAX mesh puts device r
    ids = np.vectorize(lambda d: d.id)(want.devices)
    for r in range(8):
        at = np.argwhere(ids == r)[0]
        pr = make_mesh(world_size=8, rank=r, **dims)
        assert [pr.coord(a) for a in got.shape] == list(at)


@pytest.mark.parametrize("dims", [dict(n_data=8, n_model=2),
                                  dict(n_data=4, n_model=2, n_seq=2)])
def test_make_mesh_errors_match_jax(dims):
    with pytest.raises(ValueError) as want:
        jmake_mesh(**dims)
    with pytest.raises(ValueError) as got:
        make_mesh(world_size=8, **dims)
    assert str(got.value) == str(want.value)
    # a JAX mesh may leave devices idle; a process must not be
    with pytest.raises(ValueError, match="every process"):
        make_mesh(n_data=2, n_model=2, world_size=8)


def test_process_shard_matches_jax():
    items = list(range(23))
    for n in (1, 2, 3, 8):
        for i in range(n):
            assert process_shard(items, i, n) == jprocess_shard(items, i, n)
    assert process_shard(items) == items


@pytest.mark.parametrize("n_data,accum", [(2, 1), (4, 1), (2, 2), (2, 4)])
def test_data_rows_match_jax_batch_sharding(n_data, accum):
    """The rows of the global batch each data rank holds: those the JAX
    step's batch sharding (and, under grad accumulation, its microbatch
    constraint P(None, 'data')) puts on that rank's devices."""
    b = 16
    mesh = jmake_mesh(n_data=n_data, n_model=2,
                      devices=jax.devices()[:2 * n_data])
    rows = np.arange(b)
    if accum > 1:
        x = jax.device_put(rows.reshape(accum, b // accum),
                           JNamedSharding(mesh, JP(None, "data")))
    else:
        x = jax.device_put(rows, JNamedSharding(mesh, JP("data")))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for d in range(n_data):
        dev = ids[d, 0]
        shard = next(s for s in x.addressable_shards if s.device.id == dev)
        want = np.asarray(shard.data).reshape(-1)
        pmesh = make_mesh(n_data, 2, world_size=2 * n_data, rank=2 * d)
        np.testing.assert_array_equal(data_rows(b, pmesh, accum), want)


@pytest.mark.parametrize("name,shape", [
    ("stage1_clip336", {"data": 8, "model": 1}),
    ("stage1_sd15_feature_cached", {"data": 8, "model": 1}),
    ("stage2_clip336_dino", {"data": 4, "model": 2})])
def test_bundled_configs_pass_the_mesh_plan(name, shape):
    cfg = RunConfig.from_yaml(os.path.join(base.REPO, "configs",
                                           f"{name}.yaml"))
    world = shape["data"] * shape["model"]
    assert runner.plan_mesh(cfg, world_size=world).shape == shape
    with pytest.raises(ValueError, match=f"> {world - 1} devices"):
        runner.plan_mesh(cfg, world_size=world - 1)


def test_plan_mesh_checks_use_the_jax_runners_words():
    raw = {"train": {"batch_size": 6, "grad_accum": 1},
           "parallel": {"n_data": 4}}
    with pytest.raises(ValueError, match=r"^batch_size 6 must divide over "
                       r"the data axis \(4 ways\)$"):
        runner.plan_mesh(RunConfig.from_dict(raw), world_size=4)
    raw["train"] = {"batch_size": 8, "grad_accum": 4}
    with pytest.raises(ValueError, match=r"^microbatch 2 must divide over "
                       r"the data axis \(4 ways\)$"):
        runner.plan_mesh(RunConfig.from_dict(raw), world_size=4)
    # context and pipeline parallelism run (their refusals:
    # tests/test_torch_pipeline.py)
    raw = {"train": {"batch_size": 8}, "model": {"decoder": "tiny"},
           "parallel": {"pipeline": 2}}
    with pytest.raises(ValueError, match=r"^batch_size 8 must divide into 3 "
                       r"pipeline microbatches \(x grad_accum\)$"):
        raw["parallel"]["pp_microbatches"] = 3
        runner.plan_mesh(RunConfig.from_dict(raw), world_size=2)
    for key in ("seq", "pipeline"):
        raw = {"model": {"decoder": "tiny"}, "parallel": {key: 2}}
        mesh = runner.plan_mesh(RunConfig.from_dict(raw), world_size=2)
        assert mesh.shape == {"data": 1, {"seq": "seq", "pipeline": "stage"}[
            key]: 2, "model": 1}


def test_tp_specs_match_jax_layout(mesh8):
    """The port's TP spec of each decoder leaf shards the same feature axis
    as the JAX spec (the port's Dense weight is the JAX kernel transposed,
    one block a module)."""
    jspecs = JL.param_partition_specs(JL.vicuna_7b())
    cfg = TL.vicuna_7b()
    tspecs = TL.param_partition_specs(cfg)
    assert _t(tspecs["embed"]) == _t(jspecs["embed"])
    assert _t(tspecs["lm_head.weight"]) == _t(jspecs["lm_head"])[::-1]
    for name, js in jspecs["layers"].items():
        key = (f"layers.0.{name}" if name.startswith("rms")
               else f"layers.0.{name}.weight")
        want = _t(js)[1:] if name.startswith("rms") else _t(js)[1:][::-1]
        assert _t(tspecs[key]) == want, name
    model_cfg = TM.LlavaConfig.build("openai/clip-vit-large-patch14-336",
                                     decoder=cfg)
    params = TM.LlavaParams(model_cfg, DEFAULT_PRECISION, device="meta")
    z3 = TS.param_partition_tree(params, model_cfg,
                                 make_mesh(4, 2, world_size=8), zero=3)
    assert _t(z3["decoder.layers.0.wq.weight"]) == ("model", "data")
    assert _t(z3["decoder.layers.0.wo.weight"]) == ("data", "model")
    assert _t(z3["decoder.layers.0.rms1"]) == (None,)
    assert all("data" in _t(s) for n, s in z3.items()
               if params.get_parameter(n).numel() >= fsdp.MIN_SIZE_TO_SHARD)


@pytest.mark.parametrize("zero,offloads", [
    (0, {}), (2, {"offload_opt_state": True}),
    (3, {"offload_params": True, "offload_opt_state": True})])
def test_one_process_sharded_step_is_the_plain_step(zero, offloads):
    """Without a process group ZeRO and the offloads change no bit: the
    same loss, norm and parameters over 3 stage-2 steps as
    `init_train_state` (zero 0, resident)."""
    results = []
    for sharded in (False, True):
        _, _, tcfg, params = base._configs(3)
        ttc = TS.TrainConfig(stage=2, learning_rate=1e-3, total_steps=10,
                             weight_decay=0.01)
        if sharded:
            mesh = make_mesh(world_size=1)
            state, opt = TS.init_sharded_train_state(
                params, ttc, tcfg, mesh, zero=zero, min_size=0, **offloads)
            step = TS.make_train_step(tcfg, ttc, opt, mesh=mesh)
        else:
            state, opt = TS.init_train_state(params, ttc)
            step = TS.make_train_step(tcfg, ttc, opt)
        ms = [step(state, base._port_batch(base._batch(s)))[1]
              for s in (1, 2, 3)]
        results.append(([(float(m["loss"]), float(m["grad_norm"]))
                         for m in ms], params.state_dict()))
    assert results[0][0] == results[1][0]
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_distributed_starts_one_gloo_process(monkeypatch):
    for k in ("LVR_COORDINATOR", "LVR_NUM_PROCESSES", "LVR_PROCESS_ID",
              "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="no coordinator"):
        init_distributed(device="cpu")
    monkeypatch.setenv("LVR_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("LVR_NUM_PROCESSES", "1")
    monkeypatch.setenv("LVR_PROCESS_ID", "0")
    assert init_distributed(device="cpu") is True
    try:
        assert init_distributed(device="cpu") is False
        mesh = make_mesh(n_model=1)
        assert mesh.shape == {"data": 1, "model": 1}
        x = torch.arange(6.0).reshape(2, 3)
        g = mesh.group("data")
        assert comm.size(g) == 1
        assert torch.equal(comm.all_reduce(x.clone(), g), x)
        assert torch.equal(comm.all_gather(x, 1, g), x)
        assert torch.equal(comm.reduce_scatter(x, 0, g), x)
        assert process_shard(list(range(5))) == list(range(5))
    finally:
        torch.distributed.destroy_process_group()


def test_cli_starts_the_process_group_before_the_command(monkeypatch,
                                                         capsys):
    """`LVR_DISTRIBUTED=1` (the JAX CLI's block) starts the group before the
    command runs: gloo under `--device cpu`."""
    from law_of_vision_representation_in_mllms_torch import cli
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LVR_DISTRIBUTED", "1")
    monkeypatch.setenv("LVR_COORDINATOR", f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv("LVR_NUM_PROCESSES", "1")
    monkeypatch.setenv("LVR_PROCESS_ID", "0")
    try:
        assert cli.main(["tasks", "--device", "cpu"]) == 0
        assert torch.distributed.is_initialized()
        assert torch.distributed.get_backend() == "gloo"
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    assert "mme" in capsys.readouterr().out
