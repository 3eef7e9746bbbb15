"""The port's parallel training in a spawned 4-rank `gloo` world against the
JAX package's `make_train_step` / `init_sharded_train_state` and runner on
its 8-device CPU mesh, in fp32, on the tiny LLaVA of
`tests/test_torch_train.py:_configs` and the same seeded numpy batches.

The world runs every case once (`tests/torch_parallel_worker.py`, which
imports no JAX; a `FileStore` under `tmp_path`, so xdist workers never share
a port): data 2 x model 2 (tensor parallelism of the decoder in stages 1
and 2, `zero` 0 / 2 / 3, ZeRO-3 under block remat, `offload_opt_state`,
`offload_params`, the torch.optim oracle, grad accumulation over a
nonfinite batch), data 4 (LoRA and QLoRA under ZeRO-3), and
`run_training` (data 4 with ZeRO-3 against the JAX runner's `train.jsonl`
and projector; data 2 x model 2 with ZeRO-3 at lr 0, whose saved files hold
the same bits as a one-rank run's). The batches' rows hold 9 to 3 valid
targets, so the data ranks' counts differ: a per-rank mean would show.

Context and pipeline parallelism: `ring_attention` over a seq group of 4
(both routes) against the JAX `make_ring_attention` (tolerances of
tests/test_torch_ring_attention.py: atol 2e-5, rtol 1e-4; the flash route
at valid rows); the decoder with `cp` on (data 2, seq 2) against the JAX
`forward(cp=...)` (hidden atol 2e-5, rtol 1e-4; loss rtol 1e-5; gradients
atol 3e-5, rtol 1e-3, tests/test_context_parallel.py's); and
`run_training` with `parallel.seq: 2` (stage 1) and `parallel.pipeline: 2`
(stage 2 over 4 steps: data 2 with ZeRO-2 at 2 microbatches; model 2 at 4
microbatches with `pp_remat_ticks` and block remat) against the JAX
runner's `train.jsonl` (as above), the stage-1 projector against the JAX
runner's and a pipeline run's gathered `checkpoint-{step}` against a
one-rank run of the same config (`_check_trained`).

Tolerances (as tests/test_torch_train.py; the collectives add other
summation orders): loss 1e-5 relative, grad norm 1e-4 relative, every
rank's metrics the same bits; trained parameters PARAM_TOL plus Adam's
amplification of the gradients' rounding (`_adam_bound`), with PARAM_TOL
alone for at least 99 % of the entries (90 % for the adapters, whose B
starts at 0); frozen parameters bit-equal to their initial values.
"""

import functools
import json
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP
import pytest
import torch

import test_torch_ring_attention as ring_test
import test_torch_train as base
from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.core.precision import (
    FP32_PRECISION as J_FP32)
from law_of_vision_representation_in_mllms_tpu.data import (
    preprocess as jpre)
from law_of_vision_representation_in_mllms_tpu.io import checkpoint as jckpt
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.models import llama as JL
from law_of_vision_representation_in_mllms_tpu.models import llava as JM
from law_of_vision_representation_in_mllms_tpu.models import towers as JT
from law_of_vision_representation_in_mllms_tpu.models import vit as JV
from law_of_vision_representation_in_mllms_tpu.ops import quant as JQ
from law_of_vision_representation_in_mllms_tpu.ops.ring_attention import (
    ContextParallel as JContextParallel)
from law_of_vision_representation_in_mllms_tpu.parallel import (
    make_mesh as jmake_mesh)
from law_of_vision_representation_in_mllms_tpu.train import runner as jrunner
from law_of_vision_representation_in_mllms_tpu.train import train_step as JS
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.core.precision import (
    FP32_PRECISION)
from law_of_vision_representation_in_mllms_torch.data import preprocess
from law_of_vision_representation_in_mllms_torch.io import from_jax
from law_of_vision_representation_in_mllms_torch.io import checkpoint as tckpt
from law_of_vision_representation_in_mllms_torch.models import llama as TL
from law_of_vision_representation_in_mllms_torch.models import llava as TM
from law_of_vision_representation_in_mllms_torch.models import lora as TLora
from law_of_vision_representation_in_mllms_torch.models import switch as TSw
from law_of_vision_representation_in_mllms_torch.models import towers as TT
from law_of_vision_representation_in_mllms_torch.models import vit as TV
from law_of_vision_representation_in_mllms_torch.models.layers import (
    init_weights)
from law_of_vision_representation_in_mllms_torch.ops import quant as TQ
from law_of_vision_representation_in_mllms_torch.train import runner

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_parallel_worker.py")
WORLD = 4
SEED = 7
RANK, ALPHA = 4, 12.0
TRAIN = dict(stage=2, learning_rate=1e-3, weight_decay=0.01, total_steps=20,
             warmup_ratio=0.1)
LORA = dict(lora_rank=RANK, lora_alpha=ALPHA)
# a decoder for 4 model ranks whose products' contraction slices cut int4
# groups: `down` holds 3 groups of 128 (96 rows a rank), `wo` one of 32
SPLIT_GROUPS = dict(num_kv_heads=4, intermediate_size=384)
# name -> (n_data, n_model, zero, TrainConfig / state / variant options)
STEP_CASES = {
    "tp_stage1_zero0": (2, 2, 0, dict(stage=1)),
    "tp_zero0": (2, 2, 0, {}),
    "tp_zero2": (2, 2, 2, {}),
    "tp_zero3": (2, 2, 3, {}),
    # block remat re-gathers each ZeRO-3 leaf in the backward's recompute
    "tp_zero3_remat": (2, 2, 3, dict(remat=True)),
    "tp_zero3_offload_opt_state": (2, 2, 3, dict(offload_opt_state=True)),
    "tp_zero3_offload_params": (2, 2, 3, dict(offload_params=True)),
    "tp_zero2_torch_adamw_offload": (2, 2, 2, dict(fused_optimizer=False,
                                                   offload_opt_state=True)),
    "tp_zero2_torch_adamw": (2, 2, 2, dict(fused_optimizer=False)),
    "tp_zero2_grad_accum_nonfinite": (2, 2, 2, dict(grad_accum=2)),
    "lora_zero3": (4, 1, 3, LORA),
    "qlora_zero3": (4, 1, 3, dict(LORA, bits=4)),
    # the variants tensor-parallel (the adapters cut beside the decoder,
    # the quantised codes and scales with their products)
    "tp_lora_zero2": (2, 2, 2, LORA),
    "tp_qlora_zero3": (2, 2, 3, dict(LORA, bits=4)),
    "tp_qlora8_zero2": (2, 2, 2, dict(LORA, bits=8)),
    "tp_switch_zero2": (2, 2, 2, dict(switch_sigma=1.0)),
    "tp4_qlora_split_groups": (1, 4, 0, dict(LORA, bits=4,
                                             decoder=SPLIT_GROUPS)),
}
STATE_KEYS = ("offload_opt_state", "offload_params")
VARIANT_KEYS = ("bits", "decoder")
# the references compile at XLA's lowest CPU backend optimisation: most of
# their cost is compiling, and the numbers are fp32 either way
JIT_OPTIONS = {"xla_backend_optimization_level": 0,
               "xla_llvm_disable_expensive_passes": True}
# the JAX step each case is held to: the placement changes no number (the
# JAX package's tests/test_fsdp.py holds its ZeRO levels and offloads to
# each other), so the port's stage-2 placements share the JAX package's
# ZeRO-3 step, and its offloads the JAX ZeRO-3 step with its parameters on
# the host
JAX_REFERENCE = {name: name for name in STEP_CASES}
JAX_REFERENCE.update({"tp_zero0": "tp_zero3", "tp_zero2": "tp_zero3",
                      "tp_zero3_remat": "tp_zero3",
                      "tp_zero3_offload_opt_state": "tp_zero3_offload_params",
                      "tp_zero2_torch_adamw_offload": "tp_zero2_torch_adamw"})


def crc_encode(self, text, add_special_tokens=False):
    ids = [3 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
           for w in text.split()]
    return [self.bos_token_id] + ids if add_special_tokens else ids


def _batches(name):
    if name.endswith("grad_accum_nonfinite"):
        # row 1 holds targets (rows 4 and 5 of `_batch(b=8)` hold none)
        poisoned = base._batch(5, b=8)
        poisoned["pixel_values"][0][1, 0, 0, 0] = np.nan
        return [base._batch(4, b=8), poisoned, base._batch(6, b=8)]
    return [base._batch(s) for s in (1, 2, 3)]


def _train_opts(opts):
    return {k: v for k, v in opts.items()
            if k not in STATE_KEYS + VARIANT_KEYS}


def _decoder(name):
    return tuple(sorted(STEP_CASES[name][3].get("decoder", {}).items()))


@functools.lru_cache(maxsize=None)
def _configs(decoder=()):
    """(JAX config, port config, the port's initial state dict, the
    adapters' state dict, the switch's): weights drawn by the port's seeded
    init and carried to the JAX tree by `from_jax` (a JAX init of the tiny
    LLaVA costs ~10 s of eager dispatch). `decoder`: (field, value) pairs
    of the decoder to change."""
    jcfg, tcfg = _tiny_configs(dict(decoder))
    params = TM.init_params(torch.Generator().manual_seed(SEED), tcfg,
                            FP32_PRECISION)
    lora = TLora.init_lora(torch.Generator().manual_seed(SEED + 1),
                           tcfg.decoder, TLora.LoraConfig(rank=RANK,
                                                          alpha=ALPHA),
                           FP32_PRECISION)
    switch = TSw.init_switch(torch.Generator().manual_seed(SEED + 2),
                             tcfg.decoder.hidden_size, FP32_PRECISION)
    return (jcfg, tcfg, params.state_dict(), lora.state_dict(),
            switch.state_dict())


def _tiny_configs(decoder=None):
    """The JAX and port configs of `test_torch_train._configs` (`decoder`:
    fields of the decoder to change)."""
    def entry(tower_mod, cfg_cls):
        vit = cfg_cls(image_size=14, patch_size=7, hidden_size=16,
                      num_layers=2, num_heads=2, intermediate_size=32)
        return tower_mod.TowerEntry(name="tiny", kind="vit", vit_config=vit,
                                    vit_family="clip", hidden_size=16,
                                    num_patches=vit.num_patches)
    dec = dict(dict(vocab_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, num_kv_heads=2, intermediate_size=64),
               **(decoder or {}))
    jcfg = JM.LlavaConfig(
        tower_spec=JT.TowerSpec(entries=[entry(JT, JV.ViTConfig)],
                                join="single"), decoder=JL.tiny(**dec))
    tcfg = TM.LlavaConfig(
        tower_spec=TT.TowerSpec(entries=[entry(TT, TV.ViTConfig)],
                                join="single"), decoder=TL.tiny(**dec))
    return jcfg, tcfg


def _jax_params(name):
    opts = STEP_CASES[name][3]
    jcfg, tcfg, sd, lora_sd, switch_sd = _configs(_decoder(name))
    params = TM.LlavaParams(tcfg, FP32_PRECISION)
    params.load_state_dict(sd)
    jparams = jax.tree.map(jnp.asarray, from_jax.llava_tree(params))
    if opts.get("lora_rank"):
        jparams["lora"] = jax.tree.map(jnp.asarray,
                                       from_jax.lora_tree(lora_sd))
    if opts.get("bits"):
        jparams["decoder"] = JQ.quantize_decoder(jparams["decoder"],
                                                 bits=opts["bits"])
    if opts.get("switch_sigma"):
        jparams["switch"] = jax.tree.map(jnp.asarray,
                                         from_jax.switch_tree(switch_sd))
    return jcfg, jparams


def _step_case(tmp, name):
    n_data, n_model, zero, opts = STEP_CASES[name]
    _, _, sd, lora_sd, switch_sd = _configs(_decoder(name))
    init = str(tmp / f"{name}.init.pt")
    torch.save(sd, init)
    batches = str(tmp / f"{name}.batches.npz")
    arr = np.empty(len(_batches(name)), dtype=object)
    arr[:] = _batches(name)
    np.savez(batches, batches=arr)
    case = {"kind": "steps", "name": name, "init": init, "batches": batches,
            "n_data": n_data, "n_model": n_model, "zero": zero,
            "train": dict(TRAIN, **_train_opts(opts))}
    case.update({k: opts[k] for k in STATE_KEYS + VARIANT_KEYS
                 if k in opts})
    if opts.get("lora_rank"):
        path = str(tmp / f"{name}.lora.pt")
        torch.save(lora_sd, path)
        case["lora"] = {"rank": RANK, "alpha": ALPHA, "init": path}
    if opts.get("switch_sigma"):
        case["switch"] = str(tmp / f"{name}.switch.pt")
        torch.save(switch_sd, case["switch"])
    return case


def _feature_run(tmp, name, **parallel):
    feats = tmp / "feats"
    if not feats.exists():
        os.makedirs(feats)
        rng = np.random.RandomState(0)
        for i in range(3):
            np.save(feats / f"img{i}.npy",
                    rng.randn(576, 1280).astype(np.float32))
    return {"model": {"vision_tower": "runwayml/stable-diffusion-v1-5_feature",
                      "decoder": "tiny"},
            "train": {"stage": 1, "batch_size": 4, "epochs": 1,
                      "bf16": False, "max_length": 64, "learning_rate": 1e-3,
                      "warmup_ratio": 0.0, "weight_decay": 0.1,
                      "output_dir": str(tmp / name), "save_steps": 1000},
            "data": {"data_path": base._write_data(tmp, 8),
                     "feature_folder": str(feats)},
            "parallel": parallel}


# name -> (parallel, train options) of the runs held to the JAX runner
PAR_RUNS = {
    "runner_seq2": (dict(n_data=2, seq=2), {}),
    "runner_pp2_zero2": (dict(n_data=2, pipeline=2, pp_microbatches=2,
                              zero=2), dict(stage=2, epochs=2)),
    "runner_pp2_tp2_remat": (dict(pipeline=2, n_model=2, pp_microbatches=4,
                                  pp_remat_ticks=True),
                             dict(stage=2, epochs=2,
                                  gradient_checkpointing=True)),
    # a quantised trunk in stages; the switch over seq ranks and stages;
    # QLoRA and the switch tensor-parallel (the tiny decoder's `down` and
    # `wo` contraction slices split int4 groups at 2 model ranks)
    "runner_pp2_int4": (dict(n_data=2, pipeline=2, pp_microbatches=2),
                        dict(quantize_base="int4")),
    "runner_seq2_switch": (dict(n_data=2, seq=2),
                           dict(stage=2, switch_enable=True)),
    "runner_pp2_switch": (dict(n_data=2, pipeline=2, pp_microbatches=2),
                          dict(stage=2, switch_enable=True)),
    "runner_tp2_qlora": (dict(n_data=2, n_model=2, zero=2),
                         dict(stage=2, lora_enable=True, lora_r=4,
                              lora_alpha=8.0, quantize_base="int4")),
    "runner_tp2_switch": (dict(n_data=2, n_model=2),
                          dict(stage=2, switch_enable=True)),
}


# the JAX runner cannot pipeline a quantised decoder (its GPipe maps the
# layer specs over the layers' leaves and meets a quantised leaf's dict):
# the port's pipelined run is held to the JAX runner's run of the same
# config without the pipeline, which is the same loss
JAX_UNPIPELINED = ("runner_pp2_int4",)


def _runner_cases(tmp):
    """(the JAX-side configs by name, the world's runner cases)."""
    raw = _feature_run(tmp, "runner_zero3", n_data=4, zero=3)
    jcfg = JRunConfig.from_dict(raw)
    _, jparams = jrunner.build_model(jcfg)
    init = str(tmp / "runner_init.npz")
    jio.save_params(init, base._jax_tree_np(jparams))
    jraws = {"runner_zero3": raw}
    for name, (parallel, train) in PAR_RUNS.items():
        jraws[name] = _feature_run(tmp, name, **parallel)
        jraws[name]["train"].update(train)
    inits = _jax_runner_inits(tmp, jcfg)
    runs = []
    for name, jraw in jraws.items():
        port = json.loads(json.dumps(jraw))
        port["train"]["output_dir"] += "_port"
        port["model"]["checkpoint"] = init
        if name in JAX_UNPIPELINED:
            port["parallel"] = PAR_RUNS[name][0]
            jraw["parallel"] = {k: v for k, v in jraw["parallel"].items()
                                if not k.startswith(("pipeline", "pp_"))}
            # its checkpoint-{step}s gather every stage's quantised layers
            port["train"]["save_steps"] = 1
        runs.append(dict(inits, kind="runner", name=name, config=port))
    # stage 2 at lr 0 with TP and ZeRO-3: a whole checkpoint-{step} and
    # its one-rank twin
    lr0 = _feature_run(tmp, "runner_tp_lr0", n_data=2, n_model=2, zero=3)
    lr0["train"].update(stage=2, learning_rate=0.0, save_steps=1)
    lr0["model"]["checkpoint"] = init
    return jraws, runs + [{"kind": "runner", "name": "runner_tp_lr0",
                           "config": lr0}]


def _jax_runner_inits(tmp, jcfg):
    """The adapters (rank 4, alpha 8) and the switch matrix the JAX runner
    draws from PRNGKey(seed + 1) / (seed + 2), as port state dicts saved
    under `tmp`, for the world's runs to take in place of their own
    seeded init (`torch_parallel_worker.carry_inits`)."""
    from law_of_vision_representation_in_mllms_tpu.models import lora as JLora
    from law_of_vision_representation_in_mllms_tpu.models import (
        switch as JSwitch)
    seed, dec = jcfg.train.seed, JL.tiny()
    jl = JLora.init_lora(jax.random.PRNGKey(seed + 1), dec,
                         JLora.LoraConfig(rank=4, alpha=8.0))
    sw = JSwitch.init_switch(jax.random.PRNGKey(seed + 2), dec.hidden_size)
    out = {"lora_init": str(tmp / "runner_lora_init.pt"),
           "switch_init": str(tmp / "runner_switch_init.pt")}
    torch.save(from_jax.lora_state_dict(base._jax_tree_np(jl)),
               out["lora_init"])
    torch.save(from_jax.switch_state_dict(base._jax_tree_np(sw)),
               out["switch_init"])
    return out


def _cp_inputs():
    """The decoder, embeddings, positions, mask and labels of
    tests/test_context_parallel.py's set-up (B 2, S 32, row 1's last 8
    tokens padding), the decoder's weights drawn by the port's init."""
    cfg = TL.tiny()
    dec = TL.LlamaModel(cfg, FP32_PRECISION)
    init_weights(dec, torch.Generator().manual_seed(SEED))
    b, s = 2, 32
    embeds = np.random.RandomState(1).randn(
        b, s, cfg.hidden_size).astype(np.float32) * 0.1
    mask = np.array([[True] * s, [True] * (s - 8) + [False] * 8])
    labels = np.random.RandomState(2).randint(0, cfg.vocab_size, (b, s))
    labels = np.where(mask, labels, -100)
    return dec.state_dict(), dict(
        embeds=embeds, positions=np.broadcast_to(np.arange(s), (b, s)).copy(),
        mask=mask, labels=labels)


def _cp_cases(tmp):
    """The ring case's inputs (tests/test_torch_ring_attention.py's,
    causal with the padded row) and the CP decoder case's."""
    inputs = str(tmp / "ring_inputs.npz")
    np.savez(inputs, **dict(zip(("q", "k", "v", "do", "mask"),
                                ring_test._inputs(True))))
    sd, arrays = _cp_inputs()
    init, cp_inputs = str(tmp / "cp_init.pt"), str(tmp / "cp_inputs.npz")
    torch.save(sd, init)
    np.savez(cp_inputs, **arrays)
    return [{"kind": "ring", "name": "ring_seq4", "inputs": inputs},
            {"kind": "cp_decoder", "name": "cp_decoder", "init": init,
             "inputs": cp_inputs}]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case of the module, run once by a spawned 4-rank world:
    name -> [rank 0's result, ..., rank 3's]."""
    tmp = tmp_path_factory.mktemp("world")
    cases = [_step_case(tmp, name) for name in STEP_CASES]
    jraws, runs = _runner_cases(tmp)
    job = {"world": WORLD, "store": str(tmp / "store"), "out": str(tmp),
           "cases": cases + runs + _cp_cases(tmp)}
    with open(tmp / "job.json", "w") as f:
        json.dump(job, f)
    env = dict(os.environ, PYTHONPATH=base.REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, str(tmp / "job.json"),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    # the JAX references run while the world does
    for name in set(JAX_REFERENCE.values()):
        _jax_steps(name)
    encode = jpre.SimpleTokenizer.encode
    jpre.SimpleTokenizer.encode = crc_encode
    try:
        for jraw in jraws.values():
            assert jrunner.run_training(JRunConfig.from_dict(jraw)) == 0
    finally:
        jpre.SimpleTokenizer.encode = encode
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    out = {c["name"]: [torch.load(str(tmp / f"{c['name']}.rank{r}.pt"),
                                  weights_only=False) for r in range(WORLD)]
           for c in job["cases"]}
    return {"tmp": tmp, "results": out, "jraw": jraws["runner_zero3"],
            "jraws": jraws, "cases": job["cases"]}


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    n_data, n_model, zero, opts = STEP_CASES[name]
    jcfg, jparams = _jax_params(name)
    mesh = jmake_mesh(n_data=n_data, n_model=n_model,
                      devices=jax.devices()[:n_data * n_model])
    jtc = JS.TrainConfig(**dict(TRAIN, **_train_opts(opts)))
    if zero or any(opts.get(k) for k in STATE_KEYS):
        state, opt, o_dev, o_host, p_dev, p_host = \
            JS.init_sharded_train_state(
                jparams, jtc, jcfg, mesh, zero=zero, min_size=0,
                **{k: opts.get(k, False) for k in STATE_KEYS})
    else:
        params = jax.device_put(jparams, JS.param_shardings(jparams, jcfg,
                                                            mesh))
        state, opt = JS.init_train_state(params, jtc)
        o_dev = o_host = p_dev = p_host = None
    kw = {}
    if o_host is None and p_host is None:
        # the state comes back placed as it went in: one compile, not one
        # for the first call's placement and another for the step's own
        # (not with host memory kinds, which out_shardings refuses)
        scalar = JNamedSharding(mesh, JP())
        placed = jax.tree.map(lambda x: x.sharding if isinstance(
            x.sharding, JNamedSharding) else scalar, state)
        state = jax.device_put(state, placed)
        kw["out_shardings"] = (placed, {k: scalar for k in (
            "loss", "grad_norm", "skipped_nonfinite", "step")})
    step = jax.jit(JS.make_train_step(
        jcfg, jtc, opt, J_FP32, opt_to_device=o_dev, opt_to_host=o_host,
        params_to_device=p_dev, params_to_host=p_host, mesh=mesh),
        compiler_options=JIT_OPTIONS, **kw)
    metrics = []
    for b in _batches(name):
        jb = base._jax_batch(b)
        state, m = step(state, jax.device_put(jb, JS.shard_batch_specs(
            jb, mesh)))
        metrics.append({k: float(m[k]) for k in
                        ("loss", "grad_norm", "skipped_nonfinite")})
    return metrics, base._jax_tree_np(state["params"])


def _adam_bound(nu, count, lr, w):
    """PARAM_TOL plus Adam's amplification of the gradients' rounding
    (tests/test_torch_train.py `_adam_tolerance`)."""
    v_hat = nu.float().numpy() / (1.0 - 0.999 ** count)
    amplified = count * lr * np.minimum(
        base.GRAD_ROUNDING / (np.sqrt(v_hat) + 1e-8), 2.0)
    return (base.PARAM_TOL["atol"] + base.PARAM_TOL["rtol"] * np.abs(w)
            + amplified)


def _check_trained(got, nu, count, lr, want, min_tight):
    n_tight = n_all = 0
    for name, w in want.items():
        w = w.numpy()
        diff = np.abs(got[name].numpy() - w)
        tol = _adam_bound(nu[name], count, lr, w)
        assert (diff <= tol).all(), (name, float((diff - tol).max()))
        n_tight += int((diff <= base.PARAM_TOL["atol"]
                        + base.PARAM_TOL["rtol"] * np.abs(w)).sum())
        n_all += diff.size
    assert n_tight >= min_tight * n_all, (n_tight, n_all)


def _expected_modes(name):
    n_data, n_model, zero, _ = STEP_CASES[name]
    return {0: {"replicated"}, 2: {"scatter", "replicated"},
            3: {"sharded", "replicated"}}[zero]


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_steps_match_jax(world, name):
    """Per-step loss, grad norm and nonfinite flag on every rank against
    the JAX step on its CPU mesh; the trained leaves after the steps, the
    frozen ones untouched."""
    ranks = world["results"][name]
    want_m, jp = _jax_steps(JAX_REFERENCE[name])
    keys = ("loss", "grad_norm", "skipped_nonfinite")
    for r in ranks[1:]:
        np.testing.assert_array_equal(
            [[m[k] for k in keys] for m in r["metrics"]],
            [[m[k] for k in keys] for m in ranks[0]["metrics"]])
    for got, want in zip(ranks[0]["metrics"], want_m):
        assert got["skipped_nonfinite"] == want["skipped_nonfinite"]
        if want["skipped_nonfinite"] == 0.0:
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=base.LOSS_RTOL)
            np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                       rtol=1e-4)
    if name.endswith("nonfinite"):
        assert [m["skipped_nonfinite"] for m in want_m] == [0.0, 1.0, 0.0]
        assert not np.isfinite(ranks[0]["metrics"][1]["loss"])
    modes = {p[1] for p in ranks[0]["plans"]}
    assert modes <= _expected_modes(name) and (
        STEP_CASES[name][2] == 0 or modes - {"replicated"}), modes
    got = ranks[0]["state"]
    trained = set(ranks[0]["nu"])
    opts = STEP_CASES[name][3]
    if opts.get("lora_rank"):
        want = from_jax.projector_state_dict(jp["projector"], "projector.")
        want.update(from_jax.lora_state_dict(jp["lora"], "lora."))
        min_tight = 0.9
    elif opts.get("switch_sigma"):
        want = from_jax.switch_state_dict(jp["switch"], "switch.")
        min_tight = 0.99
    else:
        want = {k: v for k, v in from_jax.llava_state_dict(jp).items()
                if k in trained}
        min_tight = 0.99
    assert set(want) == trained
    _check_trained(got, ranks[0]["nu"], ranks[0]["count"], TRAIN[
        "learning_rate"], want, min_tight)
    _, tcfg, dense = _configs(_decoder(name))[:3]
    for k, v in got.items():
        if k not in trained and k in dense:
            assert torch.equal(v, dense[k]), k
    if opts.get("bits"):
        # the codes and scales gathered from the model ranks' slices (split
        # groups put back together) are the one-rank quantisation's
        params = TM.LlavaParams(tcfg, FP32_PRECISION)
        params.load_state_dict(dense)
        TQ.quantize_decoder(params.decoder, bits=opts["bits"])
        codes = {k: v for k, v in params.state_dict().items()
                 if k.endswith((".q4", ".q8", ".scale"))}
        assert codes and all(torch.equal(got[k], v)
                             for k, v in codes.items())


def _logs(path):
    return [json.loads(x) for x in open(os.path.join(path, "train.jsonl"))
            if x.strip()]


def test_run_training_matches_jax_runner(world):
    """`run_training` over 4 data ranks with ZeRO-3: `train.jsonl` step by
    step and the saved projector against the JAX runner's on its mesh (run
    by the fixture)."""
    raw = world["jraw"]
    out = raw["train"]["output_dir"]
    want_logs, got_logs = _logs(out), _logs(out + "_port")
    assert len(got_logs) == len(want_logs) == 2
    for g, w in zip(got_logs, want_logs):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=base.LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
        assert g["skipped_nonfinite"] == 0.0
    assert {r["steps"] for r in world["results"]["runner_zero3"]} == {2}
    want = jckpt.load_projector(out)
    got = tckpt.load_projector(out + "_port")
    r0 = world["results"]["runner_zero3"][0]
    want_sd = {}
    for i, layer in enumerate(want["layers"]):
        want_sd[f"layers.{i}.weight"] = torch.from_numpy(layer["kernel"].T)
        want_sd[f"layers.{i}.bias"] = torch.from_numpy(layer["bias"])
    _check_trained(got, {k[len("projector."):]: v
                         for k, v in r0["nu"].items()}, r0["count"],
                   raw["train"]["learning_rate"], want_sd, 0.99)


def test_sharded_saves_hold_a_one_rank_runs_bits(world, monkeypatch):
    """Data 2 x model 2 with ZeRO-3 at lr 0: the final `checkpoint-{step}`
    (gathered to rank 0) holds, array for array, the bits a one-rank run of
    the same config writes."""
    monkeypatch.setattr(preprocess.SimpleTokenizer, "encode", crc_encode)
    case = next(c for c in world["cases"] if c["name"] == "runner_tp_lr0")
    one = json.loads(json.dumps(case["config"]))
    one["train"]["output_dir"] += "_one"
    one["parallel"] = {}
    runner.run_training(RunConfig.from_dict(one), device="cpu")
    for step in (1, 2):
        a = np.load(os.path.join(case["config"]["train"]["output_dir"],
                                 f"checkpoint-{step}", "params.npz"))
        b = np.load(os.path.join(one["train"]["output_dir"],
                                 f"checkpoint-{step}", "params.npz"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), k


def test_ring_attention_over_a_seq_group_matches_jax(world):
    """`ring_attention` over a seq group of 4 ranks, causal, GQA, a padded
    row: the plain route at every row, the flash route (the kernels' plain
    versions) at valid rows with dO zero at pad rows, against the JAX ring
    on 4 devices."""
    ranks = world["results"]["ring_seq4"]
    mask = ring_test._inputs(True)[4]
    for route, zero_pad in (("plain", False), ("flash", True)):
        want_out, want_grads = ring_test._jax_ring(True, True, zero_pad)
        got = [torch.cat([r[route][i] for r in ranks], 1).numpy()
               for i in range(4)]
        rows = mask if route == "flash" else np.ones_like(mask)
        np.testing.assert_allclose(got[0][rows], want_out[rows],
                                   **ring_test.TOL)
        np.testing.assert_allclose(got[1][rows], want_grads[0][rows],
                                   **ring_test.TOL)
        for g, w in zip(got[2:], want_grads[1:]):
            np.testing.assert_allclose(g, w, **ring_test.TOL)


def test_cp_decoder_matches_jax(world):
    """The decoder with `cp` on (data 2, seq 2): every rank's hidden shard,
    the loss and the decoder gradients summed over the ranks, against the
    JAX `forward(cp=...)` on the same mesh shape, fp32."""
    sd, arrays = _cp_inputs()
    jparams = jax.tree.map(jnp.asarray, from_jax.llama_tree(sd))
    cfg = JL.tiny()
    mesh = jmake_mesh(n_data=2, n_seq=2, n_model=1,
                      devices=jax.devices()[:4])
    cp = JContextParallel(mesh, head_axis=None)
    embeds, positions, mask, labels = (jnp.asarray(arrays[k]) for k in (
        "embeds", "positions", "mask", "labels"))

    def loss(p):
        h, _ = JL.forward(p, cfg, embeds, positions, attn_mask=mask, cp=cp,
                          precision=J_FP32)
        return JL.causal_lm_loss(JL.logits_fn(p, h), labels), h
    (want_loss, want_h), want_g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(jparams)
    want_h = np.asarray(want_h)
    ranks = world["results"]["cp_decoder"]
    sl = want_h.shape[1] // 2
    for r in ranks:
        c = r["coord"]
        np.testing.assert_allclose(
            r["hidden"].numpy(),
            want_h[r["rows"].numpy()][:, c * sl:(c + 1) * sl],
            atol=2e-5, rtol=1e-4)
    assert len({r["loss"] for r in ranks}) == 1
    np.testing.assert_allclose(ranks[0]["loss"], float(want_loss),
                               rtol=base.LOSS_RTOL)
    want = from_jax.llama_state_dict(base._jax_tree_np(want_g))
    for name, g in ranks[0]["grads"].items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=3e-5, rtol=1e-3, err_msg=name)


def _one_rank_twin(config, monkeypatch, case=None):
    """The port's one-process run of a world run's config (no parallel
    section), from the case's carried adapters / switch matrix; returns its
    output directory."""
    monkeypatch.setattr(preprocess.SimpleTokenizer, "encode", crc_encode)
    if case is not None:
        import torch_parallel_worker as worker
        for fn in ("init_lora", "init_switch"):
            monkeypatch.setattr(runner, fn, getattr(runner, fn))
        worker.carry_inits(case["lora_init"], case["switch_init"])
    one = json.loads(json.dumps(config))
    one["train"]["output_dir"] += "_one"
    one["parallel"] = {}
    runner.run_training(RunConfig.from_dict(one), device="cpu")
    return one["train"]["output_dir"]


def _variant_state(path):
    """A saved `lora_adapters.npz` / `switch.npz` as port state dict
    entries (`lora.` / `switch.`)."""
    tree = jio.load_params(path)
    if path.endswith("switch.npz"):
        return from_jax.switch_state_dict(tree, "switch.")
    return from_jax.lora_state_dict(tree, "lora.")


@pytest.mark.parametrize("name", list(PAR_RUNS))
def test_seq_and_pipeline_runs_match_jax_runner(world, name, monkeypatch):
    """`run_training` with `parallel.seq: 2`, `parallel.pipeline: 2` or a
    variant tensor-parallel: `train.jsonl` step by step against the JAX
    runner's on its mesh; the stage-1 projector against the JAX runner's,
    a pipeline run's final `checkpoint-{step}` (every stage's layers,
    gathered to rank 0) against a one-rank run of the same config, a
    variant's saved adapters / switch matrix against the JAX runner's (and
    a one-rank run's under TP)."""
    raw = world["jraws"][name]
    out = raw["train"]["output_dir"]
    want_logs, got_logs = _logs(out), _logs(out + "_port")
    n_steps = 2 * raw["train"]["epochs"]
    assert len(got_logs) == len(want_logs) == n_steps
    for g, w in zip(got_logs, want_logs):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=base.LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-4)
        assert g["skipped_nonfinite"] == 0.0
    ranks = world["results"][name]
    assert {r["steps"] for r in ranks} == {n_steps}
    r0 = ranks[0]
    lr = raw["train"]["learning_rate"]
    variant = ("lora_adapters.npz" if raw["train"].get("lora_enable") else
               "switch.npz" if raw["train"].get("switch_enable") else None)
    if variant:
        # rank 0's save of the gathered adapters / switch matrix against
        # the JAX runner's, and against a one-rank run's where the run is
        # tensor-parallel
        case = next(c for c in world["cases"] if c["name"] == name)
        dirs = [out]
        if raw["parallel"].get("n_model", 1) > 1:
            dirs.append(_one_rank_twin(case["config"], monkeypatch, case))
        got = _variant_state(os.path.join(out + "_port", variant))
        assert set(got) == {k for k in r0["nu"]
                            if not k.startswith("projector.")}
        for d in dirs:
            want = _variant_state(os.path.join(d, variant))
            _check_trained(got, r0["nu"], r0["count"], lr, want, 0.9)
        return
    if raw["train"]["stage"] == 1:
        want = jckpt.load_projector(out)
        got = tckpt.load_projector(out + "_port")
        want_sd = {}
        for i, layer in enumerate(want["layers"]):
            want_sd[f"layers.{i}.weight"] = torch.from_numpy(
                layer["kernel"].T)
            want_sd[f"layers.{i}.bias"] = torch.from_numpy(layer["bias"])
        _check_trained(got, {k[len("projector."):]: v
                             for k, v in r0["nu"].items()}, r0["count"], lr,
                       want_sd, 0.99)
        if name in JAX_UNPIPELINED:
            # the frozen int4 decoder that rank 0 saved, gathered from the
            # stages, holds a one-rank run's codes and scales
            case = next(c for c in world["cases"] if c["name"] == name)
            one = _one_rank_twin(case["config"], monkeypatch)
            path = f"checkpoint-{n_steps}/params.npz"
            a = np.load(os.path.join(out + "_port", path))
            b = np.load(os.path.join(one, path))
            dec = [k for k in b.files if k.startswith("decoder/")]
            assert sorted(a.files) == sorted(b.files) and any(
                "q4" in k for k in dec)
            for k in dec:
                assert a[k].tobytes() == b[k].tobytes(), k
        return
    case = next(c for c in world["cases"] if c["name"] == name)
    one = _one_rank_twin(case["config"], monkeypatch)
    path = f"checkpoint-{n_steps}/params.npz"
    got = from_jax.load_llava_npz(os.path.join(out + "_port", path))
    want = from_jax.load_llava_npz(os.path.join(one, path))
    assert sorted(got) == sorted(want)
    # the moments of every stage's trainable leaves, gathered
    assert set(r0["nu"]) == {k for k in want
                             if k.startswith(("decoder.", "projector."))}
    _check_trained(got, r0["nu"], r0["count"], lr,
                   {k: want[k] for k in r0["nu"]}, 0.99)
