"""RunConfig -> model, tokenizer and the stage-1/2 training loop
(counterpart of the JAX package's `train/runner.py`).

`build_model` supports ViT towers and the precomputed-feature pseudo-tower
with seeded random weights, per-tower weights from `model.tower_weights`
(JAX `param_io` .npz files; for a diffusion tower (a UNet, DiT-XL/2 or
SD3-medium) its featurizer bundle, whose `.json` sidecar configuration
replaces the tower's preset and sets the entry's token grid and width; a
diffusion tower without one has no weights and refuses to run, as in the JAX
package), a full LLaVA parameter file in
`model.checkpoint` (a `param_io` .npz such as either package's
`consolidate` or the port's `save_train_state` writes, the JAX runner's
orbax `checkpoint-{step}` (`io.orbax_state`), or a directory of
`checkpoint-{step}`), and a stage-1 projector in
`train.pretrain_mm_mlp_adapter`. Any projector type (a perceiver too), MoF
tower specs (per-tower projectors) and `model.visual_keep` pruning build.
`model.kv_quant=int8` gives generation the int8 KV cache;
`train.quantize_base=int4|int8` trains through a weight-only quantised
frozen decoder, built quantised block by block: stage 1, or with
`train.lora_enable` (QLoRA: dense adapters on top of the integer base).
`train.lora_enable` attaches LoRA adapters (`models/lora.py`, rank
`train.lora_r`, `train.lora_alpha`; the decoder base freezes, adapters and
projector train), `train.switch_enable` the switch matrix
(`models/switch.py`; only W trains).

`run_training` is the loop of the reference's `train.py` +
`scripts/v1_5/train/{pretrain,finetune}.sh`: datasets, the modality-grouped
sampler, batches prefetched on a host thread, `make_train_step`, JSONL
metrics, `checkpoint-{step}` saves and the projector-only stage-1 save (a
perceiver's whole tree, MoF's per-tower projectors), in
stage 2 `switch.npz` for a switch run and the LoRA-split save
(`lora_adapters.npz`, the projector, `config.json` with `lora_r` and
`lora_alpha`) for a LoRA run.

Parallel runs (`cfg.parallel`; start the processes with torchrun or the
`LVR_*` variables, `cli.py`): the mesh is built from `n_data` x `pipeline`
x `seq` x `n_model` over the world's processes with the JAX runner's
checks and messages; every rank builds the same whole model from the seed
(or `model.checkpoint`) and keeps its shard (`init_sharded_train_state`:
tensor parallelism, `zero` 2 / 3, `offload_opt_state`, `offload_params`,
a pipeline stage's layers), collates the same global batch and trains on
its data rows. `parallel.seq` > 1 runs the decoder's attention as a ring
over the seq axis (`ops/ring_attention.py`); `parallel.pipeline` > 1 runs
the trunk as a GPipe schedule of `pp_microbatches` microbatches over the
stage axis (`parallel/pipeline.py`, `pp_remat_ticks`). Rank 0 alone writes
`train.jsonl` and the saved files, gathered to whole tensors (every
stage's layers) first.

Precision and attention route: `DEFAULT_PRECISION` (fp32 weights, bf16
compute) when `train.bf16`, else fp32 throughout, as in the JAX runner. On a
CUDA device with bf16 compute the decoder takes the flash route: kernel 2
forward, kernels 5 and 6 backward. fp32 compute on CUDA takes the plain
masked attention in the decoder (kernel 2 is bf16-only); a ViT tower's
kernel 1 is bf16-only too and raises on fp32, so fp32 runs on CUDA train
feature-cached. The CPU takes the plain attention as well, where the flash
route would only run the kernels' plain versions. (The JAX runner
never turns `use_flash` on in training; the port takes the route the JAX
package takes on its own accelerator when it serves.)
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.config import RunConfig
from ..core.precision import DEFAULT_PRECISION, FP32_PRECISION, Precision
from ..data import (FeatureDataset, SupervisedDataset, collate_batch,
                    get_template, length_grouped_indices)
from ..data.preprocess import SimpleTokenizer
from ..io import checkpoint, from_jax
from ..io.orbax_state import is_orbax_checkpoint, restore_params
from ..io.featurizer_bundle import load_featurizer_bundle
from ..io.param_io import load_params
from ..models import featurizer, llama, llava
from ..models.lora import LoraConfig, init_lora
from ..models.diffusion_blocks import check_attn_impl
from ..models.switch import init_switch
from ..models.towers import parse_tower_spec
from ..models.vit import attention_route
from ..ops.ring_attention import ContextParallel
from ..parallel import local_device, make_mesh, shard_batch, world
from ..parallel.pipeline import PipelineParallel
from ..utils import MetricsLogger, map_prefetch, rank0_print
from .train_step import (GatheredOptState, TrainConfig,
                         init_sharded_train_state, make_train_step,
                         whole_params)


def build_tokenizer(cfg: RunConfig):
    if cfg.model.tokenizer:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(cfg.model.tokenizer)
    # the hash tokenizer must emit ids inside the decoder's vocab
    vocab = llama.tiny().vocab_size if cfg.model.decoder == "tiny" else 32000
    return SimpleTokenizer(vocab_size=vocab)


def build_model(cfg: RunConfig, *, device, precision: Precision =
                DEFAULT_PRECISION, generator: torch.Generator | None = None,
                quantize_bits: Optional[int] = None):
    """(LlavaConfig, LlavaParams) on `device`. Random weights come from
    `generator`, by default a generator on `device` seeded with
    `cfg.train.seed`. `quantize_bits` (4 or 8) builds the decoder's matmul
    weights quantised one block at a time (`llava.init_params`), each given
    its `model.checkpoint` weights before it is quantised: the codes of a
    dense build followed by `ops.quant.quantize_decoder`, without the dense
    decoder ever being whole on `device`."""
    tower_kw = dict(up_ft_index=cfg.model.up_ft_index, t=cfg.model.t,
                    ensemble_size=cfg.model.ensemble_size)
    if cfg.model.img_size:
        tower_kw["img_size"] = cfg.model.img_size
    spec = parse_tower_spec(cfg.model.vision_tower, **tower_kw)
    check_attn_impl(cfg.model.diffusion_attn_impl)
    if cfg.model.tower_attn_impl:
        # a JAX route name; each maps onto kernel 1 or kernel 2
        # (models/vit.attention_route), an unknown name raises
        attention_route(cfg.model.tower_attn_impl)
        spec = dataclasses.replace(spec, entries=[
            dataclasses.replace(e, vit_config=dataclasses.replace(
                e.vit_config, attn_impl=cfg.model.tower_attn_impl))
            if e.kind == "vit" else e for e in spec.entries])
    if cfg.model.tower_fast_act:
        # erf-GELU -> tanh-GELU substitution, only where the act is "gelu"
        spec = dataclasses.replace(spec, entries=[
            dataclasses.replace(e, vit_config=dataclasses.replace(
                e.vit_config, hidden_act="gelu_tanh"))
            if e.kind == "vit" and e.vit_config.hidden_act == "gelu" else e
            for e in spec.entries])
    paths = cfg.model.tower_weights or []
    if paths and len(paths) != len(spec.entries):
        raise ValueError(f"model.tower_weights has {len(paths)} paths for "
                         f"{len(spec.entries)} tower entries")
    # diffusion bundles: the sidecar's configuration replaces the preset, and
    # the entry's grid and width are recomputed from it
    bundles, overrides = {}, {}
    entries = list(spec.entries)
    for i, path in enumerate(paths):
        if path and entries[i].kind == "diffusion":
            tree, fcfg = load_featurizer_bundle(path)
            if fcfg is not None:
                fcfg = dataclasses.replace(
                    fcfg, t=entries[i].t,
                    ensemble_size=entries[i].ensemble_size)
                overrides[entries[i].name] = fcfg
                grid = featurizer.feature_grid(fcfg)
                entries[i] = dataclasses.replace(
                    entries[i], hidden_size=featurizer.feature_dim(fcfg),
                    num_patches=grid * grid, img_size=fcfg.img_size,
                    up_ft_index=fcfg.up_ft_index)
            bundles[i] = (tree, fcfg or featurizer.FEATURIZER_PRESETS[
                entries[i].name]())
    spec = dataclasses.replace(spec, entries=entries)

    if cfg.model.decoder == "vicuna-7b":
        dec = llama.vicuna_7b()
    elif cfg.model.decoder == "tiny":
        dec = llama.tiny()
    else:
        raise ValueError(f"unknown decoder {cfg.model.decoder}")
    if cfg.model.decoder_layers:
        dec = dataclasses.replace(dec, num_layers=cfg.model.decoder_layers)
    if cfg.model.decode_attn:
        dec = dataclasses.replace(dec, decode_attn=cfg.model.decode_attn)
    model_cfg = llava.LlavaConfig(
        tower_spec=spec, decoder=dec,
        projector_type=cfg.model.projector_type,
        select_layer=cfg.model.select_layer,
        select_feature=cfg.model.select_feature,
        kv_quant=cfg.model.kv_quant,
        featurizer_overrides=overrides or None,
        visual_keep=cfg.model.visual_keep,
        prune_score=cfg.model.prune_score)
    if cfg.model.kv_quant not in (None, "int8"):
        raise ValueError(f"unknown model.kv_quant {cfg.model.kv_quant!r}")

    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(cfg.train.seed)
    state = None
    if cfg.model.checkpoint:
        path = checkpoint.latest_checkpoint(cfg.model.checkpoint) or \
            cfg.model.checkpoint
        if is_orbax_checkpoint(path):
            state = from_jax.llava_state_dict(restore_params(path))
        else:
            if os.path.isdir(path):
                path = os.path.join(path, "params.npz")
            state = from_jax.load_llava_npz(path)
    params = llava.init_params(
        generator, model_cfg, precision, device, quantize_bits=quantize_bits,
        decoder_weights=None if state is None else {
            k[len("decoder."):]: v for k, v in state.items()
            if k.startswith("decoder.")})

    for i, path in enumerate(paths):
        if i in bundles:
            tree, fcfg = bundles[i]
            params.towers[i] = featurizer.FeaturizerParams.for_state_dict(
                from_jax.featurizer_state_dict(tree), fcfg, precision,
                device=device)
        elif path:
            params.towers[i].load_state_dict(
                from_jax.vit_state_dict(load_params(path)))
    if state is not None:
        _load_checkpoint(params, state)
    if cfg.train.pretrain_mm_mlp_adapter:
        params.projector.load_state_dict(
            checkpoint.load_projector(cfg.train.pretrain_mm_mlp_adapter))
    return model_cfg, params


def _load_checkpoint(params: llava.LlavaParams, state: Dict) -> None:
    """`params.load_state_dict(state)`, strict, where a quantised module
    stands for the dense weight it was built from: that weight went in
    before the quantisation, and its codes and scales are not in `state`."""
    own = params.state_dict()
    held = {k: v for k, v in state.items() if k in own}
    quantised = {k[:-len("scale")] for k in own if k.endswith(".scale")}
    extra = [k for k in state if k not in own
             and not (k.endswith(".weight") and k[:-len("weight")] in quantised)]
    missing = [k for k in own if k not in state
               and k[:k.rindex(".") + 1] not in quantised]
    if extra or missing:
        raise RuntimeError(f"model.checkpoint does not fit the model: "
                           f"unexpected keys {extra[:5]}, missing keys "
                           f"{missing[:5]}")
    params.load_state_dict(held, strict=False)


def batch_to_device(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """A `collate_batch` dict of numpy arrays -> tensors on `device` (ids and
    labels as int64)."""
    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device, dtype)
    return {"input_ids": t(batch["input_ids"], torch.long),
            "labels": t(batch["labels"], torch.long),
            "text_mask": t(batch["text_mask"]),
            "pixel_values": [t(x) for x in batch["pixel_values"]]}


def plan_mesh(cfg: RunConfig, *, world_size: Optional[int] = None,
              rank: Optional[int] = None):
    """The training mesh of `cfg.parallel` over the world's processes (or a
    plan for `world_size` of them), with the JAX runner's checks and
    messages: the mesh fits the world, the batch and each microbatch divide
    over the data axis, the decoder layers over the pipeline stages and the
    batch into the pipeline's microbatches; a pipeline composes with
    neither `seq` nor LoRA nor ZeRO-3."""
    par = cfg.parallel
    mesh = make_mesh(n_data=par.n_data, n_model=par.n_model, n_seq=par.seq,
                     n_stage=par.pipeline, world_size=world_size, rank=rank)
    n_data = mesh.n("data")
    bs, accum = cfg.train.batch_size, cfg.train.grad_accum
    a = max(1, accum)
    if par.pipeline > 1:
        layers = cfg.model.decoder_layers or (
            llama.tiny() if cfg.model.decoder == "tiny"
            else llama.vicuna_7b()).num_layers
        if layers % par.pipeline:
            raise ValueError(f"decoder layers {layers} must divide over "
                             f"{par.pipeline} pipeline stages")
        micro = par.pp_microbatches or par.pipeline
        if bs % (micro * a):
            raise ValueError(f"batch_size {bs} must divide into {micro} "
                             f"pipeline microbatches (x grad_accum)")
        if par.seq > 1 or cfg.train.lora_enable:
            raise ValueError("pipeline parallelism composes with data/tensor "
                             "parallelism, not with cp or LoRA (v1)")
        if par.zero >= 3:
            raise ValueError("pipeline parallelism composes with zero<=2 "
                             "(stage-sharded layers; re-sharding them on "
                             "the data axis is not supported)")
    if bs % n_data:
        raise ValueError(f"batch_size {bs} must divide over the data axis "
                         f"({n_data} ways)")
    if bs % a:
        raise ValueError("batch_size must divide by grad_accum")
    if accum > 1 and (bs // accum) % n_data:
        raise ValueError(f"microbatch {bs // accum} must divide over the "
                         f"data axis ({n_data} ways)")
    if par.pipeline > 1 and (bs // (a * (par.pp_microbatches
                                         or par.pipeline))) % n_data:
        # a data rank holds its share of each pipeline microbatch
        raise ValueError(f"pipeline microbatch "
                         f"{bs // (a * (par.pp_microbatches or par.pipeline))}"
                         f" must divide over the data axis ({n_data} ways)")
    return mesh


@dataclasses.dataclass
class TrainRun:
    """What `run_training` leaves: the final state ({"params", "step"}) and
    optimizer, and what built them, so a caller can inspect or continue."""
    state: Dict[str, Any]
    opt: Any
    model_cfg: llava.LlavaConfig
    train_cfg: TrainConfig
    step_fn: Any
    dataset: Any
    mesh: Any = None          # the parallel.Mesh of the run


def run_training(cfg: RunConfig, *, device="cuda") -> TrainRun:
    """Train on the card (`cuda` by default: `cuda:LOCAL_RANK` in a run of
    several processes; the CPU runs only when asked for). Writes
    `<output_dir>/train.jsonl` (per step: loss, grad_norm,
    skipped_nonfinite, tokens, step_seconds), `checkpoint-{step}` every
    `save_steps`, and at the end the stage-1 projector (`mm_projector.npz`,
    `mm_projector.bin`, `config.json`) or, in stage 2, `switch.npz`, the
    LoRA-split save, or a final `checkpoint-{step}`."""
    mesh = plan_mesh(cfg)
    rank, n_procs = world()
    par = cfg.parallel
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to train with "
                           "the plain PyTorch path on the CPU")
    if device.type == "cuda" and device.index is None and n_procs > 1:
        device = local_device()
    bs = cfg.train.batch_size
    precision = DEFAULT_PRECISION if cfg.train.bf16 else FP32_PRECISION
    tokenizer = build_tokenizer(cfg)
    template = get_template("plain" if cfg.train.stage == 1
                            else cfg.model.conv_template)
    bits = None
    if cfg.train.quantize_base:
        # quantised frozen base (`train.py:908-932` load_in_{4,8}bit): the
        # integer weights take no updates, so the decoder must be frozen.
        # The activation gradient flows through kernel 10's autograd Function
        # (int4: its transposed form) or the plain cast-and-matmul (int8).
        # With `lora_enable` this is QLoRA: the adapters stay dense on top.
        # The decoder is built quantised, block by block
        if not (cfg.train.lora_enable or cfg.train.stage == 1):
            raise ValueError("train.quantize_base requires a frozen decoder "
                             "(stage 1 or lora_enable)")
        bits = {"int8": 8, "int4": 4}.get(cfg.train.quantize_base)
        if bits is None:
            raise ValueError(f"train.quantize_base must be int4/int8: "
                             f"{cfg.train.quantize_base!r}")
    model_cfg, params = build_model(cfg, device=device, precision=precision,
                                    quantize_bits=bits)

    def seeded(offset):
        g = torch.Generator(device=device)
        g.manual_seed(cfg.train.seed + offset)
        return g
    if cfg.train.lora_enable:
        params.lora = init_lora(
            seeded(1), model_cfg.decoder,
            LoraConfig(rank=cfg.train.lora_r, alpha=cfg.train.lora_alpha),
            precision, device)
    if cfg.train.switch_enable:
        params.switch = init_switch(seeded(2), model_cfg.decoder.hidden_size,
                                    precision, device)

    if cfg.data.feature_folder:
        ds = FeatureDataset(cfg.data.data_path, cfg.data.feature_folder,
                            template, tokenizer,
                            max_length=cfg.train.max_length)
    else:
        ds = SupervisedDataset(cfg.data.data_path, cfg.data.image_folder,
                               model_cfg.tower_spec, template, tokenizer,
                               pad_square=cfg.data.image_aspect_ratio
                               == "pad", max_length=cfg.train.max_length)
    total = max(1, len(ds) // bs) * cfg.train.epochs
    tcfg = TrainConfig(stage=cfg.train.stage,
                       learning_rate=cfg.train.learning_rate,
                       weight_decay=cfg.train.weight_decay,
                       warmup_ratio=cfg.train.warmup_ratio,
                       total_steps=total,
                       remat=cfg.train.gradient_checkpointing,
                       remat_policy=cfg.train.remat_policy,
                       use_flash=(device.type == "cuda"
                                  and precision.compute_dtype
                                  == torch.bfloat16),
                       fused_optimizer=cfg.train.fused_optimizer,
                       grad_accum=cfg.train.grad_accum,
                       lora_rank=cfg.train.lora_r if cfg.train.lora_enable
                       else 0,
                       lora_alpha=cfg.train.lora_alpha,
                       switch_sigma=cfg.train.switch_sigma
                       if cfg.train.switch_enable else 0.0)
    cp = pp = None
    if par.seq > 1:
        # the spliced sequence pads to a seq-axis multiple inside loss_fn
        cp = ContextParallel(mesh)
    if par.pipeline > 1:
        pp = PipelineParallel(mesh, microbatches=par.pp_microbatches,
                              remat_ticks=par.pp_remat_ticks)
    state, opt = init_sharded_train_state(
        params, tcfg, model_cfg, mesh, zero=par.zero,
        offload_opt_state=par.offload_opt_state,
        offload_params=par.offload_params, pipeline=pp is not None)
    step_fn = make_train_step(model_cfg, tcfg, opt, mesh=mesh, cp=cp, pp=pp)
    # a data rank's rows: its share of each grad-accumulation microbatch's
    # pipeline microbatches
    splits = max(1, cfg.train.grad_accum) * (pp.n_micro if pp is not None
                                             else 1)

    def make_batch(sl):
        # every rank collates the same global batch (one padded length),
        # then keeps its data rows
        samples = [ds[int(i)] for i in sl]
        batch = collate_batch(samples, max_length=cfg.train.max_length)
        rows = batch["input_ids"].shape
        batch = shard_batch(batch, mesh, splits)
        return rows, batch_to_device(batch, device)

    def save(write) -> None:
        """`write()` on rank 0 over the whole tensors (every rank gathers)."""
        with whole_params(params, opt, mesh):
            if rank == 0:
                write()

    logger = MetricsLogger(cfg.train.output_dir, "train",
                           every=cfg.train.logging_steps)
    step = 0
    try:
        for epoch in range(cfg.train.epochs):
            if cfg.train.group_by_modality_length and hasattr(ds,
                                                              "lengths"):
                order = length_grouped_indices(ds.lengths(), bs, 1,
                                               seed=cfg.train.seed + epoch)
            else:
                order = np.random.default_rng(
                    cfg.train.seed + epoch).permutation(len(ds))
            slices = [order[s:s + bs]
                      for s in range(0, len(order) - bs + 1, bs)]
            # batch N+1 decodes, collates and uploads on a host thread
            # while step N runs
            for (b, n), batch in map_prefetch(make_batch, slices, depth=2):
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                out = {k: float(metrics[k]) for k in
                       ("loss", "grad_norm", "skipped_nonfinite")}
                out["step_seconds"] = time.perf_counter() - t0
                out["tokens"] = b * (n + model_cfg.num_patches - 1)
                out["epoch"] = epoch
                step += 1
                logger.log(step, out)
                if step % cfg.train.save_steps == 0:
                    moments = GatheredOptState(opt, mesh)
                    save(lambda: checkpoint.save_train_state(
                        cfg.train.output_dir, params, moments, step,
                        keep=cfg.train.save_total_limit or None))

        if cfg.train.stage == 1:
            # MoF: one width a tower (the JAX runner asks the spec for one
            # width, which raises under MoF)
            spec = model_cfg.tower_spec
            save(lambda: checkpoint.save_projector(
                cfg.train.output_dir, params.projector,
                config={"mm_projector_type": cfg.model.projector_type,
                        "mm_hidden_size":
                        [e.hidden_size for e in spec.entries]
                        if spec.join == "mof" else spec.mm_hidden_size},
                proj_type=cfg.model.projector_type))
            rank0_print(f"stage-1 projector saved to "
                        f"{cfg.train.output_dir}")
        elif cfg.train.switch_enable:
            save(lambda: checkpoint.save_switch(cfg.train.output_dir,
                                                params.switch))
            rank0_print(f"switch W saved to {cfg.train.output_dir}")
        elif cfg.train.lora_enable:
            # LoRA-split save (`train.py:1122-1132`): the adapters and the
            # other trainables (the projector), not the frozen base
            save(lambda: checkpoint.save_lora(
                cfg.train.output_dir, params, cfg.train.lora_r,
                cfg.train.lora_alpha))
            rank0_print(f"LoRA adapters saved to {cfg.train.output_dir}")
        else:
            moments = GatheredOptState(opt, mesh)
            save(lambda: checkpoint.save_train_state(
                cfg.train.output_dir, params, moments, step))
    finally:
        logger.close()
    return TrainRun(state=state, opt=opt, model_cfg=model_cfg,
                    train_cfg=tcfg, step_fn=step_fn, dataset=ds,
                    mesh=mesh)
