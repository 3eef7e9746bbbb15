"""One typed run-config for the whole pipeline (a copy of the JAX
package's `core/config.py`, which cannot be imported without JAX).

Plain dataclasses; `yaml` is imported only by `RunConfig.from_yaml`. Fields
that name TPU-only machinery keep their JAX-side meaning; the port's
`train.runner.build_model` raises on the ones it does not support yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class ModelSection:
    vision_tower: str = "openai/clip-vit-large-patch14-336"
    decoder: str = "vicuna-7b"             # vicuna-7b | tiny
    # depth override for the decoder preset (None = preset depth)
    decoder_layers: Optional[int] = None
    projector_type: str = "mlp2x_gelu"
    select_layer: int = -2
    select_feature: str = "patch"
    # diffusion tower knobs (`train.py:83-88`)
    up_ft_index: int = 0
    t: int = 1
    prompt: str = ""
    ensemble_size: int = 1
    img_size: Optional[int] = None
    conv_template: str = "v1"
    # opt-in visual-token pruning (top-K image tokens by `prune_score`)
    visual_keep: Optional[int] = None
    prune_score: str = "auto"
    # decode backend: greedy | chunked | speculative (greedy-equivalent;
    # greedy decoding on the card always runs chunked, as CUDA graphs)
    gen_backend: str = "greedy"
    decode_chunk: int = 16
    negotiate_layouts: bool = False        # JAX-only (XLA layouts)
    draft_len: int = 8
    # seed of the eval adapter's sampling generator (the JAX adapter's
    # `sample_seed` argument, default 0)
    sample_seed: int = 0
    # weight-only decoder quantization ("int8" | "int4" | None)
    quantize: Optional[str] = None
    # KV-cache quantization ("int8" | None)
    kv_quant: Optional[str] = None
    # decode-step attention route of the JAX package ("xla" | "pallas" |
    # "pallas_stacked"); every route is the same math as the port's kernel 3
    decode_attn: Optional[str] = None
    # ViT-tower / diffusion attention impl overrides of the JAX package
    tower_attn_impl: Optional[str] = None
    diffusion_attn_impl: Optional[str] = None
    # substitute tanh-GELU for erf-GELU in the towers
    tower_fast_act: bool = False
    checkpoint: Optional[str] = None       # params (.npz in the port)
    tokenizer: Optional[str] = None        # HF tokenizer path (host-side)
    # ported tower weights, one path per tower-spec entry ('' = skip);
    # ViT entries take a plain io.param_io .npz
    tower_weights: Optional[List[str]] = None


@dataclasses.dataclass
class TrainSection:
    stage: int = 1
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    epochs: int = 1
    batch_size: int = 32
    grad_accum: int = 1
    max_length: int = 2048
    bf16: bool = True
    gradient_checkpointing: bool = False
    # remat save policy when gradient_checkpointing is on: "block" or
    # "dots" (models/llama._remat)
    remat_policy: str = "block"
    # single-fusion AdamW (train_step.FusedAdamW); False = optax chain
    fused_optimizer: bool = True
    group_by_modality_length: bool = False
    # LoRA finetune (`finetune_lora.sh`: lora_r 128, lora_alpha 256)
    lora_enable: bool = False
    lora_r: int = 128
    lora_alpha: float = 256.0
    # QLoRA: quantize the FROZEN decoder base to "int4"/"int8"
    # (ops/quant.py weight-only; reference `train.py:908-932`
    # BitsAndBytesConfig load_in_{4,8}bit + peft). Requires a frozen
    # decoder (stage 1 or lora_enable); the 4-bit base cuts resident
    # decoder bytes 4x vs bf16 while adapters/projector train dense.
    quantize_base: Optional[str] = None
    # "Switch" steering ablation (train_switch.py): only W trains
    switch_enable: bool = False
    switch_sigma: float = 1.0
    pretrain_mm_mlp_adapter: Optional[str] = None
    output_dir: str = "checkpoints/run"
    save_steps: int = 500
    # prune to the newest N step checkpoints (HF save_total_limit); 0 = all
    save_total_limit: int = 0
    logging_steps: int = 1
    seed: int = 42


@dataclasses.dataclass
class DataSection:
    data_path: str = ""
    image_folder: str = ""
    feature_folder: Optional[str] = None   # feature-cached training
    image_aspect_ratio: str = "pad"


@dataclasses.dataclass
class ParallelSection:
    n_data: Optional[int] = None
    n_model: int = 1
    # context parallelism: shard the decoder sequence `seq` ways and run
    # ring attention over the mesh's seq axis (ops/ring_attention.py) —
    # long-context headroom the reference lacks (2048-token cap)
    seq: int = 1
    # pipeline parallelism: GPipe-schedule the decoder trunk over
    # `pipeline` stages (parallel/pipeline.py); layer stack shards on the
    # mesh's stage axis. Composes with data/tensor parallelism and
    # zero<=2; exclusive with seq>1 and LoRA.
    pipeline: int = 1
    # GPipe microbatch count (bubble = (S-1)/(M+S-1)); None -> one/stage
    pp_microbatches: Optional[int] = None
    # checkpoint each pipeline tick (saves ~(M+S-1)x of circulating
    # activations for one extra forward of recompute)
    pp_remat_ticks: bool = False
    # ZeRO level (deepspeed `scripts/zero{2,3}.json` equivalents):
    # 0 = TP-only/replicated, 2 = shard optimizer state on the data axis,
    # 3 = shard params + optimizer state (FSDP).
    zero: int = 0
    # place AdamW moments in pinned_host memory (zero3_offload.json)
    offload_opt_state: bool = False
    # additionally keep the params in pinned_host between steps (deepspeed
    # offload_param; they are streamed to HBM for each forward)
    offload_params: bool = False


@dataclasses.dataclass
class RunConfig:
    model: ModelSection = dataclasses.field(default_factory=ModelSection)
    train: TrainSection = dataclasses.field(default_factory=TrainSection)
    data: DataSection = dataclasses.field(default_factory=DataSection)
    parallel: ParallelSection = dataclasses.field(
        default_factory=ParallelSection)

    @classmethod
    def from_yaml(cls, path: str, overrides: Optional[List[str]] = None
                  ) -> "RunConfig":
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw, overrides)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any],
                  overrides: Optional[List[str]] = None) -> "RunConfig":
        cfg = cls()
        for section_name in ("model", "train", "data", "parallel"):
            section = getattr(cfg, section_name)
            for k, v in (raw.get(section_name) or {}).items():
                if not hasattr(section, k):
                    raise ValueError(
                        f"unknown config key {section_name}.{k}")
                setattr(section, k, v)
        for ov in overrides or []:
            key, _, val = ov.partition("=")
            section_name, _, field = key.partition(".")
            section = getattr(cfg, section_name)
            cur = getattr(section, field)  # raises on unknown keys
            setattr(section, field,
                    _coerce(val, cur, type(section).__annotations__
                            .get(field)))
        return cfg


def _coerce(val: str, like: Any, annotation: Any = None):
    if isinstance(like, bool):
        return val.lower() in ("1", "true", "yes")
    if isinstance(like, int):
        return int(val)
    if isinstance(like, float):
        return float(val)
    if like is None:
        # Optional fields: coerce by the DECLARED type, not by whether the
        # value happens to look numeric (a checkpoint dir named "123" must
        # stay a string; tower_weights must become a list)
        if val.lower() in ("none", "null", ""):
            return None
        ann = str(annotation or "")
        if "List" in ann or "list" in ann:
            import json as _json
            if val.startswith("["):
                return _json.loads(val)
            return val.split(":")       # path-list shorthand a.npz:b.npz
        if "int" in ann:
            return int(val)
        if "float" in ann:
            return float(val)
        return val
    return val
