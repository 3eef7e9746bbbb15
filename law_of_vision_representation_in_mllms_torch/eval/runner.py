"""Evaluation runner: RunConfig -> LlavaLMM -> tasks (counterpart of the JAX
package's `eval/runner.py`).

The `accelerate launch -m lmms_eval --model llava ...` equivalent
(`lmms_eval/__main__.py`), plus the embedding-extraction loop
(`run_embed_extract.sh`) as a function. Every entry point takes an explicit
`device`. Only `--model llava` is ported; the adapter registry comes with the
rest of the eval harness.
"""

from __future__ import annotations

import os
from typing import List, Optional

from ..core.config import RunConfig
from ..core.precision import BF16_PRECISION, FP32_PRECISION
from ..data.conversation import get_template
from .evaluator import simple_evaluate
from .llava_adapter import LlavaLMM
from .task import load_task
from .tasks import PAPER_TASKS, task_yaml


def _resolve_task(name_or_path: str):
    if os.path.exists(name_or_path):
        return name_or_path
    if name_or_path in PAPER_TASKS:
        return task_yaml(name_or_path)
    raise FileNotFoundError(f"unknown task {name_or_path}")


def build_lmm(cfg: RunConfig, *, device) -> LlavaLMM:
    """`train.bf16` (the default) keeps weights and activations in bf16, as
    the CUDA kernels require; otherwise everything is fp32 (CPU only).
    `model.quantize=int8|int4` builds the decoder's matmul weights
    quantised, block by block on `device`: the dense decoder is never whole
    there."""
    from ..train.runner import build_model, build_tokenizer
    precision = BF16_PRECISION if cfg.train.bf16 else FP32_PRECISION
    bits = {"int8": 8, "int4": 4}.get(cfg.model.quantize)
    if cfg.model.quantize and bits is None:
        raise ValueError(f"unknown model.quantize {cfg.model.quantize!r}")
    model_cfg, params = build_model(cfg, device=device, precision=precision,
                                    quantize_bits=bits)
    return LlavaLMM(params, model_cfg, build_tokenizer(cfg),
                    get_template(cfg.model.conv_template),
                    pad_square=cfg.data.image_aspect_ratio == "pad",
                    gen_backend=cfg.model.gen_backend)


def run_evaluation(cfg: RunConfig, tasks: List[str], *, device,
                   limit: Optional[int] = None, log_samples: bool = False,
                   model: str = "llava", model_args: Optional[dict] = None,
                   process_index: int = 0, process_count: int = 1):
    """`--model llava` evaluates the model built from the RunConfig on
    `device`. Docs are sharded `docs[process_index::process_count]`; both
    stay 0/1 until the port has multi-process runs."""
    if model != "llava":
        raise NotImplementedError(
            f"eval model {model!r}: the adapter registry "
            f"(eval/models_registry.py) is not ported to the PyTorch "
            f"package yet (ROADMAP, queue 1: 4, the rest of the CLI and "
            f"eval)")
    paths = [_resolve_task(t) for t in tasks]
    lmm = build_lmm(cfg, device=device)
    return simple_evaluate(lmm, paths, limit=limit, log_samples=log_samples,
                           process_index=process_index,
                           process_count=process_count)


def run_embed_extraction(cfg: RunConfig, task: str, out_dir: str, *, device,
                         limit: int = 100) -> int:
    """A-score phase A: dump post-projector embeddings for the first `limit`
    docs of a benchmark (`run_embed_extract.sh:25-35` + the commented hooks
    in `lmms_eval/models/llava.py:38-51` / `llava_arch.py:475-476`)."""
    path = _resolve_task(task)
    lmm = build_lmm(cfg, device=device)
    t = load_task(path, limit=limit)
    requests = t.build_requests(list(range(len(t.docs)))[:limit])
    return lmm.dump_image_embeds_for_docs(requests, out_dir, limit=limit)
