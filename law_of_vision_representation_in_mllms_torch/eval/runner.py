"""RunConfig -> LlavaLMM (counterpart of the JAX package's
`eval/runner.py` `build_lmm`). Task evaluation and the embedding-dump runner
are not ported yet."""

from __future__ import annotations

from ..core.config import RunConfig
from ..core.precision import BF16_PRECISION, FP32_PRECISION
from ..data.conversation import get_template
from .llava_adapter import LlavaLMM


def build_lmm(cfg: RunConfig, *, device) -> LlavaLMM:
    """`train.bf16` (the default) keeps weights and activations in bf16, as
    the CUDA kernels require; otherwise everything is fp32 (CPU only)."""
    from ..train.runner import build_model, build_tokenizer
    precision = BF16_PRECISION if cfg.train.bf16 else FP32_PRECISION
    model_cfg, params = build_model(cfg, device=device, precision=precision)
    return LlavaLMM(params, model_cfg, build_tokenizer(cfg),
                    get_template(cfg.model.conv_template),
                    pad_square=cfg.data.image_aspect_ratio == "pad",
                    gen_backend=cfg.model.gen_backend)
