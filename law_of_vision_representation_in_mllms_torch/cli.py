"""CLI of the PyTorch port (counterpart of the JAX package's `cli.py`).

Commands:
  train             stage-1/2 LLaVA training from a RunConfig YAML
  generate          one-shot inference (image + prompt -> answer)

The other commands of the JAX CLI are not ported yet (ROADMAP, queue 1).
Run on the card with `--device cuda` (the default); there is no silent CPU
fallback, a CPU run takes an explicit `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys


def _add_common(p):
    p.add_argument("--config", help="RunConfig YAML")
    p.add_argument("--set", action="append", default=[],
                   help="override, e.g. --set model.decoder=tiny")


def main(argv=None):
    parser = argparse.ArgumentParser(prog="lvr-torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="LLaVA stage-1/2 training")
    _add_common(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be explicit)")

    p = sub.add_parser("generate",
                       help="one-shot inference: image + prompt -> answer "
                            "(run_llava.py equivalent)")
    _add_common(p)
    p.add_argument("--image", help="image path (omit for text-only)")
    p.add_argument("--prompt", required=True)
    p.add_argument("--max-new-tokens", type=int, default=128)
    p.add_argument("--gen-backend",
                   choices=["greedy", "chunked", "speculative"])
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy (sampling is not ported yet)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass (with --temperature > 0)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be explicit)")

    args = parser.parse_args(argv)
    return DISPATCH[args.cmd](args)


def _run_config(args):
    from .core.config import RunConfig
    if args.config:
        return RunConfig.from_yaml(args.config, args.set)
    return RunConfig.from_dict({}, args.set)


def _cmd_train(args):
    """`deepspeed llava/train/train.py` + `scripts/v1_5/train/*.sh` as one
    command: the RunConfig YAML (and `--set` overrides) -> run_training."""
    from .train.runner import run_training
    run_training(_run_config(args), device=args.device)
    return 0


def _cmd_generate(args):
    """One-shot inference (`llava/eval/run_llava.py:1-100` eval_model):
    template-rendered prompt + one image through the adapter; the answer
    prints to stdout."""
    import torch

    from .eval.api import Instance
    from .eval.runner import build_lmm
    if args.temperature > 0:
        raise NotImplementedError(
            "--temperature > 0 (sampling) is not ported to the PyTorch "
            "package yet (ROADMAP, queue 1: 6, serving backends)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch path on the CPU")
    cfg = _run_config(args)
    if args.gen_backend:
        cfg.model.gen_backend = args.gen_backend
    lmm = build_lmm(cfg, device=device)
    visual = []
    if args.image:
        from PIL import Image
        visual = [Image.open(args.image).convert("RGB")]
    inst = Instance("generate_until", {}, 0, "cli",
                    (args.prompt,
                     {"max_new_tokens": args.max_new_tokens,
                      "temperature": args.temperature,
                      "top_p": args.top_p}), visual)
    print(lmm.generate_until([inst])[0])
    return 0


DISPATCH = {
    "train": _cmd_train,
    "generate": _cmd_generate,
}


if __name__ == "__main__":
    sys.exit(main())
