"""CLI of the PyTorch port (counterpart of the JAX package's `cli.py`).

Commands:
  train             stage-1/2 LLaVA training from a RunConfig YAML (LoRA,
                    QLoRA and the switch ablation through `--set
                    train.lora_enable=true`, `train.quantize_base=int4`,
                    `train.switch_enable=true`)
  generate          one-shot inference (image + prompt -> answer)
  serve             OpenAI-compatible chat-completions server (wave
                    batching, or --inflight continuous batching)
  eval              benchmark evaluation through the eval harness
  tasks             list the bundled eval tasks
  extract-embeds    dump post-projector embeddings for the A score
  a-score           A score over dumped embeddings (kernel 9 on the card)
  extract-features  per-image tower features for the C score (the tower's
                    kernel 1 or 2 on the card), one fp32 .npy an image
  c-score           SPair / AP-10k / PF-Pascal PCK over extracted features
                    (the zero-shot C score and its geo-aware subset)
  policy            fit / predict / validate the AC policy over a results CSV
  make-config       a RunConfig YAML for one of the paper's 13
                    representations (the JAX package's text)
  port-featurizer   a diffusers snapshot directory -> a featurizer bundle
                    (the prompt encoded on the card: kernel 2, causal)

Single components of HF / diffusers snapshots are ported by `python -m
law_of_vision_representation_in_mllms_torch.io.port_cli`. Eight commands
of the JAX CLI are not ported yet (ROADMAP, queue 1): `apply-delta`,
`make-delta`, `consolidate`, `merge-results`, `c-train`, `sam-masks`,
`preprocess-map` and `pose-awareness`.
Run on the card with `--device cuda` (the default); there is no silent CPU
fallback, a CPU run takes an explicit `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys


def _add_common(p):
    p.add_argument("--config", help="RunConfig YAML")
    p.add_argument("--set", action="append", default=[],
                   help="override, e.g. --set model.decoder=tiny")


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu must be explicit)")


def _device(args):
    """The requested torch device; a CUDA request without a card raises
    instead of falling back to the CPU."""
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain PyTorch path on the CPU")
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(prog="lvr-torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("train", help="LLaVA stage-1/2 training")
    _add_common(p)
    _add_device(p)

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
                   help="0 = greedy; > 0 samples")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling mass (with --temperature > 0)")
    _add_device(p)

    p = sub.add_parser("serve", help="OpenAI-compatible model server")
    _add_common(p)
    p.add_argument("--model", default="llava",
                   help="adapter name (only llava is ported)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="dynamic-batching max requests per dispatch")
    p.add_argument("--batch-window-ms", type=float, default=5.0,
                   help="coalescing window after the first request")
    p.add_argument("--gen-backend",
                   choices=["greedy", "chunked", "speculative"],
                   help="decode backend (shorthand for --set "
                        "model.gen_backend=...; all three give greedy's "
                        "tokens; on the card greedy runs as chunked)")
    p.add_argument("--inflight", action="store_true",
                   help="continuous batching: requests join and leave a "
                        "running slot pool between decode chunks "
                        "(models/inflight.py)")
    p.add_argument("--slots", type=int, default=4,
                   help="--inflight: concurrent decode slots")
    p.add_argument("--prompt-cap", type=int, default=256,
                   help="--inflight: max prompt tokens a request")
    p.add_argument("--gen-cap", type=int, default=256,
                   help="--inflight: max generated tokens a request")
    p.add_argument("--decode-chunk-serve", type=int, default=4,
                   help="--inflight: decode steps a chunk (one CUDA graph "
                        "replay; admission waits at most one chunk)")
    p.add_argument("--prefix-cache", type=int, default=0,
                   help="--inflight: prompt-KV store entries (a repeated "
                        "prompt skips the tower and the prefill; 0 = off)")
    p.add_argument("--prefix-block", type=int, default=64,
                   help="--prefix-cache: partial-prefix reuse granularity "
                        "in spliced cache slots")
    p.add_argument("--prefix-cache-mb", type=int, default=0,
                   help="--prefix-cache: byte budget of the store in MB (0 = "
                        "the entry count only); one stored prompt of "
                        "LLaVA-1.5-7B at --prompt-cap 64 --gen-cap 32 is "
                        "~350 MB in bf16")
    _add_device(p)

    p = sub.add_parser("eval", help="benchmark evaluation")
    _add_common(p)
    p.add_argument("--tasks", nargs="+", required=True)
    p.add_argument("--limit", type=int)
    p.add_argument("--output", default="eval_results.json")
    p.add_argument("--model", default="llava",
                   help="adapter name (only llava is ported)")
    p.add_argument("--log-samples", action="store_true",
                   help="write per-doc records next to --output "
                        "(lmms-eval --log_samples)")
    _add_device(p)

    p = sub.add_parser("tasks", help="list bundled eval tasks")
    _add_device(p)

    p = sub.add_parser("extract-embeds", help="A-score embedding dump")
    _add_common(p)
    p.add_argument("--task", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--limit", type=int, default=100)
    _add_device(p)

    p = sub.add_parser("extract-features", help="offline feature dump")
    _add_common(p)
    p.add_argument("--images", required=True,
                   help="directory or json list of image paths")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--suffix", default="")
    _add_device(p)

    p = sub.add_parser("a-score")
    p.add_argument("--base-folder", required=True)
    p.add_argument("--reps", nargs="+", required=True)
    p.add_argument("--n-images", type=int, default=100)
    _add_device(p)

    p = sub.add_parser("c-score")
    p.add_argument("--spair-dir", required=True,
                   help="dataset root (SPair-71k / AP-10k / PF-Pascal)")
    p.add_argument("--feature-dir", required=True)
    p.add_argument("--num-patches", type=int, required=True)
    p.add_argument("--suffix", default="")
    p.add_argument("--suffix2", help="two-feature concat variant")
    p.add_argument("--anno-size", type=int, default=840)
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--categories", nargs="*")
    p.add_argument("--subsample", type=int)
    p.add_argument("--dataset", default="spair",
                   choices=["spair", "ap10k", "pascal"])
    _add_device(p)

    p = sub.add_parser("policy")
    p.add_argument("action", choices=["fit", "predict", "validate"])
    p.add_argument("--csv", required=True)
    p.add_argument("--benchmark")
    p.add_argument("--data", default="AC",
                   choices=["AC", "A", "C", "random", "Ar"])
    p.add_argument("--model", default="polynomial",
                   choices=["polynomial", "linear"])
    p.add_argument("--train-models", nargs="*")
    p.add_argument("--top", type=int, default=1)
    _add_device(p)

    p = sub.add_parser("make-config",
                       help="emit a RunConfig YAML for one of the paper's "
                            "13 representations")
    p.add_argument("rep", help="e.g. CLIP336, SD1.5, CLIP336+DINOv2; "
                               "'list' prints all")
    p.add_argument("--stage", type=int, default=1, choices=[1, 2])
    p.add_argument("--tokenizer", default="/ckpts/vicuna-7b-v1.5")
    p.add_argument("--output-dir")
    p.add_argument("--data-path", default="")
    p.add_argument("--image-folder", default="")
    p.add_argument("--n-data", type=int, default=8)
    p.add_argument("--n-model", type=int, default=1)
    p.add_argument("--zero", type=int, default=2)
    p.add_argument("--lora", action="store_true",
                   help="finetune_lora.sh variant (r=128, alpha=256)")
    p.add_argument("--qlora", choices=["int4", "int8"],
                   help="LoRA + quantized frozen decoder base (QLoRA)")

    p = sub.add_parser("port-featurizer",
                       help="diffusers snapshot dir -> featurizer bundle")
    p.add_argument("kind",
                   choices=["sd15", "sd21", "imsd", "sdxl", "dit", "sd3"])
    p.add_argument("src_root", help="snapshot with unet/ vae/ text_encoder*/")
    p.add_argument("out_path")
    p.add_argument("--t", type=int, default=1)
    p.add_argument("--up-ft-index", type=int)
    p.add_argument("--ensemble-size", type=int, default=1)
    p.add_argument("--img-size", type=int)
    _add_device(p)

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
    from .eval.api import Instance
    from .eval.runner import build_lmm
    device = _device(args)
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


def _cmd_serve(args):
    """Serve the LLaVA of the RunConfig until interrupted."""
    from .serve import run_server
    device = _device(args)
    cfg = _run_config(args)
    if args.gen_backend:
        cfg.model.gen_backend = args.gen_backend
    srv = run_server(cfg, device=device, model=args.model, host=args.host,
                     port=args.port, max_batch=args.max_batch,
                     batch_window_ms=args.batch_window_ms,
                     inflight=args.inflight,
                     inflight_kwargs={
                         "n_slots": args.slots,
                         "prompt_cap": args.prompt_cap,
                         "gen_cap": args.gen_cap,
                         "chunk": args.decode_chunk_serve,
                         "prefix_cache": args.prefix_cache,
                         "prefix_block": args.prefix_block,
                         "prefix_cache_bytes":
                             args.prefix_cache_mb * (1 << 20),
                     } if args.inflight else None)
    print(f"serving {args.model} on http://{args.host}:{srv.port}/v1",
          file=sys.stderr)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        print("shutting down", file=sys.stderr)
    finally:
        srv.shutdown()
    return 0


def _cmd_eval(args):
    """`lmms_eval --model llava --tasks ...`: results JSON to `--output`
    (and per-doc `*_samples.jsonl` with `--log-samples`), the task values to
    stdout."""
    import os

    from .eval.runner import run_evaluation
    res = run_evaluation(_run_config(args), args.tasks, device=_device(args),
                         limit=args.limit, model=args.model,
                         log_samples=args.log_samples)
    with open(args.output, "w") as f:
        json.dump({k: {kk: vv for kk, vv in v.items() if kk != "samples"}
                   for k, v in res.items()}, f, indent=1)
    if args.log_samples:
        base, _ = os.path.splitext(args.output)
        for task, v in res.items():
            with open(f"{base}_{task}_samples.jsonl", "w") as f:
                for rec in v.get("samples") or []:
                    f.write(json.dumps(rec) + "\n")
    print(json.dumps({k: v["value"] for k, v in res.items()}, indent=1))
    return 0


def _cmd_tasks(args):
    import glob
    import os

    _device(args)
    from .eval.tasks import TASK_DIR
    for path in sorted(glob.glob(os.path.join(TASK_DIR, "*.yaml"))):
        name = os.path.splitext(os.path.basename(path))[0]
        desc = ""
        with open(path) as f:
            first = f.readline().strip()
            if first.startswith("#"):
                desc = first.lstrip("# ")
        print(f"{name:28s} {desc}")
    return 0


def _cmd_extract_embeds(args):
    from .eval.runner import run_embed_extraction
    n = run_embed_extraction(_run_config(args), args.task, args.out_dir,
                             device=_device(args), limit=args.limit)
    print(f"dumped {n} embeddings to {args.out_dir}")
    return 0


def _cmd_a_score(args):
    from .pipeline.a_score_run import compute_a_scores
    scores = compute_a_scores(args.base_folder, args.reps,
                              n_images=args.n_images, device=_device(args))
    print(json.dumps(scores, indent=1))
    return 0


def _cmd_extract_features(args):
    from .pipeline.runner import run_feature_extraction
    device = _device(args)
    n = run_feature_extraction(_run_config(args), args.images, args.out_dir,
                               device=device, batch_size=args.batch_size,
                               suffix=args.suffix)
    print(f"extracted {n} feature files to {args.out_dir}")
    return 0


def _cmd_c_score(args):
    from .pipeline.c_score_run import run_c_score
    res = run_c_score(args.spair_dir, args.feature_dir, device=_device(args),
                      suffix=args.suffix, suffix2=args.suffix2,
                      num_patches=args.num_patches,
                      anno_size=args.anno_size, window=args.window,
                      categories=args.categories or None,
                      subsample=args.subsample, dataset=args.dataset)
    out = {"per_img_pck": res["per_img"], "per_kpt_pck": res["per_kpt"]}
    if "geo" in res:
        out["geo_pck"] = res["geo"]
    print(json.dumps(out, indent=1))
    return 0


def _cmd_policy(args):
    from .policy import (ALL_MODELS, BENCHMARKS, fit_policy, load_ac_csv,
                         prediction_accuracy, validate_run)
    # the 6-feature least-squares fit is numpy on the host; the command
    # still refuses to run unasked on a machine without a card
    _device(args)
    table = load_ac_csv(args.csv)
    if args.action == "fit":
        for b in ([args.benchmark] if args.benchmark else BENCHMARKS):
            fit = fit_policy(table, b, data=args.data, model=args.model)
            print(f"{b}: r2={fit.r2:.4f} mse={fit.mse:.5f}")
    elif args.action == "validate":
        ok, top = validate_run(table, args.benchmark,
                               args.train_models or ALL_MODELS,
                               top=args.top)
        print(json.dumps({"hit": bool(ok), "top": list(top)}))
    else:
        for k in (4, 8, 12):
            acc = prediction_accuracy(table, k=k, data=args.data,
                                      model=args.model, top=args.top)
            print(f"k={k}: accuracy={acc:.4f}")
    return 0


def _cmd_make_config(args):
    from .core.representations import REPRESENTATIONS, render_config
    if args.rep == "list":
        for name, rep in REPRESENTATIONS.items():
            print(f"{name}\t{rep.tower}")
        return 0
    print(render_config(args.rep, args.stage, tokenizer=args.tokenizer,
                        output_dir=args.output_dir,
                        data_path=args.data_path,
                        image_folder=args.image_folder,
                        n_data=args.n_data, n_model=args.n_model,
                        zero=args.zero, lora=args.lora,
                        qlora=args.qlora))
    return 0


def _cmd_port_featurizer(args):
    """A diffusers snapshot -> a bundle for `model.tower_weights`: the
    weights ported on the host, the fixed prompt encoded on `--device`."""
    from .io.featurizer_bundle import port_featurizer_bundle
    out = port_featurizer_bundle(
        args.kind, args.src_root, args.out_path, t=args.t,
        up_ft_index=args.up_ft_index, ensemble_size=args.ensemble_size,
        img_size=args.img_size, device=_device(args))
    print(f"ported {args.kind} bundle -> {out}")
    return 0


DISPATCH = {
    "train": _cmd_train,
    "generate": _cmd_generate,
    "serve": _cmd_serve,
    "eval": _cmd_eval,
    "tasks": _cmd_tasks,
    "extract-embeds": _cmd_extract_embeds,
    "extract-features": _cmd_extract_features,
    "a-score": _cmd_a_score,
    "c-score": _cmd_c_score,
    "policy": _cmd_policy,
    "make-config": _cmd_make_config,
    "port-featurizer": _cmd_port_featurizer,
}


if __name__ == "__main__":
    sys.exit(main())
