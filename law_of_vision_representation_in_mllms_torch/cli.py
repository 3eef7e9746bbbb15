"""CLI of the PyTorch port (counterpart of the JAX package's `cli.py`).

Commands:
  train             stage-1/2 LLaVA training from a RunConfig YAML (LoRA,
                    QLoRA and the switch ablation through `--set
                    train.lora_enable=true`, `train.quantize_base=int4`,
                    `train.switch_enable=true`)
  generate          one-shot inference (image + prompt -> answer)
  serve             OpenAI-compatible chat-completions server (wave
                    batching, or --inflight continuous batching)
  eval              benchmark evaluation through the eval harness (`--model`
                    names any adapter of the registry, `--model-args k=v`)
  tasks             list the bundled eval tasks
  merge-results     merge doc-sharded per-process sample logs into one
                    aggregated result
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
  apply-delta       target = base + delta over flat .npz parameter files
  make-delta        delta = target - base over flat .npz parameter files
  consolidate       a train checkpoint (the port's runner's, or the JAX
                    runner's orbax one) -> one flat params .npz

  preprocess-map    GeoAware-SC: multi-scale SD maps and DINOv2 facet
                    descriptors of every image and its mirror (kernels 2
                    and 1 on the card)
  sam-masks         GeoAware-SC foreground masks by a box-prompted SAM from
                    a local HF snapshot (plain PyTorch)
  pose-awareness    GeoAware-SC pose-awareness test over preprocess-map's
                    files (co-PCA, masked nearest-neighbour distances)
  c-train           supervised correspondence training of the aggregation
                    network (AdamW, PCK evaluations, best.npz / last.npz)

Single components of HF / diffusers snapshots are ported by `python -m
law_of_vision_representation_in_mllms_torch.io.port_cli`.
Run on the card with `--device cuda` (the default); there is no silent CPU
fallback, a CPU run takes an explicit `--device cpu`.

Several processes (one a card): start each under torchrun, or set
`LVR_DISTRIBUTED=1` with `LVR_COORDINATOR` (host:port),
`LVR_NUM_PROCESSES` and `LVR_PROCESS_ID`; the process group starts before
the command runs (NCCL, gloo under `--device cpu`). `train` then shards by
the config's `parallel` section; `eval`, `extract-features` and
`preprocess-map` each take every process_count-th document or image.
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
                   help="adapter name (llava | registered)")
    p.add_argument("--model-args", default="",
                   help="k=v,k=v kwargs for non-llava adapters")
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
                   help="adapter name (llava | hf-vision2seq | registered)")
    p.add_argument("--model-args", default="",
                   help="k=v,k=v kwargs for non-llava adapters")
    p.add_argument("--log-samples", action="store_true",
                   help="write per-doc records next to --output "
                        "(lmms-eval --log_samples)")
    _add_device(p)

    p = sub.add_parser("tasks", help="list bundled eval tasks")
    _add_device(p)

    p = sub.add_parser("merge-results",
                       help="merge per-process sample logs into one "
                            "aggregated result (multi-host eval gather)")
    p.add_argument("--task", required=True,
                   help="task yaml path or bundled task name")
    p.add_argument("--samples", nargs="+", required=True,
                   help="per-process *_samples.jsonl files")
    p.add_argument("--output", default="merged_results.json")
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

    p = sub.add_parser("preprocess-map",
                       help="GeoAware-SC SD+DINO feature pre-extraction "
                            "(C_score/preprocess_map.py)")
    p.add_argument("images", help="image dir or JSON list of paths")
    p.add_argument("out_dir")
    p.add_argument("--sd-bundle", required=True,
                   help="SD featurizer bundle with up blocks through 2 "
                        "(port-featurizer --up-ft-index 2)")
    p.add_argument("--dino-bundle", required=True,
                   help="ported DINOv2 params npz")
    p.add_argument("--dino-tower", default="facebook/dinov2-base-840")
    p.add_argument("--real-size", type=int, default=960)
    p.add_argument("--dino-size", type=int, default=840)
    p.add_argument("--layer", type=int, default=11)
    p.add_argument("--facet", default="token",
                   choices=["token", "key", "query", "value"])
    p.add_argument("--ensemble", type=int, default=1)
    p.add_argument("--stochastic", action="store_true",
                   help="sample VAE posterior + noise (reference behaviour);"
                        " default is the deterministic cache-stable path")
    p.add_argument("--no-flips", action="store_true")
    _add_device(p)

    p = sub.add_parser("sam-masks",
                       help="GeoAware foreground masks via box-prompted "
                            "SAM (preprocess_mask_sam.py equivalent)")
    p.add_argument("--snapshot", required=True,
                   help="local HF facebook/sam-vit-{base,large,huge} "
                        "snapshot dir")
    p.add_argument("--images", required=True,
                   help="JPEGImages root (ImageAnnotation sibling "
                        "holds the bbox jsons)")
    p.add_argument("--anno-size", type=int, default=960)
    p.add_argument("--spair", action="store_true",
                   help="annotations use SPair 'bndbox' corners")
    p.add_argument("--limit", type=int)
    _add_device(p)

    p = sub.add_parser("pose-awareness",
                       help="GeoAware-SC pose-awareness test "
                            "(C_score/pose_awareness_test.py)")
    p.add_argument("template_dir", help="12 sorted pose-template images")
    p.add_argument("target_dir")
    p.add_argument("labels", help="JSON {filename: b|f|l|r}")
    p.add_argument("feat_dir", help="preprocess-map output dir")
    p.add_argument("--mask-dir", help="per-image <stem>_mask.npy|png")
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--output")
    _add_device(p)

    p = sub.add_parser("c-train", help="supervised correspondence training")
    p.add_argument("--spair-dir", required=True)
    p.add_argument("--feature-dir", required=True)
    p.add_argument("--feature-dims", nargs="+", type=int, required=True)
    p.add_argument("--num-patches", type=int, required=True)
    p.add_argument("--anno-size", type=int, default=840)
    p.add_argument("--suffix", default="")
    p.add_argument("--categories", nargs="*")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out-dir", default="c_train_out")
    _add_device(p)

    p = sub.add_parser("apply-delta",
                       help="target = base + delta over .npz param files")
    p.add_argument("--base", required=True)
    p.add_argument("--delta", required=True)
    p.add_argument("--target", required=True)

    p = sub.add_parser("make-delta",
                       help="delta = target - base over .npz param files")
    p.add_argument("--base", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--delta", required=True)

    p = sub.add_parser("consolidate",
                       help="a train checkpoint (the port's or the JAX "
                            "runner's orbax one) -> flat .npz")
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint-N dir (or run dir; newest is used)")
    p.add_argument("--output", required=True)

    args = parser.parse_args(argv)
    import os
    # multi-process start (the JAX CLI's LVR_DISTRIBUTED block; torchrun
    # sets WORLD_SIZE): the process group before any device work
    if os.environ.get("LVR_DISTRIBUTED") or int(
            os.environ.get("WORLD_SIZE", "1")) > 1:
        from .parallel import init_distributed
        init_distributed(device=getattr(args, "device", "cuda"))
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
    """Serve the LLaVA of the RunConfig (or `--model`'s adapter) until
    interrupted."""
    from .serve import run_server
    device = _device(args)
    cfg = _run_config(args)
    if args.gen_backend:
        cfg.model.gen_backend = args.gen_backend
    srv = run_server(cfg, device=device, model=args.model,
                     model_args=_parse_model_args(args.model_args) or None,
                     host=args.host, port=args.port, max_batch=args.max_batch,
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


def _parse_model_args(spec: str) -> dict:
    """k=v,k=v adapter kwargs with bool/int/float coercion (lmms-eval's
    simple_parse_args_string semantics)."""
    margs = {}
    for kv in filter(None, spec.split(",")):
        if "=" not in kv:
            raise SystemExit(f"--model-args entry '{kv}' is not k=v")
        k, v = kv.split("=", 1)
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            for cast in (int, float):
                try:
                    v = cast(v)
                    break
                except ValueError:
                    pass
        margs[k] = v
    return margs


def _cmd_eval(args):
    """`lmms_eval --model X --model_args k=v --tasks ...`: results JSON to
    `--output` (and per-doc `*_samples.jsonl` with `--log-samples`), the
    task values to stdout."""
    import os

    from .eval.runner import run_evaluation
    from .parallel import world
    margs = _parse_model_args(args.model_args)
    rank, n_procs = world()
    res = run_evaluation(_run_config(args), args.tasks, device=_device(args),
                         limit=args.limit, model=args.model,
                         model_args=margs or None,
                         log_samples=args.log_samples, process_index=rank,
                         process_count=n_procs)
    if n_procs > 1:
        # one file a process: `merge-results` joins their sample logs
        base, ext = os.path.splitext(args.output)
        args.output = f"{base}_rank{rank}{ext}"
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


def _cmd_merge_results(args):
    """Host-side gather for doc-sharded multi-process eval: each process
    runs `eval --log-samples` over its shard; this re-aggregates the union
    of their sample logs (the reference gathers rank results with
    accelerate, `evaluator.py` tail). Overlapping doc ids are refused."""
    import os

    _device(args)
    from .eval.evaluator import aggregate_records
    from .eval.task import read_task_file
    from .eval.tasks import task_yaml
    path = args.task if os.path.exists(args.task) else task_yaml(args.task)
    cfg = read_task_file(path)
    recs = []
    for fp in args.samples:
        with open(fp) as f:
            recs.extend(json.loads(line) for line in f if line.strip())
    seen = set()
    for r in recs:
        did = r.get("doc_id")
        if did in seen:
            raise SystemExit(
                f"doc_id {did} appears in more than one shard — "
                "the per-process runs overlapped")
        seen.add(did)
    out = {cfg["task"]: aggregate_records(recs,
                                          cfg.get("aggregation", "mean"))}
    with open(args.output, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out, indent=1))
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
    from .parallel import world
    rank, n_procs = world()
    n = run_feature_extraction(_run_config(args), args.images, args.out_dir,
                               device=device, batch_size=args.batch_size,
                               suffix=args.suffix, process_index=rank,
                               process_count=n_procs)
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


def _cmd_preprocess_map(args):
    """The SD bundle and the DINOv2 params onto the device, then
    `preprocess_maps` over the images (recursively, for a directory). bf16
    compute (fp32 weights) on the card, the JAX command's default; fp32 on
    the CPU."""
    import dataclasses
    import glob
    import os

    from .core.precision import DEFAULT_PRECISION, FP32_PRECISION
    from .io import from_jax
    from .io.featurizer_bundle import load_featurizer_bundle
    from .io.param_io import load_params
    from .models.featurizer import FeaturizerParams
    from .models.vit import VIT_PRESETS, ViTEncoder
    from .pipeline.geoware import make_geoware_extractors, preprocess_maps
    device = _device(args)
    precision = DEFAULT_PRECISION if device.type == "cuda" else FP32_PRECISION
    sd_tree, sd_cfg = load_featurizer_bundle(args.sd_bundle)
    if sd_cfg is None:
        raise SystemExit("--sd-bundle has no featurizer config sidecar")
    sd_cfg = dataclasses.replace(sd_cfg, img_size=args.real_size)
    sd_params = FeaturizerParams.for_state_dict(
        from_jax.featurizer_state_dict(sd_tree), sd_cfg, precision,
        device=device)
    del sd_tree
    dino = ViTEncoder(VIT_PRESETS[args.dino_tower](), precision,
                      num_blocks=args.layer + 1, device=device)
    own = dino.state_dict()
    dino.load_state_dict({k[len("encoder."):]: v for k, v in
                          from_jax.vit_state_dict(load_params(
                              args.dino_bundle)).items()
                          if k[len("encoder."):] in own})
    sd_fn, dino_fn = make_geoware_extractors(
        sd_params, sd_cfg, dino.eval(), layer=args.layer, facet=args.facet,
        deterministic=not args.stochastic, ensemble=args.ensemble)
    if os.path.isdir(args.images):
        paths = sorted(p for ext in ("jpg", "jpeg", "png") for p in
                       glob.glob(f"{args.images}/**/*.{ext}",
                                 recursive=True))
    else:
        with open(args.images) as f:
            paths = json.load(f)
    from .parallel import world
    rank, n_procs = world()
    written = preprocess_maps(
        paths, args.out_dir, sd_fn, dino_fn, device=device,
        real_size=args.real_size, dino_size=args.dino_size,
        flips=not args.no_flips, process_index=rank, process_count=n_procs)
    print(f"wrote {len(written)} feature files -> {args.out_dir}")
    return 0


def _cmd_sam_masks(args):
    """`C_score/preprocess_mask_sam.py` over the port's SAM: the snapshot's
    config.json and weights ported on the host (`hf_port.port_sam`), then
    one box-prompted segmentation an image on the device."""
    import os

    from .io import from_jax
    from .io.hf_port import port_sam, sam_config_from_hf
    from .io.port_cli import load_torch_state_dict
    from .models.sam import SamModel
    from .pipeline.sam_masks import run_sam_masks
    device = _device(args)
    with open(os.path.join(args.snapshot, "config.json")) as f:
        cfg = sam_config_from_hf(json.load(f))
    tree = port_sam(load_torch_state_dict(args.snapshot), cfg)
    model = SamModel(cfg, device=device)
    model.load_state_dict(from_jax.sam_state_dict(tree))
    del tree
    n = run_sam_masks(model.eval(), args.images, anno_size=args.anno_size,
                      spair=args.spair, limit=args.limit)
    print(f"wrote masks for {n} images", file=sys.stderr)
    return 0


def _cmd_pose_awareness(args):
    from .pipeline.geoware import run_pose_awareness
    results = run_pose_awareness(
        args.template_dir, args.target_dir, args.labels, args.feat_dir,
        device=_device(args), mask_dir=args.mask_dir, res=args.res,
        out_path=args.output)
    print(json.dumps(results, indent=1))
    return 0


def _cmd_c_train(args):
    from .train.c_score_runner import run_c_training
    res = run_c_training(args.spair_dir, args.feature_dir,
                         feature_dims=args.feature_dims,
                         num_patches=args.num_patches, device=_device(args),
                         anno_size=args.anno_size, suffix=args.suffix,
                         categories=args.categories or None,
                         steps=args.steps, out_dir=args.out_dir)
    print(json.dumps({"best_pck": res["best_pck"],
                      "history": res["history"][-3:]}))
    return 0


def _cmd_apply_delta(args):
    from .io.delta import apply_delta
    n = apply_delta(args.base, args.delta, args.target)
    print(f"wrote {args.target} ({n} arrays)", file=sys.stderr)
    return 0


def _cmd_make_delta(args):
    from .io.delta import make_delta
    n = make_delta(args.base, args.target, args.delta)
    print(f"wrote {args.delta} ({n} arrays)", file=sys.stderr)
    return 0


def _cmd_consolidate(args):
    from .io.delta import consolidate
    n = consolidate(args.checkpoint, args.output)
    print(f"wrote {args.output} ({n} arrays)", file=sys.stderr)
    return 0


DISPATCH = {
    "train": _cmd_train,
    "generate": _cmd_generate,
    "serve": _cmd_serve,
    "eval": _cmd_eval,
    "tasks": _cmd_tasks,
    "merge-results": _cmd_merge_results,
    "extract-embeds": _cmd_extract_embeds,
    "extract-features": _cmd_extract_features,
    "a-score": _cmd_a_score,
    "c-score": _cmd_c_score,
    "policy": _cmd_policy,
    "make-config": _cmd_make_config,
    "port-featurizer": _cmd_port_featurizer,
    "preprocess-map": _cmd_preprocess_map,
    "sam-masks": _cmd_sam_masks,
    "pose-awareness": _cmd_pose_awareness,
    "c-train": _cmd_c_train,
    "apply-delta": _cmd_apply_delta,
    "make-delta": _cmd_make_delta,
    "consolidate": _cmd_consolidate,
}


if __name__ == "__main__":
    sys.exit(main())
