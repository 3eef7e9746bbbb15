#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one NVIDIA
GPU (H100).

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises and exits non-zero; no phase swallows an error):
  1. build the CUDA kernels from law_of_vision_representation_in_mllms_torch/
     csrc (set-up time, printed);
  2. each kernel against its plain PyTorch version on the card, in bf16, at
     the main paths' shapes, with the max abs error beside a stated
     tolerance, and both times: kernels 1-3 (serving) and the backward
     kernels 5 (dq) and 6 (dk/dv) at the training step's B=16, S=639,
     H=32, D=128, causal, plus a GQA and a ragged case;
  3. a narrow LLaVA (4-layer 336 px tower, head_dim 64, 3 decoder layers with
     GQA): the logits of the prefill and of 3 decode steps on CUDA with the
     kernels in bf16 against the same weights on the CPU with the plain path
     in fp32, and how far the two `generate_greedy` runs agree;
  3b. the same narrow LLaVA trained 3 stage-1 `make_train_step` steps on one
     batch: CUDA bf16 (flash route, kernels 2/5/6, block remat) against CPU
     fp32 plain from the same weights; loss and projector gradient per step
     within stated tolerances, and the loss falls on both sides;
  4. the serving slice at full width: LLaVA-1.5-7B (CLIP-L/14-336 +
     mlp2x_gelu + Vicuna-7B) with seeded random bf16 weights answers 4
     requests through `LlavaLMM.generate_until`; every serving kernel's
     launch counter must have gone up in that run; a second run must give
     identical tokens; tower images/s, prefill ms, decode tokens/s and peak
     memory are printed; the model is freed afterwards;
  5. the training slice at full width: `run_training(RunConfig)` trains
     LLaVA-1.5-7B stage 1 (fp32 weights, bf16 compute, block remat) for 4
     steps of 16 random 336 px PNGs with 20-40-word captions. Losses finite,
     no skipped step, the projector moved, the tower and decoder bitwise
     unchanged, `mm_projector.npz` loads back equal, kernels 1, 2, 5 and 6
     launched in the run; step time, tokens/s, TFLOP/s, peak memory and a
     torch.profiler split of one step are printed.

TF32 is switched off (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`) so every plain version runs in
full fp32. Every metric line carries the card's name and power limit.
The last lines are the kernels JSON, the card line from nvidia-smi and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "law_of_vision_representation_in_mllms_torch"
TPU_PKG = "law_of_vision_representation_in_mllms_tpu"

# bf16 kernel vs fp32 plain on N(0, 1) inputs: P is rounded to bf16 before
# P·V and both outputs are rounded to bf16 (one ulp is 2^-7 relative), so
# the error may reach ~2.5 ulps of the largest output: 2 % of max|plain|
# (at least 2e-2 absolute)
KERNEL_REL_TOL = 2e-2
LSE_TOL = 1e-2
# narrow LLaVA, CUDA bf16 weights/activations vs CPU fp32: relative to the
# largest reference logit (bf16 rounding of every activation, 3 layers)
LOGITS_REL_TOL = 5e-2
NARROW_STEPS = 4        # prefill + 3 decode steps
# narrow training, CUDA bf16 compute (fp32 weights) vs CPU fp32: the loss
# relative to the CPU loss, the projector gradient as ||got - ref|| / ||ref||
# (bf16 rounding of every activation and of P, dS in kernels 2/5/6)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_STEPS = 3
# full-width training: 64 records, 4 steps of 16; H100 SXM dense bf16 peak
FULL_RECORDS, FULL_BATCH = 64, 16
H100_BF16_TFLOPS = 989.0
WORDS = ("image shows a small red house near the river with two trees and a "
         "dog sitting on the grass while clouds move over the hills in the "
         "late afternoon light describe every object its color and where it "
         "is").split()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def kernel_tol(ref) -> float:
    return KERNEL_REL_TOL * max(1.0, ref.float().abs().max().item())


def check_kernels(tag: str, dev) -> dict:
    """Phase 2: kernels vs plain versions at the main path's shapes."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec, encoder_attention as enc,
        flash_attention as fl)

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    results = {}

    # tower: CLIP-L/14-336, B=4
    q, k, v = (randn(4, 577, 16, 64) for _ in range(3))
    ref = enc.encoder_attention_plain(q, k, v)
    results["encoder_attention"] = dict(
        err=max_err(enc.encoder_attention(q, k, v), ref),
        tol=kernel_tol(ref),
        ms=cuda_ms(lambda: enc.encoder_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: enc.encoder_attention_plain(q, k, v)),
        shape="B=4 S=577 H=16 D=64")

    # prefill: Vicuna-7B heads, S=640 with a kv_len tail; plus a GQA case
    errs, tols = [], []
    for kvh, kv_len in ((32, 600), (8, 640)):
        q = randn(4, 640, 32, 128)
        k, v = randn(4, 640, kvh, 128), randn(4, 640, kvh, 128)
        out, lse = fl.flash_attention(q, k, v, causal=True, kv_len=kv_len,
                                      return_lse=True)
        ref, ref_lse = fl.flash_attention_plain(q, k, v, causal=True,
                                                kv_len=kv_len,
                                                return_lse=True)
        e_lse = max_err(lse, ref_lse)
        if e_lse > LSE_TOL:
            fail(f"flash_attention LSE err {e_lse} > {LSE_TOL} (KV={kvh})")
        errs.append(max_err(out, ref))
        tols.append(kernel_tol(ref))
        if kvh == 32:
            ms = cuda_ms(lambda: fl.flash_attention(q, k, v, causal=True,
                                                    kv_len=kv_len))
            plain_ms = cuda_ms(lambda: fl.flash_attention_plain(
                q, k, v, causal=True, kv_len=kv_len))
    results["flash_attention"] = dict(
        err=max(errs), tol=min(tols), ms=ms, plain_ms=plain_ms,
        shape="B=4 S=640 kv_len=600 H=KV=32 D=128 causal (+ GQA KV=8)")

    # decode: Vicuna-7B cache, T=704, holes + one fully masked 128-slot tile
    t = 704
    q = randn(4, 1, 32, 128)
    k, v = randn(4, t, 32, 128), randn(4, t, 32, 128)
    mask = torch.rand(4, t, generator=g, device=dev) < 0.8
    mask[:, 256:384] = False
    mask[:, 0] = True
    ref = dec.decode_attention_plain(q, k, v, mask)
    results["decode_attention"] = dict(
        err=max_err(dec.decode_attention(q, k, v, mask), ref),
        tol=kernel_tol(ref),
        ms=cuda_ms(lambda: dec.decode_attention(q, k, v, mask)),
        plain_ms=cuda_ms(lambda: dec.decode_attention_plain(q, k, v, mask)),
        shape="B=4 T=704 H=KV=32 Dh=128, holes + masked 128-slot tile")

    for name, r in results.items():
        print(f"{tag} kernel {name} [{r['shape']}]: max_abs_err "
              f"{r['err']:.3e} (tol {r['tol']:.3e}), kernel {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms")
        if not r["err"] <= r["tol"]:
            fail(f"{name} disagrees with its plain version: {r['err']}")
    return results


def check_flash_bwd(tag: str, dev) -> dict:
    """Phase 2, training kernels: 5 (dq) and 6 (dk/dv) against the plain
    backward on the same bf16 inputs and saved output/LSE (kernel 2's), at
    the training step's shape, a GQA case and a ragged S."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)

    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    errs = {"flash_attention_bwd_dq": [], "flash_attention_bwd_dkv": []}
    times = {}
    for b, s, kvh, timed in ((16, 639, 32, True), (16, 639, 8, True),
                             (16, 100, 32, False)):
        q, do = randn(b, s, 32, 128), randn(b, s, 32, 128)
        k, v = randn(b, s, kvh, 128), randn(b, s, kvh, 128)
        out, lse = fl.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        args = (q, k, v, out, lse, do, delta)
        dq = fl.flash_attention_bwd_dq(*args, causal=True)
        dk, dv = fl.flash_attention_bwd_dkv(*args, causal=True)
        rq, rk, rv = fl.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                  causal=True)
        case = f"B={b} S={s} H=32 KV={kvh} D=128 causal"
        e = {name: (max_err(got, ref), kernel_tol(ref))
             for name, got, ref in (("dq", dq, rq), ("dk", dk, rk),
                                    ("dv", dv, rv))}
        print(f"{tag} kernels 5/6 [{case}]: " + ", ".join(
            f"{n} max_abs_err {err:.3e} (tol {tol:.3e}, max|plain| "
            f"{tol / KERNEL_REL_TOL:.3e})" for n, (err, tol) in e.items()))
        for n, (err, tol) in e.items():
            if not err <= tol:
                fail(f"kernel {'5' if n == 'dq' else '6'} {n} disagrees with "
                     f"the plain backward at {case}: {err} > {tol}")
        errs["flash_attention_bwd_dq"].append(e["dq"])
        errs["flash_attention_bwd_dkv"] += [e["dk"], e["dv"]]
        if timed:
            t = dict(
                dq=cuda_ms(lambda: fl.flash_attention_bwd_dq(*args,
                                                             causal=True)),
                dkv=cuda_ms(lambda: fl.flash_attention_bwd_dkv(*args,
                                                               causal=True)),
                plain=cuda_ms(lambda: fl.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, causal=True), iters=5),
                fwd=cuda_ms(lambda: fl.flash_attention(q, k, v,
                                                       causal=True)))
            print(f"{tag} kernels 5/6 [{case}]: kernel 5 {t['dq']:.4f} ms, "
                  f"kernel 6 {t['dkv']:.4f} ms, plain backward (dq, dk, dv "
                  f"together) {t['plain']:.4f} ms; kernel 2 forward "
                  f"{t['fwd']:.4f} ms")
            times.setdefault("t", t)          # the MHA case is reported
        del q, k, v, do, out, lse, delta, dq, dk, dv, rq, rk, rv
    shape = "B=16 S=639 H=KV=32 D=128 causal (+ GQA KV=8, ragged S=100)"
    t = times["t"]
    return {name: dict(err=max(e for e, _ in errs[name]),
                       tol=min(tol for _, tol in errs[name]),
                       ms=t["dq" if name.endswith("dq") else "dkv"],
                       plain_ms=t["plain"], shape=shape)
            for name in errs}


def narrow_config():
    """The narrow LLaVA of phases 3 and 3b: a 4-layer 336 px tower
    (head_dim 64) and 3 decoder layers with GQA (head_dim 64)."""
    from law_of_vision_representation_in_mllms_torch.models import llama as L
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        TowerEntry, TowerSpec)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTConfig)

    vit = ViTConfig(image_size=336, patch_size=14, hidden_size=256,
                    num_layers=4, num_heads=4, intermediate_size=1024)
    entry = TowerEntry(name="narrow-clip-336", kind="vit", vit_config=vit,
                       vit_family="clip", hidden_size=256,
                       num_patches=vit.num_patches, img_size=336)
    return M.LlavaConfig(
        tower_spec=TowerSpec(entries=[entry], join="single"),
        decoder=L.LlamaConfig(vocab_size=1000, hidden_size=256,
                              intermediate_size=688, num_layers=3,
                              num_heads=4, num_kv_heads=2))


def check_narrow_llava(tag: str, dev) -> None:
    """Phase 3: narrow LLaVA, CUDA kernels in bf16 vs CPU plain fp32."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IMAGE_TOKEN_INDEX)

    cfg = narrow_config()
    cpu = M.init_params(torch.Generator().manual_seed(0), cfg,
                        FP32_PRECISION, "cpu")
    gpu = M.LlavaParams(cfg, BF16_PRECISION, device=dev)
    gpu.load_state_dict(cpu.state_dict())

    rng = np.random.RandomState(0)
    ids = rng.randint(3, 1000, size=(2, 24)).astype(np.int64)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    mask = np.ones((2, 24), bool)
    mask[1, 16:] = False
    px = rng.randn(2, 336, 336, 3).astype(np.float32)

    def inputs(device):
        return (torch.from_numpy(ids).to(device),
                torch.from_numpy(mask).to(device),
                [torch.from_numpy(px).to(device)])

    # prefill (kernels 1, 2) and decode steps (kernel 3), both sides fed the
    # CPU run's greedy tokens so every step compares the same context
    pre_ref = M.prefill(cpu, cfg, *inputs("cpu"), max_new_tokens=NARROW_STEPS)
    pre_got = M.prefill(gpu, cfg, *inputs(dev), max_new_tokens=NARROW_STEPS)
    ref_steps, got_steps = [pre_ref.logits], [pre_got.logits.float().cpu()]
    for t in range(NARROW_STEPS - 1):
        tok = ref_steps[-1].argmax(-1)
        ref_steps.append(M.decode_step(cpu, pre_ref, tok, t))
        got_steps.append(M.decode_step(gpu, pre_got, tok.to(dev), t)
                         .float().cpu())
    ref, got = torch.stack(ref_steps), torch.stack(got_steps)
    err = max_err(got, ref)
    tol = LOGITS_REL_TOL * ref.abs().max().item()
    greedy_ref = M.generate_greedy(cpu, cfg, *inputs("cpu"),
                                   max_new_tokens=NARROW_STEPS, eos_id=-1)
    greedy_got = M.generate_greedy(gpu, cfg, *inputs(dev),
                                   max_new_tokens=NARROW_STEPS, eos_id=-1)
    agree = (greedy_got.cpu() == greedy_ref).float().mean().item()
    first = (got[0].argmax(-1) == ref[0].argmax(-1)).tolist()
    print(f"{tag} narrow LLaVA logits, prefill + {NARROW_STEPS - 1} decode "
          f"steps (CUDA bf16 kernels vs CPU fp32 plain): max_abs_err "
          f"{err:.4e} (tol {tol:.4e} = {LOGITS_REL_TOL} x max|logit|); "
          f"first-step argmax agree {first}; generate_greedy tokens agree "
          f"{agree:.3f}")
    if not (torch.isfinite(got).all() and err <= tol):
        fail(f"narrow LLaVA logits disagree: {err} > {tol}")


def check_narrow_training(tag: str, dev) -> None:
    """Phase 3b: 3 stage-1 `make_train_step` steps on one batch of the
    narrow LLaVA, CUDA bf16 compute (fp32 weights; flash route with kernels
    2, 5 and 6 under block remat) against CPU fp32 plain attention, from the
    same weights. Per step: the loss and the projector gradient."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IGNORE_INDEX, IMAGE_TOKEN_INDEX)
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)
    from law_of_vision_representation_in_mllms_torch.train import (
        train_step as TS)

    cfg = narrow_config()
    cpu = M.init_params(torch.Generator().manual_seed(1), cfg,
                        FP32_PRECISION, "cpu")
    gpu = M.LlavaParams(cfg, DEFAULT_PRECISION, device=dev)
    gpu.load_state_dict(cpu.state_dict())

    rng = np.random.RandomState(1)
    b, n = 4, 40
    ids = rng.randint(3, 1000, size=(b, n)).astype(np.int64)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    labels = ids.copy()
    labels[:, :2] = IGNORE_INDEX
    mask = np.ones((b, n), bool)
    for r in range(1, b):                          # right-padded rows
        mask[r, n - 6 * r:] = False
        labels[r, n - 6 * r:] = IGNORE_INDEX
    px = rng.randn(b, 336, 336, 3).astype(np.float32)

    def batch(device):
        return {"input_ids": torch.from_numpy(ids).to(device),
                "labels": torch.from_numpy(labels).to(device),
                "text_mask": torch.from_numpy(mask).to(device),
                "pixel_values": [torch.from_numpy(px).to(device)]}

    tc_ref = TS.TrainConfig(stage=1, learning_rate=1e-2, warmup_ratio=0.0,
                            total_steps=TRAIN_STEPS)
    tc_got = dataclasses.replace(tc_ref, use_flash=True, remat=True)
    sides = []
    for params, tc, device in ((cpu, tc_ref, "cpu"), (gpu, tc_got, dev)):
        state, opt = TS.init_train_state(params, tc)
        sides.append((params, tc, batch(device), state,
                      TS.make_train_step(cfg, tc, opt)))

    def projector_grad(params, tc, bt):
        loss = M.loss_fn(params, cfg, bt, use_flash=tc.use_flash,
                         remat=tc.remat)
        grads = torch.autograd.grad(loss, list(params.projector.parameters()))
        return torch.cat([g.float().flatten().cpu() for g in grads])

    losses = ([], [])
    bwd = (fl.flash_attention_bwd_dq, fl.flash_attention_bwd_dkv)
    before = [c.launches for c in bwd]
    for step in range(TRAIN_STEPS):
        g_ref, g_got = (projector_grad(p, tc, bt)
                        for p, tc, bt, _, _ in sides)
        rel = ((g_got - g_ref).norm() / g_ref.norm()).item()
        for i, (_, _, bt, state, step_fn) in enumerate(sides):
            _, m = step_fn(state, bt)
            losses[i].append(float(m["loss"]))
            if float(m["skipped_nonfinite"]) != 0.0:
                fail(f"narrow training step {step + 1} was skipped")
        ref, got = losses[0][-1], losses[1][-1]
        loss_rel = abs(got - ref) / abs(ref)
        print(f"{tag} narrow training step {step + 1} (CUDA bf16 kernels vs "
              f"CPU fp32 plain): loss {got:.6f} vs {ref:.6f}, rel err "
              f"{loss_rel:.3e} (tol {TRAIN_LOSS_REL_TOL}); projector grad "
              f"rel err {rel:.3e} (tol {TRAIN_GRAD_REL_TOL})")
        if not (np.isfinite(got) and loss_rel <= TRAIN_LOSS_REL_TOL):
            fail(f"narrow training loss disagrees at step {step + 1}")
        if not rel <= TRAIN_GRAD_REL_TOL:
            fail(f"narrow projector gradient disagrees at step {step + 1}")
    if [c.launches for c in bwd] == before:
        fail("narrow training on CUDA launched no backward kernel")
    for side, ls in zip(("CPU", "CUDA"), losses):
        if not ls[-1] < ls[0]:
            fail(f"narrow training loss did not fall on the {side}: {ls}")


def _requests(n: int, crop: int):
    import numpy as np
    from law_of_vision_representation_in_mllms_torch.data.image_processing \
        import CLIP_MEAN, CLIP_STD
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(n):
        img = rng.rand(crop, crop, 3).astype(np.float32)
        img = (img - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(
            CLIP_STD, np.float32)
        prompt = " ".join(rng.choice(WORDS, size=30 + 4 * i))
        reqs.append(Instance("generate_until", {}, i, "smoke",
                             (prompt, {"max_new_tokens": 32}), [img]))
    return reqs


def run_full_width(tag: str, dev, counters) -> dict:
    """Phase 4: LLaVA-1.5-7B at full width through the adapter."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    from law_of_vision_representation_in_mllms_torch.models import llava as M

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lmm = build_lmm(RunConfig(), device=dev)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in lmm.params.parameters())
    print(f"{tag} LLaVA-1.5-7B ({n_params / 1e9:.3f} B params, bf16, seeded "
          f"random) built on the card in {time.perf_counter() - t0:.2f} s")
    reqs = _requests(4, lmm.processors[0].crop)
    dec = lmm.cfg.decoder

    # the main path, counted
    for c in counters.values():
        c.launches = 0
    texts = lmm.generate_until(reqs)
    torch.cuda.synchronize(dev)
    launches = {name: c.launches for name, c in counters.items()}
    steps = launches["decode_attention"] // dec.num_layers
    print(f"{tag} main path launches {launches} ({steps} decode steps)")
    if launches["encoder_attention"] < 23:
        fail("encoder_attention ran fewer than 23 times in one tower call")
    if launches["flash_attention"] < dec.num_layers:
        fail("flash_attention ran fewer than 32 times in the prefill")
    if (launches["decode_attention"] < dec.num_layers
            or launches["decode_attention"] % dec.num_layers):
        fail("decode_attention did not run 32 times per decode step")

    # token ids: in range, deterministic, consistent with the adapter's text
    ids, mask, pixels = lmm._encode_batch(reqs)

    def generate():
        return M.generate_greedy(lmm.params, lmm.cfg, ids, mask, pixels,
                                 max_new_tokens=32,
                                 eos_id=lmm.tok.eos_token_id)
    toks = generate()
    again = generate()
    torch.cuda.synchronize(dev)
    if not ((toks >= 0) & (toks < dec.vocab_size)).all():
        fail("generated token id out of range")
    if not torch.equal(toks, again):
        fail("a second run gave different tokens")
    eos = lmm.tok.eos_token_id
    for row, text in zip(toks.tolist(), texts):
        row = row[:row.index(eos)] if eos in row else row
        if lmm.tok.decode(row).strip() != text:
            fail("generate_until text differs from the decoded tokens")

    # phase timings (host clock around synchronised work)
    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t) / reps

    with torch.inference_mode():
        tower_s = timed(lambda: lmm.params.towers[0](pixels[0]))
    prefill_s = timed(lambda: M.prefill(lmm.params, lmm.cfg, ids, mask,
                                        pixels, max_new_tokens=32))
    counters["decode_attention"].launches = 0
    gen_s = timed(generate)                       # 1 warm-up + 3 timed runs
    gen_steps = counters["decode_attention"].launches // dec.num_layers // 4
    if gen_steps == 0:
        fail("the timed generate ran no decode step")
    b = ids.shape[0]
    decode_tok_s = b * gen_steps / (gen_s - prefill_s)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    seq = ids.shape[1] + lmm.cfg.num_patches - 1
    print(f"{tag} tower (CLIP-L/14-336, B={b}): {b / tower_s:.1f} images/s "
          f"({tower_s * 1e3:.2f} ms)")
    print(f"{tag} prefill (tower + projector + splice + 32-layer prefill, "
          f"B={b}, S={seq}): {prefill_s * 1e3:.2f} ms")
    print(f"{tag} decode (B={b}, {gen_steps} steps, (generate - prefill) "
          f"time): {decode_tok_s:.1f} tokens/s "
          f"({(gen_s - prefill_s) / gen_steps * 1e3:.2f} ms/step)")
    print(f"{tag} peak memory allocated: {peak_gb:.2f} GB")
    print(f"{tag} sample answer: {texts[0][:80]!r}")
    return launches


def _training_records(folder: str) -> str:
    """FULL_RECORDS `plain`-template records, each a random 336x336 PNG
    (written with PIL) and a 20-40-word caption. Returns the JSON path."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(0)
    recs = []
    for i in range(FULL_RECORDS):
        Image.fromarray(rng.randint(0, 256, (336, 336, 3), dtype=np.uint8)
                        ).save(os.path.join(folder, f"img{i}.png"))
        caption = " ".join(rng.choice(WORDS, size=rng.randint(20, 41)))
        recs.append({"id": i, "image": f"img{i}.png", "conversations": [
            {"from": "human", "value": "<image>\nDescribe the image."},
            {"from": "gpt", "value": caption}]})
    path = os.path.join(folder, "data.json")
    with open(path, "w") as f:
        json.dump(recs, f)
    return path


def train_step_flops(cfg, b: int, s: int) -> float:
    """Tensor-core FLOPs of one stage-1 step with block remat: the decoder's
    matmuls run forward, again in the recompute and once more for the
    activation gradients (no frozen-weight gradients); its attention runs
    forward twice and backward (~2.5x forward); lm_head forward and input
    gradient; the tower forward (23 of 24 CLIP-L layers)."""
    dec = cfg.decoder
    d, i, hd = dec.hidden_size, dec.intermediate_size, dec.head_dim
    per_layer = (2 * d * dec.num_heads * hd + 2 * d * dec.num_kv_heads * hd
                 + 3 * d * i)
    tokens = b * s
    matmul = 2 * per_layer * dec.num_layers * tokens
    attn = dec.num_layers * 2 * 2 * b * s * s * hd * dec.num_heads / 2
    head = 2 * d * dec.vocab_size * tokens
    vit = cfg.tower_spec.entries[0].vit_config
    vd, vi, vt = vit.hidden_size, vit.intermediate_size, vit.num_patches + 1
    tower = 2 * (4 * vd * vd + 2 * vd * vi) * vt * b * (vit.num_layers - 1)
    return 3 * matmul + 4.5 * attn + 2 * head + tower


def profile_step(tag: str, run, batch) -> None:
    """torch.profiler over one warm training step: device time by kernel
    family and the device's idle share of the step's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run.step_fn(run.state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, m = run.step_fn(run.state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    families = {"matmul (cuBLAS)": 0.0, "kernel 1 (tower attention)": 0.0,
                "kernel 2 (flash forward)": 0.0, "kernel 5 (dq)": 0.0,
                "kernel 6 (dk/dv)": 0.0, "copies and memsets": 0.0,
                "elementwise, reductions, optimizer": 0.0}
    names, launched = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name, us = e.name, e.time_range.elapsed_us()
        low = name.lower()
        if "flash_bwd_dq_kernel" in name:
            fam = "kernel 5 (dq)"
        elif "flash_bwd_dkv_kernel" in name:
            fam = "kernel 6 (dk/dv)"
        elif "flash_fwd_kernel<64" in name:
            fam = "kernel 1 (tower attention)"
        elif "flash_fwd_kernel" in name:
            fam = "kernel 2 (flash forward)"
        elif any(x in low for x in ("gemm", "gemv", "cutlass", "xmma",
                                    "nvjet", "cublas")):
            fam = "matmul (cuBLAS)"
        elif "memcpy" in low or "memset" in low:
            fam = "copies and memsets"
        else:
            fam = "elementwise, reductions, optimizer"
        families[fam] += us / 1e3
        by_name = names.setdefault(fam, {})
        by_name[name] = by_name.get(name, 0.0) + us / 1e3
        launched += 1
    busy = sum(families.values())
    if busy == 0.0:
        print(f"{tag} profiler: no device time recorded; split not measured")
        return
    print(f"{tag} profiled step: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}, "
          f"{launched} device activities")
    for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
        print(f"{tag}   {fam}: {ms:.1f} ms ({ms / busy:.1%} of device time)")
        top = sorted(names.get(fam, {}).items(), key=lambda kv: -kv[1])[:4]
        for name, t in top:
            print(f"{tag}     {t:8.1f} ms  {name[:110]}")


def run_full_width_training(tag: str, dev, counters) -> dict:
    """Phase 5: stage-1 training of LLaVA-1.5-7B through `run_training`."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION)
    from law_of_vision_representation_in_mllms_torch.data import (
        collate_batch)
    from law_of_vision_representation_in_mllms_torch.io.checkpoint import (
        load_projector)
    from law_of_vision_representation_in_mllms_torch.train import runner

    with tempfile.TemporaryDirectory(prefix="lvr_smoke_train_") as tmp:
        out_dir = os.path.join(tmp, "out")
        cfg = RunConfig.from_dict({
            "train": {"stage": 1, "batch_size": FULL_BATCH, "epochs": 1,
                      "gradient_checkpointing": True, "learning_rate": 1e-3,
                      "save_steps": 1000, "output_dir": out_dir},
            "data": {"data_path": _training_records(tmp),
                     "image_folder": tmp}})
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        run = runner.run_training(cfg, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = {name: c.launches for name, c in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        with open(os.path.join(out_dir, "train.jsonl")) as f:
            logs = [json.loads(line) for line in f if line.strip()]
        saved = load_projector(out_dir)

        params = run.state["params"]
        n_steps = len(logs)
        n_params = sum(p.numel() for p in params.parameters())
        print(f"{tag} run_training: LLaVA-1.5-7B stage 1 ({n_params / 1e9:.3f}"
              f" B params, fp32 weights, bf16 compute, block remat, flash "
              f"route {run.train_cfg.use_flash}), {n_steps} steps of "
              f"{FULL_BATCH}, {wall:.1f} s in all (model build and data "
              f"included)")
        print(f"{tag} training launches {launches}")
        print(f"{tag} losses " + " ".join(f"{r['loss']:.5f}" for r in logs)
              + "; grad norms " + " ".join(f"{r['grad_norm']:.4g}"
                                           for r in logs))
        if n_steps != FULL_RECORDS // FULL_BATCH:
            fail(f"run_training took {n_steps} steps, not "
                 f"{FULL_RECORDS // FULL_BATCH}")
        if not all(np.isfinite(r["loss"]) for r in logs):
            fail("a training loss is not finite")
        if any(r["skipped_nonfinite"] != 0.0 for r in logs):
            fail("a training step was skipped as nonfinite")
        seqs = {int(r["tokens"]) // FULL_BATCH for r in logs}
        if run.train_cfg.use_flash is not True:
            fail("run_training did not take the flash route on the card")
        per_step = {"encoder_attention": 23, "flash_attention": 64,
                    "flash_attention_bwd_dq": 32,
                    "flash_attention_bwd_dkv": 32}
        for name, n in per_step.items():
            if launches[name] < n * n_steps:
                fail(f"{name} launched {launches[name]} times in "
                     f"{n_steps} steps, fewer than {n} per step")

        # the stage-1 artifact loads back equal to the trained projector
        for name, p in params.projector.state_dict().items():
            if not torch.equal(saved[name], p.cpu()):
                fail(f"mm_projector.npz {name} differs from the trained "
                     f"projector")

        # the same seed rebuilds the initial weights: the projector moved,
        # every tower and decoder weight is bitwise what it was
        _, fresh = runner.build_model(cfg, device=dev,
                                      precision=DEFAULT_PRECISION)
        trained = dict(params.named_parameters())
        moved = False
        for name, p in fresh.named_parameters():
            same = torch.equal(p, trained[name])
            if name.startswith("projector."):
                moved |= not same
            elif not same:
                fail(f"frozen weight {name} changed in stage-1 training")
        if not moved:
            fail("the projector did not move in 4 steps")
        del fresh, trained
        gc.collect()
        torch.cuda.empty_cache()

        step_s = float(np.median([r["step_seconds"] for r in logs[1:]]))
        seq = max(seqs)
        flops = train_step_flops(run.model_cfg, FULL_BATCH, seq)
        print(f"{tag} training step (B={FULL_BATCH}, S={seq} spliced, "
              f"sequence lengths {sorted(seqs)}): median of steps 2-"
              f"{n_steps} {step_s * 1e3:.1f} ms (steps "
              + " ".join(f"{r['step_seconds'] * 1e3:.1f}" for r in logs)
              + f" ms); {FULL_BATCH * seq / step_s:.0f} tokens/s; "
              f"{flops / 1e12:.1f} TFLOP/step estimated from shapes -> "
              f"{flops / step_s / 1e12:.1f} TFLOP/s "
              f"({flops / step_s / 1e12 / H100_BF16_TFLOPS:.1%} of the "
              f"{H100_BF16_TFLOPS:.0f} TFLOP/s dense bf16 peak)")
        print(f"{tag} training peak memory allocated: {peak_gb:.2f} GB")

        # the optimizer alone, on gradients of the trained shapes
        opt = run.opt
        zeros = [torch.zeros_like(p) for _, p in opt.named_params]
        ok = torch.ones((), dtype=torch.bool, device=dev)
        norm = torch.zeros((), device=dev)
        opt_ms = cuda_ms(lambda: opt.step(zeros, ok, norm), iters=5,
                         warmup=1)
        n_train = sum(p.numel() for _, p in opt.named_params)
        print(f"{tag} FusedAdamW step over {n_train / 1e6:.1f} M trainable "
              f"params: {opt_ms:.3f} ms")

        batch = runner.batch_to_device(collate_batch(
            [run.dataset[i] for i in range(FULL_BATCH)],
            max_length=cfg.train.max_length), dev)
        profile_step(tag, run, batch)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        from law_of_vision_representation_in_mllms_torch.ops import (
            _build, decode_attention as dec, encoder_attention as enc,
            flash_attention as fl)
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    print(f"{tag} torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off (matmul and cudnn)")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"{tag} kernels built from {_build.CSRC_DIR.relative_to(REPO)} "
          f"in {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(lib_path, REPO)}")

    kernels = check_kernels(tag, dev)
    kernels.update(check_flash_bwd(tag, dev))
    check_narrow_llava(tag, dev)
    check_narrow_training(tag, dev)
    counters = {"encoder_attention": enc.encoder_attention,
                "flash_attention": fl.flash_attention,
                "decode_attention": dec.decode_attention,
                "flash_attention_bwd_dq": fl.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fl.flash_attention_bwd_dkv}
    serve = run_full_width(tag, dev, counters)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} after the serving phase: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated")
    train = run_full_width_training(tag, dev, counters)
    launches = {name: serve[name] + train[name] for name in counters}

    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "flax", "optax", "orbax", TPU_PKG)]
    if leaked:
        fail(f"JAX-side modules were imported: {leaked[:5]}")

    replaces = {
        "encoder_attention": f"{TPU_PKG}/ops/encoder_attention.py:78",
        "flash_attention": f"{TPU_PKG}/ops/flash_attention.py:377",
        "decode_attention": f"{TPU_PKG}/ops/decode_attention.py:341",
        "flash_attention_bwd_dq": f"{TPU_PKG}/ops/flash_attention.py:473",
        "flash_attention_bwd_dkv": f"{TPU_PKG}/ops/flash_attention.py:508",
    }
    sources = {name: f"{PKG}/csrc/{name}.cu" for name in replaces}
    sources["flash_attention_bwd_dq"] = f"{PKG}/csrc/flash_attention_bwd.cu"
    sources["flash_attention_bwd_dkv"] = f"{PKG}/csrc/flash_attention_bwd.cu"
    # launches: the serving run (phase 4) plus the training run (phase 5),
    # each counted from 0; the split is in "launches_by_path"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "launches": launches[name],
         "launches_by_path": {"serve": serve[name], "train": train[name]},
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
