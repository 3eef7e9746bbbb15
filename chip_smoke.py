#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training and law-chain paths on
one NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises and exits non-zero; no phase swallows an error):
  1. build the CUDA kernels from law_of_vision_representation_in_mllms_torch/
     csrc (set-up time, printed);
  2. each kernel against its plain PyTorch version on the card, in bf16, at
     the main paths' shapes, with the max abs error beside a stated
     tolerance, and both times: kernels 1-3 (serving) and the backward
     kernels 5 (dq) and 6 (dk/dv) at the training step's B=16, S=639,
     H=32, D=128, causal, plus a GQA and a ragged case; kernel 9 (masked
     max-cosine, fp32) at the A-score protocol shape N=100, St=576, Sa=576
     and 256, D=4096, a ragged masked case, a bf16 case and a self-anchor
     check; the tower routes `flash` (kernel 2 non-causal) and `encoder2`
     (kernel 1), also at the one-image shapes of the embedding dumps
     (S=577, and S=257 for CLIP@224). Beside each kernel: the least time the card could take
     (`bound_ms`, from the bytes and operations of this run's inputs) and
     the time of the one PyTorch call that computes the same function
     (`scaled_dot_product_attention`), a yardstick the port never calls;
  3. a narrow LLaVA (4-layer 336 px tower, head_dim 64, 3 decoder layers with
     GQA): the logits of the prefill and of 3 decode steps on CUDA with the
     kernels in bf16 against the same weights on the CPU with the plain path
     in fp32, and how far the two `generate_greedy` runs agree;
  3b. the same narrow LLaVA trained 3 stage-1 `make_train_step` steps on one
     batch: CUDA bf16 (flash route, kernels 2/5/6, block remat) against CPU
     fp32 plain from the same weights; loss and projector gradient per step
     within stated tolerances, and the loss falls on both sides;
  3c. `LlavaLMM.loglikelihood` of the narrow LLaVA, 8 requests of mixed
     lengths: CUDA bf16 with the kernels against CPU fp32 plain;
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
     torch.profiler split of one step are printed;
  6. the law chain at full width: an MME-style yes/no task and a
     multiple-choice task over 100 random 336 px PNGs (in a temporary
     directory, ~2.4 GB, removed afterwards); for CLIP@336, CLIP@224 and a
     DINOv2-L@336 target, each a LLaVA-1.5-7B of its own seed:
     `run_embed_extraction` (100 images), for the target also
     `run_evaluation` over both tasks (`generate_until` and
     `loglikelihood` at 7B width); then `compute_a_scores` on the card
     (kernel 9, two launches a rep) and one `fit_policy`.

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
H100_FP32_TFLOPS = 67.0         # plain fp32 FMAs, outside the tensor cores
H100_HBM_BYTES_S = 3.35e12
# kernel 9: fp32 inputs, fp32 sums over D in another order than the plain
# version's matmul; cosines lie in [-1, 1]. bf16 inputs are converted to
# fp32 exactly on both sides, so the same bound holds.
A_SCORE_TOL = 1e-5
# narrow loglikelihood, CUDA bf16 vs CPU fp32: summed log-prob relative to
# the size of the CPU sum (at least log(V) a token). The lm_head is widened
# there so that logits reach ~+-20; one bf16 ulp of such a logit is 2^-7
# relative, ~0.5 % of a token's log-prob
LL_REL_TOL = 2e-2
LL_MIN_FLAGS = 2                # greedy flags that must have been compared
LAW_IMAGES = 100                # the A-score protocol's image count
LAW_HIDDEN = 4096               # the LLM width the embeddings live in
LAW_EVAL_LIMIT = 8
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


def graph_ms(fn, launches: int = 50, replays: int = 10) -> float:
    """Mean device time of one `fn()` with `launches` of them captured in a
    CUDA graph: a 30 us kernel launched back to back through ctypes would
    otherwise be timed at the host's launch rate, not the card's."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def bound(nbytes: float, flops: float, peak_tflops: float) -> dict:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate of their type."""
    by_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    by_ops = flops / (peak_tflops * 1e12) * 1e3
    return dict(bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations")


def sdpa(q, k, v, **kw):
    """The library yardstick: PyTorch's fused attention on [B, S, H, D]
    tensors. Timed beside the kernels, called on no path of the port."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def kernel_tol(ref) -> float:
    return KERNEL_REL_TOL * max(1.0, ref.float().abs().max().item())


def check_kernels(tag: str, dev) -> dict:
    """Phase 2: kernels vs plain versions at the main path's shapes. The
    kernels and their library yardsticks are timed under a CUDA graph."""
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
    b, s, h, d = 4, 577, 16, 64
    q, k, v = (randn(b, s, h, d) for _ in range(3))
    ref = enc.encoder_attention_plain(q, k, v)
    lib_err = max_err(sdpa(q, k, v), ref)
    results["encoder_attention"] = dict(
        err=max_err(enc.encoder_attention(q, k, v), ref),
        tol=kernel_tol(ref),
        ms=graph_ms(lambda: enc.encoder_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: enc.encoder_attention_plain(q, k, v)),
        library_ms=graph_ms(lambda: sdpa(q, k, v)), library_err=lib_err,
        shape=f"B={b} S={s} H={h} D={d}",
        **bound(4 * q.numel() * 2, 4 * b * h * s * s * d, H100_BF16_TFLOPS))

    # prefill: Vicuna-7B heads, S=640 with a kv_len tail; plus a GQA case
    errs, tols = [], []
    b, s, h, d = 4, 640, 32, 128
    for kvh, kv_len in ((32, 600), (8, 640)):
        q = randn(b, s, h, d)
        k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
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
            ms = graph_ms(lambda: fl.flash_attention(q, k, v, causal=True,
                                                     kv_len=kv_len))
            plain_ms = cuda_ms(lambda: fl.flash_attention_plain(
                q, k, v, causal=True, kv_len=kv_len))
            # the same function from the library: causal over the first
            # kv_len keys (a [S, kv_len] causal mask is top-left aligned)
            kc, vc = k[:, :kv_len], v[:, :kv_len]
            lib_err = max_err(sdpa(q, kc, vc, is_causal=True), ref)
            library_ms = graph_ms(lambda: sdpa(q, kc, vc, is_causal=True))
            pairs = kv_len * (kv_len + 1) // 2 + (s - kv_len) * kv_len
            bnd = bound(2 * q.numel() * 2 + 2 * kc.numel() * 2,
                        4 * d * pairs * b * h, H100_BF16_TFLOPS)
    results["flash_attention"] = dict(
        err=max(errs), tol=min(tols), ms=ms, plain_ms=plain_ms,
        library_ms=library_ms, library_err=lib_err,
        shape="B=4 S=640 kv_len=600 H=KV=32 D=128 causal (+ GQA KV=8)", **bnd)

    # decode: Vicuna-7B cache, T=704, holes + one fully masked 128-slot tile
    b, t, h, d = 4, 704, 32, 128
    q = randn(b, 1, h, d)
    k, v = randn(b, t, h, d), randn(b, t, h, d)
    mask = torch.rand(b, t, generator=g, device=dev) < 0.8
    mask[:, 256:384] = False
    mask[:, 0] = True
    ref = dec.decode_attention_plain(q, k, v, mask)
    lib_mask = mask[:, None, None, :]
    lib_err = max_err(sdpa(q, k, v, attn_mask=lib_mask), ref)
    visible = int(mask.sum().item())
    results["decode_attention"] = dict(
        err=max_err(dec.decode_attention(q, k, v, mask), ref),
        tol=kernel_tol(ref),
        ms=graph_ms(lambda: dec.decode_attention(q, k, v, mask)),
        plain_ms=cuda_ms(lambda: dec.decode_attention_plain(q, k, v, mask)),
        library_ms=graph_ms(lambda: sdpa(q, k, v, attn_mask=lib_mask)),
        library_err=lib_err,
        shape=f"B={b} T={t} H=KV={h} Dh={d}, holes + masked 128-slot tile "
              f"({visible} of {b * t} slots visible)",
        # only the visible slots' K and V rows have to be read
        **bound(2 * visible * h * d * 2 + mask.numel() + 2 * q.numel() * 2,
                4 * visible * h * d, H100_BF16_TFLOPS))

    for name, r in results.items():
        report_kernel(tag, name, r)
        if not r["library_err"] <= r["tol"]:
            fail(f"the library yardstick of {name} computes another "
                 f"function: err {r['library_err']}")
    return results


def report_kernel(tag: str, name: str, r: dict) -> None:
    lib = ("no single PyTorch call" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    print(f"{tag} kernel {name} [{r['shape']}]: max_abs_err {r['err']:.3e} "
          f"(tol {r['tol']:.3e}), kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {lib}, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({r['bound_ms'] / r['ms']:.1%} of it reached)")
    if not r["err"] <= r["tol"]:
        fail(f"{name} disagrees with its plain version: {r['err']}")


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
            if "t" not in times:
                # the library's backward of the same function (dq, dk, dv
                # in one call), on the same inputs
                ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
                lib_out = sdpa(ql, kl, vl, is_causal=True)
                lib_grads = torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                retain_graph=True)
                for n, got, ref in zip(("dq", "dk", "dv"), lib_grads,
                                       (rq, rk, rv)):
                    if not max_err(got, ref) <= kernel_tol(ref):
                        fail(f"the library backward's {n} computes another "
                             f"function")
                t["library"] = cuda_ms(lambda: torch.autograd.grad(
                    lib_out, (ql, kl, vl), do, retain_graph=True))
                del ql, kl, vl, lib_out, lib_grads
            print(f"{tag} kernels 5/6 [{case}]: kernel 5 {t['dq']:.4f} ms, "
                  f"kernel 6 {t['dkv']:.4f} ms, plain backward (dq, dk, dv "
                  f"together) {t['plain']:.4f} ms; kernel 2 forward "
                  f"{t['fwd']:.4f} ms"
                  + (f"; library backward (dq, dk, dv together) "
                     f"{t['library']:.4f} ms" if "library" in t else ""))
            times.setdefault("t", t)          # the MHA case is reported
        del q, k, v, do, out, lse, delta, dq, dk, dv, rq, rk, rv
    shape = "B=16 S=639 H=KV=32 D=128 causal (+ GQA KV=8, ragged S=100)"
    t = times["t"]
    # causal pairs of one head; recomputed S and dP, then dQ (kernel 5) or
    # dV and dK (kernel 6): 3 and 4 products of 2*D flops a pair. Bytes:
    # q, k, v, dO in and dq (or dk, dv) out in bf16, LSE and delta in fp32.
    b, s, h, d = 16, 639, 32, 128
    pairs, tensor, stats = s * (s + 1) // 2, b * s * h * d * 2, b * h * s * 4
    bounds = {
        "flash_attention_bwd_dq": bound(5 * tensor + 2 * stats,
                                        6 * d * pairs * b * h,
                                        H100_BF16_TFLOPS),
        "flash_attention_bwd_dkv": bound(6 * tensor + 2 * stats,
                                         8 * d * pairs * b * h,
                                         H100_BF16_TFLOPS)}
    results = {name: dict(err=max(e for e, _ in errs[name]),
                          tol=min(tol for _, tol in errs[name]),
                          ms=t["dq" if name.endswith("dq") else "dkv"],
                          plain_ms=t["plain"], library_ms=t["library"],
                          shape=shape, **bounds[name])
               for name in errs}
    for name, r in results.items():
        print(f"{tag} kernel {name}: bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['bound_ms'] / r['ms']:.1%} of it "
              f"reached); the library's one backward call does the work of "
              f"kernels 5 and 6 together")
    return results


def check_a_score(tag: str, dev) -> dict:
    """Phase 2, kernel 9 against `a_score_plain` on the card: fp32 at the
    A-score protocol shape against both anchors, a ragged case with both
    masks and lengths no tile divides, a bf16-input case, and target =
    anchor, which must give 1.0 for every image."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import a_score as A

    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def masks(n, st, sa):
        tm = torch.rand(n, st, generator=g, device=dev) < 0.7
        am = torch.rand(n, sa, generator=g, device=dev) < 0.6
        am[:, 0] = True                 # never a row with no valid anchor
        return tm, am

    n, st, d = LAW_IMAGES, 576, 4096
    target = randn(n, st, d)
    errs, reported = [], None
    for sa in (576, 256):
        anchor = randn(n, sa, d)
        got = A.max_cos(target, anchor)
        ref = A.a_score_plain(target, anchor)
        again = A.max_cos(target, anchor)
        if not torch.equal(got, again):
            fail(f"kernel 9 is not repeatable at Sa={sa}")
        r = dict(err=max_err(got, ref), tol=A_SCORE_TOL,
                 ms=cuda_ms(lambda: A.max_cos(target, anchor), iters=10),
                 plain_ms=cuda_ms(lambda: A.a_score_plain(target, anchor),
                                  iters=10),
                 library_ms=None,
                 shape=f"N={n} St={st} Sa={sa} D={d} fp32",
                 **bound((target.numel() + anchor.numel()) * 4 + n * 4,
                         2 * n * st * sa * d, H100_FP32_TFLOPS))
        report_kernel(tag, "a_score", r)
        errs.append(r["err"])
        reported = reported or r        # the CLIP@336 anchor is reported
        del anchor
    self_score = A.max_cos(target, target.clone())
    self_err = (self_score - 1.0).abs().max().item()
    print(f"{tag} kernel a_score self-anchor: max |score - 1| {self_err:.3e} "
          f"(tol {A_SCORE_TOL})")
    if not self_err <= A_SCORE_TOL:
        fail(f"kernel 9: target = anchor gives {self_score[:4].tolist()}")
    del target, self_score

    cases = (("ragged, both masks", 7, 150, 77, 1000, torch.float32, True),
             ("D no vector load divides", 3, 65, 130, 37, torch.float32,
              True),
             ("bf16 inputs, masks", 8, 576, 256, 4096, torch.bfloat16, True),
             ("bf16 inputs", 8, 576, 576, 4096, torch.bfloat16, False))
    for label, n, st, sa, d, dtype, masked in cases:
        t, a = randn(n, st, d, dtype=dtype), randn(n, sa, d, dtype=dtype)
        tm, am = masks(n, st, sa) if masked else (None, None)
        err = max_err(A.max_cos(t, a, tm, am), A.a_score_plain(t, a, tm, am))
        print(f"{tag} kernel a_score [{label}: N={n} St={st} Sa={sa} D={d} "
              f"{str(dtype).split('.')[-1]}]: max_abs_err {err:.3e} (tol "
              f"{A_SCORE_TOL})")
        if not err <= A_SCORE_TOL:
            fail(f"kernel 9 disagrees with its plain version ({label})")
        errs.append(err)
    return {"a_score": dict(reported, err=max(errs))}


def check_routes(tag: str, dev) -> None:
    """Phase 2, the tower routes of `model.tower_attn_impl`, each against
    the plain `mha`: `flash` runs kernel 2 non-causal, `encoder2` and
    `tpu_flash` run kernel 1. The shapes are those the paths launch: the
    CLIP-L/14-336 batch (B=4, S=577, H=16, D=64) and the one-image calls of
    the law chain's embedding dumps, `encoder2` and `tpu_flash` at S=577
    (CLIP@336, DINOv2-L@336) and `flash` at S=257 (CLIP@224)."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import vit
    from law_of_vision_representation_in_mllms_torch.ops import (
        encoder_attention as enc, flash_attention as fl)
    from law_of_vision_representation_in_mllms_torch.ops.attention import mha

    g = torch.Generator(device=dev).manual_seed(3)
    counters = {"flash": fl.flash_attention,
                "encoder2": enc.encoder_attention,
                "tpu_flash": enc.encoder_attention}
    for b, s, impls in ((4, 577, ("flash", "encoder2", "tpu_flash")),
                        (1, 577, ("encoder2", "tpu_flash")),
                        (1, 257, ("flash",))):
        q, k, v = (torch.randn((b, s, 16, 64), generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        ref = mha(q.float(), k.float(), v.float())
        for impl in impls:
            counter = counters[impl]
            route = vit.attention_route(impl)
            before = counter.launches
            got = vit.attend(route, q, k, v)
            torch.cuda.synchronize()
            if counter.launches != before + 1:
                fail(f"tower route {impl} did not launch its kernel")
            err, tol = max_err(got, ref), kernel_tol(ref)
            ms = graph_ms(lambda: vit.attend(route, q, k, v))
            print(f"{tag} tower route {impl} -> {counter.__name__} [B={b} "
                  f"S={s} H=16 D=64]: max_abs_err {err:.3e} (tol {tol:.3e}), "
                  f"{ms:.4f} ms")
            if not err <= tol:
                fail(f"tower route {impl} disagrees with the plain mha at "
                     f"B={b} S={s}: {err}")


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


def check_narrow_loglikelihood(tag: str, dev) -> None:
    """Phase 3c: `LlavaLMM.loglikelihood` of the narrow LLaVA on 8 requests
    of mixed lengths, CUDA bf16 with kernels 1 and 2 against CPU fp32 plain.
    Every other continuation is the CPU model's own greedy answer (flag
    True), the others are random words (flag False). Summed log-probs within
    LL_REL_TOL of the CPU sum's size; greedy flags compared only where the
    CPU's top two log-probs lie further apart than twice the error that
    tolerance allows a token. The ids come from a CRC of each word, not from
    Python's per-process `hash`, so every run scores the same requests and
    compares the same flags; it fails under LL_MIN_FLAGS of them."""
    import math
    import re
    import zlib

    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.data.conversation \
        import get_template
    from law_of_vision_representation_in_mllms_torch.data.preprocess import (
        SimpleTokenizer)
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.eval.llava_adapter \
        import LlavaLMM
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.ops import (
        encoder_attention as enc, flash_attention as fl)

    cfg = narrow_config()
    cpu = M.init_params(torch.Generator().manual_seed(2), cfg,
                        FP32_PRECISION, "cpu")
    # a random lm_head leaves every token near log(1/V) and the top two
    # log-probs closer than any bf16 tolerance; a wider one makes the
    # greedy choice decisive, so the flags can be compared
    cpu.decoder.lm_head.weight.data.mul_(10.0)
    gpu = M.LlavaParams(cfg, BF16_PRECISION, device=dev)
    gpu.load_state_dict(cpu.state_dict())

    class CrcTokenizer(SimpleTokenizer):
        """Stable ids; a word `t<id>`, as `decode` writes it, is that id."""
        def encode(self, text, add_special_tokens=False):
            ids = [int(w[1:]) if re.fullmatch(r"t\d+", w)
                   else 3 + zlib.crc32(w.encode()) % (self.vocab_size - 3)
                   for w in text.split()]
            return [self.bos_token_id] + ids if add_special_tokens else ids

    tok = CrcTokenizer(vocab_size=cfg.decoder.vocab_size)
    sides = [LlavaLMM(p.eval(), cfg, tok, get_template("v1"), batch_size=8)
             for p in (cpu, gpu)]

    rng = np.random.RandomState(2)
    reqs = []
    for i in range(8):
        img = rng.randn(336, 336, 3).astype(np.float32)
        ctx = " ".join(rng.choice(WORDS, size=3 + 5 * i))
        k = 1 + i % 4
        cont = " " + " ".join(rng.choice(WORDS, size=k))
        if i % 2 == 0:
            cont = " " + sides[0].generate_until([Instance(
                "generate_until", {}, i, "smoke",
                (ctx, {"max_new_tokens": k}), [img])])[0]
        reqs.append(Instance("loglikelihood", {}, i, "smoke", (ctx, cont),
                             [img]))
    before = (enc.encoder_attention.launches, fl.flash_attention.launches)
    ref = sides[0]._ll_rows(reqs)
    got = sides[1]._ll_rows(reqs)
    torch.cuda.synchronize()
    if (enc.encoder_attention.launches == before[0]
            or fl.flash_attention.launches == before[1]):
        fail("narrow loglikelihood on CUDA launched no kernel 1 or 2")
    worst, compared, flags = 0.0, 0, set()
    for i, ((g_lp, g_flag, _), (r_lp, r_flag, r_margin)) in enumerate(
            zip(got, ref)):
        # the error of a logit does not shrink with a confident token's
        # small log-prob: a sum counts as at least log(V) a token
        n_cont = len(tok.encode(reqs[i].args[1]))
        size = max(abs(r_lp), n_cont * math.log(cfg.decoder.vocab_size))
        rel = abs(g_lp - r_lp) / size
        worst = max(worst, rel)
        if not (np.isfinite(g_lp) and rel <= LL_REL_TOL):
            fail(f"narrow loglikelihood request {i}: {g_lp} vs {r_lp}")
        if r_margin > 2 * LL_REL_TOL * size / n_cont:
            compared += 1
            flags.add(r_flag)
            if g_flag != r_flag:
                fail(f"narrow loglikelihood request {i}: greedy flag "
                     f"{g_flag} vs {r_flag} at margin {r_margin}")
    if compared < LL_MIN_FLAGS or flags != {True, False}:
        fail(f"narrow loglikelihood: {compared} greedy flags ({flags}) had a "
             f"margin over the tolerance; {LL_MIN_FLAGS} are needed, a True "
             f"and a False among them")
    print(f"{tag} narrow loglikelihood, 8 requests (CUDA bf16 kernels vs CPU "
          f"fp32 plain): worst summed log-prob rel err {worst:.3e} (tol "
          f"{LL_REL_TOL}); sums {got[0][0]:.4f} .. {got[-1][0]:.4f}; greedy "
          f"flags compared on {compared} of 8, True and False among them "
          f"(the others' top two log-probs are closer than the tolerance)")


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


def _law_chain_tasks(folder: str) -> dict:
    """LAW_IMAGES random 336x336 PNGs, an MME-style yes/no task
    (`generate_until`) and a multiple-choice task (per-option
    `loglikelihood`) over them, both on the `json` backend. The task files
    are `.json`, which the task loader reads without PyYAML. Returns the
    paths."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(6)
    mme, mc = [], []
    for i in range(LAW_IMAGES):
        Image.fromarray(rng.randint(0, 256, (336, 336, 3), dtype=np.uint8)
                        ).save(os.path.join(folder, f"img{i}.png"))
        topic = " ".join(rng.choice(WORDS, size=6))
        mme.append({"question": f"Is there {topic} in the image?",
                    "answer": "Yes" if i % 2 else "No",
                    "category": ("existence", "color")[i % 4 // 2],
                    "image_id": f"img{i // 2}", "image": f"img{i}.png"})
        options = [" ".join(rng.choice(WORDS, size=1 + j)) for j in range(4)]
        mc.append({"question": f"Which one describes {topic}?",
                   "options": options, "answer": "ABCD"[i % 4],
                   "category": ("scene", "object")[i % 2],
                   "image": f"img{i}.png"})
    paths = {}
    for name, docs, cfg in (
            ("smoke_mme", mme,
             {"doc_to_text": "mme.doc_to_text",
              "process_results": "mme.process_results",
              "aggregation": "mme", "output_type": "generate_until",
              "generation_kwargs": {"max_new_tokens": 16}}),
            ("smoke_mc", mc,
             {"doc_to_text": "mmbench_en.doc_to_text",
              "process_results": "mmbench_en.process_results",
              "aggregation": "mean", "output_type": "multiple_choice"})):
        data = os.path.join(folder, f"{name}.json")
        with open(data, "w") as f:
            json.dump(docs, f)
        paths[name] = os.path.join(folder, f"{name}_task.json")
        with open(paths[name], "w") as f:
            json.dump(dict(cfg, task=name, dataset_path=data,
                           dataset_backend="json", image_root=folder,
                           doc_to_visual="common.doc_to_visual"), f)
    return paths


def run_law_chain(tag: str, dev, counters) -> dict:
    """Phase 6: benchmark eval -> embedding dump -> A score -> AC policy at
    full LLaVA-1.5-7B width through the port's entry points."""
    import shutil

    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch import policy
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval import runner
    from law_of_vision_representation_in_mllms_torch.eval.task import (
        load_task)
    from law_of_vision_representation_in_mllms_torch.metrics.a_score import (
        a_score, pad_stack)
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        parse_tower_spec)
    from law_of_vision_representation_in_mllms_torch.ops import a_score as A
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        a_score_run)

    global LAW_IMAGES
    # each rep a LLaVA-1.5-7B of its own seed; the routes of the JAX
    # package's other tower and decode kernels ride on the anchors and the
    # target (`encoder2` and `tpu_flash` run kernel 1, `flash` kernel 2,
    # `pallas_stacked` kernel 3)
    reps = {
        "clip336": {"model": {
            "vision_tower": "openai/clip-vit-large-patch14-336",
            "tower_attn_impl": "encoder2"}, "train": {"seed": 11}},
        "clip224": {"model": {
            "vision_tower": "openai/clip-vit-large-patch14",
            "tower_attn_impl": "flash"}, "train": {"seed": 12}},
        "dinov2_336": {"model": {
            "vision_tower": "facebook/dinov2-large-336",
            "tower_attn_impl": "tpu_flash",
            "decode_attn": "pallas_stacked"}, "train": {"seed": 13}},
    }
    target = "dinov2_336"
    # 576, 256 and 576 patch tokens an image
    tokens = {rep: parse_tower_spec(raw["model"]["vision_tower"]).num_patches
              for rep, raw in reps.items()}

    tmp = tempfile.mkdtemp(prefix="lvr_smoke_law_")
    try:
        need = LAW_IMAGES * sum(tokens.values()) * LAW_HIDDEN * 4 * 1.1
        free = shutil.disk_usage(tmp).free
        if free < need:
            cut = int(LAW_IMAGES * free / need * 0.9)
            print(f"{tag} law chain: {free / 1e9:.2f} GB free under the "
                  f"temporary directory, {need / 1e9:.2f} GB needed: image "
                  f"count cut from {LAW_IMAGES} to {cut}")
            if cut < 4:
                fail("no room for the embedding dump")
            LAW_IMAGES = cut
        t0 = time.perf_counter()
        tasks = _law_chain_tasks(tmp)
        print(f"{tag} law chain: {LAW_IMAGES} PNGs and 2 task files written "
              f"in {time.perf_counter() - t0:.2f} s")
        base = os.path.join(tmp, "embeds")

        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        # the main path, counted ------------------------------------------
        dump_s = {}
        for rep, raw in reps.items():
            cfg = RunConfig.from_dict(raw)
            t0 = time.perf_counter()
            n = runner.run_embed_extraction(
                cfg, tasks["smoke_mme"], os.path.join(base, rep), device=dev,
                limit=LAW_IMAGES)
            torch.cuda.synchronize(dev)
            dump_s[rep] = time.perf_counter() - t0
            if n != LAW_IMAGES:
                fail(f"{rep}: dumped {n} embeddings, not {LAW_IMAGES}")
            gc.collect()
            torch.cuda.empty_cache()
        after_dump = {name: c.launches for name, c in counters.items()}

        t0 = time.perf_counter()
        results = runner.run_evaluation(
            RunConfig.from_dict(reps[target]), list(tasks.values()),
            device=dev, limit=LAW_EVAL_LIMIT, log_samples=True)
        torch.cuda.synchronize(dev)
        eval_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        after_eval = {name: c.launches for name, c in counters.items()}

        t0 = time.perf_counter()
        scores = a_score_run.compute_a_scores(
            base, [target, "clip336", "not_dumped"], n_images=LAW_IMAGES,
            device=dev)
        torch.cuda.synchronize(dev)
        a_score_s = time.perf_counter() - t0

        # made-up benchmark scores plus these A scores -> one policy fit
        prng = np.random.default_rng(0)
        n_models = len(policy.ALL_MODELS)
        a_col = prng.random(n_models)
        a_col[policy.ALL_MODELS.index("CLIP336")] = scores["clip336"]
        a_col[policy.ALL_MODELS.index("DINOv2")] = scores[target]
        c_col = prng.random(n_models)
        table = policy.ACTable(
            models=list(policy.ALL_MODELS),
            perf={b: 2 * a_col ** 2 + a_col * c_col + 0.5 * c_col
                  + 0.05 * prng.standard_normal(n_models)
                  for b in policy.BENCHMARKS},
            a={b: a_col for b in policy.BENCHMARKS}, c=c_col)
        fit = policy.fit_policy(table, "mme")
        launches = {name: c.launches for name, c in counters.items()}
        # ---------------------------------------------------------------
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        print(f"{tag} law chain launches {launches} (after the three "
              f"embedding dumps {after_dump}; after the eval {after_eval})")
        if launches["a_score"] != 4:
            fail(f"kernel 9 launched {launches['a_score']} times in "
                 f"compute_a_scores, not 4 (two reps x two anchors)")
        # 23 blocks a tower call, one call an image; clip224 runs kernel 2
        if after_dump["encoder_attention"] != 2 * 23 * LAW_IMAGES:
            fail("kernel 1 did not run 23 times an image in the clip336 "
                 "and target dumps")
        if after_dump["flash_attention"] != 23 * LAW_IMAGES:
            fail("kernel 2 did not run 23 times an image in the clip224 "
                 "dump (tower route flash)")
        eval_launches = {k: after_eval[k] - after_dump[k] for k in launches}
        if min(eval_launches["encoder_attention"],
               eval_launches["flash_attention"],
               eval_launches["decode_attention"]) == 0:
            fail(f"the eval did not run kernels 1, 2 and 3: {eval_launches}")
        if sorted(scores) != sorted([target, "clip336"]):
            fail(f"compute_a_scores returned {sorted(scores)}")

        # what came out: files, shapes, types, finite values
        stacks = {}
        for rep, s_len in tokens.items():
            files = sorted(os.listdir(os.path.join(base, rep)))
            if len(files) != LAW_IMAGES:
                fail(f"{rep}: {len(files)} files, not {LAW_IMAGES}")
            arrays = [np.load(os.path.join(base, rep, f"tensor_{i + 1}.npy"))
                      for i in range(LAW_IMAGES)]
            for x in arrays:
                if (x.shape != (s_len, LAW_HIDDEN) or x.dtype != np.float32
                        or not np.isfinite(x).all()):
                    fail(f"{rep}: embedding {x.shape} {x.dtype} is not a "
                         f"finite fp32 [{s_len}, {LAW_HIDDEN}]")
            stacks[rep] = arrays
        print(f"{tag} embedding dump: {LAW_IMAGES} files a rep, fp32, "
              + ", ".join(f"{rep} [{tokens[rep]}, {LAW_HIDDEN}] "
                          f"{LAW_IMAGES / dump_s[rep]:.1f} images/s "
                          f"({dump_s[rep]:.1f} s with the model build)"
                          for rep in reps))

        # the A score: kernel against plain on the same arrays, and the
        # CLIP@336 rep against itself
        t0 = time.perf_counter()
        dev_stacks = {rep: pad_stack(arrays, dev)[0]
                      for rep, arrays in stacks.items()}
        torch.cuda.synchronize(dev)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = float(a_score(dev_stacks[target], dev_stacks["clip336"],
                              dev_stacks["clip224"]))
        device_s = time.perf_counter() - t0
        if again != scores[target]:
            fail(f"the A score is not repeatable: {again} vs "
                 f"{scores[target]}")
        worst = 0.0
        per_anchor = {}
        for anchor in ("clip336", "clip224"):
            got = A.max_cos(dev_stacks[target], dev_stacks[anchor])
            ref = A.a_score_plain(dev_stacks[target], dev_stacks[anchor])
            worst = max(worst, max_err(got, ref))
            per_anchor[anchor] = got.mean().item()
        if not worst <= A_SCORE_TOL:
            fail(f"kernel 9 disagrees with its plain version on the dumped "
                 f"embeddings: {worst}")
        self_term = A.max_cos(dev_stacks["clip336"], dev_stacks["clip336"])
        term224 = A.a_score_plain(dev_stacks["clip336"],
                                  dev_stacks["clip224"]).mean().item()
        self_err = (self_term - 1.0).abs().max().item()
        self_plain = (A.a_score_plain(dev_stacks["clip336"],
                                      dev_stacks["clip336"])
                      - 1.0).abs().max().item()
        norms = torch.linalg.vector_norm(dev_stacks["clip336"], dim=-1)
        want_self = (1.0 + term224) / 2
        if not (self_err <= A_SCORE_TOL
                and abs(scores["clip336"] - want_self) <= A_SCORE_TOL):
            fail(f"CLIP@336 against itself: {scores['clip336']} vs "
                 f"{want_self}, self term off by {self_err}")
        k9_ms = cuda_ms(lambda: A.max_cos(dev_stacks[target],
                                          dev_stacks["clip336"]), iters=5,
                        warmup=1)
        print(f"{tag} A score: {target} {scores[target]:.6f} (vs clip336 "
              f"{per_anchor['clip336']:.6f}, vs clip224 "
              f"{per_anchor['clip224']:.6f}), clip336 {scores['clip336']:.6f}"
              f" (self term 1 within {self_err:.1e}, the plain version's "
              f"within {self_plain:.1e}; row norms {norms.min().item():.3g} "
              f"to {norms.max().item():.3g}); kernel vs plain on "
              f"these arrays max_abs_err {worst:.3e} (tol {A_SCORE_TOL}); "
              f"compute_a_scores {a_score_s:.2f} s in all, of it loading "
              f"and padding 3 reps onto the card {load_s:.2f} s and the "
              f"device part of one rep {device_s * 1e3:.1f} ms; kernel 9 "
              f"{k9_ms:.3f} ms a launch at N={LAW_IMAGES} St=Sa=576 "
              f"D={LAW_HIDDEN}")
        del dev_stacks, stacks

        # the eval: one value a task, in its range
        for name, (lo, hi) in (("smoke_mme", (0.0, 400.0)),
                               ("smoke_mc", (0.0, 1.0))):
            r = results[name]
            if not (r["n"] == LAW_EVAL_LIMIT and np.isfinite(r["value"])
                    and lo <= r["value"] <= hi):
                fail(f"eval result of {name} out of range: {r}")
        print(f"{tag} eval ({LAW_EVAL_LIMIT} docs a task, model build "
              f"included, {eval_s:.1f} s): smoke_mme "
              f"{results['smoke_mme']['value']:.2f} (generate_until), "
              f"smoke_mc {results['smoke_mc']['value']:.3f} (4 options a "
              f"doc through loglikelihood); launches {eval_launches}; "
              f"sample prediction "
              f"{results['smoke_mme']['samples'][0]['prediction'][:40]!r}")
        print(f"{tag} policy fit on a made-up 13-model table holding these "
              f"A scores: r2 {fit.r2:.4f}, mse {fit.mse:.5f}")
        if not (np.isfinite(fit.r2) and np.isfinite(fit.coef).all()):
            fail("fit_policy gave a non-finite fit")

        # loglikelihood alone: finite sums and requests/s
        lmm = runner.build_lmm(RunConfig.from_dict(reps[target]), device=dev)
        task = load_task(tasks["smoke_mc"], limit=LAW_EVAL_LIMIT)
        from law_of_vision_representation_in_mllms_torch.eval.api import (
            Instance)
        reqs = [Instance("loglikelihood", r.doc, r.doc_id, r.task_name,
                         (r.args[0], " " + opt), visual=r.visual)
                for r in task.build_requests(list(range(len(task.docs))))
                for opt in r.doc["options"]]
        lmm.loglikelihood(reqs[:8])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        lls = lmm.loglikelihood(reqs)
        torch.cuda.synchronize(dev)
        ll_s = time.perf_counter() - t0
        if not all(np.isfinite(lp) and lp < 0 for lp, _ in lls):
            fail("loglikelihood returned a non-finite or positive sum")
        peak_gb = max(peak_gb, torch.cuda.max_memory_allocated(dev) / 1e9)
        print(f"{tag} loglikelihood (LLaVA-1.5-7B, {len(reqs)} requests in "
              f"batches of {lmm.batch_size}, spliced S ~ 639): "
              f"{len(reqs) / ll_s:.1f} requests/s; sums "
              f"{min(lp for lp, _ in lls):.2f} .. "
              f"{max(lp for lp, _ in lls):.2f}")
        print(f"{tag} law chain peak memory allocated: {peak_gb:.2f} GB")
        del lmm
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    try:
        from law_of_vision_representation_in_mllms_torch.ops import (
            _build, a_score as asc, decode_attention as dec,
            encoder_attention as enc, flash_attention as fl)
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    t_start = time.perf_counter()
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
    kernels.update(check_a_score(tag, dev))
    check_routes(tag, dev)
    check_narrow_llava(tag, dev)
    check_narrow_training(tag, dev)
    check_narrow_loglikelihood(tag, dev)
    counters = {"encoder_attention": enc.encoder_attention,
                "flash_attention": fl.flash_attention,
                "decode_attention": dec.decode_attention,
                "flash_attention_bwd_dq": fl.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fl.flash_attention_bwd_dkv,
                "a_score": asc.max_cos}
    paths = {}
    paths["serve"] = run_full_width(tag, dev, counters)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} after the serving phase: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated")
    paths["train"] = run_full_width_training(tag, dev, counters)
    gc.collect()
    torch.cuda.empty_cache()
    paths["law_chain"] = run_law_chain(tag, dev, counters)
    # every kernel must have launched on at least one main path
    for name in counters:
        if sum(p[name] for p in paths.values()) == 0:
            fail(f"{name} was launched on no main path")

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
        "a_score": f"{TPU_PKG}/ops/a_score_pallas.py:76",
    }
    # the JAX package's other kernels of the same function, routed onto
    # these (launched in the law chain and held to the plain mha in phase 2;
    # the decode route's parity is a CPU test against the stacked kernel)
    routes = {
        "encoder_attention": [
            f"{TPU_PKG}/ops/encoder_attention.py:169 (encoder_mha_v2, "
            f"tower_attn_impl=encoder2*)",
            f"{TPU_PKG}/models/vit.py:226 (tower_attn_impl=tpu_flash)"],
        "flash_attention": [
            f"{TPU_PKG}/ops/flash_attention.py:130 (flash_attention_bhsd "
            f"without ALiBi, tower_attn_impl=flash)"],
        "decode_attention": [
            f"{TPU_PKG}/ops/decode_attention.py:190 "
            f"(decode_attention_stacked, decode_attn=pallas_stacked)"],
    }
    sources = {name: f"{PKG}/csrc/{name}.cu" for name in replaces}
    sources["flash_attention_bwd_dq"] = f"{PKG}/csrc/flash_attention_bwd.cu"
    sources["flash_attention_bwd_dkv"] = f"{PKG}/csrc/flash_attention_bwd.cu"
    print(f"{tag} chip_smoke phases took "
          f"{time.perf_counter() - t_start:.1f} s")
    # launches: the serving run (phase 4), the training run (phase 5) and
    # the law chain (phase 6), each counted from 0; the split is in
    # "launches_by_path"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "routes": routes.get(name, []),
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {path: p[name] for path, p in paths.items()},
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "shape": r["shape"]}
        for name, r in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
