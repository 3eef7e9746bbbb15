#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises and exits non-zero; no phase swallows an error):
  1. build the CUDA kernels from law_of_vision_representation_in_mllms_torch/
     csrc (set-up time, printed);
  2. each kernel against its plain PyTorch version on the card, in bf16, at
     the main path's shapes, with the max abs error beside a stated
     tolerance, and both times;
  3. a narrow LLaVA (4-layer 336 px tower, head_dim 64, 3 decoder layers with
     GQA): the logits of the prefill and of 3 decode steps on CUDA with the
     kernels in bf16 against the same weights on the CPU with the plain path
     in fp32, and how far the two `generate_greedy` runs agree;
  4. the slice at full width: LLaVA-1.5-7B (CLIP-L/14-336 + mlp2x_gelu +
     Vicuna-7B) with seeded random bf16 weights answers 4 requests through
     `LlavaLMM.generate_until`; every kernel's launch counter must have gone
     up in that run; a second run must give identical tokens; tower
     images/s, prefill ms, decode tokens/s and peak memory are printed.

TF32 is switched off (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`) so every plain version runs in
full fp32. Every metric line carries the card's name and power limit.
The last lines are the kernels JSON, the card line from nvidia-smi and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
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


def check_narrow_llava(tag: str, dev) -> None:
    """Phase 3: narrow LLaVA, CUDA kernels in bf16 vs CPU plain fp32."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llama as L
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IMAGE_TOKEN_INDEX)
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        TowerEntry, TowerSpec)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTConfig)

    vit = ViTConfig(image_size=336, patch_size=14, hidden_size=256,
                    num_layers=4, num_heads=4, intermediate_size=1024)
    entry = TowerEntry(name="narrow-clip-336", kind="vit", vit_config=vit,
                       vit_family="clip", hidden_size=256,
                       num_patches=vit.num_patches, img_size=336)
    cfg = M.LlavaConfig(
        tower_spec=TowerSpec(entries=[entry], join="single"),
        decoder=L.LlamaConfig(vocab_size=1000, hidden_size=256,
                              intermediate_size=688, num_layers=3,
                              num_heads=4, num_kv_heads=2))
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


def _requests(n: int, crop: int):
    import numpy as np
    from law_of_vision_representation_in_mllms_torch.data.image_processing \
        import CLIP_MEAN, CLIP_STD
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    rng = np.random.RandomState(0)
    words = ("image shows a small red house near the river with two trees "
             "and a dog sitting on the grass while clouds move over the "
             "hills in the late afternoon light describe every object its "
             "color and where it is").split()
    reqs = []
    for i in range(n):
        img = rng.rand(crop, crop, 3).astype(np.float32)
        img = (img - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(
            CLIP_STD, np.float32)
        prompt = " ".join(rng.choice(words, size=30 + 4 * i))
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
    check_narrow_llava(tag, dev)
    counters = {"encoder_attention": enc.encoder_attention,
                "flash_attention": fl.flash_attention,
                "decode_attention": dec.decode_attention}
    launches = run_full_width(tag, dev, counters)

    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "flax", "optax", "orbax", TPU_PKG)]
    if leaked:
        fail(f"JAX-side modules were imported: {leaked[:5]}")

    replaces = {
        "encoder_attention": f"{TPU_PKG}/ops/encoder_attention.py:78",
        "flash_attention": f"{TPU_PKG}/ops/flash_attention.py:377",
        "decode_attention": f"{TPU_PKG}/ops/decode_attention.py:341",
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"{PKG}/csrc/{name}.cu", "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": r["err"],
         "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
