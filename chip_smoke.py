#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training, law-chain (A and C
scores), quantised serving, MPT, training-variant, diffusion-tower (SD1.5,
DiT-XL/2, SD3-medium), checkpoint-porting, eval-zoo, projector / token
variant (perceiver, MoF, visual_keep, anyres) and GeoAware-SC paths on one
NVIDIA GPU (H100).

    python3 chip_smoke.py          # from the repository root, one card
    python3 chip_smoke.py --tower-of ROOT   # the tower of the port in ROOT
    python3 chip_smoke.py --a-score-of ROOT # kernel 9 of the port in ROOT
    python3 chip_smoke.py --decode-of ROOT  # kernel 3 of the port in ROOT
    python3 chip_smoke.py --int4-of ROOT    # kernel 10 at decode M in ROOT
    python3 chip_smoke.py --sass-of ROOT    # ROOT's kernels' SASS vs these
    python3 chip_smoke.py --a-score-variants  # kernel 9's floors, in turns
    python3 chip_smoke.py --sd15-split      # an SD1.5 featurization's split
    python3 chip_smoke.py --parallel        # the build and phase 17 alone
    python3 chip_smoke.py --context-pipeline  # the build and phase 18 alone

Phases (any failure raises and exits non-zero; no phase swallows an error):
  1. build the CUDA kernels from law_of_vision_representation_in_mllms_torch/
     csrc (set-up time, printed);
  2. each kernel against its plain PyTorch version on the card, in bf16, at
     the main paths' shapes, with the max abs error beside a stated
     tolerance, and both times: kernels 1-3 (serving) and the backward
     kernels 5 (dq) and 6 (dk/dv) at the training step's B=16, S=639,
     H=32, D=128, causal, plus a GQA and a ragged case; kernel 9 (masked
     max-cosine) at the A-score protocol shape N=100, St=576, Sa=576 and
     256, D=4096 in fp32 (its 3xTF32 wgmma body; bound: the three TF32
     products at 495 TFLOP/s, the fp32-FMA bound printed beside it, and
     `torch.bmm` of the same inputs at "highest" precision printed as the
     product alone), towers' structured data (cosines near 1), a self-anchor
     check, a ragged masked case, D=37 and bf16 (its SIMT body), each case's
     body checked by the counters; the tower routes `flash` (kernel 2 non-causal) and `encoder2`
     (kernel 1), also at the one-image shapes of the embedding dumps
     (S=577, and S=257 for CLIP@224). Beside each kernel: the least time the card could take
     (`bound_ms`, from the bytes and operations of this run's inputs) and
     the time of the one PyTorch call that computes the same function
     (`scaled_dot_product_attention`), a yardstick the port never calls.
     Kernels 5 and 6 are held row by row (each row of dq, dk, dv to 2 % of
     its own max|plain|), kernel 5's δ to rowsum(dO·O), and a repeat of the
     whole backward call to the same bits; that call (kernel 5 forming δ,
     then kernel 6) is timed in turns with SDPA's backward at B=16 S=639
     and B=2 S=2,048.
     Kernel 2 also at every attention shape of an SD1.5 forward at 768 px
     (B=4, 8 heads: D=40 at S=9,216, D=80 at 2,304, D=160 at 576 and 144,
     each self and cross against 77 text tokens) and SD2.1's 5-head D=64
     S=9,216 one, each with its launches an SD1.5 forward; and at
     DiT-XL/2's self-attention (S=1,024, H=16, D=72) and SD3-medium's joint
     attention (S=1,024 + 333, H=24, D=64) at B=1 and 16 (SD3 also at the
     served B=4), each with the block rows the launcher takes and its
     launches a forward (a spill of any form of the forward fails the run);
     kernel 2's causal form at the CLIP text encoders' attention (S=77,
     D=64; 12, 16 and 20 heads: SD1.5's CLIP-L, SD2.1's OpenCLIP-H, the
     bigG of SDXL and SD3), held row by row with its LSE, a repeat's bits,
     SDPA (`is_causal`) and its bound;
     kernel 2 also at GeoAware's SD1.5 at 960 px (B=1: D=40 at S=14,400,
     D=80 at 3,600, D=160 at 900 and 225, each self and cross against 77
     tokens; phase 16) and kernel 1 at DINOv2-B at 840 px (B=1 S=3,601
     H=12 D=64), each with its launches a phase-16 forward;
     kernel 2 also at a stage-1 step's B=16 S=639 and MPT-7B's B=2 S=2,048
     (causal, no bias) and at the perceiver projector's attention (Sq=64
     latents over Skv=640 keys, H=8, D=64, non-causal) at B=4 and 16, its
     backward (kernel 5 forming δ, then kernel 6) at B=16 held row by row,
     δ, a repeat's bits, timed in turns with SDPA's backward; kernel 1
     also at the dumps' B=1 S=577 and S=257,
     each with its plain version, SDPA and its bound; at every shape of
     kernels 1 and 2 a repeat must give the same bits, and ptxas's
     registers and spills of their wgmma forward are printed.
     Quantisation: kernel 10 (W4A16 matmul) at the 7B shapes 4096->4096,
     4096->11008, 11008->4096, 4096->32000 at M=4 (its decode body; also
     M=1, 8 and 16 at 4096->4096, each with the split it took), 64,
     2,812 and 11,248 (its wgmma body), and its transposed form
     `int4_matmul_dx` at M=11,248 (library: `torch.matmul` on the bf16
     weight), and at M=4 on a weight of K=1,004 with one scale a channel
     (its words zero-padded to 1,024, x padded by `quant.int4_matmul`),
     timed over rotating copies of the weight so every launch reads
     it from HBM, not from L2, with `nvcc -Xptxas -v`'s registers and spills
     of the two wgmma bodies; kernel 3's int8
     branch at B=4 T=704 H=32 Dh=128 with holes and a GQA case (library:
     SDPA on the dequantised cache); kernel 3's three cases timed cold, over
     rotating caches (`ms`), and warm, one cache in L2 (`warm_ms`), each with
     a repeat that must give the same bits, and ptxas's registers and spills
     of every form of it (a spill fails the run); kernel 3 dense against
     int8 at B=1, 4, 16, 32 and at B=4 T=2,048 over rotating caches (the kv8
     crossover); and what the int8
     weights' cast costs a call. ALiBi: kernels 2, 5 and 6 with the
     in-kernel bias at MPT-7B's shape (B=2, S=2,048, H=32, D=128, causal), a
     ragged S, H=6 at D=64, a GQA case with a kv_len tail, and each LSE;
     timed in turns with the same kernels without the bias (what the term
     costs); library: SDPA with the bias materialised as `attn_mask`, and
     its backward;
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
  3d. the narrow LLaVA (intermediate 768, so every contraction dim is whole
     128-element tiles) quantised: `quantize=int4` + `kv_quant=int8`, then
     `quantize=int8`, CUDA with kernel 10 and the int8 branch against the
     same codes and scales on the CPU in fp32; and 3 stage-1 training steps
     through the int4 frozen decoder (`train.quantize_base`), CUDA against
     CPU as in 3b;
  3f. the projector and token variants on the narrow LLaVA, the logits of
     a prefill and 3 decode steps on CUDA against the CPU: perceiver2x
     (kernel 2 twice an encode), MoF of the narrow tower and a narrow
     DINOv2-like one (1,152 interleaved tokens), visual_keep = 144 by the
     CLS attention and by the norm (the kept index sets equal, or parted
     only within twice the run's own score error of the K-th / (K+1)-th
     boundary, the CPU then fed the card's set), and an anyres splice
     (base view + 2 x 2 crops, the unpad mask as `image_valid`, the prefill
     on the masked attention, decode through kernel 3); and 3b's three
     stage-1 steps with a perceiver2x projector (kernels 5 and 6 at the
     perceiver's shape, launches counted);
  3e. a narrow MPT (3 layers, 4 heads of 64): logits and `wqkv` gradients,
     CUDA bf16 through the ALiBi kernels against CPU fp32 on the plain
     biased attention; and 3b's three steps for the training variants: LoRA
     (rank 8), QLoRA (the same over the int4 base) and the switch matrix;
  3g. GeoAware, CUDA fp32 against CPU fp32: a narrow SAM's `segment`
     logits and IoU (256 px, windows of 7 over a grid padded 16 -> 21, two
     global layers), 3 `c-train` steps' losses of a narrow aggregation
     network from the same weights, and `pair_distance` (co-PCA, fused
     descriptors, masked NN distances);
  4. the serving slice at full width: LLaVA-1.5-7B (CLIP-L/14-336 +
     mlp2x_gelu + Vicuna-7B) with seeded random bf16 weights answers 4
     requests through `LlavaLMM.generate_until`, whose greedy decode on the
     card is the chunked decoder (each 16-step chunk one CUDA graph,
     captured in this first call and replayed; the launches derived from
     captures and replays); every serving kernel's launch counter must have
     gone up in that run; the eager `generate_greedy` twice gives identical
     tokens; tower images/s, prefill ms, eager decode tokens/s and peak
     memory are printed; the model is freed afterwards;
  4b. (inside phases 4 and 7, on the model they built) the serving
     backends, 32 new tokens: the graph path (bf16, int4 + kv8, int8):
     tokens and text against the eager greedy decode's, a second run's
     tokens, tokens/s of both paths (the replays timed by CUDA events), the
     capture's time, the replays, the launches of kernels 3 and 10 recorded
     in a chunk times its replays, and kernel 3 against its plain version
     at the path's shape; in bf16 also `gen_backend=speculative` (the
     adapter's decoder keeps its captured verify round: tokens, rounds,
     warm tokens/s, capture time), beam search with 2 beams (finite
     scores, a repeat's tokens, kernel 3 at B*k = 8 against its plain
     version, the best beams' scores against eager steps on the plain
     attention fed the same tokens (a search on it printed beside), tokens/s,
     the beams' cache), sampling at temperature 0.7 / top-p 0.9 from a
     seeded generator on the card (the seed repeats its tokens;
     temperature 0 is greedy), and `LMMServer` on 127.0.0.1 answering two
     concurrent chat completions with a PNG each in one wave, as
     `generate_until` answers them, the wave's B = 2 decode held to the
     eager one and kernel 3 at its shape to its plain version. A token
     that differs from greedy must follow a near-tie of the eager logits
     (top-2 gap within `LOGITS_REL_TOL` of max|logit|);
  4c. (inside phases 4 and 7, on the model they built) the inflight
     engine (`models.inflight.InflightEngine`, 4 slots, prompt cap 128,
     gen cap 32, chunks of 16 replayed from CUDA graphs, a prompt-KV store):
     6 of phase 4's requests with staggered budgets (two join freed slots
     while the others decode, one samples), a request sharing a stored
     prompt's image and leading text (a partial hit: only its suffix is
     prefilled) and an exact repeat (a store hit: no tower pass and no
     prefill launch); every greedy request's first-token logits (kept in
     the store) against the eager prefill's (`LOGITS_REL_TOL` of
     max|logit|), and its tokens against the eager `generate_greedy` of
     that request alone (where they part, the eager logit of the engine's
     token must lie within `ENGINE_TIE_REL_TOL` plus twice its logit gap,
     of max|logit|, below the eager top; the partings are counted),
     tokens/s,
     each request's latency, captures, replays, the main run's replayed
     chunks' host ms (median and range; a run with no replay fails) apart
     from the chunks that captured a graph, and the launches of kernels
     1, 2, 3 and 10; in bf16 also `LMMServer(inflight=True)`: two
     concurrent chat completions, a `stream: true` request whose tokens
     arrive as deltas, and /health's engine counts. Every (kernel, shape)
     the engine called kernels 1, 2, 3 and 10 at, the server's engine
     included, is recorded and then held to its plain version (kernel 2
     with the block rows its launcher reports); a shape not held fails;
  14. (inside phase 4, after 4c, on its bf16 model) the eval zoo:
     `simple_evaluate` over six tasks read from their bundled YAMLs, only
     the dataset fields pointed at 4 synthetic docs each and their random
     336 px PNGs (one batch of B = 4): llava_wild (graded by a stub judge on
     127.0.0.1, set as OPENAI_API_URL for that task alone, which must get
     one rubric request a doc), olympiadbench_test_en (math equivalence)
     and mathvista_testmini (rules only), each 1,024 new tokens through the
     captured decode (64 replays of a 16-step chunk, cache T ~1,700),
     refcoco_bbox_rec_val, coco_cap and mmupd_base. Every task a finite
     aggregate of n = 4; kernels 1, 2 and 3 launched; every (kernel, shape)
     of the phase held to its plain version, kernel 3 at the long tasks' T
     among them; the first 64 tokens of the first 1,024-token batch held to
     eager `generate_greedy`'s (near-ties allowed as in 4b). Docs/s a task,
     the long decode's tokens/s and ms a step beside phase 4's at T = 735,
     the cache T, the graph captures and the peak memory are printed;
  15. (inside phase 4, after 14, on its bf16 model) the projector and
     token variants at full width: phase 4's 4 requests, 32 new tokens,
     through `generate_until` (the captured decode) with (a) a seeded
     perceiver2x projector over CLIP-L/14-336 (64 image tokens; 2 more
     kernel-2 launches an encode), (b) MoF CLIP-L/14-336 + a seeded
     DINOv2-L/14-336 with an mlp2x_gelu projector each (1,152 image
     tokens, T = 1,311) and (c) visual_keep = 144 by CLIP's CLS attention
     from block 22: finite logits, the image-token count, the captured
     tokens against eager (near-ties allowed as in 4b), the launches of
     kernels 1, 2 and 3, every kernel shape held to its plain version;
     TTFT, tokens/s and peak GB of each; then `utils.burner.burn` for 2 s
     (sustained bf16 TFLOP/s);
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
     (kernel 9, two launches a rep, all four through the wgmma body); then
     the C score: a synthetic SPair-71k test split (18 categories, 20 JPEGs
     of 300-500 px and 50 seeded pairs each, keypoints ~80 % visible and
     meeting the geo-aware groups), `extract-features` for each rep (batch
     16, bf16: kernel 1 on `encoder2` and `tpu_flash`, kernel 2 on
     `flash`, counted as the path `c_score`), `run_c_score` on the card and
     again on the CPU in fp32 over the same files (card and CPU agree
     keypoint for keypoint but for near-ties of a row's argmax, whose count
     is printed), a second extraction of the first batch bit-equal, the
     similarity's fp32 held under a process-wide TF32 switch; the leg's
     extraction images/s, `run_c_score` seconds split into host reads and
     the device part, and its peak memory; and one `fit_policy` whose C
     column holds the three reps' C scores and those of SD1.5 (phase 11),
     DiT and SD3 (phase 12);
  7. (run right after phase 4, before the first profiler session of the
     process) quantised serving at full width: LLaVA-1.5-7B through `build_lmm` with
     `model.quantize=int4` + `model.kv_quant=int8` (and the decode route
     name `pallas_stacked`, whose int8 form rides on the same branch), the 4
     requests of phase 4: kernel 10 and the int8 branch launched, the dense branch of kernel 3
     not; identical tokens over two runs; finite logits; prefill ms, decode
     tokens/s and peak memory beside phase 4's bf16 figures, the peak below
     the bf16 run's. Then the same with `model.quantize=int8`;
  8. a torch.profiler split of the decode step's device time for the three
     weight formats, the eager step and the captured chunk's step (last: the
     profiler's tracing stays attached to the process and slows every later
     launch);
  9. (after phase 7, before phase 5) MPT-7B at full width (vocab 50,432,
     d 4,096, 32 layers, 32 heads; seeded random bf16): a forward at B=2,
     S=2,048 and a forward + backward of the next-token loss; finite logits
     and gradients; the ALiBi form of kernel 2 launched 32 times a pass, of
     kernels 5 and 6 32 times each; tokens/s and peak memory;
  13. (after phase 7, before phase 11) checkpoint porting: a full-width
     CLIP-L/14-336 vision snapshot and SD1.5's CLIP-L text encoder snapshot
     (config.json and fp16 .safetensors written by this script in the
     published key names and layouts, seeded) through `python -m
     <port>.io.port_cli` (`clip_vision --image-size 336`, `clip_text`,
     `clip_text --penultimate`; three processes at once): every ported
     tensor equal to the snapshot's in the documented layout (a Linear's
     kernel its weight transposed, the patch kernel the conv weight
     `transpose(2, 3, 1, 0)`); the tower loaded as `model.tower_weights`
     loads a file, on the card (kernel 1, B=4) against the CPU fp32 tower
     (`PORT_REL_TOL`); the text encoder, whole (pooled too) and
     penultimate, on the card (kernel 2 causal, one launch a block at B=1
     S=77 H=12 D=64, each call recorded) against the CPU on the empty
     prompt's ids;
  11. (after phase 13, before phase 9) the SD1.5 representation at full
     width on seeded random weights, written as a diffusers snapshot root
     (`unet/`, `vae/` with diffusers' key names and the CLIP-L
     `text_encoder/`, fp16 .safetensors) in a temporary directory, made a
     bundle by `port-featurizer sd15 ... --device cuda:0` (its weights
     against the snapshot's, exactly: the layout and the fp16 cast, as the
     snapshot takes its key names from the port's porters, which the CPU
     tests hold to the JAX porters; its `prompt_embeds`, encoded on the
     card through kernel 2's causal form, against a CPU fp32 encode) and
     passed as `model.tower_weights`: (a)
     `extract_features` on one 768 px image, card bf16 against CPU fp32
     (`SD_FEATURE_REL_TOL`), 14 kernel-2 launches a forward, a repeat's
     bits, and the featurizer's time at B = 1, 4, 16; (b) `extract-features`
     over phase 6's synthetic SPair tree at batch 16 and `run_c_score`:
     images/s, peak memory; (c) LLaVA-1.5-7B over the tower through
     `build_lmm` -> `generate_until` on phase 4's requests with 768 px
     images, 32 new tokens: finite logits, kernels 2 (tower and prefill)
     and 3 launched, TTFT and tokens/s;
  12. (after phase 11, before phase 9) DiT-XL/2 and SD3-medium at full
     width and 4 and 3 blocks (of 28 and 24) at 512 px on seeded random
     weights, each written as a featurizer bundle (its configuration in the
     sidecar) and passed as `model.tower_weights`:
     (a) `extract_features` on one image, card bf16 against CPU fp32
     (`TRANSFORMER_FEATURE_REL_TOL`), 4 / 3 kernel-2 launches a forward
     counted by shape, a repeat's bits, the featurizer at B = 1 and 16 with
     the VAE and the backbone (`featurizer.backbone_tokens`) apart; (b)
     `extract-features` over phase 6's synthetic SPair tree at batch 16 and
     `run_c_score`: images/s, peak memory, the C scores that phase 6's fit
     takes; (c) SD3 only: LLaVA-1.5-7B over the tower (`mlp2x_gelu`
     6,144 -> 4,096, 256 image tokens) through `build_lmm` ->
     `generate_until` on phase 4's requests at 512 px, 32 new tokens:
     finite logits, kernels 2 and 3 launched, TTFT and tokens/s;
  16. (after phase 12, before phase 9) GeoAware-SC through the CLI at full
     width on seeded weights, over 12 pose templates, 4 pose targets and one
     synthetic SPair category (8 JPEGs, 6 pairs, `bndbox` annotations):
     (a) `preprocess-map` with flips (an SD1.5 bundle through up block 2 at
     960 px: 26 kernel-2 launches a forward; DINOv2-B at 840 px, the token
     facet of block 11: 12 kernel-1 launches), every launch's shape one that
     phase 2 held, one template's maps and descriptors card (bf16 compute)
     against the port's CPU fp32 (run in a second thread meanwhile); (b)
     `sam-masks --spair` from a SAM ViT-H snapshot written in HF's key names
     (config.json, fp16 .safetensors): a 960 x 960 mask and its mirror an
     image; (c) `pose-awareness` over (a)'s files and (b)'s masks at res
     128: 4 rows of 12 finite distances, n = 4; (d) `c-train --feature-dims
     640 1280 1280 768 --num-patches 60`, 10 steps of batch 4 on [3,600,
     3,968] files built from (a)'s maps: finite losses, best.npz, best_pck
     in [0, 1]. Seconds, ms an image variant / image / pair, peak memory;
  10. (after phase 9) LLaVA-1.5-7B through `run_training`, stage 2, 3 steps
     of 16: `train.lora_enable` (r=128, alpha=256), the same with
     `train.quantize_base=int4` (QLoRA: kernel 10 forward, its transposed
     form 7 x 32 + 1 times a step backward; the build's peak with the
     decoder quantised block by block) and
     `train.switch_enable`. Finite losses, no skipped step, the frozen
     weights bitwise those of a fresh build, every B non-zero (only W moved
     under switch), the saved files load back, and `load_pretrained` (which
     merges the adapters) then a prefill gives the adapted logits.

  17. (after phase 10, before phase 5) parallelism on one card: (a) the
     narrow stage-1 LLaVA, 3 steps on a mesh of one NCCL rank started by
     `parallel.init_distributed` (every collective of the sharded step
     runs), with zero 0, zero 2 with the moments offloaded and zero 3 with
     both offloads, each against the same step without a process group
     from the same weights (losses, grad norms, every parameter; the
     largest difference printed beside a 1e-6 relative tolerance); (b) full
     stage 2 of LLaVA-1.5-7B at B = 16, S = 703 with `offload_opt_state`
     (the AdamW moments in pinned host memory, streamed leaf by leaf), 2
     steps through `init_sharded_train_state` / `make_train_step`: step
     ms, optimizer-pass ms, the moments' host-to-device and device-to-host
     copy ms, the host link's GB/s each way and both at once (4 GiB of the
     pinned moments), peak allocated GB (< 80), pinned host GB, MemTotal, finite
     losses, the frozen tower bitwise unchanged, kernels 1, 2, 5 and 6
     launched 23 / 64 / 32 / 32 a step; (c) the same with `offload_params`:
     the GB held on the card between steps (< 1); (d) full width at 4
     decoder layers, both offloads against none from the same seed: every
     parameter after 2 steps within 1e-6 of max|p|.
     `python3 chip_smoke.py --parallel` runs the build and this phase alone.
  18. context and pipeline parallelism on one card: (a) (after phase 17)
     the flash ring (`ops/ring_attention.py`'s `RingFlashAttention`:
     kernel 2 a block, the partials merged by their LSEs, kernels 5 and 6 a
     block with the merged LSE and output) over a `LocalRing` of 4 ranks in
     this process, 4 shards of 1,024 of
     B = 2, S = 4,096, H = 32, D = 128 (KV = 32, and GQA KV = 8), bf16, row
     1 valid to 3,500: out, LSE, dq, dk, dv against kernel 2 causal and
     kernels 5 + 6 over the whole sequence, kv head 0 against the plain
     ring (fp32, the key mask) at valid rows, 10 launches of each kernel a
     case, the ring's ms beside the whole sequence's; (b) (inside phase 5,
     on its model and first batch, before the profiler) `loss_fn(pp=...)`:
     4 stages of 8 layers, 4 microbatches, block remat, the flash route,
     all stages in this process through `LocalHandoff`, against
     the unpipelined `loss_fn`: the loss, the gradients of the projector
     and of each stage's first layer, kernels 2 / 5 / 6 launched 256 / 128
     / 128 times (kernel 2 forward and recompute) against 64 / 32 / 32, both
     step times. `python3 chip_smoke.py --context-pipeline` runs the build
     and this phase alone (building phase 5's model for (b)).

TF32 is switched off (`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`) so every plain version runs in
full fp32. Every metric line carries the card's name and power limit, and
each phase prints its seconds.
The last lines are the kernels JSON, the card line from nvidia-smi and
`{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import glob
import hashlib
import itertools
import json
import math
import os
import statistics
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
# δ = rowsum(dO·O) as kernel 5 forms it against the same sum in fp32 by
# PyTorch: fp32 sums of D products in another order
DELTA_REL_TOL = 1e-4
# a gradient row's own max|plain| is its scale, but never less than this
# share of the tensor's: the dq of a query that sees one key is dP − δ = 0
# up to rounding, a row with no scale of its own
GRAD_ROW_FLOOR = 1e-3
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
H100_TF32_TFLOPS = 495.0        # dense TF32 on the tensor cores
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
# kernel 10 vs its plain version: both sum exact bf16 x integer products in
# fp32 (in another order) and round the result to bf16; two results that
# straddle a rounding boundary differ by one bf16 ulp, 2^-7 of the value:
# 2 ulps of the largest output
INT4_REL_TOL = 2.0 ** -6
L2_BYTES = 50e6                 # rotate over more than twice this
# the serving runs: phase 4, then phase 7's two (the route name
# `pallas_stacked` rides on the int4 run: its int8 form is the same branch)
SERVING_FORMATS = ({}, {"quantize": "int4", "kv_quant": "int8",
                        "decode_attn": "pallas_stacked"},
                   {"quantize": "int8"})
# phase 4b: the serving backends on phase 4's and 7's LLaVA. 32 new tokens
# (phase 4's) are two chunks of 16, so the graph path's cache (l_out +
# gen_cap slots) has the eager path's T, on which kernel 3's split depends
DECODE_CHUNK = 16
DRAFT_LEN = 8
BEAMS = 2
SAMPLING = {"temperature": 0.7, "top_p": 0.9}
SAMPLE_SEED = 1234
# phase 4c: the inflight engine on phase 4's and 7's LLaVA. The v1
# template makes phase 4's prompts 57-77 tokens, so the prompt cap is 128
# (t_max = 128 + 575 + 32 = 735 slots a row); the budgets stagger the
# requests' ends, so that the fifth and sixth join freed slots while the
# others decode; request 5 samples
INFLIGHT = dict(n_slots=4, prompt_cap=128, gen_cap=32, chunk=DECODE_CHUNK)
INFLIGHT_BUDGETS = (8, 16, 32, 24, 32, 32)
INFLIGHT_SAMPLED = 5
INFLIGHT_BLOCK = 32             # the store's partial-prefix granularity
# where an engine's greedy tokens part from the eager decode of the request
# alone, the eager logit of the token the engine chose must lie within
# ENGINE_TIE_REL_TOL + 2 d of max|logit| below the eager top. d is the
# largest gap between the engine's and the eager prefill's first-token
# logits of that request (held to LOGITS_REL_TOL): its cache carries that
# difference, and two routes d apart rank two tokens apart only at a gap
# under 2 d. ENGINE_TIE_REL_TOL covers what the decode steps add: eight
# bf16 ulps of max|logit| at the least (an ulp is 2^-8 to 2^-7 of it). On
# an H100 (700 W) the partings of requests whose first-token logits were
# equal to the eager ones (d = 0) lay at 0 to three ulps (up to 1.78e-2 in
# int4 + kv8), so a bound of 1e-2 failed correct runs. The bound is on the
# eager logit of the engine's own token: a faulty engine's token (a wrong
# slot, position or stale graph input) is the top of other logits and lies
# about max|logit| below the eager top, not a few ulps. No share of
# partings is bounded: up to 7 of 7 greedy requests parted, all at ties
ENGINE_TIE_REL_TOL = 2 ** -4
LAW_IMAGES = 100                # the A-score protocol's image count
LAW_HIDDEN = 4096               # the LLM width the embeddings live in
LAW_EVAL_LIMIT = 8
# phase 6's C-score leg: a synthetic SPair-71k test split of 18 categories,
# C_IMAGES images and C_PAIRS pairs a category (900 pairs, ~7 % of SPair's
# 12,234), features extracted at batch C_BATCH
C_IMAGES = 20
C_PAIRS = 50
C_BATCH = 16
C_ANNO = 840                    # the SPair canvas `run_c_score` defaults to
# a keypoint whose correctness differs between the card and the CPU must sit
# on a near-tie of its source row's argmax (the centre of its window): the
# top two similarities of that row closer than this on the CPU
C_NEAR_TIE = 1e-5
# PCK aggregates of the same correctness, card against CPU: fp32 sums of at
# most a few hundred terms in another order
C_AGG_TOL = 1e-6
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


def row_err(got, ref) -> float:
    """The worst error of one attention output row (a query of one head,
    over D) relative to that row's own max|plain|, to hold against
    KERNEL_REL_TOL: late causal rows average hundreds of keys and are small
    beside row 0 (its output is v_0), so a dropped or doubled key tile would
    hide under a tolerance taken from the whole tensor's max."""
    import torch
    diff = (got.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    return (diff / scale.clamp_min(torch.finfo(torch.float32).tiny)).max(
    ).item()


def grad_row_err(got, ref) -> float:
    """`row_err` for a gradient: each row (a query's dq, a key's dk or dv of
    one head, over D) relative to its own max|plain|, floored at
    GRAD_ROW_FLOOR of the tensor's max|plain|."""
    diff = (got.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    floor = GRAD_ROW_FLOOR * max(scale.max().item(), 1e-30)
    return (diff / scale.clamp_min(floor)).max().item()


def check_bwd_outputs(name: str, got: tuple, ref: tuple) -> dict:
    """dq, dk, dv of kernels 5 and 6 against the plain backward: the whole
    tensor (KERNEL_REL_TOL of max|plain|) and row by row (`grad_row_err`).
    Returns {n: (err, tol, row_err)}."""
    e = {}
    for n, g, r in zip(("dq", "dk", "dv"), got, ref):
        err, tol, rows = max_err(g, r), kernel_tol(r), grad_row_err(g, r)
        e[n] = (err, tol, rows)
        if not (err <= tol and rows <= KERNEL_REL_TOL):
            fail(f"kernel {'5' if n == 'dq' else '6'} {n} disagrees with the "
                 f"plain backward at {name}: {err} (tol {tol}), worst row "
                 f"{rows} (tol {KERNEL_REL_TOL})")
    return e


def check_delta(name: str, delta, out, do) -> float:
    """δ as kernel 5 wrote it against rowsum(dO·O) in fp32."""
    ref = (do.float() * out.float()).sum(-1).transpose(1, 2)
    err = max_err(delta, ref)
    tol = DELTA_REL_TOL * max(1.0, ref.abs().max().item())
    if not err <= tol:
        fail(f"kernel 5's δ disagrees with rowsum(dO·O) at {name}: {err} > "
             f"{tol}")
    return err


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
    got = enc.encoder_attention(q, k, v)
    results["encoder_attention"] = dict(
        err=max_err(got, ref), tol=kernel_tol(ref), row_err=row_err(got, ref),
        ms=graph_ms(lambda: enc.encoder_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: enc.encoder_attention_plain(q, k, v)),
        library_ms=graph_ms(lambda: sdpa(q, k, v)), library_err=lib_err,
        shape=f"B={b} S={s} H={h} D={d}",
        **bound(4 * q.numel() * 2, 4 * b * h * s * s * d, H100_BF16_TFLOPS))
    same_bits("encoder_attention", lambda: enc.encoder_attention(q, k, v))
    # the one-image calls of the embedding dumps (64-row blocks)
    results["encoder_attention"]["cases"] = [
        attention_case(tag, enc.encoder_attention,
                       enc.encoder_attention_plain,
                       lambda q, k, v: sdpa(q, k, v),
                       (randn(1, s, h, d) for _ in range(3)),
                       s * s, f"kernel 1 B=1 S={s} H={h} D={d}")
        for s in (577, 257)]
    # GeoAware's DINOv2-B at 840 px (phase 16)
    b1, s1, h1, d1 = GEO_DINO_ATTENTION
    results["encoder_attention"]["cases"].append(dict(attention_case(
        tag, enc.encoder_attention, enc.encoder_attention_plain,
        lambda q, k, v: sdpa(q, k, v),
        (randn(b1, s1, h1, d1) for _ in range(3)), s1 * s1,
        f"kernel 1 DINOv2-B@840 B={b1} S={s1} H={h1} D={d1}"),
        what="GeoAware DINOv2-B@840"))

    # prefill: Vicuna-7B heads, S=640 with a kv_len tail; plus a GQA case
    errs, tols, rows = [], [], []
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
        rows.append(row_err(out, ref))
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
            same_bits("flash_attention", lambda: fl.flash_attention(
                q, k, v, causal=True, kv_len=kv_len, return_lse=True))
    results["flash_attention"] = dict(
        err=max(errs), tol=min(tols), row_err=max(rows), ms=ms,
        plain_ms=plain_ms, library_ms=library_ms, library_err=lib_err,
        shape="B=4 S=640 kv_len=600 H=KV=32 D=128 causal (+ GQA KV=8)", **bnd)
    # a stage-1 step's launch and MPT-7B's without the bias
    del q, k, v, got, out, lse, ref, ref_lse, kc, vc
    results["flash_attention"]["cases"] = [
        attention_case(
            tag, lambda q, k, v: fl.flash_attention(q, k, v, causal=True,
                                                    return_lse=True),
            lambda q, k, v: fl.flash_attention_plain(q, k, v, causal=True,
                                                     return_lse=True),
            lambda q, k, v: sdpa(q, k, v, is_causal=True),
            (randn(b, s, 32, 128) for _ in range(3)), s * (s + 1) // 2,
            f"kernel 2 B={b} S={s} H=KV=32 D=128 causal")
        for b, s in ((16, 639), (2, 2048))]

    # decode: Vicuna-7B cache, T=704, holes + one fully masked 128-slot
    # tile; cold over caches in turn, and warm
    b, t, h, d = 4, 704, 32, 128
    q = randn(b, 1, h, d)
    mask = torch.rand(b, t, generator=g, device=dev) < 0.8
    mask[:, 256:384] = False
    mask[:, 0] = True
    caches = rotating(lambda: (randn(b, t, h, d), randn(b, t, h, d)),
                      2 * b * t * h * d * 2)
    visible = int(mask.sum().item())
    results["decode_attention"] = dict(
        time_decode("decode_attention", q, caches, mask,
                    lambda c: sdpa(q, c[0], c[1],
                                   attn_mask=mask[:, None, None, :])),
        shape=f"B={b} T={t} H=KV={h} Dh={d}, holes + masked 128-slot tile "
              f"({visible} of {b * t} slots visible)",
        # only the visible slots' K and V rows have to be read
        **bound(2 * visible * h * d * 2 + mask.numel() + 2 * q.numel() * 2,
                4 * visible * h * d, H100_BF16_TFLOPS))
    del caches

    for name, r in results.items():
        report_kernel(tag, name, r)
        if not r["library_err"] <= r["tol"]:
            fail(f"the library yardstick of {name} computes another "
                 f"function: err {r['library_err']}")
    return results


def time_decode(name: str, q, caches: list, mask, library) -> dict:
    """Kernel 3 on `caches` (tuples of its cache arguments: k, v and, for
    the int8 branch, k_scale, v_scale), each held to the plain version and a
    repeat to the same bits. `ms` is cold: the caches in turn (`rotating`),
    so each launch reads HBM as a decode step that walks 32 layers does;
    `warm_ms` the first cache alone, in L2 (the figure PRs 1-10 kept). The
    SDPA yardstick `library(cache)` is timed both ways too."""
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec)

    def kernel(c):
        return dec.decode_attention(q, c[0], c[1], mask, *c[2:])

    def plain(c):
        return dec.decode_attention_plain(q, c[0], c[1], mask, *c[2:])
    errs, tols, lib_errs = [], [], []
    for c in (caches[0], caches[-1]):
        ref = plain(c)
        errs.append(max_err(kernel(c), ref))
        tols.append(kernel_tol(ref))
        lib_errs.append(max_err(library(c), ref))
        same_bits(name, lambda: kernel(c))
    turn, lib_turn = itertools.cycle(caches), itertools.cycle(caches)
    return dict(err=max(errs), tol=min(tols), library_err=max(lib_errs),
                ms=graph_ms(lambda: kernel(next(turn))),
                warm_ms=graph_ms(lambda: kernel(caches[0])),
                plain_ms=cuda_ms(lambda: plain(caches[0])),
                library_ms=graph_ms(lambda: library(next(lib_turn))),
                library_warm_ms=graph_ms(lambda: library(caches[0])),
                caches=len(caches))


def same_bits(name: str, fn) -> None:
    """A kernel's second run on the same inputs gives the same bits."""
    import torch
    first, second = fn(), fn()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        fail(f"{name}: a repeat on the same inputs gave other bits")


def attention_case(tag: str, kernel, plain, library, qkv, pairs: int,
                   shape: str) -> dict:
    """One more shape of an attention kernel: held to its plain version row
    by row (and by its LSE where `kernel` and `plain` return (O, LSE)) and
    to a repeat of itself, then timed (under a CUDA graph) beside the plain
    version, the library call and the bound (`pairs`: the visible
    query-key pairs of one head; bytes: Q and O, K and V once each)."""
    q, k, v = qkv
    ref, got = plain(q, k, v), kernel(q, k, v)
    lse_bytes, lse_note = 0, ""
    if isinstance(ref, tuple):
        (ref, ref_lse), (got, lse) = ref, got
        e_lse = max_err(lse, ref_lse)
        if not e_lse <= LSE_TOL:
            fail(f"attention at {shape}: LSE err {e_lse} > {LSE_TOL}")
        lse_bytes = lse.numel() * 4
        lse_note = f", LSE max_abs_err {e_lse:.3e} (tol {LSE_TOL})"
    err, tol = max_err(got, ref), kernel_tol(ref)
    rows, lib_rows = row_err(got, ref), row_err(library(q, k, v), ref)
    if not (rows <= KERNEL_REL_TOL and lib_rows <= KERNEL_REL_TOL):
        fail(f"attention at {shape}: worst row error over the row's "
             f"max|plain|: kernel {rows}, library {lib_rows} > "
             f"{KERNEL_REL_TOL}")
    same_bits(shape, lambda: kernel(q, k, v))
    b, _, h, d = q.shape
    case = dict(shape=shape, err=err, tol=tol, row_err=rows,
                ms=graph_ms(lambda: kernel(q, k, v)),
                plain_ms=cuda_ms(lambda: plain(q, k, v), iters=5),
                library_ms=graph_ms(lambda: library(q, k, v)),
                **bound((2 * q.numel() + 2 * k.numel()) * 2 + lse_bytes,
                        4 * d * pairs * b * h, H100_BF16_TFLOPS))
    print(f"{tag} {shape}: max_abs_err {err:.3e} (tol {tol:.3e}), worst row "
          f"{rows:.3e} of its max|plain| (tol {KERNEL_REL_TOL}){lse_note}, "
          f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
          f"library {case['library_ms']:.4f} ms, bound "
          f"{case['bound_ms']:.4f} ms by {case['bound_by']} "
          f"({case['bound_ms'] / case['ms']:.1%} of it reached)")
    return case


def report_kernel(tag: str, name: str, r: dict) -> None:
    lib = ("no single PyTorch call" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms")
    print(f"{tag} kernel {name} [{r['shape']}]: max_abs_err {r['err']:.3e} "
          f"(tol {r['tol']:.3e}), kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.4f} ms, library {lib}, bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} "
          f"({r['bound_ms'] / r['ms']:.1%} of it reached)")
    if "warm_ms" in r:
        print(f"{tag} kernel {name}: those are cold, over {r['caches']} "
              f"caches in turn; warm (one cache, in L2) kernel "
              f"{r['warm_ms']:.4f} ms, library {r['library_warm_ms']:.4f} "
              f"ms")
    if not r["err"] <= r["tol"]:
        fail(f"{name} disagrees with its plain version: {r['err']}")
    if "row_err" in r:
        print(f"{tag} kernel {name}: worst row error {r['row_err']:.3e} of "
              f"the row's max|plain| (tol {KERNEL_REL_TOL})")
        if not r["row_err"] <= KERNEL_REL_TOL:
            fail(f"{name} disagrees with its plain version in a row: "
                 f"{r['row_err']}")


# the fused backends of `scaled_dot_product_attention`, each of which the
# library backward can be pinned to (`torch.nn.attention.SDPBackend`)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_backend(out) -> str:
    """The backend that `scaled_dot_product_attention` ran for `out`: the
    name of its autograd node (e.g. `ScaledDotProductFlashAttentionBackward0`;
    the math backend has none)."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__.startswith("ScaledDotProduct"):
            return type(fn).__name__
        todo += [f for f, _ in fn.next_functions]
    return "math (no fused node)"


def library_bwd(q, k, v, do, backend: str | None = None, **kw):
    """The library's backward of the same function: one autograd call of
    `scaled_dot_product_attention` that gives dq, dk and dv together (its
    own GQA where K and V have fewer heads), on the backend PyTorch picks or
    on `backend` (one of `SDPA_BACKENDS`; raises RuntimeError where it
    cannot run). Returns (run, grads, ran): `run()` repeats that one
    backward call, `ran` names the backend that ran (`sdpa_backend`)."""
    import contextlib
    import torch
    if q.shape[2] != k.shape[2]:
        kw = dict(kw, enable_gqa=True)
    pin = contextlib.nullcontext()
    if backend is not None:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        pin = sdpa_kernel([getattr(SDPBackend, backend)])
    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    with pin:
        lib_out = sdpa(ql, kl, vl, **kw)
    grads = torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True)

    def run():
        return torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                   retain_graph=True)
    return run, grads, sdpa_backend(lib_out)


# pairs of turns of the whole backward call and the library's at B=2 S=2048
BWD_PAIRS = 4


def whole_bwd_turns(whole, lib) -> tuple:
    """The whole backward call (`flash_attention_bwd`: kernel 5 with δ, then
    kernel 6) and the library's backward, in turns on one card: whole,
    library, library, whole. Returns their mean times."""
    w0, l0 = cuda_ms(whole), cuda_ms(lib)
    l1, w1 = cuda_ms(lib), cuda_ms(whole)
    return (w0 + w1) / 2, (l0 + l1) / 2


def check_flash_bwd(tag: str, dev) -> dict:
    """Phase 2, training kernels: 5 (dq, forming δ) and 6 (dk/dv) against
    the plain backward on the same bf16 inputs and saved output/LSE (kernel
    2's), at the stage-1 step's shape (S=639), the stage-2 steps' (S=703:
    LoRA, QLoRA, switch), a GQA case and a ragged S: every tensor and every
    row of dq, dk and dv (`check_bwd_outputs`), δ against rowsum(dO·O), and
    a repeat of the whole backward call that must give the same bits.
    Kernel 2's causal forward and LSE are held to their plain version at
    each of these shapes too. Timed: each kernel, and the whole backward
    call in turns with the library's backward (MHA and GQA)."""
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
                             (16, 703, 32, False), (16, 100, 32, False)):
        q, do = randn(b, s, 32, 128), randn(b, s, 32, 128)
        k, v = randn(b, s, kvh, 128), randn(b, s, kvh, 128)
        out, lse = fl.flash_attention(q, k, v, causal=True, return_lse=True)
        ro, rl = fl.flash_attention_plain(q, k, v, causal=True,
                                          return_lse=True)
        e_out, e_lse = max_err(out, ro), max_err(lse, rl)
        print(f"{tag} kernel 2 [B={b} S={s} H=32 KV={kvh} D=128 causal]: "
              f"max_abs_err {e_out:.3e} (tol {kernel_tol(ro):.3e}), LSE "
              f"{e_lse:.3e} (tol {LSE_TOL})")
        if not (e_out <= kernel_tol(ro) and e_lse <= LSE_TOL):
            fail(f"kernel 2 disagrees with its plain version at B={b} "
                 f"S={s} KV={kvh}: out {e_out}, LSE {e_lse}")
        del ro, rl
        case = f"B={b} S={s} H=32 KV={kvh} D=128 causal"
        args = (q, k, v, out, lse, do)
        dq, delta = fl.flash_attention_bwd_dq(*args, causal=True,
                                              return_delta=True)
        e_delta = check_delta(case, delta, out, do)
        dk, dv = fl.flash_attention_bwd_dkv(*args, delta, causal=True)
        refs = fl.flash_attention_bwd_plain(*args, causal=True)
        e = check_bwd_outputs(case, (dq, dk, dv), refs)
        whole = lambda: fl.flash_attention_bwd(*args, causal=True)
        if not all(torch.equal(a, r) for a, r in zip(whole(), (dq, dk, dv))):
            fail(f"kernels 5/6 at {case}: a repeat of the whole backward "
                 f"gave other bits")
        print(f"{tag} kernels 5/6 [{case}]: " + ", ".join(
            f"{n} max_abs_err {err:.3e} (tol {tol:.3e}, max|plain| "
            f"{tol / KERNEL_REL_TOL:.3e}), worst row {rows:.3e} of its "
            f"max|plain| (tol {KERNEL_REL_TOL})"
            for n, (err, tol, rows) in e.items())
            + f"; δ max_abs_err {e_delta:.3e}; a repeat gave the same bits")
        errs["flash_attention_bwd_dq"].append(e["dq"])
        errs["flash_attention_bwd_dkv"] += [e["dk"], e["dv"]]
        if timed:
            lib, lib_grads, backend = library_bwd(q, k, v, do,
                                                  is_causal=True)
            for n, got, ref in zip(("dq", "dk", "dv"), lib_grads, refs):
                if not max_err(got, ref) <= kernel_tol(ref):
                    fail(f"the library backward's {n} computes another "
                         f"function")
            del lib_grads
            t = dict(
                dq=cuda_ms(lambda: fl.flash_attention_bwd_dq(*args,
                                                             causal=True)),
                dkv=cuda_ms(lambda: fl.flash_attention_bwd_dkv(
                    *args, delta, causal=True)),
                plain=cuda_ms(lambda: fl.flash_attention_bwd_plain(
                    *args, causal=True), iters=5),
                fwd=cuda_ms(lambda: fl.flash_attention(q, k, v,
                                                       causal=True)))
            t["whole"], t["library"] = whole_bwd_turns(whole, lib)
            t["library_backend"] = backend
            del lib
            print(f"{tag} kernels 5/6 [{case}]: kernel 5 (forming δ) "
                  f"{t['dq']:.4f} ms, kernel 6 {t['dkv']:.4f} ms; the whole "
                  f"backward call (kernels 5 and 6) {t['whole']:.4f} ms "
                  f"against the library's backward (dq, dk, dv together; "
                  f"{backend}) {t['library']:.4f} ms in the same turns (x"
                  f"{t['whole'] / t['library']:.3f}); plain backward "
                  f"{t['plain']:.4f} ms; kernel 2 forward {t['fwd']:.4f} ms")
            times.setdefault("t", t)          # the MHA case is reported
        del q, k, v, do, out, lse, delta, dq, dk, dv, refs, args, whole
    shape = ("B=16 S=639 H=KV=32 D=128 causal (+ GQA KV=8, S=703, ragged "
             "S=100)")
    t = times["t"]
    # causal pairs of one head; recomputed S and dP, then dQ (kernel 5) or
    # dV and dK (kernel 6): 3 and 4 products of 2*D flops a pair. Bytes:
    # kernel 5 reads q, k, v, O, dO and the LSE and writes dq and δ; kernel
    # 6 reads q, k, v, dO, the LSE and δ and writes dk and dv (bf16 tensors,
    # fp32 LSE and δ).
    b, s, h, d = 16, 639, 32, 128
    pairs, tensor, stats = s * (s + 1) // 2, b * s * h * d * 2, b * h * s * 4
    bounds = {
        "flash_attention_bwd_dq": bound(6 * tensor + 2 * stats,
                                        6 * d * pairs * b * h,
                                        H100_BF16_TFLOPS),
        "flash_attention_bwd_dkv": bound(6 * tensor + 2 * stats,
                                         8 * d * pairs * b * h,
                                         H100_BF16_TFLOPS)}
    results = {name: dict(err=max(e[0] for e in errs[name]),
                          tol=min(e[1] for e in errs[name]),
                          row_err=max(e[2] for e in errs[name]),
                          ms=t["dq" if name.endswith("dq") else "dkv"],
                          whole_ms=t["whole"], plain_ms=t["plain"],
                          library_ms=t["library"],
                          library_backend=t["library_backend"], shape=shape,
                          **bounds[name])
               for name in errs}
    for name, r in results.items():
        print(f"{tag} kernel {name}: bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']} ({r['bound_ms'] / r['ms']:.1%} of it "
              f"reached); the library's one backward call does the work of "
              f"kernels 5 and 6 together")
    return results


# the perceiver projector's attention (phase 15 (a), phase 3's narrow
# perceiver): 64 latents over [576 CLIP-L/14-336 patches; 64 latents],
# 8 heads of 64, non-causal; B = 4 serves, B = 16 is a stage-1 step
PERCEIVER_ATTENTION = dict(sq=64, skv=640, h=8, d=64)


def perceiver_key(b: int) -> str:
    a = PERCEIVER_ATTENTION
    return (f"kernel 2 B={b} Sq={a['sq']} Skv={a['skv']} H={a['h']} "
            f"D={a['d']} non-causal (perceiver)")


def check_perceiver_attention(tag: str, dev) -> tuple:
    """Phase 2, the perceiver's attention: kernel 2 non-causal at Sq = 64,
    Skv = 640 (B = 4 and 16), each with its LSE, a repeat's bits, SDPA and
    its bound (`attention_case`); then its stage-1 backward at B = 16:
    kernel 5 forming δ, then kernel 6 (Sq != Skv, non-causal), every row of
    dq, dk, dv held (`check_bwd_outputs`), δ against rowsum(dO·O), a repeat
    of the whole backward call to the same bits, each kernel timed, and the
    whole call in turns with SDPA's backward. Returns (the forward cases,
    kernel 5's case, kernel 6's case)."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)

    g = torch.Generator(device=dev).manual_seed(64)
    a = PERCEIVER_ATTENTION
    sq, skv, h, d = a["sq"], a["skv"], a["h"], a["d"]

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    fwd = [attention_case(
        tag, lambda q, k, v: fl.flash_attention(q, k, v, return_lse=True),
        lambda q, k, v: fl.flash_attention_plain(q, k, v, return_lse=True),
        lambda q, k, v: sdpa(q, k, v),
        (randn(b, sq, h, d), randn(b, skv, h, d), randn(b, skv, h, d)),
        sq * skv, perceiver_key(b)) for b in (4, 16)]

    b = 16
    q, k, v, do = (randn(b, sq, h, d), randn(b, skv, h, d),
                   randn(b, skv, h, d), randn(b, sq, h, d))
    out, lse = fl.flash_attention(q, k, v, return_lse=True)
    args = (q, k, v, out, lse, do)
    case = f"B={b} Sq={sq} Skv={skv} H={h} D={d} non-causal (perceiver)"
    dq, delta = fl.flash_attention_bwd_dq(*args, return_delta=True)
    e_delta = check_delta(case, delta, out, do)
    dk, dv = fl.flash_attention_bwd_dkv(*args, delta)
    refs = fl.flash_attention_bwd_plain(*args)
    e = check_bwd_outputs(case, (dq, dk, dv), refs)

    def whole():
        return fl.flash_attention_bwd(*args)
    if not all(torch.equal(x, r) for x, r in zip(whole(), (dq, dk, dv))):
        fail(f"kernels 5/6 at {case}: a repeat of the whole backward gave "
             f"other bits")
    lib, lib_grads, backend = library_bwd(q, k, v, do)
    for n, got, ref in zip(("dq", "dk", "dv"), lib_grads, refs):
        if not max_err(got, ref) <= kernel_tol(ref):
            fail(f"the library backward's {n} computes another function at "
                 f"{case}")
    t = dict(dq=cuda_ms(lambda: fl.flash_attention_bwd_dq(*args)),
             dkv=cuda_ms(lambda: fl.flash_attention_bwd_dkv(*args, delta)),
             plain=cuda_ms(lambda: fl.flash_attention_bwd_plain(*args),
                           iters=5))
    t["whole"], t["library"] = whole_bwd_turns(whole, lib)
    pairs = sq * skv
    q_bytes, kv_bytes = q.numel() * 2, k.numel() * 2
    stats = b * h * sq * 4
    bounds = (bound(4 * q_bytes + 2 * kv_bytes + 2 * stats,
                    6 * d * pairs * b * h, H100_BF16_TFLOPS),
              bound(2 * q_bytes + 4 * kv_bytes + 2 * stats,
                    8 * d * pairs * b * h, H100_BF16_TFLOPS))
    cases = []
    for name, ms, errs, bnd in (("dq", t["dq"], [e["dq"]], bounds[0]),
                                ("dkv", t["dkv"], [e["dk"], e["dv"]],
                                 bounds[1])):
        cases.append(dict(shape=case, err=max(x[0] for x in errs),
                          tol=min(x[1] for x in errs),
                          row_err=max(x[2] for x in errs), ms=ms,
                          whole_ms=t["whole"], plain_ms=t["plain"],
                          library_ms=t["library"], library_backend=backend,
                          delta_err=e_delta, **bnd))
    print(f"{tag} kernels 5/6 [{case}]: " + ", ".join(
        f"{n} max_abs_err {err:.3e} (tol {tol:.3e}), worst row {rows:.3e} "
        f"of its max|plain| (tol {KERNEL_REL_TOL})"
        for n, (err, tol, rows) in e.items())
        + f"; δ max_abs_err {e_delta:.3e}; a repeat gave the same bits; "
        f"kernel 5 (forming δ) {t['dq']:.4f} ms (bound "
        f"{bounds[0]['bound_ms']:.4f} ms by {bounds[0]['bound_by']}), "
        f"kernel 6 {t['dkv']:.4f} ms (bound {bounds[1]['bound_ms']:.4f} ms "
        f"by {bounds[1]['bound_by']}); the whole backward call "
        f"{t['whole']:.4f} ms against the library's backward ({backend}) "
        f"{t['library']:.4f} ms in the same turns (x"
        f"{t['whole'] / t['library']:.3f}); plain backward "
        f"{t['plain']:.4f} ms")
    return fwd, cases[0], cases[1]


def reset_counts(counters: dict) -> None:
    """`counters` maps a kernel's name to (wrapper, attribute): the wrapper's
    own count of its launches (`launches`), or of those among them that ran
    its ALiBi instantiation (`alibi_launches`)."""
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)


def read_counts(counters: dict) -> dict:
    return {name: getattr(wrapper, attr)
            for name, (wrapper, attr) in counters.items()}


def check_flash_alibi(tag: str, dev) -> dict:
    """Phase 2, kernels 2, 5 and 6 with the in-kernel ALiBi bias against
    their plain versions (materialised bias) in bf16: MPT-7B's shape (B=2,
    S=2,048, H=32, D=128, causal), a ragged S, H=6 at D=64 (interleaved
    slopes), a GQA case with a kv_len tail, and the LSE of each. At MPT-7B's
    shape: the ALiBi and the non-ALiBi instantiations timed in turns (what
    the term costs), the bound, and the library yardstick: one
    `scaled_dot_product_attention` call with the materialised bias and the
    causal mask as `attn_mask`, and its backward."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models.mpt import (
        alibi_slopes)
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)

    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    names = ("flash_attention_alibi", "flash_attention_bwd_dq_alibi",
             "flash_attention_bwd_dkv_alibi")
    errs = {n: [] for n in names}
    t = {}
    for b, s, h, kvh, d, kv_len, timed in (
            (2, 2048, 32, 32, 128, None, True), (2, 333, 8, 8, 128, None, False),
            (2, 190, 6, 6, 64, None, False), (2, 190, 8, 2, 128, 150, False)):
        q, do = randn(b, s, h, d), randn(b, s, h, d)
        k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
        slopes = alibi_slopes(h, device=dev)
        kw = dict(causal=True, kv_len=kv_len, alibi_slopes=slopes)
        out, lse = fl.flash_attention(q, k, v, return_lse=True, **kw)
        ref, ref_lse = fl.flash_attention_plain(q, k, v, return_lse=True,
                                                **kw)
        e_lse = max_err(lse, ref_lse)
        case = (f"B={b} S={s} H={h} KV={kvh} D={d} causal ALiBi"
                + (f" kv_len={kv_len}" if kv_len else ""))
        args = (q, k, v, out, lse, do)
        dq, delta = fl.flash_attention_bwd_dq(*args, return_delta=True, **kw)
        e_delta = check_delta(case, delta, out, do)
        dk, dv = fl.flash_attention_bwd_dkv(*args, delta, **kw)
        rq, rk, rv = fl.flash_attention_bwd_plain(*args, **kw)
        e = {"out": (max_err(out, ref), kernel_tol(ref),
                     row_err(out, ref))}
        e.update(check_bwd_outputs(case, (dq, dk, dv), (rq, rk, rv)))
        if not all(torch.equal(x, y) for x, y in zip(
                fl.flash_attention_bwd(*args, **kw), (dq, dk, dv))):
            fail(f"kernels 5/6 at {case}: a repeat of the whole backward "
                 f"gave other bits")
        print(f"{tag} kernels 2/5/6 [{case}]: " + ", ".join(
            f"{n} max_abs_err {err:.3e} (tol {tol:.3e}), worst row "
            f"{rows:.3e}" for n, (err, tol, rows) in e.items())
            + f" (row tol {KERNEL_REL_TOL}), LSE max_abs_err {e_lse:.3e} "
              f"(tol {LSE_TOL}; LSE down to {ref_lse.min().item():.1f}), δ "
              f"max_abs_err {e_delta:.3e}; a repeat of the backward gave "
              f"the same bits")
        if e_lse > LSE_TOL:
            fail(f"flash_attention ALiBi LSE err {e_lse} > {LSE_TOL} at "
                 f"{case}")
        err, tol, rows = e["out"]
        if not (err <= tol and rows <= KERNEL_REL_TOL):
            fail(f"ALiBi out disagrees with the plain version at {case}: "
                 f"{err} > {tol} or worst row {rows}")
        # the bias is really in the kernels: without it they give another
        # result
        if max_err(fl.flash_attention(q, k, v, causal=True, kv_len=kv_len),
                   ref) <= e["out"][1]:
            fail(f"the ALiBi bias changes nothing at {case}")
        errs[names[0]].append(e["out"])
        errs[names[1]].append(e["dq"])
        errs[names[2]] += [e["dk"], e["dv"]]
        if not timed:
            continue
        nokw = dict(causal=True)
        out0, lse0 = fl.flash_attention(q, k, v, return_lse=True, **nokw)
        args0 = (q, k, v, out0, lse0, do)
        _, delta0 = fl.flash_attention_bwd_dq(*args0, return_delta=True,
                                              **nokw)
        runs = {
            "fwd": (lambda: fl.flash_attention(q, k, v, **kw),
                    lambda: fl.flash_attention(q, k, v, **nokw)),
            "dq": (lambda: fl.flash_attention_bwd_dq(*args, **kw),
                   lambda: fl.flash_attention_bwd_dq(*args0, **nokw)),
            "dkv": (lambda: fl.flash_attention_bwd_dkv(*args, delta, **kw),
                    lambda: fl.flash_attention_bwd_dkv(*args0, delta0,
                                                       **nokw))}
        for name, (with_bias, without) in runs.items():
            # in turns on one card: without, with, with, without
            a0, b0 = graph_ms(without, 10, 5), graph_ms(with_bias, 10, 5)
            b1, a1 = graph_ms(with_bias, 10, 5), graph_ms(without, 10, 5)
            t[name], t[name + "_nobias"] = (b0 + b1) / 2, (a0 + a1) / 2
        # the whole backward call against the library's backward in the
        # same turns: without the bias (SDPA's causal backward), then with
        # it (below, SDPA with the bias as `attn_mask`)
        refs0 = fl.flash_attention_bwd_plain(*args0, **nokw)
        whole0 = lambda: fl.flash_attention_bwd(*args0, **nokw)
        lib0, lib0_grads, t["lib_backend"] = library_bwd(q, k, v, do,
                                                         is_causal=True)
        for n, got, r in zip(("dq", "dk", "dv"), lib0_grads, refs0):
            if not max_err(got, r) <= kernel_tol(r):
                fail(f"the library backward's {n} computes another function "
                     f"at {case} without the bias")
        # several pairs of turns: one pair cannot tell the library's spread
        # from ours
        t["pairs_nobias"] = [whole_bwd_turns(whole0, lib0)
                             for _ in range(BWD_PAIRS)]
        t["whole_nobias"] = sum(w for w, _ in t["pairs_nobias"]) / BWD_PAIRS
        t["lib_bwd_nobias"] = sum(l for _, l in t["pairs_nobias"]) / BWD_PAIRS
        del lib0, lib0_grads
        # each backend of the library pinned, in turns with ours
        t["pinned"] = {}
        for backend in SDPA_BACKENDS:
            try:
                run, grads, ran = library_bwd(q, k, v, do, backend=backend,
                                              is_causal=True)
            except RuntimeError as exc:
                t["pinned"][backend] = str(exc).splitlines()[0][:80]
                continue
            for n, got, r in zip(("dq", "dk", "dv"), grads, refs0):
                if not max_err(got, r) <= kernel_tol(r):
                    fail(f"the library backward's {n} on {backend} computes "
                         f"another function at {case}")
            t["pinned"][backend] = (ran,) + whole_bwd_turns(whole0, run)
            del run, grads
        del refs0, whole0
        t["plain_fwd"] = cuda_ms(lambda: fl.flash_attention_plain(
            q, k, v, **kw), iters=5)
        t["plain_bwd"] = cuda_ms(lambda: fl.flash_attention_bwd_plain(
            q, k, v, out, lse, do, **kw), iters=3, warmup=1)
        # the library: the bias and the causal mask materialised as one
        # additive [1, H, S, S] mask, which SDPA takes in the inputs' bf16.
        # In the kernels' form slope * (j - (S - 1)) a row's near keys sit
        # at a bias of hundreds, where bf16 no longer tells neighbouring
        # keys apart; the mask holds slope * (j - i) instead, which differs
        # by a constant per row and gives the same output and gradients
        pos = torch.arange(s, device=dev, dtype=torch.float32)
        bias = slopes[:, None, None] * (pos[None, :] - pos[:, None])
        causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        lib_mask = bias.masked_fill(~causal, float("-inf"))[None].to(
            torch.bfloat16)
        ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
        lib_out = sdpa(ql, kl, vl, attn_mask=lib_mask)
        lib_grads = torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                        retain_graph=True)
        # the library rounds the bias to bf16, the kernels keep it in fp32:
        # twice the kernels' tolerance
        for n, got, r in zip(("out", "dq", "dk", "dv"),
                             (lib_out,) + lib_grads, (ref, rq, rk, rv)):
            lib_err = max_err(got, r)
            print(f"{tag} library (SDPA with a bf16 bias mask) {n} "
                  f"max_abs_err {lib_err:.3e} vs the plain version")
            if not lib_err <= 2 * kernel_tol(r):
                fail(f"the ALiBi library yardstick's {n} computes another "
                     f"function: {lib_err}")
        with torch.no_grad():
            t["lib_fwd"] = graph_ms(lambda: sdpa(q, k, v, attn_mask=lib_mask),
                                    10, 5)
        t["whole"], t["lib_bwd"] = whole_bwd_turns(
            lambda: fl.flash_attention_bwd(*args, **kw),
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                        retain_graph=True))
        del ql, kl, vl, lib_out, lib_grads, lib_mask, bias, causal
        pairs = s * (s + 1) // 2
        tensor, stats = b * s * h * d * 2, b * h * s * 4
        bounds = {
            names[0]: bound(4 * tensor, 4 * d * pairs * b * h,
                            H100_BF16_TFLOPS),
            names[1]: bound(6 * tensor + 2 * stats, 6 * d * pairs * b * h,
                            H100_BF16_TFLOPS),
            names[2]: bound(6 * tensor + 2 * stats, 8 * d * pairs * b * h,
                            H100_BF16_TFLOPS)}
        shape = (f"B={b} S={s} H=KV={h} D={d} causal ALiBi (+ ragged S=333, "
                 f"H=6 D=64, GQA KV=2 kv_len=150)")
        del out0, lse0, delta0, args0
    results = {
        names[0]: dict(ms=t["fwd"], noalibi_ms=t["fwd_nobias"],
                       plain_ms=t["plain_fwd"], library_ms=t["lib_fwd"]),
        names[1]: dict(ms=t["dq"], noalibi_ms=t["dq_nobias"],
                       plain_ms=t["plain_bwd"], library_ms=t["lib_bwd"],
                       whole_ms=t["whole"]),
        names[2]: dict(ms=t["dkv"], noalibi_ms=t["dkv_nobias"],
                       plain_ms=t["plain_bwd"], library_ms=t["lib_bwd"],
                       whole_ms=t["whole"])}
    for name, r in results.items():
        r.update(err=max(e[0] for e in errs[name]),
                 tol=min(e[1] for e in errs[name]),
                 row_err=max(e[2] for e in errs[name]), shape=shape,
                 **bounds[name])
        print(f"{tag} kernel {name} [{shape}]: {r['ms']:.4f} ms with the "
              f"bias, {r['noalibi_ms']:.4f} ms without it (x"
              f"{r['ms'] / r['noalibi_ms']:.3f}); plain "
              f"{r['plain_ms']:.4f} ms"
              + (" (dq, dk, dv together)" if "bwd" in name else "")
              + f"; library {r['library_ms']:.4f} ms"
              + (" (its one backward call does the work of kernels 5 and 6 "
                 "together)" if "bwd" in name else "")
              + f"; bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['bound_ms'] / r['ms']:.1%} of it reached)")
    print(f"{tag} the whole backward call (kernels 5 and 6) at B=2 S=2048 "
          f"H=32 D=128 causal: {t['whole_nobias']:.4f} ms without the bias "
          f"against the library's causal backward ({t['lib_backend']}) "
          f"{t['lib_bwd_nobias']:.4f} ms (x"
          f"{t['whole_nobias'] / t['lib_bwd_nobias']:.3f}; mean of "
          f"{BWD_PAIRS} pairs of turns: "
          + ", ".join(f"{w:.4f} / {l:.4f}" for w, l in t["pairs_nobias"])
          + f"); with ALiBi {t['whole']:.4f} ms against the library's with "
          f"the bias as attn_mask {t['lib_bwd']:.4f} ms (x"
          f"{t['whole'] / t['lib_bwd']:.3f}), each pair in the same turns")
    for backend, r in t["pinned"].items():
        if isinstance(r, str):
            print(f"{tag} the library's causal backward pinned to {backend}: "
                  f"does not run here ({r})")
        else:
            print(f"{tag} the library's causal backward pinned to {backend} "
                  f"({r[0]}): {r[2]:.4f} ms against the whole backward call "
                  f"{r[1]:.4f} ms in the same turns (x{r[1] / r[2]:.3f})")
    return results


def structured(n: int, st: int, sa: int, d: int, seed: int, dev):
    """Embeddings as towers give them: a mean that every row shares, 8
    outlier channels 60 times the rest, and anchors that are the targets
    with 5 % noise, so that cosines lie near 1 (where one TF32 product alone
    errs by ~1e-5)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    mean = rng.randn(d).astype(np.float32)
    t = mean + rng.randn(n, st, d).astype(np.float32)
    t[..., rng.choice(d, 8, replace=False)] *= 60
    a = t[:, np.arange(sa) % st] * (1 + 0.05 * rng.randn(n, sa, d))
    return (torch.from_numpy(t).to(dev),
            torch.from_numpy(a.astype(np.float32)).to(dev))


def check_a_score(tag: str, dev) -> dict:
    """Phase 2, kernel 9 against `a_score_plain` on the card: fp32 at the
    A-score protocol shape against both anchors (the 3xTF32 wgmma body),
    towers' structured data and target = anchor, which must give 1.0 for
    every image, a ragged case with both masks and lengths no block divides,
    D = 37 and bf16 inputs (the SIMT body). Each case's body is checked by
    the wrapper's counters. Timed: fp32 at both anchors and bf16 at
    Sa = 576, beside the plain version, their bounds and, for fp32,
    `torch.bmm` of the same inputs at "highest" precision: the product
    alone, not the function, printed for context and never `library_ms`."""
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

    def body_of(fn):
        """Run fn() and return the body it launched."""
        wgmma = A.max_cos.wgmma_launches
        out = fn()
        return out, "wgmma" if A.max_cos.wgmma_launches > wgmma else "simt"

    def timed(label, target, anchor, want_body):
        n, st, d = target.shape
        sa = anchor.shape[1]
        got, body = body_of(lambda: A.max_cos(target, anchor))
        if body != want_body:
            fail(f"kernel 9 ran its {body} body for {label}, not "
                 f"{want_body}")
        ref = A.a_score_plain(target, anchor)
        if not torch.equal(got, A.max_cos(target, anchor)):
            fail(f"kernel 9 is not repeatable ({label})")
        flops = 2 * n * st * sa * d
        nbytes = (target.numel() + anchor.numel()) * target.element_size() \
            + n * 4
        fma = bound(nbytes, flops, H100_FP32_TFLOPS)
        # fp32: the three TF32 products of an fp32-accurate product; 16-bit
        # inputs: one product on the tensor cores (exact in fp32)
        fast = (bound(nbytes, 3 * flops, H100_TF32_TFLOPS)
                if target.dtype == torch.float32
                else bound(nbytes, flops, H100_BF16_TFLOPS))
        r = dict(err=max_err(got, ref), tol=A_SCORE_TOL, body=body,
                 ms=cuda_ms(lambda: A.max_cos(target, anchor), iters=10),
                 plain_ms=cuda_ms(lambda: A.a_score_plain(target, anchor),
                                  iters=10),
                 library_ms=None, fma_bound_ms=fma["bound_ms"],
                 shape=f"N={n} St={st} Sa={sa} D={d} "
                       f"{str(target.dtype).split('.')[-1]}", **fast)
        print(f"{tag} kernel a_score [{r['shape']}, {body} body]: the "
              f"fp32-FMA bound {fma['bound_ms']:.4f} ms (67 TFLOP/s); "
              f"{r['ms']:.4f} ms is {fma['bound_ms'] / r['ms']:.1%} of it")
        if target.dtype == torch.float32:
            r["bmm_ms"] = cuda_ms(
                lambda: torch.bmm(target, anchor.transpose(1, 2)), iters=10)
            print(f"{tag} kernel a_score [{r['shape']}]: torch.bmm of the "
                  f"same fp32 inputs at 'highest' precision, the product "
                  f"alone (not the function, not library_ms): "
                  f"{r['bmm_ms']:.4f} ms")
        report_kernel(tag, "a_score", r)
        return r

    n, st, d = LAW_IMAGES, 576, 4096
    target = randn(n, st, d)
    errs, cases = [], []
    for sa in (576, 256):
        anchor = randn(n, sa, d)
        cases.append(timed(f"fp32 Sa={sa}", target, anchor, "wgmma"))
        errs.append(cases[-1]["err"])
        del anchor
    self_score, body = body_of(lambda: A.max_cos(target, target.clone()))
    self_err = (self_score - 1.0).abs().max().item()
    print(f"{tag} kernel a_score self-anchor ({body} body): max |score - 1| "
          f"{self_err:.3e} (tol {A_SCORE_TOL})")
    if not self_err <= A_SCORE_TOL:
        fail(f"kernel 9: target = anchor gives {self_score[:4].tolist()}")
    bf16 = target.to(torch.bfloat16)
    cases.append(timed("bf16 Sa=576", bf16, randn(n, st, d,
                                                  dtype=torch.bfloat16),
                       "simt"))
    errs.append(cases[-1]["err"])
    del target, self_score, bf16

    for sa in (576, 256):
        t, a = structured(16, 576, sa, 4096, 3, dev)
        (got, body), ref = body_of(lambda: A.max_cos(t, a)), \
            A.a_score_plain(t, a)
        err = max_err(got, ref)
        self_err = (A.max_cos(t, t.clone()) - 1.0).abs().max().item()
        print(f"{tag} kernel a_score [structured: N=16 St=576 Sa={sa} "
              f"D=4096 float32, {body} body, scores {got.min().item():.5f}"
              f"..{got.max().item():.5f}]: max_abs_err {err:.3e}, self "
              f"max |score - 1| {self_err:.3e} (tol {A_SCORE_TOL})")
        if not (body == "wgmma" and err <= A_SCORE_TOL
                and self_err <= A_SCORE_TOL):
            fail(f"kernel 9 on structured data ({body} body): {err}, self "
                 f"{self_err}")
        errs.append(err)
        del t, a

    cases_small = (
        ("ragged, both masks", 7, 150, 77, 1000, torch.float32, True,
         "wgmma"),
        ("D no vector load divides", 3, 65, 130, 37, torch.float32, True,
         "simt"),
        ("bf16 inputs, masks", 8, 576, 256, 4096, torch.bfloat16, True,
         "simt"),
        ("bf16 inputs", 8, 576, 576, 4096, torch.bfloat16, False, "simt"))
    for label, n, st, sa, d, dtype, masked, want in cases_small:
        t, a = randn(n, st, d, dtype=dtype), randn(n, sa, d, dtype=dtype)
        tm, am = masks(n, st, sa) if masked else (None, None)
        got, body = body_of(lambda: A.max_cos(t, a, tm, am))
        err = max_err(got, A.a_score_plain(t, a, tm, am))
        print(f"{tag} kernel a_score [{label}: N={n} St={st} Sa={sa} D={d} "
              f"{str(dtype).split('.')[-1]}, {body} body]: max_abs_err "
              f"{err:.3e} (tol {A_SCORE_TOL})")
        if not (err <= A_SCORE_TOL and body == want):
            fail(f"kernel 9 disagrees with its plain version or ran its "
                 f"{body} body ({label})")
        errs.append(err)
    return {"a_score": dict(cases[0], err=max(errs), cases=cases)}


def rotating(make, nbytes: float) -> list:
    """Enough copies of `make()` (each `nbytes` large) to exceed twice the L2
    cache. A kernel timed over them in turn (`itertools.cycle`) reads its
    operand from HBM at every launch, as a decode step does when it walks 32
    layers."""
    return [make() for _ in range(max(2, int(2.5 * L2_BYTES / nbytes) + 1))]


def print_ptxas(tag: str, report: str) -> None:
    """The registers and spills `nvcc -Xptxas -v` reported for the wgmma
    kernels: kernel 10's three bodies (its decode body by the rows of x it
    holds and its blocks an SM), the attention forward of kernels 1
    and 2 by its template arguments (head size, rows a block, causal,
    ALiBi), the backward of kernels 5 and 6 by theirs (head size, causal,
    ALiBi), kernel 9's two bodies (its SIMT body by input type) and kernel
    3 by head size, group size and cache type. Fails if kernel 9's wgmma
    body, any form of the attention forward (DiT's D = 72 among them), any
    form of kernel 3 or of kernel 10's decode body spills."""
    import re
    name = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fwd = re.search(r"flash_fwd_wgmma_kernelILi(\d+)ELi(\d)ELb(\d)"
                            r"ELb(\d)E", line)
            bwd = re.search(r"(flash_bwd_dq_kernel|flash_bwd_dkv_kernel)"
                            r"ILi(\d+)ELb(\d)ELb(\d)E", line)
            if fwd:
                name = (f"flash_fwd_wgmma_kernel<D={fwd[1]}, rows="
                        f"{64 * int(fwd[2])}, causal={fwd[3]}, "
                        f"alibi={fwd[4]}>")
            elif bwd:
                name = (f"{bwd[1]}<D={bwd[2]}, causal={bwd[3]}, "
                        f"alibi={bwd[4]}>")
            else:
                name = next((k for k in ("int4_wgmma_dx_kernel",
                                         "int4_wgmma_kernel",
                                         "a_score_tf32_kernel") if k in line),
                            None)
                simt = re.search(r"a_score_tile_kernelI(\w+?)EEv", line)
                if simt:
                    name = f"a_score_tile_kernel<{simt[1]}>"
                small = re.search(r"int4_decode_kernelILi(\d)ELi(\d)E",
                                  line)
                if small:
                    name = (f"int4_decode_kernel<x rows {8 * int(small[1])}"
                            f", {small[2]} blocks an SM>")
                dec = re.search(r"decode_kernelILi(\d+)ELi(\d+)E(\w+?)EEv",
                                line)
                if dec:
                    name = (f"decode_kernel<Dh={dec[1]}, G={dec[2]}, "
                            f"{'int8' if dec[3] == 'a' else 'bf16'}>")
        elif name and ("Used" in line or "spill" in line):
            print(f"{tag} ptxas {name}: {line.strip()}")
            spill = re.search(r"(\d+) bytes spill stores", line)
            if name == "a_score_tf32_kernel" and spill and int(spill[1]):
                fail(f"kernel 9's wgmma body spills: {line.strip()}")
            if name.startswith("decode_kernel") and spill and int(spill[1]):
                fail(f"kernel 3 spills in {name}: {line.strip()}")
            if name.startswith("int4_decode") and spill and int(spill[1]):
                fail(f"kernel 10's decode body spills in {name}: "
                     f"{line.strip()}")
            if name.startswith("flash_fwd") and spill and int(spill[1]):
                fail(f"the attention forward spills in {name}: "
                     f"{line.strip()}")


def check_sass_tf32(tag: str, lib_path) -> None:
    """Kernel 9's wgmma body as compiled: its TF32 `HGMMA` instructions
    counted in the library's SASS (`cuobjdump`)."""
    from law_of_vision_representation_in_mllms_torch.ops import _build
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    inside, ops = False, []
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "a_score_tf32_kernel" in line
        elif inside and "HGMMA" in line:
            ops.append(line.split("*/", 1)[1].split(";")[0].split()[0])
    print(f"{tag} SASS of kernel 9's wgmma body: {len(ops)} HGMMA "
          f"instructions, {sorted(set(ops))}")
    if not ops or not all("TF32" in op for op in ops):
        fail(f"kernel 9's wgmma body has no TF32 HGMMA: {sorted(set(ops))}")


def check_int4_matmul(tag: str, dev) -> dict:
    """Phase 2, kernel 10 against its plain version at the four 7B weight
    shapes, at a decode step's M (4, the decode body; also 1, 8 and 16 at
    4096 -> 4096, with the split each launch took), the large body's 64, a
    prefill's (4 x 703) and a QLoRA training step's (16 x 703); at that M also
    its transposed form `int4_matmul_dx` (QLoRA's input gradient) against
    its plain version `dy @ dequant(W)`. Library yardsticks: `torch.matmul`
    on the same weight dequantised to bf16 (`x @ W.T`, `dy @ W`). Every
    product is timed over rotating weights, so each launch reads its weight
    from HBM."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        int4_matmul as K, quant as Q)

    g = torch.Generator(device=dev).manual_seed(4)
    cases, dx_cases, headline, dx_headline = [], [], None, None
    for di, do in ((4096, 4096), (4096, 11008), (11008, 4096),
                   (4096, 32000)):
        def make_leaf():
            w = torch.randn((do, di), generator=g, device=dev) * 0.02
            return Q.quantize_int4(w)
        wbytes = do * di // 2 + (di // 128) * do * 4
        leaves = rotating(make_leaf, wbytes)
        dense = [Q.dequantize_int4(leaf, torch.bfloat16) for leaf in leaves]
        leaf_turn, dense_turn = itertools.cycle(leaves), itertools.cycle(dense)
        leaf = leaves[0]
        # the decode body at every M it has a form for (n8, n16) at the
        # decoder's square shape; M = 4 at all four
        for m in ((1, 4, 8, 16, 64, 2812, 11248) if (di, do) == (4096, 4096)
                  else (4, 64, 2812, 11248)):
            x = torch.randn((m, di), generator=g, device=dev,
                            dtype=torch.bfloat16)

            def plain():
                # the plain version holds an fp32 partial for every group:
                # rows go through it 2,812 at a time
                parts = [K.int4_matmul_plain(rows, leaf["q4"], leaf["scale"])
                         for rows in x.split(2812)]
                return parts[0] if len(parts) == 1 else torch.cat(parts)
            got = K.int4_matmul_kernel(x, leaf["q4"], leaf["scale"])
            split = (f", split {K.last_small_split()} (decode body)"
                     if m <= 16 else "")
            ref = plain()
            tol = INT4_REL_TOL * max(1.0, ref.float().abs().max().item())
            lib_err = max_err(x @ dense[0].T, ref)
            if not torch.equal(got, K.int4_matmul_kernel(x, leaf["q4"],
                                                         leaf["scale"])):
                fail(f"int4_matmul at M={m} {di}->{do} gave other bits on a "
                     f"second run")

            def kernel():
                lf = next(leaf_turn)
                return K.int4_matmul_kernel(x, lf["q4"], lf["scale"])

            def library():
                return x @ next(dense_turn).T
            # a launch of tens of microseconds is timed under a CUDA graph
            timer = graph_ms if m <= 64 else cuda_ms
            r = dict(
                err=max_err(got, ref), tol=tol, ms=timer(kernel),
                plain_ms=cuda_ms(plain, iters=3, warmup=1),
                library_ms=timer(library), library_err=lib_err,
                shape=f"M={m} {di}->{do} group 128, {len(leaves)} weights "
                      f"in turn{split}",
                # packed words and scales once, x in, out written; the
                # operations run on the bf16 tensor cores
                **bound(wbytes + x.numel() * 2 + m * do * 2,
                        2.0 * m * di * do, H100_BF16_TFLOPS))
            report_kernel(tag, "int4_matmul", r)
            # the library multiplies bf16(code * scale), rounded once more:
            # a looser bound than the kernel's
            if not lib_err <= 4 * tol:
                fail(f"the library yardstick of int4_matmul computes "
                     f"another function: err {lib_err}")
            cases.append({k: r[k] for k in (
                "shape", "err", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by")})
            if (di, do, m) == (4096, 4096, 4):
                headline = r
            del x, got, ref
        # the transposed form at QLoRA's M: dx = dy @ W, W = bf16(code *
        # bf16(scale)); its plain version is autograd's former backward
        m = 11248
        dy = torch.randn((m, do), generator=g, device=dev,
                         dtype=torch.bfloat16)
        got = K.int4_matmul_dx(dy, leaf["q4"], leaf["scale"])
        ref = K.int4_matmul_dx_plain(dy, leaf["q4"], leaf["scale"])
        if not torch.equal(got, K.int4_matmul_dx(dy, leaf["q4"],
                                                 leaf["scale"])):
            fail(f"int4_matmul_dx at M={m} {di}->{do} gave other bits on a "
                 f"second run")

        def dx_kernel():
            lf = next(leaf_turn)
            return K.int4_matmul_dx(dy, lf["q4"], lf["scale"])

        def dx_plain():
            lf = next(leaf_turn)
            return K.int4_matmul_dx_plain(dy, lf["q4"], lf["scale"])
        r = dict(
            err=max_err(got, ref),
            tol=INT4_REL_TOL * max(1.0, ref.float().abs().max().item()),
            ms=cuda_ms(dx_kernel), plain_ms=cuda_ms(dx_plain),
            library_ms=cuda_ms(lambda: dy @ next(dense_turn)),
            library_err=max_err(dy @ dense[0], ref),
            shape=f"M={m} dy [M, {do}] @ W [{do}, {di}] group 128, "
                  f"{len(leaves)} weights in turn",
            # words and scales once, dy in, dx written
            **bound(wbytes + dy.numel() * 2 + m * di * 2, 2.0 * m * di * do,
                    H100_BF16_TFLOPS))
        report_kernel(tag, "int4_matmul_dx", r)
        # the same bf16 weights on both sides: only the order of the sums
        if not r["library_err"] <= r["tol"]:
            fail(f"the library yardstick of int4_matmul_dx computes another "
                 f"function: err {r['library_err']}")
        dx_cases.append({k: r[k] for k in (
            "shape", "err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")})
        if (di, do) == (4096, 4096):
            dx_headline = r
        del dy, got, ref, leaves, dense, leaf
    cases.append(check_int4_odd_k(tag, dev, g))
    return {"int4_matmul": dict(headline, cases=cases,
                                err=max(c["err"] for c in cases)),
            "int4_matmul_dx": dict(dx_headline, cases=dx_cases,
                                   err=max(c["err"] for c in dx_cases))}


# kernel 10 at a contraction dim that 8 does not divide (the JAX packing
# takes any even one): its words hold the one group zero-padded to 1,024
INT4_ODD_K = (4, 1004, 4096)        # M, K, out


def check_int4_odd_k(tag: str, dev, g) -> dict:
    """Phase 2, kernel 10 on a weight of K = 1,004 with one scale a channel
    (`group_size=None`): `quant.int4_matmul` pads x with zeros to the
    stored 1,024 and launches the kernel (its decode body), held to the
    plain version on the same padded x and to a repeat's bits."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        int4_matmul as K, quant as Q)
    m, di, do = INT4_ODD_K
    leaf = Q.quantize_int4(torch.randn((do, di), generator=g, device=dev)
                           * 0.02, group_size=None)
    stored = leaf["q4"].shape[1] * 8
    x = torch.randn((m, di), generator=g, device=dev, dtype=torch.bfloat16)
    before = K.int4_matmul_kernel.launches
    got = Q.int4_matmul(x, leaf)
    if K.int4_matmul_kernel.launches != before + 1:
        fail(f"int4_matmul at K={di}: kernel 10 was not launched")
    xp = Q.pad_groups(x, 1, stored)
    ref = K.int4_matmul_plain(xp, leaf["q4"], leaf["scale"])
    if not torch.equal(got, Q.int4_matmul(x, leaf)):
        fail(f"int4_matmul at K={di} gave other bits on a second run")
    dense = Q.dequantize_int4(leaf, torch.bfloat16, di=di)
    r = dict(err=max_err(got, ref),
             tol=INT4_REL_TOL * max(1.0, ref.float().abs().max().item()),
             ms=graph_ms(lambda: Q.int4_matmul(x, leaf)),
             plain_ms=cuda_ms(lambda: K.int4_matmul_plain(
                 Q.pad_groups(x, 1, stored), leaf["q4"], leaf["scale"])),
             library_ms=graph_ms(lambda: x @ dense.T),
             shape=f"M={m} {di}->{do} group_size=None (stored K {stored}, "
                   f"x padded with zeros), one weight",
             **bound(do * stored // 2 + do * 4 + x.numel() * 2 + m * do * 2,
                     2.0 * m * di * do, H100_BF16_TFLOPS))
    report_kernel(tag, "int4_matmul", r)
    return {k: r[k] for k in ("shape", "err", "ms", "plain_ms", "library_ms",
                              "bound_ms", "bound_by")}


def check_decode_int8(tag: str, dev) -> dict:
    """Phase 2, kernel 3's int8 branch against its plain version on
    `quantize_kv` codes and scales (B=4 T=704 H=KV=32 Dh=128 with holes and
    a masked tile; a GQA case), cold over caches in turn and warm, the SDPA
    yardstick on the dequantised cache, and the dense and int8 branches side
    by side at B=1, 4, 16, 32 and at B=4 T=2,048 over rotating caches (the
    kv8 crossover by batch and length)."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec, quant as Q)

    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    t, h, d = 704, 32, 128
    cases = []
    for b, kvh in ((4, 32), (4, 8)):
        q = randn(b, 1, h, d)
        mask = torch.rand(b, t, generator=g, device=dev) < 0.8
        mask[:, 256:384] = False
        mask[:, 0] = True
        rep = h // kvh

        def make():
            (kc, ks), (vc, vs) = (Q.quantize_kv(randn(b, t, kvh, d))
                                  for _ in range(2))
            return kc, vc, ks, vs
        caches = rotating(make, 2 * b * t * kvh * (d + 4))
        # the yardstick's dequantised caches, heads repeated for GQA outside
        # the timed call
        dense = {id(c): tuple(
            (x.float() * s[..., None]).to(torch.bfloat16).repeat_interleave(
                rep, dim=2) for x, s in ((c[0], c[2]), (c[1], c[3])))
            for c in caches}
        lib_mask = mask[:, None, None, :]
        visible = int(mask.sum().item())
        r = dict(
            time_decode("decode_attention_int8", q, caches, mask,
                        lambda c: sdpa(q, *dense[id(c)], attn_mask=lib_mask)),
            shape=f"B={b} T={t} H={h} KV={kvh} Dh={d} int8 cache, holes + "
                  f"masked 128-slot tile ({visible} of {b * t} slots "
                  f"visible)",
            # the visible slots' codes and scales once
            **bound(2 * visible * kvh * (d + 4) + mask.numel()
                    + 2 * q.numel() * 2, 4 * visible * h * d,
                    H100_BF16_TFLOPS))
        report_kernel(tag, "decode_attention_int8", r)
        if not r["library_err"] <= r["tol"]:
            fail(f"the library yardstick of decode_attention_int8 computes "
                 f"another function: err {r['library_err']}")
        cases.append(r)
        del caches, dense

    # the crossover: every slot visible, caches in turn so each launch reads
    # HBM (a decode step walks 32 layers' caches, ~23 MB each at B=4)
    cross = []
    for b, t in ((1, 704), (4, 704), (16, 704), (32, 704), (4, 2048)):
        q = randn(b, 1, h, d)
        mask = torch.ones((b, t), dtype=torch.bool, device=dev)
        per = 2 * b * t * h * d
        caches = rotating(lambda: (randn(b, t, h, d), randn(b, t, h, d)),
                          per * 2)
        qcaches = [Q.quantize_kv(k) + Q.quantize_kv(v) for k, v in caches]
        cache_turn, q_turn = itertools.cycle(caches), itertools.cycle(qcaches)

        def dense():
            k, v = next(cache_turn)
            return dec.decode_attention(q, k, v, mask)

        def int8():
            kc, ks, vc, vs = next(q_turn)
            return dec.decode_attention(q, kc, vc, mask, ks, vs)
        row = dict(batch=b, t=t, dense_ms=graph_ms(dense),
                   int8_ms=graph_ms(int8),
                   dense_bound_ms=per * 2 / H100_HBM_BYTES_S * 1e3,
                   int8_bound_ms=(per + 2 * b * t * h * 4)
                   / H100_HBM_BYTES_S * 1e3)
        cross.append(row)
        print(f"{tag} kv8 crossover B={b} T={t} H=KV={h} Dh={d}, all slots "
              f"visible, {len(caches)} caches in turn: kernel 3 dense "
              f"{row['dense_ms']:.4f} ms (bound {row['dense_bound_ms']:.4f},"
              f" {row['dense_bound_ms'] / row['dense_ms']:.1%} of it), int8 "
              f"{row['int8_ms']:.4f} ms (bound {row['int8_bound_ms']:.4f}, "
              f"{row['int8_bound_ms'] / row['int8_ms']:.1%}); int8 / dense "
              f"{row['int8_ms'] / row['dense_ms']:.2f}")
        del caches, qcaches
    return {"decode_attention_int8": dict(
        cases[0], err=max(r["err"] for r in cases), crossover=cross,
        cases=[{k: r[k] for k in ("shape", "err", "tol", "ms", "warm_ms",
                                  "plain_ms", "library_ms", "library_warm_ms",
                                  "bound_ms", "bound_by")}
               for r in cases[1:]])}


def check_int8_weight_cost(tag: str, dev) -> None:
    """What `int8_matmul` costs on this card: `q8.to(bf16)` writes a bf16
    copy of the weight at every call before the product (plain PyTorch, as
    the JAX package leaves this product to XLA). Beside it: the product on a
    ready bf16 weight and kernel 10 on the same weight in int4."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        int4_matmul as K, quant as Q)

    g = torch.Generator(device=dev).manual_seed(6)
    for di, do in ((4096, 4096), (4096, 11008)):
        def make():
            w = torch.randn((do, di), generator=g, device=dev) * 0.02
            return (Q.quantize_int8(w), Q.quantize_int4(w),
                    w.to(torch.bfloat16))
        sets = rotating(make, do * di)
        turn = itertools.cycle(sets)
        x = torch.randn((4, di), generator=g, device=dev,
                        dtype=torch.bfloat16)
        ref = (x.float() @ Q.dequantize_int8(sets[0][0]).T)
        err = max_err(Q.int8_matmul(x, sets[0][0]), ref)
        tol = KERNEL_REL_TOL * max(1.0, ref.abs().max().item())
        if not err <= tol:
            fail(f"int8_matmul disagrees with its fp32 value: {err} > {tol}")
        t8 = graph_ms(lambda: Q.int8_matmul(x, next(turn)[0]))
        cast = graph_ms(lambda: next(turn)[0]["q8"].to(torch.bfloat16))
        t16 = graph_ms(lambda: x @ next(turn)[2].T)

        def int4():
            leaf = next(turn)[1]
            return K.int4_matmul_kernel(x, leaf["q4"], leaf["scale"])
        t4 = graph_ms(int4)
        print(f"{tag} int8 weights, M=4 {di}->{do}, {len(sets)} weights in "
              f"turn: int8_matmul {t8:.4f} ms (of it the cast to bf16 "
              f"{cast:.4f} ms: reads {do * di / 1e6:.1f} MB, writes "
              f"{2 * do * di / 1e6:.1f} MB), max_abs_err {err:.3e} (tol "
              f"{tol:.3e}); the same product on a bf16 weight {t16:.4f} ms; "
              f"kernel 10 on the int4 weight {t4:.4f} ms")
        del sets


# kernel 2 at the UNet's attentions (phase 2): SD1.5 at 768 px (8 heads over
# 320 / 640 / 1280 channels; the cross attentions read the 77 text tokens)
# at each batch that phase 11 runs it at: one image (a), the four served
# requests (c) and the extraction batch of C_BATCH images (b; its tail batch
# is padded to it); and SD2.1's 5-head D = 64 block-0 attention at B = 4. At
# D = 40 the launcher takes 64-row blocks at B = 1 and 4 and 128-row ones at
# B = 16 on 132 SMs, so both instantiations are held here
SD15_ATTENTION = (
    # (Sq, Skv, D, what it is)
    (9216, 9216, 40, "block 0 self"),
    (9216, 77, 40, "block 0 cross"),
    (2304, 2304, 80, "block 1 self"),
    (2304, 77, 80, "block 1 cross"),
    (576, 576, 160, "block 2 self"),
    (576, 77, 160, "block 2 cross"),
    (144, 144, 160, "mid self"),
    (144, 77, 160, "mid cross"),
)
UNET_ATTENTION = tuple(
    (b, sq, skv, 8, d, "SD1.5 " + what) for b in (1, 4, C_BATCH)
    for sq, skv, d, what in SD15_ATTENTION) + (
    (4, 9216, 9216, 5, 64, "SD2.1 block 0 self"),)
SD15_KERNEL2_LAUNCHES = 14      # kernel-2 launches of one SD1.5 forward
# kernel 2 at the transformer towers' attentions at 512 px (phase 2), at
# one image, at the extraction batch and (SD3) at the four served requests:
# DiT-XL/2's self-attention (1,024
# tokens, 16 heads of 72: the Dp = 128 tile, columns 72-127 read as zeros)
# and SD3-medium's joint attention over [1,024 latent, 333 context] tokens
# (24 heads of 64), each launched once a block of the forward
TRANSFORMER_ATTENTION = tuple(
    (b, s, s, h, d, what) for b in (1, C_BATCH)
    for s, h, d, what in ((1024, 16, 72, "DiT self"),
                          (1024 + 333, 24, 64, "SD3 joint"))) + (
    (4, 1357, 1357, 24, 64, "SD3 joint"),)    # phase 12 (c): 4 requests
# phase 12 runs each tower at a seventh and an eighth of its published depth
# (DiT-XL/2 28 blocks, SD3-medium 24; full width): the script's time limit,
# which phases 17 and 18 brought closer. One kernel-2 launch a block
TRANSFORMER_BLOCKS = {"DiT": 4, "SD3": 3}


def attn_key(sq: int, skv: int, h: int, d: int) -> str:
    return f"Sq={sq} Skv={skv} H={h} D={d}"


def check_unet_attention(tag: str, dev) -> list:
    """Phase 2, kernel 2 non-causal at every attention shape of an SD1.5
    forward at 768 px (head sizes 40, 80, 160; Sq != Skv in the cross
    attentions) at each batch phase 11 launches it at, at SD2.1's 5-head
    D = 64 one, and at DiT-XL/2's and SD3-medium's at 512 px (phase 12),
    each held to its plain version row by row and to a repeat, timed beside
    the plain version and SDPA, with the block rows that a launch at the
    shape took (as the launcher reports them after the launch). The
    plain version runs one image at a time (its [H, Sq, Skv] fp32 scores
    are 2.7 GB at S = 9,216). Returns the cases; phases 11 and 12 add to
    their towers' ones the launches they count of each shape in one
    forward."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)

    g = torch.Generator(device=dev).manual_seed(5)

    def plain(q, k, v):
        return torch.cat([fl.flash_attention_plain(q[i:i + 1], k[i:i + 1],
                                                   v[i:i + 1])
                          for i in range(q.shape[0])])

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for b, sq, skv, h, d, what in (UNET_ATTENTION + TRANSFORMER_ATTENTION
                                   + GEOWARE_ATTENTION):
        q = torch.randn((b, sq, h, d), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k, v = (torch.randn((b, skv, h, d), generator=g, device=dev,
                            dtype=torch.bfloat16) for _ in range(2))
        case = attention_case(
            tag, lambda q, k, v: fl.flash_attention(q, k, v), plain,
            lambda q, k, v: sdpa(q, k, v), (q, k, v), sq * skv,
            f"kernel 2 {what} B={b} {attn_key(sq, skv, h, d)} non-causal")
        if not case["err"] <= case["tol"]:
            fail(f"kernel 2 at {case['shape']}: {case['err']} > "
                 f"{case['tol']}")
        fl.flash_attention(q, k, v)     # one launch more: the rows it took
        torch.cuda.synchronize(dev)
        rows = fl.last_block_rows()
        if rows not in (64, 128):
            fail(f"kernel 2 at {case['shape']}: the launcher reports "
                 f"{rows}-row blocks")
        case.update(what=what, batch=b, attn=attn_key(sq, skv, h, d),
                    block_rows=rows)
        print(f"{tag} kernel 2 {what} B={b} {attn_key(sq, skv, h, d)}: "
              f"{rows}-row blocks (reported by the launch; "
              f"{-(-sq // rows) * h * b} blocks on {sms} SMs), "
              f"{case['ms']:.4f} ms")
        cases.append(case)
        del q, k, v
        torch.cuda.empty_cache()
    return cases


# kernel 2's causal form at the CLIP text encoders' attention (phase 2): one
# prompt of 77 tokens, head size 64; SD1.5's CLIP-L has 12 heads, SD2.1's
# OpenCLIP-H 16, SDXL's and SD3's bigG 20. Phase 13 and phase 11's
# `port-featurizer` launch it at 12
TEXT_ATTENTION = ((1, 77, 12, 64, "CLIP-L text"),
                  (1, 77, 16, 64, "OpenCLIP-H text"),
                  (1, 77, 20, 64, "bigG text"))


def check_text_attention(tag: str, dev) -> list:
    """Phase 2, kernel 2 causal at the text encoders' shapes, each held to
    its plain version row by row and by its LSE, to a repeat's bits, and
    timed beside the plain version, SDPA (`is_causal`) and the bound.
    Returns the cases, with `attn` the key that phase 13 counts launches
    under."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)

    g = torch.Generator(device=dev).manual_seed(13)
    cases = []
    for b, s, h, d, what in TEXT_ATTENTION:
        qkv = [torch.randn((b, s, h, d), generator=g, device=dev,
                           dtype=torch.bfloat16) for _ in range(3)]
        case = attention_case(
            tag, lambda q, k, v: fl.flash_attention(q, k, v, causal=True,
                                                    return_lse=True),
            lambda q, k, v: fl.flash_attention_plain(q, k, v, causal=True,
                                                     return_lse=True),
            lambda q, k, v: sdpa(q, k, v, is_causal=True), qkv,
            s * (s + 1) // 2, f"kernel 2 {what} B={b} S={s} H={h} D={d} "
                              f"causal")
        if not case["err"] <= case["tol"]:
            fail(f"kernel 2 at {case['shape']}: {case['err']} > "
                 f"{case['tol']}")
        case.update(what=what, batch=b, attn=text_key(b, s, h, d))
        cases.append(case)
    return cases


def text_key(b: int, s: int, h: int, d: int) -> str:
    return f"B={b} S={s} H={h} D={d} causal"


def check_routes(tag: str, dev) -> None:
    """Phase 2, the tower routes of `model.tower_attn_impl`, each against
    the plain `mha`: `flash` runs kernel 2 non-causal, `encoder2` and
    `tpu_flash` run kernel 1. The shapes are those the paths launch: the
    CLIP-L/14-336 batch (B=4, S=577, H=16, D=64), the one-image calls of
    the law chain's embedding dumps, `encoder2` and `tpu_flash` at S=577
    (CLIP@336, DINOv2-L@336) and `flash` at S=257 (CLIP@224), and the
    C-score leg's extraction batches of C_BATCH images at S=577 and
    S=257 (the tail batch padded to the same shape)."""
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
                        (1, 257, ("flash",)),
                        (C_BATCH, 577, ("flash", "encoder2", "tpu_flash")),
                        (C_BATCH, 257, ("flash",))):
        q, k, v = (torch.randn((b, s, 16, 64), generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        ref = mha(q.float(), k.float(), v.float())
        print(f"{tag} tower routes [B={b} S={s} H=16 D=64]: library (SDPA) "
              f"{graph_ms(lambda: sdpa(q, k, v)):.4f} ms")
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


def narrow_config(intermediate_size: int = 688):
    """The narrow LLaVA of phases 3 to 3d: a 4-layer 336 px tower
    (head_dim 64) and 3 decoder layers with GQA (head_dim 64). The quantised
    phases take `intermediate_size=768`: kernel 10 wants whole 128-element
    k-tiles."""
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
                              intermediate_size=intermediate_size,
                              num_layers=3,
                              num_heads=4, num_kv_heads=2))


def quantise_pair(cpu, gpu, bits: int) -> None:
    """Quantise the CPU model's decoder and give the CUDA model the SAME
    codes and scales (quantising its own bf16-rounded weights would give
    other codes)."""
    from law_of_vision_representation_in_mllms_torch.ops import quant as Q
    Q.quantize_decoder(cpu.decoder, bits=bits)
    Q.quantize_decoder(gpu.decoder, bits=bits)       # the module structure
    gpu.load_state_dict(cpu.state_dict())


def check_narrow_llava(tag: str, dev, quantize=None, kv_quant=None) -> None:
    """Phase 3: narrow LLaVA, CUDA kernels in bf16 vs CPU plain fp32. Phase
    3d: the same with the decoder's weights quantised (`quantize`: "int4"
    runs kernel 10, "int8" the cast-and-matmul) and the int8 KV cache
    (kernel 3's int8 branch), the same codes and scales on both sides."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IMAGE_TOKEN_INDEX)
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec, int4_matmul as K)

    cfg = narrow_config(768 if quantize else 688)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    cpu = M.init_params(torch.Generator().manual_seed(0), cfg,
                        FP32_PRECISION, "cpu")
    gpu = M.LlavaParams(cfg, BF16_PRECISION, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    if quantize:
        quantise_pair(cpu, gpu, 4 if quantize == "int4" else 8)
    label = (f"narrow LLaVA quantize={quantize} kv_quant={kv_quant}"
             if quantize or kv_quant else "narrow LLaVA")
    before = (K.int4_matmul_kernel.launches,
              dec.decode_attention_int8.launches,
              dec.decode_attention.launches)

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
    ran = [a - b for a, b in zip((K.int4_matmul_kernel.launches,
                                  dec.decode_attention_int8.launches,
                                  dec.decode_attention.launches), before)]
    if quantize == "int4" and ran[0] == 0:
        fail(f"{label}: kernel 10 was not launched")
    if (ran[1] == 0) != (kv_quant is None) or (ran[2] == 0) != (
            kv_quant is not None):
        fail(f"{label}: wrong branch of kernel 3 (int8 {ran[1]}, dense "
             f"{ran[2]} launches)")
    print(f"{tag} {label} logits, prefill + {NARROW_STEPS - 1} decode "
          f"steps (CUDA bf16 kernels vs CPU fp32 plain): max_abs_err "
          f"{err:.4e} (tol {tol:.4e} = {LOGITS_REL_TOL} x max|logit|); "
          f"first-step argmax agree {first}; generate_greedy tokens agree "
          f"{agree:.3f}")
    if not (torch.isfinite(got).all() and err <= tol):
        fail(f"{label} logits disagree: {err} > {tol}")


def narrow_batch(device) -> dict:
    """The narrow training batch of phases 3b-3d and 19 (c) on `device`: 4
    right-padded rows of 40 ids (an image slot at 1), a 336 px image
    each."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IGNORE_INDEX, IMAGE_TOKEN_INDEX)
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
    return {"input_ids": torch.from_numpy(ids).to(device),
            "labels": torch.from_numpy(labels).to(device),
            "text_mask": torch.from_numpy(mask).to(device),
            "pixel_values": [torch.from_numpy(px).to(device)]}


def check_narrow_training(tag: str, dev, quantize_base=None,
                          variant=None) -> None:
    """Phase 3b: 3 stage-1 `make_train_step` steps on one batch of the
    narrow LLaVA, CUDA bf16 compute (fp32 weights; flash route with kernels
    2, 5 and 6 under block remat) against CPU fp32 plain attention, from the
    same weights. Per step: the loss and the gradient of what trains (the
    projector). Phase 3d repeats it through an int4 frozen decoder
    (`quantize_base`): kernel 10 forward under autograd, its transposed form
    `int4_matmul_dx` backward. `variant="lora"` trains rank-8 adapters (with a small non-zero
    B, so that A's gradient is not 0) and the projector over the frozen
    decoder, with `quantize_base` over the int4 one (QLoRA);
    `variant="switch"` trains the switch matrix alone; `variant="perceiver"`
    trains a `perceiver2x` projector, whose attention's gradient runs
    kernels 5 and 6 at Sq = 64, Skv = 640, non-causal (2 launches each a
    backward beside the decoder's 3)."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models import (
        lora as LR, switch as SW)
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)
    from law_of_vision_representation_in_mllms_torch.train import (
        train_step as TS)

    from law_of_vision_representation_in_mllms_torch.ops import (
        int4_matmul as K)
    cfg = narrow_config(768 if quantize_base else 688)
    if variant == "perceiver":
        cfg = dataclasses.replace(cfg, projector_type="perceiver2x")
    cpu = M.init_params(torch.Generator().manual_seed(1), cfg,
                        FP32_PRECISION, "cpu")
    gpu = M.LlavaParams(cfg, DEFAULT_PRECISION, device=dev)
    extra = {}
    if variant == "lora":
        lcfg = LR.LoraConfig(rank=8, alpha=16.0)
        cpu.lora = LR.init_lora(torch.Generator().manual_seed(2), cfg.decoder,
                                lcfg, FP32_PRECISION, "cpu")
        with torch.no_grad():
            for layer in cpu.lora.layers:
                for t in layer.targets:
                    getattr(layer, f"{t}_b").normal_(
                        0.0, 0.02, generator=torch.Generator().manual_seed(3))
        gpu.lora = LR.LoraAdapters(cfg.decoder, lcfg, DEFAULT_PRECISION,
                                   device=dev)
        # Adam moves every entry by about lr a step whatever its gradient's
        # size, so where a tiny gradient's sign differs between the sides
        # the parameters part by 2 lr; a tenth of phase 3b's rate keeps the
        # third step's gradients comparable (A's entries are ~0.01 themselves)
        extra = dict(stage=2, lora_rank=lcfg.rank, lora_alpha=lcfg.alpha,
                     learning_rate=1e-3)
    elif variant == "switch":
        cpu.switch = SW.init_switch(torch.Generator().manual_seed(2),
                                    cfg.decoder.hidden_size, FP32_PRECISION,
                                    "cpu")
        gpu.switch = SW.Switch(cfg.decoder.hidden_size, DEFAULT_PRECISION,
                               device=dev)
        extra = dict(stage=2, switch_sigma=1.0)
    gpu.load_state_dict(cpu.state_dict())
    if quantize_base:
        quantise_pair(cpu, gpu, 4 if quantize_base == "int4" else 8)
    k10_before = (K.int4_matmul_kernel.launches, K.int4_matmul_dx.launches)
    what = " ".join(["narrow training"] + ([f"variant={variant}"] if variant
                                           else [])
                    + ([f"quantize_base={quantize_base}"] if quantize_base
                       else []))

    tc_ref = TS.TrainConfig(**dict(dict(
        stage=1, learning_rate=1e-2, warmup_ratio=0.0,
        total_steps=TRAIN_STEPS), **extra))
    tc_got = dataclasses.replace(tc_ref, use_flash=True, remat=True)
    sides = []
    for params, tc, device in ((cpu, tc_ref, "cpu"), (gpu, tc_got, dev)):
        state, opt = TS.init_train_state(params, tc)
        sides.append((params, tc, narrow_batch(device), state,
                      TS.make_train_step(cfg, tc, opt),
                      [p for _, p in opt.named_params]))
    trained = sorted({n.split(".")[0] for n, _ in opt.named_params})
    if trained != {None: ["projector"], "lora": ["lora", "projector"],
                   "switch": ["switch"], "perceiver": ["projector"]}[variant]:
        fail(f"{what}: the trainable subtrees are {trained}")

    def trainable_grad(params, tc, bt, trainable):
        kw = dict(use_flash=tc.use_flash, remat=tc.remat)
        if tc.switch_sigma:
            loss = SW.switch_loss_fn(params, cfg, bt, tc.switch_sigma, **kw)
        else:
            loss = M.loss_fn(params, cfg, bt, lora_scaling=tc.lora_scaling,
                             **kw)
        grads = torch.autograd.grad(loss, trainable)
        return torch.cat([g.float().flatten().cpu() for g in grads])

    losses = ([], [])
    # the switch sits behind the decoder: its step runs kernel 2 and no
    # decoder backward
    bwd = ((fl.flash_attention,) if variant == "switch" else
           (fl.flash_attention_bwd_dq, fl.flash_attention_bwd_dkv))
    before = [c.launches for c in bwd]
    for step in range(TRAIN_STEPS):
        g_ref, g_got = (trainable_grad(p, tc, bt, trainable)
                        for p, tc, bt, _, _, trainable in sides)
        rel = ((g_got - g_ref).norm() / g_ref.norm()).item()
        for i, (_, _, bt, state, step_fn, _) in enumerate(sides):
            _, m = step_fn(state, bt)
            losses[i].append(float(m["loss"]))
            if float(m["skipped_nonfinite"]) != 0.0:
                fail(f"narrow training step {step + 1} was skipped")
        ref, got = losses[0][-1], losses[1][-1]
        loss_rel = abs(got - ref) / abs(ref)
        print(f"{tag} {what} step {step + 1} (CUDA bf16 kernels vs "
              f"CPU fp32 plain): loss {got:.6f} vs {ref:.6f}, rel err "
              f"{loss_rel:.3e} (tol {TRAIN_LOSS_REL_TOL}); "
              f"{' + '.join(trained)} grad rel err {rel:.3e} (tol "
              f"{TRAIN_GRAD_REL_TOL})")
        if not (np.isfinite(got) and loss_rel <= TRAIN_LOSS_REL_TOL):
            fail(f"{what}: the loss disagrees at step {step + 1}")
        if not rel <= TRAIN_GRAD_REL_TOL:
            fail(f"{what}: the gradient disagrees at step {step + 1}")
    if any(c.launches == n for c, n in zip(bwd, before)):
        fail(f"{what} on CUDA did not launch "
             f"{[c.__name__ for c in bwd]}")
    if variant == "perceiver":
        # two backward passes a step (the gradient held, then the step's)
        want = 2 * TRAIN_STEPS * (cfg.decoder.num_layers
                                  + len(gpu.projector.layers))
        ran = [c.launches - n for c, n in zip(bwd, before)]
        print(f"{tag} {what}: kernels 5 and 6 launched {ran} times "
              f"(decoder and perceiver, {want} each expected)")
        if ran != [want, want]:
            fail(f"{what}: kernels 5 and 6 launched {ran}, not {want} "
                 f"each")
    if quantize_base == "int4" and (
            K.int4_matmul_kernel.launches == k10_before[0]
            or K.int4_matmul_dx.launches == k10_before[1]):
        fail(f"{what} launched kernel 10 "
             f"{K.int4_matmul_kernel.launches - k10_before[0]} times and its "
             f"transposed form {K.int4_matmul_dx.launches - k10_before[1]}")
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


# phase 3's token variants: the narrow tower's 576 tokens pruned to 144;
# anyres: a base view and 2 x 2 crops of a 600 x 400 image (rows masked)
NARROW_KEEP = 144
ANYRES_GRID = (2, 2)
ANYRES_SIZE = (600, 400)


def narrow_variant_config(variant: str):
    """`narrow_config` under one of phase 3's variants: `perceiver2x`; `mof`,
    the narrow tower and a narrow DINOv2-like one (erf GELU, no pre-LN,
    patch bias; 3 layers) with a projector each; `keep_saliency` /
    `keep_norm`, `visual_keep` = NARROW_KEEP by the tower's CLS attention
    or the token norm; `anyres`, the plain narrow model (its splice masked
    by `image_valid`)."""
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        TowerEntry, TowerSpec)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTConfig)
    cfg = narrow_config()
    if variant == "perceiver2x":
        return dataclasses.replace(cfg, projector_type="perceiver2x")
    if variant == "mof":
        vit = ViTConfig(image_size=336, patch_size=14, hidden_size=256,
                        num_layers=3, num_heads=4, intermediate_size=1024,
                        hidden_act="gelu", layer_norm_eps=1e-6,
                        use_pre_layernorm=False, patch_bias=True)
        dino = TowerEntry(name="narrow-dinov2-336", kind="vit",
                          vit_config=vit, vit_family="dinov2",
                          hidden_size=256, num_patches=vit.num_patches,
                          img_size=336)
        return dataclasses.replace(cfg, tower_spec=TowerSpec(
            entries=[*cfg.tower_spec.entries, dino], join="mof"))
    if variant.startswith("keep_"):
        return dataclasses.replace(cfg, visual_keep=NARROW_KEEP,
                                   prune_score=variant[len("keep_"):])
    return cfg


def prune_scores(params, cfg, pixels):
    """The scores `encode_images` prunes by (fp32 [B, P]): the lead tower's
    CLS attention from its last block, or the projected tokens' norm."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    with torch.no_grad():
        if cfg.prune_score == "norm":
            full = M.encode_images(params, dataclasses.replace(
                cfg, visual_keep=None), pixels)
            return torch.linalg.vector_norm(full.float(), dim=-1)
        return M._vit_forward_with_saliency(params.towers[0],
                                            pixels[0])[1].float()


def check_kept_tokens(tag: str, what: str, ref_scores, got_scores,
                      keep: int):
    """The token sets a card run keeps against the CPU's: equal, or parted
    only at a near tie of the CPU's scores. Phase 4's rule for tokens, made
    no looser than this run's own score error: each score of the card within
    LOGITS_REL_TOL of the row's max|score| of the CPU's, and each token in
    one set and not the other within twice the row's largest score error
    (at most LOGITS_REL_TOL of max|score|) of the boundary between the K-th
    and (K+1)-th CPU scores. Returns (the CPU's kept indices, the card's,
    the rows whose sets part)."""
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    ref_scores, got_scores = ref_scores.float().cpu(), got_scores.float().cpu()
    ref_idx = M._top_k(ref_scores, keep)[1].sort(dim=-1).values
    got_idx = M._top_k(got_scores, keep)[1].sort(dim=-1).values
    parted = 0
    for r in range(ref_scores.shape[0]):
        row = ref_scores[r]
        scale = row.abs().max().item()
        row_err = (got_scores[r] - row).abs().max().item()
        if row_err > LOGITS_REL_TOL * scale:
            fail(f"{what}: the card's prune scores of row {r} are "
                 f"{row_err:.3e} off the CPU's (tol "
                 f"{LOGITS_REL_TOL * scale:.3e})")
        a, b = set(ref_idx[r].tolist()), set(got_idx[r].tolist())
        if a == b:
            continue
        parted += 1
        top = row.sort(descending=True).values
        edge = (top[keep - 1] + top[keep]) / 2
        tol = (min(2 * row_err, LOGITS_REL_TOL * scale)
               + (top[keep - 1] - top[keep]) / 2).item()
        worst = max(abs(row[i].item() - edge.item()) for i in a ^ b)
        print(f"{tag} {what}: row {r} keeps {len(a ^ b) // 2} other tokens "
              f"on the card; the farthest from the CPU's K-th / (K+1)-th "
              f"boundary is {worst:.3e} (near-tie bound {tol:.3e})")
        if worst > tol:
            fail(f"{what}: the card kept tokens of row {r} that the CPU's "
                 f"scores do not put near the boundary ({worst} > {tol})")
    score_err = (max_err(got_scores, ref_scores)
                 / ref_scores.abs().max().item())
    print(f"{tag} {what}: prune scores card vs CPU max err {score_err:.3e} "
          f"of max|score|; kept sets equal in "
          f"{ref_scores.shape[0] - parted} of {ref_scores.shape[0]} rows")
    return ref_idx, got_idx, parted


@contextlib.contextmanager
def forced_prune(idx):
    """`llava.prune_visual_tokens` keeps the tokens `idx` [B, K] whatever
    the scores (the CPU reference fed a card run's index set)."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    orig = M.prune_visual_tokens

    def take(tokens, scores, keep):
        i = idx.to(tokens.device)
        return torch.gather(tokens, 1, i[..., None].expand(
            -1, -1, tokens.shape[-1]))
    M.prune_visual_tokens = take
    try:
        yield
    finally:
        M.prune_visual_tokens = orig


def anyres_prefill(params, cfg, ids, mask, pixels, n_new: int):
    """A prefill over an anyres splice: each row's base view and its 2 x 2
    crops (`pixels[0]` [B * 5, ...]) through tower and projector, assembled
    by `models.anyres.assemble_anyres_tokens` into [base; crop grid] tokens
    with the unpad mask, spliced with `image_valid`. The masked tokens sit
    between valid ones, where kernel 2 (no key mask) cannot go: the prefill
    takes the decoder's masked attention; the decode steps run kernel 3
    over the cache's holes. Returns (`llava.Prefill`, kept image tokens)."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.models import anyres as A
    from law_of_vision_representation_in_mllms_torch.models import llama as L
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IGNORE_INDEX, splice_embeds, splice_plan)
    dec = params.decoder
    b = ids.shape[0]
    views = 1 + ANYRES_GRID[0] * ANYRES_GRID[1]
    with torch.inference_mode():
        feats = M.encode_images(params, cfg, pixels).float().cpu().numpy()
    grid = int(round(feats.shape[1] ** 0.5))
    tokens, valid = [], []
    for r in range(b):
        f = feats[r * views:(r + 1) * views]
        t, v = A.assemble_anyres_tokens(f[0], f[1:], ANYRES_GRID,
                                        ANYRES_SIZE, grid)
        tokens.append(t)
        valid.append(v)
    dev = ids.device
    img = torch.from_numpy(np.stack(tokens)).to(dev, dec.precision
                                                 .compute_dtype)
    image_valid = torch.from_numpy(np.stack(valid)).to(dev)
    with torch.inference_mode():
        plan = splice_plan(ids, torch.full_like(ids, IGNORE_INDEX), mask,
                           img.shape[1], image_valid=image_valid)
        embeds = splice_embeds(plan, L.embed_tokens(dec, ids), img)
        l_out = embeds.shape[1]
        cache = L.init_cache(cfg.decoder, b, l_out + n_new,
                             dec.precision.compute_dtype, dev)
        slot_valid = torch.cat([plan.attn_mask, torch.zeros(
            (b, n_new), dtype=torch.bool, device=dev)], dim=1)
        h, cache = dec(embeds, plan.positions, attn_mask=slot_valid,
                       cache=cache, cache_index=0, use_flash=False)
        n_valid = plan.attn_mask.sum(dim=1)
        last = plan.positions.argmax(dim=1)        # the last valid slot
        logits = L.logits_fn(dec, h[torch.arange(b, device=dev), last])
    return M.Prefill(logits=logits, cache=cache, slot_valid=slot_valid,
                     n_valid=n_valid, l_out=l_out), int(image_valid.sum())


def check_narrow_variant(tag: str, dev, variant: str) -> None:
    """Phase 3, the projector and token variants on the narrow LLaVA: the
    logits of a prefill and 3 decode steps, CUDA bf16 with the kernels
    against CPU fp32 plain, fed the CPU's greedy tokens (`LOGITS_REL_TOL`
    of max|logit|). `perceiver2x` (its attention on kernel 2 at Sq 64, Skv
    640: 2 launches an encode), `mof` (two towers on kernel 1, tokens
    interleaved: 1,152), `keep_saliency` / `keep_norm` (144 of 576 tokens
    kept; the kept sets held by `check_kept_tokens`, and where they part at
    a near tie the CPU is fed the card's set) and `anyres` (a base view and
    2 x 2 crops, the unpad mask over the splice, `anyres_prefill`)."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IMAGE_TOKEN_INDEX)
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec, encoder_attention as enc,
        flash_attention as fl)

    cfg = narrow_variant_config(variant)
    cpu = M.init_params(torch.Generator().manual_seed(5), cfg,
                        FP32_PRECISION, "cpu")
    gpu = M.LlavaParams(cfg, BF16_PRECISION, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    label = f"narrow LLaVA [{variant}]"
    rng = np.random.RandomState(5)
    b = 2
    ids = rng.randint(3, 1000, size=(b, 24)).astype(np.int64)
    ids[:, 1] = IMAGE_TOKEN_INDEX
    mask = np.ones((b, 24), bool)
    mask[1, 16:] = False
    views = 1 + ANYRES_GRID[0] * ANYRES_GRID[1] if variant == "anyres" else 1
    px = [rng.randn(b * views, 336, 336, 3).astype(np.float32)
          for _ in cfg.tower_spec.entries]

    def inputs(device):
        return (torch.from_numpy(ids).to(device),
                torch.from_numpy(mask).to(device),
                [torch.from_numpy(p).to(device) for p in px])

    forced = contextlib.nullcontext()
    if cfg.visual_keep is not None:
        ref_idx, got_idx, parted = check_kept_tokens(
            tag, label, prune_scores(cpu, cfg, inputs("cpu")[2]),
            prune_scores(gpu, cfg, inputs(dev)[2]), cfg.visual_keep)
        if parted:
            forced = forced_prune(got_idx)
    counts = (enc.encoder_attention, fl.flash_attention,
              dec.decode_attention)
    before = [c.launches for c in counts]
    with forced:
        if variant == "anyres":
            pre_ref, n_img = anyres_prefill(cpu, cfg, *inputs("cpu"),
                                            NARROW_STEPS)
        else:
            pre_ref = M.prefill(cpu, cfg, *inputs("cpu"),
                                max_new_tokens=NARROW_STEPS)
    if variant == "anyres":
        pre_got, n_got = anyres_prefill(gpu, cfg, *inputs(dev), NARROW_STEPS)
        if n_got != n_img:
            fail(f"{label}: the unpad masks differ ({n_got} vs {n_img})")
    else:
        pre_got = M.prefill(gpu, cfg, *inputs(dev),
                            max_new_tokens=NARROW_STEPS)
    ran_prefill = [c.launches - n for c, n in zip(counts, before)]
    ref_steps, got_steps = [pre_ref.logits], [pre_got.logits.float().cpu()]
    for t in range(NARROW_STEPS - 1):
        tok = ref_steps[-1].argmax(-1)
        ref_steps.append(M.decode_step(cpu, pre_ref, tok, t))
        got_steps.append(M.decode_step(gpu, pre_got, tok.to(dev), t)
                         .float().cpu())
    ran = [c.launches - n for c, n in zip(counts, before)]
    ref, got = torch.stack(ref_steps), torch.stack(got_steps)
    err = max_err(got, ref)
    tol = LOGITS_REL_TOL * ref.abs().max().item()
    n_tok = pre_got.l_out - ids.shape[1] + 1
    want_tok = {"perceiver2x": 64, "mof": 2 * 576,
                "anyres": 5 * 576}.get(variant, cfg.num_patches)
    print(f"{tag} {label} logits, prefill + {NARROW_STEPS - 1} decode steps "
          f"(CUDA bf16 kernels vs CPU fp32 plain): max_abs_err {err:.4e} "
          f"(tol {tol:.4e} = {LOGITS_REL_TOL} x max|logit|); {n_tok} image "
          f"tokens spliced; launches (kernels 1, 2, 3) {ran}")
    if not (torch.isfinite(got).all() and err <= tol):
        fail(f"{label} logits disagree: {err} > {tol}")
    if n_tok != want_tok:
        fail(f"{label}: {n_tok} image tokens, not {want_tok}")
    towers = len(cfg.tower_spec.entries)
    layers = sum(e.vit_config.resolve_layer(cfg.select_layer)
                 for e in cfg.tower_spec.entries)
    want_k2 = (0 if variant == "anyres" else cfg.decoder.num_layers) + (
        2 if variant == "perceiver2x" else 0)
    want = [layers, want_k2,
            (NARROW_STEPS - 1) * cfg.decoder.num_layers]
    if ran_prefill[:2] != want[:2] or ran[2] != want[2]:
        fail(f"{label}: kernels 1, 2, 3 launched {ran_prefill[:2]} + "
             f"{ran[2]}, not {want} ({towers} towers)")


def check_narrow_mpt(tag: str, dev) -> None:
    """A narrow MPT (3 layers, 4 heads of 64): logits and the `wqkv`
    gradients of a next-token loss, CUDA bf16 compute through kernels 2, 5
    and 6 with the in-kernel ALiBi bias against CPU fp32 on the plain biased
    `mha`, from the same fp32 weights."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import mpt
    from law_of_vision_representation_in_mllms_torch.models.llama import (
        causal_lm_loss)
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl)

    cfg = mpt.MptConfig(vocab_size=1000, hidden_size=256, num_layers=3,
                        num_heads=4)
    cpu = mpt.init_params(torch.Generator().manual_seed(3), cfg,
                          FP32_PRECISION, "cpu")
    gpu = mpt.MptModel(cfg, DEFAULT_PRECISION, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(2, 200)))
    wrappers = (fl.flash_attention, fl.flash_attention_bwd_dq,
                fl.flash_attention_bwd_dkv)
    before = [w.alibi_launches for w in wrappers]
    sides = []
    for model, x, use_flash in ((cpu, ids, False), (gpu, ids.to(dev), None)):
        wqkv = [layer.wqkv.weight.requires_grad_() for layer in model.layers]
        logits = model(x, use_flash=use_flash)
        grads = torch.autograd.grad(causal_lm_loss(logits, x), wqkv)
        sides.append((logits.detach().float().cpu(),
                      torch.cat([g.float().flatten().cpu() for g in grads])))
    torch.cuda.synchronize()
    ran = [w.alibi_launches - n for w, n in zip(wrappers, before)]
    if ran != [cfg.num_layers] * 3:
        fail(f"narrow MPT on CUDA: ALiBi launches of kernels 2, 5, 6 {ran}, "
             f"not {cfg.num_layers} each")
    (ref, g_ref), (got, g_got) = sides
    err, tol = max_err(got, ref), LOGITS_REL_TOL * ref.abs().max().item()
    rel = ((g_got - g_ref).norm() / g_ref.norm()).item()
    print(f"{tag} narrow MPT (3 layers, H=4, D=64, B=2, S=200; CUDA bf16 "
          f"ALiBi kernels vs CPU fp32 plain): logits max_abs_err {err:.4e} "
          f"(tol {tol:.4e} = {LOGITS_REL_TOL} x max|logit|); wqkv grad rel "
          f"err {rel:.3e} (tol {TRAIN_GRAD_REL_TOL})")
    if not (torch.isfinite(got).all() and err <= tol):
        fail(f"narrow MPT logits disagree: {err} > {tol}")
    if not rel <= TRAIN_GRAD_REL_TOL:
        fail(f"narrow MPT wqkv gradients disagree: {rel}")


def run_full_width_mpt(tag: str, dev, counters) -> dict:
    """MPT-7B at full width (`MptConfig()`: vocab 50,432, d 4,096, 32 layers,
    32 heads, expansion 4) on seeded random bf16 weights: a forward at B=2,
    S=2,048 and a forward + backward of the next-token loss. Kernel 2 (one
    pass) and kernels 5, 6 must each have launched their ALiBi form 32
    times."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import mpt
    from law_of_vision_representation_in_mllms_torch.models.llama import (
        causal_lm_loss)

    cfg = mpt.MptConfig()
    b, s = 2, 2048
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    model = mpt.init_params(g, cfg, BF16_PRECISION, dev)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{tag} MPT-7B ({n_params / 1e9:.3f} B params, seeded random bf16) "
          f"built on the card in {time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")

    def sync_time(fn):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    # the main path, counted: one forward, one forward + backward
    reset_counts(counters)
    with torch.no_grad():
        logits = model(ids)
    torch.cuda.synchronize(dev)
    fwd = read_counts(counters)
    if not (logits.shape == (b, s, cfg.vocab_size)
            and logits.dtype == torch.float32
            and torch.isfinite(logits).all()):
        fail("MPT-7B logits are not finite fp32 [B, S, V]")
    spread = logits.std().item()
    del logits
    for p in model.parameters():
        p.requires_grad_(True)

    def train_pass():
        loss = causal_lm_loss(model(ids), ids)
        loss.backward()
        return loss.detach()
    loss, _ = sync_time(train_pass)
    launches = read_counts(counters)
    print(f"{tag} MPT-7B main path launches: forward {fwd}; forward + "
          f"backward after it {launches}")
    want = {"flash_attention_alibi": 2 * cfg.num_layers,
            "flash_attention_bwd_dq_alibi": cfg.num_layers,
            "flash_attention_bwd_dkv_alibi": cfg.num_layers}
    if fwd["flash_attention_alibi"] != cfg.num_layers:
        fail(f"kernel 2 (ALiBi) ran {fwd['flash_attention_alibi']} times in "
             f"one MPT-7B forward, not {cfg.num_layers}")
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{name} ran {launches[name]} times over the two MPT-7B "
                 f"passes, not {n}")
    if not torch.isfinite(loss):
        fail(f"MPT-7B loss is not finite: {loss.item()}")
    worst = 0.0
    for name, p in model.named_parameters():
        if p.grad is None or not torch.isfinite(p.grad).all():
            fail(f"MPT-7B gradient of {name} is missing or not finite")
        worst = max(worst, p.grad.float().abs().max().item())
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # timings: warm passes, host clock around synchronised work
    with torch.no_grad():
        _, fwd_s = sync_time(lambda: [model(ids) for _ in range(2)])
    fwd_s /= 2
    for p in model.parameters():
        p.grad = None
    _, train_s = sync_time(train_pass)
    print(f"{tag} MPT-7B (B={b}, S={s}): forward {fwd_s * 1e3:.1f} ms "
          f"({b * s / fwd_s:.0f} tokens/s); forward + backward "
          f"{train_s * 1e3:.1f} ms ({b * s / train_s:.0f} tokens/s); loss "
          f"{loss.item():.4f} (log V = {math.log(cfg.vocab_size):.4f}), logit "
          f"std {spread:.4f}, largest |gradient| {worst:.3e}; peak memory "
          f"allocated {peak_gb:.2f} GB")
    for p in model.parameters():
        p.grad = None
    del model, ids, loss
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _requests(n: int, crop: int, diffusion: bool = False):
    """Phase 4's requests: 30-42 words and one image each, preprocessed
    for CLIP (or, `diffusion`, to [-1, 1] as a diffusion tower takes it)."""
    import numpy as np
    from law_of_vision_representation_in_mllms_torch.data.image_processing \
        import CLIP_MEAN, CLIP_STD
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(n):
        img = rng.rand(crop, crop, 3).astype(np.float32)
        if diffusion:
            img = img * 2.0 - 1.0
        else:
            img = (img - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(
                CLIP_STD, np.float32)
        prompt = " ".join(rng.choice(WORDS, size=30 + 4 * i))
        reqs.append(Instance("generate_until", {}, i, "smoke",
                             (prompt, {"max_new_tokens": 32}), [img]))
    return reqs


def profile_decode(tag: str, label: str, lmm, ids, mask, pixels,
                   steps: int = 4) -> None:
    """torch.profiler over `steps` warm decode steps after a prefill: device
    time a step by kernel family, the step's wall time and the device's idle
    share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from law_of_vision_representation_in_mllms_torch.models import llava as M

    pre = M.prefill(lmm.params, lmm.cfg, ids, mask, pixels,
                    max_new_tokens=steps + 2)
    tok = pre.logits.argmax(-1)
    tok = M.decode_step(lmm.params, pre, tok, 0).argmax(-1)      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, steps + 1):
            tok = M.decode_step(lmm.params, pre, tok, t).argmax(-1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    families, launched = device_split(prof)
    busy = sum(families.values()) / steps
    if busy == 0.0:
        print(f"{tag} [{label}] profiler: no device time recorded; decode "
              f"split not measured")
        return
    print(f"{tag} [{label}] profiled decode step (mean of {steps}, profiler "
          f"on): wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{max(0.0, 1 - busy / wall_ms):.3f}, {launched // steps} device "
          f"activities a step: " + ", ".join(
              f"{fam} {ms / steps:.2f} ms"
              for fam, ms in sorted(families.items(), key=lambda kv: -kv[1])))


def device_split(prof) -> tuple:
    """(device ms by kernel family, device activities) of a profile."""
    from torch.autograd import DeviceType
    families, launched = {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name, low = e.name, e.name.lower()
        # "int4_" ahead of the cuBLAS names: a kernel of ours whose name held
        # "gemm" would otherwise count as the library's
        if "int4_" in name:
            fam = "kernel 10 (int4 matmul)"
        elif "decode_kernel" in name:
            fam = "kernel 3 (decode attention)"
        elif any(x in low for x in ("gemm", "gemv", "cutlass", "xmma",
                                    "nvjet", "cublas")):
            fam = "matmul (cuBLAS)"
        elif "memcpy" in low or "memset" in low:
            fam = "copies and memsets"
        else:
            fam = "elementwise, reductions, casts"
        families[fam] = families.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
        launched += 1
    return families, launched


def profile_chunk(tag: str, label: str, lmm, ids, mask, pixels,
                  replays: int = 3) -> None:
    """torch.profiler over `replays` replays of the captured 16-step chunk
    (`models.decode.ChunkedGreedyDecoder`, eos never emitted): device time a
    step by kernel family, the step's wall time and the device's idle
    share, beside `profile_decode`'s eager step. Each replay restarts the
    chunk at step 0 (`t0`), so it writes the same cache slots."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from law_of_vision_representation_in_mllms_torch.models.decode import (
        ChunkedGreedyDecoder)

    dec = ChunkedGreedyDecoder(lmm.params, lmm.cfg, eos_id=-1,
                               chunk=DECODE_CHUNK)
    dec.generate(ids, mask, pixels, max_new_tokens=2 * DECODE_CHUNK)
    (st,) = dec._keys.values()

    def replay():
        # the static tensors are inference tensors (made under the
        # decoder's inference mode)
        with torch.inference_mode():
            st.t0.zero_()
            st.step()
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(replays):
            replay()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (replays * DECODE_CHUNK)
    families, launched = device_split(prof)
    steps = replays * DECODE_CHUNK
    busy = sum(families.values()) / steps
    if busy == 0.0:
        print(f"{tag} [{label}] profiler: no device time recorded in the "
              f"graph replays; the captured chunk's split not measured")
        return
    print(f"{tag} [{label}] profiled captured chunk (CUDA graph of "
          f"{DECODE_CHUNK} decode steps, {replays} replays, profiler on), a "
          f"step: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms, idle "
          f"share {max(0.0, 1 - busy / wall_ms):.3f}, {launched / steps:.0f} "
          f"device activities a step: " + ", ".join(
              f"{fam} {ms / steps:.2f} ms"
              for fam, ms in sorted(families.items(), key=lambda kv: -kv[1])))


def profile_formats(tag: str, dev) -> None:
    """Phase 8: the decode step's device-time split for the three weight
    formats, eager and replayed from the captured chunk, each model built
    again (half a second). It runs last: a
    torch.profiler session leaves its tracing attached to the process, and
    every later launch costs the host more."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    for model in SERVING_FORMATS:
        lmm = build_lmm(RunConfig.from_dict({"model": model}), device=dev)
        ids, mask, pixels = lmm._encode_batch(
            _requests(4, lmm.processors[0].crop))
        profile_decode(tag, format_label(model), lmm, ids, mask, pixels)
        profile_chunk(tag, format_label(model), lmm, ids, mask, pixels)
        del lmm, ids, mask, pixels
        gc.collect()
        torch.cuda.empty_cache()


def format_label(model: dict) -> str:
    return ", ".join(f"{k}={v}" for k, v in model.items()
                     if k != "decode_attn") or "bf16"


def run_full_width(tag: str, dev, counters, model=None, bf16=None):
    """Phase 4: LLaVA-1.5-7B at full width through the adapter. Phase 7: the
    same requests with the `model` knobs of quantised serving (`quantize`,
    `kv_quant`), its figures printed beside the bf16 run's (`bf16`). Returns
    (launches of the counted run, figures)."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.ops.quant import (
        quantized_bytes)

    model = model or {}
    quantize, kv_quant = model.get("quantize"), model.get("kv_quant")
    label = format_label(model)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lmm = build_lmm(RunConfig.from_dict({"model": model}), device=dev)
    torch.cuda.synchronize(dev)
    n_params = sum(p.numel() for p in lmm.params.parameters())
    build_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    resident_gb = quantized_bytes(lmm.params) / 1e9
    print(f"{tag} LLaVA-1.5-7B [{label}] ({n_params / 1e9:.3f} B dense "
          f"params, seeded random) built on the card in "
          f"{time.perf_counter() - t0:.2f} s; weights resident "
          f"{resident_gb:.2f} GB, {torch.cuda.memory_allocated(dev) / 1e9:.2f}"
          f" GB allocated after the build, peak during it "
          f"{build_peak_gb:.2f} GB")
    # from here on the peak is the serving run's own
    torch.cuda.reset_peak_memory_stats(dev)
    reqs = _requests(4, lmm.processors[0].crop)
    dec = lmm.cfg.decoder
    dec_name = "decode_attention_int8" if kv_quant else "decode_attention"

    # the main path, counted: greedy decoding on the card runs the
    # adapter's chunked decoder, each 16-step chunk a CUDA graph, which
    # this first call captures (after a warm-up chunk run eagerly)
    graph_dec = lmm.chunked_decoder()
    if graph_dec.chunk != DECODE_CHUNK:
        fail(f"the adapter's decode chunk is {graph_dec.chunk}, not "
             f"{DECODE_CHUNK}")
    t0 = time.perf_counter()
    texts, launches = counted_run(counters, lambda: lmm.generate_until(reqs),
                                  graph_dec)
    first_s = time.perf_counter() - t0
    steps = launches[dec_name] // dec.num_layers
    print(f"{tag} [{label}] main path launches {launches} ({steps} decode "
          f"steps: {DECODE_CHUNK} of the warm-up chunk before the capture, "
          f"{graph_dec.replays * DECODE_CHUNK} replayed)")
    if launches["encoder_attention"] < 23:
        fail("encoder_attention ran fewer than 23 times in one tower call")
    if launches["flash_attention"] < dec.num_layers:
        fail("flash_attention ran fewer than 32 times in the prefill")
    if launches[dec_name] < dec.num_layers or launches[dec_name] % \
            dec.num_layers:
        fail(f"{dec_name} did not run 32 times per decode step")
    if kv_quant and launches["decode_attention"]:
        fail(f"the dense branch of kernel 3 ran {launches['decode_attention']}"
             f" times over an int8 cache")
    if not kv_quant and launches["decode_attention_int8"]:
        fail("the int8 branch of kernel 3 ran over a dense cache")
    # 7 weight matmuls a layer and the lm_head, in the prefill and each step
    k10 = (7 * dec.num_layers + 1) * (steps + 1) if quantize == "int4" else 0
    if launches["int4_matmul"] != k10:
        fail(f"kernel 10 ran {launches['int4_matmul']} times, not {k10}")

    # the eager greedy decode's token ids: in range, deterministic (the
    # reference the graph path's tokens and text are held to in phase 4b)
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
    pre = M.prefill(lmm.params, lmm.cfg, ids, mask, pixels, max_new_tokens=2)
    step_logits = M.decode_step(lmm.params, pre, pre.logits.argmax(-1), 0)
    if not (torch.isfinite(pre.logits).all()
            and torch.isfinite(step_logits).all()
            and step_logits.shape == (ids.shape[0], dec.vocab_size)):
        fail(f"[{label}] the logits are not finite [B, V]")
    del pre, step_logits

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
    setattr(*counters[dec_name], 0)
    gen_s = timed(generate)                       # 1 warm-up + 3 timed runs
    gen_steps = getattr(*counters[dec_name]) // dec.num_layers // 4
    if gen_steps == 0:
        fail("the timed generate ran no decode step")
    b = ids.shape[0]
    fig = dict(prefill_ms=prefill_s * 1e3,
               decode_tok_s=b * gen_steps / (gen_s - prefill_s),
               step_ms=(gen_s - prefill_s) / gen_steps * 1e3,
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
               build_peak_gb=build_peak_gb, resident_gb=resident_gb)
    seq = ids.shape[1] + lmm.cfg.num_patches - 1
    print(f"{tag} [{label}] tower (CLIP-L/14-336, B={b}): "
          f"{b / tower_s:.1f} images/s ({tower_s * 1e3:.2f} ms)")
    print(f"{tag} [{label}] prefill (tower + projector + splice + 32-layer "
          f"prefill, B={b}, S={seq}): {fig['prefill_ms']:.2f} ms")
    print(f"{tag} [{label}] decode (B={b}, {gen_steps} steps, (generate - "
          f"prefill) time): {fig['decode_tok_s']:.1f} tokens/s "
          f"({fig['step_ms']:.2f} ms/step)")
    print(f"{tag} [{label}] peak memory allocated while serving: "
          f"{fig['peak_gb']:.2f} GB")
    print(f"{tag} [{label}] sample answer: {texts[0][:80]!r}")
    # phase 4b: the serving backends on this model
    backend_paths = check_backends(tag, dev, counters, lmm, label, reqs,
                                   texts, toks, fig, quantize, first_s,
                                   every=bf16 is None)
    # phase 4c: the inflight engine, in bf16 and under int4 + kv8
    if bf16 is None or model == SERVING_FORMATS[1]:
        backend_paths.update(run_inflight(tag, dev, counters, lmm, label,
                                          quantize, fig["decode_cases"],
                                          serve=bf16 is None))
    # phase 14: the eval zoo, in bf16; phase 15: the projector and token
    # variants on the same weights
    if bf16 is None:
        backend_paths["eval_zoo"] = run_eval_zoo(tag, dev, counters, lmm,
                                                 label, fig)
        backend_paths.update(run_variants(tag, dev, counters, lmm, label,
                                          fig))
    if bf16 is not None:
        print(f"{tag} [{label}] beside the bf16 run: prefill "
              f"{fig['prefill_ms']:.2f} vs {bf16['prefill_ms']:.2f} ms, "
              f"decode {fig['decode_tok_s']:.1f} vs "
              f"{bf16['decode_tok_s']:.1f} tokens/s ({fig['step_ms']:.2f} "
              f"vs {bf16['step_ms']:.2f} ms/step), weights "
              f"{fig['resident_gb']:.2f} vs {bf16['resident_gb']:.2f} GB, "
              f"serving peak {fig['peak_gb']:.2f} vs {bf16['peak_gb']:.2f} "
              f"GB")
        if not fig["peak_gb"] < bf16["peak_gb"]:
            fail(f"[{label}] the serving peak {fig['peak_gb']:.2f} GB is not "
                 f"below the bf16 run's {bf16['peak_gb']:.2f} GB: a dense "
                 f"weight survived the quantisation")
    return launches, fig, backend_paths


def timed_s(fn, dev, reps: int = 3) -> float:
    """Host seconds of one synchronised `fn()`, the mean of `reps` after a
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t) / reps


def counted_run(counters, fn, decoder=None):
    """`fn()` with every launch count set to 0 just before and read just
    after. Through a `ChunkedGreedyDecoder`, a wrapper counts where a capture
    records its kernel, which launches nothing, and not at the replays: the
    launches are the counts less what the run's captures recorded, plus the
    recorded launches times the run's replays. Returns (fn's result,
    launches)."""
    import torch
    if decoder is not None:
        recorded0 = dict(decoder.recorded)
        graph0 = decoder.graph_launches()
    reset_counts(counters)
    out = fn()
    torch.cuda.synchronize()
    launches = read_counts(counters)
    if decoder is not None:
        graph = decoder.graph_launches()
        for name, n in decoder.recorded.items():
            launches[name] += (graph[name] - graph0[name]
                               - (n - recorded0[name]))
    return out, launches


def near_tie_gaps(lmm, inputs, want, got, chosen: bool = False) -> list:
    """For each row where `got` differs from the eager greedy tokens
    `want`: (row, first differing step, the eager path's top-2 logit gap
    there relative to the row's max |logit|), the eager steps fed `want`.
    With `chosen`, the gap is the eager top logit less the eager logit of
    the token `got` chose there, which is at least the top-2 gap."""
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    diff = got.cpu() != want.cpu()
    first = {r: int(diff[r].nonzero()[0]) for r in range(diff.shape[0])
             if diff[r].any()}
    if not first:
        return []
    pre = M.prefill(lmm.params, lmm.cfg, *inputs,
                    max_new_tokens=want.shape[1])
    logits, gaps = pre.logits, []
    for t in range(max(first.values()) + 1):
        if t:
            logits = M.decode_step(lmm.params, pre, want[:, t - 1], t - 1)
        for r, step in first.items():
            if step == t:
                row = logits[r].float()
                top2 = row.topk(2).values
                other = row[got[r, step]] if chosen else top2[1]
                gaps.append((r, step, ((top2[0] - other)
                                       / row.abs().max()).item()))
    return gaps


def check_tokens(tag: str, label: str, what: str, lmm, inputs, want,
                 got) -> None:
    """`got` must be the eager greedy tokens `want`, or differ from them
    only after a near-tie of the eager logits: a top-2 gap within phase 3's
    bf16 logits tolerance (`LOGITS_REL_TOL` of the row's max |logit|)."""
    gaps = near_tie_gaps(lmm, inputs, want, got)
    if not gaps:
        print(f"{tag} [{label}] {what}: tokens equal to the eager greedy "
              f"decode's")
        return
    for r, step, gap in gaps:
        print(f"{tag} [{label}] {what}: row {r} first differs at step "
              f"{step}; the eager top-2 logit gap there is {gap:.3e} of "
              f"max|logit| (near-tie bound {LOGITS_REL_TOL})")
        if gap > LOGITS_REL_TOL:
            fail(f"[{label}] {what}: row {r} differs from greedy at step "
                 f"{step} where the eager path's choice is decisive "
                 f"(gap {gap:.3e})")


def decode_splits(b: int, kvh: int, group: int, t: int) -> int:
    """Kernel 3's split of one (kv head, batch row)'s cache over a cluster,
    as its launcher takes it (`choose_splits`, csrc/decode_attention.cu:
    ~256 blocks, at most 8, 32-slot tiles)."""
    per = b * kvh * max(1, group // 2)
    tiles = -(-t // 32)
    splits = max(1, min((256 + per // 2) // per, (tiles + 1) // 2, 8))
    chunk = -(-tiles // splits) * 32
    return -(-t // chunk)


def check_decode_at(tag: str, dev, what: str, b: int, t: int,
                    int8: bool) -> dict:
    """Kernel 3 (its int8 branch with `int8`) against its plain version at a
    shape a serving path launches it at (Vicuna-7B: H = KV = 32, Dh = 128),
    on seeded random inputs with holes: 80 % of the slots visible, a masked
    stretch of 100, slot 0 always, and a last row whose only visible slot is
    the last; a repeat must give the same bits. Returns the case."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec, quant as Q)
    g = torch.Generator(device=dev).manual_seed(7919 * b + t)
    h, d = 32, 128

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
    q, k, v = randn(b, 1, h, d), randn(b, t, h, d), randn(b, t, h, d)
    mask = torch.rand(b, t, generator=g, device=dev) < 0.8
    mask[:, t // 3:t // 3 + 100] = False
    mask[:, 0] = True
    if b > 1:
        mask[-1] = False
        mask[-1, -1] = True
    cache = (k, v)
    if int8:
        (kc, ks), (vc, vs) = Q.quantize_kv(k), Q.quantize_kv(v)
        cache = (kc, vc, ks, vs)
    ref = dec.decode_attention_plain(q, cache[0], cache[1], mask, *cache[2:])
    got = dec.decode_attention(q, cache[0], cache[1], mask, *cache[2:])
    err, tol, rows = max_err(got, ref), kernel_tol(ref), row_err(got, ref)
    same_bits(f"kernel 3 at {what}", lambda: dec.decode_attention(
        q, cache[0], cache[1], mask, *cache[2:]))
    name = "decode_attention_int8" if int8 else "decode_attention"
    case = dict(kernel=name, path=what, shape=f"B={b} T={t} H=KV={h} Dh={d}"
                f"{' int8 cache' if int8 else ''}, holes", err=err, tol=tol,
                row_err=rows, splits=decode_splits(b, h, 1, t))
    print(f"{tag} kernel {name} at {what}'s shape [{case['shape']}, "
          f"{case['splits']} split(s) a cluster]: max_abs_err {err:.3e} (tol "
          f"{tol:.3e}), worst row {rows:.3e} of its max|plain| (tol "
          f"{KERNEL_REL_TOL}); a repeat gives the same bits")
    if not (err <= tol and rows <= KERNEL_REL_TOL):
        fail(f"{name} disagrees with its plain version at {what}'s shape "
             f"B={b} T={t}: err {err}, row {rows}")
    return case


def replay_ms(start, decode, reps: int = 3) -> float:
    """Device ms of a graph decoder's decode part alone: CUDA events around
    its replays (the host's read between two of them included), after its
    eager prefill into the key's static cache (`start()`); the mean of
    `reps`."""
    import torch
    total = 0.0
    with torch.inference_mode():
        for _ in range(reps):
            st = start()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            decode(st)
            e1.record()
            e1.synchronize()
            total += e0.elapsed_time(e1)
    return total / reps


@contextlib.contextmanager
def plain_kernel3():
    """The decoder's q_len = 1 attention runs kernel 3's plain version (fp32)
    inside: a reference run on the card that launches no kernel 3."""
    from law_of_vision_representation_in_mllms_torch.models import llama
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec)
    kernel = llama.decode_attention
    llama.decode_attention = dec.decode_attention_plain
    try:
        yield
    finally:
        llama.decode_attention = kernel


def forced_scores(lmm, inputs, seqs, eos: int):
    """Beam search's score (length penalty 1) of each row's sequence `seqs`
    [B, n]: its log-probs summed up to its first eos (or over all n), over
    that length, from eager steps fed the sequence. fp64 [B]."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    b, n = seqs.shape
    hit = seqs == eos
    lens = torch.where(hit.any(dim=1), hit.float().argmax(dim=1) + 1,
                       torch.full((b,), n, device=seqs.device))
    pre = M.prefill(lmm.params, lmm.cfg, *inputs, max_new_tokens=n)
    logits = pre.logits
    total = torch.zeros(b, dtype=torch.float64, device=seqs.device)
    for t in range(n):
        lp = torch.log_softmax(logits.float(), dim=-1).gather(
            1, seqs[:, t:t + 1])[:, 0]
        total += torch.where(t < lens, lp.double(), 0.0)
        if t + 1 < n:
            logits = M.decode_step(lmm.params, pre, seqs[:, t], t)
    return total / lens.double()


def check_backends(tag: str, dev, counters, lmm, label: str, reqs, texts,
                   toks, fig: dict, quantize, first_s: float,
                   every: bool) -> dict:
    """Phase 4b on the LLaVA of phase 4 (`every`: all backends) or of phase
    7 (the chunked decode only). Phase 4's main path ran `generate_until`
    through the adapter's chunked decoder (`first_s`: that first call, the
    capture in it); here its tokens and text are held to the eager greedy
    decode's (`toks`, `texts` the main path's), kernel 3 to its plain version
    at the path's shape, and the replays timed alone. Then, in bf16,
    `gen_backend=speculative`, beam search (against a run on kernel 3's
    plain version and against eager steps), sampling and the HTTP server.
    Puts kernel 3's cases at the paths' shapes in `fig["decode_cases"]`;
    returns the launches of each backend's path."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    ids, mask, pixels = inputs = lmm._encode_batch(reqs)
    b, n_new = toks.shape
    layers = lmm.cfg.decoder.num_layers
    eos = lmm.tok.eos_token_id
    int8 = bool(lmm.cfg.kv_quant)
    dec_name = "decode_attention_int8" if int8 else "decode_attention"
    t_cache = ids.shape[1] + lmm.cfg.num_patches - 1 + n_new
    paths = {}

    # the chunked greedy decode of phase 4's main path: one graph, its
    # recorded launches, its tokens against the eager decode's
    dec = lmm.chunked_decoder()
    if dec.captures != 1:
        fail(f"[{label}] the chunked decode captured {dec.captures} graphs")
    (st,) = dec._keys.values()
    if st.cache[0][0].shape[1] != t_cache:
        fail(f"[{label}] the graph path's cache has "
             f"{st.cache[0][0].shape[1]} slots, not the eager path's "
             f"{t_cache}")
    per_chunk = st.step.launches
    want10 = DECODE_CHUNK * (7 * layers + 1) if quantize == "int4" else 0
    if per_chunk[dec_name] != DECODE_CHUNK * layers or \
            per_chunk["int4_matmul"] != want10:
        fail(f"[{label}] the captured chunk recorded {per_chunk}, not "
             f"{DECODE_CHUNK * layers} of {dec_name} and {want10} of "
             f"kernel 10")
    print(f"{tag} [{label}] chunked decode (B={b}, {n_new} new tokens, "
          f"chunk {DECODE_CHUNK}, T={t_cache}): one graph captured; a chunk "
          f"records {per_chunk[dec_name]} launches of kernel 3 ({dec_name}) "
          f"and {per_chunk['int4_matmul']} of kernel 10; {dec.replays} "
          f"replays so far -> {dec.graph_launches()[dec_name]} and "
          f"{dec.graph_launches()['int4_matmul']} launches by replay")
    got = dec.generate(*inputs, max_new_tokens=n_new)
    again = dec.generate(*inputs, max_new_tokens=n_new)
    if not torch.equal(got, again):
        fail(f"[{label}] a second chunked run gave different tokens")
    for row, text in zip(got.tolist(), texts):
        row = row[:row.index(eos)] if eos in row else row
        if lmm.tok.decode(row).strip() != text:
            fail(f"[{label}] generate_until's text differs from the chunked "
                 f"decoder's tokens")
    check_tokens(tag, label, "chunked (CUDA graphs)", lmm, inputs, toks, got)
    cases = [check_decode_at(tag, dev, f"[{label}] greedy decode", b,
                             t_cache, int8)]
    warm_s = timed_s(lambda: lmm.generate_until(reqs), dev, reps=1)
    n_chunks = -(-n_new // DECODE_CHUNK)
    replays0 = dec.replays
    ms = replay_ms(lambda: dec._start(*inputs, n_chunks * DECODE_CHUNK),
                   lambda st: dec._decode(st, n_chunks))
    steps = (dec.replays - replays0) // 3 * DECODE_CHUNK
    fig_graph = dict(decode_tok_s=b * steps / ms * 1e3, step_ms=ms / steps,
                     capture_s=first_s - warm_s)
    print(f"{tag} [{label}] chunked decode: {fig_graph['decode_tok_s']:.1f} "
          f"tokens/s ({fig_graph['step_ms']:.2f} ms/step, {steps} steps; "
          f"CUDA events around the replays) against the eager path's "
          f"{fig['decode_tok_s']:.1f} tokens/s ({fig['step_ms']:.2f} "
          f"ms/step, (generate - prefill) host time), "
          f"{fig_graph['decode_tok_s'] / fig['decode_tok_s']:.2f}x; the "
          f"first generate_until {first_s:.2f} s, a warm one {warm_s:.2f} "
          f"s: warm-up chunk + capture {fig_graph['capture_s']:.2f} s")
    fig["graph"] = fig_graph
    fig["decode_cases"] = cases
    if not every:
        return paths

    # speculation through the adapter's decoder: its first call captures
    # the verify round, a warm one replays it
    lmm.gen_backend, lmm.draft_len = "speculative", DRAFT_LEN
    spec_dec = lmm.speculative_decoder()
    t0 = time.perf_counter()
    spec_texts, paths["speculative"] = counted_run(
        counters, lambda: lmm.generate_until(reqs), spec_dec)
    spec_first_s = time.perf_counter() - t0
    with torch.inference_mode():
        spec, rounds = spec_dec.generate(*inputs, max_new_tokens=n_new)
    if spec_dec.captures != 1:
        fail(f"speculation captured {spec_dec.captures} graphs, not 1")
    check_tokens(tag, label, "speculative", lmm, inputs, toks, spec)
    if torch.equal(spec, toks) and spec_texts != texts:
        fail("generate_until's speculative texts differ from the eager run's")
    spec_warm_s = timed_s(lambda: lmm.generate_until(reqs), dev, reps=1)
    spec_ms = replay_ms(lambda: spec_dec._start(*inputs, n_new),
                        lambda st: spec_dec._decode(st, n_new))
    print(f"{tag} [{label}] speculative decode (prompt lookup, draft "
          f"{DRAFT_LEN}, the verify round one captured graph replayed): "
          f"{rounds} rounds for {n_new} tokens, warm "
          f"{b * n_new / spec_ms * 1e3:.1f} tokens/s ({spec_ms:.2f} ms of "
          f"rounds, CUDA events around the replays); the first "
          f"generate_until {spec_first_s:.2f} s, a warm one "
          f"{spec_warm_s:.2f} s: warm-up round + capture "
          f"{spec_first_s - spec_warm_s:.2f} s")
    fig["speculative"] = dict(rounds=rounds,
                              decode_tok_s=b * n_new / spec_ms * 1e3,
                              capture_s=spec_first_s - spec_warm_s)

    # beam search, k = BEAMS: B*k rows through kernel 3 at the prompt's T
    def beam():
        return M.generate_beam(lmm.params, lmm.cfg, *inputs,
                               max_new_tokens=n_new, eos_id=eos,
                               num_beams=BEAMS, return_scores=True)
    (beam_toks, scores), paths["beam"] = counted_run(counters, beam)
    if not (torch.isfinite(scores).all() and (scores[:, 0] > -1e8).all()):
        fail(f"beam search's scores are not finite: {scores.tolist()}")
    if not torch.equal(beam()[0], beam_toks):
        fail("a second beam search gave different tokens")
    if paths["beam"][dec_name] != layers * (n_new - 1):
        fail(f"beam search launched kernel 3 {paths['beam'][dec_name]} "
             f"times, not {layers * (n_new - 1)}")
    cases.append(check_decode_at(tag, dev, "beam search", b * BEAMS,
                                 t_cache, int8))
    # against kernel 3's plain version: the best beams' scores recomputed
    # from eager steps fed their tokens must be the search's own. A search
    # on the plain attention is run beside it and its rows printed, not
    # held: on random weights the k-th and (k+1)-th of 2k candidates are
    # near-ties at many steps, and once one resolves the other way the two
    # searches follow other paths, whose final scores differ by more than
    # that step's gap
    with plain_kernel3():
        plain_toks, plain_scores = beam()
        forced = forced_scores(lmm, inputs, beam_toks, eos)
    rel = ((scores[:, 0].double() - forced).abs() / forced.abs()).max()
    print(f"{tag} [{label}] beam search: best scores against the plain "
          f"attention's eager steps fed the same tokens: worst rel err "
          f"{rel.item():.3e} (tol {LOGITS_REL_TOL}); "
          f"{(plain_toks != beam_toks).any(dim=1).sum().item()} of {b} best "
          f"beams differ from a search on the plain attention, which scores"
          f" them {[round(x, 4) for x in forced.tolist()]} against its own "
          f"best {[round(x, 4) for x in plain_scores[:, 0].tolist()]}")
    if not rel <= LOGITS_REL_TOL:
        fail(f"beam search's scores {scores[:, 0].tolist()} are not the "
             f"plain attention's {forced.tolist()} for the same tokens")
    beam_s = timed_s(lambda: beam(), dev, reps=1)
    prefill_s = fig["prefill_ms"] / 1e3
    dec_cfg = lmm.cfg.decoder
    cache_gb = (2 * layers * b * BEAMS * t_cache * dec_cfg.num_kv_heads
                * dec_cfg.head_dim * 2 / 1e9)
    print(f"{tag} [{label}] beam search (k={BEAMS}, B*k={b * BEAMS} rows): "
          f"best scores {[round(x, 3) for x in scores[:, 0].tolist()]}, "
          f"{b * n_new / (beam_s - prefill_s):.1f} tokens/s of best beams "
          f"((generate - prefill) time, {(beam_s - prefill_s) / (n_new - 1) * 1e3:.2f}"
          f" ms a step); the beams' cache {cache_gb:.2f} GB (T={t_cache}), "
          f"gathered over its batch axis every step; "
          f"{(beam_toks != toks).any(dim=1).sum().item()} of {b} rows differ"
          f" from greedy")
    fig["beam"] = dict(decode_tok_s=b * n_new / (beam_s - prefill_s),
                       cache_gb=cache_gb)

    # sampling from a seeded generator on the card
    def sample(seed, **kw):
        return M.generate_sample(
            lmm.params, lmm.cfg, *inputs, max_new_tokens=n_new, eos_id=eos,
            generator=torch.Generator(dev).manual_seed(seed), **kw)
    drawn, paths["sample"] = counted_run(
        counters, lambda: sample(SAMPLE_SEED, **SAMPLING))
    if not torch.equal(sample(SAMPLE_SEED, **SAMPLING), drawn):
        fail("the same seed drew different tokens")
    cold = sample(SAMPLE_SEED, temperature=0.0)
    check_tokens(tag, label, "temperature-0 sample", lmm, inputs, toks, cold)
    print(f"{tag} [{label}] sampling (temperature {SAMPLING['temperature']},"
          f" top-p {SAMPLING['top_p']}, seed {SAMPLE_SEED}): the seed "
          f"repeats its {drawn.numel()} tokens, "
          f"{(drawn != toks).sum().item()} of them differ from greedy")

    paths["http"] = serve_smoke(tag, label, lmm, counters, dev, cases)
    return paths


def serve_smoke(tag: str, label: str, lmm, counters, dev,
                cases: list) -> dict:
    """`LMMServer` on 127.0.0.1 (port 0) over the chunked backend: two
    concurrent chat completions, each with a base64 PNG, ride one wave; the
    answers must be `generate_until`'s on the same prompts and images, and
    `/health` must count one dispatch. The wave's batch (B = 2) is then held
    to the eager greedy decode, and kernel 3 to its plain version at its
    shape (appended to `cases`). Returns the launches of the server's
    run."""
    import base64
    import io
    import threading
    import urllib.request
    import numpy as np
    from PIL import Image
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.serve import (
        LMMServer, _parse_messages)

    rng = np.random.RandomState(3)
    payloads = []
    for i in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (336, 336, 3), np.uint8)).save(
            buf, format="PNG")
        url = "data:image/png;base64," + base64.b64encode(
            buf.getvalue()).decode()
        payloads.append({"max_tokens": 32, "messages": [{
            "role": "user", "content": [
                {"type": "image_url", "image_url": {"url": url}},
                {"type": "text",
                 "text": " ".join(WORDS[8 * i:8 * i + 14])}]}]})
    lmm.gen_backend = "chunked"
    answers, health = [None, None], {}

    def serve_two():
        srv = LMMServer(lmm, model_name="llava-1.5-7b", host="127.0.0.1",
                        port=0, max_batch=4, batch_window_ms=1000)
        srv.start_background()
        try:
            def post(i):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/v1/chat/completions",
                    data=json.dumps(payloads[i]).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=300) as r:
                    answers[i] = json.loads(r.read())[
                        "choices"][0]["message"]["content"]
            threads = [threading.Thread(target=post, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/health", timeout=60) as r:
                health.update(json.loads(r.read()))
        finally:
            srv.shutdown()
    t0 = time.perf_counter()
    _, launches = counted_run(counters, serve_two, lmm.chunked_decoder())
    wall = time.perf_counter() - t0
    reqs = []
    for p in payloads:
        prompt, images = _parse_messages(p["messages"])
        reqs.append(Instance("generate_until", {}, len(reqs), "serve",
                             (prompt, {"max_new_tokens": 32}),
                             visual=images))
    want = lmm.generate_until(reqs)
    print(f"{tag} [{label}] serve: 2 concurrent chat completions with a "
          f"336 px PNG each answered in {wall:.2f} s (server start and stop "
          f"included); /health {health}; launches {launches}")
    if answers != want:
        fail(f"the served answers {answers} are not generate_until's {want}")
    if health.get("dispatches") != 1 or health.get("requests") != 2:
        fail(f"the two requests did not ride one wave: /health {health}")
    # the wave's decode: the chunked decoder's key for B = 2 against the
    # eager greedy decode, and kernel 3 at its T
    ids, mask, pixels = inputs = lmm._encode_batch(reqs)
    t_cache = ids.shape[1] + lmm.cfg.num_patches - 1 + 32
    st = lmm.chunked_decoder()._keys.get((2, ids.shape[1], 32))
    if st is None or st.cache[0][0].shape[1] != t_cache:
        fail(f"the served wave did not decode B=2 at T={t_cache}")
    eager = M.generate_greedy(lmm.params, lmm.cfg, *inputs,
                              max_new_tokens=32, eos_id=lmm.tok.eos_token_id)
    got = lmm.chunked_decoder().generate(*inputs, max_new_tokens=32)
    check_tokens(tag, label, "served wave (B=2, chunked)", lmm, inputs,
                 eager, got)
    cases.append(check_decode_at(tag, dev, "the served wave", 2, t_cache,
                                 bool(lmm.cfg.kv_quant)))
    return launches


def inflight_inputs(lmm, text: str, image):
    """A request as the server's worker submits it: host ids [1, L], mask
    and [1, H, W, 3] pixels; and the same on the card as a batch of one
    for the eager reference."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.data.preprocess import (
        tokenizer_image_token)
    ids = np.asarray(tokenizer_image_token(lmm._prompt(text), lmm.tok),
                     np.int64)[None]
    px = np.asarray(image, np.float32)[None]
    host = (ids, np.ones_like(ids, bool), [px])
    card = (torch.from_numpy(ids).to(lmm.device),
            torch.ones(ids.shape, dtype=torch.bool, device=lmm.device),
            [torch.from_numpy(px).to(lmm.device)])
    return host, card


def hold_first_logits(tag: str, label: str, what: str, lmm, card,
                      got) -> float:
    """The first-token logits [V] an engine's prefill gave one request
    against the eager prefill of that request alone: their largest gap,
    relative to the eager max|logit|, must be within `LOGITS_REL_TOL`.
    Returns that gap."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    want = M.prefill(lmm.params, lmm.cfg, *card,
                     max_new_tokens=1).logits[0].float()
    got = torch.as_tensor(got, device=want.device).float()
    gap = ((got - want).abs().max() / want.abs().max()).item()
    print(f"{tag} [{label}] {what}: the engine's first-token logits lie "
          f"{gap:.3e} of max|logit| from the eager prefill's (tol "
          f"{LOGITS_REL_TOL})")
    if not gap <= LOGITS_REL_TOL:
        fail(f"[{label}] {what}: the engine's first-token logits lie "
             f"{gap:.3e} of max|logit| from the eager prefill's")
    return gap


def check_engine_tokens(tag: str, label: str, what: str, lmm, card, got,
                        n: int, bound: float) -> bool:
    """An engine's tokens for one request (EOS excluded) against the eager
    `generate_greedy` of that request alone. Where they part, the eager
    logit of the token the engine chose must lie within `bound` of
    max|logit| below the eager top. Returns whether they parted."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    eos = lmm.tok.eos_token_id
    want = M.generate_greedy(lmm.params, lmm.cfg, *card, max_new_tokens=n,
                             eos_id=eos)
    row = list(got)[:n]
    row += [eos] * (n - len(row))
    gaps = near_tie_gaps(lmm, card, want, torch.tensor(
        [row], device=want.device), chosen=True)
    if not gaps:
        print(f"{tag} [{label}] {what}: tokens equal to the eager greedy "
              f"decode's")
        return False
    for _, step, gap in gaps:
        print(f"{tag} [{label}] {what}: first differs at step {step}; the "
              f"eager logit of the engine's token there is {gap:.3e} of "
              f"max|logit| below the eager top (bound {bound:.3e})")
        if gap > bound:
            fail(f"[{label}] {what}: the engine chose at step {step} a token "
                 f"{gap:.3e} of max|logit| below the eager top")
    return True


@contextlib.contextmanager
def engine_shapes(seen):
    """Counts into the Counter `seen`, by kernel and shape, the card's calls
    of kernels 1, 2, 3 and 10 made inside, through the names the model's
    modules call them by: the tower's `encoder_attention`, the decoder's
    `flash_attention` and `decode_attention`, and `quant.int4_matmul`. A
    chunk graph's capture is one call; its replays rerun the captured
    shapes."""
    from law_of_vision_representation_in_mllms_torch.models import (
        llama, perceiver, vit)
    from law_of_vision_representation_in_mllms_torch.ops import quant as Q

    def attention(name):
        def keep(args, out):
            q, k = args[0], args[1]
            if not q.is_cuda:
                return None
            b, s, h, d = q.shape
            if name == "decode_attention":
                int8 = len(args) > 4 and args[4] is not None
                return (name + "_int8" * int8, b, k.shape[1], h, d)
            if name == "flash_attention":
                return (name, b, s, h, k.shape[2], d)
            if name == "flash_attention_noncausal":
                return (name, b, s, k.shape[1], h, d)
            return (name, b, s, h, d)
        return keep

    def matmul(args, out):
        x, leaf = args[0], args[1]
        if not x.is_cuda:
            return None
        q4, scale = leaf["q4"], leaf["scale"]
        di = q4.shape[-1] * 8
        return ("int4_matmul", x.numel() // x.shape[-1], di, q4.shape[-2],
                scale.shape[-2])
    spies = [_Spy(vit, "encoder_attention",
                  keep=attention("encoder_attention")),
             _Spy(llama, "flash_attention", keep=attention("flash_attention")),
             # the perceiver projector's cross-attention (phase 15)
             _Spy(perceiver, "flash_attention",
                  keep=attention("flash_attention_noncausal")),
             _Spy(llama, "decode_attention",
                  keep=attention("decode_attention")),
             _Spy(Q, "int4_matmul", keep=matmul)]
    with contextlib.ExitStack() as stack:
        for spy in spies:
            stack.enter_context(spy)
        try:
            yield
        finally:
            for spy in spies:
                seen.update(k for k in spy.kept if k is not None)


def check_int4_at(tag: str, dev, g, leaves: dict, what: str, m: int, di: int,
                  do: int, groups: int) -> dict:
    """Kernel 10 against its plain version at one (M, K, N, groups) an engine
    launched it at, on a seeded random int4 weight (one a shape, kept in
    `leaves`) and x; a repeat must give the same bits."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        int4_matmul as K, quant as Q)
    if (di, do, groups) not in leaves:
        leaves[di, do, groups] = Q.quantize_int4(
            torch.randn((do, di), generator=g, device=dev) * 0.02,
            group_size=di // groups)
    leaf = leaves[di, do, groups]
    x = torch.randn((m, di), generator=g, device=dev, dtype=torch.bfloat16)
    got = K.int4_matmul_kernel(x, leaf["q4"], leaf["scale"])
    # the plain version holds an fp32 partial for every group
    ref = torch.cat([K.int4_matmul_plain(rows, leaf["q4"], leaf["scale"])
                     for rows in x.split(1024)])
    err = max_err(got, ref)
    tol = INT4_REL_TOL * max(1.0, ref.float().abs().max().item())
    shape = (f"M={m} {di}->{do} group {di // groups}, the "
             f"{'decode' if m <= 16 else 'wgmma'} body")
    same_bits(f"kernel 10 at {what}'s {shape}", lambda: K.int4_matmul_kernel(
        x, leaf["q4"], leaf["scale"]))
    print(f"{tag} kernel int4_matmul at {what}'s shape [{shape}]: "
          f"max_abs_err {err:.3e} (tol {tol:.3e}); a repeat gives the same "
          f"bits")
    if not err <= tol:
        fail(f"int4_matmul disagrees with its plain version at {what}'s "
             f"shape {shape}: err {err}")
    return dict(kernel="int4_matmul", path=what, shape=shape, err=err,
                tol=tol)


ENGINE_HELD = set()     # the engine's launch shapes held so far in this run


def hold_engine_shapes(tag: str, dev, label: str, seen, cases: list,
                       path: str = "inflight engine") -> None:
    """Holds each kernel shape in `seen` (see `engine_shapes`) that this run
    has not held yet to its plain version, on seeded random inputs: kernels
    1 and 2 by `attention_case` (kernel 2 with the block rows its launcher
    reports), kernel 3 by `check_decode_at`, kernel 10 by `check_int4_at`.
    Appends the cases to `cases`, then fails if a shape in `seen` was not
    held. `path` names the path that launched them."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        encoder_attention as enc, flash_attention as fl)
    g = torch.Generator(device=dev).manual_seed(17)
    leaves = {}
    what = f"[{label}] {path}"

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)
    for key in sorted(set(seen) - ENGINE_HELD):
        name, *dims = key
        if name == "encoder_attention":
            b, s, h, d = dims
            case = attention_case(
                tag, enc.encoder_attention, enc.encoder_attention_plain,
                lambda q, k, v: sdpa(q, k, v),
                (randn(b, s, h, d) for _ in range(3)), s * s,
                f"kernel 1 at {what}'s B={b} S={s} H={h} D={d}")
        elif name == "flash_attention":
            b, s, h, kvh, d = dims
            if kvh != h:
                fail(f"{what} launched kernel 2 with KV={kvh} heads of "
                     f"{h}: no case here holds that")
            qkv = [randn(b, s, h, d) for _ in range(3)]
            case = attention_case(
                tag, lambda q, k, v: fl.flash_attention(q, k, v, causal=True),
                lambda q, k, v: fl.flash_attention_plain(q, k, v,
                                                         causal=True),
                lambda q, k, v: sdpa(q, k, v, is_causal=True), qkv,
                s * (s + 1) // 2,
                f"kernel 2 at {what}'s B={b} S={s} H=KV={h} D={d} causal")
            fl.flash_attention(*qkv, causal=True)   # the rows it takes
            torch.cuda.synchronize(dev)
            case["block_rows"] = fl.last_block_rows()
            print(f"{tag} kernel 2 at {what}'s B={b} S={s}: "
                  f"{case['block_rows']}-row blocks (reported by the launch)")
            del qkv
        elif name == "flash_attention_noncausal":
            b, sq, skv, h, d = dims
            case = attention_case(
                tag, lambda q, k, v: fl.flash_attention(q, k, v,
                                                        return_lse=True),
                lambda q, k, v: fl.flash_attention_plain(q, k, v,
                                                         return_lse=True),
                lambda q, k, v: sdpa(q, k, v),
                (randn(b, sq, h, d), randn(b, skv, h, d),
                 randn(b, skv, h, d)), sq * skv,
                f"kernel 2 at {what}'s B={b} Sq={sq} Skv={skv} H={h} D={d} "
                f"non-causal")
            name = "flash_attention"
        elif name.startswith("decode_attention"):
            b, t, h, d = dims
            if (h, d) != (32, 128):
                fail(f"{what} launched kernel 3 at H={h} D={d}: "
                     f"check_decode_at holds Vicuna-7B's 32 heads of 128")
            case = check_decode_at(tag, dev, what, b, t,
                                   name.endswith("int8"))
        else:
            case = check_int4_at(tag, dev, g, leaves, what, *dims)
        if not case["err"] <= case["tol"]:
            fail(f"{name} at {case['shape']}: {case['err']} > {case['tol']}")
        case.update(kernel=name, path=what)
        cases.append(case)
        ENGINE_HELD.add(key)
    if not set(seen) <= ENGINE_HELD:
        fail(f"{what} launched shapes that were not held to the plain "
             f"version: {sorted(set(seen) - ENGINE_HELD)}")
    print(f"{tag} {what} kernel calls by (kernel, shape), a capture one "
          f"call, each held to its plain version: {dict(sorted(seen.items()))}")
    del leaves
    torch.cuda.empty_cache()


def run_inflight(tag: str, dev, counters, lmm, label: str, quantize,
                 cases: list, serve: bool) -> dict:
    """Phase 4c on phase 4's or 7's LLaVA: the continuous-batching engine
    at full width (see the module docstring). Appends kernel 3's case at
    the slot step's shape to `cases`; returns the launches of each of its
    paths ("inflight", and with `serve` "inflight_http")."""
    import threading
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.models.inflight import (
        InflightEngine)

    t_phase = time.perf_counter()
    layers = lmm.cfg.decoder.num_layers
    int8 = bool(lmm.cfg.kv_quant)
    dec_name = "decode_attention_int8" if int8 else "decode_attention"
    reqs = _requests(len(INFLIGHT_BUDGETS), lmm.processors[0].crop)
    texts = [r.args[0] for r in reqs]
    images = [r.visual[0] for r in reqs]
    # the partial hit: request 3's image and text with its last 4 words
    # replaced; the exact repeat: request 0
    words = texts[3].split()
    texts.append(" ".join(words[:-4] + [w for w in WORDS
                                        if w not in words[-4:]][:4]))
    images.append(images[3])
    texts.append(texts[0])
    images.append(images[0])
    budgets = list(INFLIGHT_BUDGETS) + [32, INFLIGHT_BUDGETS[0]]
    inputs = [inflight_inputs(lmm, t, im) for t, im in zip(texts, images)]
    lengths = [h[0].shape[1] for h, _ in inputs]
    eng = InflightEngine(lmm.params, lmm.cfg, eos_id=lmm.tok.eos_token_id,
                         prefix_cache=16, prefix_block=INFLIGHT_BLOCK,
                         prefix_cache_bytes=int(8e9), sample_seed=SAMPLE_SEED,
                         **INFLIGHT)
    t_max = eng.t_max
    done_at = {}
    seen = collections.Counter()    # kernel calls by shape (engine_shapes)

    def submit(i):
        kw = SAMPLING if i == INFLIGHT_SAMPLED else {}
        handle = eng.submit(*inputs[i][0], budgets[i], **kw)
        t0 = time.perf_counter()

        def wait():
            handle.event.wait(600)
            done_at[i] = time.perf_counter() - t0
        threading.Thread(target=wait, daemon=True).start()
        return handle

    handles = {}

    def main_run():
        handles.update({i: submit(i) for i in range(len(INFLIGHT_BUDGETS))})
        handles[3].result(timeout=600)        # request 3's prompt is stored
        handles[6] = submit(6)
        return {i: h.result(timeout=600).tolist() for i, h in
                handles.items()}

    def repeat_run():
        handles[7] = eng.submit(*inputs[7][0], budgets[7])
        return handles[7].result(timeout=600).tolist()

    try:
        t0 = time.perf_counter()
        # each chunk's host seconds: the inputs' copy, the replay (or the
        # warm-up and the capture) and the read back, which syncs; and the
        # engine's captures after it, which mark the chunks that captured
        captures0 = eng.captures
        with _Spy(eng, "_step", keep=lambda args, out: eng.captures) \
                as chunk_spy, engine_shapes(seen):
            outs, launches = counted_run(counters, main_run, eng)
        wall = time.perf_counter() - t0
        n_tok = sum(len(v) for v in outs.values())
        stats = dict(eng.stats())
        # the exact repeat alone: a store hit, no tower pass, no prefill
        prefills = eng.prefills
        with engine_shapes(seen):
            rep, rep_launches = counted_run(counters, repeat_run, eng)
        outs[7] = rep
        for name, n in rep_launches.items():
            launches[name] += n
        captures, replays = eng.captures, eng.replays
        chunk_launches = {k: g.step.launches for k, g in eng._keys.items()
                          if g.step is not None}
        final = eng.stats()
        # each prefilled prompt's first-token logits, kept in the store
        # (the repeat's are request 0's)
        stored = {i: eng._prefix_store.get(eng._prefix_key(h))
                  for i, h in handles.items()}
    finally:
        eng.shutdown()
    greedy = [i for i in range(len(inputs)) if i != INFLIGHT_SAMPLED]
    if any(stored.get(i) is None for i in greedy):
        fail(f"[{label}] the store lost a greedy request's prompt: "
             f"{sorted(i for i in greedy if stored.get(i) is None)}")
    gaps = {i: hold_first_logits(tag, label, f"inflight request {i}", lmm,
                                 inputs[i][1], stored[i][2]) for i in greedy}
    parted = [i for i in greedy if check_engine_tokens(
        tag, label, f"inflight request {i} (L={lengths[i]}, "
        f"{budgets[i]} new)", lmm, inputs[i][1], outs[i], budgets[i],
        ENGINE_TIE_REL_TOL + 2 * gaps[i])]
    print(f"{tag} [{label}] inflight engine: {len(parted)} of "
          f"{len(greedy)} greedy requests part from their eager decode "
          f"({parted}), each at a tie within {ENGINE_TIE_REL_TOL} + twice "
          f"its first-token logit gap of max|logit|")
    # the served prompts are prefilled whole, as requests 0-5 were
    full = max(gaps[i] for i in greedy if i < len(INFLIGHT_BUDGETS))
    sampled = outs[INFLIGHT_SAMPLED]
    if not (0 < len(sampled) <= budgets[INFLIGHT_SAMPLED] and all(
            0 <= t < lmm.cfg.decoder.vocab_size for t in sampled)):
        fail(f"[{label}] the sampled inflight request gave {sampled}")
    if final["prefills"] != prefills or final["prefix_hits"] != 1 or \
            rep_launches["encoder_attention"] or \
            rep_launches["flash_attention"]:
        fail(f"[{label}] the exact repeat was not a store hit without a "
             f"prefill: {final}, its launches {rep_launches}")
    if stats["partial_hits"] != 1:
        fail(f"[{label}] the request sharing request 3's image and leading "
             f"text was not a partial hit: {stats}")
    if (True,) not in chunk_launches:
        fail(f"[{label}] the sampling chunk was not captured: "
             f"{list(chunk_launches)}")
    want10 = DECODE_CHUNK * (7 * layers + 1) if quantize == "int4" else 0
    for key, rec in chunk_launches.items():
        if rec[dec_name] != DECODE_CHUNK * layers or \
                rec["int4_matmul"] != want10:
            fail(f"[{label}] the inflight chunk {key} recorded {rec}")
    # what the phase must have launched: kernels 1 and 2 in each full
    # prefill (23 tower blocks, 32 decoder layers), kernel 3 in each chunk
    # (the warm-up before each capture and each replay), kernel 10 in each
    # prefill, suffix prefill and chunk step under int4
    chunks = captures + replays
    want = {"encoder_attention": 23 * prefills,
            "flash_attention": layers * prefills,
            dec_name: layers * DECODE_CHUNK * chunks,
            "int4_matmul": (7 * layers + 1) * (prefills + 1 + DECODE_CHUNK
                                               * chunks)
            if quantize == "int4" else 0}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"[{label}] the inflight engine launched {launches}, not {want}")
    lat = ", ".join(f"{i}: {done_at.get(i, float('nan')):.2f}"
                    for i in sorted(done_at))
    print(f"{tag} [{label}] inflight engine ({INFLIGHT['n_slots']} slots, "
          f"T={t_max}, chunk {DECODE_CHUNK}, prompts of {lengths} tokens, "
          f"budgets {budgets}, request {INFLIGHT_SAMPLED} sampled): {n_tok} "
          f"tokens in {wall:.2f} s, {n_tok / wall:.1f} tokens/s (host clock, "
          f"captures included); request latencies s {{{lat}}}; {stats}; the "
          f"repeat of request 0: {final['prefix_hits']} store hit, "
          f"{final['prefills'] - prefills} prefills, launches {rep_launches}")
    replay_ms, capture_ms = chunk_kinds(captures0, chunk_spy)
    if not replay_ms:
        fail(f"[{label}] the inflight engine's main run replayed no chunk "
             f"without capturing one: chunks of {capture_ms} ms, each a "
             f"capture")
    med = statistics.median(replay_ms)
    print(f"{tag} [{label}] inflight engine: {captures} chunk graphs "
          f"captured ({sorted(k[0] for k in chunk_launches)} sampled), "
          f"{replays} replays; the main run's chunks, host ms: "
          f"{len(replay_ms)} replays {replay_ms} (median {med:.2f} ms, range "
          f"{min(replay_ms):.2f}-{max(replay_ms):.2f}; "
          f"{med / DECODE_CHUNK:.2f} "
          f"ms a step of {INFLIGHT['n_slots']} slots), {len(capture_ms)} "
          f"captures (warm-up, capture and a replay each) {capture_ms}; "
          f"launches {launches} (kernel 3 "
          f"{launches[dec_name]}, kernel 10 {launches['int4_matmul']}); "
          f"store {final['prefix_entries']} entries, "
          f"{final['prefix_bytes'] / 1e9:.2f} GB; phase 4c took "
          f"{time.perf_counter() - t_phase:.1f} s")
    paths = {"inflight": launches}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if serve:
        paths["inflight_http"] = serve_inflight(tag, label, lmm, counters,
                                                seen,
                                                ENGINE_TIE_REL_TOL + 2 * full)
    hold_engine_shapes(tag, dev, label, seen, cases)
    return paths


def chunk_kinds(captures0: int, spy) -> tuple:
    """The host ms of the chunks `spy` timed (a `_Spy` of an engine's
    `_step` whose `kept` is the engine's captures after each call; `captures0`
    before the first), sorted, split into replays alone and the calls that
    captured a graph (its warm-up chunk, the capture and its first
    replay)."""
    replays, captures = [], []
    for sec, before, after in zip(spy.seconds, [captures0, *spy.kept],
                                  spy.kept):
        (captures if after > before else replays).append(round(sec * 1e3, 2))
    return sorted(replays), sorted(captures)


def serve_inflight(tag: str, label: str, lmm, counters, seen,
                   bound: float) -> dict:
    """`LMMServer(inflight=True)` on 127.0.0.1 (port 0): two concurrent chat
    completions with a 336 px PNG each and a `stream: true` request, each
    answer held to the eager greedy decode of its request alone; the
    stream must bring more than one delta; /health must carry the engine's
    counts. Adds the engine's kernel calls by shape to `seen`. Returns the
    launches of the server's run."""
    import base64
    import io
    import threading
    import urllib.request
    import numpy as np
    from PIL import Image
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.serve import (
        LMMServer, _parse_messages)

    rng = np.random.RandomState(4)
    payloads = []
    for i in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, (336, 336, 3), np.uint8)).save(
            buf, format="PNG")
        url = "data:image/png;base64," + base64.b64encode(
            buf.getvalue()).decode()
        payloads.append({"max_tokens": 32, "messages": [{
            "role": "user", "content": [
                {"type": "image_url", "image_url": {"url": url}},
                {"type": "text",
                 "text": " ".join(WORDS[6 * i:6 * i + 14])}]}]})
    payloads.append(dict(payloads[1], stream=True))
    answers, health = [None] * 3, {}
    srv = LMMServer(lmm, model_name="llava-1.5-7b", host="127.0.0.1", port=0,
                    inflight=True, inflight_kwargs=INFLIGHT)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/chat/completions",
            data=json.dumps(payloads[i]).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            answers[i] = r.read().decode()

    def serve_three():
        srv.start_background()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        post(2)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/health", timeout=60) as r:
            health.update(json.loads(r.read()))

    t0 = time.perf_counter()
    try:
        with engine_shapes(seen):
            _, launches = counted_run(counters, serve_three,
                                      srv.worker.engine)
    finally:
        srv.shutdown()
    wall = time.perf_counter() - t0
    texts = [json.loads(a)["choices"][0]["message"]["content"]
             for a in answers[:2]]
    events = [json.loads(line[6:]) for line in answers[2].split("\n")
              if line.startswith("data: {")]
    deltas = [e["choices"][0]["delta"].get("content") for e in events[1:-1]]
    texts.append("".join(deltas).strip())
    print(f"{tag} [{label}] serve --inflight: 2 concurrent chat completions "
          f"and a streamed one (336 px PNGs) answered in {wall:.2f} s (server "
          f"start and stop included); the stream brought {len(deltas)} "
          f"deltas; /health {health}; launches {launches}")
    if len(deltas) < 2 or health.get("requests") != 3 or \
            health.get("inflight", {}).get("completions") != 3:
        fail(f"[{label}] serve --inflight: {len(deltas)} deltas, /health "
             f"{health}")
    parted = 0
    for i, (p, text) in enumerate(zip(payloads, texts)):
        prompt, imgs = _parse_messages(p["messages"])
        inst = Instance("generate_until", {}, i, "serve",
                        (prompt, {"max_new_tokens": 32}), visual=imgs)
        card = lmm._encode_batch([inst])
        parted += check_engine_tokens(
            tag, label, f"served inflight answer {i}", lmm, card,
            [int(w[1:]) for w in text.split()], 32, bound)
    print(f"{tag} [{label}] serve --inflight: {parted} of {len(texts)} "
          f"answers part from their eager decode, each at a tie within "
          f"{bound:.3e} of max|logit|")
    return launches


# phase 14: the eval zoo on phase 4's LLaVA-1.5-7B. One task of each task
# file the JAX package has beside the paper's (judged, math equivalence,
# mathvista, grounding, captions, mmupd), read from its bundled YAML with
# only the dataset fields pointed at ZOO_DOCS synthetic docs (one batch,
# B = 4) and their random 336 px PNGs. The first three generate up to 1,024
# new tokens: 64 replays of a 16-step chunk over a cache of bucket(prompt) +
# 575 + 1,024 slots
ZOO_TASKS = ("llava_wild", "olympiadbench_test_en", "mathvista_testmini",
             "refcoco_bbox_rec_val", "coco_cap", "mmupd_base")
ZOO_DOCS = 4
ZOO_JUDGED = "llava_wild"       # the only task the stub judge grades
ZOO_HELD_TOKENS = 64            # the graph path's first tokens held to eager


def zoo_docs(name: str) -> list:
    """ZOO_DOCS docs of task `name` with the fields the JAX package's tests
    give them (`tests/test_eval_harness.py`), each over its own PNG. Three
    of olympiadbench's four docs have two-part answers: the random model's
    1,024 tokens decode to ~5,000 characters with no comma, which
    `math_equivalence.judge` refuses at its answer count, while one
    single-answer doc takes the whole sympy path (~11 s of host time on a
    text that long)."""
    docs = {
        "llava_wild": [
            {"question": q, "category": c, "caption": [cap],
             "gpt_answer": a}
            for q, c, cap, a in (
                ("Describe the scene.", "detail", "a dog on grass",
                 "A dog on a lawn."),
                ("What is unusual here?", "complex", "a man irons on a taxi",
                 "He irons clothes on a moving car."),
                ("What color is the bus?", "conv", "a red bus", "Red."),
                ("How many people are there?", "conv", "two people walk",
                 "Two."))],
        "olympiadbench_test_en": [
            {"question": "Compute the area of the triangle.",
             "subfield": "Mathematics", "is_multiple_answer": False,
             "answer_type": "a numeric value",
             "final_answer": [r"\frac{\sqrt{3}}{2}"], "error": 1e-5,
             "source": "OE_en"}] + [
            {"question": f"Find all real roots of polynomial {i}.",
             "subfield": "Mathematics", "is_multiple_answer": True,
             "answer_type": "Numerical", "final_answer": [f"{i},{i + 1}"],
             "error": None, "source": "OE_en"} for i in range(1, 4)],
        "mathvista_testmini": [
            {"question": "Which number is missing?",
             "question_type": "free_form", "answer_type": "integer",
             "answer": "14", "query": "Question: Which number is missing?"},
            {"question": "What fraction is shaded?",
             "question_type": "free_form", "answer_type": "float",
             "answer": "0.6", "precision": 1},
            {"question": "What fraction is blue?",
             "question_type": "multi_choice", "answer_type": "text",
             "choices": ["3/11", "8/11", "6/11"], "answer": "8/11"},
            {"question": "How many sides?", "question_type": "free_form",
             "answer_type": "integer", "answer": "5"}],
        "refcoco_bbox_rec_val": [
            {"question": "", "answer": a, "bbox": b} for a, b in (
                ("the red car", [0.1, 0.1, 0.5, 0.5]),
                ("the dog", [0.6, 0.6, 0.9, 0.9]),
                ("a cup on the left", [0.0, 0.2, 0.3, 0.6]),
                ("the tall tree", [0.4, 0.0, 0.7, 0.9]))],
        "coco_cap": [
            {"question": "", "answers": [a]} for a in (
                "a red fox jumps over the lazy dog",
                "two boats float near the old pier",
                "children play chess in a quiet hall",
                "a man rides a bike down the street")],
        "mmupd_base": [
            {"question": q, "A": "red", "B": "blue", "C": "green",
             "answer": ans, "masked_answer": masked, "index": i,
             "hint": "", "source": "s", "split": "v", "category": "c",
             "type": "aad"}
            for i, (q, ans, masked) in enumerate((
                ("Which color is the sky?", "B", ""),
                ("Which color is grass?", "C", ""),
                ("Which color is the car?", "D", "black"),
                ("Which color is the sign?", "D", "yellow")))],
    }[name]
    return [dict(d, image=f"img{i}.png") for i, d in enumerate(docs)]


class _ZooJudge:
    """A stub chat-completions judge on 127.0.0.1 (port 0) in a thread:
    every request is kept, and a pairwise review answers "8 6"."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, HTTPServer
        seen = self.seen = []

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                seen.append(json.loads(self.rfile.read(
                    int(self.headers["Content-Length"]))))
                body = json.dumps({"choices": [{"message": {
                    "content": "8 6\nAssistant 2 was less detailed."}}]})
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body.encode())

            def log_message(self, *a):
                pass
        self.httpd = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = (f"http://127.0.0.1:{self.httpd.server_port}"
                    f"/v1/chat/completions")
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


def run_eval_zoo(tag: str, dev, counters, lmm, label: str, fig: dict
                 ) -> dict:
    """Phase 14 on phase 4's LLaVA-1.5-7B (bf16): `simple_evaluate` over
    ZOO_TASKS, ZOO_DOCS docs each (one batch of B = 4), every task's
    launches counted from 0 (the graph path's derived from its captures and
    replays) and summed. Holds: every task a finite aggregate of n =
    ZOO_DOCS; the judged task's stub got one rubric request a doc (and only
    it reached the stub); kernels 1, 2 and 3 launched; every (kernel,
    shape) of the phase held to its plain version (kernel 3 at the cache T
    the long tasks reached among them); the first ZOO_HELD_TOKENS tokens
    of the first 1,024-token batch equal eager `generate_greedy`'s on its
    inputs, or part at a near-tie. Prints docs/s a task, the long decode's
    tokens/s and ms a step beside phase 4's at T = 735, the cache T,
    the graph captures and the peak memory. Returns the summed launches."""
    import numpy as np
    import torch
    from PIL import Image
    from law_of_vision_representation_in_mllms_torch.eval.evaluator import (
        simple_evaluate)
    from law_of_vision_representation_in_mllms_torch.eval.task import (
        read_task_file)
    from law_of_vision_representation_in_mllms_torch.eval.tasks import (
        task_yaml)
    from law_of_vision_representation_in_mllms_torch.models import llava as M

    t_phase = time.perf_counter()
    dec = lmm.chunked_decoder()
    captures0 = dec.captures
    layers = lmm.cfg.decoder.num_layers
    torch.cuda.reset_peak_memory_stats(dev)
    # each graph-path generate: its inputs, tokens, the decode part's
    # device ms (CUDA events around the replays and their host reads) and
    # the chunks it ran
    calls, decodes = [], []
    generate, decode = dec.generate, dec._decode

    def timed_decode(st, n_chunks):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        ran = decode(st, n_chunks)
        e1.record()
        e1.synchronize()
        decodes.append((e0.elapsed_time(e1), ran))
        return ran

    def kept_generate(*inputs, max_new_tokens):
        out = generate(*inputs, max_new_tokens=max_new_tokens)
        calls.append(dict(inputs=inputs, n_new=max_new_tokens, out=out,
                          ms=decodes[-1][0], chunks=decodes[-1][1]))
        return out
    dec.generate, dec._decode = kept_generate, timed_decode
    env = {k: os.environ.get(k) for k in ("OPENAI_API_URL", "OPENAI_API_KEY")}
    judge = _ZooJudge()
    seen = collections.Counter()
    total = collections.Counter()
    rows = []
    try:
        with tempfile.TemporaryDirectory() as tmp:
            rng = np.random.RandomState(14)
            for i in range(ZOO_DOCS):
                Image.fromarray(rng.randint(0, 256, (336, 336, 3),
                                            dtype=np.uint8)).save(
                    os.path.join(tmp, f"img{i}.png"))
            for name in ZOO_TASKS:
                # the bundled task file; only its dataset fields change
                cfg = read_task_file(task_yaml(name))
                with open(os.path.join(tmp, f"{name}.json"), "w") as f:
                    json.dump(zoo_docs(name), f)
                cfg.update(dataset_path=os.path.join(tmp, f"{name}.json"),
                           image_root=tmp)
                if name == ZOO_JUDGED:
                    os.environ["OPENAI_API_URL"] = judge.url
                    os.environ["OPENAI_API_KEY"] = "stub"
                else:
                    os.environ.pop("OPENAI_API_URL", None)
                n_judged, n_calls = len(judge.seen), len(calls)
                t0 = time.perf_counter()
                with engine_shapes(seen):
                    res, launches = counted_run(
                        counters, lambda: simple_evaluate(
                            lmm, [cfg], log_samples=True), dec)
                secs = time.perf_counter() - t0
                total.update(launches)
                r = res[name]
                if r["n"] != ZOO_DOCS or not math.isfinite(r["value"]):
                    fail(f"phase 14 {name}: n = {r['n']}, value "
                         f"{r['value']} (want n = {ZOO_DOCS}, finite)")
                judged = judge.seen[n_judged:]
                if name == ZOO_JUDGED:
                    rubric = [b for b in judged
                              if "[Assistant 2]" in b["messages"][-1][
                                  "content"]]
                    if len(rubric) != ZOO_DOCS or len(judged) != ZOO_DOCS:
                        fail(f"phase 14 {name}: the stub judge got "
                             f"{len(judged)} requests ({len(rubric)} "
                             f"rubrics), not one rubric a doc")
                elif judged:
                    fail(f"phase 14 {name} reached the judge without "
                         f"OPENAI_API_URL")
                new = calls[n_calls:]
                if len(new) != 1 or new[0]["out"].shape[0] != ZOO_DOCS:
                    fail(f"phase 14 {name}: {len(new)} graph-path batches, "
                         f"not one of B = {ZOO_DOCS}")
                c = new[0]
                c["t"] = (c["inputs"][0].shape[1] + lmm.cfg.num_patches - 1
                          + -(-c["n_new"] // DECODE_CHUNK) * DECODE_CHUNK)
                c["name"] = name
                rows.append(c)
                print(f"{tag} [{label}] phase 14 {name}: value "
                      f"{r['value']:.4f}, n {r['n']}; {ZOO_DOCS / secs:.3f} "
                      f"docs/s ({secs:.2f} s; max_new_tokens {c['n_new']}, "
                      f"{c['chunks']} chunks of {DECODE_CHUNK} run, cache "
                      f"T={c['t']}); launches {dict(launches)}")
    finally:
        del dec.generate, dec._decode
        judge.close()
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    for name in ("encoder_attention", "flash_attention", "decode_attention"):
        if not total[name]:
            fail(f"phase 14 launched no {name}")
    if total["decode_attention"] % layers:
        fail(f"phase 14's {total['decode_attention']} kernel-3 launches are "
             f"not {layers} a decode step")
    # every kernel shape of the phase, kernel 3 at the long tasks' T among
    # them, against its plain version
    long_t = {c["t"] for c in rows if c["n_new"] >= 1024}
    held_t = {key[2] for key in seen if key[0] == "decode_attention"}
    if not long_t or not long_t <= held_t:
        fail(f"phase 14: kernel 3 ran at T {sorted(held_t)}, not at every "
             f"long task's {sorted(long_t)}")
    hold_engine_shapes(tag, dev, label, seen, fig["decode_cases"],
                       path="eval zoo")
    # the first ZOO_HELD_TOKENS tokens of the first 1,024-token batch
    # against the eager greedy decode on the same inputs
    first = next(c for c in rows if c["n_new"] >= 1024)
    want = M.generate_greedy(lmm.params, lmm.cfg, *first["inputs"],
                             max_new_tokens=ZOO_HELD_TOKENS,
                             eos_id=lmm.tok.eos_token_id)
    check_tokens(tag, label, f"phase 14 {first['name']}'s first "
                 f"{ZOO_HELD_TOKENS} of {first['n_new']} tokens (graph path, "
                 f"T={first['t']})", lmm, first["inputs"], want,
                 first["out"][:, :ZOO_HELD_TOKENS])
    for c in rows:
        if c["n_new"] < 1024:
            continue
        steps = c["chunks"] * DECODE_CHUNK
        print(f"{tag} [{label}] phase 14 {c['name']} decode at T={c['t']}: "
              f"{ZOO_DOCS * steps / c['ms'] * 1e3:.1f} tokens/s "
              f"({c['ms'] / steps:.3f} ms/step over {steps} steps, CUDA "
              f"events around the replays) beside phase 4's "
              f"{fig['graph']['decode_tok_s']:.1f} tokens/s "
              f"({fig['graph']['step_ms']:.3f} ms/step) at T=735")
    print(f"{tag} [{label}] phase 14: cache T reached {max(long_t)}; "
          f"{dec.captures - captures0} graph captures; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(total)


# phase 15: the projector and token variants on phase 4's LLaVA-1.5-7B
# (bf16), its decoder and CLIP-L/14-336 tower shared; 4 requests, 32 new
# tokens each, through the captured decode
VARIANT_SEED = 15
MOF_SPEC = "openai/clip-vit-large-patch14-336,facebook/dinov2-large-336"
VARIANT_KEEP = 144
BURN_SECONDS = 2.0


def variant_lmm(lmm, seed: int, **changes):
    """An adapter over phase 4's weights with `changes` to its LlavaConfig:
    the decoder (and the CLIP tower, and the projector where the variant
    keeps it) are phase 4's modules; a new tower or projector is built on
    the card in bf16 from a generator seeded with `seed`. The new
    `LlavaParams` is made on the meta device, then given those modules, so
    no second 7B decoder is allocated."""
    import torch
    from law_of_vision_representation_in_mllms_torch.eval.llava_adapter \
        import LlavaLMM
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.models.projector import (
        build_projector)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTTower)
    base, cfg = lmm.params, dataclasses.replace(lmm.cfg, **changes)
    dev = base.decoder.embed.device
    prec = base.decoder.precision
    g = torch.Generator(device=dev).manual_seed(seed)
    params = M.LlavaParams(cfg, prec, device="meta")
    params.decoder = base.decoder
    lead = lmm.cfg.tower_spec.entries[0].name
    for i, e in enumerate(cfg.tower_spec.entries):
        if e.name == lead:
            params.towers[i] = base.towers[0]
        else:
            tower = ViTTower(e.vit_config, cfg.select_layer,
                             M._select_feature(cfg, e), prec, device=dev)
            init_weights(tower, g)
            params.towers[i] = tower.eval()
    hidden = cfg.decoder.hidden_size
    if cfg.tower_spec.join == "mof":
        projs = []
        for e in cfg.tower_spec.entries:
            if e.name == lead and cfg.projector_type == \
                    lmm.cfg.projector_type:
                projs.append(base.projector)
            else:
                p = build_projector(cfg.projector_type, e.hidden_size,
                                    hidden, prec, device=dev)
                init_weights(p, g)
                projs.append(p)
        params.projector = torch.nn.ModuleList(projs)
    elif cfg.projector_type != lmm.cfg.projector_type:
        params.projector = build_projector(
            cfg.projector_type, cfg.tower_spec.mm_hidden_size, hidden, prec,
            device=dev)
        init_weights(params.projector, g)
    else:
        params.projector = base.projector
    params.eval()
    return LlavaLMM(params, cfg, lmm.tok, lmm.template,
                    decode_chunk=lmm.decode_chunk)


def run_variants(tag: str, dev, counters, lmm, label: str, fig: dict
                 ) -> dict:
    """Phase 15 on phase 4's LLaVA-1.5-7B (bf16, full width): phase 4's 4
    requests, 32 new tokens, through `generate_until` (the captured decode)
    for (a) a `perceiver2x` projector over CLIP-L/14-336 (64 image
    tokens; its attention 2 kernel-2 launches an encode, B = 4, Sq 64, Skv
    640), (b) MoF CLIP-L/14-336 + DINOv2-L/14-336 with an `mlp2x_gelu`
    projector each (1,152 interleaved image tokens, T ~1,311; kernel 1 on
    both towers) and (c) `visual_keep` = 144 by `prune_score` auto (the CLS
    attention of CLIP's block 22, from the tower pass itself). Each run's
    launches are counted from 0 (the graph path's derived from captures
    and replays). Holds for each: finite prefill and decode-step logits;
    the image-token count of `encode_images` and of the splice; the
    captured decode's tokens against the eager `generate_greedy`'s (phase
    4's near-tie rule); the launches of kernels 1, 2 and 3; every kernel
    shape the runs called held to its plain version (`hold_engine_shapes`).
    Prints TTFT (a prefill, host clock around synchronised work), decode
    tokens/s (CUDA events around the replays) and the peak GB of each;
    then runs `utils.burner.burn` for BURN_SECONDS and prints its TFLOP/s.
    Returns the launches of each run by its path name."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        parse_tower_spec)
    from law_of_vision_representation_in_mllms_torch.utils.burner import burn

    t_phase = time.perf_counter()
    layers = lmm.cfg.decoder.num_layers
    eos = lmm.tok.eos_token_id
    reqs = _requests(4, lmm.processors[0].crop)
    clip_blocks = lmm.cfg.tower_spec.entries[0].vit_config.resolve_layer(
        lmm.cfg.select_layer)
    mof = parse_tower_spec(MOF_SPEC)
    runs = (
        ("perceiver2x", dict(projector_type="perceiver2x"), 64,
         clip_blocks, layers + 2),
        ("mof", dict(tower_spec=mof), mof.num_patches,
         sum(e.vit_config.resolve_layer(lmm.cfg.select_layer)
             for e in mof.entries), layers),
        ("visual_keep", dict(visual_keep=VARIANT_KEEP, prune_score="auto"),
         VARIANT_KEEP, clip_blocks, layers))
    seen = collections.Counter()
    paths = {}
    for i, (name, changes, n_img, want_k1, want_k2) in enumerate(runs):
        t0 = time.perf_counter()
        vlmm = variant_lmm(lmm, VARIANT_SEED + i, **changes)
        what = f"[{label}] phase 15 ({'abc'[i]}) {name}"
        if vlmm.cfg.num_patches != n_img:
            fail(f"{what}: {vlmm.cfg.num_patches} image tokens, not {n_img}")
        dec = vlmm.chunked_decoder()
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with engine_shapes(seen):
            texts, launches = counted_run(
                counters, lambda: vlmm.generate_until(reqs), dec)
        paths[f"variant_{name}"] = launches
        ids, mask, pixels = inputs = vlmm._encode_batch(reqs)
        with torch.inference_mode():
            img = M.encode_images(vlmm.params, vlmm.cfg, pixels)
        if img.shape != (4, n_img, vlmm.cfg.decoder.hidden_size) or not \
                torch.isfinite(img).all():
            fail(f"{what}: encode_images gave {tuple(img.shape)}, finite "
                 f"{bool(torch.isfinite(img).all())}; want [4, {n_img}, "
                 f"4096]")
        pre = M.prefill(vlmm.params, vlmm.cfg, ids, mask, pixels,
                        max_new_tokens=2)
        step = M.decode_step(vlmm.params, pre, pre.logits.argmax(-1), 0)
        if pre.l_out != ids.shape[1] + n_img - 1 or not (
                torch.isfinite(pre.logits).all()
                and torch.isfinite(step).all()):
            fail(f"{what}: spliced length {pre.l_out} (want "
                 f"{ids.shape[1] + n_img - 1}) or the logits are not finite")
        del pre, step, img
        steps = launches["decode_attention"] // layers
        print(f"{tag} {what}: launches {dict(launches)} ({steps} decode "
              f"steps); sample answer {texts[0][:60]!r}")
        if (launches["encoder_attention"] != want_k1
                or launches["flash_attention"] != want_k2
                or not steps or launches["decode_attention"] % layers):
            fail(f"{what}: kernels 1, 2, 3 launched "
                 f"{launches['encoder_attention']}, "
                 f"{launches['flash_attention']}, "
                 f"{launches['decode_attention']}; want {want_k1}, "
                 f"{want_k2} and {layers} a decode step")
        want = M.generate_greedy(vlmm.params, vlmm.cfg, *inputs,
                                 max_new_tokens=32, eos_id=eos)
        got = dec.generate(*inputs, max_new_tokens=32)
        check_tokens(tag, label, f"phase 15 {name} (captured decode vs "
                     f"eager)", vlmm, inputs, want, got)
        ttft_s = timed_s(lambda: M.prefill(vlmm.params, vlmm.cfg, ids, mask,
                                           pixels, max_new_tokens=32), dev)
        ms = replay_ms(lambda: dec._start(*inputs, 2 * DECODE_CHUNK),
                       lambda st: dec._decode(st, 2))
        t_cache = ids.shape[1] + n_img - 1 + 2 * DECODE_CHUNK
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        print(f"{tag} {what}: {n_img} image tokens, cache T={t_cache}; TTFT "
              f"(tower + projector + splice + prefill, B=4) "
              f"{ttft_s * 1e3:.2f} ms; decode {4 * 2 * DECODE_CHUNK / ms * 1e3:.1f}"
              f" tokens/s ({ms / (2 * DECODE_CHUNK):.3f} ms/step, CUDA events "
              f"around the replays); peak {peak:.2f} GB; "
              f"{time.perf_counter() - t0:.1f} s")
        fig.setdefault("variants", {})[name] = dict(
            ttft_ms=ttft_s * 1e3, decode_tok_s=4 * 2 * DECODE_CHUNK / ms * 1e3,
            step_ms=ms / (2 * DECODE_CHUNK), peak_gb=peak, t=t_cache)
        del vlmm, dec, inputs, ids, mask, pixels, want, got
        gc.collect()
        torch.cuda.empty_cache()
    hold_engine_shapes(tag, dev, label, seen, fig["decode_cases"],
                       path="phase 15")
    if not any(k[0] == "flash_attention_noncausal" for k in seen):
        fail("phase 15 (a) never called kernel 2 from the perceiver")
    tflops = burn(BURN_SECONDS, 8192, dev)
    print(f"{tag} [{label}] utils.burner.burn({BURN_SECONDS} s, 8192x8192 "
          f"bf16 chains): {tflops:.1f} TFLOP/s sustained "
          f"({tflops / H100_BF16_TFLOPS:.1%} of {H100_BF16_TFLOPS:.0f})")
    print(f"{tag} [{label}] phase 15 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return paths


def _training_records(folder: str, n: int = FULL_RECORDS) -> str:
    """`n` `plain`-template records, each a random 336x336 PNG (written with
    PIL) and a 20-40-word caption. Returns the JSON path."""
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(0)
    recs = []
    for i in range(n):
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
                "kernel 6 (dk/dv)": 0.0, "kernel 10 (int4 matmul)": 0.0,
                "kernel 10 dx (int4 input gradient)": 0.0,
                "copies and memsets": 0.0,
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
        elif "flash_fwd_wgmma_kernel<64" in name:
            fam = "kernel 1 (tower attention)"
        elif "flash_fwd_wgmma_kernel" in name:
            fam = "kernel 2 (flash forward)"
        elif "int4_wgmma_dx" in name:
            fam = "kernel 10 dx (int4 input gradient)"
        elif "int4_" in name:
            fam = "kernel 10 (int4 matmul)"
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
        reset_counts(counters)
        t0 = time.perf_counter()
        run = runner.run_training(cfg, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
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
        # phase 18 (b) on this model and batch, before the profiler runs
        gpipe = check_gpipe(tag, dev, counters, params, run.model_cfg, batch)
        profile_step(tag, run, batch)
    return launches, gpipe


VARIANT_STEPS = 3
VARIANT_TRAIN = {
    # `finetune.sh`'s rate: Adam moves each of W's 4,096 entries a row by
    # about lr a step, and at 1e-3 the third step's loss left 12 for 59
    "switch": {"stage": 2, "switch_enable": True, "switch_sigma": 1.0,
               "learning_rate": 2e-5},
    # `finetune_lora.sh`: r 128, alpha 256 (~320 M adapter parameters). The
    # rate is 10x the script's 2e-4 so that three steps (the first at the
    # warm-up's lr 0) move B far enough for the merge check to tell the
    # adapted model from its base
    "lora": {"stage": 2, "lora_enable": True, "lora_r": 128,
             "lora_alpha": 256.0, "learning_rate": 2e-3},
    "qlora": {"stage": 2, "lora_enable": True, "lora_r": 128,
              "lora_alpha": 256.0, "learning_rate": 2e-3,
              "quantize_base": "int4"},
}


def run_full_width_variant(tag: str, dev, counters, variant: str) -> dict:
    """LLaVA-1.5-7B at full width through `run_training`, stage 2, with
    `train.lora_enable` (r=128, alpha=256), the same over an int4 base
    (`train.quantize_base`: QLoRA, kernel 10 under autograd) or
    `train.switch_enable`: VARIANT_STEPS steps of FULL_BATCH. Finite losses,
    no skipped step, the frozen weights bitwise those of a fresh build from
    the seed, B non-zero (only W moved under switch), the saved files load
    back, and for LoRA `load_pretrained` (which merges the adapters) then a
    prefill gives the adapted model's logits. The LoRA and the QLoRA run end
    with a torch.profiler split of one more step."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION)
    from law_of_vision_representation_in_mllms_torch.data import (
        collate_batch)
    from law_of_vision_representation_in_mllms_torch.io import (
        checkpoint, from_jax)
    from law_of_vision_representation_in_mllms_torch.io.param_io import (
        load_params)
    from law_of_vision_representation_in_mllms_torch.models import (
        llama as L, llava as M, switch as SW)
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IGNORE_INDEX, splice_embeds, splice_plan)
    from law_of_vision_representation_in_mllms_torch.ops.quant import (
        quantize_decoder)
    from law_of_vision_representation_in_mllms_torch.train import runner

    what = f"run_training [{variant}]"
    with tempfile.TemporaryDirectory(prefix="lvr_smoke_variant_") as tmp:
        out_dir = os.path.join(tmp, "out")
        cfg = RunConfig.from_dict({
            "train": dict({"batch_size": FULL_BATCH, "epochs": 1,
                           "gradient_checkpointing": True,
                           "save_steps": 1000, "output_dir": out_dir},
                          **VARIANT_TRAIN[variant]),
            "data": {"data_path": _training_records(
                tmp, VARIANT_STEPS * FULL_BATCH), "image_folder": tmp}})
        if variant == "qlora":
            # the build alone: the decoder is made quantised block by block,
            # so its peak is the int4 model plus one fp32 block (or lm_head)
            torch.cuda.reset_peak_memory_stats(dev)
            base_mem = torch.cuda.memory_allocated(dev)
            _, built = runner.build_model(cfg, device=dev,
                                          precision=DEFAULT_PRECISION,
                                          quantize_bits=4)
            torch.cuda.synchronize(dev)
            build_peak = (torch.cuda.max_memory_allocated(dev) - base_mem) / 1e9
            build_held = (torch.cuda.memory_allocated(dev) - base_mem) / 1e9
            print(f"{tag} {what}: the model built with its decoder quantised "
                  f"block by block: peak {build_peak:.2f} GB during the build, "
                  f"{build_held:.2f} GB held after it")
            del built
            gc.collect()
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(counters)
        t0 = time.perf_counter()
        run = runner.run_training(cfg, device=dev)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = read_counts(counters)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        held_gb = torch.cuda.memory_allocated(dev) / 1e9
        with open(os.path.join(out_dir, "train.jsonl")) as f:
            logs = [json.loads(line) for line in f if line.strip()]
        params = run.state["params"]
        trainable = sum(p.numel() for _, p in run.opt.named_params)
        subtrees = sorted({n.split(".")[0] for n, _ in run.opt.named_params})
        print(f"{tag} {what}: LLaVA-1.5-7B stage 2, fp32 weights, bf16 "
              f"compute, block remat, flash route {run.train_cfg.use_flash}; "
              f"{trainable / 1e6:.1f} M trainable parameters in "
              f"{subtrees}; {len(logs)} steps of {FULL_BATCH}, {wall:.1f} s "
              f"in all (model build and data included)")
        print(f"{tag} {what} launches {launches}")
        print(f"{tag} {what} losses "
              + " ".join(f"{r['loss']:.5f}" for r in logs) + "; grad norms "
              + " ".join(f"{r['grad_norm']:.4g}" for r in logs))
        if len(logs) != VARIANT_STEPS:
            fail(f"{what} took {len(logs)} steps, not {VARIANT_STEPS}")
        if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                   for r in logs):
            fail(f"{what}: a loss or gradient norm is not finite")
        if any(r["skipped_nonfinite"] != 0.0 for r in logs):
            fail(f"{what}: a step was skipped as nonfinite")
        if run.train_cfg.use_flash is not True:
            fail(f"{what} did not take the flash route on the card")
        if subtrees != (["switch"] if variant == "switch"
                        else ["lora", "projector"]):
            fail(f"{what}: the trainable subtrees are {subtrees}")
        # per step: the tower's 23 blocks; the decoder's 32 flash forwards,
        # under LoRA once more in the remat recompute, and 32 of each
        # backward kernel. The switch sits behind the decoder: one forward,
        # no decoder backward at all
        lora = variant != "switch"
        per_step = {"encoder_attention": 23,
                    "flash_attention": 64 if lora else 32,
                    "flash_attention_bwd_dq": 32 if lora else 0,
                    "flash_attention_bwd_dkv": 32 if lora else 0}
        for name, n in per_step.items():
            if launches[name] != n * VARIANT_STEPS:
                fail(f"{what}: {name} launched {launches[name]} times in "
                     f"{VARIANT_STEPS} steps, not {n} per step")
        if (launches["int4_matmul"] == 0) != (variant != "qlora"):
            fail(f"{what}: kernel 10 launched {launches['int4_matmul']} "
                 f"times")
        # the input gradient of every quantised matmul, once a step: 7 a
        # layer and the lm_head
        dx_step = 7 * run.model_cfg.decoder.num_layers + 1 \
            if variant == "qlora" else 0
        if launches["int4_matmul_dx"] != dx_step * VARIANT_STEPS:
            fail(f"{what}: int4_matmul_dx launched "
                 f"{launches['int4_matmul_dx']} times in {VARIANT_STEPS} "
                 f"steps, not {dx_step} per step")
        step_s = float(np.median([r["step_seconds"] for r in logs[1:]]))
        seq = max(int(r["tokens"]) // FULL_BATCH for r in logs)
        print(f"{tag} {what} step (B={FULL_BATCH}, S={seq} spliced): median "
              f"of steps 2-{VARIANT_STEPS} {step_s * 1e3:.1f} ms (steps "
              + " ".join(f"{r['step_seconds'] * 1e3:.1f}" for r in logs)
              + f" ms); {FULL_BATCH * seq / step_s:.0f} tokens/s; peak "
              f"memory allocated {peak_gb:.2f} GB (the model's build included); "
              f"weights, adapters and moments held after the run "
              f"{held_gb:.2f} GB")

        # the same seed rebuilds the initial weights, densely, and
        # `quantize_decoder` gives the codes: what is frozen must be bitwise
        # what it was (under QLoRA this also holds the block-by-block build
        # to the dense build's codes)
        _, fresh = runner.build_model(cfg, device=dev,
                                      precision=DEFAULT_PRECISION)
        if variant == "qlora":
            quantize_decoder(fresh.decoder, bits=4)
        trained = params.state_dict()
        moved = set()
        for name, t in fresh.state_dict().items():
            if not torch.equal(t, trained[name]):
                moved.add(name.split(".")[0])
        if moved != ({"projector"} if lora else set()):
            fail(f"{what}: weights moved in {sorted(moved)}")

        files = sorted(os.listdir(out_dir))
        if variant == "switch":
            g = torch.Generator(device=dev).manual_seed(cfg.train.seed + 2)
            w0 = SW.init_switch(g, run.model_cfg.decoder.hidden_size,
                                DEFAULT_PRECISION, dev).w
            w = params.switch.w
            saved = from_jax.switch_state_dict(load_params(
                os.path.join(out_dir, checkpoint.SWITCH_NPZ)))["w"]
            if not torch.equal(saved, w.cpu()):
                fail("switch.npz differs from the trained W")
            step_size = (w - w0).abs().max().item()
            if not 0 < step_size:
                fail("the switch matrix did not move")
            print(f"{tag} {what}: only W moved (largest |W - W0| "
                  f"{step_size:.3e}); {files} written, switch.npz loads "
                  f"back equal")
        else:
            saved = from_jax.lora_state_dict(load_params(
                os.path.join(out_dir, checkpoint.LORA_NPZ)))
            b_max = 0.0
            for name, t in params.lora.state_dict().items():
                if not torch.equal(saved[name], t.cpu()):
                    fail(f"lora_adapters.npz {name} differs from the "
                         f"trained adapters")
                if name.endswith("_b"):
                    if not (t != 0).any():
                        fail(f"{what}: {name} is still zero")
                    b_max = max(b_max, t.abs().max().item())
            proj = checkpoint.load_projector(out_dir)
            for name, t in params.projector.state_dict().items():
                if not torch.equal(proj[name], t.cpu()):
                    fail(f"mm_projector.npz {name} differs")
            with open(os.path.join(out_dir, "config.json")) as f:
                saved_cfg = json.load(f)
            if saved_cfg != {"lora_r": 128, "lora_alpha": 256.0}:
                fail(f"{what}: config.json holds {saved_cfg}")
            print(f"{tag} {what}: the frozen base is bitwise unchanged, "
                  f"every B is non-zero (largest |B| {b_max:.3e}); {files} "
                  f"written and load back equal")
        if variant == "lora":
            # serving: the adapted model's prefill logits, then the base's,
            # then `load_pretrained` (merge + projector) over the base
            batch = runner.batch_to_device(collate_batch(
                [run.dataset[i] for i in range(4)],
                max_length=cfg.train.max_length), dev)
            ids, mask, px = (batch["input_ids"], batch["text_mask"],
                             batch["pixel_values"])
            mcfg = run.model_cfg

            with torch.inference_mode():
                plan = splice_plan(ids, torch.full_like(ids, IGNORE_INDEX),
                                   mask, mcfg.num_patches)
                embeds = splice_embeds(
                    plan, L.embed_tokens(params.decoder, ids),
                    M.encode_images(params, mcfg, px))
                h, _ = params.decoder(
                    embeds, plan.positions, attn_mask=plan.attn_mask,
                    use_flash=True, lora=params.lora,
                    lora_scaling=run.train_cfg.lora_scaling)
                last = plan.attn_mask.sum(dim=1) - 1
                adapted = L.logits_fn(
                    params.decoder, h[torch.arange(len(last)), last])
            base = M.prefill(fresh, mcfg, ids, mask, px,
                             max_new_tokens=1).logits
            if checkpoint.load_pretrained(out_dir, fresh) is not fresh:
                fail("load_pretrained did not return the model it was given")
            merged = M.prefill(fresh, mcfg, ids, mask, px,
                               max_new_tokens=1).logits
            err = max_err(merged, adapted)
            apart = max_err(base, adapted)
            tol = LOGITS_REL_TOL * adapted.abs().max().item()
            print(f"{tag} {what}: load_pretrained (merge_lora + projector) "
                  f"then prefill vs the adapted forward: logits max_abs_err "
                  f"{err:.4e} (tol {tol:.4e} = {LOGITS_REL_TOL} x "
                  f"max|logit|); the unmerged base lies {apart:.4e} away")
            if not (torch.isfinite(merged).all() and err <= tol):
                fail(f"merged logits disagree with the adapted: {err}")
            if not err < apart:
                fail(f"the merge brought the base no closer to the adapted "
                     f"model ({err} vs {apart})")
        del fresh, trained
        gc.collect()
        torch.cuda.empty_cache()
        if lora:
            # where a LoRA and a QLoRA step spend the device's time, after
            # every check of the trained state (the profiled steps train on)
            profile_step(f"{tag} {what}", run, runner.batch_to_device(
                collate_batch([run.dataset[i] for i in range(FULL_BATCH)],
                              max_length=cfg.train.max_length), dev))
        del params, run
        gc.collect()
        torch.cuda.empty_cache()
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

def _spair_tree(root: str, n_images: int, n_pairs: int) -> int:
    """A synthetic SPair-71k test split under `root`: per category `n_images`
    smooth random JPEGs of 300-500 px a side (SPair's images are JPEGs, and
    its loader finds an image's annotation by turning `.jpg` into `.json`),
    keypoints ~80 % visible inside a bounding box that lies inside the
    image, numbered up to the category's highest geo-aware keypoint, and
    `n_pairs` seeded (source, target) pairs. Returns the image count."""
    import numpy as np
    from PIL import Image
    from law_of_vision_representation_in_mllms_torch.metrics import spair
    groups = spair.load_geoware_tables()["SPAIR_GEO_AWARE"]
    rng = np.random.RandomState(12)
    os.makedirs(os.path.join(root, "PairAnnotation", "test"))
    for cat in spair.SPAIR_CATEGORIES:
        num_kps = 1 + max(i for g in groups[cat]
                          for i in ([g] if isinstance(g, int) else g))
        for sub in ("JPEGImages", "ImageAnnotation"):
            os.makedirs(os.path.join(root, sub, cat))
        boxes = []
        for i in range(n_images):
            w, h = (int(v) for v in rng.randint(300, 501, 2))
            coarse = rng.randint(0, 256, (h // 24 + 2, w // 24 + 2, 3),
                                 dtype=np.uint8)
            name = f"{cat}_{i:03d}"
            Image.fromarray(coarse).resize(
                (w, h), Image.Resampling.BILINEAR).save(
                os.path.join(root, "JPEGImages", cat, f"{name}.jpg"),
                quality=90)
            box = [int(rng.randint(0, w // 4)), int(rng.randint(0, h // 4)),
                   int(rng.randint(3 * w // 4, w)),
                   int(rng.randint(3 * h // 4, h))]
            kps = {str(k): ([float(rng.randint(box[0], box[2])),
                             float(rng.randint(box[1], box[3]))]
                            if rng.rand() < 0.8 else None)
                   for k in range(num_kps)}
            with open(os.path.join(root, "ImageAnnotation", cat,
                                   f"{name}.json"), "w") as f:
                json.dump({"kps": kps, "image_width": w,
                           "image_height": h}, f)
            boxes.append(([w, h, 3], box))
        for p in range(n_pairs):
            s, t = (int(v) for v in rng.choice(n_images, 2, replace=False))
            pair = {"category": cat,
                    "src_imname": f"{cat}_{s:03d}.jpg",
                    "trg_imname": f"{cat}_{t:03d}.jpg",
                    "src_imsize": boxes[s][0], "trg_imsize": boxes[t][0],
                    "src_bndbox": boxes[s][1], "trg_bndbox": boxes[t][1]}
            with open(os.path.join(
                    root, "PairAnnotation", "test",
                    f"{p:06d}-{cat}_{s:03d}-{cat}_{t:03d}:{cat}.json"),
                    "w") as f:
                json.dump(pair, f)
    return n_images * len(spair.SPAIR_CATEGORIES)


class _Spy:
    """Wraps `module.name` while the block runs: each call's seconds (after
    a device sync when `dev` is given) and what `keep(args, out)` returns."""

    def __init__(self, module, name: str, dev=None, keep=None):
        self.module, self.name, self.dev = module, name, dev
        self.keep = keep or (lambda args, out: None)
        self.seconds, self.kept = [], []

    def __enter__(self):
        import torch
        orig = self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            out = orig(*args, **kw)
            if self.dev is not None:
                torch.cuda.synchronize(self.dev)
            self.seconds.append(time.perf_counter() - t0)
            self.kept.append(self.keep(args, out))
            return out
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _c_score_run(spair_dir: str, feature_dir: str, num_patches: int, dev,
                 keep):
    """`run_c_score` on `dev` with its parts timed: the annotations and the
    feature files read on the host, `compute_pck_batch` (device), and what
    `keep(args, (result, pred))` keeps of each category's step."""
    from law_of_vision_representation_in_mllms_torch.metrics import spair
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        c_score_run)
    sync = dev if dev.type == "cuda" else None
    t0 = time.perf_counter()
    with _Spy(spair, "load_spair_data") as annos, \
            _Spy(c_score_run, "_load_features",
                 keep=lambda args, out: args) as loads, \
            _Spy(c_score_run, "compute_pck_batch", sync, keep) as steps:
        res = c_score_run.run_c_score(spair_dir, feature_dir, device=dev,
                                      num_patches=num_patches,
                                      anno_size=C_ANNO, compute_geo=True)
    parts = {"total": time.perf_counter() - t0, "annotations":
             sum(annos.seconds), "features": sum(loads.seconds),
             "device": sum(steps.seconds), "feature_reads": loads.kept}
    n_cats = len(spair.SPAIR_CATEGORIES)
    seen = [len(res["categories"]), len(annos.seconds), len(loads.seconds),
            len(steps.seconds)]
    if seen != [n_cats] * 4:
        fail(f"run_c_score on {dev}: categories, annotation loads, feature "
             f"loads and compute_pck_batch calls {seen}, not {n_cats} each")
    return res, parts, steps.kept


def _plain_feature_reads(reads) -> float:
    """Seconds of the plain numpy reader (one `np.load` a file) over the
    files of `run_c_score`'s feature reads `reads` ([(files, feature_dir,
    suffix)]), right after the native loader read them."""
    import numpy as np
    from law_of_vision_representation_in_mllms_torch.io import native_cache
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        c_score_run)
    t0 = time.perf_counter()
    for files, feature_dir, suffix in reads:
        paths = c_score_run.feature_paths(files, feature_dir, suffix)
        first = np.load(paths[0], mmap_mode="r")
        native_cache.numpy_batch_load(paths, first.shape, first.dtype)
    return time.perf_counter() - t0


def _near_tie_gap(c_mod, args, pair: int, kpt: int, n: int) -> float:
    """The top-two similarity gap of the source row a keypoint reads."""
    desc1, desc2, kps1 = args[0][pair], args[1][pair], args[2][pair]
    idx = int(c_mod.kpts_to_patch_idx(kps1[kpt], n, C_ANNO))
    row = c_mod.similarity(c_mod.normalize_feats(desc1[idx:idx + 1]),
                           c_mod.normalize_feats(desc2))[0]
    top = row.topk(2).values
    return float(top[0] - top[1])


def run_c_score_leg(tag: str, dev, counters, tmp: str, reps: dict):
    """Phase 6's C-score leg at full width: a synthetic SPair tree, then for
    each rep `extract-features` (the tower's kernel 1 or 2, batch 16, bf16)
    and `run_c_score` on the card, held to the same function on the CPU in
    fp32 over the same feature files. Returns ({rep: result}, launches)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch import cli
    from law_of_vision_representation_in_mllms_torch.metrics import (
        c_score as C)
    from law_of_vision_representation_in_mllms_torch.models.towers import (
        parse_tower_spec)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTTower)
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        features as pfeat, runner as prunner)

    from law_of_vision_representation_in_mllms_torch.io import native_cache
    t0 = time.perf_counter()
    native = native_cache.native_available()
    print(f"{tag} C score: native_available() {native} (the feature loader "
          f"built from native/lvr_loader.cpp into "
          f"{os.path.relpath(native_cache.library_path(), REPO)} in "
          f"{time.perf_counter() - t0:.2f} s)")
    if not native:
        fail("the native feature loader did not build")
    root = os.path.join(tmp, "SPair-71k")
    t0 = time.perf_counter()
    n_images = _spair_tree(root, C_IMAGES, C_PAIRS)
    images = sorted(glob.glob(os.path.join(root, "JPEGImages", "*",
                                           "*.jpg")))
    if len(images) != n_images:
        fail(f"the SPair tree holds {len(images)} images, not {n_images}")
    towers = {rep: parse_tower_spec(raw["model"]["vision_tower"])
              for rep, raw in reps.items()}
    # one rep's fp32 features on disk at a time
    need = max(n_images * t.num_patches * t.mm_hidden_size * 4 * 1.1
               for t in towers.values())
    free = shutil.disk_usage(tmp).free
    if free < need:
        fail(f"{free / 1e9:.2f} GB free under the temporary directory, "
             f"{need / 1e9:.2f} GB needed for one rep's SPair features")
    print(f"{tag} C score: a synthetic SPair tree of {n_images} JPEGs and "
          f"{C_PAIRS * 18} pairs written in {time.perf_counter() - t0:.2f} "
          f"s; one rep's features {need / 1.1e9:.2f} GB")

    def on_cpu(args, out):
        # the CPU run keeps its inputs, for the gap of a differing keypoint
        return args, out[0].correct

    def on_card(args, out):
        return out[0].correct.cpu()

    torch.cuda.reset_peak_memory_stats(dev)
    results, cpu_results, stash, figures = {}, {}, {}, {}
    n_tied = 0
    worst_gap = 0.0
    reset_counts(counters)
    # the main path, counted: extract-features and run_c_score on the
    # card, three reps (the CPU runs in between launch nothing) -----------
    for rep, raw in reps.items():
        out_dir = os.path.join(tmp, f"spair_{rep}")
        sets = [f"{section}.{k}={v}" for section, d in raw.items()
                for k, v in d.items()]
        argv = ["extract-features", "--images",
                os.path.join(root, "JPEGImages"), "--out-dir", out_dir,
                "--batch-size", str(C_BATCH), "--device", str(dev)]
        for item in sets:
            argv += ["--set", item]
        t0 = time.perf_counter()
        with _Spy(prunner, "extract_tower_features", dev) as ext, \
                _Spy(pfeat, "preprocess_image") as prep, \
                _Spy(ViTTower, "forward", dev) as fwd, \
                _Spy(pfeat.np, "save") as saves, \
                contextlib.redirect_stdout(io.StringIO()) as said:
            cli.main(argv)
        seen = [len(ext.seconds), len(fwd.seconds), len(prep.seconds),
                len(saves.seconds)]
        if seen != [1, -(-n_images // C_BATCH), n_images, n_images]:
            fail(f"{rep}: extraction, tower, preprocess and np.save calls "
                 f"{seen}, not [1, {-(-n_images // C_BATCH)}, {n_images}, "
                 f"{n_images}]")
        build_s = time.perf_counter() - t0 - ext.seconds[0]
        split = {"preprocess": sum(prep.seconds), "tower": sum(fwd.seconds),
                 "save": sum(saves.seconds)}
        if said.getvalue().strip() != (f"extracted {n_images} feature files "
                                       f"to {out_dir}"):
            fail(f"{rep}: extract-features said {said.getvalue()!r}")
        grid = towers[rep].entries[0].vit_config.grid
        files = sorted(f for f in os.listdir(out_dir) if f.endswith(".npy"))
        if len(files) != n_images:
            fail(f"{rep}: {len(files)} feature files, not {n_images}")
        shape = (grid * grid, towers[rep].mm_hidden_size)
        for f in files:
            x = np.load(os.path.join(out_dir, f))
            if (x.shape != shape or x.dtype != np.float32
                    or not np.isfinite(x).all()):
                fail(f"{rep}: {f} is not a finite fp32 {shape}")
        if not stash:
            stash.update({f: np.load(os.path.join(out_dir, f))
                          for f in files[:C_BATCH]})

        res, parts, card_correct = _c_score_run(root, out_dir, grid, dev,
                                                on_card)
        parts["plain_features"] = _plain_feature_reads(
            parts.pop("feature_reads"))
        # the same function on the CPU in fp32 over the same files
        cpu_res, cpu_parts, cpu_steps = _c_score_run(
            root, out_dir, grid, torch.device("cpu"), on_cpu)
        tied = 0
        if list(res["categories"]) != list(cpu_res["categories"]):
            fail(f"{rep}: the card scored categories "
                 f"{list(res['categories'])}, the CPU "
                 f"{list(cpu_res['categories'])}")
        for cat, got_c, (args, want_c) in zip(res["categories"],
                                              card_correct, cpu_steps,
                                              strict=True):
            differ = (got_c != want_c).any(0)
            for pair, kpt in differ.nonzero().tolist():
                gap = _near_tie_gap(C, args, pair, kpt, grid)
                worst_gap = max(worst_gap, gap)
                tied += 1
            mine, ref = res["categories"][cat], cpu_res["categories"][cat]
            for key in ("n_kpts", "n_pairs", "n_geo_kpts"):
                if mine[key] != ref[key]:
                    fail(f"{rep} {cat}: {key} {mine[key]} on the card, "
                         f"{ref[key]} on the CPU")
            if not differ.any():
                for key in ("per_kpt", "per_img", "geo_per_kpt"):
                    if not np.allclose(mine[key], ref[key], rtol=0,
                                       atol=C_AGG_TOL):
                        fail(f"{rep} {cat}: {key} {mine[key]} on the card, "
                             f"{ref[key]} on the CPU, the same keypoints "
                             f"correct")
        del cpu_steps
        n_tied += tied
        if worst_gap >= C_NEAR_TIE:
            fail(f"{rep}: a keypoint's correctness differs between the card "
                 f"and the CPU where its source row's top two similarities "
                 f"are {worst_gap:.3g} apart (near-tie bound {C_NEAR_TIE})")
        for key in ("per_img", "per_kpt", "geo"):
            if not all(0.0 <= v <= 1.0 for v in res[key]):
                fail(f"{rep}: {key} {res[key]} is not in [0, 1]")
        if rep == next(iter(reps)):
            _check_pinned_fp32(tag, C, out_dir, root, dev)
        results[rep], cpu_results[rep] = res, cpu_res
        figures[rep] = (ext.seconds[0], build_s, split, parts, cpu_parts,
                        tied)
        shutil.rmtree(out_dir)
        gc.collect()
        torch.cuda.empty_cache()
    launches = read_counts(counters)
    # ---------------------------------------------------------------------
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    calls = -(-n_images // C_BATCH)
    want = {"encoder_attention": 23 * calls * sum(
        1 for raw in reps.values()
        if raw["model"]["tower_attn_impl"] != "flash"),
        "flash_attention": 23 * calls}
    if any(launches[k] != v for k, v in want.items()) or any(
            v for k, v in launches.items() if k not in want):
        fail(f"the C-score leg's launches {launches}, not {want} (23 "
             f"blocks a tower call, {calls} calls a rep)")

    # a second extraction of the first batch of the first rep: same bits
    first = next(iter(reps))
    listing = os.path.join(tmp, "first_batch.json")
    with open(listing, "w") as f:
        json.dump(images[:C_BATCH], f)
    again_dir = os.path.join(tmp, "spair_again")
    cfg_raw = reps[first]
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    prunner.run_feature_extraction(RunConfig.from_dict(cfg_raw), listing,
                                   again_dir, device=dev,
                                   batch_size=C_BATCH)
    for f, x in stash.items():
        if not np.array_equal(np.load(os.path.join(again_dir, f)), x):
            fail(f"{first}: a second extraction of {f} gave other bits")
    shutil.rmtree(again_dir)

    for rep, (ext_s, build_s, split, parts, cpu_parts,
              tied) in figures.items():
        res, ref = results[rep], cpu_results[rep]
        print(f"{tag} C score {rep} (route "
              f"{reps[rep]['model']['tower_attn_impl']}, {n_images} images, "
              f"{C_PAIRS * 18} pairs): per_img PCK@.10/.05/.01 "
              f"{', '.join(f'{v:.4f}' for v in res['per_img'])} (CPU "
              f"{', '.join(f'{v:.4f}' for v in ref['per_img'])}), per_kpt "
              f"{res['per_kpt'][0]:.4f}, geo {res['geo'][0]:.4f}; "
              f"extraction {n_images / ext_s:.1f} images/s ({ext_s:.2f} s: "
              f"preprocess_image {split['preprocess']:.2f} (host: decode, "
              f"resize), tower calls {split['tower']:.2f} (card, synced), "
              f"np.save {split['save']:.2f}, the rest "
              f"{ext_s - sum(split.values()):.2f}; the 7B build "
              f"{build_s:.2f} s apart); run_c_score "
              f"{parts['total']:.2f} s: annotations {parts['annotations']:.2f}"
              f", feature files {parts['features']:.2f} (host, the native "
              f"batch_load; the plain numpy reader on the same files "
              f"{parts['plain_features']:.2f}), "
              f"compute_pck_batch {parts['device']:.3f} (device), the rest "
              f"{parts['total'] - parts['annotations'] - parts['features'] - parts['device']:.2f}"
              f"; the CPU's run {cpu_parts['total']:.2f} s "
              f"(compute_pck_batch {cpu_parts['device']:.2f}); keypoints "
              f"whose correctness differs from the CPU's: {tied}")
    print(f"{tag} C score: {n_tied} keypoints differ between card and CPU in "
          f"all, each on a near-tie (largest top-two gap {worst_gap:.3g}, "
          f"bound {C_NEAR_TIE}); second extraction of {len(stash)} images "
          f"bit-equal; leg launches {launches}; leg peak memory allocated "
          f"{peak_gb:.2f} GB")
    return results, launches


def _check_pinned_fp32(tag: str, C, feature_dir: str, spair_dir: str,
                       dev) -> None:
    """`similarity` computes in true fp32 with TF32 switched on for the
    process, and leaves the switch as it found it."""
    import torch
    from law_of_vision_representation_in_mllms_torch.metrics import spair
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        c_score_run)
    pairs = spair.load_spair_data(spair_dir, spair.SPAIR_CATEGORIES[0])
    feats = torch.from_numpy(c_score_run._load_features(
        pairs.files, feature_dir, "")).to(dev)
    d1 = C.normalize_feats(feats[0::2])
    d2 = C.normalize_feats(feats[1::2])
    prev = torch.backends.cuda.matmul.allow_tf32
    ieee = torch.matmul(d1, d2.transpose(-1, -2))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pinned = C.similarity(d1, d2)
        kept = torch.backends.cuda.matmul.allow_tf32
        tf32 = torch.matmul(d1, d2.transpose(-1, -2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if prev or not kept or not torch.equal(pinned, ieee):
        fail("similarity is not true fp32 under a process-wide TF32 switch, "
             "or did not restore the switch")
    moved = (tf32.argmax(-1) != ieee.argmax(-1)).sum().item()
    print(f"{tag} C score: similarity under allow_tf32=True gives the fp32 "
          f"bits; a TF32 product of the same {tuple(d1.shape)} descriptors "
          f"errs by {(tf32 - ieee).abs().max().item():.2e} and moves "
          f"{moved} of {ieee.shape[0] * ieee.shape[1]} window centres")


SD15 = "runwayml/stable-diffusion-v1-5"
# phases 13 and 11: checkpoints in the layout of the published snapshots,
# written by this script (the card's machine has no `safetensors` package)
SAFETENSORS_DTYPES = {"torch.float16": "F16", "torch.float32": "F32",
                      "torch.bfloat16": "BF16"}
PORT_SEED = 31
# phase 13's snapshots: openai/clip-vit-large-patch14-336's vision tower
# and SD1.5's text encoder (openai/clip-vit-large-patch14's CLIP-L text
# tower), at their published widths and depths
PORT_VISION = dict(hidden=1024, inter=4096, layers=24, heads=16, patch=14,
                   size=336)
PORT_TEXT = dict(hidden=768, inter=3072, layers=12, heads=12, vocab=49408,
                 positions=77)
# phase 13 and phase 11's prompt: the card in bf16 compute (fp32 weights and
# LayerNorm statistics) against the CPU in fp32 on the same ported weights,
# as ||card - CPU|| / ||CPU|| over the whole output and over its worst
# token. Every activation is rounded to bf16 (2^-9 relative on average)
# about ten times a block; independent roundings add in quadrature, so the
# 23 blocks of the CLIP-L/14-336 tower give sqrt(230) x 2^-9 = 3 % and the
# 12 of the CLIP-L text encoder 2 %
PORT_REL_TOL = 5e-2


def write_safetensors(path: str, tensors: dict) -> int:
    """`tensors` (name -> CPU tensor, fp16 / fp32 / bf16) as one
    .safetensors file: an 8-byte little-endian header length, the JSON
    header (each tensor's dtype, shape and data_offsets, padded with spaces
    to 8 bytes, as the reference writer pads it), then the raw bytes in
    the header's order. Returns the bytes written."""
    import struct

    import torch
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": SAFETENSORS_DTYPES[str(t.dtype)],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


def _write_snapshot(folder: str, config: dict, tensors: dict,
                    name: str = "model.safetensors") -> int:
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    return write_safetensors(os.path.join(folder, name), tensors)


class _Init:
    """Seeded fp16 weights for a snapshot, drawn on the card: a Linear /
    conv weight N(0, 1 / fan_in), biases and embeddings N(0, 0.02), norms
    1 + N(0, 0.02)."""

    def __init__(self, dev, seed: int):
        import torch
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.sd = {}

    def rand(self, name: str, shape, std: float, mean: float = 0.0):
        import torch
        x = torch.randn(shape, generator=self.gen, device=self.gen.device)
        self.sd[name] = (x * std + mean).half().cpu()

    def linear(self, prefix: str, dout: int, din: int) -> None:
        self.rand(prefix + ".weight", (dout, din), din ** -0.5)
        self.rand(prefix + ".bias", (dout,), 0.02)

    def norm(self, prefix: str, dim: int) -> None:
        self.rand(prefix + ".weight", (dim,), 0.02, 1.0)
        self.rand(prefix + ".bias", (dim,), 0.02)

    def clip_layers(self, prefix: str, n: int, d: int, inter: int) -> None:
        for i in range(n):
            lp = f"{prefix}.layers.{i}"
            self.norm(f"{lp}.layer_norm1", d)
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                self.linear(f"{lp}.self_attn.{proj}", d, d)
            self.norm(f"{lp}.layer_norm2", d)
            self.linear(f"{lp}.mlp.fc1", inter, d)
            self.linear(f"{lp}.mlp.fc2", d, inter)


def clip_vision_snapshot(folder: str, dev, seed: int) -> dict:
    """openai/clip-vit-large-patch14-336's vision tower as a
    CLIPVisionModel snapshot (its config.json and key names, `PORT_VISION`:
    24 layers of 1,024, patch 14 at 336 px), seeded fp16 weights. Returns
    the tensors."""
    v = PORT_VISION
    d, inter, layers, p, size = (v["hidden"], v["inter"], v["layers"],
                                 v["patch"], v["size"])
    w, pre = _Init(dev, seed), "vision_model"
    w.rand(f"{pre}.embeddings.class_embedding", (d,), 0.02)
    w.rand(f"{pre}.embeddings.patch_embedding.weight", (d, 3, p, p),
           (3 * p * p) ** -0.5)
    w.rand(f"{pre}.embeddings.position_embedding.weight",
           ((size // p) ** 2 + 1, d), 0.02)
    w.norm(f"{pre}.pre_layrnorm", d)
    w.clip_layers(f"{pre}.encoder", layers, d, inter)
    w.norm(f"{pre}.post_layernorm", d)
    _write_snapshot(folder, {
        "architectures": ["CLIPVisionModel"],
        "model_type": "clip_vision_model", "hidden_size": d,
        "intermediate_size": inter, "num_hidden_layers": layers,
        "num_attention_heads": v["heads"], "num_channels": 3,
        "image_size": size,
        "patch_size": p, "hidden_act": "quick_gelu",
        "layer_norm_eps": 1e-05, "projection_dim": 768,
        "torch_dtype": "float16"}, w.sd)
    return w.sd


def clip_text_snapshot(folder: str, dev, seed: int) -> dict:
    """SD1.5's text encoder (openai/clip-vit-large-patch14's text tower)
    as a CLIPTextModel snapshot: its config.json (the legacy eos_token_id
    2 included) and key names, `PORT_TEXT`: 12 layers of 768, 77
    positions, seeded fp16 weights. Returns the tensors."""
    t = PORT_TEXT
    d, inter, layers = t["hidden"], t["inter"], t["layers"]
    w, pre = _Init(dev, seed), "text_model"
    w.rand(f"{pre}.embeddings.token_embedding.weight", (t["vocab"], d), 0.02)
    w.rand(f"{pre}.embeddings.position_embedding.weight",
           (t["positions"], d), 0.01)
    w.clip_layers(f"{pre}.encoder", layers, d, inter)
    w.norm(f"{pre}.final_layer_norm", d)
    _write_snapshot(folder, {
        "architectures": ["CLIPTextModel"], "model_type": "clip_text_model",
        "vocab_size": t["vocab"], "hidden_size": d,
        "intermediate_size": inter, "num_hidden_layers": layers,
        "num_attention_heads": t["heads"],
        "max_position_embeddings": t["positions"], "hidden_act": "quick_gelu",
        "layer_norm_eps": 1e-05, "bos_token_id": 0, "eos_token_id": 2,
        "pad_token_id": 1, "projection_dim": 768,
        "torch_dtype": "float16"}, w.sd)
    return w.sd


def flat_tree(tree) -> dict:
    """A nested tree of arrays as {"a/b/c": array}, keyed as the port's
    `.npz` files are (`io.param_io`; the CPU tests use this one too)."""
    from law_of_vision_representation_in_mllms_torch.io.param_io import (
        _flatten)
    out = {}
    _flatten(tree, "", out)
    return out


def _f32(snap: dict, key: str):
    return snap[key].float().numpy()


def _ln_leaf(snap: dict, p: str) -> dict:
    return {"ln": {"scale": _f32(snap, p + ".weight"),
                   "bias": _f32(snap, p + ".bias")}}


def _clip_blocks(snap: dict, prefix: str, n_blocks: int) -> dict:
    """The JAX-layout trees of `n_blocks` CLIP layers under `prefix`, as
    the documented layout gives them from the snapshot's tensors in fp32:
    a Linear's kernel is its weight transposed, a LayerNorm's scale its
    weight."""
    def lin(p):
        return {"kernel": _f32(snap, p + ".weight").T,
                "bias": _f32(snap, p + ".bias")}
    tree = {}
    for i in range(n_blocks):
        lp = f"{prefix}.layers.{i}"
        tree[f"block_{i}"] = {
            "ln1": _ln_leaf(snap, f"{lp}.layer_norm1"),
            "q": lin(f"{lp}.self_attn.q_proj"),
            "k": lin(f"{lp}.self_attn.k_proj"),
            "v": lin(f"{lp}.self_attn.v_proj"),
            "o": lin(f"{lp}.self_attn.out_proj"),
            "ln2": _ln_leaf(snap, f"{lp}.layer_norm2"),
            "fc1": lin(f"{lp}.mlp.fc1"), "fc2": lin(f"{lp}.mlp.fc2")}
    return tree


def expected_vision_tree(snap: dict, n_blocks: int) -> dict:
    """The ViTEncoder tree `port_cli clip_vision` must write: the patch
    kernel the conv weight `transpose(2, 3, 1, 0)`, the class token
    reshaped to [1, 1, D], the position table given a leading axis."""
    emb = "vision_model.embeddings"
    return {
        **_clip_blocks(snap, "vision_model.encoder", n_blocks),
        "patch_kernel": _f32(snap, f"{emb}.patch_embedding.weight"
                             ).transpose(2, 3, 1, 0),
        "cls_token": _f32(snap, f"{emb}.class_embedding").reshape(1, 1, -1),
        "pos_embed": _f32(snap, f"{emb}.position_embedding.weight")[None],
        "pre_ln": _ln_leaf(snap, "vision_model.pre_layrnorm")}


def expected_text_tree(snap: dict, n_blocks: int) -> dict:
    """The CLIPTextEncoder tree `port_cli clip_text` must write."""
    emb = "text_model.embeddings"
    return {
        **_clip_blocks(snap, "text_model.encoder", n_blocks),
        "token_embedding": _f32(snap, f"{emb}.token_embedding.weight"),
        "pos_embed": _f32(snap, f"{emb}.position_embedding.weight")[None],
        "final_ln": _ln_leaf(snap, "text_model.final_layer_norm")}


def check_exact(what: str, got: dict, want: dict) -> int:
    """Every leaf of `got` equals `want`'s bit for bit, with the same keys,
    shapes and fp32 dtype. Returns the count of values compared."""
    import numpy as np
    got, want = flat_tree(got), flat_tree(want)
    if sorted(got) != sorted(want):
        fail(f"{what}: ported keys {sorted(set(got) ^ set(want))[:6]} differ "
             f"from the snapshot's")
    n = 0
    for k, w in want.items():
        g = got[k]
        if g.dtype != np.float32 or g.shape != w.shape or \
                not np.array_equal(g, w):
            fail(f"{what}: {k} is not the snapshot's tensor in the "
                 f"documented layout ({g.dtype} {g.shape} vs {w.shape})")
        n += w.size
    return n


def rel_errors(got, ref) -> tuple:
    """(||got - ref|| / ||ref||, the same over the worst token (the last
    axis), max|got - ref|) of a card output against its CPU fp32 run."""
    import torch
    diff = got.float().cpu() - ref.float()
    rows = diff.norm(dim=-1) / ref.float().norm(dim=-1).clamp_min(
        torch.finfo(torch.float32).tiny)
    return ((diff.norm() / ref.float().norm()).item(), rows.max().item(),
            diff.abs().max().item())


@contextlib.contextmanager
def kernel2_calls(module):
    """Records (q's shape, causal) of every `module.flash_attention` call
    in the block."""
    orig, calls = module.flash_attention, []

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), bool(kw.get("causal", False))))
        return orig(q, k, v, **kw)
    module.flash_attention = spy
    try:
        yield calls
    finally:
        module.flash_attention = orig


def run_port_cli(tag: str, jobs: dict) -> float:
    """`python -m <port>.io.port_cli KIND SRC OUT [flags]` for every job
    (name -> argv), all started at once; each must end 0 and say what it
    wrote. Returns the seconds until the last ended."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.io.port_cli", *argv], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, argv in jobs.items()}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            fail(f"port_cli {name} did not end in 900 s")
        kind, src, dst = jobs[name][:3]
        if proc.returncode != 0 or out.strip() != (
                f"ported {kind} from {src} -> {dst}"):
            fail(f"port_cli {name}: rc {proc.returncode}, said {out!r}, "
                 f"{err[-2000:]}")
    seconds = time.perf_counter() - t0
    print(f"{tag} phase 13 port_cli {', '.join(jobs)} (one process each, "
          f"started together) took {seconds:.1f} s")
    return seconds


def run_checkpoint_porting(tag: str, dev, counters, text_cases: list
                           ) -> dict:
    """Phase 13: a full-width CLIP-L/14-336 vision snapshot and SD1.5's
    CLIP-L text encoder snapshot (config.json and fp16 .safetensors in the
    published layouts, seeded) through `python -m <port>.io.port_cli`
    (`clip_vision --image-size 336`, `clip_text` and `clip_text
    --penultimate`, three processes); every ported tensor against the
    snapshot's in the documented layout, exactly; the ported tower loaded
    as `model.tower_weights` loads a file, on the card (kernel 1, B = 4)
    against the CPU fp32 tower; the text encoder on the card (kernel 2's
    causal form, one launch a block at B 1, S 77, H 12, D 64) against the
    CPU, on the empty prompt's ids, whole and penultimate. Returns the
    launches of each path, counted from 0."""
    import shutil

    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.io import (
        featurizer_bundle as FB, from_jax)
    from law_of_vision_representation_in_mllms_torch.io.param_io import (
        load_params)
    from law_of_vision_representation_in_mllms_torch.models import (
        text_encoder as TE, vit)

    paths = {}
    tmp = tempfile.mkdtemp(prefix="lvr_port_")
    try:
        t0 = time.perf_counter()
        vis_dir, text_dir = (os.path.join(tmp, n) for n in ("clip336",
                                                             "clip_l_text"))
        vis = clip_vision_snapshot(vis_dir, dev, PORT_SEED)
        text = clip_text_snapshot(text_dir, dev, PORT_SEED + 1)
        size = sum(os.path.getsize(os.path.join(d, f)) for d in
                   (vis_dir, text_dir) for f in os.listdir(d))
        print(f"{tag} phase 13 snapshots (CLIP-L/14-336 vision, "
              f"{sum(t.numel() for t in vis.values()) / 1e6:.1f} M; CLIP-L "
              f"text, {sum(t.numel() for t in text.values()) / 1e6:.1f} M; "
              f"fp16 .safetensors, {size / 1e9:.2f} GB) written in "
              f"{time.perf_counter() - t0:.2f} s")
        outs = {n: os.path.join(tmp, n + ".npz") for n in
                ("vision", "text", "text_penultimate")}
        run_port_cli(tag, {
            "vision": ["clip_vision", vis_dir, outs["vision"],
                       "--image-size", "336"],
            "text": ["clip_text", text_dir, outs["text"]],
            "text_penultimate": ["clip_text", text_dir,
                                 outs["text_penultimate"], "--penultimate"]})

        # every ported tensor is the snapshot's, in the documented layout
        v, n_text = PORT_VISION, PORT_TEXT["layers"]
        cfg = dataclasses.replace(
            vit.clip_l14(v["size"]), hidden_size=v["hidden"],
            intermediate_size=v["inter"], num_layers=v["layers"],
            num_heads=v["heads"], patch_size=v["patch"])
        n_vis = cfg.resolve_layer(-2)
        trees = {n: load_params(p) for n, p in outs.items()}
        counted = (check_exact("clip_vision", trees["vision"],
                               expected_vision_tree(vis, n_vis))
                   + check_exact("clip_text", trees["text"],
                                 expected_text_tree(text, n_text))
                   + check_exact("clip_text --penultimate",
                                 trees["text_penultimate"],
                                 expected_text_tree(text, n_text - 1)))
        print(f"{tag} phase 13 ported trees: {counted / 1e6:.1f} M values "
              f"equal the snapshots' bit for bit (fp16 -> fp32; Linear "
              f"kernel = weight.T, patch kernel = weight.transpose(2, 3, 1, "
              f"0)); vision {n_vis} of {v['layers']} blocks (select_layer "
              f"-2), text {n_text} and {n_text - 1}")

        # the tower, loaded as model.tower_weights loads a file
        sd = from_jax.vit_state_dict(trees.pop("vision"))
        card = vit.ViTTower(cfg, select_layer=-2, precision=DEFAULT_PRECISION,
                            device=dev)
        card.load_state_dict(sd)
        cpu = vit.ViTTower(cfg, select_layer=-2, precision=FP32_PRECISION)
        cpu.load_state_dict(sd)
        del sd
        rng = np.random.RandomState(PORT_SEED)
        px = torch.from_numpy(np.stack([_sd_image(rng, cfg.image_size)
                                        for _ in range(4)]))
        with torch.no_grad():
            card(px.to(dev))
            got, launches = counted_run(counters, lambda: card(px.to(dev)))
            paths["port_clip_vision"] = launches
            want = {"encoder_attention": n_vis}
            if any(launches[k] != want.get(k, 0) for k in launches):
                fail(f"ported tower launches {launches}, not {want}")
            t1 = time.perf_counter()
            ref = cpu(px)
            cpu_s = time.perf_counter() - t1
        if got.shape != (4, cfg.num_patches, cfg.hidden_size) or \
                not torch.isfinite(got).all():
            fail(f"ported tower on the card: {tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        rel, worst, abs_err = rel_errors(got, ref)
        print(f"{tag} phase 13 ported CLIP-L/14-336 tower, B=4 "
              f"{cfg.image_size} px, "
              f"{n_vis} blocks: card bf16 (kernel 1) vs CPU fp32 "
              f"||diff|| / ||CPU|| {rel:.3e}, worst token {worst:.3e} (tol "
              f"{PORT_REL_TOL} each), max|diff| {abs_err:.3e} of max|CPU| "
              f"{ref.abs().max().item():.3e}; launches {launches}; CPU "
              f"{cpu_s:.2f} s")
        if not (rel <= PORT_REL_TOL and worst <= PORT_REL_TOL):
            fail(f"ported tower: card against CPU {rel}, worst token "
                 f"{worst} > {PORT_REL_TOL}")
        del card, cpu, got, ref
        torch.cuda.empty_cache()

        # the text encoder, whole (with the pooled output) and penultimate
        with open(os.path.join(text_dir, "config.json")) as f:
            tcfg = TE.text_config_from_hf(json.load(f), text)
        ids = torch.from_numpy(FB._empty_prompt_ids()).long()
        key = text_key(1, 77, tcfg.num_heads, tcfg.hidden_size //
                       tcfg.num_heads)
        if key not in {c["attn"] for c in text_cases}:
            fail(f"phase 2 did not hold kernel 2 at the text encoder's "
                 f"{key}")
        for name, n in (("text", None), ("text_penultimate", n_text - 1)):
            tree = trees.pop(name)
            sd = from_jax.text_encoder_state_dict(tree)
            n_tree = sum(k.startswith("block_") for k in tree)
            encs = [TE.CLIPTextEncoder(tcfg, prec, num_blocks=n_tree,
                                       device=d)
                    for prec, d in ((DEFAULT_PRECISION, dev),
                                    (FP32_PRECISION, None))]
            for enc in encs:
                enc.load_state_dict(sd)
            pooled = n is None
            with torch.no_grad():
                with kernel2_calls(vit) as calls:
                    (h, p), launches = counted_run(counters, lambda: encs[0](
                        ids.to(dev), num_blocks=n, want_pooled=pooled))
                h_ref, p_ref = encs[1](ids, num_blocks=n, want_pooled=pooled)
            blocks = n or tcfg.num_layers
            paths[f"port_clip_{name}"] = launches
            shape = (1, 77, tcfg.num_heads,
                     tcfg.hidden_size // tcfg.num_heads)
            if launches["flash_attention"] != blocks or any(
                    v for k, v in launches.items()
                    if k != "flash_attention") or \
                    calls != [(shape, True)] * blocks:
                fail(f"ported text encoder ({name}): launches {launches}, "
                     f"kernel-2 calls {calls[:3]}, not {blocks} causal at "
                     f"{shape}")
            for c in text_cases:
                if c["attn"] == key:
                    c.setdefault("launches_phase13", 0)
                    c["launches_phase13"] += blocks
            errs = [("hidden", *rel_errors(h, h_ref))]
            if pooled:
                errs.append(("pooled", *rel_errors(p[:, None], p_ref[:, None])))
            if not torch.isfinite(h).all() or \
                    h.shape != (1, 77, tcfg.hidden_size):
                fail(f"ported text encoder ({name}): {tuple(h.shape)} not "
                     f"finite (1, 77, {tcfg.hidden_size})")
            print(f"{tag} phase 13 ported CLIP-L text encoder "
                  f"({'whole, pooled at the eos' if pooled else 'penultimate'}"
                  f", {blocks} blocks) on the empty prompt: card bf16 "
                  f"(kernel 2 causal, {blocks} launches at {key}) vs CPU "
                  f"fp32 " + "; ".join(
                      f"{what} ||diff|| / ||CPU|| {r:.3e}, worst token "
                      f"{w:.3e}, max|diff| {a:.3e}" for what, r, w, a in errs)
                  + f" (tol {PORT_REL_TOL})")
            for what, r, w, _ in errs:
                if not (r <= PORT_REL_TOL and w <= PORT_REL_TOL):
                    fail(f"ported text encoder ({name}) {what}: card against "
                         f"CPU {r}, worst token {w} > {PORT_REL_TOL}")
            del encs, sd, tree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


SD_SEED = 21
# phase 11 (a): SD1.5's up-block-0 tokens from the card in bf16 against the
# CPU in fp32, on the same weights and image, as ||card - CPU|| / ||CPU||.
# Every activation is rounded to bf16 (2^-9 relative on average) some 250
# times on the way through the VAE encoder (27 convolutions and norms at up
# to 768 x 768) and the UNet (26 residual blocks, 7 transformer blocks);
# independent roundings add in quadrature, sqrt(250) x 2^-9 = 3 %, and the
# random weights' residual sums keep most of them
SD_FEATURE_REL_TOL = 5e-2


def _sd_image(rng, size: int):
    """A smooth random image in [-1, 1] (a 32 x 32 colour grid, bilinear)."""
    import numpy as np
    from PIL import Image
    coarse = rng.randint(0, 256, (32, 32, 3), dtype=np.uint8)
    img = Image.fromarray(coarse).resize((size, size),
                                         Image.Resampling.BILINEAR)
    return np.asarray(img, np.float32) / 127.5 - 1.0


def snapshot_bytes(root: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(root) for f in files)


class _Probe(dict):
    """A state dict that holds every key and answers the i-th read with a
    [1, 1, 1, 1] tensor of value i: run through a porter, it ties each leaf
    of the porter's tree to the key the porter read for it."""

    def __init__(self):
        super().__init__()
        self.reads = []

    def __contains__(self, key):
        return True

    def __getitem__(self, key):
        import torch
        self.reads.append(key)
        return torch.full((1, 1, 1, 1), float(len(self.reads) - 1))


def diffusers_snapshot(porter, tree: dict, half: bool = True) -> tuple:
    """(state dict, {tree path: key}): the diffusers-keyed state dict (fp16,
    or fp32 with `half=False`) from which `porter(sd)` gives `tree` (fp32
    numpy, the JAX layout), a `kernel` of rank 2 transposed back to
    [out, in], of rank 4 to [O, I, kh, kw]; the keys are those the porter
    reads, a bias or shortcut only where `tree` has it. The key names are
    thus the porter's own: phase 11 passes the port's porters, so its
    check of the bundle covers the layout and the cast, not the names,
    which the CPU tests hold to the JAX porters by passing those here."""
    import numpy as np
    import torch
    probe = _Probe()
    where = {path: probe.reads[int(leaf.reshape(-1)[0])]
             for path, leaf in flat_tree(porter(probe)).items()}
    sd, used = {}, {}
    for path, leaf in flat_tree(tree).items():
        if path.endswith("kernel"):
            leaf = leaf.T if leaf.ndim == 2 else leaf.transpose(3, 2, 0, 1)
        t = torch.from_numpy(np.ascontiguousarray(leaf))
        sd[where[path]] = t.half() if half else t
        used[path] = where[path]
    return sd, used


def sd15_snapshot(root: str, tree: dict, cfg, dev) -> dict:
    """A full-width SD1.5 diffusers snapshot root of the bundle tree `tree`
    in fp16: `unet/` and `vae/` (`diffusion_pytorch_model.safetensors` with
    diffusers' key names, as the port's porters read them) and
    `text_encoder/` (`clip_text_snapshot`). Returns {"backbone" | "vae":
    (state dict, {tree path: key})} for the check of the bundle."""
    from law_of_vision_representation_in_mllms_torch.io import (
        diffusers_port as DP)
    out = {"backbone": diffusers_snapshot(lambda s: DP.port_unet(
        s, cfg.unet, (cfg.up_ft_index,)), tree["backbone"]),
        "vae": diffusers_snapshot(lambda s: DP.port_vae_encoder(
            s, cfg.vae), tree["vae"])}
    for part, folder, cls in (("backbone", "unet", "UNet2DConditionModel"),
                              ("vae", "vae", "AutoencoderKL")):
        _write_snapshot(os.path.join(root, folder), {"_class_name": cls},
                        out[part][0], "diffusion_pytorch_model.safetensors")
    clip_text_snapshot(os.path.join(root, "text_encoder"), dev, SD_SEED + 1)
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": "StableDiffusionPipeline"}, f)
    return out


def port_sd15_bundle(tag: str, dev, counters, root: str, snap: dict,
                     bundle: str, text_cases: list) -> dict:
    """Phase 11's bundle: `cli.main(["port-featurizer", "sd15", root,
    bundle, "--device", dev])`, counted (the prompt's 12 kernel-2 causal
    launches at B 1, S 77, H 12, D 64); the bundle's UNet and VAE against
    the snapshot's tensors (exact: fp16 -> fp32, a Linear's kernel the
    weight transposed, a conv's the weight `transpose(2, 3, 1, 0)`; the
    layout and the cast only, as the snapshot's keys are the port's
    porters' own, `diffusers_snapshot`); its
    `prompt_embeds` against a CPU fp32 encode of the same snapshot
    (`PORT_REL_TOL`, whole and worst token). Returns the launches."""
    import contextlib
    import io

    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch import cli
    from law_of_vision_representation_in_mllms_torch.io import (
        featurizer_bundle as FB)
    from law_of_vision_representation_in_mllms_torch.models import vit

    argv = ["port-featurizer", "sd15", root, bundle, "--device", str(dev)]
    t0 = time.perf_counter()
    with kernel2_calls(vit) as calls, \
            contextlib.redirect_stdout(io.StringIO()) as said:
        rc, launches = counted_run(counters, lambda: cli.main(argv))
    port_s = time.perf_counter() - t0
    if rc != 0 or said.getvalue().strip() != f"ported sd15 bundle -> {bundle}":
        fail(f"port-featurizer sd15: rc {rc}, said {said.getvalue()!r}")
    t = PORT_TEXT
    blocks, shape = t["layers"], (1, 77, t["heads"], t["hidden"] // t["heads"])
    key = text_key(*shape)
    if launches["flash_attention"] != blocks or any(
            v for k, v in launches.items() if k != "flash_attention") or \
            calls != [(shape, True)] * blocks:
        fail(f"port-featurizer sd15: launches {launches}, kernel-2 calls "
             f"{calls[:3]}, not {blocks} causal at {key}")
    for c in text_cases:
        if c["attn"] == key:
            c["launches_phase11"] = blocks
    tree, _ = FB.load_featurizer_bundle(bundle)
    n = 0
    for part, (sd, where) in snap.items():
        got = flat_tree(tree[part])
        if sorted(got) != sorted(where):
            fail(f"port-featurizer sd15: the bundle's {part} keys differ "
                 f"from the snapshot's: {sorted(set(got) ^ set(where))[:6]}")
        for path, k in where.items():
            want = sd[k].float().numpy()
            if path.endswith("kernel"):
                want = want.T if want.ndim == 2 else want.transpose(2, 3, 1, 0)
            if got[path].dtype != np.float32 or \
                    not np.array_equal(got[path], want):
                fail(f"port-featurizer sd15: {part}/{path} is not the "
                     f"snapshot's {k}")
            n += want.size
    t1 = time.perf_counter()
    ref, _ = FB._encode_prompt(os.path.join(root, "text_encoder"),
                               FB._empty_prompt_ids(), penultimate=False)
    cpu_s = time.perf_counter() - t1
    got = torch.from_numpy(tree["prompt_embeds"])
    if got.shape != (1, 77, t["hidden"]) or not torch.isfinite(got).all():
        fail(f"port-featurizer sd15: prompt_embeds {tuple(got.shape)} are "
             f"not finite (1, 77, {t['hidden']})")
    rel, worst, abs_err = rel_errors(got, torch.from_numpy(ref))
    print(f"{tag} phase 11 port-featurizer sd15 on the card: "
          f"{port_s:.1f} s, bundle {os.path.getsize(bundle) / 1e9:.2f} GB; "
          f"UNet + VAE {n / 1e6:.1f} M values equal the snapshot's bit for "
          f"bit (fp16 -> fp32, the documented layout: this holds the "
          f"layout and the cast; the key names are the port's porters' own, "
          f"held to the JAX porters by the CPU tests); prompt_embeds (card "
          f"bf16, kernel 2 causal, {blocks} launches at {key}) vs a CPU fp32 "
          f"encode ({cpu_s:.2f} s): ||diff|| / ||CPU|| {rel:.3e}, worst "
          f"token {worst:.3e} (tol {PORT_REL_TOL} each), max|diff| "
          f"{abs_err:.3e} of max|CPU| {np.abs(ref).max():.3e}; launches "
          f"{launches}")
    if not (rel <= PORT_REL_TOL and worst <= PORT_REL_TOL):
        fail(f"port-featurizer sd15: prompt_embeds card against CPU {rel}, "
             f"worst token {worst} > {PORT_REL_TOL}")
    return launches


def run_diffusion_tower(tag: str, dev, counters, unet_cases: list,
                        c_scores: dict, text_cases: list) -> dict:
    """Phase 11: the SD1.5 representation at full width (VAE encoder
    (128, 256, 512, 512), UNet (320, 640, 1280, 1280) with 8 heads, up block
    0 harvested: 576 tokens of 1280 at 768 px) on seeded random weights,
    written as a diffusers snapshot (fp16, with a CLIP-L text encoder) in a
    temporary directory, made into a bundle by `port-featurizer` on the
    card (`port_sd15_bundle`) and read back through `model.tower_weights`,
    as a user's ported bundle is:
    (a) `extract_features` on one image, card bf16 against CPU fp32, 14
        kernel-2 launches a forward, a repeat's bits;
    (b) `extract-features` over a synthetic SPair tree (phase 6's
        generator) at batch 16, then `run_c_score` on the card;
    (c) LLaVA-1.5-7B (`mlp2x_gelu` 1280 -> 4096, Vicuna-7B) through
        `build_lmm` -> `generate_until` on phase 4's four requests with
        768 px images, 32 new tokens: finite logits, kernel 2 (tower and
        prefill) and kernel 3 launched, TTFT and tokens/s.
    Every tower attention of (a)-(c) is recorded by its shape, which must be
    one that phase 2 held to its plain version (`unet_cases`); each SD1.5
    case gets the launches of its shape counted in (a)'s forward. Puts
    the C score (PCK@0.10 per image) into `c_scores["SD1.5"]` for phase
    6's fit. Returns the launches of each path, counted from 0."""
    import collections
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch import cli
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    from law_of_vision_representation_in_mllms_torch.io import (
        featurizer_bundle as FB, from_jax)
    from law_of_vision_representation_in_mllms_torch.models import (
        diffusion_blocks as DB, featurizer as F, llava as M,
        tower_runtime as TR)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        features as pfeat, runner as prunner)

    def attn_shape(args, out):      # the card's launches; None on the CPU
        (b, sq, h, d), skv = args[0].shape, args[1].shape[1]
        return (b, sq, skv, h, d) if args[0].is_cuda else None

    paths = {}
    tmp = tempfile.mkdtemp(prefix="lvr_sd15_")
    seen = _Spy(DB, "flash_attention", keep=attn_shape).__enter__()
    try:
        # the bundle: a diffusers snapshot of seeded random weights, then
        # `port-featurizer` on the card ---------------------------------
        cfg = F.FEATURIZER_PRESETS[SD15]()
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(SD_SEED)
        own = F.FeaturizerParams(cfg, FP32_PRECISION, device=dev)
        init_weights(own, gen)
        n_params = sum(p.numel() for p in own.parameters())
        tree = from_jax.featurizer_tree(own.state_dict())
        del own
        torch.cuda.empty_cache()
        root = os.path.join(tmp, "sd15_snapshot")
        snap = sd15_snapshot(root, tree, cfg, dev)
        del tree
        print(f"{tag} phase 11 SD1.5 diffusers snapshot ({n_params / 1e6:.1f}"
              f" M params: VAE encoder + UNet through up block 0, seeded "
              f"random; and the CLIP-L text encoder; fp16 .safetensors, "
              f"{snapshot_bytes(root) / 1e9:.2f} GB) written in "
              f"{time.perf_counter() - t0:.2f} s")
        bundle = os.path.join(tmp, "sd15.npz")
        paths["sd15_port"] = port_sd15_bundle(tag, dev, counters, root, snap,
                                              bundle, text_cases)
        del snap

        # (a) one image, card bf16 against CPU fp32 ----------------------
        tree, bcfg = FB.load_featurizer_bundle(bundle)
        sd = from_jax.featurizer_state_dict(tree)
        del tree
        card = F.FeaturizerParams.for_state_dict(sd, bcfg, BF16_PRECISION,
                                                 device=dev)
        cpu = F.FeaturizerParams.for_state_dict(sd, bcfg, FP32_PRECISION)
        del sd
        px = torch.from_numpy(_sd_image(np.random.RandomState(SD_SEED),
                                        cfg.img_size))[None]
        F.extract_features(card, bcfg, px.to(dev), deterministic=True)
        torch.cuda.synchronize(dev)
        with _Spy(DB, "flash_attention", keep=attn_shape) as one:
            got, launches = counted_run(counters, lambda: F.extract_features(
                card, bcfg, px.to(dev), deterministic=True))
        paths["sd15_features"] = launches
        want_launches = {"flash_attention": SD15_KERNEL2_LAUNCHES}
        if any(launches[k] != want_launches.get(k, 0) for k in launches):
            fail(f"SD1.5 forward launches {launches}, not {want_launches}")
        by_shape = collections.Counter(attn_key(*k[1:]) for k in one.kept)
        sd15 = {c["attn"] for c in unet_cases if c["what"][:5] == "SD1.5"}
        if sum(by_shape.values()) != SD15_KERNEL2_LAUNCHES or \
                not set(by_shape) <= sd15:
            fail(f"SD1.5 forward: tower attentions {dict(by_shape)}, not "
                 f"{SD15_KERNEL2_LAUNCHES} at phase 2's shapes")
        for c in unet_cases:
            if c["what"][:5] == "SD1.5":
                c["launches_per_sd15_forward"] = by_shape[c["attn"]]
        print(f"{tag} phase 11 (a) kernel-2 launches of one SD1.5 forward "
              f"by shape (counted): {dict(by_shape)}")
        again = F.extract_features(card, bcfg, px.to(dev), deterministic=True)
        if not torch.equal(got, again):
            fail("SD1.5 features: a repeat on the card gave other bits")
        t0 = time.perf_counter()
        ref = F.extract_features(cpu, bcfg, px, deterministic=True)
        cpu_s = time.perf_counter() - t0
        del cpu
        grid, dim = F.feature_grid(bcfg), F.feature_dim(bcfg)
        if got.shape != (1, grid * grid, dim) or ref.shape != got.shape:
            fail(f"SD1.5 features {tuple(got.shape)}, CPU "
                 f"{tuple(ref.shape)}, not (1, {grid * grid}, {dim})")
        if not torch.isfinite(got).all():
            fail("SD1.5 features on the card are not finite")
        diff = got.float().cpu() - ref
        rel = (diff.norm() / ref.norm()).item()
        rel_max = (diff.abs().max() / ref.abs().max()).item()
        cos = torch.nn.functional.cosine_similarity(
            got.float().cpu()[0], ref[0], dim=-1)
        card_ms = cuda_ms(lambda: F.extract_features(
            card, bcfg, px.to(dev), deterministic=True), iters=3, warmup=1)
        print(f"{tag} phase 11 (a) SD1.5 extract_features, one 768 px image: "
              f"{tuple(got.shape)} tokens; card bf16 vs CPU fp32 "
              f"||diff|| / ||CPU|| {rel:.3e} (tol {SD_FEATURE_REL_TOL}), "
              f"max|diff| / max|CPU| {rel_max:.3e}, token cosine min "
              f"{cos.min().item():.5f} mean {cos.mean().item():.5f}; "
              f"max|CPU| {ref.abs().max().item():.3e}; a repeat's bits "
              f"equal; launches {launches}; card {card_ms:.2f} ms, CPU "
              f"{cpu_s:.2f} s")
        if not rel <= SD_FEATURE_REL_TOL:
            fail(f"SD1.5 features: card bf16 against CPU fp32 {rel} > "
                 f"{SD_FEATURE_REL_TOL}")
        for b in (1, 4, C_BATCH):
            xb = px.to(dev).expand(b, -1, -1, -1).contiguous()
            ms = cuda_ms(lambda: F.extract_features(card, bcfg, xb,
                                                    deterministic=True),
                         iters=3, warmup=1)
            print(f"{tag} phase 11 SD1.5 featurizer at B={b}: {ms:.2f} ms a "
                  f"call, {b / ms * 1e3:.2f} images/s (synced, the card "
                  f"alone)")
        del card, got, again, ref, diff
        gc.collect()
        torch.cuda.empty_cache()

        # (b) extract-features over a synthetic SPair tree, run_c_score --
        root = os.path.join(tmp, "SPair-71k")
        n_images = _spair_tree(root, C_IMAGES, C_PAIRS)
        out_dir = os.path.join(tmp, "spair_sd15")
        argv = ["extract-features", "--images",
                os.path.join(root, "JPEGImages"), "--out-dir", out_dir,
                "--batch-size", str(C_BATCH), "--device", str(dev),
                "--set", "model.vision_tower=" + SD15,
                "--set", f"model.tower_weights={bundle}",
                "--set", "model.decoder_layers=2"]
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts(counters)
        t0 = time.perf_counter()
        with _Spy(prunner, "extract_tower_features", dev) as ext, \
                _Spy(pfeat, "preprocess_image") as prep, \
                _Spy(TR, "extract_features", dev) as fwd, \
                contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cli.main(argv)
        total_s = time.perf_counter() - t0
        torch.cuda.synchronize(dev)
        calls = -(-n_images // C_BATCH)
        if rc != 0 or said.getvalue().strip() != (
                f"extracted {n_images} feature files to {out_dir}"):
            fail(f"SD1.5 extract-features: rc {rc}, said "
                 f"{said.getvalue()!r}")
        if [len(ext.seconds), len(fwd.seconds)] != [1, calls]:
            fail(f"SD1.5 extract-features: {len(fwd.seconds)} tower calls, "
                 f"not {calls}")
        files = sorted(f for f in os.listdir(out_dir) if f.endswith(".npy"))
        shape = (grid * grid, dim)
        if len(files) != n_images:
            fail(f"SD1.5: {len(files)} feature files, not {n_images}")
        for f in files[:C_BATCH]:
            x = np.load(os.path.join(out_dir, f))
            if x.shape != shape or not np.isfinite(x).all():
                fail(f"SD1.5: {f} is not a finite fp32 {shape}")
        extract_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        res, parts, _ = _c_score_run(root, out_dir, grid, dev,
                                     lambda args, out: None)
        c_scores["SD1.5"] = res["per_img"][0]
        launches = read_counts(counters)
        paths["sd15_c_score"] = launches
        want = {"flash_attention": SD15_KERNEL2_LAUNCHES * calls}
        if any(launches[k] != want.get(k, 0) for k in launches):
            fail(f"SD1.5 C-score launches {launches}, not {want}")
        for key in ("per_img", "per_kpt", "geo"):
            if not all(0.0 <= v <= 1.0 for v in res[key]):
                fail(f"SD1.5: {key} {res[key]} is not in [0, 1]")
        ext_s = ext.seconds[0]
        print(f"{tag} phase 11 (b) SD1.5 C score ({n_images} images, "
              f"{C_PAIRS * 18} pairs, batch {C_BATCH}): per_img "
              f"PCK@.10/.05/.01 {', '.join(f'{v:.4f}' for v in res['per_img'])}"
              f", per_kpt {res['per_kpt'][0]:.4f}, geo {res['geo'][0]:.4f}; "
              f"extraction {n_images / ext_s:.2f} images/s ({ext_s:.2f} s: "
              f"preprocess_image {sum(prep.seconds):.2f} (host), tower calls "
              f"{sum(fwd.seconds):.2f} (card, synced); the build with a "
              f"2-layer decoder {total_s - ext_s:.2f} s apart); extraction "
              f"peak memory allocated {extract_peak:.2f} GB; run_c_score "
              f"{parts['total']:.2f} s (feature files {parts['features']:.2f}"
              f", compute_pck_batch {parts['device']:.3f}); launches "
              f"{launches}")
        shutil.rmtree(out_dir)
        shutil.rmtree(root)
        gc.collect()
        torch.cuda.empty_cache()

        # (c) LLaVA-1.5-7B over the SD1.5 tower, served -----------------
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        lmm = build_lmm(RunConfig.from_dict({"model": {
            "vision_tower": SD15, "tower_weights": [bundle]}}), device=dev)
        torch.cuda.synchronize(dev)
        print(f"{tag} phase 11 (c) LLaVA-1.5-7B over SD1.5 (576 tokens of "
              f"1280 -> mlp2x_gelu -> 4096) built in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        reqs = _requests(4, lmm.processors[0].crop, diffusion=True)
        graph_dec = lmm.chunked_decoder()
        texts, launches = counted_run(
            counters, lambda: lmm.generate_until(reqs), graph_dec)
        paths["sd15_serve"] = launches
        dec = lmm.cfg.decoder
        if launches["flash_attention"] != SD15_KERNEL2_LAUNCHES + \
                dec.num_layers:
            fail(f"SD1.5 serving: kernel 2 ran {launches['flash_attention']}"
                 f" times, not {SD15_KERNEL2_LAUNCHES} (tower) + "
                 f"{dec.num_layers} (prefill)")
        if launches["decode_attention"] < dec.num_layers or \
                launches["encoder_attention"]:
            fail(f"SD1.5 serving launches {launches}")
        ids, mask, pixels = lmm._encode_batch(reqs)
        pre = M.prefill(lmm.params, lmm.cfg, ids, mask, pixels,
                        max_new_tokens=2)
        if not (torch.isfinite(pre.logits).all()
                and pre.logits.shape == (4, dec.vocab_size)):
            fail("SD1.5 serving: the prefill's logits are not finite [B, V]")
        del pre
        ttft_s = timed_s(lambda: M.prefill(
            lmm.params, lmm.cfg, ids, mask, pixels, max_new_tokens=32), dev)
        gen_s = timed_s(lambda: lmm.generate_until(reqs), dev, reps=2)
        n_tok = 4 * 32
        print(f"{tag} phase 11 (c) SD1.5 serving (B=4, 768 px, S="
              f"{ids.shape[1] + lmm.cfg.num_patches - 1}, 32 new tokens, "
              f"the graph path): TTFT (tower + projector + prefill) "
              f"{ttft_s * 1e3:.2f} ms; generate_until {gen_s * 1e3:.2f} ms, "
              f"{n_tok / (gen_s - ttft_s):.1f} tokens/s after the first "
              f"token ({n_tok / gen_s:.1f} with it); launches {launches}; "
              f"peak memory allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; sample "
              f"answer {texts[0][:60]!r}")
        print(f"{tag} phase 11 (d) SD1.5 as a fourth representation of "
              f"phase 6's law chain: not run (optional); (a)-(c) drive the "
              f"SD1.5 tower through the entry points the law chain calls")
        del lmm, graph_dec
        checked = {(c["batch"], c["attn"]) for c in unet_cases}
        ran = collections.Counter((k[0], attn_key(*k[1:])) for k in seen.kept
                                  if k is not None)
        if not set(ran) <= checked:
            fail(f"phase 11 ran tower attentions that phase 2 did not hold "
                 f"to the plain version: {sorted(set(ran) - checked)}")
        print(f"{tag} phase 11 tower attentions by (B, shape), each held to "
              f"its plain version in phase 2: {dict(sorted(ran.items()))}")
    finally:
        seen.__exit__()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


DIT = "facebook/DiT-XL-2-512"
SD3 = "stabilityai/stable-diffusion-3-medium-diffusers"
# phase 12: the two transformer towers, each a bundle of its own seed
TRANSFORMER_TOWERS = (("DiT", DIT, 22), ("SD3", SD3, 23))
# phase 12 (a): the last block's tokens (2x2-unfolded) from the card in bf16
# against the CPU in fp32, ||card - CPU|| / ||CPU||. The VAE encoder at
# 512 px rounds every activation to bf16 (2^-9 relative on average) some
# 60 times, each block ~10 times (adaLN, q / k / v, P, the attention output,
# the MLP, two residual adds): ~340 roundings for DiT's 28 blocks, ~300 for
# SD3's 24 (its latent stream; the context stream adds its own), a seventh
# or an eighth of the blocks' share at phase 12's depth;
# independent roundings add in quadrature, sqrt(340) x 2^-9 = 3.6 %, the
# bound SD1.5 is held to (`SD_FEATURE_REL_TOL`, 250 roundings)
TRANSFORMER_FEATURE_REL_TOL = 5e-2


def run_transformer_towers(tag: str, dev, counters, cases: list,
                           c_scores: dict) -> dict:
    """Phase 12: DiT-XL/2 (VAE encoder + blocks of 1,152 over 16 heads
    of 72) and SD3-medium (16-channel VAE + joint blocks of 1,536 over 24
    heads of 64, a 192² position table, 333 context tokens) at full width
    and 4 of 28 and 3 of 24 blocks (`TRANSFORMER_BLOCKS`) on seeded
    random weights, each written as a featurizer bundle
    in a temporary directory and read back through `model.tower_weights`:
    (a) `extract_features` on one 512 px image, the last block harvested:
        card bf16 against CPU fp32 (`TRANSFORMER_FEATURE_REL_TOL`), kernel-2
        launches by shape (one a block), a repeat's bits, and the
        featurizer's time at B = 1 and 16 with the VAE and the backbone
        apart;
    (b) `extract-features` over phase 6's synthetic SPair tree at batch 16,
        then `run_c_score` on the card: images/s, peak memory;
    (c) SD3 only: LLaVA-1.5-7B (`mlp2x_gelu` 6,144 -> 4,096, 256 image
        tokens) through `build_lmm` -> `generate_until` on phase 4's
        requests at 512 px, 32 new tokens: finite logits, kernels 2 and 3
        launched, TTFT and tokens/s.
    Every tower attention is recorded by its (B, shape), which must be one
    that phase 2 held to its plain version (`cases`); each of phase 2's
    cases of the tower gets the launches of its shape in (a)'s forward.
    Puts each tower's C score (PCK@0.10 per image) into `c_scores` under
    its name in the AC table ("DiT", "SD3") for phase 6's fit. Returns the
    launches of each path, counted from 0."""
    import collections
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch import cli
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION, FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.io import (
        featurizer_bundle as FB, from_jax)
    from law_of_vision_representation_in_mllms_torch.models import (
        diffusion_blocks as DB, featurizer as F, tower_runtime as TR)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        features as pfeat, runner as prunner)

    def attn_shape(args, out):      # the card's launches; None on the CPU
        (b, sq, h, d), skv = args[0].shape, args[1].shape[1]
        return (b, sq, skv, h, d) if args[0].is_cuda else None

    paths = {}
    tmp = tempfile.mkdtemp(prefix="lvr_dit_sd3_")
    seen = _Spy(DB, "flash_attention", keep=attn_shape).__enter__()
    try:
        root = os.path.join(tmp, "SPair-71k")
        n_images = _spair_tree(root, C_IMAGES, C_PAIRS)
        for label, name, seed in TRANSFORMER_TOWERS:
            key = label.lower()
            per_forward = TRANSFORMER_BLOCKS[label]
            # the bundle: seeded random fp32 weights, built on the card ---
            cfg = F.FEATURIZER_PRESETS[name]()
            part = "dit" if cfg.dit is not None else "mmdit"
            cfg = dataclasses.replace(cfg, **{part: dataclasses.replace(
                getattr(cfg, part), num_layers=per_forward)})
            t0 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(seed)
            own = F.FeaturizerParams(cfg, FP32_PRECISION, device=dev)
            init_weights(own, gen)
            for buf in own.buffers():           # SD3's prompt and pooled
                buf.normal_(generator=gen)
            if label == "SD3":                  # zeros at its Flax init
                own.backbone.pos_embed.data.normal_(0.0, 0.02, generator=gen)
            n_params = sum(p.numel() for p in own.parameters())
            n_backbone = sum(p.numel() for p in own.backbone.parameters())
            bundle = FB.save_featurizer_bundle(os.path.join(tmp, key), own,
                                               cfg)
            del own
            torch.cuda.empty_cache()
            print(f"{tag} phase 12 {label} featurizer ({n_params / 1e6:.1f} "
                  f"M params, {n_backbone / 1e6:.1f} M of them the "
                  f"backbone's, {own_blocks(cfg)} blocks; seeded random) "
                  f"written as a bundle of "
                  f"{os.path.getsize(bundle) / 1e9:.2f} GB in "
                  f"{time.perf_counter() - t0:.2f} s; "
                  f"{shutil.disk_usage(tmp).free / 1e9:.0f} GB left there")

            # (a) one image, card bf16 against CPU fp32 ------------------
            tree, bcfg = FB.load_featurizer_bundle(bundle)
            sd = from_jax.featurizer_state_dict(tree)
            del tree
            card = F.FeaturizerParams.for_state_dict(sd, bcfg,
                                                     BF16_PRECISION,
                                                     device=dev)
            cpu = F.FeaturizerParams.for_state_dict(sd, bcfg,
                                                    FP32_PRECISION)
            del sd
            px = torch.from_numpy(_sd_image(np.random.RandomState(seed),
                                            cfg.img_size))[None]
            F.extract_features(card, bcfg, px.to(dev), deterministic=True)
            torch.cuda.synchronize(dev)
            with _Spy(DB, "flash_attention", keep=attn_shape) as one:
                got, launches = counted_run(
                    counters, lambda: F.extract_features(
                        card, bcfg, px.to(dev), deterministic=True))
            paths[f"{key}_features"] = launches
            want = {"flash_attention": per_forward}
            if any(launches[k] != want.get(k, 0) for k in launches):
                fail(f"{label} forward launches {launches}, not {want}")
            by_shape = collections.Counter(attn_key(*k[1:])
                                           for k in one.kept)
            mine = [c for c in cases if c["what"].startswith(label)]
            if sum(by_shape.values()) != per_forward or \
                    not set(by_shape) <= {c["attn"] for c in mine}:
                fail(f"{label} forward: tower attentions {dict(by_shape)}, "
                     f"not {per_forward} at phase 2's shapes")
            for c in mine:
                c["launches_per_forward"] = by_shape[c["attn"]]
            again = F.extract_features(card, bcfg, px.to(dev),
                                       deterministic=True)
            if not torch.equal(got, again):
                fail(f"{label} features: a repeat on the card gave other "
                     f"bits")
            t0 = time.perf_counter()
            ref = F.extract_features(cpu, bcfg, px, deterministic=True)
            cpu_s = time.perf_counter() - t0
            del cpu
            grid, dim = F.feature_grid(bcfg), F.feature_dim(bcfg)
            if got.shape != (1, grid * grid, dim) or ref.shape != got.shape:
                fail(f"{label} features {tuple(got.shape)}, CPU "
                     f"{tuple(ref.shape)}, not (1, {grid * grid}, {dim})")
            if not torch.isfinite(got).all():
                fail(f"{label} features on the card are not finite")
            diff = got.float().cpu() - ref
            rel = (diff.norm() / ref.norm()).item()
            rel_max = (diff.abs().max() / ref.abs().max()).item()
            cos = torch.nn.functional.cosine_similarity(
                got.float().cpu()[0], ref[0], dim=-1)
            print(f"{tag} phase 12 (a) {label} extract_features, one "
                  f"{cfg.img_size} px image, block {bcfg.up_ft_index} of "
                  f"{own_blocks(bcfg)}: {tuple(got.shape)} tokens; card bf16 "
                  f"vs CPU fp32 ||diff|| / ||CPU|| {rel:.3e} (tol "
                  f"{TRANSFORMER_FEATURE_REL_TOL}), max|diff| / max|CPU| "
                  f"{rel_max:.3e}, token cosine min {cos.min().item():.5f} "
                  f"mean {cos.mean().item():.5f}; max|CPU| "
                  f"{ref.abs().max().item():.3e}; a repeat's bits equal; "
                  f"kernel-2 launches by shape (counted) {dict(by_shape)}; "
                  f"CPU {cpu_s:.2f} s")
            if not rel <= TRANSFORMER_FEATURE_REL_TOL:
                fail(f"{label} features: card bf16 against CPU fp32 {rel} > "
                     f"{TRANSFORMER_FEATURE_REL_TOL}")
            for b in (1, C_BATCH):
                xb = px.to(dev).expand(b, -1, -1, -1).contiguous()
                noisy = F._noisy_latents(card, bcfg, xb, None,
                                         deterministic=True)
                whole = cuda_ms(lambda: F.extract_features(
                    card, bcfg, xb, deterministic=True), iters=3, warmup=1)
                vae = cuda_ms(lambda: card.vae(xb), iters=3, warmup=1)
                back = cuda_ms(lambda: F.backbone_tokens(
                    card, bcfg, noisy), iters=3, warmup=1)
                print(f"{tag} phase 12 {label} featurizer at B={b}: "
                      f"{whole:.2f} ms a call, {b / whole * 1e3:.2f} "
                      f"images/s (synced, the card alone); the VAE encoder "
                      f"{vae:.2f} ms, the backbone and the unfold "
                      f"{back:.2f} ms")
                del xb, noisy
            del card, got, again, ref, diff
            gc.collect()
            torch.cuda.empty_cache()

            # (b) extract-features over the synthetic SPair tree ----------
            out_dir = os.path.join(tmp, f"spair_{key}")
            argv = ["extract-features", "--images",
                    os.path.join(root, "JPEGImages"), "--out-dir", out_dir,
                    "--batch-size", str(C_BATCH), "--device", str(dev),
                    "--set", "model.vision_tower=" + name,
                    "--set", f"model.tower_weights={bundle}",
                    "--set", "model.decoder_layers=2"]
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts(counters)
            t0 = time.perf_counter()
            with _Spy(prunner, "extract_tower_features", dev) as ext, \
                    _Spy(pfeat, "preprocess_image") as prep, \
                    _Spy(TR, "extract_features", dev) as fwd, \
                    contextlib.redirect_stdout(io.StringIO()) as said:
                rc = cli.main(argv)
            total_s = time.perf_counter() - t0
            torch.cuda.synchronize(dev)
            calls = -(-n_images // C_BATCH)
            if rc != 0 or said.getvalue().strip() != (
                    f"extracted {n_images} feature files to {out_dir}"):
                fail(f"{label} extract-features: rc {rc}, said "
                     f"{said.getvalue()!r}")
            if [len(ext.seconds), len(fwd.seconds)] != [1, calls]:
                fail(f"{label} extract-features: {len(fwd.seconds)} tower "
                     f"calls, not {calls}")
            files = sorted(f for f in os.listdir(out_dir)
                           if f.endswith(".npy"))
            if len(files) != n_images:
                fail(f"{label}: {len(files)} feature files, not {n_images}")
            for f in files[:C_BATCH]:
                x = np.load(os.path.join(out_dir, f))
                if x.shape != (grid * grid, dim) or not np.isfinite(x).all():
                    fail(f"{label}: {f} is not a finite fp32 "
                         f"{(grid * grid, dim)}")
            extract_peak = torch.cuda.max_memory_allocated(dev) / 1e9
            res, parts, _ = _c_score_run(root, out_dir, grid, dev,
                                         lambda args, out: None)
            c_scores[label] = res["per_img"][0]
            launches = read_counts(counters)
            paths[f"{key}_c_score"] = launches
            want = {"flash_attention": per_forward * calls}
            if any(launches[k] != want.get(k, 0) for k in launches):
                fail(f"{label} C-score launches {launches}, not {want}")
            for k in ("per_img", "per_kpt", "geo"):
                if not all(0.0 <= v <= 1.0 for v in res[k]):
                    fail(f"{label}: {k} {res[k]} is not in [0, 1]")
            ext_s = ext.seconds[0]
            print(f"{tag} phase 12 (b) {label} C score ({n_images} images, "
                  f"{C_PAIRS * 18} pairs, batch {C_BATCH}): per_img "
                  f"PCK@.10/.05/.01 "
                  f"{', '.join(f'{v:.4f}' for v in res['per_img'])}, "
                  f"per_kpt {res['per_kpt'][0]:.4f}, geo "
                  f"{res['geo'][0]:.4f}; extraction {n_images / ext_s:.2f} "
                  f"images/s ({ext_s:.2f} s: preprocess_image "
                  f"{sum(prep.seconds):.2f} (host), tower calls "
                  f"{sum(fwd.seconds):.2f} (card, synced); the build with a "
                  f"2-layer decoder {total_s - ext_s:.2f} s apart); "
                  f"extraction peak memory allocated {extract_peak:.2f} GB; "
                  f"run_c_score {parts['total']:.2f} s (feature files "
                  f"{parts['features']:.2f}, compute_pck_batch "
                  f"{parts['device']:.3f}); launches {launches}")
            shutil.rmtree(out_dir)
            gc.collect()
            torch.cuda.empty_cache()
            if label == "SD3":
                paths["sd3_serve"] = serve_tower(tag, dev, counters, name,
                                                 bundle, per_forward)
            os.remove(bundle)
            os.remove(bundle + ".json")
        checked = {(c["batch"], c["attn"]) for c in cases}
        ran = collections.Counter((k[0], attn_key(*k[1:])) for k in seen.kept
                                  if k is not None)
        if not set(ran) <= checked:
            fail(f"phase 12 ran tower attentions that phase 2 did not hold "
                 f"to the plain version: {sorted(set(ran) - checked)}")
        print(f"{tag} phase 12 tower attentions by (B, shape), each held to "
              f"its plain version in phase 2: {dict(sorted(ran.items()))}")
    finally:
        seen.__exit__()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# phase 16: GeoAware-SC at full width. The SD1.5 featurizer at 960 px through
# up block 2 (its s5 / s4 / s3 taps at 15², 30², 60²), DINOv2-B at 840 px
# (a 60 x 60 grid; the token facet of block 11), SAM ViT-H (1,024 px, 32
# layers of 1,280, windows of 14, global layers 7, 15, 23, 31) and the
# aggregation network at GeoAware's feature dims on a 60 grid, all seeded
GEO_SEED = 41
GEO_CATEGORY = "cat"                # the SPair category of (a), (b), (d)
GEO_IMAGES = 8                      # its images, and its pairs
GEO_PAIRS = 6
GEO_TARGETS = "bflr"                # the pose targets' labels
GEO_REAL_SIZE = 960
GEO_DINO = "facebook/dinov2-base-840"
GEO_DINO_LAYER = 11
GEO_FEATURE_DIMS = (640, 1280, 1280, 768)     # s3, s4, s5, DINO
GEO_C_STEPS = 10
# kernel 2 at the SD1.5 UNet's attentions at 960 px through up block 2 (one
# image a call: B = 1), each launched (down blocks 0-2 twice, mid once, up
# blocks 1 and 2 three times; self and cross) this many times a forward
GEOWARE_SD15_ATTENTION = (
    (14400, 14400, 40, "block 0 self", 2),
    (14400, 77, 40, "block 0 cross", 2),
    (3600, 3600, 80, "block 1 self", 5),
    (3600, 77, 80, "block 1 cross", 5),
    (900, 900, 160, "block 2 self", 5),
    (900, 77, 160, "block 2 cross", 5),
    (225, 225, 160, "mid self", 1),
    (225, 77, 160, "mid cross", 1),
)
GEOWARE_ATTENTION = tuple((1, sq, skv, 8, d, "GeoAware 960 px " + what)
                          for sq, skv, d, what, _ in GEOWARE_SD15_ATTENTION)
GEO_KERNEL2_LAUNCHES = sum(n for *_, n in GEOWARE_SD15_ATTENTION)   # 26
# kernel 1 at DINOv2-B's attention at 840 px: 1 + 60² tokens, 12 heads of 64,
# one launch a block, 12 blocks through block 11
GEO_DINO_ATTENTION = (1, 3601, 12, 64)
GEO_KERNEL1_LAUNCHES = GEO_DINO_LAYER + 1
# facebook/sam-vit-huge's config.json (the keys `sam_config_from_hf` reads)
SAM_VIT_H_CONFIG = {
    "architectures": ["SamModel"], "model_type": "sam",
    "vision_config": {
        "hidden_size": 1280, "num_hidden_layers": 32,
        "num_attention_heads": 16, "mlp_dim": 5120, "output_channels": 256,
        "image_size": 1024, "patch_size": 16, "window_size": 14,
        "global_attn_indexes": [7, 15, 23, 31], "layer_norm_eps": 1e-06,
        "num_pos_feats": 128, "qkv_bias": True, "use_abs_pos": True,
        "use_rel_pos": True, "mlp_ratio": 4.0, "num_channels": 3,
        "model_type": "sam_vision_model"},
    "prompt_encoder_config": {
        "hidden_size": 256, "image_size": 1024, "patch_size": 16,
        "image_embedding_size": 64, "mask_input_channels": 16,
        "num_point_embeddings": 4},
    "mask_decoder_config": {
        "hidden_size": 256, "mlp_dim": 2048, "num_hidden_layers": 2,
        "num_attention_heads": 8, "attention_downsample_rate": 2,
        "num_multimask_outputs": 3, "iou_head_depth": 3,
        "iou_head_hidden_dim": 256},
    "torch_dtype": "float16"}


def sam_snapshot_tensors(config: dict, w: "_Init") -> dict:
    """A SamModel's tensors in HF's published key names and layouts for
    `config` (a config.json dict), drawn by `w`: linear and conv weights
    N(0, 1 / fan_in), biases, position and relative-position tables
    N(0, 0.02), norms 1 + N(0, 0.02), the prompt and token embeddings and
    the Fourier table N(0, 1). The shared Fourier table is stored under
    both of its names, as transformers saves it."""
    v, pc = config["vision_config"], config["prompt_encoder_config"]
    mc = config["mask_decoder_config"]
    d, p = v["hidden_size"], v["patch_size"]
    g = v["image_size"] // p
    hd = d // v["num_attention_heads"]
    oc = v["output_channels"]
    w.rand("shared_image_embedding.positional_embedding",
           (2, v["num_pos_feats"]), 1.0)
    w.sd["prompt_encoder.shared_embedding.positional_embedding"] = w.sd[
        "shared_image_embedding.positional_embedding"]
    ve = "vision_encoder"
    w.rand(f"{ve}.pos_embed", (1, g, g, d), 0.02)
    w.rand(f"{ve}.patch_embed.projection.weight", (d, 3, p, p),
           (3 * p * p) ** -0.5)
    w.rand(f"{ve}.patch_embed.projection.bias", (d,), 0.02)
    for i in range(v["num_hidden_layers"]):
        side = g if i in v["global_attn_indexes"] else v["window_size"]
        lp = f"{ve}.layers.{i}"
        w.norm(f"{lp}.layer_norm1", d)
        w.rand(f"{lp}.attn.rel_pos_h", (2 * side - 1, hd), 0.02)
        w.rand(f"{lp}.attn.rel_pos_w", (2 * side - 1, hd), 0.02)
        w.linear(f"{lp}.attn.qkv", 3 * d, d)
        w.linear(f"{lp}.attn.proj", d, d)
        w.norm(f"{lp}.layer_norm2", d)
        w.linear(f"{lp}.mlp.lin1", v["mlp_dim"], d)
        w.linear(f"{lp}.mlp.lin2", d, v["mlp_dim"])
    w.rand(f"{ve}.neck.conv1.weight", (oc, d, 1, 1), d ** -0.5)
    w.norm(f"{ve}.neck.layer_norm1", oc)
    w.rand(f"{ve}.neck.conv2.weight", (oc, oc, 3, 3), (9 * oc) ** -0.5)
    w.norm(f"{ve}.neck.layer_norm2", oc)
    c, mic = pc["hidden_size"], pc["mask_input_channels"]
    pe = "prompt_encoder"
    for name, shape in (("conv1", (mic // 4, 1, 2, 2)),
                        ("conv2", (mic, mic // 4, 2, 2)),
                        ("conv3", (c, mic, 1, 1))):
        w.rand(f"{pe}.mask_embed.{name}.weight", shape,
               (shape[1] * shape[2] * shape[3]) ** -0.5)
        w.rand(f"{pe}.mask_embed.{name}.bias", shape[:1], 0.02)
    w.norm(f"{pe}.mask_embed.layer_norm1", mic // 4)
    w.norm(f"{pe}.mask_embed.layer_norm2", mic)
    for name in ("no_mask_embed", "not_a_point_embed", *(
            f"point_embed.{i}" for i in range(4))):
        w.rand(f"{pe}.{name}.weight", (1, c), 1.0)
    md, n_mask = "mask_decoder", mc["num_multimask_outputs"] + 1
    inner = c // mc["attention_downsample_rate"]
    w.rand(f"{md}.iou_token.weight", (1, c), 1.0)
    w.rand(f"{md}.mask_tokens.weight", (n_mask, c), 1.0)

    def attn(prefix, width):
        for name in ("q_proj", "k_proj", "v_proj"):
            w.linear(f"{prefix}.{name}", width, c)
        w.linear(f"{prefix}.out_proj", c, width)
    for i in range(mc["num_hidden_layers"]):
        lp = f"{md}.transformer.layers.{i}"
        attn(f"{lp}.self_attn", c)
        attn(f"{lp}.cross_attn_token_to_image", inner)
        attn(f"{lp}.cross_attn_image_to_token", inner)
        for j in range(1, 5):
            w.norm(f"{lp}.layer_norm{j}", c)
        w.linear(f"{lp}.mlp.lin1", mc["mlp_dim"], c)
        w.linear(f"{lp}.mlp.lin2", c, mc["mlp_dim"])
    attn(f"{md}.transformer.final_attn_token_to_image", inner)
    w.norm(f"{md}.transformer.layer_norm_final_attn", c)
    # ConvTranspose2d weights are [in, out, kh, kw]
    w.rand(f"{md}.upscale_conv1.weight", (c, c // 4, 2, 2), (4 * c) ** -0.5)
    w.rand(f"{md}.upscale_conv1.bias", (c // 4,), 0.02)
    w.norm(f"{md}.upscale_layer_norm", c // 4)
    w.rand(f"{md}.upscale_conv2.weight", (c // 4, c // 8, 2, 2), c ** -0.5)
    w.rand(f"{md}.upscale_conv2.bias", (c // 8,), 0.02)
    for i in range(n_mask):
        hp = f"{md}.output_hypernetworks_mlps.{i}"
        w.linear(f"{hp}.proj_in", c, c)
        w.linear(f"{hp}.layers.0", c, c)
        w.linear(f"{hp}.proj_out", c // 8, c)
    ih, depth = mc["iou_head_hidden_dim"], mc["iou_head_depth"]
    w.linear(f"{md}.iou_prediction_head.proj_in", ih, c)
    for j in range(depth - 2):
        w.linear(f"{md}.iou_prediction_head.layers.{j}", ih, ih)
    w.linear(f"{md}.iou_prediction_head.proj_out", n_mask, ih)
    return w.sd


def _geo_tree(root: str) -> dict:
    """Phase 16's images under `root`: 12 pose templates (`templates/*.png`),
    the pose targets (`SPair-71k/JPEGImages/pose_targets/*.jpg`, a
    `bndbox` annotation each, their labels in `labels.json`) and one SPair
    category (GEO_IMAGES JPEGs with keypoints and a `bndbox` each, as
    SPair's image annotations have, and GEO_PAIRS test pairs), all smooth
    random images of 300-500 px a side. Returns the paths."""
    import numpy as np
    from PIL import Image
    from law_of_vision_representation_in_mllms_torch.metrics import spair
    rng = np.random.RandomState(GEO_SEED)

    def image(path):
        w, h = (int(v) for v in rng.randint(300, 501, 2))
        coarse = rng.randint(0, 256, (h // 24 + 2, w // 24 + 2, 3),
                             dtype=np.uint8)
        Image.fromarray(coarse).resize(
            (w, h), Image.Resampling.BILINEAR).save(path)
        return w, h

    def box(w, h):
        return [int(rng.randint(0, w // 4)), int(rng.randint(0, h // 4)),
                int(rng.randint(3 * w // 4, w)),
                int(rng.randint(3 * h // 4, h))]

    spair_root = os.path.join(root, "SPair-71k")
    out = {"templates": os.path.join(root, "templates"),
           "targets": os.path.join(spair_root, "JPEGImages", "pose_targets"),
           "labels": os.path.join(root, "labels.json"),
           "spair": spair_root}
    os.makedirs(out["templates"])
    for i in range(12):
        image(os.path.join(out["templates"], f"t{i:02d}.png"))
    for sub in ("JPEGImages", "ImageAnnotation"):
        for cat in ("pose_targets", GEO_CATEGORY):
            os.makedirs(os.path.join(spair_root, sub, cat))
    os.makedirs(os.path.join(spair_root, "PairAnnotation", "test"))
    labels = {}
    for i, pose in enumerate(GEO_TARGETS):
        w, h = image(os.path.join(out["targets"], f"tgt{i}.jpg"))
        with open(os.path.join(spair_root, "ImageAnnotation", "pose_targets",
                               f"tgt{i}.json"), "w") as f:
            json.dump({"bndbox": box(w, h), "image_width": w,
                       "image_height": h}, f)
        labels[f"tgt{i}.jpg"] = pose
    with open(out["labels"], "w") as f:
        json.dump(labels, f)
    groups = spair.load_geoware_tables()["SPAIR_GEO_AWARE"][GEO_CATEGORY]
    num_kps = 1 + max(i for gr in groups
                      for i in ([gr] if isinstance(gr, int) else gr))
    sizes = []
    for i in range(GEO_IMAGES):
        name = f"{GEO_CATEGORY}_{i:03d}"
        w, h = image(os.path.join(spair_root, "JPEGImages", GEO_CATEGORY,
                                  f"{name}.jpg"))
        bb = box(w, h)
        kps = {str(k): ([float(rng.randint(bb[0], bb[2])),
                         float(rng.randint(bb[1], bb[3]))]
                        if rng.rand() < 0.8 else None)
               for k in range(num_kps)}
        with open(os.path.join(spair_root, "ImageAnnotation", GEO_CATEGORY,
                               f"{name}.json"), "w") as f:
            json.dump({"kps": kps, "bndbox": bb, "image_width": w,
                       "image_height": h}, f)
        sizes.append(([w, h, 3], bb))
    for p in range(GEO_PAIRS):
        s, t = (int(v) for v in rng.choice(GEO_IMAGES, 2, replace=False))
        cat = GEO_CATEGORY
        with open(os.path.join(
                spair_root, "PairAnnotation", "test",
                f"{p:06d}-{cat}_{s:03d}-{cat}_{t:03d}:{cat}.json"),
                "w") as f:
            json.dump({"category": cat, "src_imname": f"{cat}_{s:03d}.jpg",
                       "trg_imname": f"{cat}_{t:03d}.jpg",
                       "src_imsize": sizes[s][0], "trg_imsize": sizes[t][0],
                       "src_bndbox": sizes[s][1],
                       "trg_bndbox": sizes[t][1]}, f)
    return out


def _cli_quiet(argv: list) -> tuple:
    """`cli.main(argv)` with its standard output captured: (rc, output)."""
    import io
    from law_of_vision_representation_in_mllms_torch import cli
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli.main(argv)
    return rc, said.getvalue()


def run_geoware(tag: str, dev, counters, unet_cases: list,
                dino_case: dict) -> dict:
    """Phase 16: GeoAware-SC through the port's CLI at full width on seeded
    weights, over phase 16's images (`_geo_tree`):
    (a) `preprocess-map` of the 12 templates, the pose targets and the SPair
        category, flips on: an SD1.5 bundle through up block 2 at 960 px
        (26 kernel-2 launches a forward) and DINOv2-B at 840 px (the token
        facet of block 11: 12 kernel-1 launches); one template's s3 / s4 /
        s5 maps and DINO descriptors, card (bf16 compute) against the
        port's CPU fp32 run (made in a second thread while the bundles are
        written and joined before (a), so that no host work of the check
        overlaps the commands' times);
    (b) `sam-masks --spair` over the targets and the category from a SAM
        ViT-H snapshot in HF's key names (config.json + fp16 .safetensors):
        a mask and its mirror for every image, at the canvas's shape;
    (c) `pose-awareness` over (a)'s files with (b)'s masks, `--res 128`:
        4 rows of 12 finite distances, n = 4;
    (d) `c-train` at GeoAware's widths (`--feature-dims 640 1280 1280 768
        --num-patches 60`, 10 steps of batch 4) on [3,600, 3,968] files
        built from (a)'s maps of the category (s3, s4 and s5 repeated to
        s3's 60 x 60 grid, then DINO's tokens): finite losses, best.npz,
        best_pck in [0, 1].
    Every kernel launch is counted from 0 around each command, and every
    tower attention recorded by its shape, which must be one phase 2 held
    to its plain version (`unet_cases`' GeoAware cases, `dino_case`); each
    GeoAware case gets its launches a forward. Returns the launches of each
    path."""
    import collections
    import shutil
    import threading

    import numpy as np
    import torch
    from PIL import Image
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.io import (
        featurizer_bundle as FB, from_jax)
    from law_of_vision_representation_in_mllms_torch.io.param_io import (
        save_params)
    from law_of_vision_representation_in_mllms_torch.models import (
        diffusion_blocks as DB, facet, featurizer as F, vit)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        geoware as G, sam_masks as SM)

    def attn_shape(args, out):
        (b, sq, h, d), skv = args[0].shape, args[1].shape[1]
        return (b, sq, skv, h, d) if args[0].is_cuda else None

    paths = {}
    t_phase = time.perf_counter()
    threads = torch.get_num_threads()
    tmp = tempfile.mkdtemp(prefix="lvr_geoware_")
    seen2 = _Spy(DB, "flash_attention", keep=attn_shape).__enter__()
    seen1 = _Spy(vit, "encoder_attention", keep=attn_shape).__enter__()
    cpu_ref, worker = {}, None
    try:
        t0 = time.perf_counter()
        data = _geo_tree(tmp)
        # the bundles: seeded fp32 weights drawn on the card ------------
        gen = torch.Generator(device=dev).manual_seed(GEO_SEED)
        cfg = dataclasses.replace(F.FEATURIZER_PRESETS[SD15](),
                                  img_size=GEO_REAL_SIZE, up_ft_index=2)
        own = F.FeaturizerParams(cfg, FP32_PRECISION, device=dev)
        init_weights(own, gen)
        own.prompt_embeds.normal_(generator=gen)
        n_sd = sum(p.numel() for p in own.parameters())
        sd_state = {k: v.cpu() for k, v in own.state_dict().items()}
        del own
        dcfg = vit.VIT_PRESETS[GEO_DINO]()
        dino = vit.ViTEncoder(dcfg, FP32_PRECISION, device=dev)
        init_weights(dino, gen)
        dino_state = {k: v.cpu() for k, v in dino.state_dict().items()}
        del dino
        torch.cuda.empty_cache()

        # the CPU fp32 reference of one template, in a second thread while
        # the bundles are written; joined before (a) starts, so that no
        # host work of the check overlaps the commands' times
        def cpu_reference():
            try:
                t1 = time.perf_counter()
                with Image.open(os.path.join(data["templates"],
                                             "t00.png")) as img:
                    img = img.convert("RGB")
                sd_px = torch.from_numpy(G._sd_pixels(G.load_square(
                    img, GEO_REAL_SIZE)))[None]
                dn_px = torch.from_numpy(G._dino_pixels(G.load_square(
                    img, dcfg.image_size)))[None]
                with torch.no_grad():
                    sd_cpu = F.FeaturizerParams.for_state_dict(
                        sd_state, cfg, FP32_PRECISION)
                    cpu_ref["sd"] = F.extract_multiscale_features(
                        sd_cpu, cfg, sd_px, deterministic=True)
                    del sd_cpu
                    enc = vit.ViTEncoder(dcfg, FP32_PRECISION,
                                         num_blocks=GEO_DINO_LAYER + 1)
                    enc.load_state_dict(dino_state)
                    cpu_ref["dino"] = facet.facet_descriptors(
                        enc, dn_px, layer=GEO_DINO_LAYER, facet="token")
                cpu_ref["seconds"] = time.perf_counter() - t1
            except BaseException as e:          # re-raised by the phase
                cpu_ref["error"] = e
        worker = threading.Thread(target=cpu_reference)
        worker.start()
        sd_bundle = FB.save_featurizer_bundle(
            os.path.join(tmp, "sd15_up2"), from_jax.featurizer_tree(sd_state),
            cfg)
        dino_npz = os.path.join(tmp, "dinov2_b_840.npz")
        save_params(dino_npz, from_jax.vit_tree(
            {"encoder." + k: v for k, v in dino_state.items()},
            dcfg.patch_size)["encoder"])
        n_img = 12 + len(GEO_TARGETS) + GEO_IMAGES
        print(f"{tag} phase 16 inputs: {n_img} images; SD1.5 bundle "
              f"through up block 2 ({n_sd / 1e6:.1f} M params, {os.path.getsize(sd_bundle) / 1e9:.2f} GB), "
              f"DINOv2-B@840 ({os.path.getsize(dino_npz) / 1e9:.2f} GB), "
              f"seeded, written in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        worker.join()
        if "error" in cpu_ref:
            raise cpu_ref["error"]
        print(f"{tag} phase 16 t00's CPU fp32 reference: "
              f"{cpu_ref['seconds']:.1f} s on {threads} host threads, the "
              f"bundles' writes beside it; waited {time.perf_counter() - t0:.1f}"
              f" s for it after them")

        # (a) preprocess-map over every image, flips on ------------------
        feats = os.path.join(tmp, "geo_features")
        argv = ["preprocess-map", tmp, feats, "--sd-bundle", sd_bundle,
                "--dino-bundle", dino_npz, "--dino-tower", GEO_DINO,
                "--real-size", str(GEO_REAL_SIZE), "--dino-size",
                str(dcfg.image_size), "--layer", str(GEO_DINO_LAYER),
                "--device", str(dev)]
        n2, n1 = len(seen2.kept), len(seen1.kept)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with _Spy(G, "extract_multiscale_features", dev) as sd_t, \
                _Spy(G, "facet_descriptors", dev) as dino_t:
            (rc, said), launches = counted_run(counters,
                                               lambda: _cli_quiet(argv))
        pre_s = time.perf_counter() - t0
        variants = 2 * n_img
        if rc != 0 or said.strip() != (f"wrote {2 * variants} feature files "
                                       f"-> {feats}"):
            fail(f"phase 16 (a) preprocess-map: rc {rc}, said {said!r}")
        paths["geoware_preprocess"] = launches
        want = {"flash_attention": GEO_KERNEL2_LAUNCHES * variants,
                "encoder_attention": GEO_KERNEL1_LAUNCHES * variants}
        if any(launches[k] != want.get(k, 0) for k in launches):
            fail(f"phase 16 (a) launches {launches}, not {want}")
        by_shape = collections.Counter(
            attn_key(*k[1:]) for k in seen2.kept[n2:] if k is not None)
        geo = {c["attn"]: c for c in unet_cases
               if c["what"].startswith("GeoAware")}
        if not set(by_shape) <= set(geo) or any(
                by_shape[attn_key(sq, skv, 8, d)] != n * variants
                for sq, skv, d, _, n in GEOWARE_SD15_ATTENTION):
            fail(f"phase 16 (a) kernel-2 launches by shape {dict(by_shape)},"
                 f" not GEOWARE_SD15_ATTENTION's x {variants}")
        for a, c in geo.items():
            c["launches_per_geoware_forward"] = by_shape[a] // variants
        dino_shapes = {k for k in seen1.kept[n1:] if k is not None}
        b, s, h, d = GEO_DINO_ATTENTION
        if dino_shapes != {(b, s, s, h, d)}:
            fail(f"phase 16 (a) kernel-1 launches at {dino_shapes}, not the "
                 f"held {GEO_DINO_ATTENTION}")
        dino_case["launches_per_geoware_forward"] = (
            launches["encoder_attention"] // variants)
        with np.load(os.path.join(feats, "t00_sd.npz")) as z:
            maps = {k: z[k] for k in z.files}
        desc = np.load(os.path.join(feats, "t00_dino.npy"))
        # s5 / s4 / s3: up blocks 0-2 before their upsamplers (SD1.5 at
        # 960 px: 15², 30², 60² of 1280, 1280, 640)
        chans = cfg.unet.block_out_channels
        n = len(chans)
        lat = GEO_REAL_SIZE // 2 ** (len(cfg.vae.block_out_channels) - 1)
        want_shapes = {f"s{5 - i}": (1, lat >> (n - 1 - i),
                                     lat >> (n - 1 - i), chans[n - 1 - i])
                       for i in range(3)}
        if {k: v.shape for k, v in maps.items()} != want_shapes or \
                desc.shape != (1, 1, dcfg.num_patches, dcfg.hidden_size):
            fail(f"phase 16 (a) maps {[v.shape for v in maps.values()]}, "
                 f"descriptors {desc.shape}")
        for v in (*maps.values(), desc):
            if not np.isfinite(v).all():
                fail("phase 16 (a): a map or descriptor is not finite")
        print(f"{tag} phase 16 (a) preprocess-map, {n_img} images x 2 "
              f"(flips), card: {pre_s:.1f} s, {variants / pre_s:.2f} image "
              f"variants/s; SD1.5 at {GEO_REAL_SIZE} px through up block 2 "
              f"{np.median(sd_t.seconds) * 1e3:.1f} ms a variant (median, "
              f"synced), DINOv2-B@840 token facet "
              f"{np.median(dino_t.seconds) * 1e3:.1f} ms; launches "
              f"{launches}; kernel 2 a forward by shape "
              f"{ {a: n // variants for a, n in by_shape.items()} }; peak "
              f"memory allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

        # (b) sam-masks from a SAM ViT-H snapshot ------------------------
        t0 = time.perf_counter()
        snap = os.path.join(tmp, "sam_vit_h")
        w = _Init(dev, GEO_SEED + 1)
        nbytes = _write_snapshot(snap, SAM_VIT_H_CONFIG,
                                 sam_snapshot_tensors(SAM_VIT_H_CONFIG, w))
        n_sam = sum(t.numel() for k, t in w.sd.items()
                    if not k.startswith("prompt_encoder.shared"))
        del w
        write_s = time.perf_counter() - t0
        images = os.path.join(data["spair"], "JPEGImages")
        argv = ["sam-masks", "--snapshot", snap, "--images", images,
                "--spair", "--anno-size", str(GEO_REAL_SIZE), "--device",
                str(dev)]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with _Spy(SM, "segment_box", dev) as seg_t:
            (rc, _), launches = counted_run(counters,
                                            lambda: _cli_quiet(argv))
        sam_s = time.perf_counter() - t0
        paths["geoware_sam"] = launches
        n_masks = len(GEO_TARGETS) + GEO_IMAGES
        if rc != 0 or len(seg_t.seconds) != n_masks or any(launches.values()):
            fail(f"phase 16 (b) sam-masks: rc {rc}, {len(seg_t.seconds)} "
                 f"images, launches {launches} (SAM runs no port kernel)")
        fg = []
        for sub, n in (("pose_targets", len(GEO_TARGETS)),
                       (GEO_CATEGORY, GEO_IMAGES)):
            out_dir = os.path.join(data["spair"], "features", sub)
            for f in sorted(os.listdir(os.path.join(images, sub))):
                stem = os.path.splitext(f)[0]
                m, mf = (np.asarray(Image.open(os.path.join(
                    out_dir, f"{stem}_mask{x}.png"))) for x in ("", "_flip"))
                if m.shape != (GEO_REAL_SIZE, GEO_REAL_SIZE) or \
                        not np.array_equal(mf, m[:, ::-1]) or \
                        not set(np.unique(m)) <= {0, 255}:
                    fail(f"phase 16 (b) {sub}/{stem}: mask {m.shape}, its "
                         f"flip not its mirror, or values not 0 / 255")
                fg.append((m > 0).mean())
        print(f"{tag} phase 16 (b) SAM ViT-H snapshot ({n_sam / 1e6:.1f} M "
              f"params, fp16 .safetensors {nbytes / 1e9:.2f} GB, HF key "
              f"names) written in {write_s:.1f} s; sam-masks over "
              f"{n_masks} images: {sam_s:.1f} s (loading and porting on the "
              f"host included), {np.median(seg_t.seconds) * 1e3:.1f} ms an "
              f"image (median, synced: resize, encoder, decoder, the "
              f"upscale to {GEO_REAL_SIZE} px); masks "
              f"{GEO_REAL_SIZE}x{GEO_REAL_SIZE}, foreground share "
              f"{min(fg):.3f}-{max(fg):.3f}; launches {launches}; peak "
              f"memory allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

        # (c) pose-awareness over (a)'s files, (b)'s masks ---------------
        out_json = os.path.join(tmp, "pose.json")
        argv = ["pose-awareness", data["templates"], data["targets"],
                data["labels"], feats, "--mask-dir",
                os.path.join(data["spair"], "features", "pose_targets"),
                "--res", "128", "--output", out_json, "--device", str(dev)]
        t0 = time.perf_counter()
        with _Spy(G, "pair_distance", dev) as pair_t:
            (rc, _), launches = counted_run(counters,
                                            lambda: _cli_quiet(argv))
        pose_s = time.perf_counter() - t0
        paths["geoware_pose"] = launches
        with open(out_json) as f:
            pose = json.load(f)
        rows = np.asarray(pose["rows"], np.float64)
        if rc != 0 or rows.shape != (len(GEO_TARGETS), 12) or \
                not np.isfinite(rows).all() or \
                pose["results"]["n"] != len(GEO_TARGETS):
            fail(f"phase 16 (c) pose-awareness: rc {rc}, rows "
                 f"{rows.shape}, results {pose['results']}")
        print(f"{tag} phase 16 (c) pose-awareness, {len(GEO_TARGETS)} "
              f"targets x 12 templates at res 128: {pose_s:.1f} s, "
              f"{np.median(pair_t.seconds) * 1e3:.1f} ms a pair (median, "
              f"synced: co-PCA's three SVDs, the fused descriptors, the "
              f"16,384 x 16,384 distances); distances "
              f"{rows.min():.4f}-{rows.max():.4f}; results "
              f"{pose['results']}; launches {launches}")

        # (d) c-train at GeoAware's widths -------------------------------
        c_feats = os.path.join(tmp, "c_features")
        os.makedirs(c_feats)
        g = dcfg.grid
        for i in range(GEO_IMAGES):
            stem = f"{GEO_CATEGORY}_{i:03d}"
            with np.load(os.path.join(feats, f"{stem}_sd.npz")) as z:
                parts = [np.repeat(np.repeat(z[k][0], g // z[k].shape[1],
                                             axis=0), g // z[k].shape[2],
                                   axis=1) for k in ("s3", "s4", "s5")]
            parts.append(np.load(os.path.join(
                feats, f"{stem}_dino.npy"))[0, 0].reshape(g, g, -1))
            np.save(os.path.join(c_feats, f"{stem}.npy"),
                    np.concatenate(parts, axis=-1).reshape(g * g, -1))
        out_dir = os.path.join(tmp, "c_train_out")
        argv = ["c-train", "--spair-dir", data["spair"], "--feature-dir",
                c_feats, "--feature-dims",
                *(str(x) for x in GEO_FEATURE_DIMS), "--num-patches",
                str(g), "--categories", GEO_CATEGORY, "--steps",
                str(GEO_C_STEPS), "--out-dir", out_dir, "--device", str(dev)]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        (rc, said), launches = counted_run(counters, lambda: _cli_quiet(argv))
        train_s = time.perf_counter() - t0
        paths["geoware_c_train"] = launches
        res = json.loads(said.strip().splitlines()[-1]) if rc == 0 else {}
        losses = [h["loss"] for h in res.get("history", [])]
        if rc != 0 or not losses or not np.isfinite(losses).all() or \
                not 0.0 <= res["best_pck"] <= 1.0 or \
                not os.path.exists(os.path.join(out_dir, "best.npz")) or \
                any(launches.values()):
            fail(f"phase 16 (d) c-train: rc {rc}, said {said!r}, launches "
                 f"{launches}")
        print(f"{tag} phase 16 (d) c-train, {GEO_C_STEPS} steps of batch 4 "
              f"on [{g * g}, {sum(GEO_FEATURE_DIMS)}] features of "
              f"{GEO_IMAGES} images ({GEO_PAIRS} pairs): {train_s:.1f} s "
              f"(the feature reads and 5 PCK evaluations included); last "
              f"losses {losses}, best_pck {res['best_pck']:.4f}; launches "
              f"{launches} (the aggregation network has no attention); peak "
              f"memory allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

        # (a)'s check: the card's files against the CPU fp32 run ---------
        errs = {k: rel_errors(torch.from_numpy(maps[k]), v)
                for k, v in cpu_ref["sd"].items()}
        errs["dino"] = rel_errors(torch.from_numpy(desc), cpu_ref["dino"])
        print(f"{tag} phase 16 (a) t00, card (bf16 compute) vs the port's CPU "
              f"fp32: ||diff|| / ||CPU||, worst token, max|diff|: "
              + ", ".join(f"{k} {e[0]:.3e} / {e[1]:.3e} / {e[2]:.3e}"
                          for k, e in errs.items())
              + f" (tol {SD_FEATURE_REL_TOL} for the maps, {PORT_REL_TOL} "
              f"the descriptors, on the whole)")
        for k, e in errs.items():
            tol = PORT_REL_TOL if k == "dino" else SD_FEATURE_REL_TOL
            if not e[0] <= tol:
                fail(f"phase 16 (a) {k}: card against CPU {e[0]} > {tol}")
        print(f"{tag} phase 16 took {time.perf_counter() - t_phase:.1f} s")
    finally:
        if worker is not None:
            worker.join()
        seen1.__exit__()
        seen2.__exit__()
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# phase 3's GeoAware checks, CUDA fp32 (TF32 off) against the CPU fp32 on the
# same weights and inputs: fp32 sums in another order, and co-PCA's SVD by
# another algorithm (its signs do not reach a distance)
NARROW_FP32_REL_TOL = 1e-4


def check_narrow_geoware(tag: str, dev) -> None:
    """Phase 3: (1) a narrow SAM (256 px, 4 layers of 128 over windows of
    7 (the 16 x 16 grid padded to 21) and 2 global layers; a 64-wide
    decoder), `segment`'s mask logits and IoU for two boxes; (2) 3
    `c-train` steps of a narrow aggregation network (dims 32 / 64 / 64 / 48
    on an 8 x 8 grid, batch 2) from the same initial weights, loss by loss;
    (3) `pair_distance` (co-PCA, fusion, masked NN distances) of two
    random multi-scale feature sets; each CUDA against the CPU within
    NARROW_FP32_REL_TOL."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.metrics import (
        aggregation as A)
    from law_of_vision_representation_in_mllms_torch.models import sam as S
    from law_of_vision_representation_in_mllms_torch.pipeline import (
        geoware as G)
    from law_of_vision_representation_in_mllms_torch.train import (
        c_score_train as CT)

    def rel(got, ref):
        got, ref = got.detach().float().cpu(), ref.detach().float()
        return ((got - ref).norm() / ref.norm()).item()

    # (1) SAM
    cfg = S.SamConfig(
        vision=S.SamVisionCfg(image_size=256, hidden_size=128, num_layers=4,
                              num_heads=4, mlp_dim=512, out_chans=64,
                              window_size=7, global_attn_indexes=(1, 3)),
        prompt_hidden=64, num_pos_feats=32, decoder_heads=4,
        decoder_mlp_dim=256, iou_head_hidden=64, input_image_size=256)
    cpu = S.SamModel(cfg)
    gen = torch.Generator().manual_seed(GEO_SEED)
    with torch.no_grad():
        for p in cpu.parameters():
            x = torch.randn(p.shape, generator=gen)
            p.copy_(x * p.shape[0] ** -0.5 if p.dim() == 2 else 0.1 * x)
        for m in cpu.modules():
            if isinstance(m, S._LN):
                m.w.add_(1.0)
    card = S.SamModel(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    px = torch.randn((1, 256, 256, 3), generator=gen)
    boxes = torch.tensor([[[20.0, 30.0, 200.0, 220.0],
                           [60.0, 50.0, 150.0, 120.0]]])
    (m_cpu, iou_cpu), (m_card, iou_card) = (
        S.segment(model, px.to(d), boxes.to(d))
        for model, d in ((cpu, "cpu"), (card, dev)))
    sam_err = (rel(m_card, m_cpu), rel(iou_card, iou_cpu))
    del cpu, card

    # (2) c-train, 3 steps
    dims, n = (32, 64, 64, 48), 8
    tcfg = CT.CTrainConfig(learning_rate=3e-3, total_steps=100, num_patches=n)
    rng = np.random.RandomState(GEO_SEED)
    batch = {
        "feat1": rng.randn(2, n, n, sum(dims)).astype(np.float32),
        "feat2": rng.randn(2, n, n, sum(dims)).astype(np.float32),
        "kp_idx1": rng.randint(0, n * n, (2, 6)),
        "kp_idx2": rng.randint(0, n * n, (2, 6)),
        "kp_valid": (rng.rand(2, 6) > 0.2).astype(np.float32),
        "gt_flow": rng.randn(2, 6, 2).astype(np.float32)}
    losses = {}
    for d in ("cpu", dev):
        net = A.AggregationNetwork(feature_dims=dims, projection_dim=32,
                                   num_norm_groups=4).to(d)
        opt = CT.init_c_train(net, tcfg, torch.Generator(device=d)
                              .manual_seed(0))
        if d != "cpu":
            net.load_state_dict(start)
        else:
            start = {k: v.clone() for k, v in net.state_dict().items()}
        step = CT.make_c_train_step(net, tcfg, opt)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        losses[str(d)] = [float(step(b)["loss"]) for _ in range(3)]
    lc, lg = losses["cpu"], losses[str(dev)]
    train_err = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))

    # (3) co-PCA and the masked NN distance
    feats = [{k: torch.randn((1, gr, gr, c), generator=gen)
              for k, gr, c in (("s5", 4, 96), ("s4", 8, 96), ("s3", 16, 48))}
             for _ in range(2)]
    descs = [torch.randn((1, 1, 256, 40), generator=gen) for _ in range(2)]
    mask = (torch.rand((64, 64), generator=gen) > 0.3).float()
    dists = [G.pair_distance(
        {k: v.to(d) for k, v in feats[0].items()}, descs[0].to(d),
        {k: v.to(d) for k, v in feats[1].items()}, descs[1].to(d),
        mask.to(d), res=64, dims=(32, 32, 16)) for d in ("cpu", dev)]
    pair_err = abs(dists[1] - dists[0]) / abs(dists[0])
    print(f"{tag} narrow GeoAware, CUDA fp32 vs CPU fp32 (tol "
          f"{NARROW_FP32_REL_TOL}): SAM segment logits "
          f"{sam_err[0]:.3e}, IoU {sam_err[1]:.3e} (||diff|| / ||CPU||); "
          f"c-train losses {lc} vs {lg}, worst {train_err:.3e}; "
          f"pair_distance {dists[0]:.6f} vs {dists[1]:.6f} "
          f"({pair_err:.3e})")
    for what, e in (("SAM logits", sam_err[0]), ("SAM IoU", sam_err[1]),
                    ("c-train loss", train_err),
                    ("pair_distance", pair_err)):
        if not e <= NARROW_FP32_REL_TOL:
            fail(f"narrow GeoAware {what}: CUDA against CPU {e} > "
                 f"{NARROW_FP32_REL_TOL}")


def own_blocks(cfg) -> int:
    """The blocks of a DiT / MMDiT featurizer configuration."""
    return (cfg.dit or cfg.mmdit).num_layers


def serve_tower(tag: str, dev, counters, name: str, bundle: str,
                tower_launches: int) -> dict:
    """Phase 12 (c): LLaVA-1.5-7B over a diffusion tower's bundle through
    `build_lmm` -> `generate_until` on phase 4's four requests at the
    tower's image size, 32 new tokens (the graph path): finite logits,
    kernel 2 launched `tower_launches` times by the tower and once a layer
    by the prefill, kernel 3 by the decode; TTFT and tokens/s. Returns the
    launches, counted from 0."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    from law_of_vision_representation_in_mllms_torch.models import (
        llava as M)
    label = name.split("/")[-1]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    lmm = build_lmm(RunConfig.from_dict({"model": {
        "vision_tower": name, "tower_weights": [bundle]}}), device=dev)
    torch.cuda.synchronize(dev)
    entry = lmm.cfg.tower_spec.entries[0]
    print(f"{tag} phase 12 (c) LLaVA-1.5-7B over {label} "
          f"({entry.num_patches} tokens of {entry.hidden_size} -> "
          f"{lmm.cfg.projector_type} -> {lmm.cfg.decoder.hidden_size}) built "
          f"in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    reqs = _requests(4, lmm.processors[0].crop, diffusion=True)
    graph_dec = lmm.chunked_decoder()
    texts, launches = counted_run(
        counters, lambda: lmm.generate_until(reqs), graph_dec)
    dec = lmm.cfg.decoder
    if launches["flash_attention"] != tower_launches + dec.num_layers:
        fail(f"{label} serving: kernel 2 ran {launches['flash_attention']} "
             f"times, not {tower_launches} (tower) + {dec.num_layers} "
             f"(prefill)")
    if launches["decode_attention"] < dec.num_layers or \
            launches["encoder_attention"]:
        fail(f"{label} serving launches {launches}")
    ids, mask, pixels = lmm._encode_batch(reqs)
    pre = M.prefill(lmm.params, lmm.cfg, ids, mask, pixels, max_new_tokens=2)
    if not (torch.isfinite(pre.logits).all()
            and pre.logits.shape == (4, dec.vocab_size)):
        fail(f"{label} serving: the prefill's logits are not finite [B, V]")
    del pre
    ttft_s = timed_s(lambda: M.prefill(
        lmm.params, lmm.cfg, ids, mask, pixels, max_new_tokens=32), dev)
    gen_s = timed_s(lambda: lmm.generate_until(reqs), dev, reps=2)
    n_tok = 4 * 32
    print(f"{tag} phase 12 (c) {label} serving (B=4, {entry.img_size} px, "
          f"S={ids.shape[1] + lmm.cfg.num_patches - 1}, 32 new tokens, the "
          f"graph path): TTFT (tower + projector + prefill) "
          f"{ttft_s * 1e3:.2f} ms; generate_until {gen_s * 1e3:.2f} ms, "
          f"{n_tok / (gen_s - ttft_s):.1f} tokens/s after the first token "
          f"({n_tok / gen_s:.1f} with it); launches {launches}; peak memory "
          f"allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
          f"sample answer {texts[0][:60]!r}")
    del lmm, graph_dec
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def sd15_split() -> int:
    """`--sd15-split`: where an SD1.5 featurization's device time goes at
    768 px (seeded random bf16 weights): the VAE encoder and the UNet pass
    timed apart by CUDA events at B = 1, 4 and 16, then one B = 16 call
    under torch.profiler, its device time by kernel family."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, REPO)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import (
        featurizer as F)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.ops import _build
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    tag = f"[{card_line()}]"
    _build.library()
    cfg = F.FEATURIZER_PRESETS[SD15]()
    params = F.FeaturizerParams(cfg, BF16_PRECISION, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SD_SEED)
    init_weights(params, gen)
    params.prompt_embeds.normal_(generator=gen)
    px1 = torch.from_numpy(_sd_image(np.random.RandomState(SD_SEED),
                                     cfg.img_size))[None].to(dev)
    for b in (1, 4, C_BATCH):
        px = px1.expand(b, -1, -1, -1).contiguous()
        with torch.no_grad():
            noisy = F._noisy_latents(params, cfg, px, None,
                                     deterministic=True)
            ctx = params.prompt_embeds.expand(b, -1, -1)
            vae_ms = cuda_ms(lambda: params.vae(px), iters=3, warmup=1)
            unet_ms = cuda_ms(lambda: params.backbone(noisy, cfg.t, ctx),
                              iters=3, warmup=1)
        all_ms = cuda_ms(lambda: F.extract_features(params, cfg, px,
                                                    deterministic=True),
                         iters=3, warmup=1)
        print(f"{tag} SD1.5 featurizer B={b}: whole {all_ms:.2f} ms "
              f"({b / all_ms * 1e3:.2f} images/s), VAE encoder "
              f"{vae_ms:.2f} ms, UNet through up block 0 {unet_ms:.2f} ms")
    families = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        F.extract_features(params, cfg, px, deterministic=True)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        low = e.name.lower()
        if "flash_fwd" in low:
            fam = "kernel 2 (UNet attention)"
        elif "group_norm" in low or "groupnorm" in low:
            fam = "GroupNorm"
        elif any(x in low for x in ("conv", "fprop", "implicit", "cudnn",
                                    "winograd")):
            fam = "convolution (cuDNN)"
        elif any(x in low for x in ("gemm", "gemv", "cutlass", "xmma",
                                    "nvjet", "cublas")):
            fam = "matmul (cuBLAS)"
        elif "softmax" in low:
            fam = "softmax (VAE attention)"
        elif "memcpy" in low or "memset" in low:
            fam = "copies and memsets"
        else:
            fam = "elementwise, reductions, casts"
        families[fam] = families.get(fam, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy = sum(families.values())
    if busy == 0.0:
        print(f"{tag} SD1.5 featurizer profile: no device time recorded")
        return 0
    print(f"{tag} SD1.5 featurizer B={C_BATCH}, one call under "
          f"torch.profiler: wall {wall_ms:.2f} ms, device busy {busy:.2f} "
          f"ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}: " + ", ".join(
              f"{fam} {ms:.2f} ms ({ms / busy:.1%})"
              for fam, ms in sorted(families.items(), key=lambda kv: -kv[1])))
    return 0


def run_law_chain(tag: str, dev, counters, tower_c: dict) -> tuple:
    """Phase 6: benchmark eval -> embedding dump -> A score -> C score ->
    AC policy at full LLaVA-1.5-7B width through the port's entry points.
    `tower_c`: the diffusion towers' C scores of phases 11 and 12 by their
    names in the AC table, which join the fit's C column. Returns the
    launches of the law chain up to the A score and those of the C-score
    leg, each counted from 0."""
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
        reset_counts(counters)
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
        after_dump = read_counts(counters)

        t0 = time.perf_counter()
        results = runner.run_evaluation(
            RunConfig.from_dict(reps[target]), list(tasks.values()),
            device=dev, limit=LAW_EVAL_LIMIT, log_samples=True)
        torch.cuda.synchronize(dev)
        eval_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        after_eval = read_counts(counters)

        t0 = time.perf_counter()
        scores = a_score_run.compute_a_scores(
            base, [target, "clip336", "not_dumped"], n_images=LAW_IMAGES,
            device=dev)
        torch.cuda.synchronize(dev)
        a_score_s = time.perf_counter() - t0
        launches = read_counts(counters)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        # ---------------------------------------------------------------

        # the C score: its own main path, counted from 0 inside
        c_results, c_launches = run_c_score_leg(tag, dev, counters, tmp,
                                                reps)
        torch.cuda.reset_peak_memory_stats(dev)

        # made-up benchmark scores plus these A and C scores -> one policy
        # fit; the C column holds the three reps' C scores and the
        # diffusion towers' of phases 11 and 12 (PCK@0.10 per image, the
        # paper's 'corres')
        prng = np.random.default_rng(0)
        n_models = len(policy.ALL_MODELS)
        a_col = prng.random(n_models)
        a_col[policy.ALL_MODELS.index("CLIP336")] = scores["clip336"]
        a_col[policy.ALL_MODELS.index("DINOv2")] = scores[target]
        c_col = prng.random(n_models)
        for model, rep in (("CLIP336", "clip336"), ("CLIP224", "clip224"),
                           ("DINOv2", target)):
            c_col[policy.ALL_MODELS.index(model)] = \
                c_results[rep]["per_img"][0]
        for model, c in tower_c.items():
            c_col[policy.ALL_MODELS.index(model)] = c
        table = policy.ACTable(
            models=list(policy.ALL_MODELS),
            perf={b: 2 * a_col ** 2 + a_col * c_col + 0.5 * c_col
                  + 0.05 * prng.standard_normal(n_models)
                  for b in policy.BENCHMARKS},
            a={b: a_col for b in policy.BENCHMARKS}, c=c_col)
        fit = policy.fit_policy(table, "mme")

        print(f"{tag} law chain launches {launches} (after the three "
              f"embedding dumps {after_dump}; after the eval {after_eval})")
        if launches["a_score"] != 4 or launches["a_score_wgmma"] != 4:
            fail(f"kernel 9 launched {launches['a_score']} times in "
                 f"compute_a_scores ({launches['a_score_wgmma']} through its "
                 f"wgmma body), not 4 (two reps x two anchors, fp32)")
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
              f"A scores and the C scores of CLIP336, CLIP224 and DINOv2 ("
              + ", ".join(f"{c_results[r]['per_img'][0]:.4f}"
                          for r in ("clip336", "clip224", target))
              + ") and of " + ", ".join(f"{m} {c:.4f}"
                                        for m, c in tower_c.items())
              + f": r2 {fit.r2:.4f}, mse {fit.mse:.5f}")
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
    return launches, c_launches


def time_tower(root: str) -> int:
    """`python3 chip_smoke.py --tower-of ROOT`: the CLIP-L/14-336 tower (23
    blocks, seeded random bf16 weights) of the port found in ROOT, a
    checkout such as a parent commit unpacked by `git archive`, at B=4 and
    B=1: images/s by the host clock around synchronised runs (as phase 4
    times it), and the host time of one kernel-1 launch (launches back to
    back at B=1 S=257, no graph); each the median of 7 trials, with their
    range. Run it for two roots in turns to compare them on one card;
    prints one JSON line."""
    import torch
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        BF16_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        init_weights)
    from law_of_vision_representation_in_mllms_torch.models.vit import (
        ViTTower, clip_l14)
    from law_of_vision_representation_in_mllms_torch.ops import (
        encoder_attention as enc)
    if not os.path.abspath(enc.__file__).startswith(root + os.sep):
        fail(f"the port was imported from {enc.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    tower = ViTTower(clip_l14(336), -2, "patch", BF16_PRECISION, device=dev)
    with torch.no_grad():
        init_weights(tower, torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)

    def trials(fn, reps: int) -> list:
        fn()
        torch.cuda.synchronize(dev)
        seconds = []
        for _ in range(7):
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(dev)
            seconds.append((time.perf_counter() - t) / reps)
        return seconds

    out = {"root": root, "card": card_line()}
    with torch.inference_mode():
        for b in (4, 1):
            pixels = torch.randn(b, 336, 336, 3, generator=g, device=dev)
            rates = [b / t for t in trials(lambda: tower(pixels), 10)]
            out[f"images_s_b{b}"] = statistics.median(rates)
            out[f"images_s_b{b}_range"] = [min(rates), max(rates)]
        q, k, v = (torch.randn(1, 257, 16, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        us = [t * 1e6 for t in trials(lambda: enc.encoder_attention(q, k, v),
                                      500)]
        out["launch_host_us"] = statistics.median(us)
        out["launch_host_us_range"] = [min(us), max(us)]
    print(json.dumps(out))
    return 0


def time_a_score(root: str) -> int:
    """`python3 chip_smoke.py --a-score-of ROOT`: kernel 9 of the port found
    in ROOT (a checkout such as a parent commit unpacked by `git archive`)
    at N=100, St=576, D=4096: fp32 against Sa=576 and 256, bf16 and fp16
    against Sa=576, each the median of 5 timings of 10 launches (CUDA
    events), with their range, and a hash of the scores' bits (inputs from
    one seed, so two roots see the same data). Run it for two roots in turns
    to compare them on one card; prints one JSON line."""
    import torch
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from law_of_vision_representation_in_mllms_torch.ops import a_score as A
    if not os.path.abspath(A.__file__).startswith(root + os.sep):
        fail(f"the port was imported from {A.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(2)
    out = {"root": root, "card": card_line()}
    target = torch.randn(LAW_IMAGES, 576, 4096, generator=g, device=dev)
    for dtype, sa in ((torch.float32, 576), (torch.float32, 256),
                      (torch.bfloat16, 576), (torch.float16, 576)):
        t = target.to(dtype)
        a = torch.randn(LAW_IMAGES, sa, 4096, generator=g,
                        device=dev).to(dtype)
        scores = A.max_cos(t, a)
        ms = [cuda_ms(lambda: A.max_cos(t, a), iters=10, warmup=1)
              for _ in range(5)]
        key = f"{str(dtype).split('.')[-1]}_sa{sa}_ms"
        out[key] = statistics.median(ms)
        out[key + "_range"] = [min(ms), max(ms)]
        # the scores' bits, to compare with another root's
        out[key[:-3] + "_sha256"] = hashlib.sha256(
            scores.cpu().numpy().tobytes()).hexdigest()
        del t, a
    print(json.dumps(out))
    return 0


def time_decode_of(root: str) -> int:
    """`python3 chip_smoke.py --decode-of ROOT`: kernel 3 of the port found
    in ROOT (a checkout such as a parent commit unpacked by `git archive`),
    cold (caches in turn, as `time_decode` times phase 2), at phase 2's
    shapes: dense and int8 at B=4 T=704 H=KV=32 Dh=128 with holes and a
    masked 128-slot tile, int8 at GQA KV=8; every slot visible at B=1 and
    B=4, T=704, and at B=4 T=2,048, both branches. Each the median of 5
    timings under a CUDA graph, with their range, and the max abs error
    against the plain version; and the host time of one launch (launches
    back to back, no graph; median of 5 runs of 500). Inputs come from one
    seed, so two roots see the same data. Run it for two roots in turns to
    compare them on one card; prints one JSON line."""
    import torch
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from law_of_vision_representation_in_mllms_torch.ops import (
        decode_attention as dec, quant as Q)
    if not os.path.abspath(dec.__file__).startswith(root + os.sep):
        fail(f"the port was imported from {dec.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=torch.bfloat16)

    out = {"root": root, "card": card_line()}
    h, d = 32, 128
    for label, b, t, kvh, holes, int8 in (
            ("dense_holes", 4, 704, 32, True, False),
            ("int8_holes", 4, 704, 32, True, True),
            ("int8_gqa8_holes", 4, 704, 8, True, True),
            ("dense_b4_t704", 4, 704, 32, False, False),
            ("int8_b4_t704", 4, 704, 32, False, True),
            ("dense_b1_t704", 1, 704, 32, False, False),
            ("int8_b1_t704", 1, 704, 32, False, True),
            ("dense_b4_t2048", 4, 2048, 32, False, False),
            ("int8_b4_t2048", 4, 2048, 32, False, True)):
        q = randn(b, 1, h, d)
        mask = torch.ones((b, t), dtype=torch.bool, device=dev)
        if holes:
            mask = torch.rand(b, t, generator=g, device=dev) < 0.8
            mask[:, 256:384] = False
            mask[:, 0] = True

        def make():
            k, v = randn(b, t, kvh, d), randn(b, t, kvh, d)
            if not int8:
                return k, v
            (kc, ks), (vc, vs) = Q.quantize_kv(k), Q.quantize_kv(v)
            return kc, vc, ks, vs

        def call(c, fn=dec.decode_attention):
            return fn(q, c[0], c[1], mask, *c[2:])
        caches = rotating(make, 2 * b * t * kvh * (d + 4 if int8 else 2 * d))
        turn = itertools.cycle(caches)
        out[label + "_err"] = max_err(
            call(caches[0]), call(caches[0], dec.decode_attention_plain))
        ms = [graph_ms(lambda: call(next(turn))) for _ in range(5)]
        out[label + "_ms"] = statistics.median(ms)
        out[label + "_ms_range"] = [min(ms), max(ms)]
        del caches, turn
        if label == "dense_b4_t704":
            k = v = randn(b, t, kvh, d)
            us = []
            for _ in range(5):
                dec.decode_attention(q, k, v, mask)
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                for _ in range(500):
                    dec.decode_attention(q, k, v, mask)
                us.append((time.perf_counter() - t0) / 500 * 1e6)
                torch.cuda.synchronize(dev)
            out["launch_host_us"] = statistics.median(us)
            out["launch_host_us_range"] = [min(us), max(us)]
    print(json.dumps(out))
    return 0


# kernel 10's decode shapes for `--int4-of`: the 7B decoder's four weights
# and the K = 1,004 one-scale weight of phase 2, at every M of a decode batch
INT4_OF_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                  (1004, 4096))
INT4_OF_M = (1, 4, 8, 16)


def time_decode_layer(matmul, g, dev) -> list:
    """Five timings (ms, under a CUDA graph) of a decoder layer's seven
    launches of kernel 10 at M = 4 in the order of a decode step
    (`models/llama.py`), a PyTorch elementwise op standing in for what runs
    between them there (RMSNorm, RoPE, the cache write and attention, the
    residual, SiLU, the product: no launch of kernel 10 follows another),
    over 8 layers' seeded weights in turn. `matmul(x, leaf)` is the
    launch."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import quant as Q
    shapes = {"wq": (4096, 4096), "wk": (4096, 4096), "wv": (4096, 4096),
              "wo": (4096, 4096), "gate": (4096, 11008),
              "up": (4096, 11008), "down": (11008, 4096)}
    layers = [{name: Q.quantize_int4(torch.randn(
        (do, di), generator=g, device=dev) * 0.02)
        for name, (di, do) in shapes.items()} for _ in range(8)]
    h = torch.randn((4, 4096), generator=g, device=dev, dtype=torch.bfloat16)
    turn = itertools.cycle(layers)

    def layer():
        w = next(turn)
        x = h * 1.0
        q = matmul(x, w["wq"]) * 1.0
        k = matmul(x, w["wk"]) * 1.0
        a = matmul(x, w["wv"]) + q + k
        x2 = matmul(a, w["wo"]) + h
        gate = torch.nn.functional.silu(matmul(x2, w["gate"]))
        return matmul(gate * matmul(x2, w["up"]), w["down"])
    return [graph_ms(layer, launches=16, replays=10) for _ in range(5)]


def time_int4_of(root: str) -> int:
    """`python3 chip_smoke.py --int4-of ROOT`: kernel 10 of the port found in
    ROOT (a checkout such as a parent commit unpacked by `git archive`) at a
    decode step's M (INT4_OF_M) at the 7B decoder's four weight shapes and
    at K = 1,004 with one scale a channel (its words zero-padded to 1,024, x
    padded once outside the timing); group 128 elsewhere. First, what a
    decode step sees: a decoder layer's seven launches at M = 4 in a decode
    step's order with a PyTorch elementwise op between each (no launch of
    kernel 10 follows another there), over 8 layers' weights in turn
    (`layer_m4_ms`). Then each case: the median of 5 timings of a launch
    followed by an elementwise op on x, less the op alone (`after_op_ms`,
    as in the step), and of launches back to back (`ms`: where ROOT's
    launcher uses programmatic dependent launch, a launch overlaps the end
    of the one before it, which no decode step has), each under a CUDA
    graph over rotating weights (cold L2, as `rotating` makes them) with
    their range; the bound (packed words, scales, x and out once each at
    3.35 TB/s), the max abs error against the plain version and the split
    the launcher took where ROOT's port reports one; and the host time of
    one eager launch at M = 4, 4096 -> 4096 (tensor-map encodes included;
    median of 5 runs of 500 back to back). Inputs come from one seed, so
    two roots see the same data. Run it for two roots in turns to compare
    them on one card; prints one JSON line."""
    import torch
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from law_of_vision_representation_in_mllms_torch.ops import (
        int4_matmul as K, quant as Q)
    if not os.path.abspath(K.__file__).startswith(root + os.sep):
        fail(f"the port was imported from {K.__file__}, not from {root}")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(10)
    out = {"root": root, "card": card_line()}
    ms = time_decode_layer(lambda a, leaf: K.int4_matmul_kernel(
        a, leaf["q4"], leaf["scale"]), g, dev)
    out["layer_m4_ms"] = statistics.median(ms)
    out["layer_m4_ms_range"] = [min(ms), max(ms)]
    print(f"a decode layer's 7 launches at M = 4 with elementwise ops "
          f"between: {out['layer_m4_ms']:.4f} ms {out['layer_m4_ms_range']}",
          flush=True)
    for di, do in INT4_OF_SHAPES:
        groups = di // 128 if di % 128 == 0 else 1
        stored = Q.stored_width(di, groups)
        wbytes = do * stored // 2 + groups * do * 4

        def make():
            w = torch.randn((do, di), generator=g, device=dev) * 0.02
            return Q.quantize_int4(w, group_size=di // groups)
        leaves = rotating(make, wbytes)
        first, turn = leaves[0], itertools.cycle(leaves)
        for m in INT4_OF_M:
            x = Q.pad_groups(torch.randn((m, di), generator=g, device=dev,
                                         dtype=torch.bfloat16), groups,
                             stored)

            def call(leaf, fn=K.int4_matmul_kernel):
                return fn(x, leaf["q4"], leaf["scale"])
            key = f"m{m}_{di}_{do}"
            got = call(first)
            out[key + "_err"] = max_err(got, call(first, K.int4_matmul_plain))
            split = getattr(K, "last_small_split", None)
            out[key + "_split"] = split() if split else None
            op = [graph_ms(lambda: x * 1.0) for _ in range(5)]
            after = [graph_ms(lambda: (call(next(turn)), x * 1.0))
                     - statistics.median(op) for _ in range(5)]
            out[key + "_after_op_ms"] = statistics.median(after)
            out[key + "_after_op_ms_range"] = [min(after), max(after)]
            ms = [graph_ms(lambda: call(next(turn))) for _ in range(5)]
            out[key + "_ms"] = statistics.median(ms)
            out[key + "_ms_range"] = [min(ms), max(ms)]
            out[key + "_bound_ms"] = bound(
                wbytes + x.numel() * 2 + m * do * 2, 2.0 * m * di * do,
                H100_BF16_TFLOPS)["bound_ms"]
            if (m, di, do) == (4, 4096, 4096):
                us = []
                for _ in range(5):
                    call(first)
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    for _ in range(500):
                        call(first)
                    us.append((time.perf_counter() - t0) / 500 * 1e6)
                    torch.cuda.synchronize(dev)
                out["launch_host_us"] = statistics.median(us)
                out["launch_host_us_range"] = [min(us), max(us)]
            print(f"{key}: after an op {out[key + '_after_op_ms']:.4f} ms "
                  f"{out[key + '_after_op_ms_range']}, back to back "
                  f"{out[key + '_ms']:.4f} ms {out[key + '_ms_range']}"
                  f", bound {out[key + '_bound_ms']:.4f}, err "
                  f"{out[key + '_err']:.3e}, split {out[key + '_split']}",
                  flush=True)
        del leaves, turn, first
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


# text edits of csrc/a_score.cu that make kernel 9's wgmma body into what
# bounds it: one TF32 product a k8 step (hi hi: the one-pass design and what
# accuracy costs), one accumulator for all of D (what the per-stage partial
# sums buy), no products (the split, loads and barriers alone), no anchor
# split (products on unsplit data)
A_PRODUCTS = ("        wgmma_tf32<N>(part, hi[ks], dl, ks > 0);\n",
              "        wgmma_tf32<N>(part, lo[ks], dh, 1);\n",
              "        wgmma_tf32<N>(part, hi[ks], dh, 1);\n")
A_VARIANTS = {
    "one_pass": [(A_PRODUCTS[0], ""), (A_PRODUCTS[1], ""),
                 (A_PRODUCTS[2], A_PRODUCTS[2].replace(", 1);",
                                                       ", ks > 0);"))],
    "one_accumulator": [
        (A_PRODUCTS[0], A_PRODUCTS[0].replace("ks > 0", "ks > 0 || it > 0")),
        ("      for (int i = 0; i < N / 2; ++i) acc[i] += part[i];",
         "      for (int i = 0; i < N / 2; ++i) acc[i] = part[i];")],
    "no_products": [(p, "") for p in A_PRODUCTS],
    "no_split": [("    if (r < rows) {\n      const int off",
                  "    if (r < 0) {\n      const int off")],
}


def a_score_variants() -> int:
    """`python3 chip_smoke.py --a-score-variants`: kernel 9's wgmma body
    against text-edited copies of it (A_VARIANTS), each built into a library
    of its own and called through the same C entry point, in turns (base,
    the variants, the variants backwards, base) at N=100, St=576, D=4096
    against Sa=576 and 256; each variant's max abs error against the plain
    version on towers' structured data, and against 1 with target = anchor.
    Prints one JSON line."""
    import ctypes
    import torch
    sys.path.insert(0, REPO)
    from law_of_vision_representation_in_mllms_torch.ops import _build
    from law_of_vision_representation_in_mllms_torch.ops import a_score as A
    source = (_build.CSRC_DIR / "a_score.cu").read_text()
    dev = torch.device("cuda", 0)

    def build(name: str, tmp: str) -> str:
        text = source
        for old, new in A_VARIANTS.get(name, []):
            if old not in text:
                fail(f"variant {name}: csrc/a_score.cu no longer holds "
                     f"{old.strip()!r}")
            text = text.replace(old, new)
        src, lib = os.path.join(tmp, f"{name}.cu"), os.path.join(
            tmp, f"lib{name}.so")
        with open(src, "w") as f:
            f.write(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC_DIR), "-shared", "-o", lib, src],
                       check=True, capture_output=True, timeout=900)
        return lib

    out = {"card": card_line()}
    with tempfile.TemporaryDirectory() as tmp:
        names = ["base", *A_VARIANTS]
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            libs = dict(zip(names, pool.map(lambda n: build(n, tmp), names)))
        fns = {}
        for name, path in libs.items():
            fn = ctypes.CDLL(path).lvr_a_score_tf32
            fn.argtypes = list(_build._SIGNATURES["lvr_a_score_tf32"])
            fns[name] = fn

        def call(name, t, a):
            n, st, d = t.shape
            sa = a.shape[1]
            row_max = torch.empty((n, -(-sa // A.TF32_TILE), st), device=dev)
            res = torch.empty(n, device=dev)
            err = fns[name](t.data_ptr(), a.data_ptr(), None, None,
                            row_max.data_ptr(), res.data_ptr(), n, st, sa, d,
                            _build.stream_handle(dev))
            if err:
                fail(f"variant {name}: CUDA error {err}")
            return res

        for sa in (576, 256):
            t, a = structured(16, 576, sa, 4096, 3, dev)
            ref = A.a_score_plain(t, a)
            for name in names:
                out[f"{name}_sa{sa}_err"] = max_err(call(name, t, a), ref)
        for name in names:                   # target = anchor: 1.0
            out[f"{name}_self_err"] = max_err(call(name, t, t.clone()),
                                              torch.ones(16, device=dev))
        g = torch.Generator(device=dev).manual_seed(2)
        t = torch.randn(LAW_IMAGES, 576, 4096, generator=g, device=dev)
        for sa in (576, 256):
            a = torch.randn(LAW_IMAGES, sa, 4096, generator=g, device=dev)
            for name in names + names[::-1]:
                out.setdefault(f"{name}_sa{sa}_ms", []).append(
                    cuda_ms(lambda: call(name, t, a), iters=10))
    for key, v in out.items():
        print(f"{key}: {v}")
    print(json.dumps(out))
    return 0


def compare_sass(root: str) -> int:
    """`python3 chip_smoke.py --sass-of ROOT`: every csrc/*.cu of the port in
    ROOT and of this checkout compiled with the library's flags, and each
    kernel's SASS (`cuobjdump -sass`) compared by function (names with the
    file's anonymous-namespace hash taken out, blanks collapsed). Prints,
    for each source, the kernels that are identical, differ, or are only on
    one side; one JSON line."""
    import re
    sys.path.insert(0, REPO)
    from law_of_vision_representation_in_mllms_torch.ops import _build
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    roots = {"this": REPO, "other": os.path.abspath(root)}

    def sass_of(src: str, tmp: str) -> dict:
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-c", "-o", obj, src],
                       check=True, capture_output=True, timeout=900)
        text = subprocess.run([cuobjdump, "-sass", obj], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
        funcs, name = {}, None
        for line in text.splitlines():
            line = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", line)
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                funcs[name] = []
            elif name and "/*" in line:
                # cuobjdump pads columns to the file's widest instruction
                funcs[name].append(" ".join(line.split()))
        return funcs

    out = {"this": REPO, "other": roots["other"], "sources": {}}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            for side, base in roots.items():
                for src in sorted(os.listdir(os.path.join(base, PKG,
                                                          "csrc"))):
                    if src.endswith(".cu"):
                        os.makedirs(os.path.join(tmp, side), exist_ok=True)
                        jobs[side, src] = pool.submit(
                            sass_of, os.path.join(base, PKG, "csrc", src),
                            os.path.join(tmp, side))
        for src in sorted({s for _, s in jobs}):
            a = jobs["this", src].result() if ("this", src) in jobs else {}
            b = jobs["other", src].result() if ("other", src) in jobs else {}
            same = sorted(k for k in a if k in b and a[k] == b[k])
            diff = sorted(k for k in a if k in b and a[k] != b[k])
            out["sources"][src] = {
                "identical": len(same), "differ": diff,
                "only_this": sorted(set(a) - set(b)),
                "only_other": sorted(set(b) - set(a))}
            print(f"{src}: {len(same)} kernels with identical SASS, differ "
                  f"{diff}, only here {sorted(set(a) - set(b))}, only in "
                  f"{root} {sorted(set(b) - set(a))}")
            for k in diff:
                first = next((x, y) for x, y in zip(a[k] + [""], b[k] + [""])
                             if x != y)
                print(f"  {k}: {len(a[k])} / {len(b[k])} lines; first "
                      f"difference {first}")
    print(json.dumps(out))
    return 0


# phase 17: parallelism on one card. (a) the narrow model's sharded steps on
# a one-rank NCCL mesh; (b) full stage 2 at B = FULL_BATCH with the AdamW
# moments in pinned host memory; (c) the same with the parameters there
# too; (d) offload against none at full width, PAR_SHORT_LAYERS layers
PAR_NARROW_STEPS = 3
PAR_FULL_STEPS = 2
PAR_SHORT_LAYERS = 4
PAR_LR = 2e-5                   # `finetune.sh`'s rate
PAR_LINK_CHUNKS = 4             # 4 GiB of pinned chunks time the host link
# (a): a one-rank all-reduce returns its input and the one-rank step runs the
# ops of the step without a process group in their order, so the numbers
# should be the same bits; the bound leaves room for a collective that rounds
PAR_REL_TOL = 1e-6
CARD_GB = 80.0


def par_narrow_batches(dev, n: int):
    """Phase 3b's narrow batch (B = 4, 40 tokens, right-padded), `n` draws."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.models.splice import (
        IGNORE_INDEX, IMAGE_TOKEN_INDEX)
    out = []
    for seed in range(n):
        rng = np.random.RandomState(10 + seed)
        b, t = 4, 40
        ids = rng.randint(3, 1000, size=(b, t)).astype(np.int64)
        ids[:, 1] = IMAGE_TOKEN_INDEX
        labels = ids.copy()
        labels[:, :2] = IGNORE_INDEX
        mask = np.ones((b, t), bool)
        for r in range(1, b):
            mask[r, t - 6 * r:] = False
            labels[r, t - 6 * r:] = IGNORE_INDEX
        px = rng.randn(b, 336, 336, 3).astype(np.float32)
        out.append({"input_ids": torch.from_numpy(ids).to(dev),
                    "labels": torch.from_numpy(labels).to(dev),
                    "text_mask": torch.from_numpy(mask).to(dev),
                    "pixel_values": [torch.from_numpy(px).to(dev)]})
    return out


def pinned_blocks(opt) -> list:
    """The pinned host blocks of an offloading optimizer: its moments' and
    its parameters'."""
    off = getattr(opt, "param_offload", None)
    return [h for h in (getattr(opt, "host", None),
                        off.host if off is not None else None)
            if h is not None]


def release_offload(opt) -> None:
    """Unpin and drop what an offloading optimizer holds on the host."""
    blocks = pinned_blocks(opt)
    if getattr(opt, "param_offload", None) is not None:
        opt.param_offload.release()
    for h in blocks:
        h.release()


def check_parallel_narrow(tag: str, dev) -> None:
    """Phase 17 (a): the narrow stage-1 LLaVA, PAR_NARROW_STEPS steps on a
    mesh of one NCCL rank (started by `parallel.init_distributed`; every
    collective of the step runs) with zero 0, zero 2 with the moments
    offloaded and zero 3 with both offloads, against the step without a
    process group (`init_train_state`, zero 0, resident) from the same
    weights: losses, grad norms and every parameter."""
    import socket
    import torch
    import torch.distributed as dist
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.parallel import (
        init_distributed, make_mesh)
    from law_of_vision_representation_in_mllms_torch.train import (
        train_step as TS)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not init_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda"):
        fail("phase 17 (a): a process group already existed")
    try:
        if dist.get_backend() != "nccl":
            fail(f"phase 17 (a): the card's group runs "
                 f"{dist.get_backend()}, not nccl")
        mesh = make_mesh(n_data=1, n_model=1)
        if set(mesh.groups) != {"data", "model"}:
            fail(f"phase 17 (a): mesh groups {sorted(mesh.groups)}")
        cfg = narrow_config()
        init = M.init_params(torch.Generator(device=dev).manual_seed(5), cfg,
                             DEFAULT_PRECISION, dev).state_dict()
        batches = par_narrow_batches(dev, PAR_NARROW_STEPS)
        tc = TS.TrainConfig(stage=1, learning_rate=1e-2, warmup_ratio=0.0,
                            total_steps=10, use_flash=True, remat=True)

        def run(opts):
            params = M.LlavaParams(cfg, DEFAULT_PRECISION, device=dev)
            params.load_state_dict(init)
            if opts is None:
                state, opt = TS.init_train_state(params, tc)
                step = TS.make_train_step(cfg, tc, opt)
            else:
                state, opt = TS.init_sharded_train_state(
                    params, tc, cfg, mesh, min_size=0, **opts)
                step = TS.make_train_step(cfg, tc, opt, mesh=mesh)
            metrics = []
            for b in batches:
                _, m = step(state, b)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            with TS.whole_params(params, opt):
                sd = {k: v.detach().clone()
                      for k, v in params.state_dict().items()}
            release_offload(opt)
            return metrics, sd

        ref_m, ref_sd = run(None)
        scale = max(v.abs().max().item() for v in ref_sd.values())
        for opts in ({"zero": 0}, {"zero": 2, "offload_opt_state": True},
                     {"zero": 3, "offload_opt_state": True,
                      "offload_params": True}):
            got_m, got_sd = run(opts)
            d_metric = max(abs(a - b) / abs(b) for g, r in zip(got_m, ref_m)
                           for a, b in zip(g, r))
            d_param = max((got_sd[k].float() - v.float()).abs().max().item()
                          for k, v in ref_sd.items())
            print(f"{tag} phase 17 (a) narrow stage 1 on one NCCL rank, "
                  f"{opts}: {PAR_NARROW_STEPS} steps, losses "
                  + " ".join(f"{m[0]:.6f}" for m in got_m)
                  + f"; largest relative loss / grad-norm difference from "
                  f"the step without a group {d_metric:.3e}, largest "
                  f"parameter "
                  f"difference {d_param:.3e} (tolerance {PAR_REL_TOL:g} "
                  f"relative; of max|p| {scale:.3f})")
            if d_metric > PAR_REL_TOL or d_param > PAR_REL_TOL * scale:
                fail(f"phase 17 (a) {opts}: the sharded step parts from "
                     f"the step without a group")
    finally:
        dist.destroy_process_group()


def mem_total_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024 / 1e9
    fail("no MemTotal in /proc/meminfo")


def par_stage2(tmp: str, dev, layers=None):
    """LLaVA-1.5-7B for stage 2 (`runner.build_model` from the seed, fp32
    weights, bf16 compute; `layers` cuts the decoder's depth), its
    TrainConfig (block remat, the flash route) and one batch of FULL_BATCH
    records through the stage-2 template."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION)
    from law_of_vision_representation_in_mllms_torch.data import (
        SupervisedDataset, collate_batch, get_template)
    from law_of_vision_representation_in_mllms_torch.train import (
        runner, train_step as TS)

    path = os.path.join(tmp, "data.json")
    if not os.path.exists(path):
        _training_records(tmp, FULL_BATCH)
    model = {"decoder_layers": layers} if layers else {}
    cfg = RunConfig.from_dict({"model": model, "train": {
        "stage": 2, "batch_size": FULL_BATCH, "learning_rate": PAR_LR,
        "gradient_checkpointing": True}, "data": {"data_path": path,
                                                 "image_folder": tmp}})
    model_cfg, params = runner.build_model(cfg, device=dev,
                                           precision=DEFAULT_PRECISION)
    ds = SupervisedDataset(path, tmp, model_cfg.tower_spec,
                           get_template(cfg.model.conv_template),
                           runner.build_tokenizer(cfg),
                           max_length=cfg.train.max_length)
    batch = runner.batch_to_device(collate_batch(
        [ds[i] for i in range(FULL_BATCH)], max_length=cfg.train.max_length),
        dev)
    tcfg = TS.TrainConfig(stage=2, learning_rate=PAR_LR, warmup_ratio=0.0,
                          total_steps=10, remat=True, use_flash=True)
    torch.cuda.synchronize(dev)
    return model_cfg, params, tcfg, batch


def par_steps(dev, step, state, opt, batch, n: int) -> tuple:
    """`n` steps: per step (host ms to a synchronise, optimizer-pass ms by
    CUDA events, metrics)."""
    import torch
    spans = []
    inner = opt.step

    def timed(*a, **k):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        inner(*a, **k)
        e1.record()
        spans.append((e0, e1))
    opt.step = timed
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        out.append([(time.perf_counter() - t0) * 1e3, None,
                    {k: float(m[k]) for k in ("loss", "grad_norm",
                                              "skipped_nonfinite")}])
    opt.step = inner
    for row, (e0, e1) in zip(out, spans):
        row[1] = e0.elapsed_time(e1)
    return out


def host_link(chunks: list, dev) -> dict:
    """GB/s of pinned host memory to the card, back, and both at once (half
    the bytes each way on two streams), over `chunks` (pinned uint8 tensors
    of the moments). What goes back is what came in: the chunks keep their
    bytes."""
    import torch
    nbytes = sum(c.numel() for c in chunks)
    bufs = [torch.empty_like(c, device=dev) for c in chunks]

    def timed(fn) -> float:
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1)

    def h2d(pairs):
        for c, b in pairs:
            b.copy_(c, non_blocking=True)

    def d2h(pairs):
        for c, b in pairs:
            c.copy_(b, non_blocking=True)

    pairs = list(zip(chunks, bufs))
    h2d(pairs)                                       # warm-up
    t_in = timed(lambda: h2d(pairs))
    t_out = timed(lambda: d2h(pairs))
    half = len(pairs) // 2
    s_in, s_out = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def both():
        s_in.wait_stream(torch.cuda.current_stream(dev))
        s_out.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s_in):
            h2d(pairs[:half])
        with torch.cuda.stream(s_out):
            d2h(pairs[half:])
        torch.cuda.current_stream(dev).wait_stream(s_in)
        torch.cuda.current_stream(dev).wait_stream(s_out)
    t_both = timed(both)
    return {"gb": nbytes / 1e9, "h2d": nbytes / t_in / 1e6,
            "d2h": nbytes / t_out / 1e6, "both": nbytes / t_both / 1e6}


def run_parallel(tag: str, dev, counters) -> dict:
    """Phase 17: (a) `check_parallel_narrow`; (b) full stage 2 of
    LLaVA-1.5-7B at B = FULL_BATCH (S = 703 spliced) with
    `offload_opt_state`, PAR_FULL_STEPS steps through
    `init_sharded_train_state` / `make_train_step`: step ms with the
    moments' copy ms apart, peak GB (< 80), pinned host GB, MemTotal, finite
    losses, the frozen tower bitwise unchanged, the kernels' launches; (c)
    the same model and moments with its parameters offloaded too (2 more
    steps): the device GB held between steps; (d) at PAR_SHORT_LAYERS decoder layers, both offloads against
    none from the same seed: every parameter after PAR_FULL_STEPS steps.
    Returns (b)'s launches."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.parallel import (
        fsdp, make_mesh)
    from law_of_vision_representation_in_mllms_torch.train import (
        train_step as TS)

    t_phase = time.perf_counter()
    check_parallel_narrow(tag, dev)
    t_a = time.perf_counter() - t_phase
    mesh = make_mesh(world_size=1)
    mem_gb = mem_total_gb()
    with tempfile.TemporaryDirectory(prefix="lvr_smoke_parallel_") as tmp:
        t0 = time.perf_counter()
        model_cfg, params, tcfg, batch = par_stage2(tmp, dev)
        seq = batch["input_ids"].shape[1] + model_cfg.num_patches - 1
        tower = {k: v.cpu() for k, v in params.towers.state_dict().items()}
        t1 = time.perf_counter()
        state, opt = TS.init_sharded_train_state(
            params, tcfg, model_cfg, mesh, zero=0, offload_opt_state=True)
        step = TS.make_train_step(model_cfg, tcfg, opt, mesh=mesh)
        torch.cuda.synchronize(dev)
        set_up = {"b": t1 - t0, "pin b": time.perf_counter() - t1}
        # (b), then (c): the same model and moments with its parameters
        # offloaded too (what `init_sharded_train_state(offload_params=
        # True)` attaches)
        for part in ("b", "c"):
            if part == "c":
                t1 = time.perf_counter()
                opt.param_offload = fsdp.ParamOffload(params, dev)
                torch.cuda.synchronize(dev)
                set_up["pin c"] = time.perf_counter() - t1
            opt.copy_events = []
            torch.cuda.reset_peak_memory_stats(dev)
            if part == "b":
                reset_counts(counters)
            rows = par_steps(dev, step, state, opt, batch, PAR_FULL_STEPS)
            if part == "b":
                launches = read_counts(counters)
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            held = torch.cuda.memory_allocated(dev) / 1e9
            copy = opt.copy_ms()
            moved = opt.moment_bytes()
            n_train = sum(p.numel() for _, p in opt.named_params)
            pinned = sum(h.nbytes for h in pinned_blocks(opt)) / 1e9
            losses = [r[2]["loss"] for r in rows]
            offloads = "the moments" + (" and the parameters"
                                        if part == "c" else "")
            print(f"{tag} phase 17 ({part}) LLaVA-1.5-7B full stage 2, "
                  f"{offloads} in pinned host memory: {n_train / 1e9:.3f} B "
                  f"trainable of "
                  f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f} "
                  f"B, B={FULL_BATCH} S={seq}, fp32 weights and moments, "
                  f"bf16 compute, block remat, flash route; set-up "
                  + ", ".join(f"{k} {v:.1f} s" for k, v in set_up.items()))
            print(f"{tag} phase 17 ({part}) steps "
                  + "; ".join(f"{r[0]:.1f} ms (optimizer pass {r[1]:.1f} ms)"
                              for r in rows)
                  + f"; moments {moved / 1e9:.2f} GB each way a step: "
                  f"copies host-to-device {copy['h2d']:.1f} ms, "
                  f"device-to-host {copy['d2h']:.1f} ms over "
                  f"{PAR_FULL_STEPS} steps ("
                  f"{PAR_FULL_STEPS * moved / max(copy['h2d'], 1e-9) / 1e6:.1f}"
                  f" / "
                  f"{PAR_FULL_STEPS * moved / max(copy['d2h'], 1e-9) / 1e6:.1f}"
                  f" GB/s); losses "
                  + " ".join(f"{x:.5f}" for x in losses)
                  + "; grad norms "
                  + " ".join(f"{r[2]['grad_norm']:.4g}" for r in rows))
            print(f"{tag} phase 17 ({part}) peak allocated {peak:.2f} GB "
                  f"(the card {CARD_GB:.0f}); held between steps "
                  f"{held:.2f} GB; pinned host {pinned:.2f} GB of MemTotal "
                  f"{mem_gb:.2f} GB")
            if part == "b":
                print(f"{tag} phase 17 (b) launches {launches}")
                link = host_link(opt.host.chunks[:PAR_LINK_CHUNKS], dev)
                print(f"{tag} phase 17 (b) the host link over "
                      f"{link['gb']:.2f} GB of the pinned moments: to the "
                      f"card {link['h2d']:.1f} GB/s, back {link['d2h']:.1f} "
                      f"GB/s, both ways at once {link['both']:.1f} GB/s in "
                      f"all")
            if not all(np.isfinite(x) for x in losses) or any(
                    r[2]["skipped_nonfinite"] for r in rows):
                fail(f"phase 17 ({part}): a loss is not finite or a step "
                     f"was skipped")
            if peak >= CARD_GB:
                fail(f"phase 17 ({part}): peak {peak:.2f} GB is not under "
                     f"{CARD_GB:.0f}")
            if copy["h2d"] <= 0 or copy["d2h"] <= 0:
                fail(f"phase 17 ({part}): no moment copy was timed")
            if part == "c" and held > 1.0:
                fail(f"phase 17 (c): {held:.2f} GB held on the card between "
                     f"steps with the parameters offloaded")
        opt.param_offload.to_device()
        for k, v in params.towers.state_dict().items():
            if not torch.equal(v.cpu(), tower[k]):
                fail(f"phase 17 (b, c): the frozen tower's {k} changed")
        print(f"{tag} phase 17 (b, c) the frozen tower is bitwise unchanged "
              f"after {2 * PAR_FULL_STEPS} steps")
        release_offload(opt)
        del params, state, opt, step, batch, tower
        gc.collect()
        torch.cuda.empty_cache()
        per_step = {"encoder_attention": 23, "flash_attention": 64,
                    "flash_attention_bwd_dq": 32, "flash_attention_bwd_dkv": 32}
        for name, n in per_step.items():
            if launches[name] != n * PAR_FULL_STEPS:
                fail(f"phase 17 (b): {name} launched {launches[name]} times "
                     f"in {PAR_FULL_STEPS} steps, not {n} a step")
        # (d): offloaded against resident, the same seed, short depth
        finals = []
        for opts in ({}, {"offload_opt_state": True,
                          "offload_params": True}):
            model_cfg, params, tcfg, batch = par_stage2(
                tmp, dev, layers=PAR_SHORT_LAYERS)
            state, opt = TS.init_sharded_train_state(
                params, tcfg, model_cfg, mesh, zero=0, **opts)
            step = TS.make_train_step(model_cfg, tcfg, opt, mesh=mesh)
            rows = par_steps(dev, step, state, opt, batch, PAR_FULL_STEPS)
            if opt.param_offload is not None:
                opt.param_offload.to_device()
            finals.append(({k: v.detach().cpu() for k, v in
                            params.state_dict().items()}, rows))
            release_offload(opt)
            del params, state, opt, step, batch
            gc.collect()
            torch.cuda.empty_cache()
        (a_sd, a_rows), (b_sd, b_rows) = finals
        scale = max(v.abs().max().item() for v in a_sd.values())
        diff = max((b_sd[k] - v).abs().max().item() for k, v in a_sd.items())
        print(f"{tag} phase 17 (d) LLaVA-1.5-7B width, {PAR_SHORT_LAYERS} "
              f"layers, {PAR_FULL_STEPS} stage-2 steps: resident "
              + ", ".join(f"{r[0]:.1f} ms" for r in a_rows)
              + "; both offloads " + ", ".join(f"{r[0]:.1f} ms"
                                                for r in b_rows)
              + f"; losses {[r[2]['loss'] for r in a_rows]} / "
              f"{[r[2]['loss'] for r in b_rows]}; largest parameter "
              f"difference {diff:.3e} (tolerance {PAR_REL_TOL:g} of max|p| "
              f"{scale:.3f})")
        if diff > PAR_REL_TOL * scale:
            fail("phase 17 (d): the offloaded run's parameters part from "
                 "the resident run's")
    print(f"{tag} phase 17 took {time.perf_counter() - t_phase:.1f} s "
          f"((a) {t_a:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 18: context and pipeline parallelism on one card (the card machine
# has one H100, so no NCCL ring or stage hand-off crosses cards here; the
# multi-rank numbers are the CPU tests' gloo worlds). (a) the flash ring
# (`ops/ring_attention.py`) over a `LocalRing` of RING_N ranks in this
# process at LLaVA-1.5-7B's decoder width against kernels 2, 5 and 6 over
# the whole sequence; (b) the GPipe schedule (`parallel/pipeline.py`) of
# PP_STAGES stages through `LocalHandoff` at phase 5's stage-1
# shape against the unpipelined loss
RING_B, RING_S, RING_N, RING_H, RING_D = 2, 4096, 4, 32, 128
RING_VALID = 3500               # row 1's valid tokens (right-padded)
RING_KV = (32, 8)               # MHA, and GQA of 4 query heads a kv head
RING_BLOCKS = RING_N * (RING_N + 1) // 2    # causal: the diagonal and below
# a ring's dq, dk and dv are sums of up to RING_N partials that kernels 5
# and 6 each round to bf16 (the whole-sequence kernels and the plain ring
# round once or never), so a row whose partials cancel in part carries up to
# RING_N / 2 times a kernel's rounding of its largest partial: gradient rows
# are held to twice KERNEL_REL_TOL, every tensor to KERNEL_REL_TOL of its max
RING_GRAD_ROW_TOL = 2 * KERNEL_REL_TOL
PP_STAGES, PP_MICRO = 4, 4
# (b): the pipelined step runs the same per-row math as the unpipelined one
# on 4 microbatches of B / 4 rows; cuBLAS may take other algorithms (other
# fp32 summation orders) for the smaller products, and every activation is
# rounded to bf16, so one ulp (2^-8 .. 2^-7 relative) may part a value: the
# loss within PP_LOSS_TOL relative, each gradient within KERNEL_REL_TOL of
# its max|unpipelined|
PP_LOSS_TOL = 1e-3


def ring_shards(x, n: int, grad: bool = False) -> list:
    """x [B, S, ...]'s n sequence shards, each a contiguous tensor of its
    own (a rank's), leaves that take a gradient with `grad`."""
    return [p.contiguous().requires_grad_(grad) for p in x.chunk(n, dim=1)]


def flash_ring(R, qs, ks, vs, dos) -> tuple:
    """`ring_attention(flash=True)` over a `LocalRing` of len(qs) ranks,
    each rank's shards given: the forward (`RingFlashAttention.apply`) and
    its backward for the ranks' dO. Returns the outputs, the merged LSEs
    the Function keeps for its backward, and the ranks' (dq, dk, dv)."""
    import torch
    outs = R.ring_attention(qs, ks, vs, ring=R.LocalRing(len(qs)),
                            causal=True, flash=True)
    lses = outs[0].grad_fn.saved_tensors[4 * len(qs):]
    grads = torch.autograd.grad(outs, qs + ks + vs, dos)
    n = len(qs)
    return ([o.detach() for o in outs], list(lses), grads[:n],
            grads[n:2 * n], grads[2 * n:])


def plain_ring_slice(R, q, k, v, do, mask, n: int, kv: int):
    """The plain ring (the JAX formula, fp32, the key mask rotating with
    its block) over a `LocalRing` of n ranks for kv head `kv` and its query
    heads, with its q / k / v gradients by autograd: (out, dq, dk, dv)."""
    import torch
    g = q.shape[2] // k.shape[2]
    qh = q[:, :, kv * g:(kv + 1) * g].float().requires_grad_()
    kh = k[:, :, kv:kv + 1].float().requires_grad_()
    vh = v[:, :, kv:kv + 1].float().requires_grad_()
    out = torch.cat(R.ring_attention(
        qh.chunk(n, 1), kh.chunk(n, 1), vh.chunk(n, 1), ring=R.LocalRing(n),
        causal=True, kv_masks=mask.chunk(n, 1)), 1)
    grads = torch.autograd.grad(out, (qh, kh, vh),
                                do[:, :, kv * g:(kv + 1) * g].float())
    return (out.detach(), *grads)


def check_ring(tag: str, dev, counters) -> dict:
    """Phase 18 (a): the flash ring (`ring_attention` over a `LocalRing`,
    i.e. `RingFlashAttention`) of RING_N ranks of RING_S / RING_N tokens at
    B = RING_B, H = RING_H, D = RING_D, bf16, row 1 valid to RING_VALID,
    MHA and GQA: out, the merged LSE, dq, dk, dv against kernel 2 causal
    and kernels 5 + 6 over the whole sequence (every row: both take no key
    mask), one kv head against the plain ring at valid rows, the launches
    and the ring's ms against the whole sequence's. Returns the launches of
    the counted ring runs."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        flash_attention as fl, ring_attention as R)
    gen = torch.Generator(device=dev).manual_seed(18)
    mask = torch.ones(RING_B, RING_S, dtype=torch.bool, device=dev)
    mask[1, RING_VALID:] = False
    total = {name: 0 for name in counters}
    for kvh in RING_KV:
        def randn(h):
            return torch.randn((RING_B, RING_S, h, RING_D), generator=gen,
                               device=dev, dtype=torch.bfloat16)
        q, k, v = randn(RING_H), randn(kvh), randn(kvh)
        # the ignored labels of pad rows give them no gradient
        do = randn(RING_H) * mask[:, :, None, None]
        qs, ks, vs = (ring_shards(x, RING_N, grad=True) for x in (q, k, v))
        dos = ring_shards(do, RING_N)
        what = (f"ring of {RING_N} x {RING_S // RING_N} (B={RING_B} "
                f"S={RING_S} H={RING_H} KV={kvh} D={RING_D})")
        reset_counts(counters)
        outs, lses, dq, dk, dv = flash_ring(R, qs, ks, vs, dos)
        torch.cuda.synchronize(dev)
        launches = read_counts(counters)
        got = (torch.cat(outs, 1), torch.cat(lses, 2),
               *(torch.cat(x, 1) for x in (dq, dk, dv)))
        for name in total:
            total[name] += launches[name]
        for name in ("flash_attention", "flash_attention_bwd_dq",
                     "flash_attention_bwd_dkv"):
            if launches[name] != RING_BLOCKS:
                fail(f"phase 18 (a) {what}: {name} launched "
                     f"{launches[name]} times, not {RING_BLOCKS}")
        out_w, lse_w = fl.flash_attention(q, k, v, causal=True,
                                          return_lse=True)
        whole = (out_w, lse_w, *fl.flash_attention_bwd(
            q, k, v, out_w, lse_w, do, causal=True))
        errs = {}
        for name, g_t, w_t in zip(("out", "lse", "dq", "dk", "dv"), got,
                                  whole):
            err = max_err(g_t, w_t)
            if name == "lse":
                tol, rows = LSE_TOL, 0.0
            else:
                tol = kernel_tol(w_t)
                rows = (row_err if name == "out" else grad_row_err)(g_t, w_t)
            row_tol = RING_GRAD_ROW_TOL if name[0] == "d" else \
                KERNEL_REL_TOL
            errs[name] = (err, tol, rows)
            if not (err <= tol and rows <= row_tol):
                fail(f"phase 18 (a) {what}: the ring's {name} parts from "
                     f"the whole sequence's kernels by {err} (tol {tol}), "
                     f"worst row {rows} (tol {row_tol})")
        # one kv head against the plain ring (fp32, masked) at valid rows
        plain = plain_ring_slice(R, q, k, v, do, mask, RING_N, 0)
        g = RING_H // kvh
        sl = (got[0][:, :, :g], got[2][:, :, :g], got[3][:, :, :1],
              got[4][:, :, :1])
        plain_errs = {}
        for name, g_t, p_t in zip(("out", "dq", "dk", "dv"), sl, plain):
            if name in ("out", "dq"):
                g_t, p_t = g_t[mask], p_t[mask]
            err, tol = max_err(g_t, p_t), kernel_tol(p_t)
            rows = (row_err if name == "out" else grad_row_err)(g_t, p_t)
            row_tol = RING_GRAD_ROW_TOL if name[0] == "d" else \
                KERNEL_REL_TOL
            plain_errs[name] = (err, tol, rows)
            if not (err <= tol and rows <= row_tol):
                fail(f"phase 18 (a) {what}: kv head 0's {name} parts from "
                     f"the plain ring by {err} (tol {tol}), worst row "
                     f"{rows} (tol {row_tol})")
        ring_ms = cuda_ms(lambda: flash_ring(R, qs, ks, vs, dos), iters=5,
                          warmup=1)

        def ring_forward():
            with torch.no_grad():
                R.ring_attention(qs, ks, vs, ring=R.LocalRing(RING_N),
                                 causal=True, flash=True)
        ring_fwd_ms = cuda_ms(ring_forward, iters=5, warmup=1)

        def whole_call():
            o, lse = fl.flash_attention(q, k, v, causal=True,
                                        return_lse=True)
            fl.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        whole_ms = cuda_ms(whole_call, iters=5, warmup=1)
        whole_fwd_ms = cuda_ms(lambda: fl.flash_attention(
            q, k, v, causal=True, return_lse=True), iters=5, warmup=1)
        print(f"{tag} phase 18 (a) {what}: launches kernel 2 / 5 / 6 "
              f"{launches['flash_attention']} / "
              f"{launches['flash_attention_bwd_dq']} / "
              f"{launches['flash_attention_bwd_dkv']} over the {RING_N} "
              f"ranks; against the whole sequence's kernels: " + ", ".join(
                  f"{n} {e[0]:.3g} (tol {e[1]:.3g}, worst row {e[2]:.3g})"
                  for n, e in errs.items())
              + "; kv head 0 against the plain ring at valid rows: "
              + ", ".join(f"{n} {e[0]:.3g} (tol {e[1]:.3g}, worst row "
                          f"{e[2]:.3g})" for n, e in plain_errs.items()))
        print(f"{tag} phase 18 (a) {what}: RingFlashAttention forward + "
              f"backward over a LocalRing of {RING_N} ({RING_BLOCKS} blocks "
              f"a kernel, the merges, the fp32 sums, autograd) "
              f"{ring_ms:.4f} ms against {whole_ms:.4f} ms for kernel 2 + "
              f"kernels 5 and 6 over the whole sequence "
              f"({ring_ms / whole_ms:.2f}x); the forward alone "
              f"{ring_fwd_ms:.4f} ms against kernel 2's {whole_fwd_ms:.4f} "
              f"ms ({ring_fwd_ms / whole_fwd_ms:.2f}x)")
        del q, k, v, do, qs, ks, vs, dos, outs, lses, dq, dk, dv, got, \
            whole, plain
    return total


def check_gpipe(tag: str, dev, counters, params, model_cfg, batch,
                phase: str = "18 (b)", loss_tol: float = PP_LOSS_TOL,
                kernel10: bool = False) -> dict:
    """Phase 18 (b): `llava.loss_fn(pp=...)`, PP_STAGES stages of
    L / PP_STAGES layers over PP_MICRO microbatches through `LocalHandoff`,
    block remat and the flash route, against the unpipelined `loss_fn` on
    the same weights and batch: the loss and the gradients of the projector
    and of each stage's first layer (which require a gradient for this
    check only), the launches of kernels 2, 5 and 6 and both step times.
    Returns the pipelined run's launches (its main path). Phase 19 (b) runs
    it on a quantised decoder (`kernel10`): each stage's layers and the
    head run kernel 10 forward and `int4_matmul_dx` backward, and every
    kernel of the step runs PP_MICRO times as often pipelined as not (one
    launch a microbatch where the unpipelined step has one)."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.parallel import (
        make_mesh)
    from law_of_vision_representation_in_mllms_torch.parallel.pipeline import (
        LocalHandoff, PipelineParallel)
    t_phase = time.perf_counter()
    dec = params.decoder
    per = model_cfg.decoder.num_layers // PP_STAGES
    firsts = [dec.layers[k * per] for k in range(PP_STAGES)]
    # stage 1's trainables and the checked layers take a gradient here
    flags = [(p, p.requires_grad) for p in params.parameters()]
    params.projector.requires_grad_(True)
    for blk in firsts:
        blk.requires_grad_(True)
    named = [(f"projector.{n}", p) for n, p in
             params.projector.named_parameters()]
    for k, blk in enumerate(firsts):
        named += [(f"decoder.layers.{k * per}.{n}", p)
                  for n, p in blk.named_parameters()]
    wanted = [p for _, p in named]
    pp = PipelineParallel(make_mesh(n_stage=PP_STAGES, world_size=PP_STAGES),
                          microbatches=PP_MICRO,
                          handoff=LocalHandoff(PP_STAGES))
    try:
        def step(pipe):
            loss = M.loss_fn(params, model_cfg, batch, remat=True,
                             use_flash=True, pp=pipe)
            return loss.detach(), torch.autograd.grad(loss, wanted)
        results, launches, times = {}, {}, {}
        for label, pipe in (("unpipelined", None), ("pipelined", pp)):
            reset_counts(counters)
            t0 = time.perf_counter()
            results[label] = step(pipe)
            torch.cuda.synchronize(dev)
            times[label] = [(time.perf_counter() - t0) * 1e3]
            launches[label] = read_counts(counters)
        for label, pipe in (("unpipelined", None), ("pipelined", pp)):
            t0 = time.perf_counter()
            step(pipe)
            torch.cuda.synchronize(dev)
            times[label].append((time.perf_counter() - t0) * 1e3)
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
    (l0, g0), (l1, g1) = results["unpipelined"], results["pipelined"]
    loss_err = abs(float(l1) - float(l0)) / abs(float(l0))
    worst = max(((max_err(a, b) / max(b.float().abs().max().item(), 1e-30),
                  n) for (n, _), a, b in zip(named, g1, g0)))
    b = batch["input_ids"].shape[0]
    what = "int4 decoder" if kernel10 else "LLaVA-1.5-7B"
    print(f"{tag} phase {phase} {what} stage 1 at B={b}, GPipe of "
          f"{PP_STAGES} stages x {per} layers, {PP_MICRO} microbatches, "
          f"block remat, flash route: loss {float(l1):.6f} against "
          f"{float(l0):.6f} unpipelined (rel {loss_err:.3g}, tol "
          f"{loss_tol}); the gradients of the projector and of layers "
          f"{[k * per for k in range(PP_STAGES)]} (all their leaves): worst "
          f"{worst[0]:.3g} of max|unpipelined| at {worst[1]} (tol "
          f"{KERNEL_REL_TOL})")
    k10 = ("int4_matmul", "int4_matmul_dx") if kernel10 else ()
    for label in ("unpipelined", "pipelined"):
        n = launches[label]
        print(f"{tag} phase {phase} {label}: kernel 1 / 2 / 5 / 6 launches "
              f"{n['encoder_attention']} / {n['flash_attention']} / "
              f"{n['flash_attention_bwd_dq']} / "
              f"{n['flash_attention_bwd_dkv']} (kernel 2: forward and block "
              f"remat's recompute)"
              + "".join(f", {k} {n[k]}" for k in k10)
              + "; loss and gradients "
              + " / ".join(f"{t:.1f}" for t in times[label])
              + " ms (first, second call)")
    if not (torch.isfinite(l1) and loss_err <= loss_tol):
        fail(f"phase {phase}: the pipelined loss {float(l1)} parts from the "
             f"unpipelined {float(l0)} by {loss_err} (tol {loss_tol})")
    if not worst[0] <= KERNEL_REL_TOL:
        fail(f"phase {phase}: the pipelined gradient of {worst[1]} parts "
             f"from the unpipelined by {worst[0]} of its max (tol "
             f"{KERNEL_REL_TOL})")
    n_layers = model_cfg.decoder.num_layers
    want = {"flash_attention": 2 * PP_MICRO * n_layers,
            "flash_attention_bwd_dq": PP_MICRO * n_layers,
            "flash_attention_bwd_dkv": PP_MICRO * n_layers}
    want.update({k: PP_MICRO * launches["unpipelined"][k] for k in k10})
    for name, n in want.items():
        if launches["pipelined"][name] != n or not n:
            fail(f"phase {phase}: {name} launched "
                 f"{launches['pipelined'][name]} times in the pipelined "
                 f"step, not {n}")
    if launches["pipelined"]["encoder_attention"] != \
            launches["unpipelined"]["encoder_attention"]:
        fail(f"phase {phase}: the pipelined step ran the tower another "
             f"number of times than the unpipelined one")
    del results, g0, g1
    print(f"{tag} phase {phase} took {time.perf_counter() - t_phase:.1f} s")
    return launches["pipelined"]


def full_stage1(dev, tmp: str, layers=None, quantize_bits=None):
    """Phase 5's model and first batch (for `--context-pipeline`; phase 19
    (b) cuts the decoder to `layers` and quantises it): (LlavaConfig,
    LlavaParams, batch on the card)."""
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION)
    from law_of_vision_representation_in_mllms_torch.data import (
        SupervisedDataset, collate_batch, get_template)
    from law_of_vision_representation_in_mllms_torch.train import runner
    cfg = RunConfig.from_dict({
        "model": {"decoder_layers": layers},
        "train": {"stage": 1, "batch_size": FULL_BATCH},
        "data": {"data_path": _training_records(tmp, FULL_BATCH),
                 "image_folder": tmp}})
    model_cfg, params = runner.build_model(cfg, device=dev,
                                           precision=DEFAULT_PRECISION,
                                           quantize_bits=quantize_bits)
    ds = SupervisedDataset(cfg.data.data_path, cfg.data.image_folder,
                           model_cfg.tower_spec, get_template("plain"),
                           runner.build_tokenizer(cfg),
                           pad_square=cfg.data.image_aspect_ratio == "pad",
                           max_length=cfg.train.max_length)
    batch = runner.batch_to_device(collate_batch(
        [ds[i] for i in range(FULL_BATCH)],
        max_length=cfg.train.max_length), dev)
    return model_cfg, params, batch


def context_pipeline_only() -> int:
    """`--context-pipeline`: the build and phase 18 alone (phase 5's model
    built here for (b))."""
    import torch
    sys.path.insert(0, REPO)
    from law_of_vision_representation_in_mllms_torch.ops import (
        _build, encoder_attention as enc, flash_attention as fl)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"{tag} kernels built in {time.perf_counter() - t0:.1f} s")
    counters = {name: (wrapper, "launches") for name, wrapper in (
        ("encoder_attention", enc.encoder_attention),
        ("flash_attention", fl.flash_attention),
        ("flash_attention_bwd_dq", fl.flash_attention_bwd_dq),
        ("flash_attention_bwd_dkv", fl.flash_attention_bwd_dkv))}
    t0 = time.perf_counter()
    check_ring(tag, dev, counters)
    print(f"{tag} phase 18 (a) took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="lvr_smoke_pp_") as tmp:
        model_cfg, params, batch = full_stage1(dev, tmp)
        check_gpipe(tag, dev, counters, params, model_cfg, batch)
    print(card)
    return 0


# phase 19: the variants' tensor and pipeline parallelism, and the orbax
# reader. (a) kernel 10 and its transposed form at a model rank's slices of
# Vicuna-7B's products (n_model 2 and 4) at QLoRA's M = 16 x 703: column
# slices (out channels) of wq / wk / wv, gate / up and lm_head, row slices
# (contraction) of wo and down; down over 4 ranks cuts 11,008 into 2,752
# rows a rank, 21.5 groups of 128, which `quant.row_slice` pads to 22
# groups of 2,816 (`QuantDense` places x among the padding)
TP_M = 16 * 703
TP_SHAPES = tuple(
    (n, name, kind) for n in (2, 4) for name, kind in (
        ("wq", "column"), ("gate", "column"), ("lm_head", "column"),
        ("wo", "row"), ("down", "row")))
# (b): a quantised decoder of TP_PIPE_LAYERS layers (4 stages of 2) at full
# width: the same per-row math pipelined or not, so the loss within 1e-4
TP_PIPE_LAYERS = 8
TP_PIPE_LOSS_TOL = 1e-4
ORBAX_FIXTURE = os.path.join("tests", "data", "orbax_tiny", "checkpoint-1")
ORBAX_ARRAYS = os.path.join("tests", "data", "orbax_tiny_arrays.npz")
# the fixture's RunConfig (tests/make_orbax_fixture.py FIXTURE_CONFIG)
ORBAX_CONFIG = {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit",
                          "decoder_layers": 1},
                "train": {"bf16": False, "seed": 0}}


def tp_leaf(g, dev, name: str, n: int):
    """(what, QuantDense of rank 1's part, x width) for `name`'s slice over
    `n` model ranks of Vicuna-7B, from a seeded whole weight."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models.layers import (
        QuantDense)
    from law_of_vision_representation_in_mllms_torch.ops import quant as Q
    dims = {"wq": (4096, 4096), "gate": (4096, 11008),
            "lm_head": (4096, 32000), "wo": (4096, 4096),
            "down": (11008, 4096)}
    di, do = dims[name]
    whole = Q.quantize_int4(torch.randn((do, di), generator=g, device=dev)
                            * 0.02)
    module = QuantDense(whole, DEFAULT_PRECISION)
    dim = 1 if name in ("wo", "down") else 0
    # rank 1 of n: its slice, without a process group
    r, c = 1, (di if dim else do) // n
    if dim:
        leaf, x_index = Q.row_slice(whole, r * c, (r + 1) * c, di)
        module.tp, module.whole_scale = (1, None, di), whole["scale"]
    else:
        leaf, x_index = Q.column_slice(whole, r * c, (r + 1) * c), None
    module._set(leaf, x_index)
    k_in = c if dim else di
    return module, k_in


def check_tp_kernel10(tag: str, dev) -> tuple:
    """Phase 19 (a): kernel 10 (through `QuantDense`, which pads x where a
    row slice splits groups) and `int4_matmul_dx` at TP_SHAPES against
    their plain versions, with times, bounds and `torch.matmul` on the
    slice's bf16 weight. Returns the two kernels' cases."""
    import torch
    from law_of_vision_representation_in_mllms_torch.ops import (
        int4_matmul as K, quant as Q)
    g = torch.Generator(device=dev).manual_seed(19)
    cases, dx_cases = [], []
    m = TP_M
    for n, name, kind in TP_SHAPES:
        module, k_in = tp_leaf(g, dev, name, n)
        q4, scale = module.q4, module.scale
        do, di = q4.shape[0], q4.shape[1] * 8
        x = torch.randn((m, k_in), generator=g, device=dev,
                        dtype=torch.bfloat16)
        before = K.int4_matmul_kernel.launches
        got = module(x)
        if K.int4_matmul_kernel.launches != before + 1:
            fail(f"phase 19 (a): {name} over {n} ranks did not launch "
                 f"kernel 10")
        xp = x if module.x_index is None else x.new_zeros(
            (m, di)).index_copy(1, module.x_index, x)

        def plain():
            parts = [K.int4_matmul_plain(rows, q4, scale)
                     for rows in xp.split(2812)]
            return torch.cat(parts)
        ref = plain()
        if not torch.equal(got, module(x)):
            fail(f"phase 19 (a): {name} over {n} ranks gave other bits on a "
                 f"second run")
        dense = Q.dequantize_int4({"q4": q4, "scale": scale}, torch.bfloat16)
        # the bounds count the rank's k_in real contraction rows, not the
        # padding a split group adds (its cost shows as lost efficiency)
        wbytes = do * k_in // 2 + scale.numel() * 4
        pad = ("" if module.x_index is None else
               f", x padded {k_in} -> {di} ({scale.shape[0]} groups)")
        r = dict(err=max_err(got, ref),
                 tol=INT4_REL_TOL * max(1.0, ref.float().abs().max().item()),
                 ms=cuda_ms(lambda: module(x)),
                 plain_ms=cuda_ms(plain, iters=2, warmup=1),
                 library_ms=cuda_ms(lambda: xp @ dense.T),
                 shape=f"TP {n} rank 1, {name} ({kind}): M={m} {k_in}->{do} "
                       f"group 128{pad}, one weight",
                 **bound(wbytes + x.numel() * 2 + m * do * 2,
                         2.0 * m * k_in * do, H100_BF16_TFLOPS))
        report_kernel(tag, "int4_matmul", r)
        cases.append({k: r[k] for k in (
            "shape", "err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")})
        dy = torch.randn((m, do), generator=g, device=dev,
                         dtype=torch.bfloat16)
        got = K.int4_matmul_dx(dy, q4, scale)
        ref = K.int4_matmul_dx_plain(dy, q4, scale)
        if not torch.equal(got, K.int4_matmul_dx(dy, q4, scale)):
            fail(f"phase 19 (a): int4_matmul_dx for {name} over {n} ranks "
                 f"gave other bits on a second run")
        r = dict(err=max_err(got, ref),
                 tol=INT4_REL_TOL * max(1.0, ref.float().abs().max().item()),
                 ms=cuda_ms(lambda: K.int4_matmul_dx(dy, q4, scale)),
                 plain_ms=cuda_ms(lambda: K.int4_matmul_dx_plain(
                     dy, q4, scale), iters=3, warmup=1),
                 library_ms=cuda_ms(lambda: dy @ dense),
                 shape=f"TP {n} rank 1, {name} ({kind}): M={m} dy [M, {do}] "
                       f"@ W [{do}, {di}] group 128, one weight",
                 **bound(wbytes + dy.numel() * 2 + m * k_in * 2,
                         2.0 * m * k_in * do, H100_BF16_TFLOPS))
        report_kernel(tag, "int4_matmul_dx", r)
        dx_cases.append({k: r[k] for k in (
            "shape", "err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")})
        del module, x, xp, dy, got, ref, dense
        gc.collect()
        torch.cuda.empty_cache()
    return cases, dx_cases


# (c): the variants' TP steps in two processes on the one card over gloo
# (NCCL refuses two ranks on one device; gloo stages CUDA tensors through
# the host), against one rank: the narrow LLaVA with a vocabulary of 1,024
# (kernel 10 wants output channels in multiples of 8 a rank) and 640
# intermediate features (a rank's `down` slice is 2.5 int4 groups, padded
# to 3)
TP_GLOO_VARIANTS = (("lora", None), ("qlora", "int4"), ("switch", None))
TP_GLOO_STEPS = 3       # the first step's rate is 0 (warm-up), so 3


def tp_gloo_case(dev, variant: str, quantize_base):
    """(config, params on `dev`, TrainConfig, batch) of a phase 19 (c) case,
    the same on every rank (CPU-seeded weights)."""
    import torch
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        DEFAULT_PRECISION)
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models import (
        lora as LR, switch as SW)
    from law_of_vision_representation_in_mllms_torch.ops import quant as Q
    from law_of_vision_representation_in_mllms_torch.train import (
        train_step as TS)
    cfg = narrow_config(640)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, vocab_size=1024))
    params = M.init_params(torch.Generator().manual_seed(1), cfg,
                           DEFAULT_PRECISION, "cpu")
    extra = dict(stage=2, switch_sigma=1.0)
    if variant != "switch":
        lcfg = LR.LoraConfig(rank=8, alpha=16.0)
        params.lora = LR.init_lora(torch.Generator().manual_seed(2),
                                   cfg.decoder, lcfg, DEFAULT_PRECISION,
                                   "cpu")
        with torch.no_grad():
            g = torch.Generator().manual_seed(3)
            for layer in params.lora.layers:
                for t in layer.targets:
                    getattr(layer, f"{t}_b").normal_(0.0, 0.02, generator=g)
        extra = dict(stage=2, lora_rank=lcfg.rank, lora_alpha=lcfg.alpha)
    else:
        params.switch = SW.init_switch(torch.Generator().manual_seed(2),
                                       cfg.decoder.hidden_size,
                                       DEFAULT_PRECISION, "cpu")
    params = params.to(dev)
    if quantize_base:
        Q.quantize_decoder(params.decoder, bits=4)
    tc = TS.TrainConfig(**dict(dict(
        learning_rate=1e-3, warmup_ratio=0.0, total_steps=10,
        use_flash=True, remat=True), **extra))
    return cfg, params, tc, narrow_batch(dev)


def tp_gloo_steps(dev, variant: str, quantize_base, mesh) -> dict:
    """One case on `mesh` (one rank without groups, or the model axis of
    2): the gradient of every trainable leaf at the start, gathered whole
    over the model ranks, then TP_GLOO_STEPS `make_train_step` steps'
    losses and gradient norms."""
    import torch
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    from law_of_vision_representation_in_mllms_torch.models import (
        switch as SW)
    from law_of_vision_representation_in_mllms_torch.parallel import comm
    from law_of_vision_representation_in_mllms_torch.train import (
        train_step as TS)
    cfg, params, tc, batch = tp_gloo_case(dev, variant, quantize_base)
    state, opt = TS.init_sharded_train_state(params, tc, cfg, mesh, zero=0)
    trainable = [p for _, p in opt.named_params]
    kw = dict(use_flash=True, remat=True, mesh=mesh)
    loss = (SW.switch_loss_fn(params, cfg, batch, tc.switch_sigma, **kw)
            if tc.switch_sigma else
            M.loss_fn(params, cfg, batch, lora_scaling=tc.lora_scaling, **kw))
    grads = {}
    for plan, g in zip(opt.plans, torch.autograd.grad(loss, trainable)):
        if plan.tp_dim is not None:
            g = comm.all_gather(g, plan.tp_dim, mesh.group("model"))
        grads[plan.name] = g.float().cpu()
    step = TS.make_train_step(cfg, tc, opt, mesh=mesh)
    metrics = []
    for _ in range(TP_GLOO_STEPS):
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return {"grads": grads, "metrics": metrics}


def tp_gloo_rank(rank: int, port: int, out: str) -> int:
    """`--tp-gloo-rank RANK PORT OUT`: rank RANK of phase 19 (c)'s gloo
    world of two on cuda:0; writes its cases' results (rank 0) and its
    kernel launches to OUT."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from law_of_vision_representation_in_mllms_torch.ops import (
        encoder_attention as enc, flash_attention as fl, int4_matmul as k10)
    from law_of_vision_representation_in_mllms_torch.parallel import (
        make_mesh)
    torch.backends.cuda.matmul.allow_tf32 = False
    # the card (a CPU run rehearses the ranks' logic)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    counted = {"encoder_attention": enc.encoder_attention,
               "flash_attention": fl.flash_attention,
               "flash_attention_bwd_dq": fl.flash_attention_bwd_dq,
               "flash_attention_bwd_dkv": fl.flash_attention_bwd_dkv,
               "int4_matmul": k10.int4_matmul_kernel,
               "int4_matmul_dx": k10.int4_matmul_dx}
    try:
        mesh = make_mesh(n_model=2)
        results = {v: tp_gloo_steps(dev, v, q, mesh)
                   for v, q in TP_GLOO_VARIANTS}
        torch.save({"results": results if rank == 0 else None,
                    "launches": {k: w.launches for k, w in counted.items()}},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def run_tp_gloo(tag: str, dev, counters) -> dict:
    """Phase 19 (c): the LoRA, QLoRA (int4) and switch TP steps over a
    model axis of 2, in two processes on the card over gloo, against the
    same cases on one rank in this process: every trainable leaf's
    gradient at the start (gathered whole; within TRAIN_GRAD_REL_TOL of the
    one-rank gradient's norm) and each step's loss and gradient norm
    (within TRAIN_LOSS_REL_TOL and TRAIN_GRAD_REL_TOL). Returns the two
    ranks' kernel launches (their main path)."""
    import socket
    import torch
    from law_of_vision_representation_in_mllms_torch.parallel import (
        make_mesh)
    t0 = time.perf_counter()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory(prefix="lvr_smoke_gloo_") as out:
        procs = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--tp-gloo-rank", str(r), str(port), out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=600)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate()[0])
        if any(p.returncode for p in procs):
            fail(f"phase 19 (c): a gloo rank failed:\n"
                 + "\n".join(log[-2000:] for log in logs))
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"))
                 for r in range(2)]
    world_s = time.perf_counter() - t0
    one = make_mesh(world_size=1)
    reset_counts(counters)
    for (variant, q), (name, got) in zip(TP_GLOO_VARIANTS,
                                         ranks[0]["results"].items()):
        want = tp_gloo_steps(dev, variant, q, one)
        if sorted(got["grads"]) != sorted(want["grads"]):
            fail(f"phase 19 (c) {name}: other trainable leaves under TP")
        rel = max((torch.linalg.vector_norm(got["grads"][k] - w)
                   / torch.linalg.vector_norm(w).clamp_min(1e-30)).item()
                  for k, w in want["grads"].items())
        loss_rel = max(abs(a[0] - b[0]) / abs(b[0])
                       for a, b in zip(got["metrics"], want["metrics"]))
        norm_rel = max(abs(a[1] - b[1]) / abs(b[1])
                       for a, b in zip(got["metrics"], want["metrics"]))
        print(f"{tag} phase 19 (c) {name} TP 2 (two processes on the card, "
              f"gloo) against one rank: worst leaf gradient "
              f"{rel:.3g} of its norm (tol {TRAIN_GRAD_REL_TOL}), losses "
              + " / ".join(f"{a[0]:.6f}" for a in got["metrics"])
              + " against " + " / ".join(f"{b[0]:.6f}"
                                          for b in want["metrics"])
              + f" (rel {loss_rel:.3g}, tol {TRAIN_LOSS_REL_TOL}), "
              f"gradient norms rel {norm_rel:.3g}")
        if not (rel <= TRAIN_GRAD_REL_TOL and loss_rel <= TRAIN_LOSS_REL_TOL
                and norm_rel <= TRAIN_GRAD_REL_TOL):
            fail(f"phase 19 (c) {name}: the TP steps part from one rank")
    launches = read_counts(counters)
    for name in launches:
        launches[name] = sum(r["launches"].get(name, 0) for r in ranks)
    print(f"{tag} phase 19 (c) the two ranks' launches: "
          + ", ".join(f"{k} {v}" for k, v in launches.items() if v)
          + f"; the gloo world {world_s:.1f} s, the whole (c) "
          f"{time.perf_counter() - t0:.1f} s")
    for name in ("int4_matmul", "int4_matmul_dx", "flash_attention",
                 "flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        if name in launches and not launches[name]:
            fail(f"phase 19 (c): {name} was not launched by the TP ranks")
    return launches


def check_orbax_reader(tag: str, dev) -> None:
    """Phase 19 (d): the orbax fixture (tests/make_orbax_fixture.py: the
    JAX `save_train_state` of the tiny LLaVA from 4 host devices, with bf16
    and int8 leaves and a step) read on this host: `restore_raw` against
    the arrays saved beside it, bit for bit; `consolidate` against them;
    `build_model(model.checkpoint=...)` on the card, every parameter equal
    to its array; the MB/s of the system's zstd library, through
    `io/zstd.py`, over the fixture's chunk frames."""
    import numpy as np
    import torch
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.core.precision import (
        FP32_PRECISION)
    from law_of_vision_representation_in_mllms_torch.io import (
        delta, from_jax, ocdbt, orbax_state, param_io, zstd)
    from law_of_vision_representation_in_mllms_torch.train import runner
    fixture = os.path.join(REPO, ORBAX_FIXTURE)
    zstd.library()
    want = {}
    param_io._flatten(param_io.load_params(os.path.join(REPO, ORBAX_ARRAYS)),
                      "", want)
    got = {}
    t0 = time.perf_counter()
    param_io._flatten(orbax_state.restore_raw(fixture), "", got)
    read_s = time.perf_counter() - t0
    if sorted(got) != sorted(want) or any(
            got[k].dtype != want[k].dtype or got[k].tobytes()
            != want[k].tobytes() for k in want):
        fail("phase 19 (d): restore_raw of the orbax fixture differs from "
             "its arrays")
    with tempfile.TemporaryDirectory(prefix="lvr_smoke_orbax_") as tmp:
        out = os.path.join(tmp, "flat.npz")
        n = delta.consolidate(fixture, out)
        flat = np.load(out)
        params_want = {k[len("params/"):]: v for k, v in want.items()
                       if k.startswith("params/")}
        if sorted(flat.files) != sorted(params_want) or any(
                flat[k].tobytes() != params_want[k].tobytes()
                for k in flat.files):
            fail("phase 19 (d): consolidate of the orbax fixture differs "
                 "from its params")
    cfg = dict(ORBAX_CONFIG, model=dict(ORBAX_CONFIG["model"],
                                        checkpoint=fixture))
    _, params = runner.build_model(RunConfig.from_dict(cfg), device=dev,
                                   precision=FP32_PRECISION)
    sd = from_jax.llava_state_dict(param_io.load_params(
        os.path.join(REPO, ORBAX_ARRAYS))["params"])
    own = params.state_dict()
    bad = [k for k, v in own.items()
           if v.device.type != "cuda" or not torch.equal(v.cpu(), sd[k])]
    if bad or sorted(own) != sorted(sd):
        fail(f"phase 19 (d): model.checkpoint of the orbax fixture gave "
             f"other parameters: {bad[:3]}")
    frames = [v.read() for k, v in ocdbt.Database(fixture).items().items()
              if not k.endswith(b".zarray")]
    frames = [f for f in frames if f[:4] == b"\x28\xb5\x2f\xfd"]
    sizes = [zstd.decompress(f).size for f in frames]
    reps = 50
    t0 = time.perf_counter()
    for _ in range(reps):
        for f in frames:
            zstd.decompress(f)
    dt = time.perf_counter() - t0
    out_mb = reps * sum(sizes) / 1e6
    print(f"{tag} phase 19 (d) orbax fixture ({len(want)} arrays, "
          f"{len(frames)} zstd chunk frames, {sum(map(len, frames))} bytes "
          f"compressed): restore_raw bit-equal to its arrays in "
          f"{read_s * 1e3:.1f} ms; "
          f"consolidate {n} arrays equal; model.checkpoint -> "
          f"{len(own)} parameters on {dev}, all equal; libzstd via ctypes "
          f"{out_mb / dt:.1f} MB/s of output on this host ({reps} passes, "
          f"{dt * 1e3:.1f} ms, {dt / (reps * len(frames)) * 1e6:.1f} us a "
          f"frame of {sum(sizes) / len(frames) / 1e3:.1f} kB)")


def run_tp_variants(tag: str, dev, counters, kernels=None) -> dict:
    """Phase 19: (a) into `kernels`' int4 cases, (b) the quantised GPipe
    step, (c) the variants' TP steps over gloo, (d) the orbax reader.
    Returns the launches of (b) and of (c) (their main paths)."""
    import torch
    t_phase = time.perf_counter()
    cases, dx_cases = check_tp_kernel10(tag, dev)
    if kernels is not None:
        kernels["int4_matmul"]["cases"] += cases
        kernels["int4_matmul_dx"]["cases"] += dx_cases
        for name in ("int4_matmul", "int4_matmul_dx"):
            kernels[name]["err"] = max(c["err"]
                                       for c in kernels[name]["cases"])
    print(f"{tag} phase 19 (a) took {time.perf_counter() - t_phase:.1f} s")
    with tempfile.TemporaryDirectory(prefix="lvr_smoke_tp_") as tmp:
        model_cfg, params, batch = full_stage1(dev, tmp, TP_PIPE_LAYERS, 4)
        launches = check_gpipe(tag, dev, counters, params, model_cfg, batch,
                               phase="19 (b)", loss_tol=TP_PIPE_LOSS_TOL,
                               kernel10=True)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = run_tp_gloo(tag, dev, counters)
    check_orbax_reader(tag, dev)
    print(f"{tag} phase 19 took {time.perf_counter() - t_phase:.1f} s")
    return launches, tp_launches


def tp_variants_only() -> int:
    """`--tp-variants`: the build and phase 19 alone."""
    import torch
    sys.path.insert(0, REPO)
    from law_of_vision_representation_in_mllms_torch.ops import (
        _build, encoder_attention as enc, flash_attention as fl,
        int4_matmul as k10)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"{tag} kernels built in {time.perf_counter() - t0:.1f} s")
    counters = {name: (wrapper, "launches") for name, wrapper in (
        ("encoder_attention", enc.encoder_attention),
        ("flash_attention", fl.flash_attention),
        ("flash_attention_bwd_dq", fl.flash_attention_bwd_dq),
        ("flash_attention_bwd_dkv", fl.flash_attention_bwd_dkv),
        ("int4_matmul", k10.int4_matmul_kernel),
        ("int4_matmul_dx", k10.int4_matmul_dx))}
    run_tp_variants(tag, dev, counters)
    print(card)
    return 0


def parallel_only() -> int:
    """`--parallel`: the build and phase 17 alone."""
    import torch
    sys.path.insert(0, REPO)
    from law_of_vision_representation_in_mllms_torch.ops import (
        _build, decode_attention as dec, encoder_attention as enc,
        flash_attention as fl, int4_matmul as k10)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    t0 = time.perf_counter()
    _build.build()
    _build.library()
    print(f"{tag} kernels built in {time.perf_counter() - t0:.1f} s")
    counters = {name: (wrapper, "launches") for name, wrapper in (
        ("encoder_attention", enc.encoder_attention),
        ("flash_attention", fl.flash_attention),
        ("decode_attention", dec.decode_attention),
        ("flash_attention_bwd_dq", fl.flash_attention_bwd_dq),
        ("flash_attention_bwd_dkv", fl.flash_attention_bwd_dkv),
        ("int4_matmul", k10.int4_matmul_kernel))}
    run_parallel(tag, dev, counters)
    print(card)
    return 0


def main() -> int:
    import torch
    if sys.argv[1:2] == ["--tp-gloo-rank"] and len(sys.argv) == 5:
        # a rank of phase 19 (c)'s gloo world (on the CPU: a rehearsal)
        return tp_gloo_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: needs an NVIDIA GPU")
    if sys.argv[1:2] == ["--tower-of"] and len(sys.argv) == 3:
        return time_tower(sys.argv[2])
    if sys.argv[1:2] == ["--a-score-of"] and len(sys.argv) == 3:
        return time_a_score(sys.argv[2])
    if sys.argv[1:2] == ["--decode-of"] and len(sys.argv) == 3:
        return time_decode_of(sys.argv[2])
    if sys.argv[1:2] == ["--int4-of"] and len(sys.argv) == 3:
        return time_int4_of(sys.argv[2])
    if sys.argv[1:2] == ["--sass-of"] and len(sys.argv) == 3:
        return compare_sass(sys.argv[2])
    if sys.argv[1:] == ["--a-score-variants"]:
        return a_score_variants()
    if sys.argv[1:] == ["--sd15-split"]:
        return sd15_split()
    if sys.argv[1:] == ["--parallel"]:
        return parallel_only()
    if sys.argv[1:] == ["--context-pipeline"]:
        return context_pipeline_only()
    if sys.argv[1:] == ["--tp-variants"]:
        return tp_variants_only()
    sys.path.insert(0, REPO)
    try:
        from law_of_vision_representation_in_mllms_torch.ops import (
            _build, a_score as asc, decode_attention as dec,
            encoder_attention as enc, flash_attention as fl,
            int4_matmul as k10)
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
    clock = [t_start]

    def mark(what: str) -> None:
        """The seconds since the previous mark."""
        now = time.perf_counter()
        print(f"{tag} {what} took {now - clock[0]:.1f} s")
        clock[0] = now

    t0 = time.perf_counter()
    # the registers and spills of the wgmma kernels (kernel 10, the
    # attention forward of kernels 1 and 2, the backward of kernels 5 and
    # 6), compiled beside the library's build
    ptxas_sources = ("int4_matmul.cu", "flash_attention.cu",
                     "encoder_attention.cu", "flash_attention_bwd.cu",
                     "a_score.cu", "decode_attention.cu")
    with concurrent.futures.ThreadPoolExecutor(len(ptxas_sources)) as pool:
        reports = [pool.submit(_build.ptxas_report, src)
                   for src in ptxas_sources]
        lib_path = _build.build()
        _build.library()
        print(f"{tag} kernels built from {_build.CSRC_DIR.relative_to(REPO)} "
              f"in {time.perf_counter() - t0:.2f} s -> "
              f"{os.path.relpath(lib_path, REPO)}")
        for report in reports:
            print_ptxas(tag, report.result())
    check_sass_tf32(tag, lib_path)
    mark("phase 1 (the build, ptxas, SASS)")

    kernels = check_kernels(tag, dev)
    unet_cases = check_unet_attention(tag, dev)
    text_cases = check_text_attention(tag, dev)
    kernels["flash_attention"]["cases"] += unet_cases + text_cases
    gc.collect()
    torch.cuda.empty_cache()
    kernels.update(check_flash_bwd(tag, dev))
    perceiver_fwd, perceiver_dq, perceiver_dkv = check_perceiver_attention(
        tag, dev)
    kernels["flash_attention"]["cases"] += perceiver_fwd
    kernels["flash_attention_bwd_dq"]["cases"] = [perceiver_dq]
    kernels["flash_attention_bwd_dkv"]["cases"] = [perceiver_dkv]
    kernels.update(check_flash_alibi(tag, dev))
    gc.collect()
    torch.cuda.empty_cache()
    kernels.update(check_a_score(tag, dev))
    kernels.update(check_int4_matmul(tag, dev))
    kernels.update(check_decode_int8(tag, dev))
    check_int8_weight_cost(tag, dev)
    gc.collect()
    torch.cuda.empty_cache()
    check_routes(tag, dev)
    mark("phase 2 (kernels against their plain versions)")
    check_narrow_llava(tag, dev)
    check_narrow_training(tag, dev)
    check_narrow_loglikelihood(tag, dev)
    check_narrow_llava(tag, dev, quantize="int4", kv_quant="int8")
    check_narrow_llava(tag, dev, quantize="int8")
    check_narrow_training(tag, dev, quantize_base="int4")
    check_narrow_mpt(tag, dev)
    for variant in ("perceiver2x", "mof", "keep_saliency", "keep_norm",
                    "anyres"):
        check_narrow_variant(tag, dev, variant)
    check_narrow_training(tag, dev, variant="perceiver")
    check_narrow_training(tag, dev, variant="lora")
    check_narrow_training(tag, dev, quantize_base="int4", variant="lora")
    check_narrow_training(tag, dev, variant="switch")
    check_narrow_geoware(tag, dev)
    mark("phase 3 (narrow models, CUDA against CPU)")
    counters = {name: (wrapper, "launches") for name, wrapper in (
        ("encoder_attention", enc.encoder_attention),
        ("flash_attention", fl.flash_attention),
        ("decode_attention", dec.decode_attention),
        ("flash_attention_bwd_dq", fl.flash_attention_bwd_dq),
        ("flash_attention_bwd_dkv", fl.flash_attention_bwd_dkv),
        ("a_score", asc.max_cos),
        ("decode_attention_int8", dec.decode_attention_int8),
        ("int4_matmul", k10.int4_matmul_kernel),
        ("int4_matmul_dx", k10.int4_matmul_dx))}
    # the launches of kernels 2, 5 and 6 that ran their ALiBi instantiation
    # (a share of the counts above)
    counters.update({name + "_alibi": (wrapper, "alibi_launches")
                     for name, (wrapper, _) in counters.items()
                     if hasattr(wrapper, "alibi_launches")})
    # the launches of kernel 9 that ran its 3xTF32 wgmma body
    counters["a_score_wgmma"] = (asc.max_cos, "wgmma_launches")
    # the serving runs come before any torch.profiler session (phase 5 holds
    # the first): its tracing stays attached to the process afterwards and
    # makes every launch dearer for the host, which is what bounds a decode
    # step
    paths = {}
    paths["serve"], bf16_fig, backends = run_full_width(tag, dev, counters)
    paths.update({f"serve_{k}": v for k, v in backends.items()})
    mark("phase 4 (serving, its backends)")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"{tag} after the serving phase: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB still allocated")
    figs = [bf16_fig]
    for name, model in zip(("serve_int4_kv8", "serve_int8"),
                           SERVING_FORMATS[1:]):
        paths[name], fig, backends = run_full_width(tag, dev, counters,
                                                    model, bf16_fig)
        figs.append(fig)
        paths.update({f"{name}_{k}": v for k, v in backends.items()})
        gc.collect()
        torch.cuda.empty_cache()
    mark("phase 7 (quantised serving)")
    # checkpoint porting (phase 13): the port's own snapshot readers and
    # porters, before phase 11 takes its bundle from `port-featurizer`
    paths.update(run_checkpoint_porting(tag, dev, counters, text_cases))
    mark("phase 13 (checkpoint porting)")
    # the SD1.5 representation at full width (phase 11), also before
    # torch.profiler first runs: it serves through the chunked decoder
    tower_c = {}        # the diffusion towers' C scores, for phase 6's fit
    paths.update(run_diffusion_tower(tag, dev, counters, unet_cases,
                                     tower_c, text_cases))
    mark("phase 11 (SD1.5)")
    # DiT-XL/2 and SD3-medium at full width and cut depth (phase 12), before
    # torch.profiler first runs for the same reason
    paths.update(run_transformer_towers(tag, dev, counters, unet_cases,
                                        tower_c))
    mark("phase 12 (DiT-XL/2, SD3-medium)")
    # GeoAware-SC (phase 16), before torch.profiler first runs
    dino_case = next(c for c in kernels["encoder_attention"]["cases"]
                     if c.get("what") == "GeoAware DINOv2-B@840")
    paths.update(run_geoware(tag, dev, counters, unet_cases, dino_case))
    mark("phase 16 (GeoAware-SC)")
    # MPT-7B and the switch variant, also before torch.profiler first runs;
    # the LoRA and QLoRA variants each end with a profiled step, after their
    # own steps are timed. Every training step here keeps the device busy
    # (idle share ~0.03 in phase 5's split), so the tracing's cost to the
    # host does not show in the later step times
    paths["mpt"] = run_full_width_mpt(tag, dev, counters)
    mark("phase 9 (MPT-7B)")
    for variant in VARIANT_TRAIN:
        paths[f"train_{variant}"] = run_full_width_variant(tag, dev, counters,
                                                           variant)
    mark("phase 10 (training variants)")
    gc.collect()
    torch.cuda.empty_cache()
    paths["train_parallel_offload"] = run_parallel(tag, dev, counters)
    mark("phase 17 (parallelism: one-rank NCCL mesh, ZeRO, host offload, "
         "full stage 2)")
    paths["ring"] = check_ring(tag, dev, counters)
    mark("phase 18 (a) (context parallelism: the flash ring)")
    paths["train"], paths["gpipe"] = run_full_width_training(tag, dev,
                                                             counters)
    mark("phase 5 (stage-1 training) and phase 18 (b) (the GPipe schedule)")
    gc.collect()
    torch.cuda.empty_cache()
    paths["tp_gpipe_int4"], paths["tp_gloo_variants"] = run_tp_variants(
        tag, dev, counters, kernels)
    mark("phase 19 (the variants' TP and pipeline: kernel 10 at a rank's "
         "shapes, a quantised GPipe, gloo on the card, the orbax reader)")
    gc.collect()
    torch.cuda.empty_cache()
    paths["law_chain"], paths["c_score"] = run_law_chain(tag, dev, counters,
                                                         tower_c)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 6 (the law chain, the C-score leg)")
    profile_formats(tag, dev)
    mark("phase 8 (profiled decode)")
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
        # the same `pallas_call` as kernel 3's dense branch: `_kernel` with
        # `quantized=True`
        "decode_attention_int8": f"{TPU_PKG}/ops/decode_attention.py:341",
        "int4_matmul": f"{TPU_PKG}/ops/int4_kernel.py:157",
        # XLA's product in the JAX custom VJP of kernel 10
        "int4_matmul_dx": f"{TPU_PKG}/ops/quant.py:189 (_int4_kernel_mm_bwd, "
                          f"XLA)",
        # the same `pallas_call`s as kernels 2, 5 and 6 with `alibi=True`
        # (`_fwd_lse_kernel`, `_bwd_dq_kernel`, `_bwd_dkv_kernel`)
        "flash_attention_alibi": f"{TPU_PKG}/ops/flash_attention.py:377",
        "flash_attention_bwd_dq_alibi":
            f"{TPU_PKG}/ops/flash_attention.py:473",
        "flash_attention_bwd_dkv_alibi":
            f"{TPU_PKG}/ops/flash_attention.py:508",
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
            f"without ALiBi, tower_attn_impl=flash, and every attention of "
            f"the diffusion towers through flash_mha: the UNets' head "
            f"sizes 40, 80, 160 and 64, DiT-XL/2's 72, SD3's joint 64)"],
        "flash_attention_alibi": [
            f"{TPU_PKG}/ops/flash_attention.py:130 (flash_attention_bhsd "
            f"with alibi_slopes: the same function without the LSE)"],
        "decode_attention": [
            f"{TPU_PKG}/ops/decode_attention.py:190 "
            f"(decode_attention_stacked, decode_attn=pallas_stacked)"],
        "decode_attention_int8": [
            f"{TPU_PKG}/ops/decode_attention.py:190 "
            f"(decode_attention_stacked with ks_all/vs_all, "
            f"decode_attn=pallas_stacked)"],
    }
    sources = {name: f"{PKG}/csrc/{name}.cu" for name in replaces}
    sources["flash_attention_bwd_dq"] = f"{PKG}/csrc/flash_attention_bwd.cu"
    sources["flash_attention_bwd_dkv"] = f"{PKG}/csrc/flash_attention_bwd.cu"
    sources["decode_attention_int8"] = f"{PKG}/csrc/decode_attention.cu"
    sources["int4_matmul_dx"] = f"{PKG}/csrc/int4_matmul.cu"
    sources["flash_attention_alibi"] = f"{PKG}/csrc/flash_attention.cu"
    for name in ("flash_attention_bwd_dq_alibi",
                 "flash_attention_bwd_dkv_alibi"):
        sources[name] = f"{PKG}/csrc/flash_attention_bwd.cu"
    # kernel 3 held to its plain version at the serving paths' shapes
    for fig in figs:
        for case in fig.get("decode_cases", []):
            kernels[case.pop("kernel")].setdefault("path_cases",
                                                   []).append(case)
    # the paths whose decode steps are replayed CUDA graphs: the serving
    # runs' greedy decode (phases 4 and 7), the served wave, speculation and
    # the inflight engine (phase 4c, its server too)
    graph_paths = ("serve", "serve_int4_kv8", "serve_int8", "serve_http",
                   "serve_speculative", "serve_inflight",
                   "serve_inflight_http", "serve_int4_kv8_inflight",
                   "serve_eval_zoo", "serve_variant_perceiver2x",
                   "serve_variant_mof", "serve_variant_visual_keep")
    print(f"{tag} chip_smoke phases took "
          f"{time.perf_counter() - t_start:.1f} s")
    # launches: the serving run (phase 4, its decode replayed CUDA graphs:
    # the launches derived from captures and replays) and its backends
    # (phase 4b), the training run (phase 5), the law chain and its C-score
    # leg (phase 6), the two quantised serving runs (phase 7), MPT-7B
    # (phase 9), the three training variants (phase 10) and phase 17's full
    # stage 2 with the moments offloaded, each counted from 0; the split is
    # in "launches_by_path"
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name], "routes": routes.get(name, []),
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {path: p[name] for path, p in paths.items()},
         "graph_launches": sum(p[name] for path, p in paths.items()
                               if path in graph_paths),
         "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], "shape": r["shape"],
         **{k: r[k] for k in ("cases", "crossover", "noalibi_ms",
                              "whole_ms", "library_backend", "row_err",
                              "fma_bound_ms", "bmm_ms", "body", "warm_ms",
                              "library_warm_ms", "path_cases")
            if k in r},
         **({"wgmma_launches": sum(p["a_score_wgmma"]
                                   for p in paths.values())}
            if name == "a_score" else {})}
        for name, r in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
