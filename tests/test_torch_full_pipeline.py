"""The complete paper workflow on the port, end to end on tiny models on the
CPU (`tests/test_full_pipeline.py` with `device="cpu"`):

for each of 3 vision representations -> stage-1 train (projector) ->
benchmark eval -> A-score embedding dump -> SPair feature extraction ->
C scores; then A scores -> assemble the AC table -> fit the policy.
"""

import os

import numpy as np
import torch
from PIL import Image

from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.data.image_processing import (
    ImageProcessorConfig)
from law_of_vision_representation_in_mllms_torch.eval.runner import (
    run_embed_extraction, run_evaluation)
from law_of_vision_representation_in_mllms_torch.pipeline import (
    compute_a_scores, extract_tower_features, make_vit_extractor, run_c_score)
from law_of_vision_representation_in_mllms_torch.policy import fit_policy
from law_of_vision_representation_in_mllms_torch.policy.data import (
    BENCHMARKS, ACTable)
from law_of_vision_representation_in_mllms_torch.train.runner import (
    build_model, run_training)
from test_full_pipeline import _make_benchmark, _make_training_data
from test_spair import _make_synthetic_spair

torch.set_num_threads(1)

REPS = ["repA", "repB", "repC"]


def _run_config(root, seed, stage1_out):
    return RunConfig.from_dict({
        "model": {"vision_tower": "debug/tiny-vit", "decoder": "tiny"},
        "train": {"stage": 1, "batch_size": 2, "epochs": 1, "bf16": False,
                  "max_length": 64, "output_dir": stage1_out,
                  "save_steps": 1000, "seed": seed},
        "data": {"data_path": f"{root}/train.json",
                 "image_folder": f"{root}/imgs"},
        "parallel": {"n_data": 1, "n_model": 1},
    })


def test_full_paper_pipeline(tmp_path):
    root = str(tmp_path)
    _make_training_data(root)
    task_path = _make_benchmark(root)

    # SPair tree for the C score
    spair = f"{root}/SPair-71k"
    _make_synthetic_spair(spair, n_pairs=3)
    names = {f"img{i}.jpg" for i in range(6)}
    for n in names:
        Image.new("RGB", (64, 48), (30, 60, 90)).save(
            f"{spair}/JPEGImages/cat/{n}")

    bench_scores, c_scores = {}, {}
    emb_base = f"{root}/embeds"

    for seed, rep in enumerate(REPS):
        out = f"{root}/{rep}/stage1"
        cfg = _run_config(root, seed, out)
        # 1. stage-1 training (projector only)
        run = run_training(cfg, device="cpu")
        assert run.state["step"] > 0
        assert os.path.exists(f"{out}/mm_projector.npz")

        # 2. benchmark eval with the stage-1 projector
        cfg.train.pretrain_mm_mlp_adapter = out
        res = run_evaluation(cfg, [task_path], device="cpu")
        bench_scores[rep] = res["tiny_bench"]["value"]

        # 3. A-score embedding dump (first 4 docs)
        n = run_embed_extraction(cfg, task_path, f"{emb_base}/{rep}",
                                 device="cpu", limit=4)
        assert n == 4

        # 4. SPair feature extraction with this rep's tower
        model_cfg, params = build_model(cfg, device="cpu")
        entry = model_cfg.tower_spec.entries[0]
        fn = make_vit_extractor(entry.vit_config, params.towers[0],
                                select_layer=-2, device="cpu")
        proc = ImageProcessorConfig("clip", size=28, crop=28)
        paths = sorted(f"{spair}/JPEGImages/cat/{n}" for n in names)
        written = extract_tower_features(fn, paths, proc,
                                         f"{root}/{rep}/feats", batch_size=4)
        assert len(written) == 6
        c = run_c_score(spair, f"{root}/{rep}/feats", device="cpu",
                        suffix="", num_patches=entry.vit_config.grid,
                        anno_size=64, categories=["cat"], compute_geo=False)
        assert "geo" not in c and 0.0 <= c["per_img"][0] <= 1.0
        c_scores[rep] = 100 * c["per_img"][0]

    # anchors for the A score: reuse two reps' dumps as clip336/clip224
    os.rename(f"{emb_base}/{REPS[0]}", f"{emb_base}/clip336")
    os.rename(f"{emb_base}/{REPS[1]}", f"{emb_base}/clip224")
    os.rename(f"{emb_base}/{REPS[2]}", f"{emb_base}/{REPS[2]}_t")
    scores = compute_a_scores(emb_base, [f"{REPS[2]}_t", "clip336"],
                              n_images=4, device="cpu")
    a_scores = {REPS[0]: scores["clip336"], REPS[1]: scores["clip336"],
                REPS[2]: scores[f"{REPS[2]}_t"]}
    # the rep identical to an anchor aligns more strongly
    assert a_scores[REPS[0]] >= a_scores[REPS[2]] - 1e-6

    # 5. assemble the AC table + fit the policy (single benchmark, padded
    # to the schema with copies)
    perf = {b: np.asarray([bench_scores[r] + 0.01 * i
                           for i, r in enumerate(REPS)])
            for b in BENCHMARKS}
    a = {b: np.asarray([a_scores[r] for r in REPS]) for b in BENCHMARKS}
    table = ACTable(models=list(REPS), perf=perf, a=a,
                    c=np.asarray([c_scores[r] for r in REPS]))
    fit = fit_policy(table, "mme")
    assert np.isfinite(fit.r2)
    pred = fit.predict(np.stack(table.normed("mme")[:2], 1))
    assert pred.shape == (3,)
