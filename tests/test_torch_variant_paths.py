"""The entry points under the projector and token variants, the port against
the JAX package on the CPU in fp32: `model.projector_type=perceiver2x`, an
MoF tower spec (two tiny towers, per-tower projectors, interleaved tokens)
and `model.visual_keep` (CLS-attention saliency; the norm score for
generation too).

Both packages build the tiny LLaVA of one `RunConfig`; the JAX model's
weights go to the port as a `param_io` `.npz` (`model.checkpoint`). Then:
- `generate_until` (what `generate` and `eval` run) on CRC ids, answers
  equal or parted at a near tie of the JAX logits (`test_torch_near_tie`),
  and the `generate` CLI's answer equal to the adapter's;
- `loglikelihood` (the eval harness's other request) within 1e-4 and its
  greedy flags equal; the A-score dump (`extract-embeds`) within 1e-5;
- `serve`, in waves and `--inflight`: concurrent chat completions answer
  as the adapter's `generate_until` does;
- stage-1 `run_training`, step by step against the JAX runner's log, and
  the saved projector loaded back equal to the trained one. The JAX
  runner's own stage-1 save cannot be read back for a perceiver (it keeps
  only `layers`) and raises for MoF (it asks the tower spec for one width):
  the port's is held to its own trained weights.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.eval import (
    runner as jrunner)
from law_of_vision_representation_in_mllms_tpu.eval.api import (
    Instance as JInstance)
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.train import (
    runner as jtrain)
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.eval import (
    runner as trunner)
from law_of_vision_representation_in_mllms_torch.eval.api import Instance
from law_of_vision_representation_in_mllms_torch.io import (
    checkpoint as tckpt)
from law_of_vision_representation_in_mllms_torch.serve import (
    LMMServer, _parse_messages)
from law_of_vision_representation_in_mllms_torch.train import (
    runner as ttrain)

from test_torch_near_tie import check_answers, use_crc_ids
from test_torch_serve import _image_part, _png_b64, _post

torch.set_num_threads(1)

BASE = {"decoder": "tiny", "vision_tower": "debug/tiny-vit"}
VARIANTS = {
    "perceiver2x": {"projector_type": "perceiver2x"},
    "mof": {"vision_tower": "debug/tiny-vit,debug/tiny-vit"},
    "keep_saliency": {"visual_keep": 6, "prune_score": "saliency"},
    "keep_norm": {"visual_keep": 6, "prune_score": "norm"},
}
MAX_NEW = 5


def _model(variant):
    return dict(BASE, **VARIANTS[variant])


@pytest.fixture(scope="module")
def pair(request, tmp_path_factory):
    """(variant, JAX adapter, port adapter, checkpoint .npz)."""
    variant = request.param
    model = _model(variant)
    jlmm = jrunner.build_lmm(JRunConfig.from_dict(
        {"model": model, "train": {"bf16": False}}))
    path = str(tmp_path_factory.mktemp(variant) / "llava.npz")
    jio.save_params(path, jlmm.params)
    lmm = trunner.build_lmm(RunConfig.from_dict(
        {"model": dict(model, checkpoint=path), "train": {"bf16": False}}),
        device="cpu")
    assert lmm.cfg.num_patches == jlmm.cfg.num_patches
    use_crc_ids(jlmm, lmm)
    return variant, jlmm, lmm, path


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 256, (36 + 8 * i, 44, 3),
                                        dtype=np.uint8)) for i in range(n)]


PROMPTS = ("describe the image", "what is shown here in the picture")


def _gen_requests(cls, images):
    return [cls("generate_until", {}, i, "t",
                (p, {"max_new_tokens": MAX_NEW}), [im])
            for i, (p, im) in enumerate(zip(PROMPTS, images))]


# every variant generates; the norm score's other paths are the saliency
# variant's with another index set
ALL = pytest.mark.parametrize("pair", sorted(VARIANTS), indirect=True)
THREE = pytest.mark.parametrize(
    "pair", ["keep_saliency", "mof", "perceiver2x"], indirect=True)


@ALL
def test_generate_until_matches_jax(pair, tmp_path, capsys):
    variant, jlmm, lmm, path = pair
    images = _images(2)
    want = jlmm.generate_until(_gen_requests(JInstance, images))
    got = lmm.generate_until(_gen_requests(Instance, images))
    assert len(got) == 2 and all(got)
    check_answers(jlmm, _gen_requests(JInstance, images), want, got)
    # `generate --device cpu` (the hash tokenizer of a fresh build)
    images[0].save(tmp_path / "img.png")
    sets = [f"model.{k}={v}" for k, v in _model(variant).items()]
    argv = ["generate", "--prompt", PROMPTS[0], "--image",
            str(tmp_path / "img.png"), "--max-new-tokens", str(MAX_NEW),
            "--device", "cpu", "--set", f"model.checkpoint={path}",
            "--set", "train.bf16=false"]
    for s in sets:
        argv += ["--set", s]
    capsys.readouterr()
    assert cli.main(argv) == 0
    fresh = trunner.build_lmm(RunConfig.from_dict(
        {"model": dict(_model(variant), checkpoint=path),
         "train": {"bf16": False}}), device="cpu")
    inst = Instance("generate_until", {}, 0, "cli", (PROMPTS[0], {
        "max_new_tokens": MAX_NEW, "temperature": 0.0, "top_p": 1.0}),
        [Image.open(tmp_path / "img.png").convert("RGB")])
    assert capsys.readouterr().out.strip() == fresh.generate_until([inst])[0]


@THREE
def test_loglikelihood_and_embeddings_match_jax(pair, tmp_path):
    variant, jlmm, lmm, _ = pair
    images = _images(3, seed=1)
    ctx = ["what is this", "is there a dog", "count the objects"]
    conts = [" a cat", " yes", " three or four"]

    def reqs(cls):
        return [cls("loglikelihood", {}, i, "t", (c, k), [im])
                for i, (c, k, im) in enumerate(zip(ctx, conts, images))]
    want = jlmm.loglikelihood(reqs(JInstance))
    got = lmm.loglikelihood(reqs(Instance))
    for (g_lp, g_flag), (w_lp, w_flag) in zip(got, want):
        assert abs(g_lp - w_lp) < 1e-4 and g_flag == w_flag
    outs = []
    for model, cls, name in ((jlmm, JInstance, "j"), (lmm, Instance, "t")):
        out = str(tmp_path / name)
        assert model.dump_image_embeds_for_docs(
            _gen_requests(cls, images[:2]), out, limit=2) == 2
        outs.append(out)
    for f in ("tensor_1.npy", "tensor_2.npy"):
        w = np.load(os.path.join(outs[0], f))
        g = np.load(os.path.join(outs[1], f))
        assert g.shape == w.shape == (lmm.cfg.num_patches,
                                      lmm.cfg.decoder.hidden_size)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def _payloads():
    return [{"max_tokens": MAX_NEW, "messages": [{"role": "user", "content": [
        _image_part(_png_b64(size=(40, 32), seed=i)),
        {"type": "text", "text": text}]}]} for i, text in enumerate(PROMPTS)]


def _serve_two(srv):
    got = [None, None]
    payloads = _payloads()

    def hit(i):
        got[i] = _post(srv.port, payloads[i])["choices"][0]["message"][
            "content"]
    threads = [threading.Thread(target=hit, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return got


@THREE
def test_served_waves_and_inflight_match_generate_until(pair):
    variant, _, lmm, _ = pair
    reqs = []
    for p in _payloads():
        prompt, images = _parse_messages(p["messages"])
        reqs.append(Instance("generate_until", {}, len(reqs), "serve",
                             (prompt, {"max_new_tokens": MAX_NEW}),
                             visual=images))
    want = lmm.generate_until(reqs)
    for kw in ({"max_batch": 4, "batch_window_ms": 500},
               {"inflight": True, "inflight_kwargs": dict(
                   n_slots=2, prompt_cap=64, gen_cap=8, chunk=2)}):
        srv = LMMServer(lmm, port=0, **kw)
        srv.start_background()
        try:
            got = _serve_two(srv)
        finally:
            srv.shutdown()
        assert got == want, (kw, got, want)


def _train_raw(tmp_path, variant):
    rng = np.random.RandomState(1)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (30 + 6 * i, 28, 3),
                                    dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    words = "a red house near the river with two trees and a dog".split()
    recs = [{"image": f"img{i % 3}.png", "conversations": [
        {"from": "human", "value": "<image>\ndescribe the picture"},
        {"from": "gpt", "value": " ".join(rng.choice(words, 3 + i % 4))}]}
        for i in range(4)]
    with open(tmp_path / "data.json", "w") as f:
        json.dump(recs, f)
    return {"model": _model(variant),
            "train": {"stage": 1, "batch_size": 2, "epochs": 1,
                      "bf16": False, "max_length": 64, "learning_rate": 1e-3,
                      "warmup_ratio": 0.0, "save_steps": 1000,
                      "output_dir": str(tmp_path / "out")},
            "data": {"data_path": str(tmp_path / "data.json"),
                     "image_folder": str(tmp_path)},
            "parallel": {"n_data": 1, "n_model": 1}}


def _logs(out_dir):
    with open(os.path.join(out_dir, "train.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@THREE
def test_stage1_training_matches_jax(pair, tmp_path):
    variant, _, _, _ = pair
    raw = _train_raw(tmp_path, variant)
    jcfg = JRunConfig.from_dict(raw)
    _, jparams = jtrain.build_model(jcfg)
    init = str(tmp_path / "init.npz")
    jio.save_params(init, jparams)
    if variant == "mof":
        # the JAX runner trains, then asks the spec for one projector
        # width when it saves, which MoF refuses
        with pytest.raises(ValueError, match="per-tower"):
            jtrain.run_training(jcfg)
    else:
        assert jtrain.run_training(jcfg) == 0
    traw = json.loads(json.dumps(raw))
    traw["train"]["output_dir"] += "_port"
    traw["model"]["checkpoint"] = init
    traw["parallel"] = {}
    run = ttrain.run_training(RunConfig.from_dict(traw), device="cpu")
    logs, jlogs = _logs(traw["train"]["output_dir"]), _logs(
        raw["train"]["output_dir"])
    assert len(logs) == len(jlogs) == 2
    for r, jr in zip(logs, jlogs):
        assert r["skipped_nonfinite"] == 0.0
        np.testing.assert_allclose(r["loss"], jr["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], jr["grad_norm"],
                                   rtol=1e-4)
    out = traw["train"]["output_dir"]
    assert not os.path.exists(os.path.join(out, "mm_projector.bin")) or (
        variant.startswith("keep"))
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    assert saved["mm_projector_type"] == run.model_cfg.projector_type
    trained = run.state["params"].projector.state_dict()
    loaded = tckpt.load_projector(out)
    assert set(loaded) == set(trained)
    for k, v in trained.items():
        assert torch.equal(loaded[k], v), k
