"""The port's eval harness, embedding dump and law-chain CLI against the JAX
package, on the CPU in fp32.

- `simple_evaluate`, the metric functions and doc sharding: both packages
  score the same canned answers over paper tasks written to `tmp_path`
  (as `tests/test_eval_harness.py` writes them) and must give the same
  results dict (exact: the same numpy calls on the same records).
- `LlavaLMM.loglikelihood` and `dump_image_embeds_for_docs`: the tiny LLaVA
  from ONE `.npz` of JAX-initialised params through both adapters. Summed
  log-probs within 1e-4, greedy flags equal, embeddings within 1e-5 (fp32
  sums in different orders).
- `run_evaluation`, `run_embed_extraction` and the CLI commands `eval`,
  `tasks`, `extract-embeds`, `a-score` end to end with `--device cpu`; each
  package scores the embeddings the other dumped.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.eval import (
    evaluator as jeval, metrics as jmetrics, runner as jrunner,
    task as jtask)
from law_of_vision_representation_in_mllms_tpu.eval.api import (
    Instance as JInstance)
from law_of_vision_representation_in_mllms_tpu.eval.tasks import (
    PAPER_TASKS as J_PAPER_TASKS, task_yaml as j_task_yaml)
from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
from law_of_vision_representation_in_mllms_tpu.pipeline.a_score_run import (
    compute_a_scores as j_compute_a_scores)
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.eval import (
    evaluator as teval, metrics as tmetrics, runner as trunner,
    task as ttask)
from law_of_vision_representation_in_mllms_torch.eval.api import (
    LMM, Instance)
from law_of_vision_representation_in_mllms_torch.eval.tasks import (
    PAPER_TASKS, task_yaml)
from law_of_vision_representation_in_mllms_torch.pipeline.a_score_run import (
    compute_a_scores)

torch.set_num_threads(1)

TINY = {"model": {"decoder": "tiny", "vision_tower": "debug/tiny-vit"},
        "train": {"bf16": False}}


class EchoLMM(LMM):
    """Canned answers keyed by doc_id; serves both packages' evaluators."""

    def __init__(self, answers):
        self.answers = answers

    def generate_until(self, requests):
        return [self.answers[r.doc_id] for r in requests]

    def loglikelihood(self, requests):
        return [(-float(len(r.args[1])), False) for r in requests]


def _task_cfg(tmp_path, name, docs, yaml_of=task_yaml):
    d = tmp_path / name
    os.makedirs(d, exist_ok=True)
    with open(d / "questions.json", "w") as f:
        json.dump(docs, f)
    with open(yaml_of(name)) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset_path"] = str(d / "questions.json")
    cfg["image_root"] = str(d)
    return cfg


_VQA = {"answers": ["cat"] * 6 + ["kitten"] * 4}
CASES = {
    "mme": ([{"question": "Is there a cat?", "answer": "Yes",
              "category": "existence", "image_id": "img0"},
             {"question": "Is there a dog?", "answer": "No",
              "category": "existence", "image_id": "img0"},
             {"question": "Is it red?", "answer": "Yes",
              "category": "color", "image_id": "img1"},
             {"question": "Is it blue?", "answer": "No",
              "category": "color", "image_id": "img1"}],
            {0: "Yes", 1: "No", 2: "Yes", 3: "Yes"}, 250.0),
    "mmbench_en": ([{"question": "Shape?", "options": ["circle", "square"],
                     "answer": "A", "category": "shape"},
                    {"question": "Color?", "options": ["red", "blue"],
                     "answer": "B", "category": "color"}],
                   {0: "A. circle", 1: "The answer is red"}, 0.5),
    "scienceqa_img": ([{"question": "Pick.", "hint": "Think.",
                        "options": ["x", "y", "z"], "answer": "C"}],
                      {0: "(C)"}, 1.0),
    "ok_vqa": ([dict(_VQA, question="What animal?")], {0: "a cat"}, 1.0),
    "vizwiz_vqa_val": ([dict(_VQA, question="What?")], {0: "kitten"}, 1.0),
    "pope": ([{"question": "Is there a dog?", "answer": "yes"},
              {"question": "Is there a cat?", "answer": "no"},
              {"question": "Is there a car?", "answer": "yes"}],
             {0: "Yes", 1: "Yes", 2: "No"}, 0.5),
    "gqa": ([{"question": "What is it?", "answer": "dog"},
             {"question": "Where?", "answer": "park"}],
            {0: "A dog.", 1: "street"}, 0.5),
}


def _bundled(yaml_of):
    folder = os.path.dirname(yaml_of("mme"))
    return sorted(f[:-5] for f in os.listdir(folder) if f.endswith(".yaml"))


def test_bundled_tasks_are_the_paper_tasks():
    """`PAPER_TASKS` stays the paper's 11; the port bundles the JAX
    package's 44 task YAMLs (byte equality: tests/test_torch_eval_zoo.py)."""
    assert PAPER_TASKS == J_PAPER_TASKS
    for name in PAPER_TASKS:
        assert open(task_yaml(name)).read() == open(j_task_yaml(name)).read()
    assert _bundled(task_yaml) == _bundled(j_task_yaml)
    assert len(_bundled(task_yaml)) == 44


@pytest.mark.parametrize("name", sorted(CASES))
def test_simple_evaluate_matches_jax(tmp_path, name):
    docs, answers, value = CASES[name]
    model = EchoLMM(answers)
    got = teval.simple_evaluate(
        model, [_task_cfg(tmp_path, name, docs)], log_samples=True)
    want = jeval.simple_evaluate(
        model, [_task_cfg(tmp_path, name, docs, j_task_yaml)],
        log_samples=True)
    assert got == want
    assert abs(got[name]["value"] - value) < 1e-9
    assert got[name]["n"] == len(docs)


def test_multiple_choice_goes_through_loglikelihood(tmp_path):
    docs = [{"question": "pick", "options": ["aaaa", "bb"], "answer": "B"}]
    cfg = dict(_task_cfg(tmp_path, "mmbench_en", docs), task="mc_ll",
               output_type="multiple_choice")
    got = teval.simple_evaluate(EchoLMM({}), [cfg], log_samples=True)
    want = jeval.simple_evaluate(EchoLMM({}), [cfg], log_samples=True)
    assert got == want
    assert got["mc_ll"]["samples"][0]["prediction"] == "B"


def test_load_task_reads_json_task_files(tmp_path):
    """A task file may be `.json` (read without PyYAML) or YAML; both give
    the task a dict gives."""
    docs, answers, _ = CASES["pope"]
    cfg = _task_cfg(tmp_path, "pope", docs)
    as_json, as_yaml = str(tmp_path / "t.json"), str(tmp_path / "t.yaml")
    with open(as_json, "w") as f:
        json.dump(cfg, f)
    with open(as_yaml, "w") as f:
        yaml.safe_dump(cfg, f)
    want = teval.simple_evaluate(EchoLMM(answers), [cfg])
    for path in (as_json, as_yaml):
        assert teval.simple_evaluate(EchoLMM(answers), [path]) == want
        assert ttask.load_task(path, limit=2).docs == docs[:2]


def test_doc_sharding_and_merge(tmp_path):
    docs = [{"question": f"q{i}", "options": ["x", "y"], "answer": "A"}
            for i in range(7)]
    cfg = _task_cfg(tmp_path, "seed_image", docs)
    model = EchoLMM({i: ("A" if i % 2 == 0 else "B") for i in range(7)})
    merged = {}
    for mod, ev in ((ttask, teval), (jtask, jeval)):
        tasks = [mod.load_task(cfg)]
        parts = [ev.evaluate(model, tasks, process_index=p, process_count=2,
                             log_samples=True) for p in range(2)]
        assert [r["seed_image"]["n"] for r in parts] == [4, 3]
        merged[mod] = ev.merge_process_results(parts, tasks)
    assert merged[ttask] == merged[jtask]
    assert abs(merged[ttask]["seed_image"]["value"] - 4 / 7) < 1e-9


def test_metric_functions_match_jax():
    pairs = [("Two", ["2"] * 10), ("a cat.", ["cat"] * 3 + ["dog"] * 7),
             ("It's the   red one", ["the red one"] * 10)]
    for pred, answers in pairs:
        assert tmetrics.vqa_accuracy(pred, answers) == \
            jmetrics.vqa_accuracy(pred, answers)
        assert tmetrics.vqa_normalize(pred) == jmetrics.vqa_normalize(pred)
    for pred, options in (("(B)", ["a", "b"]), ("blue thing", ["red", "blue"]),
                          ("no idea", ["x", "y", "z"])):
        assert tmetrics.parse_multi_choice(pred, options) == \
            jmetrics.parse_multi_choice(pred, options)
    assert tmetrics.anls("hello", ["hallo"]) == jmetrics.anls("hello",
                                                              ["hallo"])
    assert tmetrics.exact_match(" Yes ", "yes") == \
        jmetrics.exact_match(" Yes ", "yes")
    values = list(np.random.RandomState(0).rand(40))
    assert tmetrics.bootstrap_stderr(values) == \
        jmetrics.bootstrap_stderr(values)
    recs = [{"category": "c", "image_id": "i", "correct": True},
            {"category": "c", "image_id": "i", "correct": False}]
    assert tmetrics.mme_aggregate(recs) == jmetrics.mme_aggregate(recs) == 50.0
    assert sorted(tmetrics.AGGREGATIONS) == sorted(jmetrics.AGGREGATIONS)
    assert sorted(tmetrics.METRICS) == sorted(jmetrics.METRICS)


def test_unported_eval_parts_point_at_the_roadmap(tmp_path):
    """The eval parts that once pointed at the ROADMAP are ported: the
    `llava_wild` and `mmupd_dual` aggregations and an `mmvet` hook load and
    give the JAX package's values; an unknown model name raises the JAX
    registry's KeyError, an unknown task a FileNotFoundError."""
    wild = [{"scores": [8.0, 6.0]}, {"scores": [-1.0, -1.0]}]
    dual = [{"split": "standard", "score": 1.0},
            {"split": "masked", "score": 0.5}]
    for agg, recs in (("llava_wild", wild), ("mmupd_dual", dual)):
        assert tmetrics.AGGREGATIONS[agg](recs) == \
            jmetrics.AGGREGATIONS[agg](recs)
    assert tmetrics.AGGREGATIONS["llava_wild"](wild) == 75.0
    assert tmetrics.AGGREGATIONS["mmupd_dual"](dual) == 0.5
    cfg = dict(_task_cfg(tmp_path, "gqa", CASES["gqa"][0]),
               doc_to_text="mmvet.doc_to_text")
    doc = CASES["gqa"][0][0]
    assert ttask.load_task(cfg).doc_to_text(doc) == \
        jtask.load_task(cfg).doc_to_text(doc) == "What is it?"
    for run in (lambda: trunner.run_evaluation(
                    RunConfig.from_dict(TINY), ["mme"], device="cpu",
                    model="no-such-model"),
                lambda: jrunner.run_evaluation(
                    JRunConfig.from_dict(TINY), ["mme"],
                    model="no-such-model")):
        with pytest.raises(KeyError, match="unknown LMM 'no-such-model'"):
            run()
    with pytest.raises(FileNotFoundError):
        trunner.run_evaluation(RunConfig.from_dict(TINY), ["no_such_task"],
                               device="cpu")


# ---- the tiny LLaVA through both adapters --------------------------------

@pytest.fixture(scope="module")
def lmms(tmp_path_factory):
    """(JAX adapter, port adapter, checkpoint path): JAX-initialised params
    saved once as a `param_io` .npz and loaded by the port's `build_lmm`."""
    jlmm = jrunner.build_lmm(JRunConfig.from_dict(TINY))
    path = str(tmp_path_factory.mktemp("ckpt") / "llava.npz")
    jio.save_params(path, jlmm.params)
    lmm = trunner.build_lmm(RunConfig.from_dict(
        {"model": dict(TINY["model"], checkpoint=path),
         "train": TINY["train"]}), device="cpu")
    return jlmm, lmm, path


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 256, (40 + 8 * i, 56, 3),
                                        dtype=np.uint8)) for i in range(n)]


def test_loglikelihood_matches_jax(lmms):
    jlmm, lmm, _ = lmms
    images = _images(6, seed=1)
    contexts = ["what is this", "describe the image in some detail please "
                "and say what colors you can see in it",
                "is there a dog", "what", "count the objects", "why"]
    conts = [" a cat", " a large red house near the river bank", " yes",
             " no", " three or maybe four of them", " because"]

    def reqs(cls):
        return [cls("loglikelihood", {}, i, "t", (c, k), [im])
                for i, (c, k, im) in enumerate(zip(contexts, conts, images))]
    want = jlmm.loglikelihood(reqs(JInstance))
    got = lmm.loglikelihood(reqs(Instance))
    assert len(got) == len(want) == 6
    for (g_lp, g_flag), (w_lp, w_flag) in zip(got, want):
        assert isinstance(g_lp, float) and isinstance(g_flag, bool)
        assert abs(g_lp - w_lp) < 1e-4
        assert g_flag == w_flag
    # a smaller batch size changes the buckets, not the values
    lmm.batch_size = 4
    try:
        again = lmm.loglikelihood(reqs(Instance))
    finally:
        lmm.batch_size = 8
    for (a_lp, _), (g_lp, _) in zip(again, got):
        assert abs(a_lp - g_lp) < 1e-4


def test_loglikelihood_greedy_flag(lmms):
    """The flag is True exactly when the continuation is the model's own
    greedy choice: score the argmax token of a context, then another."""
    _, lmm, _ = lmms
    img = _images(1, seed=2)[0]
    ctx = "what is this"
    probe = Instance("loglikelihood", {}, 0, "t", (ctx, " x"), [img])
    ids, mask, pixels = lmm._encode_batch([probe])
    from law_of_vision_representation_in_mllms_torch.models import llava as M
    pre = M.prefill(lmm.params, lmm.cfg, ids, mask, pixels, max_new_tokens=1)
    best = int(pre.logits[0].argmax())
    worst = int(pre.logits[0].argmin())

    class OneToken:
        """Tokenizer stub: the continuation encodes to one chosen id."""
        def __init__(self, tok, cont_id):
            self.tok, self.cont_id = tok, cont_id
            self.eos_token_id = tok.eos_token_id

        def encode(self, text, add_special_tokens=True):
            if text == " x":
                return [self.cont_id]
            return self.tok.encode(text,
                                   add_special_tokens=add_special_tokens)

        def __getattr__(self, name):
            return getattr(self.tok, name)

    real = lmm.tok
    try:
        lmm.tok = OneToken(real, best)
        lp_best, flag_best = lmm.loglikelihood([probe])[0]
        lmm.tok = OneToken(real, worst)
        lp_worst, flag_worst = lmm.loglikelihood([probe])[0]
    finally:
        lmm.tok = real
    assert flag_best is True and flag_worst is False
    # the margin is the gap between the top two log-probs at that position
    margin = lmm._ll_rows([probe])[0][2]
    top2 = torch.log_softmax(pre.logits[0], -1).topk(2).values
    assert abs(margin - (top2[0] - top2[1]).item()) < 1e-4
    assert lp_best > lp_worst
    want = torch.log_softmax(pre.logits[0], -1)[best].item()
    assert abs(lp_best - want) < 1e-4


def _mme_docs(folder, n):
    docs = []
    for i, im in enumerate(_images(n, seed=3)):
        im.save(os.path.join(folder, f"img{i}.png"))
        docs.append({"question": f"Is this picture number {i}?",
                     "answer": "Yes" if i % 2 else "No",
                     "category": "existence", "image_id": f"img{i // 2}",
                     "image": f"img{i}.png"})
    return docs


def _write_yaml(tmp_path, name, docs_folder, docs, **overrides):
    with open(os.path.join(docs_folder, f"{name}.json"), "w") as f:
        json.dump(docs, f)
    with open(task_yaml("mme" if "mme" in name else "mmbench_en")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(task=name, dataset_path=os.path.join(docs_folder,
                                                    f"{name}.json"),
               image_root=docs_folder, **overrides)
    path = str(tmp_path / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def task_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tasks")
    folder = str(tmp)
    mme = _write_yaml(tmp, "mme_tiny", folder, _mme_docs(folder, 4),
                      generation_kwargs={"max_new_tokens": 4})
    mc_docs = [{"question": "Which one?", "options": ["a red one", "blue"],
                "answer": "A", "image": "img0.png"},
               {"question": "Pick.", "options": ["yes", "no", "maybe so"],
                "answer": "C", "image": "img1.png"}]
    mc = _write_yaml(tmp, "mc_tiny", folder, mc_docs,
                     output_type="multiple_choice")
    return mme, mc


def test_dump_image_embeds_matches_jax(lmms, task_files, tmp_path):
    jlmm, lmm, _ = lmms
    mme, _ = task_files
    outs = []
    for mod, model, name in ((jtask, jlmm, "j"), (ttask, lmm, "t")):
        task = mod.load_task(mme)
        reqs = task.build_requests(list(range(len(task.docs))))
        out = str(tmp_path / name)
        assert model.dump_image_embeds_for_docs(reqs, out, limit=3) == 3
        outs.append(out)
    assert sorted(os.listdir(outs[1])) == sorted(os.listdir(outs[0])) == [
        "tensor_1.npy", "tensor_2.npy", "tensor_3.npy"]
    for f in os.listdir(outs[0]):
        want = np.load(os.path.join(outs[0], f))
        got = np.load(os.path.join(outs[1], f))
        assert got.dtype == np.float32 and got.shape == want.shape == (
            lmm.cfg.num_patches, lmm.cfg.decoder.hidden_size)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_run_evaluation_matches_jax(lmms, task_files):
    """Both task kinds end to end from the RunConfig: `generate_until`
    (MME-style) and `multiple_choice` (per-option loglikelihood)."""
    _, _, ckpt = lmms
    raw = {"model": dict(TINY["model"], checkpoint=ckpt),
           "train": TINY["train"]}
    tasks = list(task_files)
    # the JAX runner rebuilds the fixture's params from the same seed
    want = jrunner.run_evaluation(JRunConfig.from_dict(TINY), tasks,
                                  log_samples=True)
    got = trunner.run_evaluation(RunConfig.from_dict(raw), tasks,
                                 device="cpu", log_samples=True)
    assert got == want
    assert set(got) == {"mme_tiny", "mc_tiny"}
    assert 0.0 <= got["mc_tiny"]["value"] <= 1.0
    assert 0.0 <= got["mme_tiny"]["value"] <= 200.0
    limited = trunner.run_evaluation(RunConfig.from_dict(raw), tasks[:1],
                                     device="cpu", limit=2)
    assert limited["mme_tiny"]["n"] == 2
    assert limited["mme_tiny"]["samples"] is None


def test_law_chain_cli_and_cross_package_scores(lmms, task_files, tmp_path,
                                                capsys):
    """`extract-embeds` for two anchors and a target, `a-score` over them,
    `eval` with samples, `tasks`: all with `--device cpu`. The JAX runner
    scores the port's dumps and the port scores the JAX dumps."""
    _, _, ckpt = lmms
    mme, mc = task_files
    base = str(tmp_path / "embeds")
    common = ["--set", "model.decoder=tiny", "--set",
              "model.vision_tower=debug/tiny-vit", "--set",
              "train.bf16=false", "--device", "cpu"]
    for rep, extra in (("clip336", f"model.checkpoint={ckpt}"),
                       ("clip224", "train.seed=1"),
                       ("target", "train.seed=2")):
        assert cli.main(["extract-embeds", "--task", mme, "--out-dir",
                         os.path.join(base, rep), "--limit", "3", "--set",
                         extra] + common) == 0
        assert "dumped 3 embeddings" in capsys.readouterr().out
    assert cli.main(["a-score", "--base-folder", base, "--reps", "target",
                     "clip336", "missing", "--n-images", "3", "--device",
                     "cpu"]) == 0
    scores = json.loads(capsys.readouterr().out)
    assert sorted(scores) == ["clip336", "target"]
    want = j_compute_a_scores(base, ["target", "clip336"], n_images=3)
    for rep in want:
        assert abs(scores[rep] - want[rep]) < 1e-5

    # the other way: the JAX runner dumps, the port scores
    jbase = str(tmp_path / "jembeds")
    for rep, seed in (("clip336", 0), ("clip224", 1), ("target", 2)):
        jcfg = JRunConfig.from_dict(dict(TINY, train=dict(TINY["train"],
                                                          seed=seed)))
        assert jrunner.run_embed_extraction(
            jcfg, mme, os.path.join(jbase, rep), limit=3) == 3
    got = compute_a_scores(jbase, ["target"], n_images=3, device="cpu")
    want = j_compute_a_scores(jbase, ["target"], n_images=3)
    assert abs(got["target"] - want["target"]) < 1e-5

    out = str(tmp_path / "res.json")
    assert cli.main(["eval", "--tasks", mme, mc, "--limit", "2", "--output",
                     out, "--log-samples", "--set",
                     f"model.checkpoint={ckpt}"] + common) == 0
    printed = json.loads(capsys.readouterr().out)
    saved = json.load(open(out))
    assert set(printed) == set(saved) == {"mme_tiny", "mc_tiny"}
    assert all("samples" not in v for v in saved.values())
    for task in printed:
        assert saved[task]["value"] == printed[task]
        lines = open(str(tmp_path / f"res_{task}_samples.jsonl")).readlines()
        assert len(lines) == 2 and "prediction" in json.loads(lines[0])

    assert cli.main(["tasks", "--device", "cpu"]) == 0
    listed = [line.split()[0]
              for line in capsys.readouterr().out.splitlines()]
    assert listed == _bundled(j_task_yaml)
    assert set(PAPER_TASKS) < set(listed)


@pytest.mark.parametrize("cmd", [
    ["eval", "--tasks", "mme"],
    ["merge-results", "--task", "mme", "--samples", "x.jsonl"],
    ["extract-embeds", "--task", "mme", "--out-dir", "x"],
    ["a-score", "--base-folder", "x", "--reps", "y"],
    ["policy", "fit", "--csv", "x.csv"],
    ["tasks"],
    ["extract-features", "--images", "x", "--out-dir", "y"],
    ["c-score", "--spair-dir", "x", "--feature-dir", "y", "--num-patches",
     "24"]])
def test_new_commands_default_to_cuda_and_raise_without_a_card(cmd):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(cmd)
