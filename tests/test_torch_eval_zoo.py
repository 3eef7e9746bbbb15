"""The port's eval zoo against the JAX package's, on the CPU.

- The bundled task YAMLs are byte copies of the JAX package's 44, and the
  port's pure-Python eval modules (task files, judge, math equivalence) have
  the JAX modules' syntax trees: the same code, whatever its line breaks.
- Each of the 33 tasks beyond the paper's 11 goes through both packages'
  `simple_evaluate` on the same docs and canned answers (the fields
  `tests/test_eval_harness.py` gives them); the results must be equal. The
  GPT-judged tasks, and mathverse / mmupd / mathvista's judged chains, talk
  to one stub judge on 127.0.0.1, which must see the same requests from
  both packages.
- `merge-results` of both CLIs over the same doc-sharded sample logs gives
  the same JSON, and both refuse overlapping doc ids.
- `run_evaluation(model="llava")` on the tiny LLaVA over three zoo tasks
  against the JAX `run_evaluation` with the same weights: predictions equal
  or parted at a near tie of the JAX model's logits, scores equal where the
  predictions are.
"""

import ast
import json
import math
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import yaml
from PIL import Image

from law_of_vision_representation_in_mllms_tpu import cli as jcli
from law_of_vision_representation_in_mllms_tpu.core.config import (
    RunConfig as JRunConfig)
from law_of_vision_representation_in_mllms_tpu.eval import (
    evaluator as jeval, runner as jrunner, task as jtask)
from law_of_vision_representation_in_mllms_tpu.eval.tasks import (
    PAPER_TASKS as J_PAPER_TASKS, TASK_DIR as J_TASK_DIR,
    task_yaml as j_task_yaml)
from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.core.config import RunConfig
from law_of_vision_representation_in_mllms_torch.eval import (
    evaluator as teval, runner as trunner, task as ttask)
from law_of_vision_representation_in_mllms_torch.eval.tasks import (
    PAPER_TASKS, TASK_DIR, task_yaml)
from test_torch_eval import TINY, EchoLMM, lmms  # noqa: F401 (fixture)
from test_torch_near_tie import check_answers

J_PKG = os.path.dirname(os.path.dirname(J_TASK_DIR))
T_PKG = os.path.dirname(os.path.dirname(TASK_DIR))
BUNDLED = sorted(f[:-5] for f in os.listdir(J_TASK_DIR) if f.endswith(".yaml"))
ZOO = sorted(set(BUNDLED) - set(J_PAPER_TASKS))
# the modules the port keeps as copies of the JAX package's
COPIES = ("eval/judge.py", "eval/math_equivalence.py",
          "eval/tasks/paper_tasks.py", "eval/tasks/judged_tasks.py",
          "eval/tasks/grounding_tasks.py", "eval/tasks/mathvista_tasks.py",
          "eval/tasks/extra_tasks.py")


def test_bundled_yamls_are_byte_copies():
    assert len(BUNDLED) == 44 and len(ZOO) == 33
    ported = sorted(f[:-5] for f in os.listdir(TASK_DIR) if f.endswith(".yaml"))
    assert ported == BUNDLED
    for name in BUNDLED:
        with open(task_yaml(name), "rb") as f, open(j_task_yaml(name),
                                                    "rb") as g:
            assert f.read() == g.read(), name
    assert PAPER_TASKS == J_PAPER_TASKS


@pytest.mark.parametrize("rel", COPIES)
def test_eval_modules_are_copies(rel):
    """Same syntax tree: string constants (the rubric prompts) equal, code
    equal; only the line breaks inside a literal may differ."""
    trees = [ast.dump(ast.parse(open(os.path.join(pkg, rel)).read()))
             for pkg in (J_PKG, T_PKG)]
    assert trees[0] == trees[1]


# ---- the 33 tasks through both harnesses -----------------------------------

_MC = [{"question": "Which part?", "options": ["stem", "leaf"],
        "answer": "B"},
       {"question": "What?", "options": ["cat", "dog", "bird"],
        "answer": "C"}]
_ANLS = [{"question": "Name?", "answers": ["hello"]},
         {"question": "Price?", "answers": ["$25", "25 dollars"]}]
_CAPS = [{"question": "", "answers": ["a red fox jumps over the dog"]},
         {"question": "", "answers": ["two boats float near the pier"]},
         {"question": "", "answers": ["children play chess in a hall"]}]
_CAP_ANSWERS = {0: "a red fox jumps over the dog", 1: "two boats float",
                2: "kids play chess inside"}
_REC = [{"question": "", "answer": "the red car",
         "bbox": [0.1, 0.1, 0.5, 0.5]},
        {"question": "", "answer": "the dog", "bbox": [0.6, 0.6, 0.9, 0.9]},
        {"question": "", "answer": "a cup", "bbox": [0.2, 0.3, 0.4, 0.6]}]
_REC_ANSWERS = {0: "[0.1, 0.1, 0.5, 0.5]", 1: "[0.0, 0.0, 0.2, 0.2]",
                2: "The box is [0.25, 0.3, 0.45, 0.6]."}
_REG = [{"question": "", "image": "im0.png", "bbox": [4, 4, 10, 10],
         "answers": ["a green square region"]},
        {"question": "", "image": "im0.png", "bbox": [2, 2, 8, 8],
         "answers": ["the small red outlined box"]}]
_REG_ANSWERS = {0: "a green square region", 1: "a small box"}
_WILD = [{"question": "Describe the scene.", "category": "detail",
          "caption": ["a dog on grass"], "gpt_answer": "A dog."},
         {"question": "What is unusual?", "category": "complex",
          "caption": ["a man irons on a taxi"],
          "gpt_answer": "Ironing on a car."},
         {"question": "What color?", "category": "conv",
          "caption": ["a red bus"], "gpt_answer": "Red."}]
_WILD_ANSWERS = {0: "A brown dog.", 1: "He is ironing.", 2: "red"}
_MMUPD = [{"question": "Color?", "A": "red", "B": "blue", "answer": "B",
           "masked_answer": "", "index": 0, "hint": "", "source": "s",
           "split": "v", "category": "c", "type": "aad"},
          {"question": "Which?", "A": "one", "B": "two", "answer": "C",
           "masked_answer": "three", "index": 1, "hint": "", "source": "s",
           "split": "v", "category": "c", "type": "aad"},
          {"question": "Shape?", "A": "round", "B": "flat", "C": "tall",
           "answer": "D", "masked_answer": "square", "index": 2,
           "hint": "look", "source": "s", "split": "v", "category": "c",
           "type": "iasd"}]
_MATHVERSE = [{"question": "Find x.", "question_type": "free_form",
               "answer_type": "float", "answer": "2.5",
               "query_cot": "Find x. Answer with the final value."},
              {"question": "Find y.", "question_type": "free_form",
               "answer_type": "float", "answer": "22",
               "query_cot": "Find y."}]
_MATHVISTA = [
    {"question": "Which number is missing?", "question_type": "free_form",
     "answer_type": "integer", "answer": "14",
     "query": "Question: Which number is missing?"},
    {"question": "Fraction?", "question_type": "free_form",
     "answer_type": "float", "answer": "0.6", "precision": 1},
    {"question": "What fraction is blue?", "question_type": "multi_choice",
     "answer_type": "text", "choices": ["3/11", "8/11", "6/11"],
     "answer": "8/11"},
    {"question": "Name the shape.", "question_type": "free_form",
     "answer_type": "text", "answer": "circle"}]
_MATHVISTA_ANSWERS = {0: "The number missing in the sequence is 14.",
                      1: "The fraction is 0.6, which means six of ten.",
                      2: "(B) 8/11", 3: "It looks round\nmaybe a circle"}
_OLYMPIAD = [
    {"question": "Compute the area.", "subfield": "Mathematics",
     "is_multiple_answer": False, "answer_type": "a numeric value",
     "final_answer": [r"\frac{\sqrt{3}}{2}"], "error": 1e-5,
     "source": "OE_en"},
    {"question": "Prove it.", "subfield": "Mathematics",
     "is_multiple_answer": False, "answer_type": "Need_human_evaluate",
     "final_answer": None, "error": None, "source": "TP_en"},
    {"question": "Find all roots.", "subfield": "Mathematics",
     "is_multiple_answer": True, "answer_type": "Numerical",
     "final_answer": ["1,2"], "error": None, "source": "OE_en"},
    {"question": "Solve for y.", "subfield": "Mathematics",
     "is_multiple_answer": False, "answer_type": "Expression",
     "final_answer": ["y=2x+1"], "error": None, "source": "OE_en"}]
_OLYMPIAD_ANSWERS = {0: r"So the final answer is \boxed{0.8660254}.",
                     1: "QED.", 2: r"the answers are \boxed{2} and \boxed{1}",
                     3: r"So the final answer is \boxed{2x - y + 1 = 0}"}

# name -> (docs, canned answers by doc id, talks to the judge)
CASES = {
    "ai2d": (_MC, {0: "B. leaf", 1: "A"}, False),
    "seedbench_2": (_MC, {0: "B", 1: "The answer is C"}, False),
    "docvqa_val": (_ANLS, {0: "hallo", 1: "25 dollars"}, False),
    "infovqa_val": (_ANLS, {0: "hallo", 1: "nothing"}, False),
    "stvqa": (_ANLS, {0: "hello", 1: "$25"}, False),
    "multidocvqa_val": (_ANLS, {0: "help", 1: "$26"}, False),
    "chartqa": ([{"question": "Total?", "answer": "100"},
                 {"question": "Share?", "answer": "24%"},
                 {"question": "Label?", "answer": "Paris"}],
                {0: "104", 1: "30%", 2: "paris"}, False),
    "ocrbench": ([{"question": "Read the text", "answer": ["STOP"]},
                  {"question": "Formula?", "answer": ["x^2 + 1"],
                   "dataset": "HME100k"},
                  {"question": "Sign?", "answer": ["EXIT"]}],
                 {0: "the sign says stop.", 1: "x^2+1", 2: "entry"}, False),
    "coco_cap": (_CAPS, _CAP_ANSWERS, False),
    "textcaps_val": (_CAPS, _CAP_ANSWERS, False),
    "nocaps_val": (_CAPS, _CAP_ANSWERS, False),
    "flickr30k": (_CAPS, _CAP_ANSWERS, False),
    "realworldqa": ([{"question": "Pick. A. left B. right", "answer": "B"},
                     {"question": "How many cars?", "answer": "2"},
                     {"question": "Color?", "answer": "red"}],
                    {0: "The answer is (B)", 1: "Two.", 2: "blue"}, False),
    "hallusion_bench": (
        [{"question": "Is the left side longer?", "gt_answer": "1",
          "category": "VD", "subcategory": "illusion", "set_id": "0",
          "figure_id": "0", "question_id": "0"},
         {"question": "Is the left side longer?", "gt_answer": "0",
          "category": "VD", "subcategory": "illusion", "set_id": "0",
          "figure_id": "1", "question_id": "0"},
         {"question": "Is this a chart?", "gt_answer": "1",
          "category": "VS", "subcategory": "chart", "set_id": "1",
          "figure_id": "0", "question_id": "0"}],
        {0: "Yes", 1: "Yes, it is", 2: "yes"}, False),
    "iconqa_val": ([{"question": "Which shape?", "ques_type": "choose_txt",
                     "choices": "circle,square", "answer": "square"},
                    {"question": "How many icons?",
                     "ques_type": "fill_in_blank", "answer": "three"}],
                   {0: "square", 1: "four"}, False),
    "websrc_val": ([{"question": "Hotel name?",
                     "answer": "Grand Plaza Hotel"},
                    {"question": "Price?", "answer": "$25"},
                    {"question": "Color?", "answer": "red car"}],
                   {0: "grand plaza hotel", 1: "30", 2: "red truck"}, False),
    "screenspot_rec_test": (
        [{"question": "", "instruction": "click the save button",
          "bbox": [0.4, 0.4, 0.6, 0.6]},
         {"question": "", "instruction": "open the menu",
          "bbox": [0.0, 0.0, 0.1, 0.1]}],
        {0: "[0.4, 0.4, 0.6, 0.6]", 1: "[0.5, 0.5, 0.7, 0.7]"}, False),
    "refcoco_bbox_rec_val": (_REC, _REC_ANSWERS, False),
    "refcoco+_bbox_rec_val": (_REC, _REC_ANSWERS, False),
    "refcocog_bbox_rec_val": (_REC, _REC_ANSWERS, False),
    "refcoco_bbox_val": (_REG, _REG_ANSWERS, False),
    "refcoco+_bbox_val": (_REG, _REG_ANSWERS, False),
    "refcocog_bbox_val": (_REG, _REG_ANSWERS, False),
    "mathvista_testmini": (_MATHVISTA, _MATHVISTA_ANSWERS, False),
    "cmmmu_val": ([{"question": "图中是什么动物?", "type": "选择",
                    "answer": "B", "option1": "狗", "option2": "猫",
                    "option3": "鸟", "option4": "鱼"},
                   {"question": "图中有两只猫。", "type": "判断",
                    "answer": "对"},
                   {"question": "图中有几只猫?", "type": "填空",
                    "answer": "2"}],
                  {0: "(B) 猫", 1: "错", 2: "共有 2 只"}, False),
    "mmupd_base": (_MMUPD, {0: "B", 1: "There is no correct answer "
                            "provided.", 2: "C"}, False),
    "mathverse_testmini": (_MATHVERSE, {0: "Solving gives x = 2.50",
                                        1: "y equals twenty-two"}, False),
    "olympiadbench_test_en": (_OLYMPIAD, _OLYMPIAD_ANSWERS, False),
    "mmvet": ([{"question": "What is x?", "answer": "-1 <AND> -5",
                "capability": "math", "question_id": "q0"},
               {"question": "Explain.", "answer": "full explanation",
                "capability": "know", "question_id": "q1"}],
              {0: "this is half right", 1: "complete answer"}, True),
    "llava_wild": (_WILD, _WILD_ANSWERS, True),
    "llava_bench_coco": (_WILD, _WILD_ANSWERS, True),
    "llava_wild_multilingual": (_WILD, _WILD_ANSWERS, True),
    "ferret": ([{"question": "What is in this region?",
                 "category": "refer_desc",
                 "context": ["a dog on grass",
                             "obj0: dog (0.1,0.1,0.4,0.4)"],
                 "gpt_answer": "A dog."},
                {"question": "Where is the cat?", "category": "ground_conv",
                 "context": "a cat (0.5,0.5,0.9,0.9)",
                 "gpt_answer": "At (0.5,0.5,0.9,0.9)."}],
               {0: "A small dog.", 1: "[0.5, 0.5, 0.9, 0.9]"}, True),
}
# the judged chains of the rule-first tasks (OPENAI_API_URL set)
JUDGED_CHAINS = ("mathverse_testmini", "mmupd_base", "mathvista_testmini")


class _Judge(BaseHTTPRequestHandler):
    """Canned chat completions: an MM-Vet correctness, a pairwise review, a
    MathVerse score or extraction, else an MMUPD option letter."""

    seen = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.seen.append(body)
        prompt = body["messages"][-1]["content"]
        if "Correctness" in prompt:
            content = "0.5" if "half right" in prompt else "1.0"
        elif body["messages"][0]["role"] == "system":
            content = "8 6\nAssistant 2 was less detailed."
        elif "Judgement:" in prompt:
            content = "1"
        elif "Extracted Answer:" in prompt:
            content = "twenty-two"
        else:
            content = "D"
        resp = json.dumps({"choices": [{"message": {
            "content": content}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def judge_url():
    srv = HTTPServer(("127.0.0.1", 0), _Judge)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}/v1/chat/completions"
    finally:
        srv.shutdown()
        thread.join()


def _task_cfg(tmp_path, name, docs, yaml_of):
    d = tmp_path / name
    os.makedirs(d, exist_ok=True)
    with open(d / "questions.json", "w") as f:
        json.dump(docs, f)
    Image.new("RGB", (32, 32), (0, 128, 0)).save(d / "im0.png")
    with open(yaml_of(name)) as f:
        cfg = yaml.safe_load(f)
    cfg["dataset_path"] = str(d / "questions.json")
    cfg["image_root"] = str(d)
    return cfg


def _both(tmp_path, name, docs, answers):
    """(port's results, JAX's results, the port's judge requests, the
    JAX's) of one task."""
    model = EchoLMM(answers)
    out = []
    for ev, yaml_of in ((teval, task_yaml), (jeval, j_task_yaml)):
        n = len(_Judge.seen)
        res = ev.simple_evaluate(model, [_task_cfg(tmp_path, name, docs,
                                                   yaml_of)],
                                 log_samples=True)
        out.append((res, _Judge.seen[n:]))
    (got, got_req), (want, want_req) = out
    return got, want, got_req, want_req


@pytest.mark.parametrize(
    "name, judged",
    [(n, CASES[n][2]) for n in ZOO] + [(n, True) for n in JUDGED_CHAINS])
def test_zoo_task_matches_jax(tmp_path, monkeypatch, judge_url, name,
                              judged):
    assert sorted(CASES) == ZOO
    docs, answers, _ = CASES[name]
    if judged:
        monkeypatch.setenv("OPENAI_API_URL", judge_url)
        monkeypatch.setenv("OPENAI_API_KEY", "k")
    else:
        monkeypatch.delenv("OPENAI_API_URL", raising=False)
    got, want, got_req, want_req = _both(tmp_path, name, docs, answers)
    assert got == want
    assert got_req == want_req
    # the judged tasks and chains reach the judge; without a URL nothing
    # does
    assert bool(got_req) == judged
    res = got[name]
    assert res["n"] == len(docs)
    assert math.isfinite(res["value"])
    assert len(res["samples"]) == len(docs)


def test_zoo_values_as_the_jax_harness_tests(tmp_path, monkeypatch,
                                             judge_url):
    """A few headline values the JAX package's own tests pin, through the
    port: MM-Vet (50 + 100) / 2, LLaVA-Bench 6 / 8, MMUPD's dual accuracy,
    an exact caption's CIDEr-D of 10 and REC hits in two of three."""
    monkeypatch.setenv("OPENAI_API_URL", judge_url)
    got = _both(tmp_path, "mmvet", *CASES["mmvet"][:2])[0]
    assert got["mmvet"]["value"] == 75.0
    got = _both(tmp_path, "llava_wild", _WILD[:1], _WILD_ANSWERS)[0]
    assert got["llava_wild"]["value"] == 75.0
    monkeypatch.delenv("OPENAI_API_URL")
    got = _both(tmp_path, "mmupd_base", _MMUPD[:2],
                CASES["mmupd_base"][1])[0]
    assert got["mmupd_base"]["value"] == 1.0
    got = _both(tmp_path, "coco_cap", _CAPS[:2],
                {0: _CAPS[0]["answers"][0], 1: _CAPS[1]["answers"][0]})[0]
    assert abs(got["coco_cap"]["value"] - 10.0) < 1e-9
    got = _both(tmp_path, "refcoco_bbox_rec_val", _REC, _REC_ANSWERS)[0]
    assert abs(got["refcoco_bbox_rec_val"]["value"] - 2 / 3) < 1e-9


def test_unknown_hook_raises_as_jax(tmp_path):
    cfg = dict(_task_cfg(tmp_path, "coco_cap", _CAPS, task_yaml),
               doc_to_text="no_such_family.doc_to_text")
    errors = []
    for mod in (ttask, jtask):
        with pytest.raises(ImportError) as e:
            mod.load_task(cfg)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


# ---- merge-results ----------------------------------------------------------

@pytest.mark.parametrize("name, as_path", [("seed_image", True),
                                           ("mmupd_base", False),
                                           ("coco_cap", False)])
def test_merge_results_matches_jax_cli(tmp_path, capsys, name, as_path):
    """Two doc shards' sample logs merged by both CLIs (`--task` a task file
    or a bundled name) give the same JSON; repeating a shard is refused."""
    docs, answers = {
        "seed_image": ([{"question": f"q{i}", "options": ["x", "y"],
                         "answer": "A"} for i in range(7)],
                       {i: "A" if i % 2 == 0 else "B" for i in range(7)}),
        "mmupd_base": (_MMUPD, CASES["mmupd_base"][1]),
        "coco_cap": (_CAPS, _CAP_ANSWERS)}[name]
    cfg = _task_cfg(tmp_path, name, docs, task_yaml)
    tasks = [ttask.load_task(cfg)]
    files = []
    for pidx in range(2):
        res = teval.evaluate(EchoLMM(answers), tasks, process_index=pidx,
                             process_count=2, log_samples=True)
        fp = tmp_path / f"rank{pidx}_samples.jsonl"
        with open(fp, "w") as f:
            for rec in res[name]["samples"]:
                f.write(json.dumps(rec) + "\n")
        files.append(str(fp))
    task = name
    if as_path:
        task = str(tmp_path / f"{name}.yaml")
        with open(task, "w") as f:
            yaml.safe_dump(cfg, f)
    outs = []
    for main, extra, tag in ((cli.main, ["--device", "cpu"], "t"),
                             (jcli.main, [], "j")):
        out = str(tmp_path / f"merged_{tag}.json")
        assert main(["merge-results", "--task", task, "--samples", *files,
                     "--output", out] + extra) == 0
        outs.append(json.load(open(out)))
        with pytest.raises(SystemExit, match="more than one shard"):
            main(["merge-results", "--task", task, "--samples", files[0],
                  files[0], "--output", out] + extra)
    capsys.readouterr()
    assert outs[0] == outs[1]
    assert outs[0][name]["n"] == len(docs)
    whole = teval.evaluate(EchoLMM(answers), tasks)[name]
    assert outs[0][name]["value"] == pytest.approx(whole["value"], abs=1e-12)


# ---- the tiny LLaVA end to end over three zoo tasks -------------------------

def _zoo_task_files(folder):
    """coco_cap (64 new tokens), refcoco_bbox_rec_val (32) and mmupd_base
    (32) with three imaged docs each, as YAML task files."""
    rng = np.random.RandomState(5)
    for i in range(3):
        Image.fromarray(rng.randint(0, 256, (48, 40 + 8 * i, 3),
                                    dtype=np.uint8)).save(
            os.path.join(folder, f"img{i}.png"))
    docs = {"coco_cap": _CAPS, "refcoco_bbox_rec_val": _REC,
            "mmupd_base": _MMUPD}
    paths = []
    for name, task_docs in docs.items():
        task_docs = [dict(d, image=f"img{i}.png")
                     for i, d in enumerate(task_docs)]
        with open(os.path.join(folder, f"{name}.json"), "w") as f:
            json.dump(task_docs, f)
        with open(task_yaml(name)) as f:
            cfg = yaml.safe_load(f)
        cfg.update(dataset_path=os.path.join(folder, f"{name}.json"),
                   image_root=folder)
        paths.append(os.path.join(folder, f"{name}.yaml"))
        with open(paths[-1], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


def test_run_evaluation_over_zoo_tasks_matches_jax(lmms, tmp_path,
                                                   monkeypatch):
    jlmm, _, ckpt = lmms
    monkeypatch.delenv("OPENAI_API_URL", raising=False)
    paths = _zoo_task_files(str(tmp_path))
    # the JAX runner rebuilds the fixture's params from the same seed
    want = jrunner.run_evaluation(JRunConfig.from_dict(TINY), paths,
                                  log_samples=True)
    got = trunner.run_evaluation(RunConfig.from_dict(
        {"model": dict(TINY["model"], checkpoint=ckpt),
         "train": TINY["train"]}), paths, device="cpu", log_samples=True)
    assert sorted(got) == sorted(want) == ["coco_cap", "mmupd_base",
                                           "refcoco_bbox_rec_val"]
    for path in paths:
        name = jtask.load_task(path).name
        g, w = got[name], want[name]
        g_pred = [r["prediction"] for r in g["samples"]]
        w_pred = [r["prediction"] for r in w["samples"]]
        assert g["n"] == w["n"] == 3 and math.isfinite(g["value"])
        if g_pred == w_pred:
            assert g == w
            continue
        # parted at a near tie of the JAX model's logits, else a fault
        jt = jtask.load_task(path)
        check_answers(jlmm, jt.build_requests(list(range(3))), w_pred,
                      g_pred)
        for gr, wr in zip(g["samples"], w["samples"]):
            if gr["prediction"] == wr["prediction"]:
                assert gr == wr


def test_registry_llava_is_the_port_adapter(lmms):
    """`build_lmm_by_name("llava", ...)` wraps the port's `LlavaLMM` around
    the given params on `device`: the same answers as the adapter that
    `build_lmm` made."""
    from law_of_vision_representation_in_mllms_torch.eval.api import Instance
    from law_of_vision_representation_in_mllms_torch.eval.models_registry \
        import build_lmm_by_name
    _, lmm, _ = lmms
    built = build_lmm_by_name("llava", params=lmm.params, cfg=lmm.cfg,
                              tokenizer=lmm.tok, template=lmm.template,
                              device="cpu")
    assert type(built) is type(lmm) and built.device.type == "cpu"
    img = Image.fromarray(np.random.RandomState(3).randint(
        0, 256, (40, 40, 3), dtype=np.uint8))
    reqs = [Instance("generate_until", {}, 0, "t",
                     ("what is this", {"max_new_tokens": 5}), [img])]
    assert built.generate_until(reqs) == lmm.generate_until(reqs)
