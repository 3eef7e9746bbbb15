"""The port's judge, math equivalence and `openai-api` adapter against the
JAX package's, on the CPU.

- `math_equivalence.judge` on the JAX tests' cases and more (intervals,
  unions, equations, percentages, ±, several boxes), and its pieces
  (`extract_boxed`, `split_top_level`, `expand_pm`, `latex_to_sympy_str`)
  on edge cases: the same verdicts and strings in both packages.
- `ChatJudge` against a stub on 127.0.0.1 that fails, answers empty or
  answers: the retries, the '' fallback after `retries` failures, the
  payload; `judge_for_task` reads the YAML `metadata:` block.
- `build_lmm_by_name("openai-api")` against a stub: the payload of text
  and base64 PNG parts, the reply, the reference names that resolve to it.
"""

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import pytest
from PIL import Image

from law_of_vision_representation_in_mllms_tpu.eval import (
    judge as jjudge, math_equivalence as jmath)
from law_of_vision_representation_in_mllms_tpu.eval.api import (
    Instance as JInstance)
from law_of_vision_representation_in_mllms_tpu.eval.models_registry import (
    build_lmm_by_name as j_build_lmm_by_name)
from law_of_vision_representation_in_mllms_torch.eval import (
    judge as tjudge, math_equivalence as tmath)
from law_of_vision_representation_in_mllms_torch.eval.api import Instance
from law_of_vision_representation_in_mllms_torch.eval.models_registry import (
    build_lmm_by_name)

# (prediction, reference, precision, verdict)
JUDGE_CASES = [
    (r"\boxed{\frac{1}{2}}", "0.5", 1e-8, True),
    (r"\boxed{1,2}", "2,1", 1e-8, True),
    (r"\boxed{2\pi}", "6.2832", 1e-3, True),
    (r"\boxed{3}", "4", 1e-8, False),
    (r"\boxed{y=2x+1}", "2x - y + 1 = 0", 1e-8, True),
    (r"the answers are \boxed{1} and \boxed{2}", "1,2", 1e-8, True),
    (r"\boxed{(1,2)}", "(1, 2)", 1e-8, True),
    (r"\boxed{[0,\frac{1}{2}]}", "[0, 0.5]", 1e-8, True),
    (r"\boxed{(1,2)}", "[1, 2]", 1e-8, False),
    (r"\boxed{(0,1)\cup(2,3)}", r"(0, 1) \cup (2, 3)", 1e-8, True),
    (r"\boxed{45^\circ}", "45", 1e-8, True),
    (r"\boxed{0.8660254}", r"\frac{\sqrt{3}}{2}", 1e-5, True),
    (r"\boxed{0.87}", r"\frac{\sqrt{3}}{2}", 1e-5, False),
    (r"\boxed{50\%}", "0.5", 1e-8, True),
    (r"\boxed{2\pm\sqrt{3}}", r"2+\sqrt{3}, 2-\sqrt{3}", 1e-8, True),
    (r"\boxed{x^{2}+2x+1}", "(x+1)^2", 1e-8, True),
    (r"\boxed{3\sqrt{2}}", r"\sqrt{18}", 1e-8, True),
    (r"\boxed{1,2,3}", "1,2", 1e-8, False),
    ("12.", "12", 1e-8, True),
    (r"\boxed{\infty}", r"\infty", 1e-8, True),
    (r"\boxed{a+b}", "b+a", 1e-8, True),
    ("no box here", "7", 1e-8, False),
]


@pytest.mark.parametrize("pred, ref, precision, verdict", JUDGE_CASES)
def test_math_judge_matches_jax(pred, ref, precision, verdict):
    got = tmath.judge(pred, ref, precision)
    assert got == jmath.judge(pred, ref, precision)
    assert got is verdict


@pytest.mark.parametrize("text", [
    r"\boxed{a}", r"\boxed{\frac{1}{2}} and \boxed{3}", "plain 4",
    r"\boxed{{x}+1}", r"\boxed{unclosed", r"x \boxed{} y", "",
    r"\boxed{(0,1]}\boxed{[2,3)}"])
def test_extract_boxed_matches_jax(text):
    assert tmath.extract_boxed(text) == jmath.extract_boxed(text)


@pytest.mark.parametrize("expr", [
    "1,2,3", "(1,2),[3,4]", r"\{1,2\},3", "a,,b", " 1 , 2 ", "f(x,y),g",
    r"1\pm2", r"x\pm y, z", ""])
def test_split_and_expand_pm_match_jax(expr):
    parts = tmath.split_top_level(expr)
    assert parts == jmath.split_top_level(expr)
    assert tmath.expand_pm(parts) == jmath.expand_pm(parts)
    assert tmath.latex_to_sympy_str(expr) == jmath.latex_to_sympy_str(expr)


def test_expand_pm_edge_cases():
    assert tmath.expand_pm([r"1\pm2"]) == ["1+2", "1-2"]
    assert tmath.expand_pm([r"\pm x", "y"]) == ["+ x", "- x", "y"]
    assert tmath.expand_pm([]) == []
    assert tmath.latex_to_sympy_str(r"\frac{\sqrt{3}}{2}") == \
        "((sqrt(3))/(2))"


# ---- the chat judge --------------------------------------------------------

class _Flaky(BaseHTTPRequestHandler):
    """Fails (HTTP 500) the first `fail` requests, then answers `reply`
    (which may be empty)."""

    state = {"fail": 0, "reply": "", "bodies": []}

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        self.state["bodies"].append(
            dict(body, auth=self.headers["Authorization"]))
        if self.state["fail"] > 0:
            self.state["fail"] -= 1
            self.send_response(500)
            self.end_headers()
            return
        if isinstance(body["messages"][0]["content"], list):
            reply = f"reply-to:{body['model']}"   # the adapter's payload
        else:
            reply = self.state["reply"]
        resp = json.dumps({"choices": [{"message": {
            "content": reply}}]}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(resp)))
        self.end_headers()
        self.wfile.write(resp)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def stub():
    srv = HTTPServer(("127.0.0.1", 0), _Flaky)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_port}/v1/chat/completions"
    finally:
        srv.shutdown()
        thread.join()


@pytest.mark.parametrize("fail, reply, retries, want, requests", [
    (0, " 0.7 ", 3, "0.7", 1),          # answered: stripped
    (2, "8 6", 3, "8 6", 3),            # two failures, then an answer
    (3, "8 6", 3, "", 3),               # every try fails: ''
    (0, "   ", 2, "", 2),               # empty answers are retried
    (1, "ok", 1, "", 1)])               # retries=1: one try
def test_chat_judge_retries_and_fallback(stub, fail, reply, retries, want,
                                         requests):
    seen = []
    for mod in (tjudge, jjudge):
        _Flaky.state.update(fail=fail, reply=reply, bodies=[])
        judge = mod.ChatJudge(model="gpt-x", api_url=stub, api_key="k",
                              retries=retries)
        out = judge("grade this", system="be fair", max_tokens=9,
                    temperature=0.5)
        seen.append((out, _Flaky.state["bodies"]))
    assert seen[0] == seen[1]
    out, bodies = seen[0]
    assert out == want and len(bodies) == requests
    assert bodies[0] == {
        "model": "gpt-x", "max_tokens": 9, "temperature": 0.5,
        "messages": [{"role": "system", "content": "be fair"},
                     {"role": "user", "content": "grade this"}],
        "auth": "Bearer k"}


def test_judge_for_task_reads_metadata(monkeypatch, stub):
    monkeypatch.setenv("OPENAI_API_URL", stub)
    monkeypatch.setenv("OPENAI_API_KEY", "env-key")
    task = SimpleNamespace(cfg=SimpleNamespace(metadata={
        "gpt_eval_model_name": "gpt-4-0613", "judge_retries": 5,
        "judge_retry_sleep": 0.0}))
    judges = [mod.judge_for_task(task) for mod in (tjudge, jjudge)]
    assert vars(judges[0]) == vars(judges[1])
    assert (judges[0].model, judges[0].retries, judges[0].api_url,
            judges[0].api_key) == ("gpt-4-0613", 5, stub, "env-key")
    bare = tjudge.judge_for_task(SimpleNamespace())
    assert (bare.model, bare.retries) == ("gpt-4-0613", 3)


# ---- the openai-api adapter -------------------------------------------------

def test_openai_api_adapter_matches_jax(stub):
    img = Image.new("RGB", (4, 4), (255, 0, 0))
    payloads = []
    for build, inst in ((build_lmm_by_name, Instance),
                        (j_build_lmm_by_name, JInstance)):
        _Flaky.state.update(fail=1, reply="", bodies=[])
        lmm = build("openai-api", model_version="test-model", api_url=stub,
                    api_key="k", retries=2, retry_sleep=0.0)
        out = lmm.generate_until([inst(
            "generate_until", {}, 0, "t",
            ("What?<image>Answer.", {"max_new_tokens": 7}), visual=[img])])
        assert out == ["reply-to:test-model"]
        payloads.append(_Flaky.state["bodies"])
        gpt4v = build("gpt4v", api_url=stub, api_key="k", retries=1)
        assert gpt4v.model_version == "gpt-4-vision-preview"
        assert build("qwen-vl-api", api_url=stub).model_version == \
            "qwen-vl-plus"
        with pytest.raises(NotImplementedError):
            gpt4v.loglikelihood([])
    assert payloads[0] == payloads[1] and len(payloads[0]) == 2
    content = payloads[0][-1]["messages"][0]["content"]
    assert [c["type"] for c in content] == ["text", "image_url", "text"]
    assert payloads[0][-1]["max_tokens"] == 7
    b64 = content[1]["image_url"]["url"].split(",", 1)[1]
    assert base64.b64decode(b64)[:4] == b"\x89PNG"
    # every retry failed: '' (gpt4v.py's fallback)
    _Flaky.state.update(fail=3, bodies=[])
    lmm = build_lmm_by_name("openai-api", api_url=stub, retries=2,
                            retry_sleep=0.0)
    assert lmm.generate_until([Instance(
        "generate_until", {}, 0, "t", ("hi", {}), visual=[])]) == [""]
