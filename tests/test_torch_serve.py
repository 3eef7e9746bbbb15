"""The port's `serve` (`law_of_vision_representation_in_mllms_torch/
serve.py`): the wave server's cases of `tests/test_serve.py` on the port's
`LMMServer` (chat completions, data-URL images, SSE, health, models, the
wave batcher's coalescing and its grouping by generation kwargs), then the
tiny LLaVA served by the port against the same weights served by the JAX
package's server, and against the port's own `generate_until`. Also the
`--inflight` flags as the CLI hands them on (the engine itself is in
`tests/test_torch_inflight.py`) and the not-ported refusal of a `--model`
other than llava (ROADMAP item 4).
"""

import base64
import json
import threading
import time
import urllib.error
import urllib.request
from io import BytesIO

import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_torch import cli
from law_of_vision_representation_in_mllms_torch.eval.api import (
    LMM, Instance)
from law_of_vision_representation_in_mllms_torch.serve import (
    LMMServer, _parse_messages, _word_deltas, run_server)

from test_torch_near_tie import check_answers, use_crc_ids

torch.set_num_threads(1)


class CannedLMM(LMM):
    def __init__(self):
        self.seen = []

    def generate_until(self, requests):
        self.seen.extend(requests)
        return [f"ok:{len(r.visual or [])}img:{r.args[0][:20]}"
                for r in requests]

    def loglikelihood(self, requests):
        return [(0.0, True)] * len(requests)


def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
        return json.loads(r.read())


def _png_b64(size=(8, 8), colour=(1, 2, 3), seed=None):
    from PIL import Image
    if seed is None:
        img = Image.new("RGB", size, colour)
    else:
        rng = np.random.RandomState(seed)
        img = Image.fromarray(rng.randint(0, 255, size[::-1] + (3,),
                                          np.uint8))
    buf = BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _image_part(b64):
    return {"type": "image_url",
            "image_url": {"url": f"data:image/png;base64,{b64}"}}


@pytest.fixture
def server():
    """`LMMServer(lmm, **kw)` started in the background, shut down after."""
    started = []

    def start(lmm, **kw):
        srv = LMMServer(lmm, port=0, **kw)
        srv.start_background()
        started.append(srv)
        return srv
    yield start
    for srv in started:
        srv.shutdown()


def test_server_chat_completions_and_introspection(server):
    lmm = CannedLMM()
    srv = server(lmm, model_name="tiny")
    assert _get(srv.port, "/health")["status"] == "ok"
    assert _get(srv.port, "/v1/models")["data"][0]["id"] == "tiny"
    out = _post(srv.port, {"model": "tiny", "max_tokens": 8, "messages": [
        {"role": "user", "content": "hello there"}]})
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant"
    assert msg["content"].startswith("ok:0img:hello there")
    assert lmm.seen[-1].args[1]["max_new_tokens"] == 8
    # a data-URL image part: a PIL image and an '<image>' marker
    out = _post(srv.port, {"messages": [{"role": "user", "content": [
        {"type": "text", "text": "What?"}, _image_part(_png_b64())]}]})
    assert out["choices"][0]["message"]["content"].startswith("ok:1img")
    assert "<image>" in lmm.seen[-1].args[0]
    # a malformed request: a structured 400, the server stays up
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv.port, {"messages": [{"role": "user", "content": [
            {"type": "image_url",
             "image_url": {"url": "https://x/y.png"}}]}]})
    assert err.value.code == 400
    assert "data:image" in json.loads(err.value.read())["error"]["message"]
    out = _post(srv.port, {"messages": [
        {"role": "user", "content": "still alive?"}]})
    assert out["choices"][0]["message"]["content"].startswith("ok:0img")
    # OpenAI `stop` (a string or a list) becomes the kwargs' `until`
    for stop, until in (("END", ["END"]), (["a", "b"], ["a", "b"])):
        _post(srv.port, {"messages": [{"role": "user", "content": "s"}],
                         "stop": stop})
        assert lmm.seen[-1].args[1]["until"] == until
    # temperature / top_p / do_sample pass through as generation kwargs
    _post(srv.port, {"messages": [{"role": "user", "content": "t"}],
                     "temperature": 0.7, "top_p": 0.9, "do_sample": False})
    assert lmm.seen[-1].args[1] == {"temperature": 0.7, "top_p": 0.9,
                                    "do_sample": False}
    health = _get(srv.port, "/health")
    assert health["requests"] == 6 and health["dispatches"] == 6
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(srv.port, "/nowhere")
    assert err.value.code == 404


def test_parse_messages_matches_jax():
    """The port's copy of `_parse_messages` flattens the same messages into
    the same prompt and images as the JAX package's."""
    from law_of_vision_representation_in_mllms_tpu.serve import (
        _parse_messages as j_parse, _word_deltas as j_words)
    b64 = _png_b64(size=(6, 5), seed=0)
    messages = [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": [
            {"type": "text", "text": "what is"}, _image_part(b64),
            {"type": "text", "text": "this"}]},
        {"role": "assistant", "content": "a cat"},
        {"role": "tool", "content": "ignored"},
        {"role": "user", "content": "what colour?"}]
    prompt, images = _parse_messages(messages)
    j_prompt, j_images = j_parse(messages)
    assert prompt == j_prompt and "ASSISTANT: a cat" in prompt
    assert len(images) == len(j_images) == 1
    assert np.array_equal(np.asarray(images[0]), np.asarray(j_images[0]))
    for text in ("", "one", "two words here", " padded  text "):
        assert list(_word_deltas(text)) == list(j_words(text))
        assert "".join(_word_deltas(text)) == text


def test_dynamic_batching_coalesces_concurrent_requests(server):
    class SlowLMM(LMM):
        def __init__(self):
            self.batches = []

        def generate_until(self, requests):
            self.batches.append(len(requests))
            time.sleep(0.05)
            return [f"r{i}" for i in range(len(requests))]

        def loglikelihood(self, requests):
            return [(0.0, True)] * len(requests)

    lmm = SlowLMM()
    srv = server(lmm, max_batch=8, batch_window_ms=150)
    results = []

    def hit(i):
        out = _post(srv.port, {"messages": [
            {"role": "user", "content": f"q{i}"}]})
        results.append(out["choices"][0]["message"]["content"])
    threads = [threading.Thread(target=hit, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 6
    # six concurrent requests coalesce into far fewer dispatches
    assert srv.worker.dispatches <= 3 and max(lmm.batches) >= 2


def test_gen_kwargs_grouping_history_and_multi_image(server):
    class RecordingLMM(LMM):
        def __init__(self):
            self.calls = []

        def generate_until(self, requests):
            self.calls.append([r.args[1].get("max_new_tokens")
                               for r in requests])
            return ["r"] * len(requests)

        def loglikelihood(self, requests):
            return [(0.0, True)] * len(requests)

    lmm = RecordingLMM()
    srv = server(lmm, max_batch=8, batch_window_ms=200)
    outs = []

    def hit(mt):
        outs.append(_post(srv.port, {"max_tokens": mt, "messages": [
            {"role": "user", "content": "q"}]}))
    threads = [threading.Thread(target=hit, args=(mt,))
               for mt in (4, 4, 512)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    # different max_tokens never share a dispatch (the adapter reads the
    # kwargs of a batch's first request)
    assert len(outs) == 3
    assert sorted(map(sorted, lmm.calls)) == [[4, 4], [512]]

    seen = {}

    class Cap(LMM):
        def generate_until(self, requests):
            seen["prompt"] = requests[0].args[0]
            return ["x"] * len(requests)

        def loglikelihood(self, requests):
            return [(0.0, True)] * len(requests)

    srv2 = server(Cap())
    _post(srv2.port, {"messages": [
        {"role": "user", "content": "what is this?"},
        {"role": "assistant", "content": "a cat"},
        {"role": "user", "content": "what color?"}]})
    assert "ASSISTANT: a cat" in seen["prompt"]
    part = _image_part(_png_b64(size=(4, 4)))
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv2.port, {"messages": [
            {"role": "user", "content": [part, part]}]})
    assert err.value.code == 400
    assert "one image" in json.loads(err.value.read())["error"]["message"]


def test_generation_error_fails_the_wave_not_the_server(server):
    """An adapter error answers every request of its wave with a 400; the
    next wave is served."""
    class Flaky(LMM):
        def __init__(self):
            self.calls = 0

        def generate_until(self, requests):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("boom")
            return ["fine"] * len(requests)

        def loglikelihood(self, requests):
            return [(0.0, True)] * len(requests)

    srv = server(Flaky())
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(srv.port, {"messages": [{"role": "user", "content": "a"}]})
    assert err.value.code == 400
    assert json.loads(err.value.read())["error"] == {
        "message": "boom", "type": "RuntimeError"}
    out = _post(srv.port, {"messages": [{"role": "user", "content": "b"}]})
    assert out["choices"][0]["message"]["content"] == "fine"


def test_sse_streaming(server):
    srv = server(CannedLMM(), model_name="tiny")
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/chat/completions",
        data=json.dumps({"stream": True, "messages": [
            {"role": "user", "content": "hello world"}]}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        assert r.headers["Content-Type"] == "text/event-stream"
        body = r.read().decode()
    events = [line[len("data: "):] for line in body.split("\n")
              if line.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert text.startswith("ok:0img:hello world")
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)


def test_tiny_llava_served_matches_jax_server(tmp_path, server):
    """The tiny LLaVA behind both packages' servers, on the same weights (a
    JAX `.npz`): two concurrent image requests ride one wave of the port's
    server, and every answer equals the JAX server's and the port's own
    `generate_until`, under the greedy and the chunked backend."""
    from law_of_vision_representation_in_mllms_tpu.core.config import (
        RunConfig as JRunConfig)
    from law_of_vision_representation_in_mllms_tpu.eval.api import (
        Instance as JInstance)
    from law_of_vision_representation_in_mllms_tpu.eval.runner import (
        build_lmm as j_build_lmm)
    from law_of_vision_representation_in_mllms_tpu.io import param_io as jio
    from law_of_vision_representation_in_mllms_tpu.serve import (
        LMMServer as JServer)
    from law_of_vision_representation_in_mllms_torch.core.config import (
        RunConfig)
    from law_of_vision_representation_in_mllms_torch.eval.runner import (
        build_lmm)
    model = {"decoder": "tiny", "vision_tower": "debug/tiny-vit",
             "decode_chunk": 4}
    jlmm = j_build_lmm(JRunConfig.from_dict(
        {"model": model, "train": {"bf16": False}}))
    path = str(tmp_path / "llava.npz")
    jio.save_params(path, jlmm.params)
    lmm = build_lmm(RunConfig.from_dict(
        {"model": dict(model, checkpoint=path), "train": {"bf16": False}}),
        device="cpu")
    # CRC ids (the same prompts in every process); a differing answer must
    # part from the JAX one at a near tie of the JAX logits
    use_crc_ids(jlmm, lmm)
    jsrv = JServer(jlmm, port=0)
    jsrv.start_background()
    try:
        payloads = [{"max_tokens": 6, "messages": [{"role": "user",
                                                    "content": [
            _image_part(_png_b64(size=(40, 32), seed=i)),
            {"type": "text", "text": text}]}]}
            for i, text in enumerate(("describe the image",
                                      "what is shown here"))]
        want = [_post(jsrv.port, p)["choices"][0]["message"]["content"]
                for p in payloads]
    finally:
        jsrv.shutdown()
    jreqs = []
    for p in payloads:
        prompt, images = _parse_messages(p["messages"])
        jreqs.append(JInstance("generate_until", {}, len(jreqs), "serve",
                               (prompt, {"max_new_tokens": 6}),
                               visual=images))
    for backend in ("greedy", "chunked"):
        lmm.gen_backend = backend
        srv = server(lmm, max_batch=4, batch_window_ms=500)
        got = [None, None]

        def hit(i):
            got[i] = _post(srv.port, payloads[i])[
                "choices"][0]["message"]["content"]
        threads = [threading.Thread(target=hit, args=(i,)) for i in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        check_answers(jlmm, jreqs, want, got)
        assert _get(srv.port, "/health")["dispatches"] == 1
        # the served answers are the adapter's on the same prompts
        reqs = []
        for p in payloads:
            prompt, images = _parse_messages(p["messages"])
            reqs.append(Instance("generate_until", {}, len(reqs), "serve",
                                 (prompt, {"max_new_tokens": 6}),
                                 visual=images))
        assert lmm.generate_until(reqs) == got


def test_inflight_and_other_models_refused(monkeypatch):
    """`--inflight` and its flags reach `run_server` as the engine's
    arguments (the JAX CLI's defaults; without `--inflight` the flags are
    not used); `--model` other than llava points at ROADMAP item 4."""
    from law_of_vision_representation_in_mllms_torch import serve
    seen = []

    def fake_run_server(cfg, **kw):
        seen.append(kw)
        raise KeyboardInterrupt       # stop before anything is served
    monkeypatch.setattr(serve, "run_server", fake_run_server)
    for extra in (["--inflight"], ["--inflight", "--slots", "2",
                                   "--prefix-cache", "1", "--gen-cap", "64",
                                   "--prefix-cache-mb", "3",
                                   "--decode-chunk-serve", "16"],
                  ["--slots", "4"]):
        with pytest.raises(KeyboardInterrupt):
            cli.main(["serve", "--device", "cpu"] + extra)
    assert [kw["inflight"] for kw in seen] == [True, True, False]
    assert seen[0]["inflight_kwargs"] == {
        "n_slots": 4, "prompt_cap": 256, "gen_cap": 256, "chunk": 4,
        "prefix_cache": 0, "prefix_block": 64, "prefix_cache_bytes": 0}
    assert seen[1]["inflight_kwargs"] == {
        "n_slots": 2, "prompt_cap": 256, "gen_cap": 64, "chunk": 16,
        "prefix_cache": 1, "prefix_block": 64,
        "prefix_cache_bytes": 3 << 20}
    assert seen[2]["inflight_kwargs"] is None
    with pytest.raises(NotImplementedError, match="ROADMAP, queue 1: 4"):
        run_server(None, device="cpu", model="openai-api", port=0)


def test_cli_serve_builds_and_serves(monkeypatch, capsys):
    """`serve --device cpu` builds the tiny LLaVA of its `--set`s, takes
    `--gen-backend`, and serves until interrupted (here: at once)."""
    from law_of_vision_representation_in_mllms_torch import serve
    seen = {}

    def fake_forever(self):
        seen["lmm"] = self.lmm
        seen["port"] = self.port
        raise KeyboardInterrupt

    def fake_shutdown(self):
        # the HTTP loop never ran: `httpd.shutdown()` would wait for it
        seen["shutdown"] = True
        self.worker.shutdown()
        self.httpd.server_close()
    monkeypatch.setattr(serve.LMMServer, "serve_forever", fake_forever)
    monkeypatch.setattr(serve.LMMServer, "shutdown", fake_shutdown)
    rc = cli.main(["serve", "--device", "cpu", "--port", "0",
                   "--gen-backend", "chunked",
                   "--set", "model.decoder=tiny",
                   "--set", "model.vision_tower=debug/tiny-vit",
                   "--set", "train.bf16=false"])
    assert rc == 0
    assert seen["lmm"].gen_backend == "chunked" and seen["port"] > 0
    assert seen["shutdown"]
    assert "serving llava on http://127.0.0.1:" in capsys.readouterr().err
