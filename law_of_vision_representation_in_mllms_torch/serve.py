"""OpenAI-compatible model server: `serve` (counterpart of the JAX
package's `serve.py`, a copy: that module imports nothing of JAX itself, but
the port imports nothing of the JAX package).

Any LMM (the port's `LlavaLMM` included) is exposed behind a stdlib
`ThreadingHTTPServer` speaking the chat-completions dialect:

- `POST /v1/chat/completions`: messages with interleaved text and
  `image_url` data-URL parts; one choice with the generation, or an SSE
  stream (`stream: true`) that replays the finished text word by word;
- `GET /v1/models`: the single model;
- `GET /health`: liveness, the request and dispatch counts.

Requests are batched in waves (`_BatchWorker`): concurrent requests that
arrive within `batch_window_ms` of the first ride one `generate_until`
call, grouped by their generation kwargs, while the HTTP threads parse and
decode images. max_tokens / temperature / top_p / stop map onto the
generation kwargs the adapter understands.

With `inflight=True` (`serve --inflight`) every request goes through the
continuous-batching engine instead (`_InflightWorker` over
`models.inflight.InflightEngine`): the HTTP threads tokenise and preprocess,
the engine's thread alone touches the device, a `stream: true` request
receives its tokens as the engine produces them, and `/health` reports the
engine's counts under "inflight". The wave worker is not built then.
"""

from __future__ import annotations

import base64
import io
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from .eval.api import Instance, LMM

_DATA_URL = re.compile(r"^data:image/[\w.+-]+;base64,(.*)$", re.DOTALL)


def _parse_messages(messages: List[dict]):
    """Flatten chat messages into (prompt, images): text parts join in
    order, each image part becomes an '<image>' marker + a PIL image —
    the inverse of the JAX package's `openai-api` adapter's payload
    function (`eval/models_registry.py` _payload)."""
    from PIL import Image
    texts: List[str] = []
    images = []
    for msg in messages:
        role = msg.get("role")
        if role not in ("user", "system", "assistant"):
            continue
        content = msg.get("content", "")
        if role == "assistant":
            # keep multi-turn history in the prompt rather than dropping it
            if isinstance(content, str) and content:
                texts.append(f"ASSISTANT: {content}")
            continue
        if isinstance(content, str):
            texts.append(content)
            continue
        for part in content:
            if part.get("type") == "text":
                texts.append(part.get("text", ""))
            elif part.get("type") == "image_url":
                url = part["image_url"]["url"] if \
                    isinstance(part.get("image_url"), dict) else \
                    part.get("image_url", "")
                m = _DATA_URL.match(url)
                if not m:
                    raise ValueError(
                        "only data:image/...;base64 image_url parts are "
                        "supported (no egress from the server)")
                img = Image.open(io.BytesIO(
                    base64.b64decode(m.group(1)))).convert("RGB")
                images.append(img)
                texts.append("<image>")
    return "\n".join(t for t in texts if t), images


def _word_deltas(text: str):
    """Word-chunk replay of a finished generation for SSE clients."""
    words = text.split(" ")
    for i, w in enumerate(words):
        yield w if i == len(words) - 1 else w + " "


class _BatchWorker:
    """Dynamic request batching: a single worker thread drains the queue,
    waits up to ``window_ms`` after the first arrival for co-riders, and
    dispatches one ``generate_until`` call for the whole batch — the
    LlavaLMM adapter pads batched requests into one decode, so co-batched
    requests cost about one request's latency. (The sglang runtime the
    reference delegates to does the same thing server-side.)
    """

    def __init__(self, lmm: LMM, max_batch: int = 8,
                 window_ms: float = 5.0):
        import queue
        self.lmm = lmm
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.q: "queue.Queue" = queue.Queue()
        self.dispatches = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, inst: Instance) -> str:
        done = threading.Event()
        slot = {}
        self.q.put((inst, done, slot))
        done.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["text"]

    def _run(self):
        import queue
        while not self._stop:
            try:
                first = self.q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self.q.get(timeout=left))
                except queue.Empty:
                    break
            # group by generation kwargs: the LlavaLMM adapter reads
            # max_new_tokens/until from the first request of a chunk
            # (llava_adapter.py), so only same-kwargs requests may share
            # a dispatch
            groups: dict = {}
            for item in batch:
                # json, not tuple(sorted(...)): kwargs may hold lists
                # (`until` stop strings), which aren't hashable
                key = json.dumps(item[0].args[1], sort_keys=True,
                                 default=str) \
                    if len(item[0].args) > 1 else ""
                groups.setdefault(key, []).append(item)
            for group in groups.values():
                insts = [g[0] for g in group]
                try:
                    texts = self.lmm.generate_until(insts)
                    if len(texts) != len(insts):
                        raise RuntimeError(
                            f"adapter returned {len(texts)} results for "
                            f"{len(insts)} requests")
                    self.dispatches += 1
                    for (_, done, slot), text in zip(group, texts):
                        slot["text"] = text
                        done.set()
                except Exception as e:  # noqa: BLE001 — fail the batch
                    for _, done, slot in group:
                        slot["error"] = e
                        done.set()

    def shutdown(self):
        import queue
        self._stop = True
        self._thread.join(timeout=2)
        # fail any request still queued so its HTTP thread unblocks
        while True:
            try:
                _, done, slot = self.q.get_nowait()
            except queue.Empty:
                break
            slot["error"] = RuntimeError("server shutting down")
            done.set()


class _InflightWorker:
    """Continuous-batching worker: requests stream through the slot pool of
    `models.inflight.InflightEngine` instead of riding co-arrival waves. A
    request waits for a free slot, never for a longer neighbour to finish.
    Needs the port's `LlavaLMM` (its params, config, tokenizer and
    processors)."""

    def __init__(self, lmm, n_slots: int = 4, prompt_cap: int = 256,
                 gen_cap: int = 256, chunk: int = 4,
                 prefix_cache: int = 0, prefix_block: int = 64,
                 prefix_cache_bytes: int = 0):
        from .models.inflight import InflightEngine
        self.lmm = lmm
        self.engine = InflightEngine(
            lmm.params, lmm.cfg, eos_id=lmm.tok.eos_token_id,
            n_slots=n_slots, prompt_cap=prompt_cap, gen_cap=gen_cap,
            chunk=chunk, prefix_cache=prefix_cache,
            prefix_block=prefix_block,
            prefix_cache_bytes=prefix_cache_bytes)

    @property
    def dispatches(self):
        return self.engine.dispatches

    def _submit(self, inst: Instance):
        """Tokenise and preprocess on the calling thread, then queue."""
        import numpy as np
        from .data.preprocess import tokenizer_image_token
        from .eval.llava_adapter import sampling_knobs
        lmm = self.lmm
        ids = np.asarray(tokenizer_image_token(lmm._prompt(inst.args[0]),
                                               lmm.tok), np.int64)[None]
        pixels = [(lmm._pixel(inst.visual[0], proc) if inst.visual
                   else np.zeros((proc.crop, proc.crop, 3), np.float32))[None]
                  for proc in lmm.processors]
        kwargs = inst.args[1] if len(inst.args) > 1 else {}
        temperature, top_p = sampling_knobs(kwargs)
        return self.engine.submit(
            ids, np.ones_like(ids, bool), pixels,
            kwargs.get("max_new_tokens", 16), temperature=temperature,
            top_p=top_p), kwargs

    @staticmethod
    def _truncate(text: str, kwargs: dict) -> str:
        for stop in kwargs.get("until", []):
            if stop and stop in text:
                text = text.split(stop)[0]
        return text.strip()

    def submit(self, inst: Instance) -> str:
        handle, kwargs = self._submit(inst)
        row = handle.result(timeout=600).tolist()
        return self._truncate(self.lmm.tok.decode(row).strip(), kwargs)

    def submit_stream(self, inst: Instance):
        """Text deltas as the engine decodes: the growing token row is
        detokenised at each token and the new suffix sent; stops at the
        first stop string (the engine ends the slot at EOS or its budget by
        itself)."""
        handle, kwargs = self._submit(inst)
        stops = [s for s in kwargs.get("until", []) if s]
        row: list = []
        sent = ""
        try:
            for tok in handle.iter_tokens():
                row.append(int(tok))
                text = self.lmm.tok.decode(row).strip()
                cut = next((text.split(s)[0] for s in stops if s in text),
                           None)
                if cut is not None:
                    if cut[len(sent):]:
                        yield cut[len(sent):]
                    return
                if text.startswith(sent) and len(text) > len(sent):
                    yield text[len(sent):]
                    sent = text
        finally:
            # a stop string or a client that hung up (GeneratorExit): free
            # the slot instead of decoding to the budget; a no-op once done
            handle.cancel()

    def shutdown(self):
        self.engine.shutdown()


class LMMServer:
    """Serve one LMM instance over HTTP until ``shutdown()``. `inflight`
    serves through `_InflightWorker` with `inflight_kwargs` (n_slots,
    prompt_cap, gen_cap, chunk, prefix_cache, prefix_block,
    prefix_cache_bytes)."""

    def __init__(self, lmm: LMM, model_name: str = "lvr",
                 host: str = "127.0.0.1", port: int = 8000,
                 max_batch: int = 8, batch_window_ms: float = 5.0,
                 inflight: bool = False, inflight_kwargs: Optional[dict]
                 = None):
        self.lmm = lmm
        self.model_name = model_name
        self._count = 0
        self._count_lock = threading.Lock()
        if inflight:
            self.worker = _InflightWorker(lmm, **(inflight_kwargs or {}))
        else:
            self.worker = _BatchWorker(lmm, max_batch=max_batch,
                                       window_ms=batch_window_ms)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, payload: dict):
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/health":
                    payload = {"status": "ok", "requests": outer._count,
                               "dispatches": outer.worker.dispatches}
                    engine = getattr(outer.worker, "engine", None)
                    if engine is not None:
                        payload["inflight"] = engine.stats()
                    else:
                        payload["queued"] = outer.worker.q.qsize()
                    self._send(200, payload)
                elif self.path == "/v1/models":
                    self._send(200, {"object": "list", "data": [
                        {"id": outer.model_name, "object": "model"}]})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                if self.path.rstrip("/") != "/v1/chat/completions":
                    self._send(404, {"error": "not found"})
                    return
                try:
                    req = json.loads(self.rfile.read(
                        int(self.headers["Content-Length"])))
                    prompt, images = _parse_messages(req["messages"])
                    if len(images) > 1:
                        raise ValueError(
                            "this model accepts at most one image per "
                            "request (the LLaVA splice conditions on a "
                            "single image)")
                    gen_kwargs = {}
                    if "max_tokens" in req:
                        gen_kwargs["max_new_tokens"] = int(
                            req["max_tokens"])
                    if "temperature" in req:
                        gen_kwargs["temperature"] = float(
                            req["temperature"])
                    if "top_p" in req:
                        gen_kwargs["top_p"] = float(req["top_p"])
                    if "do_sample" in req:   # HF extension: greedy override
                        gen_kwargs["do_sample"] = bool(req["do_sample"])
                    if "stop" in req:      # OpenAI stop -> until strings
                        s = req["stop"]
                        gen_kwargs["until"] = \
                            [s] if isinstance(s, str) else list(s or [])
                    inst = Instance("generate_until", {}, 0,
                                    "serve", (prompt, gen_kwargs),
                                    visual=images or None)
                    if req.get("stream") and hasattr(outer.worker,
                                                     "submit_stream"):
                        # the inflight worker: each token as it is decoded
                        with outer._count_lock:
                            outer._count += 1
                            rid = outer._count
                        try:
                            self._send_stream(
                                rid, outer.worker.submit_stream(inst))
                        except OSError:
                            pass   # client hung up mid-stream
                        return
                    text = outer.worker.submit(inst)
                    with outer._count_lock:
                        outer._count += 1
                        rid = outer._count
                    if req.get("stream"):
                        try:
                            self._send_stream(rid, _word_deltas(text))
                        except OSError:
                            pass   # client hung up mid-stream: headers
                            # are already out, a JSON 400 would corrupt
                            # the half-written SSE response
                        return
                    self._send(200, {
                        "id": f"chatcmpl-{rid}",
                        "object": "chat.completion",
                        "model": outer.model_name,
                        "choices": [{
                            "index": 0,
                            "message": {"role": "assistant",
                                        "content": text},
                            "finish_reason": "stop"}],
                    })
                except Exception as e:  # noqa: BLE001 — surface as 400
                    self._send(400, {"error": {"message": str(e),
                                               "type": type(e).__name__}})

            def _send_stream(self, rid: int, deltas):
                """OpenAI SSE protocol (`stream: true`): role delta,
                content deltas, finish chunk, [DONE]. `deltas` yields text
                fragments: word chunks replaying a finished generation (the
                wave worker), or each token's text as the engine decodes
                it (the inflight worker), each flushed as it comes."""
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()

                def chunk(delta, finish=None):
                    payload = {"id": f"chatcmpl-{rid}",
                               "object": "chat.completion.chunk",
                               "model": outer.model_name,
                               "choices": [{"index": 0, "delta": delta,
                                            "finish_reason": finish}]}
                    self.wfile.write(
                        f"data: {json.dumps(payload)}\n\n".encode())
                    self.wfile.flush()
                chunk({"role": "assistant"})
                for d in deltas:
                    chunk({"content": d})
                chunk({}, finish="stop")
                self.wfile.write(b"data: [DONE]\n\n")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_port

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.worker.shutdown()


def run_server(cfg, *, device, model: str = "llava",
               host: str = "127.0.0.1", port: int = 8000,
               model_name: Optional[str] = None, max_batch: int = 8,
               batch_window_ms: float = 5.0, inflight: bool = False,
               inflight_kwargs: Optional[dict] = None) -> LMMServer:
    """CLI entry: build the adapter as `eval.runner.run_evaluation` does, on
    `device`, and serve it, in waves or (`inflight`) through the
    continuous-batching engine. Only `--model llava` is ported."""
    if model != "llava":
        raise NotImplementedError(
            f"serve model {model!r}: the adapter registry "
            f"(eval/models_registry.py) is not ported to the PyTorch "
            f"package yet (ROADMAP, queue 1: 4, the rest of the CLI and "
            f"eval)")
    from .eval.runner import build_lmm
    lmm = build_lmm(cfg, device=device)
    return LMMServer(lmm, model_name=model_name or model, host=host,
                     port=port, max_batch=max_batch,
                     batch_window_ms=batch_window_ms, inflight=inflight,
                     inflight_kwargs=inflight_kwargs)
