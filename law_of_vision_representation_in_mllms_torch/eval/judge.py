"""Chat-completions judge client for the GPT-graded benchmarks.

The reference grades MM-Vet and LLaVA-Bench-in-the-Wild with GPT-4 through
the OpenAI chat-completions API (`lmms_eval/tasks/mmvet/utils.py:37-78`,
`lmms_eval/tasks/llava-in-the-wild/utils.py:50-86`). This is the same
stdlib-urllib client the `openai-api` LMM adapter uses, specialised for
text-only judging: point ``OPENAI_API_URL`` at any OpenAI-style endpoint
(tests use a local stub server), temperature-0 by default, bounded retries
with an empty-string fallback so scoring degrades to 0 instead of crashing
the eval run.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class ChatJudge:
    """Minimal OpenAI-compatible chat judge.

    Call with a user prompt (and optional system message); returns the
    assistant message content, or '' after ``retries`` failures — matching
    the reference's get_chat_response fallback (`mmvet/utils.py:76-78`).
    """

    def __init__(self, model: str = "gpt-4-0613",
                 api_url: Optional[str] = None,
                 api_key: Optional[str] = None,
                 retries: int = 3, retry_sleep: float = 0.0,
                 timeout: float = 60.0):
        self.model = model
        self.api_url = api_url or os.getenv(
            "OPENAI_API_URL", "https://api.openai.com/v1/chat/completions")
        self.api_key = api_key or os.getenv("OPENAI_API_KEY", "YOUR_API_KEY")
        self.retries = retries
        self.retry_sleep = retry_sleep
        self.timeout = timeout

    def __call__(self, prompt: str, system: Optional[str] = None,
                 max_tokens: int = 1024, temperature: float = 0.0) -> str:
        import urllib.request
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        payload = {"model": self.model, "messages": messages,
                   "max_tokens": max_tokens, "temperature": temperature}
        for attempt in range(self.retries):
            try:
                req = urllib.request.Request(
                    self.api_url,
                    data=json.dumps(payload).encode("utf-8"),
                    headers={"Content-Type": "application/json",
                             "Authorization": f"Bearer {self.api_key}"})
                with urllib.request.urlopen(req,
                                            timeout=self.timeout) as resp:
                    body = json.loads(resp.read().decode("utf-8"))
                content = body["choices"][0]["message"]["content"] or ""
                if content.strip():
                    return content.strip()
            except Exception:  # noqa: BLE001 — reference retries everything
                pass
            if attempt + 1 < self.retries and self.retry_sleep:
                time.sleep(self.retry_sleep)
        return ""


def judge_for_task(task) -> ChatJudge:
    """Build a judge from the task's yaml ``metadata:`` block
    (gpt_eval_model_name, like `mmvet/mmvet.yaml` metadata) + env vars."""
    meta = getattr(getattr(task, "cfg", None), "metadata", None) or {}
    return ChatJudge(model=meta.get("gpt_eval_model_name", "gpt-4-0613"),
                     retries=int(meta.get("judge_retries", 3)),
                     retry_sleep=float(meta.get("judge_retry_sleep", 0.0)))
