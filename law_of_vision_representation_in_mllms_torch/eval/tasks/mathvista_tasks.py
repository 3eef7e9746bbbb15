"""MathVista (testmini) — math reasoning over charts/figures
(`lmms_eval/tasks/mathvista`).

The reference extracts the final answer from the model's free-form response
with GPT (`mathvista_evals.py:114-160` extract_answer -> chat judge over a
few-shot DEMO_PROMPT), then normalizes it per answer type and compares
exactly (`:171-233`). Here extraction is rule-first (direct choice/number
parses + the quick-extract regex + a final-line heuristic) and falls back
to the chat judge only when rules fail AND a judge endpoint is configured
(``OPENAI_API_URL``), so the task runs fully offline on well-formed model
output.
"""

from __future__ import annotations

import re

from ..metrics import levenshtein
from ..task import register_function

# `mathvista_evals.py:8` few-shot extraction prompt, abbreviated to the
# instruction line (the judge sees query+response, same contract).
EXTRACT_INSTRUCTION = (
    "Please read the following example. Then extract the answer from the "
    "model response and type it at the end of the prompt.")


@register_function("mathvista.doc_to_text")
def mathvista_doc_to_text(doc):
    """The HF dataset ships a prebuilt `query` (hint + question + choices);
    fall back to assembling one (`mathvista_evals.py` create_one_query)."""
    if doc.get("query"):
        return doc["query"]
    parts = []
    if doc.get("hint"):
        parts.append(f"Hint: {doc['hint']}")
    parts.append(f"Question: {doc['question']}")
    if doc.get("choices"):
        letters = [chr(ord("A") + i) for i in range(len(doc["choices"]))]
        opts = "\n".join(f"({l}) {c}"
                         for l, c in zip(letters, doc["choices"]))
        parts.append(f"Choices:\n{opts}")
    return "\n".join(parts)


def extract_answer(response: str, doc) -> str:
    """Rule-based port of `mathvista_evals.py:114-160`: direct choice
    match, int/float parse, the quick-extract regex, then a last-line /
    'answer is X' heuristic in place of the GPT call."""
    response = response.strip()
    if not response:
        return ""
    choices = doc.get("choices") or []
    if doc.get("question_type") == "multi_choice" and response in choices:
        return response
    if doc.get("answer_type") == "integer":
        try:
            return str(int(response))
        except ValueError:
            pass
    if doc.get("answer_type") == "float":
        try:
            return str(float(response))
        except ValueError:
            pass
    m = re.search(r'The answer is "(.*)"\.', response)
    if m:
        return m.group(1)
    m = re.search(r"(?:answer is|Answer:)\s*\(?([^\n.]+?)\)?\s*(?:\.|$)",
                  response, re.IGNORECASE)
    if m:
        return m.group(1).strip()
    if doc.get("answer_type") in ("integer", "float"):
        nums = re.findall(r"-?\d+(?:\.\d+)?", response)
        if nums:
            return nums[-1]  # final value convention (the hint asks for it)
    # judge fallback only when an endpoint is configured
    import os
    if os.getenv("OPENAI_API_URL"):
        from ..judge import ChatJudge
        judge = ChatJudge()
        out = judge(f"{EXTRACT_INSTRUCTION}\n\n"
                    f"{doc.get('query', doc.get('question', ''))}\n\n"
                    f"Model response: {response}\n\nExtracted answer: ",
                    max_tokens=256)
        if out:
            return out
    return response.splitlines()[-1].strip()


def normalize_answer(extraction: str, doc) -> str:
    """`mathvista_evals.py:171-217`: letter->choice text (most-similar by
    edit distance when no exact letter), int/float rounding to the doc's
    precision, str() for lists."""
    qtype = doc.get("question_type")
    atype = doc.get("answer_type")
    choices = doc.get("choices") or []
    if qtype == "multi_choice":
        extraction = str(extraction).strip()
        letters = re.findall(r"\(([a-zA-Z])\)", extraction)
        if letters:
            extraction = letters[0].upper()
        options = [chr(ord("A") + i) for i in range(len(choices))]
        if extraction in options:
            return choices[options.index(extraction)]
        dists = [levenshtein(extraction, str(c)) for c in choices]
        return choices[dists.index(min(dists))] if choices else extraction
    if atype == "integer":
        try:
            return str(int(float(extraction)))
        except (ValueError, TypeError):
            return ""
    if atype == "float":
        try:
            return str(round(float(extraction),
                             int(doc.get("precision") or 0)))
        except (ValueError, TypeError):
            return ""
    return str(extraction)


@register_function("mathvista.process_results")
def mathvista_process_results(doc, prediction, task):
    extraction = extract_answer(prediction, doc)
    norm = normalize_answer(extraction, doc)
    answer = doc.get("answer")
    correct = (str(norm).strip() == str(answer).strip()) \
        if answer is not None else False
    return {"score": float(correct), "extraction": extraction,
            "normalized": norm,
            "question_type": doc.get("question_type", "")}
