"""Doc hooks for the 8 paper benchmarks (README.md Table / SURVEY §6.1).

Each benchmark's prompt format and scoring follows the lmms-eval task
implementations the reference forks (`lmms_eval/tasks/<name>/{*.yaml,
utils.py}`):

- mme: yes/no questions, "Answer the question using a single word or
  phrase."; per-category acc + acc+ summed (utils.mme_aggregate_results).
- mmbench_en / scienceqa_img / seed_image / mmmu_val: multiple choice with
  lettered options, "Answer with the option's letter from the given choices
  directly."
- ok_vqa / vizwiz_vqa_val / textvqa_val: open VQA with the VQA-v2 soft
  accuracy over 10 annotator answers; vizwiz adds the 'Unanswerable' hint.

Datasets are local JSON (see Task docstring) with fields noted per hook.
"""

from __future__ import annotations

import os
from typing import Dict, List

from ..metrics import (exact_match, parse_multi_choice, vqa_accuracy)
from ..task import register_function

MC_SUFFIX = ("Answer with the option's letter from the given choices "
             "directly.")
WORD_SUFFIX = "Answer the question using a single word or phrase."
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"


def _image_loader(doc: Dict, image_root: str) -> List:
    if not doc.get("image"):
        return []
    from PIL import Image
    return [Image.open(os.path.join(image_root, doc["image"]))]


register_function("common.doc_to_visual")(_image_loader)


# ---- MME -------------------------------------------------------------------

@register_function("mme.doc_to_text")
def mme_doc_to_text(doc):
    # mme questions already end with the instruction in the source data;
    # add it when absent (lmms_eval/tasks/mme/utils.py doc_to_text)
    q = doc["question"].strip()
    if WORD_SUFFIX not in q:
        q = f"{q}\n{WORD_SUFFIX}"
    return q


@register_function("mme.process_results")
def mme_process_results(doc, prediction, task):
    pred = prediction.strip().lower().rstrip(".")
    ans = doc["answer"].strip().lower()
    if pred.startswith("yes"):
        pred = "yes"
    elif pred.startswith("no"):
        pred = "no"
    correct = pred == ans
    return {"score": float(correct), "correct": correct,
            "category": doc["category"],
            "image_id": doc.get("image_id", doc.get("image", ""))}


# ---- multiple choice --------------------------------------------------------

def _mc_text(doc):
    opts = doc["options"]
    lines = [doc["question"].strip()]
    if doc.get("hint"):
        lines.insert(0, doc["hint"].strip())
    for i, o in enumerate(opts):
        lines.append(f"{LETTERS[i]}. {o}")
    lines.append(MC_SUFFIX)
    return "\n".join(lines)


def _mc_results(doc, prediction, task):
    letter = parse_multi_choice(prediction, doc["options"],
                                LETTERS[:len(doc["options"])])
    target = doc["answer"].strip().upper()
    if target not in LETTERS[:len(doc["options"])]:
        # answer given as option text
        target = LETTERS[doc["options"].index(doc["answer"])]
    return {"score": float(letter == target), "parsed": letter,
            "target": target}


for _name in ("mmbench_en", "mmmu_val", "scienceqa_img", "seed_image"):
    register_function(f"{_name}.doc_to_text")(_mc_text)
    register_function(f"{_name}.process_results")(_mc_results)


# ---- open VQA ---------------------------------------------------------------

@register_function("vqa.doc_to_text")
def vqa_doc_to_text(doc):
    return f"{doc['question'].strip()}\n{WORD_SUFFIX}"


@register_function("vizwiz.doc_to_text")
def vizwiz_doc_to_text(doc):
    return (f"{doc['question'].strip()}\nWhen the provided information is "
            "insufficient, respond with 'Unanswerable'.\n" + WORD_SUFFIX)


@register_function("vqa.process_results")
def vqa_process_results(doc, prediction, task):
    answers = doc["answers"]
    return {"score": vqa_accuracy(prediction, answers)}


@register_function("gqa.process_results")
def gqa_process_results(doc, prediction, task):
    # GQA: single ground-truth answer, exact match after the m4c
    # normalization (`lmms_eval/tasks/gqa/utils.py`)
    from ..metrics import vqa_normalize
    pred = vqa_normalize(prediction)
    ans = vqa_normalize(str(doc["answer"]))
    return {"score": float(pred == ans)}


# ---- POPE (object-hallucination probing; `llava/eval/model_pope_dist.py`,
# `eval_pope.py` + lmms_eval/tasks/pope) ----------------------------------

@register_function("pope.doc_to_text")
def pope_doc_to_text(doc):
    return f"{doc['question'].strip()}\n{WORD_SUFFIX}"


@register_function("pope.process_results")
def pope_process_results(doc, prediction, task):
    pred = prediction.strip().lower().rstrip(".")
    pred = "yes" if pred.startswith("yes") else (
        "no" if pred.startswith("no") else pred)
    ans = doc["answer"].strip().lower()
    return {"score": float(pred == ans), "pred_yes": pred == "yes",
            "gt_yes": ans == "yes"}


@register_function("pope.aggregate")
def pope_aggregate(records):
    """accuracy/precision/recall/F1/yes-ratio (`eval_pope.py` semantics);
    the scalar value reported is the F1 score."""
    tp = sum(r["pred_yes"] and r["gt_yes"] for r in records)
    fp = sum(r["pred_yes"] and not r["gt_yes"] for r in records)
    fn = sum(not r["pred_yes"] and r["gt_yes"] for r in records)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return f1


# ---- beyond the paper's 8: widely-run lmms-eval tasks ------------------------

# ai2d: diagram MC, same letter protocol (`lmms_eval/tasks/ai2d/utils.py`)
register_function("ai2d.doc_to_text")(_mc_text)
register_function("ai2d.process_results")(_mc_results)


@register_function("docvqa.doc_to_text")
def docvqa_doc_to_text(doc):
    # lmms_eval/tasks/docvqa/utils.py: bare question + short-answer prompt
    return f"{doc['question'].strip()}\n{WORD_SUFFIX}"


@register_function("docvqa.process_results")
def docvqa_process_results(doc, prediction, task):
    """ANLS over the annotator answers (`docvqa/utils.py` anls metric)."""
    from ..metrics import anls
    return {"score": anls(prediction, doc["answers"])}


@register_function("chartqa.doc_to_text")
def chartqa_doc_to_text(doc):
    # chartqa.yaml: "\nAnswer the question with a single word."
    return (f"{doc['question'].strip()}\n"
            "Answer the question with a single word.")


def relaxed_correctness(prediction: str, target: str,
                        max_relative_change: float = 0.05) -> bool:
    """ChartQA relaxed accuracy (`chartqa/utils.py:25-63`): numeric answers
    correct within 5% relative error, non-numeric require exact
    (case-insensitive) match; percent signs divide by 100."""
    def to_float(text):
        try:
            if text.endswith("%"):
                return float(text.rstrip("%")) / 100.0
            return float(text)
        except ValueError:
            return None
    p, t = to_float(prediction.strip()), to_float(str(target).strip())
    if p is not None and t:
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction.strip().lower() == str(target).strip().lower()


@register_function("chartqa.process_results")
def chartqa_process_results(doc, prediction, task):
    answers = doc["answers"] if isinstance(doc.get("answers"), list) \
        else [doc["answer"]]
    return {"score": float(any(relaxed_correctness(prediction, a)
                               for a in answers))}


@register_function("ocrbench.doc_to_text")
def ocrbench_doc_to_text(doc):
    return doc["question"].strip()


@register_function("ocrbench.process_results")
def ocrbench_process_results(doc, prediction, task):
    """Substring containment scoring (`ocrbench/utils.py:33-66`): the
    normalized ground truth must appear in the normalized prediction;
    HME100k (math expressions) strips spaces instead of lowercasing."""
    ans = doc["answer"]
    answers = ans if isinstance(ans, list) else [ans]
    pred = prediction.lower().strip()
    if doc.get("dataset") == "HME100k":
        p = prediction.strip().replace("\n", " ").replace(" ", "")
        hit = any(str(a).strip().replace("\n", " ").replace(" ", "") in p
                  for a in answers)
    else:
        p = pred.strip().replace("\n", " ")
        hit = any(str(a).lower().strip().replace("\n", " ") in p
                  for a in answers)
    return {"score": float(hit),
            "question_type": doc.get("question_type", "")}


# ---- caption family: coco_cap / textcaps / nocaps / flickr30k ---------------

@register_function("caption.doc_to_text")
def caption_doc_to_text(doc):
    # all four caption tasks use the same prompt
    # (`lmms_eval/tasks/coco_cap/utils.py:22-23`, nocaps/textcaps prompt kwarg)
    return "Provide a one-sentence caption for the provided image."


@register_function("caption.process_results")
def caption_process_results(doc, prediction, task):
    """Store references; corpus CIDEr-D happens at aggregation time
    (`coco_cap/utils.py:26-56` stashes pred+answer the same way)."""
    ans = doc.get("answers", doc.get("answer"))
    refs = ans if isinstance(ans, list) else [ans]
    return {"references": [str(r) for r in refs]}


# ---- ANLS family: infovqa / stvqa / multidocvqa -----------------------------
# same bare-question + single-word prompt and ANLS scoring as docvqa
# (`lmms_eval/tasks/{infovqa,stvqa,multidocvqa}`; post_prompt in their yamls)
for _name in ("infovqa", "stvqa", "multidocvqa"):
    register_function(f"{_name}.doc_to_text")(docvqa_doc_to_text)
    register_function(f"{_name}.process_results")(docvqa_process_results)

# seedbench_2: same lettered-MC protocol as seedbench
# (`lmms_eval/tasks/seedbench_2/utils.py` seed_doc_to_text/process_result)
register_function("seedbench_2.doc_to_text")(_mc_text)
register_function("seedbench_2.process_results")(_mc_results)


@register_function("realworldqa.doc_to_text")
def realworldqa_doc_to_text(doc):
    # options are embedded in the question text upstream
    # (`realworldqa/utils.py:12-25`)
    return doc["question"].strip()


@register_function("realworldqa.process_results")
def realworldqa_process_results(doc, prediction, task):
    """Exact match after the reference's flexible-extract filter chain
    (`realworldqa/realworldqa.yaml` filter_list: number-words->digits then
    a '(A)'-style letter grab). Letter answers pull the first standalone
    letter; open answers go through the VQA normalizer (which maps number
    words to digits and strips articles/punctuation)."""
    import re as _re
    from ..metrics import vqa_normalize
    ans = str(doc["answer"]).strip().lower()
    pred = prediction.strip().lower()
    if len(ans) == 1 and ans.isalpha():
        m = _re.search(r"\(([a-z])\)", pred) or \
            _re.match(r"^([a-z])\b", pred)
        got = m.group(1) if m else pred.strip(" .")
        return {"score": float(got == ans)}
    return {"score": float(vqa_normalize(pred) == vqa_normalize(ans))}


# ---- hallusion_bench --------------------------------------------------------

@register_function("hallusion.doc_to_text")
def hallusion_doc_to_text(doc):
    # bare question (`hallusion_bench/evaluate_hb.py:17-22`)
    return doc["question"].strip()


@register_function("hallusion.process_results")
def hallusion_process_results(doc, prediction, task):
    """Yes/no correctness. The reference grades with a GPT judge
    (`evaluate_hb.py` evaluate_by_chatgpt -> 0/1/2); offline we parse the
    yes/no directly, keeping the 0/1/2 convention (2 = uncertain)."""
    import re as _re
    p = prediction.lower()
    if _re.search(r"\byes\b", p):
        parsed = 1
    elif _re.search(r"\bno\b|\bnot\b", p):
        parsed = 0
    else:
        parsed = 2
    return {"correct": int(parsed == int(doc["gt_answer"])),
            "category": doc.get("category", ""),
            "subcategory": doc.get("subcategory", ""),
            "set_id": str(doc.get("set_id", "")),
            "figure_id": str(doc.get("figure_id", "")),
            "question_id": str(doc.get("question_id", ""))}


def hallusion_all(records):
    """aAcc / qAcc / fAcc (`hallusion_bench/utils.py` get_eval_all /
    get_eval_pair_all / get_eval_fig): per-answer accuracy; per question
    group (all figure variants of a question right); per figure group (all
    questions about a figure right, VS figure_id 0 control rows skipped)."""
    a_acc = 100.0 * sum(r["correct"] for r in records) / max(len(records), 1)

    def _group_acc(key_fn, skip=None):
        groups = {}
        for r in records:
            if skip and skip(r):
                continue
            groups.setdefault(key_fn(r), []).append(r["correct"])
        if not groups:
            return 0.0
        return 100.0 * sum(all(v) for v in groups.values()) / len(groups)

    q_acc = _group_acc(lambda r: (r["category"], r["subcategory"],
                                  r["set_id"], r["question_id"]))
    f_acc = _group_acc(lambda r: (r["category"], r["subcategory"],
                                  r["set_id"], r["figure_id"]),
                       skip=lambda r: r["category"] == "VS" and
                       r["figure_id"] == "0")
    return {"aAcc": round(a_acc, 4), "qAcc": round(q_acc, 4),
            "fAcc": round(f_acc, 4)}


def hallusion_aggregate(records):
    """Task value = aAcc; the qAcc/fAcc breakdown comes via
    hallusion_all on the logged samples."""
    return hallusion_all(records)["aAcc"]


# ---- iconqa -----------------------------------------------------------------

@register_function("iconqa.doc_to_text")
def iconqa_doc_to_text(doc):
    """Three question types (`iconqa/utils.py:27-51`): image choice,
    text choice (comma-joined `choices` field), or fill-in-the-blank."""
    q = doc["question"].strip()
    qt = doc.get("ques_type", "fill_in_blank")
    if qt == "choose_img":
        opts = "The first image. The second image."
        return (f"{q}\nOptions: {opts}\n"
                "Answer with the option you think is correct.")
    if qt == "choose_txt":
        opts = " ".join(f"{c.strip()}." for c in
                        str(doc.get("choices", "")).split(","))
        return (f"{q}\nOptions: {opts}\n"
                "Answer with the option you think is correct.")
    return f"{q}\n{WORD_SUFFIX}"


@register_function("iconqa.process_results")
def iconqa_process_results(doc, prediction, task):
    # ANLS over the single answer (`iconqa/utils.py:54-58`)
    from ..metrics import anls
    return {"score": anls(prediction, [str(doc["answer"])])}


# ---- websrc: web-page QA scored by set-token F1 -----------------------------

@register_function("websrc.doc_to_text")
def websrc_doc_to_text(doc):
    # question + short-answer suffix (`websrc/utils.py:16-28` construct
    # prompt: "Answer the question using a single word or phrase.")
    return f"{doc['question'].strip()}\n{WORD_SUFFIX}"


@register_function("websrc.process_results")
def websrc_process_results(doc, prediction, task):
    """Set-based token F1 between answer and prediction
    (`websrc/utils.py:130-153`: lowercase, word/punct tokenize, set
    precision/recall)."""
    import re as _re

    def toks(t):
        return set(_re.findall(r"\w+|[^\w\s]", str(t).lower().strip()))
    sa, sb = toks(doc["answer"]), toks(prediction)
    if not sa or not sb:
        return {"score": 0.0, "domain": doc.get("domain", "")}
    comm = sa & sb
    prec, rec = len(comm) / len(sb), len(comm) / len(sa)
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    return {"score": f1, "domain": doc.get("domain", "")}
