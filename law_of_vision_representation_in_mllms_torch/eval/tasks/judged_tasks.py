"""GPT-judged benchmarks: MM-Vet and LLaVA-Bench-in-the-Wild.

Both score free-form answers with a chat-completions judge instead of rule
matching (`lmms_eval/tasks/mmvet/utils.py`,
`lmms_eval/tasks/llava-in-the-wild/utils.py`). The grading rubrics below
are reproduced verbatim — like the conversation system prompts, they must
match the reference for protocol identity. The judge endpoint comes from
``OPENAI_API_URL``/``OPENAI_API_KEY`` (any OpenAI-style server).
"""

from __future__ import annotations

import numpy as np

from ..judge import judge_for_task
from ..task import register_function

# `mmvet/utils.py:24` MM_VET_PROMPT — few-shot grading rubric, verbatim.
MM_VET_PROMPT = """Compare the ground truth and prediction from AI models, to give a correctness score for the prediction. <AND> in the ground truth means it is totally right only when all elements in the ground truth are present in the prediction, and <OR> means it is totally right when any one element in the ground truth is present in the prediction. The correctness score is 0.0 (totally wrong), 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, or 1.0 (totally right). Just complete the last space of the correctness score.
gpt_query_prompt | Ground truth | Prediction | Correctness
--- | --- | --- | ---
What is x in the equation? | -1 <AND> -5 | x = 3 | 0.0
What is x in the equation? | -1 <AND> -5 | x = -1 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -5 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -5 or 5 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -1 or x = -5 | 1.0
Can you explain this meme? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme talks about Iceland and Greenland. It's pointing out that despite their names, Iceland is not very icy and Greenland isn't very green. | 0.4
Can you explain this meme? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme is using humor to point out the misleading nature of Iceland's and Greenland's names. Iceland, despite its name, has lush green landscapes while Greenland is mostly covered in ice and snow. The text 'This is why I have trust issues' is a playful way to suggest that these contradictions can lead to distrust or confusion. The humor in this meme is derived from the unexpected contrast between the names of the countries and their actual physical characteristics. | 1.0
"""

# `llava-in-the-wild/utils.py:55-57` judge system message, verbatim.
LLAVA_WILD_SYSTEM = ("You are a helpful and precise assistant for checking "
                     "the quality of the answer.")

# `llava-in-the-wild/rule.json` llava_bench_* rubrics, verbatim.
_WILD_RULE_TAIL = (
    "Please rate the helpfulness, relevance, accuracy, level of details of "
    "their responses. Each assistant receives an overall score on a scale "
    "of 1 to 10,"
    " where a higher score indicates better overall performance.\nPlease"
    " first output a single line containing only two "
    "values indicating the scores for Assistant 1 and 2, respectively. The "
    "two scores are separated by a space.\nIn the subsequent line, please "
    "provide a comprehensive explanation of your evaluation, avoiding any "
    "potential bias and ensuring that the order in which the responses "
    "were presented does not affect your judgment.")
LLAVA_WILD_RULES = {
    "conv": {"role": "Assistant", "prompt": (
        "We would like to request your feedback on the performance of two "
        "AI assistants in response to the user question displayed above. "
        "The user asks the question on observing an image. For your "
        "reference, the visual content in the image is represented with a "
        "few sentences describing the image. \n" + _WILD_RULE_TAIL)},
    "detail": {"role": "Assistant", "prompt": (
        "We would like to request your feedback on the performance of two "
        "AI assistants in response to the user question displayed above. "
        "The user asks the question on observing an image. For your "
        "reference, the visual content in the image is represented with a "
        "few sentences describing the image. \n" + _WILD_RULE_TAIL)},
    "complex": {"role": "Assistant", "prompt": (
        "We would like to request your feedback on the performance of two "
        "AI assistants in response to the user question displayed above. "
        "The user asks the question on observing an image. For your "
        "reference, the visual content in the image is represented with a "
        "few sentences describing the image. \n" + _WILD_RULE_TAIL)},
}


# ---- MM-Vet -----------------------------------------------------------------

@register_function("mmvet.doc_to_text")
def mmvet_doc_to_text(doc):
    # bare question (`mmvet/mmvet.yaml` doc_to_text)
    return doc["question"].strip()


@register_function("mmvet.process_results")
def mmvet_process_results(doc, prediction, task):
    """Judge-graded 0..1 correctness, stored x100 so the task value matches
    the reference's reported scale (`mmvet/utils.py:86-133`): the judge
    completes the rubric table row; non-parsable replies retry with
    increasing temperature, then score 0."""
    judge = judge_for_task(task)
    answer = str(doc["answer"]).replace("<AND>", " <AND> ") \
                               .replace("<OR>", " <OR> ")
    query = (f"{MM_VET_PROMPT}\n{doc['question']} | {answer} | "
             f"{prediction} |")
    score, temperature = 0.0, 0.0
    for _ in range(3):
        content = judge(query, max_tokens=8, temperature=temperature)
        try:
            val = float(content.split(" ")[0].strip())
            if 0.0 <= val <= 1.0:
                score = val
                break
        except ValueError:
            pass
        if not content:
            break
        temperature += 0.5
    return {"score": 100.0 * score,
            "capabilities": doc.get("capability", "")}


# ---- LLaVA-Bench-in-the-Wild ------------------------------------------------

@register_function("llava_wild.doc_to_text")
def llava_wild_doc_to_text(doc):
    return doc["question"].strip()


def _pairwise_judge(doc, prediction, task, rules, default_rule,
                    context_field):
    """Shared pairwise 1-10 grading vs the GPT-4 reference answer
    (`llava-in-the-wild/utils.py:116-175`, `ferret/utils.py:117-140`):
    judge sees the textual context, both answers, and the category
    rubric; first review line = two scores."""
    judge = judge_for_task(task)
    ctx = doc.get(context_field, [])
    context = "\n".join(ctx) if isinstance(ctx, list) else ctx
    rule = rules.get(doc.get("category", default_rule),
                     rules[default_rule])
    role = rule["role"]
    content = (f"[Context]\n{context}\n\n"
               f"[Question]\n{doc['question']}\n\n"
               f"[{role} 1]\n{doc.get('gpt_answer', '')}\n\n"
               f"[End of {role} 1]\n\n"
               f"[{role} 2]\n{prediction}\n\n[End of {role} 2]\n\n"
               f"[System]\n{rule['prompt']}\n\n")
    review = judge(content, system=LLAVA_WILD_SYSTEM, max_tokens=1024)
    try:
        pair = review.split("\n")[0].replace(",", " ").split()
        scores = [float(pair[0]), float(pair[1])] if len(pair) == 2 \
            else [-1.0, -1.0]
    except (ValueError, IndexError):
        scores = [-1.0, -1.0]
    return {"scores": scores, "category": doc.get("category", "")}


@register_function("llava_wild.process_results")
def llava_wild_process_results(doc, prediction, task):
    return _pairwise_judge(doc, prediction, task, LLAVA_WILD_RULES,
                           "conv", "caption")


def llava_wild_aggregate(records):
    """100 x mean(model)/mean(gpt4) over parsable reviews
    (`llava-in-the-wild/utils.py:178-194`)."""
    pairs = [r["scores"] for r in records
             if min(r["scores"]) > 0]
    if not pairs:
        return 0.0
    stats = np.asarray(pairs).mean(axis=0)
    return round(float(stats[1] / stats[0] * 100), 1)


# ---- Ferret-Bench -----------------------------------------------------------

# `ferret/rule.json` rubrics, verbatim. All three categories share the
# scene-context preamble; ground_conv adds the coordinate-precision rule.
_FERRET_PREAMBLE = (
    "We would like to request your feedback on the performance of two AI "
    "assistants in response to the user question displayed above. The "
    "user asks the question about specific region of an image. For your "
    "reference, the visual content in the image is represented with five "
    "descriptive sentences describing the same image. In addition, "
    "specific object locations within the image are given, along with "
    "detailed coordinates. These coordinates are in the form of bounding "
    "boxes, represented as (x1, y1, x2, y2) with floating numbers ranging "
    "from 0 to 1. These values correspond to the top left x, top left y, "
    "bottom right x, and bottom right y. Also, the relationships between "
    "pairs of objects are provided, in the format of object -> "
    "relationship -> subject, where the object/subject are indexed by "
    "object id from previous object lists as well as the object names. "
    "Also, several region description are given, each describing a box "
    "region of image, with detailed coordinates. \n")
_FERRET_TAIL = (
    "Each assistant receives an overall score on a scale of 1 to 10, "
    "where a higher score indicates better overall performance.\nPlease "
    "first output a single line containing only two values indicating "
    "the scores for Assistant 1 and 2, respectively. The two scores are "
    "separated by a space.\nIn the subsequent line, please provide a "
    "comprehensive explanation of your evaluation, avoiding any "
    "potential bias and ensuring that the order in which the responses "
    "were presented does not affect your judgment.")
FERRET_RULES = {
    "refer_desc": {"role": "Assistant", "prompt": _FERRET_PREAMBLE + (
        "Please rate the spatial correspondence, helpfulness, relevance, "
        "accuracy, level of details of their responses. ") + _FERRET_TAIL},
    "refer_reason": {"role": "Assistant", "prompt": _FERRET_PREAMBLE + (
        "Please rate the spatial correspondence, helpfulness, relevance, "
        "accuracy, level of details of their responses. ") + _FERRET_TAIL},
    "ground_conv": {"role": "Assistant", "prompt": (
        _FERRET_PREAMBLE.replace(
            "asks the question about specific region of an image",
            "asks the question that requires model to predict the "
            "coordinates of relevant object") +
        "Please rate the predicted coordinates, helpfulness, relevance, "
        "accuracy, level of details of their responses. Specifically, "
        "pay your attention to the precision of the coordinates and "
        "whether it matches the object. Small deviation (<20% of "
        "ground-truth box width or height) of coordinates is allowed and "
        "shouldn't be punished. More than that, the degree of deviation "
        "should be reflected in scoring too.  ") + _FERRET_TAIL},
}


@register_function("ferret.doc_to_text")
def ferret_doc_to_text(doc):
    return doc["question"].strip()


@register_function("ferret.process_results")
def ferret_process_results(doc, prediction, task):
    """Same pairwise machinery with ferret's scene-graph context and
    category rubrics; per-category sub-scores come via the evaluator's
    group breakdown."""
    return _pairwise_judge(doc, prediction, task, FERRET_RULES,
                           "refer_desc", "context")
