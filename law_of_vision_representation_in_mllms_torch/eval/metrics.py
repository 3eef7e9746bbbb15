"""Metric functions + aggregation + bootstrap stderr.

Covers the metrics the 8 paper benchmarks use (`lmms_eval/api/metrics.py`
plus per-task utils): exact match, multiple-choice accuracy, the VQA-v2
soft accuracy with its answer normalization (`llava/eval/m4c_evaluator.py`
semantics), ANLS, and MME's per-category score.
"""

from __future__ import annotations

import re
import string
from typing import Dict, List, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# answer normalization (VQA protocol)
# ---------------------------------------------------------------------------

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't", "didnt": "didn't",
    "doesnt": "doesn't", "dont": "don't", "hadnt": "hadn't",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "im": "i'm",
    "ive": "i've", "isnt": "isn't", "itd": "it'd", "itll": "it'll",
    "lets": "let's", "maam": "ma'am", "mightve": "might've",
    "mustve": "must've", "shant": "shan't", "shed": "she'd",
    "shes": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "thats": "that's", "theres": "there's", "theyd": "they'd",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "wasnt": "wasn't", "wed": "we'd", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whats": "what's", "wheres": "where's",
    "whod": "who'd", "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't", "youd": "you'd",
    "youll": "you'll", "youre": "you're", "youve": "you've",
}

_NUMBERS = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
            "four": "4", "five": "5", "six": "6", "seven": "7",
            "eight": "8", "nine": "9", "ten": "10"}

_ARTICLES = {"a", "an", "the"}
_PUNCT = re.compile(r"[;/\[\]\"{}()=+\\_\-><@`,?!]")
_PERIOD = re.compile(r"(?<!\d)\.(?!\d)")


def vqa_normalize(ans: str) -> str:
    """VQA-v2 answer processing: punctuation, number words, articles,
    contractions."""
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _PUNCT.sub("", ans)
    ans = _PERIOD.sub("", ans)
    words = []
    for w in ans.split():
        w = _NUMBERS.get(w, w)
        if w in _ARTICLES:
            continue
        words.append(_CONTRACTIONS.get(w, w))
    return " ".join(words)


def vqa_accuracy(prediction: str, gt_answers: Sequence[str]) -> float:
    """VQA soft accuracy: min(#matching humans / 3, 1), averaged over
    leave-one-out subsets of the 10 annotators."""
    pred = vqa_normalize(prediction)
    gts = [vqa_normalize(a) for a in gt_answers]
    if len(gts) == 1:
        return float(pred == gts[0])
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        accs.append(min(1.0, sum(o == pred for o in others) / 3.0))
    return float(np.mean(accs))


def exact_match(prediction: str, target: str) -> float:
    return float(prediction.strip().lower() == target.strip().lower())


def levenshtein(a: str, b: str) -> int:
    """Edit distance (used by ANLS and mathvista's most-similar-choice)."""
    if not a or not b:
        return max(len(a), len(b))
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(prediction: str, targets: Sequence[str],
         threshold: float = 0.5) -> float:
    """Average normalized Levenshtein similarity."""
    p = prediction.strip().lower()
    best = 0.0
    for t in targets:
        t = t.strip().lower()
        d = levenshtein(p, t)
        s = 1 - d / max(len(p), len(t), 1)
        best = max(best, s if s >= threshold else 0.0)
    return best


_MC_PREFIX = re.compile(r"^\(?([A-E])\)?[.:)\s]?", re.IGNORECASE)


def parse_multi_choice(prediction: str, choices: Sequence[str],
                       letters: Sequence[str] = "ABCDE") -> str:
    """Extract a choice letter from a free-form answer (lmms-eval mmbench /
    seedbench-style parsing, simplified): leading letter, exact option text,
    or option-substring match."""
    pred = prediction.strip()
    m = _MC_PREFIX.match(pred)
    if m and (len(pred) <= 3 or not pred[m.end():m.end() + 1].isalnum()):
        return m.group(1).upper()
    low = pred.lower()
    for i, c in enumerate(choices):
        if low == str(c).strip().lower():
            return letters[i]
    for i, c in enumerate(choices):
        if str(c).strip().lower() and str(c).strip().lower() in low:
            return letters[i]
    return ""


# ---------------------------------------------------------------------------
# caption metrics (corpus-level)
# ---------------------------------------------------------------------------

_CAP_PUNCT = re.compile(r"[^\w\s]")


def caption_tokenize(text: str) -> List[str]:
    """Simplified PTB-style caption normalization: lowercase, strip
    punctuation, whitespace split. The reference pipes captions through
    Stanford PTBTokenizer (`pycocoevalcap.tokenizer`); for the scorer math
    below the only load-bearing steps are lowercasing + punctuation
    removal."""
    return _CAP_PUNCT.sub("", text.lower()).split()


def _ngram_counts(tokens: Sequence[str], max_n: int) -> Dict:
    counts: Dict = {}
    for n in range(1, max_n + 1):
        for i in range(len(tokens) - n + 1):
            key = tuple(tokens[i:i + n])
            counts[key] = counts.get(key, 0) + 1
    return counts


def cider_d(predictions: Sequence[str],
            references: Sequence[Sequence[str]],
            max_n: int = 4, sigma: float = 6.0) -> float:
    """Corpus CIDEr-D (Vedantam et al. 2015), matching
    `pycocoevalcap/cider/cider_scorer.py` (used by the reference's caption
    tasks, `lmms_eval/tasks/coco_cap/utils.py:46`): tf-idf n-gram vectors
    (n=1..4), idf from reference-set document frequency with
    ref_len=log(#docs), clipped cosine similarity per n, gaussian length
    penalty (sigma=6, length measured in bigram term-frequencies as the
    original code does), averaged over n and references, x10.

    Returns 0-10 (x100 when reported, per coco leaderboard convention —
    we keep the raw 0-10 scale like pycocoevalcap)."""
    assert len(predictions) == len(references)
    num_docs = len(predictions)
    if num_docs == 0:
        return 0.0
    ref_tok = [[_ngram_counts(caption_tokenize(r), max_n) for r in refs]
               for refs in references]
    hyp_tok = [_ngram_counts(caption_tokenize(p), max_n)
               for p in predictions]

    # document frequency: each distinct ngram counted once per ref SET
    df: Dict = {}
    for refs in ref_tok:
        for ng in set(k for r in refs for k in r):
            df[ng] = df.get(ng, 0) + 1
    ref_len = np.log(float(num_docs))

    def to_vec(cnts):
        vec = [dict() for _ in range(max_n)]
        norm = [0.0] * max_n
        length = 0
        for ng, tf in cnts.items():
            idf = ref_len - np.log(max(1.0, df.get(ng, 0.0)))
            k = len(ng) - 1
            w = float(tf) * idf
            vec[k][ng] = w
            norm[k] += w * w
            if k == 1:  # original counts length via bigram tf
                length += tf
        return vec, [np.sqrt(x) for x in norm], length

    def sim(vh, nh, lh, vr, nr, lr):
        delta = float(lh - lr)
        vals = np.zeros(max_n)
        for k in range(max_n):
            s = 0.0
            for ng, wh in vh[k].items():
                wr = vr[k].get(ng)
                if wr is not None:
                    s += min(wh, wr) * wr
            if nh[k] * nr[k] > 0:
                s /= nh[k] * nr[k]
            vals[k] = s * np.exp(-(delta ** 2) / (2 * sigma ** 2))
        return vals

    scores = []
    for hyp, refs in zip(hyp_tok, ref_tok):
        vh, nh, lh = to_vec(hyp)
        acc = np.zeros(max_n)
        for r in refs:
            vr, nr, lr = to_vec(r)
            acc += sim(vh, nh, lh, vr, nr, lr)
        scores.append(10.0 * float(np.mean(acc / max(len(refs), 1))))
    return float(np.mean(scores))


def corpus_bleu4(predictions: Sequence[str],
                 references: Sequence[Sequence[str]],
                 max_n: int = 4) -> float:
    """Corpus BLEU-4 with per-reference clipped counts and closest-length
    brevity penalty (`pycocoevalcap/bleu/bleu_scorer.py` semantics,
    uniform weights, 0-1 scale)."""
    match = np.zeros(max_n)
    total = np.zeros(max_n)
    hyp_len = ref_len = 0
    for pred, refs in zip(predictions, references):
        h = caption_tokenize(pred)
        rs = [caption_tokenize(r) for r in refs]
        hyp_len += len(h)
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1]
        hc = _ngram_counts(h, max_n)
        clip: Dict = {}
        for r in rs:
            for ng, c in _ngram_counts(r, max_n).items():
                clip[ng] = max(clip.get(ng, 0), c)
        for ng, c in hc.items():
            k = len(ng) - 1
            total[k] += c
            match[k] += min(c, clip.get(ng, 0))
    precisions = [(match[k] / total[k]) if total[k] else 0.0
                  for k in range(max_n)]
    if min(precisions) == 0.0:
        return 0.0
    bp = 1.0 if hyp_len > ref_len else np.exp(1 - ref_len / max(hyp_len, 1))
    return float(bp * np.exp(np.mean(np.log(precisions))))


def caption_aggregate(records: List[Dict]) -> float:
    """Corpus CIDEr-D over evaluator records (prediction + references)."""
    return cider_d([r["prediction"] for r in records],
                   [r["references"] for r in records])


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------

def aggregate_mean(values: Sequence[float]) -> float:
    return float(np.mean(values)) if len(values) else 0.0


def mme_aggregate(records: List[Dict]) -> float:
    """MME score: per category, acc (per question) + acc+ (both questions of
    an image right), each x100, summed over categories
    (`lmms_eval/tasks/mme/utils.py` semantics)."""
    by_cat: Dict[str, Dict[str, List]] = {}
    for r in records:
        cat = r["category"]
        img = r["image_id"]
        by_cat.setdefault(cat, {}).setdefault(img, []).append(r["correct"])
    total = 0.0
    for cat, imgs in by_cat.items():
        flat = [c for v in imgs.values() for c in v]
        acc = np.mean(flat)
        acc_plus = np.mean([all(v) for v in imgs.values()])
        total += 100.0 * acc + 100.0 * acc_plus
    return float(total)


def bootstrap_stderr(values: Sequence[float], n_resamples: int = 1000,
                     seed: int = 1234) -> float:
    """Bootstrap standard error of the mean (`api/metrics.py` bootstrap)."""
    v = np.asarray(values, np.float64)
    if len(v) <= 1:
        return 0.0
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(v), size=(n_resamples, len(v)))
    return float(np.std(v[idx].mean(axis=1), ddof=1))


METRICS = {
    "exact_match": exact_match,
    "vqa_accuracy": vqa_accuracy,
    "anls": anls,
}

def _pope_aggregate(records):
    from .tasks.paper_tasks import pope_aggregate
    return pope_aggregate(records)


def _hallusion_aggregate(records):
    from .tasks.paper_tasks import hallusion_aggregate
    return hallusion_aggregate(records)


def _llava_wild_aggregate(records):
    from .tasks.judged_tasks import llava_wild_aggregate
    return llava_wild_aggregate(records)


def _mmupd_dual(records):
    from .tasks.extra_tasks import mmupd_dual_accuracy
    return mmupd_dual_accuracy(records)["dual"]


AGGREGATIONS = {
    "mean": aggregate_mean,
    "mme": mme_aggregate,
    "pope_f1": _pope_aggregate,
    "cider": caption_aggregate,
    "hallusion_aacc": _hallusion_aggregate,
    "llava_wild": _llava_wild_aggregate,
    "mmupd_dual": _mmupd_dual,
}
