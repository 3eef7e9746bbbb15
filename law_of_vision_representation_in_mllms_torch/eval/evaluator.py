"""The evaluation loop (`lmms_eval/evaluator.py simple_evaluate/evaluate`).

Data parallelism follows the reference's doc-sharding scheme: each process
evaluates docs[process_index::process_count] and results are merged on host
(the reference uses accelerate gather; a one-process run needs no
collective — doc-sharded runs merge with `merge_process_results`). A copy of
the JAX package's `eval/evaluator.py`, which the port may not import.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .api import Instance, LMM
from .metrics import AGGREGATIONS, bootstrap_stderr
from .task import Task


def evaluate(model: LMM, tasks: Sequence[Task], *,
             process_index: int = 0, process_count: int = 1,
             log_samples: bool = False) -> Dict[str, Dict]:
    results: Dict[str, Dict] = {}
    for task in tasks:
        doc_ids = list(range(len(task.docs)))[process_index::process_count]
        requests = task.build_requests(doc_ids)
        if task.cfg.output_type == "generate_until":
            preds = model.generate_until(requests)
        elif task.cfg.output_type == "multiple_choice":
            # one loglikelihood per option; prediction = argmax option
            # (lm-eval mc protocol; `api/task.py` loglikelihood requests)
            flat = []
            counts = []
            for req in requests:
                options = req.doc["options"]
                counts.append(len(options))
                for opt in options:
                    flat.append(Instance("loglikelihood", req.doc,
                                         req.doc_id, req.task_name,
                                         (req.args[0], " " + str(opt)),
                                         visual=req.visual))
            lls = model.loglikelihood(flat)
            preds, k = [], 0
            for req, n in zip(requests, counts):
                scores = [lls[k + i][0] for i in range(n)]
                k += n
                preds.append(chr(ord("A") + int(np.argmax(scores))))
        else:
            preds = [str(p) for p, _ in model.loglikelihood(requests)]

        records = []
        for req, pred in zip(requests, preds):
            rec = task.process_results(req.doc, pred)
            rec["doc_id"] = req.doc_id
            rec["prediction"] = pred
            for key in _GROUP_KEYS:      # doc metadata for sub-scores
                if key not in rec and key in req.doc:
                    rec[key] = req.doc[key]
            records.append(rec)

        agg = aggregate_records(records, task.cfg.aggregation)
        agg["samples"] = records if log_samples else None
        results[task.name] = agg
    return results


def aggregate_records(records: List[Dict], agg_name: str) -> Dict:
    """Aggregate scored records into {value, stderr, n, groups} — the one
    tail shared by evaluate(), merge_process_results(), and `lvr
    merge-results`. Records WITHOUT a 'score' field are excluded from the
    mean (e.g. olympiadbench proof docs are submission-only in the
    reference and must not deflate the accuracy)."""
    if agg_name == "mean":
        scores = [r["score"] for r in records if "score" in r]
        value = float(np.mean(scores)) if scores else 0.0
        stderr = bootstrap_stderr(scores)
    else:
        value = AGGREGATIONS[agg_name](records)
        stderr = 0.0
    return {"value": value, "stderr": stderr, "n": len(records),
            "groups": group_breakdown(records)}


# record fields that denote a reporting sub-group (the lmms-eval tasks
# report per-category/subject/split sub-scores alongside the aggregate,
# e.g. seedbench by data_type, mmvet by capability, chartqa by split)
_GROUP_KEYS = ("category", "question_type", "capabilities", "split",
               "data_type", "domain", "problem_version", "upd_type")


def group_breakdown(records: List[Dict]) -> Dict[str, Dict[str, float]]:
    """Mean score per sub-group for every group-denoting field the task's
    records carry. Only meaningful for score-per-record tasks; records
    without a 'score' field (judged/caption protocols with their own
    aggregations) yield no breakdown."""
    out: Dict[str, Dict[str, float]] = {}
    for key in _GROUP_KEYS:
        groups: Dict[str, List[float]] = {}
        for r in records:
            if key in r and "score" in r and r[key] not in ("", None):
                groups.setdefault(str(r[key]), []).append(r["score"])
        if len(groups) > 1:
            out[key] = {g: float(np.mean(v)) for g, v in sorted(
                groups.items())}
    return out


def merge_process_results(per_process: List[Dict[str, Dict]],
                          tasks: Sequence[Task]) -> Dict[str, Dict]:
    """Merge doc-sharded results from multiple processes (host-side)."""
    merged = {}
    for task in tasks:
        recs = []
        for res in per_process:
            r = res[task.name]
            if r["samples"] is None:
                raise ValueError("merge requires log_samples=True")
            recs.extend(r["samples"])
        agg = aggregate_records(recs, task.cfg.aggregation)
        agg["samples"] = recs
        merged[task.name] = agg
    return merged


def simple_evaluate(model: LMM, task_paths: Sequence, *,
                    limit: Optional[int] = None, log_samples: bool = False,
                    process_index: int = 0, process_count: int = 1
                    ) -> Dict[str, Dict]:
    from .task import load_task
    overrides = {"limit": limit} if limit else {}
    tasks = [load_task(p, **overrides) for p in task_paths]
    return evaluate(model, tasks, process_index=process_index,
                    process_count=process_count, log_samples=log_samples)
