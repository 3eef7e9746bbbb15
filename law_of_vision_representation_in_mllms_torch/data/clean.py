"""Conversation-JSON cleanup (a copy of the JAX package's `data/clean.py`,
the reference's `data_process.py:1-17`).

The reference's one-off script strips records whose conversations are
malformed (missing turns, empty values, role order violations); here it is
a library function and a file-to-file entry with a report.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple


def clean_conversations(records: List[Dict]) -> Tuple[List[Dict], Dict]:
    """Drop malformed records; returns (clean, report)."""
    clean, dropped = [], {"empty": 0, "role_order": 0, "odd_turns": 0}
    for rec in records:
        conv = rec.get("conversations") or []
        if len(conv) < 2 or len(conv) % 2:
            dropped["odd_turns"] += 1
            continue
        if any(not (s.get("value") or "").strip() for s in conv):
            dropped["empty"] += 1
            continue
        roles_ok = all(
            s.get("from") == ("human" if i % 2 == 0 else "gpt")
            for i, s in enumerate(conv))
        if not roles_ok:
            dropped["role_order"] += 1
            continue
        clean.append(rec)
    report = {"kept": len(clean), "dropped": dropped,
              "total": len(records)}
    return clean, report


def clean_file(in_path: str, out_path: str) -> Dict:
    with open(in_path) as f:
        records = json.load(f)
    clean, report = clean_conversations(records)
    with open(out_path, "w") as f:
        json.dump(clean, f)
    return report
