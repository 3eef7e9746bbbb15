"""Evaluation API: request instances + the abstract multimodal LM.

Mirrors lmms-eval's contract (`lmms_eval/api/instance.py:5-29`,
`lmms_eval/api/model.py:18-113`): a task turns documents into `Instance`
requests of type "generate_until" or "loglikelihood"; a model consumes
batches of instances and returns strings / (logprob, greedy-match) pairs.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Instance:
    request_type: str                 # "generate_until" | "loglikelihood"
    doc: Dict[str, Any]
    doc_id: int
    task_name: str
    # generate_until: (context, gen_kwargs); loglikelihood: (context, cont)
    args: Tuple
    visual: Optional[List[Any]] = None


class LMM(abc.ABC):
    """Abstract multimodal LM."""

    @abc.abstractmethod
    def generate_until(self, requests: List[Instance]) -> List[str]:
        ...

    @abc.abstractmethod
    def loglikelihood(self, requests: List[Instance]
                      ) -> List[Tuple[float, bool]]:
        ...
