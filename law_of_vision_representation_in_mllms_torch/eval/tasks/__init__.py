"""The bundled task YAMLs (byte copies of the JAX package's 44) and their
doc hooks: the paper's benchmarks and the other plain ones
(`paper_tasks.py`), the judged, grounding, mathvista and extra task files.
`PAPER_TASKS` stays the paper's 11."""

import os

from . import paper_tasks  # noqa: F401  (registers doc hooks)
from . import judged_tasks  # noqa: F401  (GPT-judged tasks)
from . import grounding_tasks  # noqa: F401  (refcoco family)
from . import mathvista_tasks  # noqa: F401  (mathvista)
from . import extra_tasks  # noqa: F401  (cmmmu/mmupd/mathverse)

TASK_DIR = os.path.dirname(__file__)


def task_yaml(name: str) -> str:
    return os.path.join(TASK_DIR, f"{name}.yaml")


PAPER_TASKS = ["mme", "mmbench_en", "mmmu_val", "ok_vqa", "textvqa_val",
               "vizwiz_vqa_val", "scienceqa_img", "seed_image", "pope",
               "vqav2_val", "gqa"]
