"""The bundled task YAMLs and their doc hooks. Only the paper's benchmarks
(`paper_tasks.py`) are ported; the judged, grounding, mathvista and extra
task files of the JAX package come with queue 1, item 4 of the ROADMAP."""

import os

from . import paper_tasks  # noqa: F401  (registers doc hooks)

TASK_DIR = os.path.dirname(__file__)


def task_yaml(name: str) -> str:
    return os.path.join(TASK_DIR, f"{name}.yaml")


PAPER_TASKS = ["mme", "mmbench_en", "mmmu_val", "ok_vqa", "textvqa_val",
               "vizwiz_vqa_val", "scienceqa_img", "seed_image", "pope",
               "vqav2_val", "gqa"]
