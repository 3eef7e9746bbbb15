"""YAML-configured tasks (a copy of the JAX package's `eval/task.py`, which
the port may not import).

Keeps lmms-eval's task contract (`lmms_eval/api/task.py ConfigurableTask`,
`tasks/__init__.py` registry): a YAML file names the dataset, the
doc->text/visual/target hooks (dotted python paths registered in
`FUNCTION_REGISTRY`, replacing the `!function utils.fn` YAML tag), the
generation kwargs, and the metric/aggregation pair.

Dataset backends are pluggable and hermetic: "json" (local file; list of
dicts, image paths relative to `image_root`) by default, "hf" when the
datasets library + local cache are available. The reference hard-depends on
HF hub downloads (`tasks/mme/mme.yaml:1`), which cannot work offline.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import Any, Callable, Dict, List, Optional

from .api import Instance

FUNCTION_REGISTRY: Dict[str, Callable] = {}


def register_function(name: str):
    def deco(fn):
        FUNCTION_REGISTRY[name] = fn
        return fn
    return deco


def _resolve(name_or_path: Optional[str]) -> Optional[Callable]:
    if name_or_path is None:
        return None
    if name_or_path in FUNCTION_REGISTRY:
        return FUNCTION_REGISTRY[name_or_path]
    mod, _, attr = name_or_path.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


class LazyVisual:
    """List-like that defers (and caches) image decoding to first access.
    `release()` drops the decoded images; the adapter calls it after
    preprocessing so a long eval never holds more than one batch of
    pixels."""

    __slots__ = ("_fn", "_val")

    def __init__(self, fn: Callable[[], List]):
        self._fn = fn
        self._val = None

    def _load(self) -> List:
        if self._val is None:
            self._val = self._fn()
        return self._val

    def release(self) -> None:
        self._val = None

    def __bool__(self):
        return bool(self._load())

    def __len__(self):
        return len(self._load())

    def __getitem__(self, i):
        return self._load()[i]

    def __iter__(self):
        return iter(self._load())


@dataclasses.dataclass
class TaskConfig:
    task: str
    dataset_path: str
    dataset_backend: str = "json"
    # HF hub config name (the second load_dataset positional — e.g.
    # gqa.yaml:2 dataset_name: testdev_balanced_instructions)
    dataset_name: Optional[str] = None
    image_root: str = ""
    split: str = "test"
    output_type: str = "generate_until"         # | loglikelihood
    doc_to_text: Optional[str] = None
    doc_to_visual: Optional[str] = None
    doc_to_target: Optional[str] = None
    process_results: Optional[str] = None
    generation_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"max_new_tokens": 16})
    metric: str = "exact_match"
    aggregation: str = "mean"
    limit: Optional[int] = None
    # free-form task metadata (e.g. gpt_eval_model_name for judged tasks,
    # mirroring the lmms-eval yaml `metadata:` block)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Task:
    def __init__(self, cfg: TaskConfig):
        self.cfg = cfg
        self.name = cfg.task
        self._doc_to_text = _resolve(cfg.doc_to_text)
        self._doc_to_visual = _resolve(cfg.doc_to_visual)
        self._doc_to_target = _resolve(cfg.doc_to_target)
        self._process_results = _resolve(cfg.process_results)
        self.docs = self._load_docs()

    def _load_docs(self) -> List[Dict]:
        cfg = self.cfg
        if cfg.dataset_backend == "json":
            with open(cfg.dataset_path) as f:
                docs = json.load(f)
        elif cfg.dataset_backend == "jsonl":
            with open(cfg.dataset_path) as f:
                docs = [json.loads(line) for line in f if line.strip()]
        elif cfg.dataset_backend == "hf":
            # lmms-eval compatibility (`tasks/mme/mme.yaml:1` loads from the
            # hub); also accepts save_to_disk dirs and local json files so
            # pre-downloaded caches work offline
            import datasets
            if os.path.isdir(cfg.dataset_path):
                ds = datasets.load_from_disk(cfg.dataset_path)
                if isinstance(ds, datasets.DatasetDict):
                    ds = ds[cfg.split]
            elif cfg.dataset_path.endswith((".json", ".jsonl")):
                ds = datasets.load_dataset(
                    "json", data_files=cfg.dataset_path, split="train")
            else:
                ds = datasets.load_dataset(cfg.dataset_path,
                                           cfg.dataset_name,
                                           split=cfg.split)
            docs = list(ds)
        else:
            raise ValueError(cfg.dataset_backend)
        if cfg.limit:
            docs = docs[:cfg.limit]
        return docs

    # ---- document hooks --------------------------------------------------

    def doc_to_text(self, doc: Dict) -> str:
        if self._doc_to_text:
            return self._doc_to_text(doc)
        return doc["question"]

    def doc_to_visual(self, doc: Dict) -> List:
        if self._doc_to_visual:
            return self._doc_to_visual(doc, self.cfg.image_root)
        img = doc.get("image")
        if img is None:
            return []
        if isinstance(img, str):
            from PIL import Image
            # decode fully and release the file handle immediately (an
            # open handle per doc exhausts the fd table at MME/SEED scale)
            with Image.open(os.path.join(self.cfg.image_root, img)) as im:
                return [im.convert("RGB")]
        return [img.convert("RGB")]        # HF image-typed column

    def doc_to_target(self, doc: Dict) -> Any:
        if self._doc_to_target:
            return self._doc_to_target(doc)
        return doc["answer"]

    def build_requests(self, doc_ids: List[int]) -> List[Instance]:
        """Requests carry LAZY visuals: images decode at model-consumption
        time (per batch), not here — materializing tens of thousands of
        PIL images up front is the OOM/fd hazard the reference avoids by
        loading per batch (`lmms_eval/models/llava.py:314`)."""
        out = []
        for i in doc_ids:
            doc = self.docs[i]
            out.append(Instance(
                request_type=self.cfg.output_type, doc=doc, doc_id=i,
                task_name=self.name,
                args=(self.doc_to_text(doc), self.cfg.generation_kwargs),
                visual=LazyVisual(lambda d=doc: self.doc_to_visual(d))))
        return out

    def process_results(self, doc: Dict, prediction: str) -> Dict:
        """-> {'score': float, ...extra fields for custom aggregation}"""
        if self._process_results:
            return self._process_results(doc, prediction, self)
        from .metrics import METRICS
        metric = METRICS[self.cfg.metric]
        target = self.doc_to_target(doc)
        if isinstance(target, list):
            score = metric(prediction, target)
        else:
            score = metric(prediction, str(target))
        return {"score": score}


def read_task_file(path: str) -> dict:
    """A task file's fields: `.json` (read without PyYAML) or YAML."""
    with open(path) as f:
        if path.endswith(".json"):
            return json.load(f)
        import yaml
        return yaml.safe_load(f)


def load_task(path_or_cfg, **overrides) -> Task:
    """Load a task from a YAML (or `.json`) file path or a dict."""
    if isinstance(path_or_cfg, str):
        raw = read_task_file(path_or_cfg)
    else:
        raw = dict(path_or_cfg)
    raw.update(overrides)
    fields = {f.name for f in dataclasses.fields(TaskConfig)}
    raw = {k: v for k, v in raw.items() if k in fields}
    return Task(TaskConfig(**raw))
