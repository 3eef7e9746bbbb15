"""Training datasets, collation and the modality-grouped sampler
(counterpart of the JAX package's `data/datasets.py`; host-side numpy, so the
batches are the JAX ones to the element).

- `SupervisedDataset`: conversation JSON + image folder -> per-sample
  (input_ids, labels, one pixel array per tower entry), the reference's
  `LazySupervisedDataset` (`train.py:653-766`), text-only samples included;
- `FeatureDataset`: a folder of precomputed `.npy` features instead of
  images (`LazyFeatureDataset`, `train.py:767-831`, a zero feature for
  text-only samples);
- `collate_batch`: right-pads ids/labels to a bucketed length and stacks the
  pixels per tower (`DataCollatorForSupervisedDataset`, `train.py:833-875`);
- `length_grouped_indices`: the modality-aware length-grouped sampler
  (`llava_trainer.py:50-147`).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.splice import IGNORE_INDEX
from ..models.towers import TowerSpec
from .conversation import Conversation
from .image_processing import preprocess_image, processor_for_tower
from .preprocess import preprocess_sources


def _bucket_len(n: int, minimum: int = 32) -> int:
    """Smallest power-of-two multiple of `minimum` that holds n: a few padded
    lengths instead of one per batch."""
    b = minimum
    while b < n:
        b *= 2
    return b


class SupervisedDataset:
    def __init__(self, data_path: str, image_folder: str,
                 tower_spec: TowerSpec, template: Conversation, tokenizer,
                 *, pad_square: bool = True,
                 max_length: Optional[int] = None):
        with open(data_path) as f:
            self.records = json.load(f)
        self.image_folder = image_folder
        self.spec = tower_spec
        self.template = template
        self.tokenizer = tokenizer
        self.pad_square = pad_square
        self.max_length = max_length
        self.processors = [processor_for_tower(e.name, e.img_size)
                           for e in tower_spec.entries]

    def __len__(self):
        return len(self.records)

    def lengths(self) -> np.ndarray:
        """Approximate token lengths, negative for text-only samples (the
        modality-grouping key, `train.py:664-677`)."""
        out = []
        for r in self.records:
            n = sum(len(s["value"].split()) for s in r["conversations"])
            n += 128 if "image" in r else 0
            out.append(n if "image" in r else -n)
        return np.asarray(out)

    def __getitem__(self, i: int) -> Dict:
        rec = self.records[i]
        has_image = "image" in rec
        ids, labels = preprocess_sources(rec["conversations"], self.template,
                                         self.tokenizer,
                                         has_image=has_image,
                                         max_length=self.max_length)
        pixels = []
        if has_image:
            from PIL import Image
            with Image.open(os.path.join(self.image_folder,
                                         rec["image"])) as img:
                for proc in self.processors:
                    pixels.append(preprocess_image(
                        img, proc, pad_square=self.pad_square and
                        proc.mode == "clip"))
        else:
            for proc in self.processors:
                pixels.append(np.zeros((proc.crop, proc.crop, 3),
                                       np.float32))
        return {"input_ids": ids, "labels": labels, "pixel_values": pixels,
                "has_image": has_image}


class FeatureDataset:
    """Feature-cached training: one `<image stem>.npy` per sample instead of
    a tower forward per step.

    With `packed_cache`, a `.lvrpack` file (`io.native_cache.pack`), the
    features come out of that one file through the native loader's gathers
    instead of one file a sample. `pack_index` maps image stems to pack rows
    (by default the order of the records' first mention of each stem)."""

    def __init__(self, data_path: str, feature_folder: str,
                 template: Conversation, tokenizer, *,
                 feature_shape=(576, 1280),
                 max_length: Optional[int] = None,
                 packed_cache: Optional[str] = None,
                 pack_index: Optional[Dict[str, int]] = None):
        with open(data_path) as f:
            self.records = json.load(f)
        self.feature_folder = feature_folder
        self.template = template
        self.tokenizer = tokenizer
        self.feature_shape = tuple(feature_shape)
        self.max_length = max_length
        self._pack = None
        if packed_cache:
            from ..io.native_cache import PackedCache
            self._pack = PackedCache(packed_cache, self.feature_shape)
            if pack_index is None:
                pack_index = {}
                for r in self.records:
                    if "image" in r:
                        stem = os.path.splitext(r["image"])[0]
                        pack_index.setdefault(stem, len(pack_index))
            self._pack_index = pack_index

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i: int) -> Dict:
        rec = self.records[i]
        has_image = "image" in rec
        ids, labels = preprocess_sources(rec["conversations"], self.template,
                                         self.tokenizer,
                                         has_image=has_image,
                                         max_length=self.max_length)
        if has_image:
            stem = os.path.splitext(rec["image"])[0]
            if self._pack is not None:
                feat = self._pack.gather(
                    [self._pack_index[stem]])[0].astype(np.float32)
            else:
                feat = np.load(os.path.join(
                    self.feature_folder, stem + ".npy")).astype(np.float32)
        else:
            feat = np.zeros(self.feature_shape, np.float32)
        return {"input_ids": ids, "labels": labels, "pixel_values": [feat],
                "has_image": has_image}


def collate_batch(samples: Sequence[Dict], *, pad_id: int = 0,
                  bucket: bool = True, max_length: Optional[int] = None
                  ) -> Dict[str, np.ndarray | List[np.ndarray]]:
    """Right-padded [B, n] int32 ids/labels and bool text_mask, with n the
    longest sample bucketed (and capped at `max_length`); pixels stacked per
    tower entry."""
    n = max(len(s["input_ids"]) for s in samples)
    if max_length:
        n = min(n, max_length)
    if bucket:
        n = _bucket_len(n)
        if max_length:
            n = min(n, max_length)
    b = len(samples)
    ids = np.full((b, n), pad_id, np.int32)
    labels = np.full((b, n), IGNORE_INDEX, np.int32)
    mask = np.zeros((b, n), bool)
    for i, s in enumerate(samples):
        k = min(len(s["input_ids"]), n)
        ids[i, :k] = s["input_ids"][:k]
        labels[i, :k] = s["labels"][:k]
        mask[i, :k] = True
    n_towers = len(samples[0]["pixel_values"])
    pixels = [np.stack([s["pixel_values"][t] for s in samples])
              for t in range(n_towers)]
    return {"input_ids": ids, "labels": labels, "text_mask": mask,
            "pixel_values": pixels}


def length_grouped_indices(lengths: np.ndarray, batch_size: int,
                           world_size: int, *, seed: int = 0,
                           group_by_modality: bool = True) -> np.ndarray:
    """Modality-grouped length sampler (`llava_trainer.py:50-147`):
    multimodal and text-only samples form separate megabatches, each sorted
    by length descending, then full megabatches are shuffled and the
    incomplete ones go last."""
    rng = np.random.default_rng(seed)
    mega = batch_size * world_size
    idx = rng.permutation(len(lengths))

    def group(ind):
        chunks = [ind[i:i + mega] for i in range(0, len(ind), mega)]
        return [c[np.argsort(-np.abs(lengths[c]), kind="stable")]
                for c in chunks]

    if group_by_modality and (lengths > 0).any() and (lengths < 0).any():
        mm = idx[lengths[idx] > 0]
        txt = idx[lengths[idx] <= 0]
        batches = group(mm) + group(txt)
    else:
        batches = group(idx)
    full = [b for b in batches if len(b) == mega]
    partial = [b for b in batches if len(b) < mega]
    order = rng.permutation(len(full))
    return np.concatenate([full[i] for i in order] + partial)
