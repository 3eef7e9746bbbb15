"""Orbax train states, read without orbax: the JAX runner's
`checkpoint-{step}` (`StandardCheckpointer`, OCDBT with zarr v2 arrays) as
numpy trees.

A checkpoint directory holds `_METADATA` (JSON: the tree, one entry a leaf,
its keys with their kinds, 2 a dict key and 1 a list index, and its value
type), `_CHECKPOINT_METADATA`, `_sharding`, `array_metadatas/process_N` and
the OCDBT database (`io/ocdbt.py`). A leaf named by its '.'-joined keys
(`params.decoder.embed`) is the zarr array under that key: `<name>/.zarray`
(JSON: shape, chunk shape, dtype, fill value, compressor) and one value a
chunk, `<name>/<i>.<j>...` (`<name>/0` for a 0-d array), a zstd frame of
the chunk's C-order bytes, padded to whole chunks at the array's edges. A
sharded save (tensor parallelism, ZeRO) writes one chunk a shard, and this
module assembles them; a chunk a save left out holds the fill value.

dtypes: every numpy one zarr names (`<f4`, `<i4`, `|i1`, ...), and
`bfloat16` as the 2-byte void type `V2`, which is what numpy reads back
from a `.npz` that the JAX package wrote from a bfloat16 array (the port
has no bfloat16 numpy type; `io.from_jax` widens `V2` leaves to fp32).

- `restore_raw(path)`: the whole state, template-free, as the JAX
  `consolidate` reads it (orbax `PyTreeCheckpointer().restore(path)`):
  dicts and lists of arrays, scalars as Python numbers, empty containers
  and None where the tree holds them; `restore_raw(path, "params")` the
  same tree with only the leaves under `params` (the optimizer's moments,
  twice the parameters in fp32, are not decoded);
- `restore_params(path)`: its `params` subtree, the tree that the JAX
  `restore_train_state(path, {"params": ...})["params"]` returns.
"""

from __future__ import annotations

import itertools
import json
import math
import os
from typing import Any, Dict, Optional

import numpy as np

from . import ocdbt, zstd

BF16 = np.dtype("V2")
# files only an orbax checkpoint directory holds
MARKERS = ("_CHECKPOINT_METADATA", "manifest.ocdbt")


def is_orbax_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, m)) for m in MARKERS)


def _dtype(name: str) -> np.dtype:
    return BF16 if name == "bfloat16" else np.dtype(name)


def _array(items: Dict[bytes, ocdbt.Value], name: str) -> np.ndarray:
    """The zarr v2 array stored under `name`."""
    meta_value = items.get(f"{name}/.zarray".encode())
    if meta_value is None:
        raise ValueError(f"orbax checkpoint: no zarr array {name!r} (only "
                         f"zarr v2 arrays, `use_zarr3: false`, are read)")
    meta = json.loads(meta_value.read())
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{name}: only C-order arrays without filters are "
                         f"read, got {meta}")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{name}: compressor {comp} is not zstd")
    dtype = _dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    fill = meta.get("fill_value")
    if fill not in (None, 0, 0.0, False):
        if dtype == BF16:
            raise ValueError(f"{name}: a bfloat16 fill value {fill}")
        out = np.full(shape, fill, dtype)
    else:
        out = np.zeros(shape, dtype)
    sep = meta.get("dimension_separator", ".")
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
        value = items.get(key)
        if value is None:
            continue
        raw = value.read()
        data = (zstd.decompress(raw, chunk_bytes) if comp is not None
                else np.frombuffer(raw, np.uint8))
        if data.size != chunk_bytes:
            raise ValueError(f"{key.decode()}: {data.size} bytes, a chunk "
                             f"holds {chunk_bytes}")
        block = data.view(dtype).reshape(chunks)
        where = tuple(slice(i * c, min((i + 1) * c, s))
                      for i, c, s in zip(idx, chunks, shape))
        out[where] = block[tuple(slice(0, w.stop - w.start) for w in where)]
    return out


def _insert(tree: Dict, keys, value) -> None:
    """Put `value` into the nested dicts of `tree` at `keys`."""
    for key in keys[:-1]:
        tree = tree.setdefault(key, {})
    tree[keys[-1]] = value


def _listify(node):
    """The dicts of list-index keys (kind 1, stored as str) made lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(isinstance(k, _Index) for k in out):
        return [out[k] for k in sorted(out, key=int)]
    return out


class _Index(str):
    """A list index among a node's keys."""


# leaves that hold no array: an empty container (a feature pseudo-tower's
# `{}`) or None
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple, "None": lambda: None}


def restore_raw(path: str, subtree: Optional[str] = None) -> Dict[str, Any]:
    """The train state in the orbax checkpoint directory `path`
    (template-free; see the module text), or, with `subtree`, only the
    leaves whose first key it is."""
    with open(os.path.join(path, "_METADATA")) as f:
        tree_meta = json.load(f)["tree_metadata"]
    items = ocdbt.Database(path).items()
    tree: Dict = {}
    for entry in tree_meta.values():
        keys = [_Index(k["key"]) if k["key_type"] == 1 else k["key"]
                for k in entry["key_metadata"]]
        if subtree is not None and keys[0] != subtree:
            continue
        kind = entry["value_metadata"]["value_type"]
        name = ".".join(map(str, keys))
        if kind in _EMPTY:
            value = _EMPTY[kind]()
        else:
            value = _array(items, name)
            if kind == "scalar":
                value = value.item()
        _insert(tree, keys, value)
    return _listify(tree)


def restore_params(path: str) -> Dict[str, Any]:
    """The `params` subtree of the train state at `path`."""
    return restore_raw(path, "params")["params"]
