"""The flat .npz parameter files of the JAX package (a copy of its
`io/param_io.py`).

`save_params` flattens a parameter tree with '/'-joined keys (list indices as
`#i`) into one .npz; `load_params` rebuilds the nested dict/list tree of
numpy arrays, which `io.from_jax` turns into the port's state dicts (and its
`*_tree` functions turn back).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}" if prefix else str(k), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/#{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def save_params(path: str, tree: Any) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    np.savez(path, **flat)


def load_params(path: str) -> Any:
    with np.load(path) as data:
        root: Dict = {}
        for key in data.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    if node and all(k.startswith("#") for k in node):
        idx = sorted(node, key=lambda k: int(k[1:]))
        return [_listify(node[k]) for k in idx]
    return {k: _listify(v) for k, v in node.items()}
