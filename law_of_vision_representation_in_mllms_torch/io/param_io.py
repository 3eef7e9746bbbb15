"""Reader for the flat .npz parameter files of the JAX package.

`law_of_vision_representation_in_mllms_tpu/io/param_io.save_params` flattens
a parameter tree with '/'-joined keys (list indices as `#i`) into one .npz;
`load_params` rebuilds the nested dict/list tree of numpy arrays, which
`io.from_jax` turns into the port's state dicts.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


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
