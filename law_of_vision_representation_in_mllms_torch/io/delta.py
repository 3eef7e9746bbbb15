"""Delta weights and consolidation over the flat `.npz` parameter files
(counterpart of the JAX package's `io/delta.py`).

The reference distributes LLaVA weights as deltas against the base LLaMA and
rebuilds them with `llava/model/apply_delta.py:12-37` / `make_delta.py`
(state-dict arithmetic); `consolidate.py` re-saves a training checkpoint as
one artifact. Here the operations work on flat `io.param_io` `.npz` files,
with the JAX package's rules:

- keys present only in the delta (the reference's mm_projector case) pass
  through unchanged;
- a shape-mismatched key must EXTEND the base's array (the reference's
  extended-vocab embed_tokens / lm_head case): the base adds into its
  leading slice;
- a key of the base missing from the delta (or the target) raises;
- `make_delta` is the exact inverse of `apply_delta`.

`consolidate` writes the parameters of a training checkpoint as one flat
`.npz` in the JAX `param_io` key layout: one that the port's runner saved
(`io.checkpoint.save_train_state`: `checkpoint-{step}/params.npz`), or an
orbax train state that the JAX runner saved, read by `io.orbax_state`
(OCDBT and zstd read by the port's own code; no orbax or tensorstore).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .orbax_state import is_orbax_checkpoint, restore_raw
from .param_io import load_params, save_params


def _load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _combine(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
             sign: int) -> Dict[str, np.ndarray]:
    """out[k] = a[k] + sign * b[k]; b-only keys raise, a-only keys pass
    through; a[k] may extend b[k] (vocab growth): b applies to the leading
    slice."""
    out = {}
    for k, av in a.items():
        if k not in b:
            out[k] = av                      # projector-style new weights
            continue
        bv = b[k]
        if av.shape == bv.shape:
            out[k] = av + sign * bv
        else:
            if av.ndim != bv.ndim or any(
                    x < y for x, y in zip(av.shape, bv.shape)):
                raise ValueError(
                    f"{k}: shape {av.shape} does not extend {bv.shape}")
            av = av.copy()
            sl = tuple(slice(0, s) for s in bv.shape)
            av[sl] = av[sl] + sign * bv
            out[k] = av
    extra = set(b) - set(a)
    if extra:
        raise ValueError(f"keys missing from the target/delta side: "
                         f"{sorted(extra)[:5]}...")
    return out


def apply_delta(base_path: str, delta_path: str, target_path: str) -> int:
    """target = delta + base (`apply_delta.py:12-37`). Returns the number of
    arrays written."""
    out = _combine(_load_flat(delta_path), _load_flat(base_path), +1)
    np.savez(target_path, **out)
    return len(out)


def make_delta(base_path: str, target_path: str, delta_path: str) -> int:
    """delta = target - base (the inverse of `apply_delta`)."""
    out = _combine(_load_flat(target_path), _load_flat(base_path), -1)
    np.savez(delta_path, **out)
    return len(out)


def consolidate(ckpt_path: str, out_path: str) -> int:
    """A training checkpoint -> one flat params `.npz` (`consolidate.py`).

    `ckpt_path` is a `params.npz`, a `checkpoint-{step}` directory (the
    port's runner's, or the JAX runner's orbax one, whose `params` are
    written, as the JAX `consolidate` writes them), or a run directory (its
    newest `checkpoint-{step}` is taken). Returns the number of arrays
    written."""
    from .checkpoint import latest_checkpoint
    if os.path.isdir(ckpt_path) and not is_orbax_checkpoint(ckpt_path):
        ckpt_path = latest_checkpoint(ckpt_path) or ckpt_path
    if is_orbax_checkpoint(ckpt_path):
        # the params alone (a state without them is written whole, as the
        # JAX `consolidate` writes it)
        state = restore_raw(ckpt_path, "params") or restore_raw(ckpt_path)
        save_params(out_path, state.get("params", state))
    else:
        if os.path.isdir(ckpt_path):
            ckpt_path = os.path.join(ckpt_path, "params.npz")
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"no params.npz at {ckpt_path}")
        save_params(out_path, load_params(ckpt_path))
    with np.load(out_path) as z:
        return len(z.files)
