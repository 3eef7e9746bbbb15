"""A score: cross-modal alignment of a vision representation (counterpart of
the JAX package's `metrics/a_score.py`).

Reference semantics (`A_score/compute.py:1-86`): for each of 100 images, take
the post-projector embeddings (LLM space, [seq, 4096]) of the target
representation and of the two anchors (CLIP@336 and CLIP@224 stage-1 models);
L2-normalize rows (norm + 1e-10 in the denominator), compute the target x
anchor cosine-similarity matrix, take the max over anchor tokens, mean over
target tokens; average over images, then over the two anchors.

Every function here goes through `ops.a_score.max_cos`: kernel 9 for CUDA
tensors (one launch scores all images against one anchor and never writes
the similarity matrix), its plain version for CPU tensors. The masked form
supports ragged sequence lengths, so the runner's padded batches take the
kernel too. Tensors in, tensors out; the host helpers take a `device`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.a_score import EPS, max_cos  # noqa: F401  (EPS re-exported)


def max_cos_similarity(target, anchor, *, target_mask=None, anchor_mask=None):
    """mean_t max_a cos(target_t, anchor_a).

    Args:
      target: [..., St, D]
      anchor: [..., Sa, D]
      target_mask / anchor_mask: optional boolean [..., S] validity masks for
        padded batches.

    Returns: [...] scalar per batch element (fp32).
    """
    lead = target.shape[:-2]
    if anchor.shape[:-2] != lead:
        raise ValueError(f"max_cos_similarity: batch dims differ, "
                         f"{tuple(target.shape)} vs {tuple(anchor.shape)}")

    def flat(x, tail):
        return None if x is None else x.reshape(-1, *x.shape[-tail:])
    out = max_cos(flat(target, 2).contiguous(), flat(anchor, 2).contiguous(),
                  flat(target_mask, 1), flat(anchor_mask, 1))
    return out.reshape(lead)


def a_score_pairwise(target, anchor):
    """Batched per-image max-cos: target [N, St, D], anchor [N, Sa, D] ->
    [N] (kernel 9 on the card)."""
    return max_cos_similarity(target, anchor)


def a_score(target, anchor336, anchor224, *, target_mask=None,
            anchor336_mask=None, anchor224_mask=None) -> torch.Tensor:
    """The full A score: mean over images, then mean over the two anchors
    (`A_score/compute.py:75-81`).

    All inputs [N, S, D] (N=100 in the reference protocol). Returns a scalar
    tensor on the inputs' device.
    """
    s336 = max_cos_similarity(target, anchor336, target_mask=target_mask,
                              anchor_mask=anchor336_mask)
    s224 = max_cos_similarity(target, anchor224, target_mask=target_mask,
                              anchor_mask=anchor224_mask)
    return (s336.mean() + s224.mean()) / 2


def pad_stack(arrays, device):
    """A list of per-image [S_i, D] numpy arrays with ragged S_i -> (fp32
    [N, S_max, D], bool [N, S_max] validity) on `device`. The mask is None
    when every length is the same."""
    smax = max(x.shape[0] for x in arrays)
    d = arrays[0].shape[1]
    out = np.zeros((len(arrays), smax, d), np.float32)
    ragged = any(x.shape[0] != smax for x in arrays)
    mask = np.zeros((len(arrays), smax), bool) if ragged else None
    for i, x in enumerate(arrays):
        out[i, :x.shape[0]] = x
        if ragged:
            mask[i, :x.shape[0]] = True
    return (torch.from_numpy(out).to(device),
            None if mask is None else torch.from_numpy(mask).to(device))


def a_score_from_arrays(target_list, anchor336_list, anchor224_list, *,
                        device) -> float:
    """Host convenience: lists of per-image [S_i, D] arrays with ragged S_i.

    Pads to the max length with masks; numerically identical to the
    reference's per-image loop.
    """
    t, tm = pad_stack(target_list, device)
    a336, am336 = pad_stack(anchor336_list, device)
    a224, am224 = pad_stack(anchor224_list, device)
    return float(a_score(t, a336, a224, target_mask=tm,
                         anchor336_mask=am336, anchor224_mask=am224))


def language_align_score(target, anchor224):
    """The `llava/eval/language_align.py:1-69` variant: max-cos alignment
    against the CLIP224 anchor only (used for clipdino reps). Returns the
    mean over images."""
    return max_cos_similarity(target, anchor224).mean()
