"""The port's A score against the JAX package, on the CPU in fp32.

The same seeded numpy inputs go through the JAX `max_cos_similarity`, the
Pallas kernel `max_cos_pallas` in interpret mode (as `tests/test_a_score.py`
runs it), a per-image numpy oracle of `A_score/compute.py`, and the port's
`ops.a_score` / `metrics.a_score` / `pipeline.a_score_run`. For CPU tensors
the port's wrapper takes `a_score_plain`, the plain version that
`chip_smoke.py` holds kernel 9 against on the card. Tolerance: 1e-5 absolute
(fp32 sums over D in different orders; cosines lie in [-1, 1]).
"""

import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from law_of_vision_representation_in_mllms_tpu.ops.a_score_pallas import (
    max_cos_pallas)
from law_of_vision_representation_in_mllms_tpu.pipeline.a_score_run import (
    compute_a_scores as j_compute_a_scores)
from law_of_vision_representation_in_mllms_torch.metrics import a_score as TA
from law_of_vision_representation_in_mllms_torch.ops.a_score import (
    a_score_body, a_score_plain, max_cos)
from law_of_vision_representation_in_mllms_torch.pipeline.a_score_run import (
    compute_a_scores)
# the tests directory is on sys.path under pytest
from test_torch_cuda_kernels import _structured

# the module, not the function of the same name that the package re-exports
JA = importlib.import_module(
    "law_of_vision_representation_in_mllms_tpu.metrics.a_score")
torch.set_num_threads(1)
TOL = 1e-5


def _oracle(target, anchor, tmask=None, amask=None):
    """`A_score/compute.py` per image: normalise rows by (norm + 1e-10),
    cosine matrix, max over anchor tokens, mean over target tokens."""
    out = []
    for i in range(len(target)):
        t = target[i].astype(np.float64)
        a = anchor[i].astype(np.float64)
        if tmask is not None:
            t = t[tmask[i]]
        if amask is not None:
            a = a[amask[i]]
        if len(t) == 0:
            out.append(0.0)
            continue
        t = t / (np.linalg.norm(t, axis=-1, keepdims=True) + 1e-10)
        a = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-10)
        out.append((t @ a.T).max(axis=1).mean())
    return np.asarray(out)


def _inputs(n, st, sa, d, seed=0, masks=False):
    rng = np.random.RandomState(seed)
    t = rng.randn(n, st, d).astype(np.float32)
    a = rng.randn(n, sa, d).astype(np.float32)
    tm = am = None
    if masks:
        tm = rng.rand(n, st) < 0.7
        am = rng.rand(n, sa) < 0.6
        tm[:, 0] = True
        am[:, 0] = True                    # never a row with no valid anchor
    return t, a, tm, am


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("n,st,sa,d,masks", [
    (4, 16, 16, 64, False), (3, 20, 9, 48, False), (4, 16, 12, 64, True),
    (2, 70, 65, 37, True)])
def test_max_cos_matches_jax(n, st, sa, d, masks):
    t, a, tm, am = _inputs(n, st, sa, d, masks=masks)
    want = np.asarray(JA.max_cos_similarity(
        jnp.asarray(t), jnp.asarray(a),
        target_mask=None if tm is None else jnp.asarray(tm),
        anchor_mask=None if am is None else jnp.asarray(am)))
    got = max_cos(_t(t), _t(a), _t(tm), _t(am))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), _oracle(t, a, tm, am), atol=TOL,
                               rtol=0)
    # the metrics module is the same function under the JAX name
    got2 = TA.max_cos_similarity(_t(t), _t(a), target_mask=_t(tm),
                                 anchor_mask=_t(am))
    assert torch.equal(got, got2)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("value", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("where", ["target", "anchor"])
def test_max_cos_non_finite_matches_jax(where, value, masked):
    """A NaN or Inf in a valid row makes the image's score NaN, as the JAX
    `jnp.max` does; in a masked-out row it changes nothing. The same holds
    for kernel 9 on the card (tests/test_torch_cuda_kernels.py)."""
    t, a, tm, am = _inputs(3, 12, 10, 16, seed=4, masks=True)
    x, mask, row = (t, tm, 5) if where == "target" else (a, am, 7)
    mask[1, row] = not masked
    finite_score = max_cos(_t(t), _t(a), _t(tm), _t(am)).numpy()
    x[1, row, 3] = value
    want = np.asarray(JA.max_cos_similarity(
        jnp.asarray(t), jnp.asarray(a), target_mask=jnp.asarray(tm),
        anchor_mask=jnp.asarray(am)))
    got = max_cos(_t(t), _t(a), _t(tm), _t(am)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]) != masked and not np.isnan(got[[0, 2]]).any()
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], atol=TOL, rtol=0)
    if masked:                   # the masked row's values reach nothing
        assert np.array_equal(got, finite_score)


@pytest.mark.parametrize("d", [64, 96, 100])
def test_plain_matches_pallas_interpret(d):
    """`a_score_plain` against the TPU kernel it replaces, run as the JAX
    tests run it on the CPU; d=96 and d=100 are sizes `block_d=32` does and
    does not divide."""
    t, a, _, _ = _inputs(3, 16, 24, d, seed=1)
    want = np.asarray(max_cos_pallas(jnp.asarray(t), jnp.asarray(a),
                                     block_d=32, interpret=True))
    got = a_score_plain(_t(t), _t(a)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    pair = TA.a_score_pairwise(_t(t), _t(a)).numpy()
    np.testing.assert_allclose(pair, np.asarray(
        JA.a_score_pairwise(jnp.asarray(t), jnp.asarray(a))), atol=TOL,
        rtol=0)


def test_leading_batch_dims_and_fully_masked_target():
    t, a, tm, am = _inputs(6, 10, 8, 32, seed=2, masks=True)
    tm[2] = False                           # an image with no valid row
    want = np.asarray(JA.max_cos_similarity(
        jnp.asarray(t).reshape(2, 3, 10, 32),
        jnp.asarray(a).reshape(2, 3, 8, 32),
        target_mask=jnp.asarray(tm).reshape(2, 3, 10),
        anchor_mask=jnp.asarray(am).reshape(2, 3, 8)))
    got = TA.max_cos_similarity(
        _t(t).reshape(2, 3, 10, 32), _t(a).reshape(2, 3, 8, 32),
        target_mask=_t(tm).reshape(2, 3, 10),
        anchor_mask=_t(am).reshape(2, 3, 8))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert got[0, 2].item() == 0.0


def test_self_anchor_is_one():
    t, _, _, _ = _inputs(3, 12, 12, 40, seed=3)
    got = max_cos(_t(t), _t(t.copy()))
    np.testing.assert_allclose(got.numpy(), 1.0, atol=TOL, rtol=0)


def test_a_score_and_language_align_match_jax():
    t, a336, _, _ = _inputs(5, 16, 16, 64, seed=4)
    _, a224, _, _ = _inputs(5, 16, 9, 64, seed=5)
    want = float(JA.a_score(jnp.asarray(t), jnp.asarray(a336),
                            jnp.asarray(a224)))
    got = TA.a_score(_t(t), _t(a336), _t(a224))
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    assert abs(float(got) - want) < TOL
    want = float(JA.language_align_score(jnp.asarray(t), jnp.asarray(a224)))
    assert abs(float(TA.language_align_score(_t(t), _t(a224))) - want) < TOL


def test_a_score_from_arrays_ragged():
    rng = np.random.RandomState(6)

    def ragged(lengths, d=32):
        return [rng.randn(s, d).astype(np.float32) for s in lengths]
    t = ragged([5, 9, 7])
    a336 = ragged([9, 9, 4])
    a224 = ragged([3, 3, 3])
    want = JA.a_score_from_arrays(t, a336, a224)
    got = TA.a_score_from_arrays(t, a336, a224, device="cpu")
    assert abs(got - want) < TOL
    oracle = (_oracle(t, a336).mean() + _oracle(t, a224).mean()) / 2
    assert abs(got - oracle) < TOL
    # equal lengths need no mask
    _, mask = TA.pad_stack(a224, "cpu")
    assert mask is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_inputs_use_fp32_math(dtype):
    t, a, tm, am = _inputs(3, 12, 10, 64, seed=7, masks=True)
    tl, al = _t(t).to(dtype), _t(a).to(dtype)
    got = max_cos(tl, al, _t(tm), _t(am))
    assert got.dtype == torch.float32
    # the rounded inputs, scored in fp32 by the JAX function
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16
    want = np.asarray(JA.max_cos_similarity(
        jnp.asarray(tl.float().numpy()).astype(jdt),
        jnp.asarray(al.float().numpy()).astype(jdt),
        target_mask=jnp.asarray(tm), anchor_mask=jnp.asarray(am)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_wrapper_checks_inputs():
    t, a, tm, am = _inputs(2, 6, 5, 16, seed=8, masks=True)
    with pytest.raises(ValueError):
        max_cos(_t(t), _t(a)[:1])
    with pytest.raises(ValueError):
        max_cos(_t(t), _t(a)[:, :, :8])
    with pytest.raises(ValueError):
        max_cos(_t(t), _t(a), _t(tm).float())
    with pytest.raises(ValueError):
        max_cos(_t(t), _t(a), _t(tm)[:, :3])
    with pytest.raises(RuntimeError, match="forward-only"):
        max_cos(_t(t).requires_grad_(), _t(a))
    before = max_cos.launches
    max_cos(_t(t), _t(a))
    assert max_cos.launches == before      # the CPU path launches no kernel


def _tf32_rna(x):
    """x rounded to TF32 (10 mantissa bits, ties away from zero) on its bit
    pattern, as `csrc/hopper_common.cuh` `tf32_rna` does."""
    bits = x.view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _max_cos_3xtf32(t, a, passes=3):
    """Kernel 9's wgmma body in numpy: each operand split as hi = rna(x),
    lo = rna(x - hi); the products hi lo + lo hi + hi hi (hi hi alone for
    `passes=1`) of TF32 values, which are exact, summed in fp64; norms of
    the fp32 rows."""
    t_hi, a_hi = _tf32_rna(t), _tf32_rna(a)
    t_lo, a_lo = _tf32_rna(t - t_hi), _tf32_rna(a - a_hi)

    def mm(x, y):
        return np.einsum("ntd,nad->nta", x.astype(np.float64),
                         y.astype(np.float64))
    dot = mm(t_hi, a_hi)
    if passes == 3:
        dot += mm(t_hi, a_lo) + mm(t_lo, a_hi)
    tn = np.linalg.norm(t.astype(np.float64), axis=-1) + 1e-10
    an = np.linalg.norm(a.astype(np.float64), axis=-1) + 1e-10
    return (dot / tn[:, :, None] / an[:, None, :]).max(-1).mean(-1)


@pytest.mark.parametrize("self_anchor", [False, True])
def test_3xtf32_split_matches_fp32(self_anchor):
    """The split of kernel 9's wgmma body keeps the score within 1e-6 of the
    fp32 plain version and of the JAX function on near-duplicate anchors,
    where one TF32 product alone misses that tolerance (1e-6: the three
    products drop only lo lo and lo's rounding, ~2^-22 relative)."""
    t, a = (x.numpy() for x in _structured(2, 192, 192, 512, 10, "cpu"))
    if self_anchor:
        a = t.copy()
    plain = a_score_plain(_t(t), _t(a)).numpy()
    jax_ = np.asarray(JA.max_cos_similarity(jnp.asarray(t), jnp.asarray(a)))
    got = _max_cos_3xtf32(t, a)
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, jax_, atol=1e-6, rtol=0)
    if self_anchor:
        np.testing.assert_allclose(got, 1.0, atol=1e-6, rtol=0)
    assert np.abs(_max_cos_3xtf32(t, a, passes=1) - plain).max() > 1e-6


@pytest.mark.parametrize("dtype,d,t_off,a_off,body", [
    (torch.float32, 4096, 0, 0, "wgmma"),
    (torch.float32, 1000, 16, 4096, "wgmma"),
    (torch.float32, 4100, 0, 0, "wgmma"),
    (torch.float32, 37, 0, 0, "simt"),          # D % 4 != 0
    (torch.float32, 4096, 4, 0, "simt"),        # a base TMA cannot take
    (torch.float32, 4096, 0, 8, "simt"),
    (torch.bfloat16, 4096, 0, 0, "simt"),
    (torch.float16, 4096, 0, 0, "simt")])
def test_body_dispatch(dtype, d, t_off, a_off, body):
    """Which body kernel 9 launches depends on dtype, D and the bases'
    16-byte alignment alone."""
    assert a_score_body(dtype, d, 1 << 20 | t_off, 1 << 21 | a_off) == body


def _dump(base, rep, arrays):
    os.makedirs(os.path.join(base, rep), exist_ok=True)
    for i, x in enumerate(arrays):
        np.save(os.path.join(base, rep, f"tensor_{i + 1}.npy"), x)


def test_compute_a_scores_matches_jax_runner(tmp_path):
    rng = np.random.RandomState(9)
    base = str(tmp_path)
    n, d = 4, 32
    _dump(base, "clip336", [rng.randn(9, d).astype(np.float32)
                            for _ in range(n)])
    _dump(base, "clip224", [rng.randn(4, d).astype(np.float32)
                            for _ in range(n)])
    _dump(base, "dino", [rng.randn(9, d).astype(np.float32)
                         for _ in range(n)])
    _dump(base, "ragged", [rng.randn(5 + i, d).astype(np.float32)
                           for i in range(n)])
    _dump(base, "short", [rng.randn(9, d).astype(np.float32)
                          for _ in range(n - 1)])        # a file is missing
    reps = ["dino", "ragged", "clip336", "short", "absent"]
    want = j_compute_a_scores(base, reps, n_images=n)
    got = compute_a_scores(base, reps, n_images=n, device="cpu")
    assert sorted(got) == sorted(want) == ["clip336", "dino", "ragged"]
    for rep in want:
        assert abs(got[rep] - want[rep]) < TOL, rep
    # an anchor scored against itself contributes exactly 1.0
    target = [np.load(os.path.join(base, "clip336", f"tensor_{i + 1}.npy"))
              for i in range(n)]
    a224 = [np.load(os.path.join(base, "clip224", f"tensor_{i + 1}.npy"))
            for i in range(n)]
    assert abs(got["clip336"] - (1.0 + _oracle(target, a224).mean()) / 2) \
        < TOL


def test_compute_a_scores_missing_anchor_raises(tmp_path):
    _dump(str(tmp_path), "clip336", [np.ones((2, 4), np.float32)])
    with pytest.raises(FileNotFoundError, match="anchor"):
        compute_a_scores(str(tmp_path), ["clip336"], n_images=1,
                         device="cpu")
