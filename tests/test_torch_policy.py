"""The port's AC policy (numpy, on the host) against the JAX package's, on an
AC table made from a seed. The port keeps its own copy of the `policy`
package because it may import nothing of the JAX package; these tests hold
the copy to the original, function by function and through both CSV
writers and readers. Tolerance: 1e-12 (the same numpy calls on the same
float64 data)."""

import os

import numpy as np
import pytest

from law_of_vision_representation_in_mllms_tpu import policy as JP
from law_of_vision_representation_in_mllms_tpu.policy import data as jdata
from law_of_vision_representation_in_mllms_torch import cli, policy as TP
from law_of_vision_representation_in_mllms_torch.policy import data as tdata

# the paper's 13 x 8 table is not in the repository; a checkout that has it
# names it here
REF_CSV = os.environ.get("LVR_REFERENCE_AC_CSV", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "policy",
    "ablations_t.csv"))


def _tables(seed=0, noise=0.05):
    """The same seeded AC table as both packages' `ACTable`: performance is a
    degree-2 function of (A, C) plus noise."""
    rng = np.random.default_rng(seed)
    n = len(JP.ALL_MODELS)
    a = {b: rng.random(n) for b in JP.BENCHMARKS}
    c = rng.random(n)
    perf = {b: 2 * a[b] ** 2 + a[b] * c + 0.5 * c + 0.1
            + noise * rng.standard_normal(n) for b in JP.BENCHMARKS}
    kw = dict(models=list(JP.ALL_MODELS), perf=perf, a=a, c=c)
    return JP.ACTable(**kw), TP.ACTable(**kw)


def test_constants_match():
    assert TP.BENCHMARKS == JP.BENCHMARKS
    assert TP.ALL_MODELS == JP.ALL_MODELS
    assert TP.OPTIMAL == JP.OPTIMAL


@pytest.mark.parametrize("degree", [1, 2])
def test_poly_features(degree):
    x = np.random.default_rng(1).random((9, 2))
    np.testing.assert_allclose(TP.poly_features(x, degree),
                               JP.poly_features(x, degree), atol=1e-12)


@pytest.mark.parametrize("data,model", [
    ("AC", "polynomial"), ("AC", "linear"), ("A", "polynomial"),
    ("C", "linear"), ("random", "polynomial"), ("Ar", "polynomial")])
def test_fit_policy(data, model):
    jt, tt = _tables()
    for b in JP.BENCHMARKS[:3]:
        want = JP.fit_policy(jt, b, data=data, model=model)
        got = TP.fit_policy(tt, b, data=data, model=model)
        np.testing.assert_allclose(got.coef, want.coef, atol=1e-12)
        assert got.degree == want.degree
        assert abs(got.r2 - want.r2) < 1e-12
        assert abs(got.mse - want.mse) < 1e-12
    train = JP.ALL_MODELS[:8]
    want = JP.fit_policy(jt, "mme", train_models=train)
    got = TP.fit_policy(tt, "mme", train_models=train)
    np.testing.assert_allclose(got.coef, want.coef, atol=1e-12)
    x = np.random.default_rng(2).random((5, 2))
    np.testing.assert_allclose(got.predict(x), want.predict(x), atol=1e-12)


def test_exact_law_is_recovered():
    _, tt = _tables(noise=0.0)
    assert TP.fit_policy(tt, "mme").r2 > 0.999


@pytest.mark.parametrize("top", [1, 3])
def test_validate_run(top):
    jt, tt = _tables(seed=3)
    for b in JP.BENCHMARKS:
        want = JP.validate_run(jt, b, JP.ALL_MODELS[:9], top=top)
        got = TP.validate_run(tt, b, TP.ALL_MODELS[:9], top=top)
        assert bool(got[0]) == bool(want[0])
        assert list(got[1]) == list(want[1])


@pytest.mark.parametrize("data", ["AC", "A", "random"])
def test_prediction_accuracy(data):
    jt, tt = _tables(seed=4)
    want = JP.prediction_accuracy(jt, k=6, data=data, n_draws=8, seed=0)
    got = TP.prediction_accuracy(tt, k=6, data=data, n_draws=8, seed=0)
    assert got == want


def test_subset_search():
    jt, tt = _tables(seed=5)
    kw = dict(sizes=(11, 12), benchmarks=["mme", "ok_vqa"])
    want = JP.subset_search(jt, **kw)
    got = TP.subset_search(tt, **kw)
    assert got == want


def test_csv_round_trip_both_ways(tmp_path):
    """Each package reads the CSV the other writes."""
    jt, tt = _tables(seed=6)
    by_jax, by_port = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jdata.write_ac_csv(by_jax, jt)
    tdata.write_ac_csv(by_port, tt)
    assert open(by_jax).read() == open(by_port).read()
    for back in (TP.load_ac_csv(by_jax), JP.load_ac_csv(by_port)):
        assert back.models == jt.models
        np.testing.assert_allclose(back.c, jt.c)
        for b in JP.BENCHMARKS:
            np.testing.assert_allclose(back.perf[b], jt.perf[b])
            np.testing.assert_allclose(back.a[b], jt.a[b])


def test_policy_cli(tmp_path, capsys):
    _, tt = _tables(seed=7)
    path = str(tmp_path / "ac.csv")
    tdata.write_ac_csv(path, tt)
    assert cli.main(["policy", "fit", "--csv", path, "--benchmark", "mme",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    fit = TP.fit_policy(TP.load_ac_csv(path), "mme")
    assert out.strip() == f"mme: r2={fit.r2:.4f} mse={fit.mse:.5f}"
    assert cli.main(["policy", "validate", "--csv", path, "--benchmark",
                     "mme", "--top", "2", "--device", "cpu"]) == 0
    assert '"hit"' in capsys.readouterr().out


@pytest.mark.skipif(not os.path.exists(REF_CSV),
                    reason="the paper's AC table is not in the repository")
def test_reference_table():
    jt, tt = JP.load_ac_csv(REF_CSV), TP.load_ac_csv(REF_CSV)
    for b in JP.BENCHMARKS:
        want, got = JP.fit_policy(jt, b), TP.fit_policy(tt, b)
        np.testing.assert_allclose(got.coef, want.coef, atol=1e-12)
