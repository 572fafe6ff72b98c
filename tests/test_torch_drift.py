"""The port's drift gate held against the JAX package's.

* ``ks_statistic`` is bitwise the reference's on the same arrays (ties,
  unequal sizes, one-point samples).
* ``score_drift`` on one fit's artifact, read by each package (the JAX
  package's ``.npz`` loads in the port), gives the same statistic within
  1e-6 and the same verdict, for an in-distribution append and a shifted
  one, under two kernels. The kernel block runs on the CPU here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jc
from repro.core import engine as jengine
from repro.serve import drift as jdrift
from repro_torch.core.engine.state import SolverArtifact
from repro_torch.data import make_toy
from repro_torch.serve import drift as tdrift

M, N_APP = 96, 12
J_KERNELS = {"rbf": jc.rbf(0.5), "linear": jc.linear()}


def _ks_cases():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(300)
    return {
        "gaussians": (a, rng.standard_normal(200) + 0.3),
        "ties": (np.round(a, 1), np.round(rng.standard_normal(77), 1)),
        "equal": (a, a.copy()),
        "one_point": (a[:1], a[1:40]),
        "f32_in": (a.astype(np.float32), (a[:50] * 2).astype(np.float32)),
    }


@pytest.mark.parametrize("case", sorted(_ks_cases()))
def test_ks_statistic_is_bitwise_the_reference(case):
    a, b = _ks_cases()[case]
    j, t = jdrift.ks_statistic(a, b), tdrift.ks_statistic(a, b)
    assert isinstance(t, float)
    assert np.float64(t).tobytes() == np.float64(j).tobytes()
    assert 0.0 <= t <= 1.0


def test_ks_statistic_refuses_empty_samples():
    with pytest.raises(ValueError):
        tdrift.ks_statistic([], [1.0])
    assert tdrift.DEFAULT_THRESHOLD == jdrift.DEFAULT_THRESHOLD == 0.35


@pytest.fixture(scope="module", params=sorted(J_KERNELS))
def artifacts(request, tmp_path_factory):
    """One JAX fit's artifact in each package (the port's loaded from the
    JAX package's checkpoint)."""
    X = make_toy(5, M)[0]
    spec = jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5,
                       kernel=J_KERNELS[request.param])
    res = repro.fit(jnp.asarray(X), spec, strategy="blocked", tol=1e-3)
    j_art = jengine.artifact_from_result(res)
    path = str(tmp_path_factory.mktemp("drift") / "art.npz")
    j_art.save(path)
    return X, j_art, SolverArtifact.load(path)


@pytest.mark.parametrize("shift", [0.0, 5.0], ids=["in_band", "shifted"])
def test_score_drift_matches_the_reference(artifacts, shift):
    X, j_art, t_art = artifacts
    assert np.array_equal(t_art.support_mask(), j_art.support_mask())
    assert np.array_equal(t_art.support_mask(1e-3),
                          j_art.support_mask(1e-3))
    rng = np.random.default_rng(1)
    app = (X[:N_APP] + rng.normal(0, 1e-3, (N_APP, X.shape[1]))
           + shift).astype(np.float32)
    j = jdrift.score_drift(j_art, app)
    t = tdrift.score_drift(t_art, app, device="cpu")
    assert abs(t.statistic - j.statistic) <= 1e-6
    assert t.drifted == j.drifted == (shift > 0)
    assert (t.n_ref, t.n_new, t.threshold) == (j.n_ref, j.n_new,
                                                j.threshold)
    # a tensor candidate reads the same rows
    t2 = tdrift.score_drift(t_art, torch.as_tensor(app), device="cpu")
    assert t2 == t


def test_score_drift_samples_and_degenerate_fits(artifacts):
    X, j_art, t_art = artifacts
    big = np.concatenate([X] * 8)               # 768 rows > max_sample
    j = jdrift.score_drift(j_art, big, max_sample=100)
    t = tdrift.score_drift(t_art, big, max_sample=100, device="cpu")
    assert (t.n_ref, t.n_new) == (j.n_ref, j.n_new) == (96, 96)
    assert abs(t.statistic - j.statistic) <= 1e-6
    # every |gamma| below the threshold: all rows serve as the slab
    j = jdrift.score_drift(j_art, X, sv_threshold=1e9)
    t = tdrift.score_drift(t_art, X, sv_threshold=1e9, device="cpu")
    assert abs(t.statistic - j.statistic) <= 1e-6


def test_score_drift_runs_on_the_card_unless_asked(artifacts, monkeypatch):
    _, _, t_art = artifacts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrift.score_drift(t_art, t_art.X[:4])
