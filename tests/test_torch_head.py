"""The port's slab head (``repro_torch.core.head``) held against the JAX
package's ``repro.core.head`` on the same numpy features.

Features are toy rows (d = 6) with a scale and shift per feature, so the
whitening matters. ``mean``/``scale`` agree within 1e-6 relative (f32
sums in another order; ``scale`` is the population std on both sides).
The fitted heads are held as ``tests/test_torch_fit.py`` holds fits: the
objective and rho1/rho2 within ``max(truth_tolerance, SOLVER_ATOL_FLOOR)``
(two converged solves stop anywhere inside the tol-sized gap); gamma too
for the sequential solvers, which stay together to 2e-6. The blocked
solver's gamma parts on near-ties (ROADMAP C.6) by up to 0.01 at these
sizes while its objective and offsets agree, so it is not compared
coordinate by coordinate. On new features the JAX head carried across
scores like the JAX head within the f32 ``TOLERANCES`` (atol scaled by
the largest score: the slab values are O(1e-3)); the port's own head
within the f32 ``truth_tolerance``, no label flipped where |score| is
above 1% of the largest.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.kernels.precision import TOLERANCES, truth_tolerance
import repro_torch.core as tc
from repro_torch import convert
from repro_torch.data import make_toy

SOLVER_ATOL_FLOOR = 5e-3
M, D, TOL = 160, 6, 1e-3


@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(4)
    scale = rng.uniform(0.5, 3.0, D).astype(np.float32)
    shift = rng.uniform(-2.0, 2.0, D).astype(np.float32)
    F = make_toy(4, M, d=D)[0] * scale + shift
    Q = make_toy(9, 64, d=D)[0] * scale + shift
    return F, Q


def _specs():
    return (jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jc.rbf(1.0 / D)),
            tc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tc.rbf(1.0 / D)))


def _objective(gamma, Fn, kernel):
    g = torch.as_tensor(np.array(gamma), dtype=torch.float64)
    return float(tc.dual_objective_matfree(g, torch.as_tensor(
        np.asarray(Fn), dtype=torch.float64), kernel))


def _close(a, b):
    tol = truth_tolerance("f32", b)
    return bool(np.all(np.abs(np.asarray(a) - np.asarray(b))
                       <= max(tol["atol"], SOLVER_ATOL_FLOOR)
                       + tol["rtol"] * np.abs(np.asarray(b))))


@pytest.mark.parametrize("mode", ["mean", "last"])
def test_pool_features_matches_reference(mode):
    hidden = np.random.default_rng(1).standard_normal((4, 7, 5)).astype(
        np.float32)
    want = np.asarray(jc.pool_features(jnp.asarray(hidden), mode))
    got = tc.pool_features(torch.as_tensor(hidden), mode)
    assert got.shape == (4, 5) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("solver", ["blocked", "paper", "mvp"])
def test_fit_head_matches_reference(features, solver, normalize):
    F, Q = features
    js, ts = _specs()
    jh = jc.fit_head(jnp.asarray(F), js, solver=solver, tol=TOL,
                     normalize=normalize)
    th = tc.fit_head(F, ts, solver=solver, tol=TOL, normalize=normalize,
                     device="cpu")
    for name in ("mean", "scale"):
        a, b = getattr(th, name).numpy(), np.asarray(getattr(jh, name))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
    if not normalize:
        assert torch.equal(th.mean, torch.zeros(D))
        assert torch.equal(th.scale, torch.ones(D))
    assert int(th.result.iters) > 0 and bool(th.result.converged)
    Fn = (F - np.asarray(jh.mean)) / np.asarray(jh.scale)
    o_t = _objective(th.model.gamma, Fn, ts.kernel)
    o_j = _objective(jh.model.gamma, Fn, ts.kernel)
    assert _close([o_t], [o_j]), (o_t, o_j)
    assert _close([float(th.model.rho1), float(th.model.rho2)],
                  [float(jh.model.rho1), float(jh.model.rho2)])
    if solver != "blocked":
        assert _close(th.model.gamma.numpy(), np.asarray(jh.model.gamma))
    s_j = np.asarray(jh.score(jnp.asarray(Q)))
    top = float(np.abs(s_j).max())
    # The JAX head carried across scores as the JAX head does: the same
    # model and whitening, only the f32 sums in another order.
    carried = tc.FittedHead(
        model=convert.model_from_params(
            gamma=np.array(jh.model.gamma), rho1=float(jh.model.rho1),
            rho2=float(jh.model.rho2), X=np.array(jh.model.X), spec=ts),
        mean=torch.as_tensor(np.array(jh.mean)),
        scale=torch.as_tensor(np.array(jh.scale)), result=th.result)
    f32 = TOLERANCES["f32"]
    np.testing.assert_allclose(carried.score(Q).numpy(), s_j,
                               rtol=f32["rtol"], atol=f32["atol"] * top)
    # The port's own head: within the f32 truth_tolerance, and no label
    # flipped where |score| is above 1% of the largest.
    s_t = th.score(Q).numpy()
    np.testing.assert_allclose(s_t, s_j, **truth_tolerance("f32", s_j))
    sure = np.abs(s_j) > 1e-2 * top
    assert np.array_equal(np.sign(s_t[sure]), np.sign(s_j[sure]))
    assert np.array_equal(th.predict(Q).numpy()[sure],
                          np.asarray(jh.predict(jnp.asarray(Q)))[sure])


def test_unknown_solver_or_pooling_raises(features, monkeypatch):
    F, _ = features
    _, ts = _specs()
    with pytest.raises(ValueError, match="unknown solver"):
        tc.fit_head(F, ts, solver="qp", device="cpu")
    with pytest.raises(ValueError, match="unknown pooling"):
        tc.pool_features(torch.zeros(2, 3, 4), "max")
    # the card unless the CPU is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.fit_head(F, ts)
