"""The shrinking repack driver in the port held against the JAX package's,
and ``repro_torch.fit``'s routing by strategy.

The driver cells are tests/test_engine_parity.py's shrinking cells: {rbf,
linear} x {f32, bf16}, precomputed Gram, m = 96, P = 4, tol = 1e-4,
``warm_iters=30`` (so the rbf cells leave work for the rounds), on the
same numpy rows in both packages. Objective and both offsets must agree
with the reference's shrinking result and with the port's own
``solve_blocked`` within ``max(truth_tolerance, SOLVER_ATOL_FLOOR)``.
One more cell (m = 150) gathers a bucket smaller than m, so the active
gather, the ``f_offset`` fold and the rescaled nu1/nu2 run on a strict
subset.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core.shrinking import _bucket as ref_bucket
from repro.kernels.precision import truth_tolerance
import repro_torch
import repro_torch.core as tc
from repro_torch import api
from repro_torch.core import shrinking
from repro_torch.data import make_toy
from repro_torch.kernels.precision import round_to_tile

SOLVER_ATOL_FLOOR = 5e-3
M = 96


def _specs(kernel_name):
    jk = jc.rbf(gamma=0.5) if kernel_name == "rbf" else jc.linear()
    tk = tc.rbf(gamma=0.5) if kernel_name == "rbf" else tc.linear()
    return (jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jk),
            tc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tk))


def _objective(gamma, K):
    g = np.asarray(gamma, np.float64)
    return 0.5 * g @ K @ g


def _agree(res, ref, K, precision):
    o, o_ref = _objective(res.model.gamma, K), _objective(ref.model.gamma, K)
    t = truth_tolerance(precision, [o_ref])
    np.testing.assert_allclose(o, o_ref, rtol=t["rtol"],
                               atol=max(t["atol"], SOLVER_ATOL_FLOOR))
    rho = np.asarray([float(res.model.rho1), float(res.model.rho2)])
    rho_ref = np.asarray([float(ref.model.rho1), float(ref.model.rho2)])
    t = truth_tolerance(precision, rho_ref)
    np.testing.assert_allclose(rho, rho_ref, rtol=t["rtol"],
                               atol=max(t["atol"], SOLVER_ATOL_FLOOR))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kernel_name", ["rbf", "linear"])
def test_shrinking_matches_reference_and_blocked(kernel_name, precision):
    js, ts = _specs(kernel_name)
    X, _ = make_toy(5, M)
    kw = dict(P=4, gram_mode="precomputed", precision=precision, tol=1e-4)
    j_shr = jc.solve_blocked_shrinking(jnp.asarray(X), js, warm_iters=30,
                                       **kw)
    t_shr = tc.solve_blocked_shrinking(torch.as_tensor(X), ts,
                                       warm_iters=30, **kw)
    t_blk = tc.solve_blocked(torch.as_tensor(X), ts, **kw)
    K = np.asarray(js.kernel.gram(jnp.asarray(X)), np.float64)
    _agree(t_shr, j_shr, K, precision)
    _agree(t_shr, t_blk, K, precision)
    assert bool(t_shr.converged) and bool(j_shr.converged)
    g = t_shr.model.gamma.double()
    assert float(g.sum()) == pytest.approx(ts.total(), abs=1e-5)
    assert float(g.max()) <= ts.upper(M) + 1e-7
    assert float(g.min()) >= ts.lower(M) - 1e-7
    # The result carries the caller's rows, and f = K @ gamma over them.
    assert torch.equal(t_shr.model.X, torch.as_tensor(X))
    Kt = ts.kernel.gram(round_to_tile(torch.as_tensor(X), precision))
    np.testing.assert_allclose(t_shr.f.numpy(), (Kt @ t_shr.model.gamma)
                               .numpy(), **truth_tolerance("f32", t_shr.f))


def test_shrinking_repacks_a_strict_subset(monkeypatch):
    """m = 150: after 30 warm iterations the active set buckets to 128
    rows, solved with the frozen rows' scores folded into f_offset and
    nu1/nu2 rescaled by m / 128; the result agrees with the reference's
    and with the blocked solve."""
    js, ts = _specs("rbf")
    X, _ = make_toy(5, 150)
    solves = []
    inner = shrinking.solve_blocked

    def spy(Xs, sp, **kw):
        solves.append((Xs.shape[0], sp.nu1, sp.nu2,
                       kw.get("f_offset") is not None))
        return inner(Xs, sp, **kw)

    monkeypatch.setattr(shrinking, "solve_blocked", spy)
    kw = dict(P=4, gram_mode="precomputed", tol=1e-4)
    t_shr = tc.solve_blocked_shrinking(torch.as_tensor(X), ts,
                                       warm_iters=30, **kw)
    assert solves[0] == (150, 0.5, 0.05, False)
    rows, nu1, nu2, offset = solves[1]
    assert rows == 128 and offset
    assert nu1 == 0.5 * 150 / 128 and nu2 == 0.05 * 150 / 128
    j_shr = jc.solve_blocked_shrinking(jnp.asarray(X), js, warm_iters=30,
                                       **kw)
    t_blk = tc.solve_blocked(torch.as_tensor(X), ts, **kw)
    K = np.asarray(js.kernel.gram(jnp.asarray(X)), np.float64)
    _agree(t_shr, j_shr, K, "f32")
    _agree(t_shr, t_blk, K, "f32")
    assert bool(t_shr.converged)


def test_bucket_is_the_reference_rule():
    for m in (1, 63, 64, 65, 100, 150, 4096, 32768):
        for n in list(range(0, 300)) + [1000, 4095, 4096, 4097, 40000]:
            assert shrinking._bucket(n, m) == ref_bucket(n, m), (n, m)


# -- fit routing --------------------------------------------------------------

def _record(monkeypatch, name):
    """Replace api.<name> with a recorder returning a sentinel."""
    seen = []

    def rec(X, spec, **kw):
        seen.append((int(X.shape[0]), kw))
        return "sentinel"

    monkeypatch.setattr(api, name, rec)
    return seen


def test_auto_takes_shrinking_above_8192(monkeypatch):
    shr = _record(monkeypatch, "solve_blocked_shrinking")
    blk = _record(monkeypatch, "solve_blocked")
    X = np.zeros((8193, 2), np.float32)
    assert repro_torch.fit(X, device="cpu") == "sentinel"
    assert [m for m, _ in shr] == [8193] and not blk
    assert shr[0][1]["gram_mode"] == "on_the_fly"   # the CPU's rows
    assert repro_torch.fit(X[:8192], device="cpu") == "sentinel"
    assert [m for m, _ in blk] == [8192] and len(shr) == 1


@pytest.mark.parametrize("strategy,target,cap", [
    ("paper", "solve_smo", "max_iters"),
    ("mvp", "solve_smo", "max_iters"),
    ("blocked", "solve_blocked", "max_outer"),
    ("pallas", "solve_blocked", "max_outer"),
    ("shrinking", "solve_blocked_shrinking", "max_outer"),
])
def test_iteration_cap_reaches_each_strategy(monkeypatch, strategy, target,
                                             cap):
    """max_iters and max_outer are aliases: each solver gets its own
    name, whichever the caller used."""
    seen = _record(monkeypatch, target)
    X = np.zeros((16, 2), np.float32)
    for given in ("max_iters", "max_outer"):
        repro_torch.fit(X, strategy=strategy, device="cpu", **{given: 7})
        kw = seen[-1][1]
        assert kw[cap] == 7
        assert ({"max_iters", "max_outer"} - {cap}).isdisjoint(kw)
    if strategy in ("paper", "mvp"):
        assert seen[-1][1]["selection"] == strategy

