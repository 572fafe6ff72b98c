"""The port's solver engine held against the JAX package, piece by piece.

Each cell hands the same numpy state to ``repro.core.engine`` and to
``repro_torch.core.engine`` (on the CPU) and compares what comes back:
the working-set ids exactly (ties included), integer counts exactly, and
f32 values at the f32 tolerance of ``TOLERANCES`` (the two differ only by
summation order) or tighter where the arithmetic is elementwise.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.engine as jeng
import repro.core.kernel_fn as jkf
import repro.core.ocssvm as joc
from repro.kernels.precision import truth_tolerance
import repro_torch.core.engine as teng
import repro_torch.core.kernel_fn as tkf
import repro_torch.core.ocssvm as toc

M = 60
J_SPEC = joc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jkf.rbf(0.5))
T_SPEC = toc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tkf.rbf(0.5))
HI, LO = T_SPEC.upper(M), T_SPEC.lower(M)


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _close(port, ref):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(port).astype(np.float32), ref,
                               **truth_tolerance("f32", ref))


def _state(seed, *, bounds_only=False):
    """gamma with entries at hi, at lo, at 0 and (unless bounds_only)
    free on both planes; f random."""
    rng = np.random.default_rng(seed)
    choices = [HI, LO, 0.0] if bounds_only else [HI, LO, 0.0, HI / 3,
                                                 LO / 4]
    g = rng.choice(np.asarray(choices, np.float32), size=M)
    if not bounds_only:
        g = np.where(rng.random(M) < 0.3,
                     rng.uniform(LO, HI, M).astype(np.float32), g)
    f = rng.standard_normal(M).astype(np.float32) * 0.01
    return g.astype(np.float32), f


# -- feasible_init ------------------------------------------------------------

@pytest.mark.parametrize("nu1,m", [(0.5, 97), (4.0, 50)],
                         ids=["uniform", "waterfill"])
def test_feasible_init_bitwise(nu1, m):
    js = joc.SlabSpec(nu1=nu1, nu2=0.05, eps=0.5, kernel=jkf.rbf(0.5))
    ts = toc.SlabSpec(nu1=nu1, nu2=0.05, eps=0.5, kernel=tkf.rbf(0.5))
    j = np.asarray(joc.feasible_init(m, js, jnp.float32))
    t = toc.feasible_init(m, ts, torch.float32).numpy()
    assert np.array_equal(j, t)


# -- stats ----------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("bounds_only", [False, True],
                         ids=["free", "midpoint"])
def test_solver_stats_fresh_matches_jax(seed, bounds_only):
    g, f = _state(seed, bounds_only=bounds_only)
    kw = dict(hi=HI, lo=LO, m=M, tol=1e-3)
    zero = np.float32(0.0)
    j = jeng.solver_stats_fresh(jnp.asarray(g), jnp.asarray(f), zero, zero,
                                True, **kw)
    t = teng.solver_stats_fresh(_t(g), _t(f), _t(zero), _t(zero), True,
                                **kw)
    for jv, tv in zip(j, t):
        if np.issubdtype(np.asarray(jv).dtype, np.integer):
            assert int(jv) == int(tv)
        else:
            _close(tv, jv)


def test_violation_cases_match_jax():
    g, f = _state(11)
    kw = dict(hi=HI, lo=LO, m=M)
    j = jeng.violation(jnp.asarray(g), jnp.asarray(f), 0.001, 0.002, **kw)
    t = teng.violation(_t(g), _t(f), _t(0.001), _t(0.002), **kw)
    assert np.array_equal(np.asarray(j), t.numpy())   # elementwise only


# -- selection ------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_block_selector_ties_and_inf(seed):
    """Scores drawn from three values (many ties) and most rows at a bound,
    so fewer than P rows can shrink and -inf entries tie: the ids must be
    exactly jax.lax.top_k's (lowest index first on a tie)."""
    rng = np.random.default_rng(seed)
    g = rng.choice(np.asarray([HI, LO, LO, LO, 0.0], np.float32), size=M)
    f = rng.choice(np.asarray([-0.5, 0.0, 0.5], np.float32), size=M)
    X = rng.standard_normal((M, 3)).astype(np.float32)
    P = 8
    zero = np.float32(0.0)
    js = jeng.SolverState(jnp.asarray(g), jnp.asarray(f), zero, zero,
                          jnp.int32(0), jnp.int32(0), zero, zero,
                          jnp.int32(0))
    ts = teng.SolverState(_t(g), _t(f), _t(zero), _t(zero), None, None,
                          None, None, None)
    jsel = jeng.BlockSelector(types.SimpleNamespace(X=jnp.asarray(X)), P=P,
                              hi=HI, lo=LO).select(js)
    tsel = teng.BlockSelector(types.SimpleNamespace(X=_t(X)), P=P, hi=HI,
                              lo=LO).select(ts)
    assert np.array_equal(np.asarray(jsel.ids), tsel.ids.numpy())
    assert np.array_equal(np.asarray(jsel.X), tsel.X.numpy())


# -- the pair solve -------------------------------------------------------------

def _selection(seed, P, *, duplicate=False):
    rng = np.random.default_rng(seed)
    ids = rng.choice(M, size=2 * P, replace=False).astype(np.int32)
    if duplicate:
        ids[P + 1] = ids[1]          # a frozen pair, as top-k ties give
    g, f = _state(seed)
    X = rng.standard_normal((M, 4)).astype(np.float32)
    Xs = X[ids]
    K = np.asarray(jkf.rbf(0.5).cross(jnp.asarray(Xs), jnp.asarray(Xs)))
    dsl = np.ones(2 * P, np.float32)
    return ids, g[ids], f[ids], Xs, K, dsl


@pytest.mark.parametrize("duplicate", [False, True], ids=["plain", "frozen"])
def test_gauss_seidel_pairs_tight(duplicate):
    P = 6
    ids, g, f, Xs, K, dsl = _selection(3, P, duplicate=duplicate)
    jsel = jeng.Selection(ids=jnp.asarray(ids), gamma=jnp.asarray(g),
                          f=jnp.asarray(f), X=jnp.asarray(Xs))
    tsel = teng.Selection(ids=_t(ids, torch.int64), gamma=_t(g), f=_t(f),
                          X=_t(Xs))
    j = np.asarray(jeng.gauss_seidel_pairs(jsel, jnp.asarray(K),
                                           jnp.asarray(dsl), hi=HI, lo=LO))
    t = teng.gauss_seidel_pairs(tsel, _t(K), _t(dsl), hi=HI, lo=LO).numpy()
    # Elementwise f32 arithmetic in the same order: equal to a few ulp.
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-9)
    if duplicate:
        assert t[1] == 0.0 and t[P + 1] == 0.0
    # Every pair moves on the equality hyperplane.
    assert abs(float(t.astype(np.float64).sum())) < 1e-8


# -- providers ------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("gram_mode", ["precomputed", "on_the_fly",
                                       "pallas"])
def test_providers_match_jax(gram_mode, precision):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((M, 5)).astype(np.float32)
    g, _ = _state(5)
    jp = jeng.make_provider(gram_mode, jnp.asarray(X), jkf.rbf(0.5),
                            interpret=True, precision=precision)
    tp = teng.make_provider(gram_mode, _t(X), tkf.rbf(0.5),
                            precision=precision)
    assert tp.name == gram_mode
    assert np.array_equal(np.asarray(jp.X), tp.X.numpy())
    jf = np.asarray(jp.init_scores(jnp.asarray(g)))
    _close(tp.init_scores(_t(g)), jf)
    ids = np.asarray([3, 17, 29, 41], np.int32)
    delta = np.asarray([0.01, -0.02, -0.01, 0.02], np.float32)
    jsel = jp.prepare(jeng.Selection(ids=jnp.asarray(ids),
                                     gamma=jnp.asarray(g[ids]),
                                     f=jnp.asarray(jf[ids]),
                                     X=jp.X[jnp.asarray(ids)]))
    tsel = tp.prepare(teng.Selection(ids=_t(ids, torch.int64),
                                     gamma=_t(g[ids]), f=_t(jf[ids]),
                                     X=tp.X[_t(ids, torch.int64)]))
    _close(tp.apply_update(_t(jf), tsel, _t(delta)),
           jp.apply_update(jnp.asarray(jf), jsel, jnp.asarray(delta)))
    _close(tp.block(tsel), jp.block(jsel))
    _close(tp.diag_sel(tsel), jp.diag_sel(jsel))
    assert np.array_equal(
        tp.scatter(_t(g), tsel, _t(delta)).numpy(),
        np.asarray(jp.scatter(jnp.asarray(g), jsel, jnp.asarray(delta))))


def test_blocked_scores_and_objective_above_single_pass():
    m = teng.SINGLE_PASS_MAX + 100
    rng = np.random.default_rng(6)
    X = _t(rng.standard_normal((m, 2)).astype(np.float32))
    g = _t(rng.standard_normal(m).astype(np.float32) / m)
    kern = tkf.rbf(0.5)
    K = kern.gram(X)
    _close(teng.raw_scores_blocked(X, g, kern), (K @ g).numpy())
    _close(toc.dual_objective_matfree(g, X, kern),
           toc.dual_objective(g, K).numpy())


# -- model helpers ----------------------------------------------------------------

def test_model_helpers_match_jax():
    rng = np.random.default_rng(8)
    X = rng.standard_normal((M, 3)).astype(np.float32)
    g, _ = _state(8)
    g[::4] = 0.0
    jm = joc.OCSSVMModel(gamma=jnp.asarray(g), rho1=jnp.float32(0.01),
                         rho2=jnp.float32(0.02), X=jnp.asarray(X),
                         spec=J_SPEC)
    tm = toc.OCSSVMModel(gamma=_t(g), rho1=_t(0.01), rho2=_t(0.02), X=_t(X),
                         spec=T_SPEC)
    Q = rng.standard_normal((9, 3)).astype(np.float32)
    _close(tm.decision_function(_t(Q)), jm.decision_function(jnp.asarray(Q)))
    assert np.array_equal(tm.predict(_t(Q)).numpy(),
                          np.asarray(jm.predict(jnp.asarray(Q))))
    jq, tq = joc.with_quantile_offsets(jm), toc.with_quantile_offsets(tm)
    _close(torch.stack([tq.rho1, tq.rho2]), [jq.rho1, jq.rho2])
    jc, tc = joc.compact_support(jm), toc.compact_support(tm)
    assert np.array_equal(np.asarray(jc.gamma), tc.gamma.numpy())
    assert np.array_equal(np.asarray(jc.X), tc.X.numpy())
    K = np.asarray(J_SPEC.kernel.gram(jnp.asarray(X)))
    _close(toc.dual_objective(_t(g), _t(K)),
           joc.dual_objective(jnp.asarray(g), jnp.asarray(K)))
    _close(toc.dual_objective_matfree(_t(g), _t(X), T_SPEC.kernel),
           joc.dual_objective_matfree(jnp.asarray(g), jnp.asarray(X),
                                      J_SPEC.kernel))
    j1, j2 = jeng.recover_rhos(jnp.asarray(g), jnp.asarray(g) * 3, hi=HI,
                               lo=LO, m=M)
    t1, t2 = teng.recover_rhos(_t(g), _t(g) * 3, hi=HI, lo=LO, m=M)
    _close(torch.stack([t1, t2]), [j1, j2])


def test_concrete_spec_reads_tensors_once():
    s = toc.SlabSpec(nu1=torch.tensor(0.5), kernel=tkf.KernelFn(
        "rbf", gamma=torch.tensor(0.25)))
    c = toc.concrete_spec(s)
    assert isinstance(c.nu1, float) and isinstance(c.kernel.gamma, float)
    hash(c)
