"""The paper's solver in the port held against the JAX package: the eq. 56
``PaperSelector``, ``smo.solve`` (paper and mvp), the FISTA/PGD QP
baseline and its projection, the KKT views, MCC and the paper's
configuration.

Both packages see the same numpy inputs (``repro_torch.data.make_toy``).
Selections must agree exactly (ids) and to the f32 tolerance (the
columns they carry). ``smo.solve`` runs at m = 200, tol = 1e-3 with
``tests/test_smo_core.py``'s three specs: the objective within 2e-3 (that
file's bound against the QP), the same ``converged``, iterations within
10%. At tol = 1e-4 the two trajectories part on near-ties — an f32
rounding of the movability test (|clip(gb, L, H) - gamma_b| against
1e-11) reads 0 in one package and 5e-10 in the other once gamma differs
by 6e-9 — and the counts differ by up to 14% (ROADMAP C).

The QP is compared iterate for iterate at 400 iterations: FISTA's
iterates part slowly along the flat directions of the dual (largest
gamma difference 1e-6 at 100 iterations, 8e-6 at 300, 1.4e-4 at 1000,
4.7e-4 at 2000 on the rbf cell, while the objectives agree to 1e-9;
ROADMAP C), so 400 iterations hold gamma within the f32 tolerance with
room to spare.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.core.engine as je
import repro.core.kkt as jkkt
from repro.configs import ocssvm_paper as jpaper
from repro.kernels.precision import truth_tolerance
import repro_torch
import repro_torch.core as tc
import repro_torch.core.engine as te
import repro_torch.core.kkt as tkkt
from repro_torch.configs import ocssvm_paper as tpaper
from repro_torch.data import make_toy

SPECS = [  # tests/test_smo_core.py's
    dict(nu1=0.5, nu2=0.05, eps=0.5, kernel=("rbf", 0.5)),
    dict(nu1=0.5, nu2=0.01, eps=2.0 / 3.0, kernel=("linear", None)),
    dict(nu1=0.3, nu2=0.1, eps=0.4, kernel=("rbf", 1.5)),
]
SIDS = ["rbf0.5", "linear", "rbf1.5"]


def _specs(d):
    name, g = d["kernel"]
    jk = jc.rbf(g) if name == "rbf" else jc.linear()
    tk = tc.rbf(g) if name == "rbf" else tc.linear()
    kw = {k: v for k, v in d.items() if k != "kernel"}
    return jc.SlabSpec(kernel=jk, **kw), tc.SlabSpec(kernel=tk, **kw)


def _objective(gamma, K):
    g = np.asarray(gamma, np.float64)
    return 0.5 * g @ K @ g


# -- PaperSelector -----------------------------------------------------------

def _state_pair(X, gamma, spec_d, rho=None):
    """The same SolverState in both packages: f = K @ gamma in f32 (the
    JAX provider's), rho from the JAX recovery unless given."""
    js, ts = _specs(spec_d)
    m = X.shape[0]
    hi, lo = js.upper(m), js.lower(m)
    jp = je.make_provider("precomputed", jnp.asarray(X), js.kernel)
    tp = te.make_provider("precomputed", torch.as_tensor(X), ts.kernel)
    g = jnp.asarray(gamma, jnp.float32)
    f = np.asarray(jp.init_scores(g), np.float32)
    if rho is None:
        rho = [float(r) for r in je.recover_rhos(g, jnp.asarray(f), hi=hi,
                                                  lo=lo, m=m)]
    js_state = je.SolverState(
        g, jnp.asarray(f), jnp.float32(rho[0]), jnp.float32(rho[1]),
        jnp.int32(0), jnp.int32(0), jnp.float32(0), jnp.float32(0),
        jnp.int32(0))
    ts_state = te.SolverState(
        torch.tensor(np.asarray(gamma, np.float32)), torch.tensor(f),
        torch.tensor(rho[0], dtype=torch.float32),
        torch.tensor(rho[1], dtype=torch.float32),
        *(torch.zeros((), dtype=dt) for dt in
          (torch.int32, torch.int32, torch.float32, torch.float32,
           torch.int32)))
    jsel = je.PaperSelector(jp, hi=hi, lo=lo, m=m, tol=1e-4)
    tsel = te.PaperSelector(tp, hi=hi, lo=lo, m=m, tol=1e-4)
    return jsel.select(js_state), tsel.select(ts_state)


def _gamma_in_box(rng, m, spec_d):
    _, ts = _specs(spec_d)
    hi, lo = ts.upper(m), ts.lower(m)
    g = rng.uniform(lo, hi, m)
    g[rng.choice(m, m // 4, replace=False)] = hi      # some at the bounds
    g[rng.choice(m, m // 8, replace=False)] = lo
    g[rng.choice(m, m // 8, replace=False)] = 0.0
    return g.astype(np.float32)


def _assert_same_selection(a, b):
    assert np.asarray(a.ids).tolist() == b.ids.tolist()
    for name in ("gamma", "f", "X"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      getattr(b, name).numpy())
    ref = np.asarray(a.rows)
    assert b.rows.shape == ref.shape
    np.testing.assert_allclose(b.rows.numpy(), ref,
                               **truth_tolerance("f32", ref))


@pytest.mark.parametrize("spec_d", SPECS, ids=SIDS)
def test_paper_selector_matches_reference(spec_d):
    X, _ = make_toy(4, 96)
    g = _gamma_in_box(np.random.default_rng(0), 96, spec_d)
    a, b = _state_pair(X, g, spec_d)
    _assert_same_selection(a, b)


@pytest.mark.parametrize("spec_d", SPECS, ids=SIDS)
def test_paper_selector_ties_take_the_lowest_index(spec_d):
    """Every row twice (rows i and i + 48 equal, with equal gamma): every
    |f_bar| and every partner score ties with its twin, and both argmaxes
    must take the lower index."""
    X0, _ = make_toy(5, 48)
    X = np.concatenate([X0, X0])
    g0 = _gamma_in_box(np.random.default_rng(1), 48, spec_d)
    a, b = _state_pair(X, np.concatenate([g0, g0]) / 2, spec_d)
    _assert_same_selection(a, b)
    assert b.ids[0] < 48


@pytest.mark.parametrize("spec_d", SPECS, ids=SIDS)
def test_paper_selector_with_no_violator(spec_d):
    """gamma = 0 inside a slab that holds every score: no row violates,
    every |f_bar| candidate is -inf and b is row 0 in both packages."""
    X, _ = make_toy(6, 64)
    g = np.zeros(64, np.float32)
    a, b = _state_pair(X, g, spec_d, rho=[-10.0, 10.0])
    _assert_same_selection(a, b)
    assert int(b.ids[0]) == 0


def test_make_selector_maps_the_names():
    X = torch.as_tensor(make_toy(1, 32)[0])
    p = te.make_provider("precomputed", X, tc.rbf(0.5))
    kw = dict(P=4, hi=0.1, lo=-0.1, m=32, tol=1e-3)
    assert isinstance(te.make_selector("paper", p, **kw), te.PaperSelector)
    mvp = te.make_selector("mvp", p, **kw)
    assert isinstance(mvp, te.BlockSelector) and mvp.P == 1
    assert te.make_selector("block", p, **kw).P == 4
    assert te.make_selector("paper", p, **kw).criterion == "kkt"
    with pytest.raises(ValueError):
        te.make_selector("bogus", p, **kw)


# -- smo.solve ---------------------------------------------------------------

@pytest.mark.parametrize("selection", ["paper", "mvp"])
@pytest.mark.parametrize("spec_d", SPECS, ids=SIDS)
def test_smo_solve_matches_reference(spec_d, selection):
    js, ts = _specs(spec_d)
    X, _ = make_toy(1, 200)
    jr = jc.solve_smo(jnp.asarray(X), js, selection=selection, tol=1e-3)
    tr = tc.solve_smo(torch.as_tensor(X), ts, selection=selection, tol=1e-3)
    K = np.asarray(js.kernel.gram(jnp.asarray(X)), np.float64)
    assert _objective(tr.model.gamma.numpy(), K) == pytest.approx(
        _objective(jr.model.gamma, K), abs=2e-3)
    assert bool(tr.converged) == bool(jr.converged)
    assert abs(int(tr.iters) - int(jr.iters)) <= max(1, 0.1 * int(jr.iters))
    g = tr.model.gamma.double()
    assert float(g.sum()) == pytest.approx(ts.total(), abs=1e-5)
    assert float(g.max()) <= ts.upper(200) + 1e-7
    assert float(g.min()) >= ts.lower(200) - 1e-7


def test_fit_paper_and_mvp_route_through_smo_solve():
    js, ts = _specs(SPECS[0])
    X, _ = make_toy(1, 200)
    for strategy in ("paper", "mvp"):
        a = repro_torch.fit(X, ts, strategy=strategy, tol=1e-3,
                            max_outer=50, device="cpu")
        b = tc.solve_smo(torch.as_tensor(X), ts, selection=strategy,
                         tol=1e-3, max_iters=50)
        assert torch.equal(a.model.gamma, b.model.gamma)
        assert int(a.iters) == int(b.iters) <= 50


# -- the QP baseline ---------------------------------------------------------

@pytest.mark.parametrize("accelerate", [True, False], ids=["fista", "pgd"])
@pytest.mark.parametrize("spec_d", SPECS[:2], ids=SIDS[:2])
def test_solve_qp_matches_reference_iterate_for_iterate(spec_d, accelerate):
    js, ts = _specs(spec_d)
    X, _ = make_toy(1, 200)
    # tol < 0: no early stop, so both run exactly 400 iterations (near a
    # fixed point the last step's size sits at the rounding level, where
    # the two packages may cross a tiny tol one iteration apart).
    jq = jc.solve_qp(jnp.asarray(X), js, max_iters=400, tol=-1.0,
                     accelerate=accelerate)
    tq = tc.solve_qp(torch.as_tensor(X), ts, max_iters=400, tol=-1.0,
                     accelerate=accelerate)
    assert int(tq.iters) == int(jq.iters) == 400
    ref = np.asarray(jq.gamma)
    np.testing.assert_allclose(tq.gamma.numpy(), ref,
                               **truth_tolerance("f32", ref))
    o = float(jq.objective)
    np.testing.assert_allclose(float(tq.objective), o,
                               **truth_tolerance("f32", [o]))
    g = tq.gamma.double()
    assert float(g.sum()) == pytest.approx(ts.total(), abs=1e-5)


def test_smo_objective_within_the_qp_bound():
    """tests/test_smo_core.py's bound: SMO <= QP + 5e-4 + 0.05 |QP|."""
    _, ts = _specs(SPECS[0])
    X, _ = make_toy(1, 200)
    Xt = torch.as_tensor(X)
    K = ts.kernel.gram(Xt)
    qp = tc.solve_qp(Xt, ts, max_iters=400, tol=1e-10)
    o_qp = float(tc.dual_objective(qp.gamma, K))
    assert float(qp.objective) == pytest.approx(o_qp, rel=1e-6)
    res = tc.solve_smo(Xt, ts, selection="mvp", tol=1e-3)
    assert float(tc.dual_objective(res.model.gamma, K)) \
        <= o_qp + 5e-4 + 0.05 * abs(o_qp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_project_box_hyperplane(seed):
    rng = np.random.default_rng(seed)
    m = 300
    lo, hi, total = -0.02, 0.01, 1.0 / 3.0
    v = (rng.standard_normal(m) * 0.02).astype(np.float32)
    p = tc.project_box_hyperplane(torch.as_tensor(v), lo, hi, total)
    ref = np.asarray(jc.project_box_hyperplane(jnp.asarray(v), lo, hi,
                                               total))
    np.testing.assert_allclose(p.numpy(), ref, **truth_tolerance("f32", ref))
    assert float(p.double().sum()) == pytest.approx(total, abs=1e-5)
    assert float(p.max()) <= hi and float(p.min()) >= lo


# -- KKT views, rho, MCC, configuration --------------------------------------

def test_kkt_views_match_reference_exactly():
    js, ts = _specs(SPECS[0])
    m = 120
    rng = np.random.default_rng(3)
    g = _gamma_in_box(rng, m, SPECS[0])
    s = rng.standard_normal(m).astype(np.float32) * 0.1
    r1, r2 = np.float32(-0.05), np.float32(0.07)
    vj = np.asarray(jkkt.violation(jnp.asarray(g), jnp.asarray(s),
                                   jnp.float32(r1), jnp.float32(r2), js))
    vt = tkkt.violation(torch.as_tensor(g), torch.as_tensor(s),
                        torch.tensor(r1), torch.tensor(r2), ts)
    np.testing.assert_array_equal(vt.numpy(), vj)
    for tol in (1e-4, 1e-2, 0.1, 10.0):
        assert int(tkkt.n_violators(vt, tol)) == int(
            jkkt.n_violators(jnp.asarray(vj), tol))
        assert bool(tkkt.converged(vt, tol)) == bool(
            jkkt.converged(jnp.asarray(vj), tol))
    fb = tkkt.slab_margin(torch.as_tensor(s), torch.tensor(r1),
                          torch.tensor(r2))
    np.testing.assert_array_equal(fb.numpy(), np.asarray(jkkt.slab_margin(
        jnp.asarray(s), jnp.float32(r1), jnp.float32(r2))))


@pytest.mark.parametrize("spec_d", SPECS, ids=SIDS)
def test_recover_rhos_spec_view_matches_reference(spec_d):
    js, ts = _specs(spec_d)
    X, _ = make_toy(2, 80)
    g = _gamma_in_box(np.random.default_rng(4), 80, spec_d)
    s = np.array(js.kernel.gram(jnp.asarray(X)) @ jnp.asarray(g),
                  np.float32)
    rj = jc.recover_rhos(jnp.asarray(g), jnp.asarray(s), js)
    rt = tc.recover_rhos(torch.as_tensor(g), torch.as_tensor(s), ts)
    np.testing.assert_allclose([float(x) for x in rt],
                               [float(x) for x in rj], rtol=1e-6, atol=1e-7)


def test_mcc_matches_reference_exactly():
    rng = np.random.default_rng(7)
    for _ in range(5):
        y = rng.choice([-1.0, 1.0], 200).astype(np.float32)
        p = rng.choice([-1.0, 1.0], 200).astype(np.float32)
        assert float(tc.mcc(y, torch.as_tensor(p))) == float(
            jc.mcc(jnp.asarray(y), jnp.asarray(p)))
    y = rng.choice([-1.0, 1.0], 50).astype(np.float32)
    assert float(tc.mcc(y, torch.as_tensor(y))) == pytest.approx(1.0)
    # an empty marginal (every prediction positive) gives 0, not NaN
    ones = torch.ones(50)
    assert float(tc.mcc(y, ones)) == 0.0 == float(
        jc.mcc(jnp.asarray(y), jnp.ones(50)))


def test_paper_configuration_matches_reference():
    for name in ("PAPER_SPEC", "FIG2_SPEC"):
        a, b = getattr(jpaper, name), getattr(tpaper, name)
        assert (a.nu1, a.nu2, a.eps) == (b.nu1, b.nu2, b.eps)
        assert a.kernel.name == b.kernel.name == "linear"
    assert tpaper.TABLE1_SIZES == jpaper.TABLE1_SIZES
