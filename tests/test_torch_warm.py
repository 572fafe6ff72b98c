"""Warm starts in the port held against the JAX package: the row hashes,
matching and box repair, ``prepare_warm_start``, the ``SolverArtifact``
checkpoint in both directions, ``fit_update``'s routes, the providers'
``append_rows``/``expire_rows`` and the warm path of the model cache.

The cells are tests/test_streaming.py's, at that file's sizes (96 prior
rows, 6 expired, 12 appended; the 5% append at m = 1000), on
``repro_torch.data.make_toy`` rows in both packages. A warm re-fit must
land on the cold fit's objective within ``truth_tolerance`` (that file's
bound); against the JAX package's cold fit, two independently converged
solves, the solver floor of tests/test_engine_parity.py is added.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jc
import repro.core.engine as je
from repro.core.engine.state import clip_to_box as ref_clip_to_box
from repro.core.ocssvm import dual_objective_matfree as jdo
from repro.kernels.precision import truth_tolerance
import repro_torch
import repro_torch.core as tc
import repro_torch.core.engine as te
from repro_torch import api
from repro_torch.core.ocssvm import dual_objective_matfree
from repro_torch.data import make_toy
from repro_torch.serve.model_cache import ModelCache

SOLVER_ATOL_FLOOR = 5e-3
M_PREV, N_APP, N_EXP = 96, 12, 6


def _specs(kernel_name):
    jk = jc.rbf(gamma=0.5) if kernel_name == "rbf" else jc.linear()
    tk = tc.rbf(gamma=0.5) if kernel_name == "rbf" else tc.linear()
    return (jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jk),
            tc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tk))


def _stream(seed=5, m=M_PREV, n_app=N_APP, n_exp=N_EXP):
    """(X_prev, X_new): drop the first n_exp rows, append n_app fresh."""
    X = make_toy(seed, m + n_app)[0]
    X_prev = X[:m]
    return X_prev, np.concatenate([X_prev[n_exp:], X[m:]])


def _objective(res, X, spec):
    return float(dual_objective_matfree(
        res.model.gamma.double(), torch.as_tensor(X, dtype=torch.float64),
        spec.kernel))


def _jax_artifact(X_prev, spec, precision="f32"):
    prev = repro.fit(jnp.asarray(X_prev), spec, strategy="blocked",
                     precision=precision, tol=1e-4)
    return je.artifact_from_result(prev, precision=precision)


def _to_torch(art_j, tmp_path):
    """A JAX artifact through its .npz into the port."""
    path = str(tmp_path / "jax_artifact.npz")
    art_j.save(path)
    return te.SolverArtifact.load(path)


# -- hashes, matching, the box repair ---------------------------------------

def test_row_hashes_are_the_references_bitwise():
    X = make_toy(1, 200, d=7)[0]
    ref = je.row_hashes(X)
    np.testing.assert_array_equal(te.row_hashes(X), ref)
    np.testing.assert_array_equal(te.row_hashes(torch.as_tensor(X)), ref)
    np.testing.assert_array_equal(te.row_hashes(X.astype(np.float64)), ref)
    with pytest.raises(ValueError):
        te.row_hashes(X[0])


def test_match_rows_and_clip_to_box_are_exact():
    rng = np.random.default_rng(2)
    X = make_toy(2, 60)[0]
    prev = np.concatenate([X[:40], X[:5]])           # 5 duplicated rows
    new = np.concatenate([X[10:50], X[:3], X[2:4]])
    a = te.match_rows(te.row_hashes(prev), te.row_hashes(new))
    b = je.match_rows(je.row_hashes(prev), je.row_hashes(new))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for _ in range(5):
        g = rng.uniform(-0.05, 0.05, 80).astype(np.float32)
        kw = dict(hi=0.02, lo=-0.03, total=0.5)
        np.testing.assert_array_equal(te.clip_to_box(g, **kw),
                                      ref_clip_to_box(g, **kw))
    with pytest.raises(ValueError, match="slack"):
        te.clip_to_box(np.zeros(4, np.float32), hi=0.1, lo=-0.1, total=1.0)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kernel_name", ["rbf", "linear"])
def test_prepare_warm_start_matches_reference(tmp_path, kernel_name,
                                              precision):
    js, ts = _specs(kernel_name)
    X_prev, X_new = _stream()
    art_j = _jax_artifact(X_prev, js, precision)
    art_t = _to_torch(art_j, tmp_path)
    wj, ij = je.prepare_warm_start(art_j, jnp.asarray(X_new), js)
    wt, it = te.prepare_warm_start(art_t, torch.as_tensor(X_new), ts)
    assert dataclasses.asdict(it) == dataclasses.asdict(ij)
    assert it.n_corr > 0 and it.n_fresh == N_APP
    np.testing.assert_array_equal(wt.gamma0.numpy(), np.asarray(wj.gamma0))
    np.testing.assert_array_equal(wt.x_corr.numpy(), np.asarray(wj.x_corr))
    np.testing.assert_array_equal(wt.delta.numpy(), np.asarray(wj.delta))
    ref = np.asarray(wj.f_seed)
    np.testing.assert_allclose(wt.f_seed.numpy(), ref,
                               **truth_tolerance("f32", ref))
    # The invariant the engine relies on, for the port's own seed:
    # f_seed + k(X, x_corr) @ delta == K @ gamma0 over the rounded rows.
    prov = te.make_provider("precomputed", torch.as_tensor(X_new),
                            ts.kernel, precision=precision)
    truth = (prov.K @ wt.gamma0).numpy()
    np.testing.assert_allclose(prov.reconcile_scores(wt).numpy(), truth,
                               **truth_tolerance("f32", truth))


# -- the artifact checkpoint, both directions -------------------------------

def test_jax_artifact_loads_and_feeds_the_ports_fit_update(tmp_path):
    js, ts = _specs("rbf")
    X_prev, X_new = _stream()
    art = _to_torch(_jax_artifact(X_prev, js), tmp_path)
    assert art.m == M_PREV and art.precision == "f32"
    assert art.spec.kernel.name == "rbf" and art.spec.nu1 == 0.5
    np.testing.assert_array_equal(art.hashes, te.row_hashes(X_prev))
    st = {}
    warm = repro_torch.fit_update(art, X_new, strategy="blocked", tol=1e-4,
                                  stats_out=st, device="cpu")
    assert st["mode"] == "warm"
    cold = repro_torch.fit(X_new, ts, strategy="blocked", tol=1e-4,
                           device="cpu")
    o = _objective(cold, X_new, ts)
    np.testing.assert_allclose(_objective(warm, X_new, ts), o,
                               **truth_tolerance("f32", o))


def test_port_artifact_loads_and_feeds_the_references_fit_update(tmp_path):
    js, ts = _specs("rbf")
    X_prev, X_new = _stream()
    prev = repro_torch.fit(X_prev, ts, strategy="blocked", tol=1e-4,
                           device="cpu")
    art = te.artifact_from_result(prev)
    path = str(tmp_path / "port_artifact.npz")
    art.save(path)
    loaded = je.SolverArtifact.load(path)
    np.testing.assert_array_equal(loaded.hashes, je.row_hashes(X_prev))
    np.testing.assert_array_equal(np.asarray(loaded.gamma), art.gamma)
    st = {}
    warm = repro.fit_update(loaded, jnp.asarray(X_new), strategy="blocked",
                            tol=1e-4, stats_out=st)
    assert st["mode"] == "warm"
    cold = repro.fit(jnp.asarray(X_new), js, strategy="blocked", tol=1e-4)
    o = float(jdo(cold.model.gamma, jnp.asarray(X_new), js.kernel))
    np.testing.assert_allclose(
        float(jdo(warm.model.gamma, jnp.asarray(X_new), js.kernel)), o,
        **truth_tolerance("f32", o))
    # and back: the port's own save/load is exact
    again = te.SolverArtifact.load(path)
    for name in ("gamma", "f", "X", "hashes"):
        np.testing.assert_array_equal(getattr(again, name),
                                      getattr(art, name))
    assert (again.rho1, again.rho2, again.precision) == (
        art.rho1, art.rho2, art.precision)


# -- fit_update ---------------------------------------------------------------

_JAX_COLD = {}


def _jax_cold_objective(kernel_name, precision, X_new):
    key = (kernel_name, precision)
    if key not in _JAX_COLD:
        js, _ = _specs(kernel_name)
        r = repro.fit(jnp.asarray(X_new), js, strategy="blocked",
                      precision=precision, tol=1e-4)
        g = np.asarray(r.model.gamma, np.float64)
        K = np.asarray(js.kernel.gram(jnp.asarray(X_new)), np.float64)
        _JAX_COLD[key] = 0.5 * g @ K @ g
    return _JAX_COLD[key]


@pytest.mark.parametrize("strategy", ["blocked", "pallas"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kernel_name", ["rbf", "linear"])
def test_warm_cold_parity_matrix(kernel_name, precision, strategy):
    _, spec = _specs(kernel_name)
    X_prev, X_new = _stream()
    kw = dict(strategy=strategy, tol=1e-4, device="cpu")
    prev = repro_torch.fit(X_prev, spec, precision=precision, **kw)
    art = te.artifact_from_result(prev, precision=precision)
    cold = repro_torch.fit(X_new, spec, precision=precision, **kw)
    stats = {}
    warm = repro_torch.fit_update(art, X_new, stats_out=stats, **kw)
    assert stats["mode"] == "warm"
    assert stats["n_fresh"] == N_APP and stats["n_expired"] == N_EXP
    assert stats["n_overlap"] == M_PREV - N_EXP

    obj_cold = _objective(cold, X_new, spec)
    obj_warm = _objective(warm, X_new, spec)
    np.testing.assert_allclose(obj_warm, obj_cold,
                               **truth_tolerance(precision, obj_cold))
    t = truth_tolerance(precision, obj_cold)
    np.testing.assert_allclose(
        obj_warm, _jax_cold_objective(kernel_name, precision, X_new),
        rtol=t["rtol"], atol=max(t["atol"], SOLVER_ATOL_FLOOR))
    # the slab the two fits carve must agree on fresh queries
    q = torch.as_tensor(make_toy(9, 32)[0])
    sc = cold.model.decision_function(q).numpy()
    sw = warm.model.decision_function(q).numpy()
    np.testing.assert_allclose(sw, sc, **truth_tolerance(precision, sc))


def test_fit_update_5pct_delta_quarter_iters():
    M, APP = 1000, 50                        # 5% appended-rows delta
    _, spec = _specs("rbf")
    X = make_toy(5, M + APP)[0]
    X_prev, X_new = X[:M], X                 # pure append, no expiry
    kw = dict(strategy="blocked", tol=1e-4, device="cpu")
    prev = repro_torch.fit(X_prev, spec, **kw)
    cold = repro_torch.fit(X_new, spec, **kw)
    stats = {}
    warm = repro_torch.fit_update(te.artifact_from_result(prev), X_new,
                                  stats_out=stats, **kw)
    assert stats["mode"] == "warm"
    assert warm.converged and cold.converged
    ratio = int(warm.iters) / int(cold.iters)
    assert ratio <= 0.25, (
        f"warm {int(warm.iters)} vs cold {int(cold.iters)} iters "
        f"(ratio {ratio:.2f} > 0.25)")
    obj_cold = _objective(cold, X_new, spec)
    np.testing.assert_allclose(_objective(warm, X_new, spec), obj_cold,
                               **truth_tolerance("f32", obj_cold))


def test_fit_update_low_overlap_falls_back_cold():
    _, spec = _specs("rbf")
    X_prev, _ = _stream(seed=5)
    X_other = make_toy(77, M_PREV)[0]
    kw = dict(strategy="blocked", tol=1e-3, device="cpu")
    prev = repro_torch.fit(X_prev, spec, **kw)
    stats = {}
    res = repro_torch.fit_update(te.artifact_from_result(prev), X_other,
                                 stats_out=stats, **kw)
    assert stats["mode"] == "cold" and stats["n_overlap"] == 0
    assert stats["P"] is None        # no delta-scaled P on the cold route
    assert res.converged


def _recording_blocked(monkeypatch, raise_when_warm=False):
    seen = []
    real = api.solve_blocked

    def rec(X, spec, **kw):
        seen.append(dict(kw))
        if raise_when_warm and kw.get("warm") is not None:
            raise NotImplementedError("no warm path here")
        return real(X, spec, **kw)

    monkeypatch.setattr(api, "solve_blocked", rec)
    return seen


def test_fit_update_gamma0_routes(monkeypatch):
    _, spec = _specs("rbf")
    X_prev, X_new = _stream()
    prev = repro_torch.fit(X_prev, spec, tol=1e-3, device="cpu")
    art = te.artifact_from_result(prev)
    seen = _recording_blocked(monkeypatch)
    g0 = torch.full((X_new.shape[0],), spec.total() / X_new.shape[0])
    st = {}
    repro_torch.fit_update(art, X_new, tol=1e-3, gamma0=g0, stats_out=st,
                           device="cpu")
    assert st["mode"] == "cold" and st["fallback"] == "gamma0_conflict"
    assert seen[-1]["warm"] is None and seen[-1]["gamma0"] is g0
    assert seen[-1]["P"] == 8                 # no delta-scaled P when cold
    st = {}
    stale = torch.zeros(M_PREV)
    repro_torch.fit_update(art, X_new, tol=1e-3, gamma0=stale, stats_out=st,
                           device="cpu")
    assert st["mode"] == "warm" and st["fallback"] == "gamma0_stale_dropped"
    assert seen[-1]["warm"] is not None and "gamma0" not in seen[-1]
    # the delta-scaled working set: 12 fresh + the corrections, capped
    moving = st["n_fresh"] + st["n_corr"]
    assert st["P"] == seen[-1]["P"] == max(
        8, min(64, st["m"] // 16, 1 << max(moving // 2, 1).bit_length()))


def test_fit_update_refits_cold_when_the_warm_path_raises(monkeypatch):
    _, spec = _specs("rbf")
    X_prev, X_new = _stream()
    prev = repro_torch.fit(X_prev, spec, tol=1e-3, device="cpu")
    seen = _recording_blocked(monkeypatch, raise_when_warm=True)
    st = {}
    res = repro_torch.fit_update(prev, X_new, tol=1e-3, stats_out=st,
                                 device="cpu")
    assert st["mode"] == "cold"
    assert st["fallback"].startswith("warm_unsupported")
    assert seen[0]["warm"] is not None and seen[0]["P"] == st["P"]
    # the delta-scaled P was sized for the warm route: the cold refit
    # runs at the default
    assert seen[1]["warm"] is None and seen[1]["P"] == 8
    assert res.converged


def test_fit_warm_start_accepts_each_seed_kind_and_fills_info():
    _, spec = _specs("rbf")
    X_prev, X_new = _stream()
    prev = repro_torch.fit(X_prev, spec, tol=1e-3, device="cpu")
    art = te.artifact_from_result(prev)
    info = {}
    a = repro_torch.fit(X_new, spec, tol=1e-3, warm_start=art,
                        warm_info_out=info, device="cpu")
    assert info["n_fresh"] == N_APP and info["n_overlap"] == M_PREV - N_EXP
    b = repro_torch.fit(X_new, spec, tol=1e-3, warm_start=prev,
                        device="cpu")
    ws, _ = te.prepare_warm_start(art, torch.as_tensor(X_new), spec)
    c = repro_torch.fit(X_new, spec, tol=1e-3, warm_start=ws, device="cpu")
    assert torch.equal(a.model.gamma, b.model.gamma)
    assert torch.equal(a.model.gamma, c.model.gamma)
    # paper/mvp seed gamma only
    d = repro_torch.fit(X_new, spec, strategy="mvp", tol=1e-3,
                        warm_start=art, max_iters=0, device="cpu")
    assert torch.equal(d.model.gamma, ws.gamma0)
    with pytest.raises(TypeError, match="SolverArtifact"):
        repro_torch.fit(X_new, spec, warm_start=object(), device="cpu")
    with pytest.raises(TypeError):
        repro_torch.fit_update(object(), X_new, device="cpu")


# -- provider append / expire ------------------------------------------------

@pytest.mark.parametrize("gram_mode", ["precomputed", "on_the_fly",
                                       "pallas"])
def test_provider_append_expire_matches_rebuild(gram_mode):
    _, spec = _specs("rbf")
    X_prev, _ = _stream(seed=5)
    X = torch.as_tensor(X_prev[:40])
    X_app = X_prev[40:52]
    kern = spec.kernel
    prov = te.make_provider(gram_mode, X, kern)
    gamma = torch.linspace(0.001, 0.02, X.shape[0])
    f = prov.init_scores(gamma)

    p2, g2, f2 = prov.append_rows(X_app, gamma, f)
    assert type(p2) is type(prov)
    full = torch.cat([X, torch.as_tensor(X_app)])
    ref = te.make_provider(gram_mode, full, kern)
    np.testing.assert_allclose(f2.numpy(), ref.init_scores(g2).numpy(),
                               rtol=0, atol=5e-6)
    assert float(g2[X.shape[0]:].abs().max()) == 0.0
    assert torch.equal(p2.X, ref.X)

    idx = np.asarray([0, 3, 17, 41])
    p3, g3, f3 = p2.expire_rows(idx, g2, f2)
    keep = np.setdiff1d(np.arange(int(g2.shape[0])), idx)
    ref3 = te.make_provider(gram_mode, full[keep], kern)
    np.testing.assert_allclose(f3.numpy(), ref3.init_scores(g3).numpy(),
                               rtol=0, atol=5e-6)
    np.testing.assert_array_equal(g3.numpy(), g2.numpy()[keep])
    if gram_mode == "pallas":
        # the rebuilt fused providers carry the tile rows and their norms
        for p, r in ((p2, ref), (p3, ref3)):
            assert torch.equal(p.X_tile, r.X_tile)
            np.testing.assert_allclose(p.norms.numpy(), r.norms.numpy(),
                                       rtol=1e-7, atol=0)
    if gram_mode == "precomputed":
        np.testing.assert_allclose(p3.K.numpy(), ref3.K.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("gram_mode", ["precomputed", "pallas"])
def test_provider_append_expire_matches_reference(gram_mode):
    js, ts = _specs("rbf")
    X_prev, _ = _stream(seed=5)
    X, X_app = X_prev[:40], X_prev[40:52]
    g = np.linspace(0.001, 0.02, 40, dtype=np.float32)
    jp = je.make_provider(gram_mode, jnp.asarray(X), js.kernel,
                          interpret=True)
    tp = te.make_provider(gram_mode, torch.as_tensor(X), ts.kernel)
    jf, tf = jp.init_scores(jnp.asarray(g)), tp.init_scores(
        torch.as_tensor(g))
    _, jg2, jf2 = jp.append_rows(jnp.asarray(X_app), jnp.asarray(g), jf)
    tp2, tg2, tf2 = tp.append_rows(X_app, torch.as_tensor(g), tf)
    np.testing.assert_allclose(tf2.numpy(), np.asarray(jf2), rtol=0,
                               atol=5e-6)
    idx = [1, 5, 44]
    _, _, jf3 = je.make_provider(
        gram_mode, jnp.concatenate([jnp.asarray(X), jnp.asarray(X_app)]),
        js.kernel, interpret=True).expire_rows(idx, jg2, jf2)
    _, _, tf3 = tp2.expire_rows(idx, tg2, tf2)
    np.testing.assert_allclose(tf3.numpy(), np.asarray(jf3), rtol=0,
                               atol=5e-6)


# -- the model cache's warm path ---------------------------------------------

def test_get_or_fit_warm_start_routes_through_fit_update(monkeypatch):
    _, spec = _specs("rbf")
    X_prev, X_new = _stream()
    cache = ModelCache()
    sm1 = cache.get_or_fit(X_prev, spec, tol=1e-3, device="cpu")
    assert isinstance(sm1.artifact, te.SolverArtifact)
    assert sm1.artifact.m == M_PREV and sm1.artifact.precision == "f32"
    np.testing.assert_array_equal(sm1.artifact.X, X_prev)
    calls = []
    real = api.fit_update

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(api, "fit_update", spy)
    st = {}
    sm2 = cache.get_or_fit(X_new, spec, tol=1e-3, device="cpu",
                           warm_start=sm1.artifact, warm_stats_out=st)
    assert len(calls) == 1 and st["mode"] == "warm"
    assert sm2.artifact.m == X_new.shape[0] and sm2.fit_iters > 0
    # the seed is not part of the key: the same recipe hits
    assert cache.get_or_fit(X_new, spec, tol=1e-3, device="cpu") is sm2
    with pytest.raises(TypeError):
        cache.get_or_fit(X_prev[:50], spec, tol=1e-3, device="cpu",
                         warm_start=object())
