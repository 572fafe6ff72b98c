"""The port's model registry held against the JAX package's.

* One script of ``register`` / ``get`` / ``evict`` / ``set_quota`` /
  ``refresh`` (drift-gated warm, shifted cold, forced) / ``replace`` /
  ``unregister`` and the routed ``serve`` runs in both packages on the
  same rows: the same names, versions, quotas, ``refresh_modes`` and
  error types, and served scores within the f32 ``TOLERANCES``.
* ``ExtendableFingerprint.key`` and ``recipe_key`` are the reference's
  tuples, for an f32 array and for a bf16 tensor against the reference's
  bf16 array.
* Concurrent ``get`` on one name runs exactly one fit; warm lookups skip
  the re-fingerprint; ``ModelCache.lookup/evict/clear``.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.serve as jserve
import repro_torch
import repro_torch.core as tc
import repro_torch.serve as tserve
from repro.kernels.precision import truth_tolerance
from repro_torch.data import make_toy
from repro_torch.launch import make_solver_mesh
from repro_torch.serve import registry as tregistry

M = 96
FIT_KW = dict(tol=1e-3, strategy="blocked")


def _specs(pkg):
    return (pkg.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=pkg.rbf(0.5)),
            pkg.SlabSpec(nu1=0.3, nu2=0.05, eps=0.5, kernel=pkg.rbf(1.5)))


def _data():
    X = make_toy(5, M)[0]
    rng = np.random.default_rng(0)
    inband = (X[:12] + rng.normal(0, 1e-3, (12, X.shape[1]))).astype(
        np.float32)
    other = make_toy(11, 64)[0]
    q = make_toy(21, 70)[0]
    return X, inband, other, q


def _script(serve_pkg, core_pkg, routed_serve, kw):
    """Drive one registry; returns (log of everything but scores,
    scores). Each step logs its result or its error's type name."""
    X, inband, other, q = _data()
    spec_a, spec_b = _specs(core_pkg)
    log, scores = [], []

    def step(what, fn):
        try:
            out = fn()
        except Exception as e:          # the typed errors are the point
            log.append((what, "raised", type(e).__name__))
            return None
        log.append((what, out))
        return out

    def served(name):
        sm = reg.get(name)
        scores.append(np.asarray(sm.score(q)))
        return sm

    reg = serve_pkg.ModelRegistry()
    step("register a", lambda: reg.register("a", X, spec_a, quota=64,
                                            **kw).quota)
    step("register b", lambda: reg.register("b", X, spec_b, **kw).quota)
    step("names", reg.names)
    step("len/contains", lambda: (len(reg), "a" in reg, "zz" in reg))
    step("same recipe is a no-op",
         lambda: reg.register("a", X, spec_a, **kw) is reg.recipe("a"))
    step("quota update", lambda: reg.register("a", X, spec_a, quota=50,
                                              **kw).quota)
    step("different recipe", lambda: reg.register("a", other, spec_a, **kw))
    step("bad quota", lambda: reg.register("c", X, spec_a, quota=0, **kw))
    step("empty name", lambda: reg.register("", X, spec_a, **kw))
    sm_a = served("a")
    served("b")
    step("get twice is a hit", lambda: reg.get("a") is sm_a)
    step("unknown", lambda: reg.get("zz"))
    step("unknown is a KeyError",
         lambda: isinstance(serve_pkg.UnknownModelError("x"), KeyError))
    step("evict", lambda: reg.evict("a"))
    step("evict again", lambda: reg.evict("a"))
    step("versions", lambda: (reg.version("a"), reg.version("b")))
    served("a")
    step("set_quota", lambda: reg.set_quota("a", 32).quota)
    step("set_quota unknown", lambda: reg.set_quota("zz", 3))
    step("set_quota bad", lambda: reg.set_quota("a", 0))
    step("quota", lambda: (reg.quota("a"), reg.quota("b")))

    def refresh(**r):
        sm = reg.refresh("a", **r)
        st = reg.refresh_stats("a")
        scores.append(np.asarray(sm.score(q)))
        drift = st["last_drift"]
        return (dict(st["modes"]), None if drift is None else drift.drifted,
                None if st["last_warm"] is None
                else st["last_warm"]["mode"],
                int(reg.recipe("a").X.shape[0]), reg.version("a"))

    step("refresh in band", lambda: refresh(append=inband))
    step("refresh shifted", lambda: refresh(append=inband + 5.0))
    step("refresh cold", lambda: refresh(mode="cold"))
    step("refresh warm", lambda: refresh(mode="warm"))
    step("refresh replace X", lambda: refresh(X=X))
    step("refresh bad mode", lambda: reg.refresh("a", mode="tepid"))
    step("refresh both", lambda: reg.refresh("a", append=inband, X=X))
    step("refresh bad width",
         lambda: reg.refresh("a", append=np.zeros((2, 5), np.float32)))
    step("quota survives refresh", lambda: reg.quota("a"))
    step("replace", lambda: reg.register("b", other, spec_b, replace=True,
                                         **kw).quota)
    served("b")
    step("versions after", lambda: (reg.version("a"), reg.version("b")))
    step("routed serve by name",
         lambda: routed_serve(model="b", registry=reg) is reg.get("b"))
    step("routed register", lambda: routed_serve(
        X, spec_a, model="c", registry=reg, quota=10, **kw) is reg.get("c"))
    step("routed quota update",
         lambda: (routed_serve(model="c", registry=reg, quota=20)
                  is reg.get("c"), reg.quota("c")))
    step("routed spec without X",
         lambda: routed_serve(model="c", spec=spec_a, registry=reg))
    step("routed registry without model",
         lambda: routed_serve(X, spec_a, registry=reg))
    step("routed cache with model",
         lambda: routed_serve(X, spec_a, model="c", cache=object()))
    step("routed nothing", lambda: routed_serve())
    step("unregister", lambda: reg.unregister("a"))
    step("names after", reg.names)
    step("get unregistered", lambda: reg.get("a"))
    step("stats unregistered", lambda: reg.refresh_stats("a"))
    step("version after unregister", lambda: reg.version("a"))
    step("cache size", lambda: (len(reg.cache), reg.cache.maxsize))
    return log, scores


def test_registry_script_matches_the_reference():
    j_log, j_scores = _script(jserve, jc, jserve.registry.serve, FIT_KW)
    t_log, t_scores = _script(tserve, tc, tregistry.serve,
                              dict(FIT_KW, device="cpu"))
    assert t_log == j_log
    assert len(t_scores) == len(j_scores) == 9
    for t, j in zip(t_scores, j_scores):
        assert isinstance(t, np.ndarray) and t.shape == j.shape
        np.testing.assert_allclose(t, j, **truth_tolerance("f32", j))


def test_api_serve_routes_by_name():
    X, _, _, q = _data()
    spec_a, _ = _specs(tc)
    reg = tserve.ModelRegistry()
    sm = repro_torch.serve(X, spec_a, model="tenant-a", registry=reg,
                           quota=40, device="cpu", **FIT_KW)
    assert repro_torch.serve(model="tenant-a", registry=reg) is sm
    assert reg.quota("tenant-a") == 40
    assert sm.score(q).shape == (len(q),)
    with pytest.raises(tserve.UnknownModelError):
        repro_torch.serve(model="nobody", registry=reg)


# -- fingerprints and keys ----------------------------------------------------

@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_fingerprints_and_keys_equal_the_reference(precision):
    X = make_toy(3, 64)[0]
    more = make_toy(4, 8)[0]
    if precision == "f32":
        jx, jm, tx, tm = X, more, X, torch.as_tensor(more)
    else:
        jx, jm = (jnp.asarray(a, jnp.bfloat16) for a in (X, more))
        tx, tm = (torch.as_tensor(a).to(torch.bfloat16) for a in (X, more))
    jfp, tfp = (jserve.ExtendableFingerprint(jx[:48]),
                tserve.ExtendableFingerprint(tx[:48]))
    assert tfp.key == jfp.key == jserve.fingerprint_array(jx[:48])
    assert tfp.key == tserve.fingerprint_array(tx[:48])
    assert tfp.key[1] == ("float32" if precision == "f32" else "bfloat16")
    t_ext, j_ext = tfp.extend(tx[48:]), jfp.extend(jx[48:])
    assert t_ext.key == j_ext.key == tserve.fingerprint_array(tx)
    j_all = jnp.concatenate([jnp.asarray(jx), jnp.asarray(jm)])
    assert t_ext.extend(tm).key == j_ext.extend(jm).key \
        == jserve.fingerprint_array(j_all)
    # what only a full re-hash can key
    assert tfp.extend(torch.zeros((2, X.shape[1] + 1))) is None
    other = np.float64 if precision == "f32" else np.float32
    assert tfp.extend(np.zeros((2, X.shape[1]), other)) is None
    j_spec, _ = _specs(jc)
    t_spec, _ = _specs(tc)
    kw = dict(precision="bf16", P=16, offsets="quantile")
    assert tserve.recipe_key(tx, t_spec, **kw) \
        == jserve.recipe_key(jx, j_spec, **kw)
    assert tserve.recipe_key(tx, t_spec, _fingerprint=tfp.key) \
        == jserve.recipe_key(jx, j_spec, _fingerprint=jfp.key)


def test_extendable_fingerprint_refuses_above_the_budget(monkeypatch):
    from repro_torch.serve import model_cache
    X = make_toy(3, 64)[0]
    monkeypatch.setattr(model_cache, "_HASH_SAMPLE_BYTES", X.nbytes - 1)
    sampled = model_cache.ExtendableFingerprint(X)
    assert sampled.key == model_cache.fingerprint_array(X)
    assert sampled.extend(X[:4]) is None
    monkeypatch.setattr(model_cache, "_HASH_SAMPLE_BYTES", X.nbytes + 1)
    assert model_cache.ExtendableFingerprint(X).extend(X[:4]) is None


# -- concurrency and the cache's lookup/evict/clear ----------------------------

@pytest.fixture
def counting_fit(monkeypatch):
    calls = []
    real_fit = repro_torch.api.fit

    def spy(*a, **k):
        calls.append(1)
        return real_fit(*a, **k)

    monkeypatch.setattr(repro_torch.api, "fit", spy)
    return calls


def test_concurrent_gets_run_one_fit(counting_fit):
    X, _, _, _ = _data()
    spec_a, _ = _specs(tc)
    reg = tserve.ModelRegistry()
    reg.register("a", X, spec_a, device="cpu", **FIT_KW)
    assert counting_fit == []                 # registration fits nothing
    barrier = threading.Barrier(8)
    out = []

    def worker():
        barrier.wait()
        out.append(reg.get("a"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert len(counting_fit) == 1 and len(out) == 8
    assert all(o is out[0] for o in out)


def test_warm_lookup_skips_refingerprint(counting_fit, monkeypatch):
    X, _, _, _ = _data()
    spec_a, _ = _specs(tc)
    reg = tserve.ModelRegistry()
    reg.register("a", X, spec_a, device="cpu", **FIT_KW)
    sm = reg.get("a")

    def boom(*a, **k):
        raise AssertionError("re-fingerprint on a warm lookup")

    monkeypatch.setattr(tserve.model_cache, "fingerprint_array", boom)
    assert reg.get("a") is sm and len(counting_fit) == 1


def test_refresh_append_rekeys_in_delta_only(monkeypatch):
    X, inband, _, _ = _data()
    spec_a, _ = _specs(tc)
    reg = tserve.ModelRegistry()
    reg.register("a", X, spec_a, device="cpu", **FIT_KW)
    reg.get("a")
    reg.refresh("a", append=inband[:6])     # first append builds the fp
    monkeypatch.setattr(tregistry.ExtendableFingerprint, "__init__",
                        lambda self, X: pytest.fail("full re-hash"))
    sm = reg.refresh("a", append=torch.as_tensor(inband[6:]))
    assert reg.recipe("a").X.shape == (M + 12, X.shape[1])
    assert reg.recipe("a").key == tserve.recipe_key(
        np.concatenate([X, inband]), spec_a, device="cpu", **FIT_KW)
    assert reg.get("a") is sm


def test_refresh_of_a_tensor_recipe_stays_a_tensor():
    X, inband, _, q = _data()
    spec_a, _ = _specs(tc)
    reg = tserve.ModelRegistry()
    reg.register("a", torch.as_tensor(X), spec_a, device="cpu", **FIT_KW)
    reg.get("a")
    sm = reg.refresh("a", append=inband)
    Xr = reg.recipe("a").X
    assert isinstance(Xr, torch.Tensor) and Xr.shape == (M + 12, X.shape[1])
    assert reg.refresh_stats("a")["modes"] == {"warm": 1, "cold": 0}
    assert reg.recipe("a").key == tserve.recipe_key(
        np.concatenate([X, inband]), spec_a, device="cpu", **FIT_KW)
    assert sm.score(q).shape == (len(q),)


def test_cache_lookup_evict_clear(counting_fit):
    X, _, _, _ = _data()
    spec_a, _ = _specs(tc)
    cache = tserve.ModelCache()
    key = tserve.recipe_key(X, spec_a, device="cpu", **FIT_KW)
    assert cache.lookup(key) is None and cache.hits == 0
    sm = cache.get_or_fit(X, spec_a, device="cpu", **FIT_KW)
    assert cache.lookup(key) is sm and cache.hits == 1
    assert cache.get_or_fit(None, _key=key) is sm      # keyed: no X read
    assert cache.evict(key) and not cache.evict(key) and len(cache) == 0
    cache.get_or_fit(X, spec_a, device="cpu", **FIT_KW)
    cache.clear()
    assert len(cache) == 0 and (cache.hits, cache.misses) == (0, 0)
    assert len(counting_fit) == 2


def test_cache_clear_during_an_inflight_fit_drops_its_insert(monkeypatch):
    X, _, _, _ = _data()
    spec_a, _ = _specs(tc)
    cache = tserve.ModelCache()
    entered, release = threading.Event(), threading.Event()
    real_fit = repro_torch.api.fit

    def slow_fit(*a, **k):
        entered.set()
        release.wait(60)
        return real_fit(*a, **k)

    monkeypatch.setattr(repro_torch.api, "fit", slow_fit)
    out = []
    t = threading.Thread(target=lambda: out.append(
        cache.get_or_fit(X, spec_a, device="cpu", **FIT_KW)))
    t.start()
    assert entered.wait(60)
    cache.clear()
    release.set()
    t.join(300)
    assert len(out) == 1 and out[0].n_sv > 0
    assert len(cache) == 0          # completed into the pre-clear generation


def test_serving_model_predict_and_scorer_kwargs():
    X, _, _, q = _data()
    spec_a, _ = _specs(tc)
    sm = tserve.ModelCache().get_or_fit(X, spec_a, device="cpu", **FIT_KW)
    s = sm.score(q)
    assert np.array_equal(sm.predict(q), np.where(s >= 0, 1, -1))
    pt = sm.predict(torch.as_tensor(q))
    assert isinstance(pt, torch.Tensor)
    assert np.array_equal(pt.numpy(), sm.predict(q))
    assert sm.scorer() is sm.scorer()
    # kwargs build a fresh scorer: a one-rank mesh scores as the default
    mesh, _ = make_solver_mesh()
    assert sm.scorer(mesh=mesh) is not sm.scorer()
    assert np.array_equal(sm.scorer(mesh=mesh).score(q), s)
    with pytest.raises(TypeError):
        sm.scorer(interpret=True)
