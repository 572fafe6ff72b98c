"""The port's serving path held against the JAX package, and the port's
import hygiene.

* ``convert`` carries a JAX-fitted model across; the port's
  ``pack_model`` + ``BatchScorer`` then score it like the JAX package's
  ``BatchScorer(interpret=True)`` at the bucket edges and on a zero-SV
  model, at every precision. The same model and rounding on both sides:
  f32 tolerance.
* The slice as a whole: ``repro_torch.serve`` against ``repro.serve`` on
  the same data. The two solves stop at different points inside the
  tol-sized gap, so the offsets agree within the solver floor of
  tests/test_engine_parity.py and the decision values within what that
  floor on rho allows: |d value| <= floor * (|s - rho1| + |rho2 - s|).
* No file of the port, nor chip_smoke.py, imports JAX or the JAX package.
"""
import ast
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jc
from repro.kernels.precision import PRECISIONS, truth_tolerance
from repro.serve import BatchScorer as JBatchScorer
from repro.serve import ModelCache as JModelCache
from repro.serve.model_cache import pack_model as j_pack_model
import repro_torch
import repro_torch.core as tc
from repro_torch import convert
from repro_torch.serve import (BUCKETS, BatchScorer, ModelCache,
                               ModelRegistry, bucket_for, fingerprint_array,
                               pack_model, recipe_key)
from repro_torch.data import make_toy
from repro_torch.launch import make_solver_mesh

ROOT = Path(__file__).resolve().parents[1]
SOLVER_ATOL_FLOOR = 5e-3
J_SPEC = jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jc.rbf(0.5))
T_SPEC = tc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tc.rbf(0.5))


@pytest.fixture(scope="module")
def jax_fit():
    X, _ = make_toy(3, 256)
    res = repro.fit(jnp.asarray(X), J_SPEC, strategy="blocked",
                    gram_mode="precomputed", P=16, tol=1e-3)
    return X, res


def _carry(jmodel, **override):
    k = jmodel.spec.kernel
    spec = convert.spec_from_params(
        nu1=jmodel.spec.nu1, nu2=jmodel.spec.nu2, eps=jmodel.spec.eps,
        kernel=k.name, gamma=float(k.gamma), coef0=float(k.coef0),
        degree=k.degree)
    params = dict(gamma=np.asarray(jmodel.gamma), rho1=float(jmodel.rho1),
                  rho2=float(jmodel.rho2), X=np.asarray(jmodel.X))
    params.update(override)
    return convert.model_from_params(spec=spec, **params)


@pytest.mark.parametrize("zero_sv", [False, True], ids=["fitted", "zero_sv"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_carried_model_scores_like_jax(jax_fit, precision, zero_sv):
    X, res = jax_fit
    jmodel = res.model
    if zero_sv:
        jmodel = jmodel._replace(gamma=jnp.zeros_like(jmodel.gamma))
    tmodel = _carry(jmodel)
    jsm = j_pack_model(jmodel, precision=precision)
    tsm = pack_model(tmodel, precision=precision)
    assert tsm.n_sv == jsm.n_sv == (0 if zero_sv else jsm.n_sv)
    assert tuple(tsm.t_pad.shape) == tuple(jsm.t_pad.shape)
    assert np.array_equal(tsm.t_pad.float().numpy(),
                          np.asarray(jsm.t_pad, np.float32))
    assert np.array_equal(tsm.gamma_pad.numpy(), np.asarray(jsm.gamma_pad))
    jsc, tsc = JBatchScorer(jsm, interpret=True), BatchScorer(tsm)
    for n in (63, 64, 65):
        q = make_toy(20 + n, n)[0]
        j = np.asarray(jsc.score(q))
        t = tsc.score(q)
        assert isinstance(t, np.ndarray) and t.shape == (n,)
        np.testing.assert_allclose(t, j, **truth_tolerance("f32", j))
    if zero_sv:
        r1, r2 = float(jmodel.rho1), float(jmodel.rho2)
        np.testing.assert_allclose(t, np.full(n, (0 - r1) * (r2 - 0)),
                                   rtol=1e-6)


def test_carried_result(jax_fit):
    _, res = jax_fit
    tr = convert.result_from_params(
        model=_carry(res.model), iters=int(res.iters),
        n_viol=int(res.n_viol), max_viol=float(res.max_viol),
        gap=float(res.gap), converged=bool(res.converged),
        f=np.asarray(res.f))
    assert int(tr.iters) == int(res.iters)
    assert bool(tr.converged) == bool(res.converged)
    assert np.array_equal(tr.f.numpy(), np.asarray(res.f))
    with pytest.raises(ValueError):
        _carry(res.model, gamma=np.zeros(3, np.float32))


@pytest.mark.parametrize("offsets", ["paper", "quantile"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_fit_then_serve_matches_jax(precision, offsets):
    X, _ = make_toy(3, 256)
    kw = dict(offsets=offsets, P=16, tol=1e-3, precision=precision)
    jsm = repro.serve(jnp.asarray(X), J_SPEC, cache=JModelCache(), **kw)
    tsm = repro_torch.serve(X, T_SPEC, cache=ModelCache(), device="cpu",
                            **kw)
    rho_j = np.asarray([float(jsm.rho1), float(jsm.rho2)])
    rho_t = np.asarray([float(tsm.rho1), float(tsm.rho2)])
    tol_rho = truth_tolerance(precision, rho_j)
    np.testing.assert_allclose(rho_t, rho_j, rtol=tol_rho["rtol"],
                               atol=max(tol_rho["atol"], SOLVER_ATOL_FLOOR))
    q = make_toy(9, 300)[0]
    j = np.asarray(jsm.score(q))
    t = tsm.score(q)
    s = np.asarray(jsm.model.raw_scores(jnp.asarray(q)))
    reach = np.max(np.abs(s - rho_j[0]) + np.abs(rho_j[1] - s))
    np.testing.assert_allclose(t, j, rtol=0, atol=SOLVER_ATOL_FLOOR * reach)
    assert tsm.precision == precision and tsm.t_pad.dtype == {
        "f32": torch.float32, "bf16": torch.bfloat16,
        "f16": torch.float16}[precision]


# -- scorer and cache -----------------------------------------------------------

def test_buckets_and_launch_plan():
    assert BUCKETS == (64, 256, 1024, 4096)
    assert [bucket_for(n) for n in (1, 64, 65, 4096, 9999)] == \
        [64, 64, 256, 4096, 4096]
    with pytest.raises(ValueError):
        bucket_for(0)
    model = tc.OCSSVMModel(gamma=torch.zeros(3), rho1=torch.tensor(0.0),
                           rho2=torch.tensor(1.0), X=torch.zeros((3, 2)),
                           spec=T_SPEC)
    sc = BatchScorer(pack_model(model))
    assert sc.launch_plan(5000) == [(4096, 4096), (904, 1024)]
    assert sc.score(np.zeros((5000, 2), np.float32)).shape == (5000,)
    out = sc.score(torch.zeros((7, 2)))
    assert isinstance(out, torch.Tensor) and out.shape == (7,)
    with pytest.raises(ValueError):
        sc.score(np.zeros((4, 3), np.float32))
    sc.warmup()


def test_cache_coalesces_concurrent_misses(monkeypatch):
    X, _ = make_toy(1, 96)
    cache = ModelCache()
    calls = []
    real_fit = repro_torch.api.fit

    def counting_fit(*a, **k):
        calls.append(1)
        return real_fit(*a, **k)

    monkeypatch.setattr(repro_torch.api, "fit", counting_fit)
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        cache.get_or_fit(X, T_SPEC, device="cpu", tol=1e-3)))
        for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(out) == 8
    assert all(o is out[0] for o in out)
    assert (cache.hits, cache.misses) == (7, 1) and len(cache) == 1


def test_cache_failure_does_not_poison_the_key(monkeypatch):
    X, _ = make_toy(2, 64)
    cache = ModelCache()
    real_fit = repro_torch.api.fit
    state = {"fail": True}

    def flaky_fit(*a, **k):
        if state.pop("fail", False):
            raise RuntimeError("boom")
        return real_fit(*a, **k)

    monkeypatch.setattr(repro_torch.api, "fit", flaky_fit)
    with pytest.raises(RuntimeError):
        cache.get_or_fit(X, T_SPEC, device="cpu")
    assert cache.get_or_fit(X, T_SPEC, device="cpu").n_sv > 0
    assert len(cache) == 1


def test_fingerprint_and_recipe_key():
    X, _ = make_toy(5, 40)
    assert fingerprint_array(X) == fingerprint_array(torch.as_tensor(X))
    assert fingerprint_array(X) != fingerprint_array(X + 1)
    k1 = recipe_key(X, T_SPEC, precision="bf16", P=16)
    assert k1 == recipe_key(X.copy(), T_SPEC, precision="bf16", P=16)
    assert k1 != recipe_key(X, T_SPEC, precision="f32", P=16)
    with pytest.raises(ValueError):
        recipe_key(X, T_SPEC, offsets="bogus")


def test_serve_routes_and_rejects():
    X, _ = make_toy(6, 64)
    cache = ModelCache()
    a = repro_torch.serve(X, T_SPEC, cache=cache, device="cpu")
    assert repro_torch.serve(X, T_SPEC, cache=cache, device="cpu") is a
    assert cache.hits == 1
    # by name through a registry
    reg = ModelRegistry()
    b = repro_torch.serve(X, T_SPEC, model="tenant-a", registry=reg,
                          device="cpu")
    assert repro_torch.serve(model="tenant-a", registry=reg) is b
    assert np.array_equal(b.score(X[:5]), a.score(X[:5]))
    # a one-rank mesh (no process group) scores as the local scorer does
    mesh, _ = make_solver_mesh()
    assert np.array_equal(b.scorer(mesh=mesh).score(X[:5]), a.score(X[:5]))
    with pytest.raises(ValueError, match="no axis 'pod'"):
        b.scorer(mesh=mesh, data_axis="pod")
    # a warm start must be a prior fit: on a miss (the seed is no part of
    # the key, so X itself would hit) fit_update refuses anything else
    with pytest.raises(TypeError, match="SolverArtifact"):
        cache.get_or_fit(X[:40], T_SPEC, warm_start=object(), device="cpu")


def test_serve_surface_equals_the_reference():
    import repro.serve as jserve
    import repro_torch.serve as tserve
    assert tserve.__all__ == jserve.__all__
    assert all(hasattr(tserve, n) for n in tserve.__all__)
    assert repro_torch.__all__ == repro.__all__
    assert repro_torch.serve_async is tserve.serve_async


# -- import hygiene ---------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "repro")


def test_port_sources_import_nothing_of_jax():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    serve_dir = ROOT / "src" / "repro_torch" / "serve"
    assert {serve_dir / f"{m}.py" for m in (
        "drift", "service", "registry", "admission", "async_driver",
        "shm_registry")} <= set(files)
    port = ROOT / "src" / "repro_torch"
    assert {port / "checkpoint" / "manager.py",
            port / "runtime" / "fault_tolerance.py",
            port / "core" / "head.py",
            port / "launch" / "serve_slab.py"} <= set(files)
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch; repro_torch.fit; repro_torch.serve; "
            "import repro_torch.convert, repro_torch.serve.scorer, "
            "repro_torch.kernels._build, repro_torch.serve.shm_registry, "
            "repro_torch.serve.async_driver, repro_torch.serve.drift, "
            "repro_torch.checkpoint.manager, "
            "repro_torch.runtime.fault_tolerance, repro_torch.core.head, "
            "repro_torch.launch.serve_slab; "
            "repro_torch.serve_async; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
