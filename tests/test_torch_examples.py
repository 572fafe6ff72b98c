"""The port's examples (``examples/torch_quickstart.py``,
``torch_serve_ocssvm.py``, ``torch_lm_anomaly.py``) run on the CPU at
their own sizes, each held against the JAX package on the same arrays
(the JAX examples draw with ``jax.random``, whose streams the port does
not reproduce, so their printouts are not the yardstick).

* quickstart: the paper SMO's iterations within 1% of ``repro.fit``'s on
  the same rows (ROADMAP C.7), the blocked solver's (the fused fupdate
  provider on both sides, the JAX one in interpret mode) within 10%
  (C.6); both converge.
* serve_ocssvm: the served model carried into the JAX package scores
  every batch and the micro-batched requests through its
  ``ScoringService`` (the decision kernel in interpret mode) as the
  port's service does, within the f32 ``TOLERANCES`` (atol scaled by the
  largest score); the offsets within the solver floor of
  tests/test_engine_parity.py of ``repro.serve`` on the same rows; the
  second ``serve`` is a cache hit.
* No example of the port imports JAX or the JAX package (``ast``).
* lm_anomaly: the first loss equals the JAX ``make_train_step``'s on the
  same parameters (the example's, carried across) and batch within 1e-4;
  the loss falls; the slab head on the example's features scores as the
  JAX ``fit_head`` on the same features: the JAX head carried across
  within the f32 ``TOLERANCES``, the port's own within the f32
  ``truth_tolerance`` with no sign flipped above 1% of the largest score.

Torch runs on one thread here: the examples' many small operations are
slowed tenfold or more when the worker shares its cores.
"""
import ast
import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jc
from repro.configs import get_arch as j_get_arch
from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.ocssvm_paper import PAPER_SPEC as J_PAPER_SPEC
from repro.kernels.precision import TOLERANCES, truth_tolerance
from repro.serve import BatchScorer as JBatchScorer
from repro.serve import ScoringService as JScoringService
from repro.serve.model_cache import pack_model as j_pack_model
from repro.train import train_step as jts
import repro_torch.core as tc
from repro_torch import convert
from repro_torch.data import make_toy
from repro_torch.models.transformer import init_params

ROOT = Path(__file__).resolve().parents[1]
SOLVER_ATOL_FLOOR = 5e-3


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b):
    tol = truth_tolerance("f32", b)
    return bool(np.all(np.abs(np.asarray(a) - np.asarray(b))
                       <= max(tol["atol"], SOLVER_ATOL_FLOOR)
                       + tol["rtol"] * np.abs(np.asarray(b))))


def _scores_close(got, want):
    f32 = TOLERANCES["f32"]
    top = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=f32["rtol"],
                               atol=f32["atol"] * top)


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_ocssvm",
                                  "torch_lm_anomaly", "torch_train_lm"])
def test_the_port_s_examples_import_nothing_of_jax(name):
    tree = ast.parse((ROOT / "examples" / f"{name}.py").read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert "repro_torch" in {m.split(".")[0] for m in mods}
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


# -- quickstart ------------------------------------------------------------

def test_quickstart_iterations_match_the_reference():
    ex = _example("torch_quickstart")
    got = ex.main(device="cpu")
    X, y = make_toy(0, 1000)
    jp = repro.fit(jnp.asarray(X), J_PAPER_SPEC, strategy="paper", tol=1e-3)
    spec = jc.SlabSpec(nu1=0.3, nu2=0.05, eps=0.4, kernel=jc.rbf(0.8))
    jb = repro.fit(jnp.asarray(X), spec, P=16, tol=1e-3, gram_mode="pallas",
                   interpret=True)
    assert got["paper_converged"] and bool(jp.converged)
    assert got["blocked_converged"] and bool(jb.converged)
    assert abs(got["paper_iters"] - int(jp.iters)) <= 0.01 * int(jp.iters)
    assert abs(got["blocked_iters"] - int(jb.iters)) <= 0.1 * int(jb.iters)
    assert _close(got["paper_rho"], [float(jp.model.rho1),
                                     float(jp.model.rho2)])
    assert 0.0 < got["blocked_mcc"] <= 1.0
    assert got["scores"].shape == (200,) and np.isfinite(got["scores"]).all()


# -- serve_ocssvm ----------------------------------------------------------

def test_serve_ocssvm_scores_like_the_reference_service():
    ex = _example("torch_serve_ocssvm")
    got = ex.main(device="cpu")
    sm = got["served"]
    assert got["hit"]
    j_spec = jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jc.rbf(0.5))
    jmodel = jc.OCSSVMModel(
        gamma=jnp.asarray(sm.model.gamma.numpy()),
        rho1=jnp.float32(float(sm.rho1)), rho2=jnp.float32(float(sm.rho2)),
        X=jnp.asarray(sm.model.X.numpy()), spec=j_spec)
    svc = JScoringService(JBatchScorer(j_pack_model(jmodel, precision="f32"),
                                       interpret=True))
    for size, b in got["batches"].items():
        want = np.asarray(svc.score(b["queries"]))
        assert b["scores"].shape == (size,)
        _scores_close(b["scores"], want)
    mb = got["microbatch"]
    pend = [svc.submit(q) for q in mb["requests"]]
    assert svc.flush() == mb["launches"] == 1
    for p, s in zip(pend, mb["scores"]):
        _scores_close(np.asarray(s), np.asarray(p.result()))
    X, _ = make_toy(0, 2000)
    jsm = repro.serve(jnp.asarray(X), j_spec, offsets="quantile", P=16,
                      tol=1e-3)
    assert _close(got["rho"], [float(jsm.rho1), float(jsm.rho2)])


# -- lm_anomaly ------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_anomaly():
    ex = _example("torch_lm_anomaly")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return ex, ex.main(device="cpu")
    finally:
        torch.set_num_threads(n)


def test_lm_anomaly_first_loss_matches_the_reference(lm_anomaly):
    ex, got = lm_anomaly
    cfg = ex.lm_config()
    jcfg = dataclasses.replace(
        j_get_arch("llama3.2-3b"), n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
        layer_pattern=(JLayerSpec("full"),), param_dtype="float32",
        remat="none")
    params = convert.lm_params_to_numpy(init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"), cfg)
    step = jts.make_train_step(jcfg, peak_lr=3e-3, warmup_steps=10,
                               total_steps=ex.STEPS)
    batch = {k: jnp.asarray(v) for k, v in ex.train_batch(0).items()}
    _, m = step(jts.init_train_state(jcfg, params), batch)
    assert abs(got["losses"][0] - float(m["loss"])) < 1e-4
    assert len(got["losses"]) == ex.STEPS
    assert got["losses"][-1] < got["losses"][0]


def test_lm_anomaly_head_scores_like_the_reference_head(lm_anomaly):
    ex, got = lm_anomaly
    F = got["features"]
    assert F["train"].shape == (256, 64) and F["id"].shape == (128, 64)
    j_spec = jc.SlabSpec(nu1=0.2, nu2=0.1, eps=0.3, kernel=jc.rbf(0.05))
    jh = jc.fit_head(jnp.asarray(F["train"]), j_spec, solver="blocked", P=8,
                     tol=1e-3)
    th = got["head"]
    assert got["head_converged"] and bool(jh.result.converged)
    carried = tc.FittedHead(
        model=convert.model_from_params(
            gamma=np.array(jh.model.gamma), rho1=float(jh.model.rho1),
            rho2=float(jh.model.rho2), X=np.array(jh.model.X), spec=ex.SPEC),
        mean=torch.as_tensor(np.array(jh.mean)),
        scale=torch.as_tensor(np.array(jh.scale)), result=th.result)
    for part in ("id", "ood"):
        want = np.asarray(jh.score(jnp.asarray(F[part])))
        _scores_close(carried.score(F[part]).numpy(), want)
        own = got["scores"][part]
        np.testing.assert_allclose(own, want, **truth_tolerance("f32", want))
        top = float(np.abs(want).max())
        sure = np.abs(want) > 1e-2 * top
        assert np.array_equal(np.sign(own[sure]), np.sign(want[sure]))
    assert 0.0 <= got["auc"] <= 1.0
