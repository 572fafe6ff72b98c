"""``repro_torch.fit`` held against ``repro.fit`` on the same numpy data.

Both packages solve the same toy problem with the same strategy, gram
mode, precision, P and tol (the JAX side's Pallas provider in interpret
mode). They agree on the objective and on rho1/rho2 within
``max(truth_tolerance, SOLVER_ATOL_FLOOR)`` — the floor of
tests/test_engine_parity.py, because two converged solves stop anywhere
inside the tol-sized gap — on ``converged`` exactly, and on ``iters``
within 10%: the f32 summation order differs, so once a near-tie picks
another pair the two trajectories part. At m = 256, tol = 1e-3 they stay
together to the end; at tighter tol the JAX package's own three
providers differ from each other by up to 17% (ROADMAP C).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jc
from repro.kernels.precision import truth_tolerance
import repro_torch
import repro_torch.core as tc
from repro_torch import api
from repro_torch.data import make_toy
from repro_torch.launch import make_solver_mesh

SOLVER_ATOL_FLOOR = 5e-3
M, TOL, P = 256, 1e-3, 8


@pytest.fixture(scope="module")
def X():
    return make_toy(3, M)[0]


def _specs(kernel_name):
    jk = jc.rbf(0.5) if kernel_name == "rbf" else jc.linear()
    tk = tc.rbf(0.5) if kernel_name == "rbf" else tc.linear()
    return (jc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=jk),
            tc.SlabSpec(nu1=0.5, nu2=0.05, eps=0.5, kernel=tk))


def _objective(gamma, K):
    g = np.asarray(gamma, np.float64)
    return 0.5 * g @ K @ g


@pytest.mark.parametrize("gram_mode", ["precomputed", "on_the_fly",
                                       "pallas"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("kernel_name", ["rbf", "linear"])
def test_fit_matches_jax(X, kernel_name, precision, gram_mode):
    js, ts = _specs(kernel_name)
    kw = dict(interpret=True) if gram_mode == "pallas" else {}
    jr = repro.fit(jnp.asarray(X), js, strategy="blocked",
                   gram_mode=gram_mode, precision=precision, P=P, tol=TOL,
                   **kw)
    tr = repro_torch.fit(X, ts, strategy="blocked", gram_mode=gram_mode,
                         precision=precision, P=P, tol=TOL, device="cpu")

    K = np.asarray(js.kernel.gram(jnp.asarray(X)), np.float64)
    o_j = _objective(jr.model.gamma, K)
    o_t = _objective(tr.model.gamma.numpy(), K)
    tol_obj = truth_tolerance(precision, [o_j])
    np.testing.assert_allclose(o_t, o_j, rtol=tol_obj["rtol"],
                               atol=max(tol_obj["atol"], SOLVER_ATOL_FLOOR))
    rho_j = np.asarray([float(jr.model.rho1), float(jr.model.rho2)])
    rho_t = np.asarray([float(tr.model.rho1), float(tr.model.rho2)])
    tol_rho = truth_tolerance(precision, rho_j)
    np.testing.assert_allclose(rho_t, rho_j, rtol=tol_rho["rtol"],
                               atol=max(tol_rho["atol"], SOLVER_ATOL_FLOOR))
    assert bool(tr.converged) == bool(jr.converged)
    assert abs(int(tr.iters) - int(jr.iters)) <= max(1, 0.1 * int(jr.iters))

    # Feasibility of the port's gamma: the equality and the box.
    g = tr.model.gamma.double()
    assert float(g.sum()) == pytest.approx(ts.total(), abs=1e-5)
    assert float(g.max()) <= ts.upper(M) + 1e-7
    assert float(g.min()) >= ts.lower(M) - 1e-7
    np.testing.assert_allclose(tr.f.numpy(), (K @ g.numpy()),
                               **truth_tolerance(precision, K @ g.numpy()))


def test_strategy_pallas_pins_the_fused_provider(X):
    _, ts = _specs("rbf")
    a = repro_torch.fit(X, ts, strategy="pallas", P=P, tol=TOL,
                        device="cpu")
    b = repro_torch.fit(X, ts, strategy="blocked", gram_mode="pallas", P=P,
                        tol=TOL, device="cpu")
    assert torch.equal(a.model.gamma, b.model.gamma)
    with pytest.raises(ValueError):
        repro_torch.fit(X, ts, strategy="pallas", gram_mode="precomputed",
                        device="cpu")


def test_auto_gram_mode_mirrors_the_reference():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert api._auto_gram_mode(2048, cuda) == "precomputed"
    assert api._auto_gram_mode(2049, cuda) == "pallas"
    assert api._auto_gram_mode(2049, cpu) == "on_the_fly"
    assert api._auto_gram_mode(8192, cuda) == "pallas"


@pytest.mark.parametrize("strategy", ["distributed", "sharded"])
def test_unported_strategies_name_their_roadmap_item(X, strategy):
    """The sharded strategies validate their arguments as the JAX
    package's do: "distributed" needs a mesh, and neither takes a
    gram_mode (the sharded provider owns Gram access)."""
    with pytest.raises(ValueError, match="needs a mesh"
                       if strategy == "distributed" else "gram_mode"):
        repro_torch.fit(X, strategy=strategy, device="cpu",
                        **({} if strategy == "distributed"
                           else dict(gram_mode="pallas")))


def test_unknown_strategy_and_unported_options(X):
    with pytest.raises(ValueError):
        repro_torch.fit(X, strategy="bogus", device="cpu")
    # a warm start must be a prior fit (artifact, result or prepared seed)
    with pytest.raises(TypeError, match="SolverArtifact"):
        repro_torch.fit(X, warm_start=object(), device="cpu")
    # a mesh routes "auto" to the sharded solver, whose shrinking-only
    # knobs are refused below the shrinking threshold (as in the JAX
    # package)
    mesh, _ = make_solver_mesh()
    with pytest.raises(ValueError, match="warm_iters"):
        repro_torch.fit(X, mesh=mesh, warm_iters=5, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    """No device named: the entry points go to CUDA, switch TF32 off there,
    and raise rather than fall back to the CPU when there is no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert api.resolve_device(None).type == "cuda"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.fit(np.zeros((8, 2), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.serve(np.zeros((8, 2), np.float32),
                          cache=repro_torch.serve.ModelCache())
    assert api.resolve_device("cpu").type == "cpu"


def test_toy_data_shape_and_labels():
    X, y = make_toy(0, 500, d=5)
    assert X.shape == (500, 5) and X.dtype == np.float32
    assert set(np.unique(y)) == {-1.0, 1.0}
    assert int((y < 0).sum()) == int(500 * 0.15)
    X2, _ = make_toy(0, 500, d=5)
    assert np.array_equal(X, X2)
