"""The rest of the port's sharded surface held against the JAX package:
``sharded_raw_scores``, the sharded warm refit (``fit_update(mesh=)``),
the sharded shrinking driver and the sharded scorer.

Both sides run as in tests/test_torch_distributed.py: the JAX side in one
``run_forced_devices`` subprocess (4 forced host devices), the port side
as 4 gloo ranks spawned once, at the same time, on the same numpy inputs.

``solve_sharded_shrinking`` is held against the JAX package's
single-device ``solve_blocked``: the reference's own sharded shrinking
driver raises under jax 0.9.0 (ROADMAP C.2). Its cases take each of the
driver's exits: a repack round (the active set solved locally on the
first rank, its gamma broadcast), the "not profitable" exit, distributed
rounds only (``gather_max=0``), and phase 1 converging (linear).

Tolerances: scores within ``TOLERANCES`` of the reference's (the plain
decision and kernel sums in another order); solver outputs within
``max(truth_tolerance, SOLVER_ATOL_FLOOR)``; the warm refit's iterations
within 10% (ROADMAP C.6).
"""
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_forced_devices
from repro.kernels.precision import TOLERANCES, truth_tolerance
import repro_torch
from repro_torch.core.engine import artifact_from_result
from repro_torch.data import make_toy
from repro_torch.kernels.precision import round_to_tile
from repro_torch.serve import BUCKETS
import torch_dist_ranks

SOLVER_ATOL_FLOOR = 5e-3
P, TOL, SHRINK_TOL = 8, 1e-3, 1e-4
RANKS, RANKS_TIMEOUT_S, JAX_TIMEOUT_S = 4, 240, 600
M, M_SHRINK = 256, 1024
# Every per-rank bucket (RANKS * bucket rows), and a ragged request.
REQUESTS = tuple(RANKS * b for b in BUCKETS) + (1001,)
SHRINK = {
    "repack-rbf-f32": dict(kernel="rbf", precision="f32", warm_iters=60),
    "repack-rbf-bf16": dict(kernel="rbf", precision="bf16", warm_iters=60),
    "unprofitable-rbf-f32": dict(kernel="rbf", precision="f32",
                                 warm_iters=1),
    "rounds-rbf-f32": dict(kernel="rbf", precision="f32", warm_iters=60,
                           gather_max=0),
    "phase1-linear-f32": dict(kernel="linear", precision="f32"),
    "phase1-linear-bf16": dict(kernel="linear", precision="bf16"),
}

JAX_CODE = """
import json
import jax, jax.numpy as jnp, numpy as np
import repro
from repro.core import SlabSpec, linear, rbf, solve_blocked
from repro.core.distributed_smo import sharded_raw_scores
from repro.core.engine import SolverArtifact
from repro.core.ocssvm import OCSSVMModel
from repro.serve import pack_model
from repro.serve.scorer import BatchScorer
job = json.loads(JOB)
z = np.load(NPZ)
mesh = jax.make_mesh((4,), ("data",))
def spec(k):
    return SlabSpec(nu1=0.5, nu2=0.05, eps=0.5,
                    kernel=rbf(0.5) if k == "rbf" else linear())
def summary(r):
    return dict(gamma=np.asarray(r.model.gamma).tolist(),
                rho=[float(r.model.rho1), float(r.model.rho2)],
                iters=int(r.iters), converged=bool(r.converged))
out = {}
out["raw"] = {p: np.asarray(sharded_raw_scores(
    jnp.asarray(z["X"]), jnp.asarray(z["gamma"]), spec("rbf").kernel, mesh,
    precision=p)).tolist() for p in ("f32", "bf16")}
st = {}
r = repro.fit_update(SolverArtifact.load(job["artifact"]),
                     jnp.asarray(z["X_new"]), tol=job["tol"], mesh=mesh,
                     stats_out=st)
out["warm"] = dict(summary(r), stats={k: st[k] for k in ("mode", "P")})
for key, c in job["shrink"].items():
    r = solve_blocked(jnp.asarray(z["X_shrink"]), spec(c["kernel"]),
                      P=job["P"], tol=job["shrink_tol"],
                      precision=c["precision"])
    out["single/" + key] = summary(r)
model = OCSSVMModel(gamma=jnp.asarray(z["sv_gamma"]),
                    rho1=jnp.asarray(float(z["sv_rho"][0])),
                    rho2=jnp.asarray(float(z["sv_rho"][1])),
                    X=jnp.asarray(z["sv_X"]), spec=spec("rbf"))
for p in ("f32", "bf16"):
    scorer = BatchScorer(pack_model(model, precision=p), mesh=mesh)
    out["scores/" + p] = {str(n): np.asarray(
        scorer.score(z["queries"][:n])).tolist() for n in job["requests"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    spec = torch_dist_ranks._spec("rbf")
    X = make_toy(4, M)[0]
    n_delta = M * 5 // 100            # 5% expiry + 5% append
    X_new = np.concatenate([X[n_delta:], make_toy(5, n_delta)[0]])
    prev = repro_torch.fit(X, spec, strategy="blocked", P=P, tol=TOL,
                           device="cpu")
    art_path = str(tmp / "prev.npz")
    artifact_from_result(prev).save(art_path)
    data = dict(
        X=X, X_new=X_new, gamma=prev.model.gamma.numpy(),
        X_shrink=make_toy(2, M_SHRINK)[0],
        queries=make_toy(6, max(REQUESTS))[0],
        sv_gamma=prev.model.gamma.numpy(), sv_X=X,
        sv_rho=np.asarray([float(prev.model.rho1), float(prev.model.rho2)],
                          np.float32))
    npz = str(tmp / "data.npz")
    np.savez(npz, **data)
    job = dict(artifact=art_path, tol=TOL, P=P, shrink=SHRINK,
               shrink_tol=SHRINK_TOL, requests=REQUESTS)
    code = JAX_CODE.replace("JOB", repr(json.dumps(job))).replace(
        "NPZ", repr(npz))
    served = dict(gamma=data["sv_gamma"], X=X, rho1=float(data["sv_rho"][0]),
                  rho2=float(data["sv_rho"][1]))
    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(run_forced_devices, code, devices=RANKS,
                               timeout=JAX_TIMEOUT_S)
        port = spawn(dict(job, served=served, **data), tmp)
        ref = jax_side.result()
    return dict(data=data, jax=ref, port=port)


def spawn(job, tmp):
    from repro_torch.launch import spawn_ranks
    return spawn_ranks(torch_dist_ranks.sharded_paths, RANKS, args=(job,),
                       timeout_s=RANKS_TIMEOUT_S, dir=str(tmp))


def _objective(gamma, X, kernel_name):
    Xd = torch.as_tensor(X, dtype=torch.float64)
    K = torch_dist_ranks._spec(kernel_name).kernel.gram(Xd).numpy()
    g = np.asarray(gamma, np.float64)
    return 0.5 * g @ K @ g


def _within(a, b, precision, what):
    tol = truth_tolerance(precision, np.atleast_1d(np.asarray(b)))
    np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                               atol=max(tol["atol"], SOLVER_ATOL_FLOOR),
                               err_msg=what)


def _same_on_every_rank(runs, key):
    ranks = [r[key] for r in runs["port"]]
    for r in ranks[1:]:
        assert r["gamma"].tobytes() == ranks[0]["gamma"].tobytes()
        assert r["iters"] == ranks[0]["iters"]
    return ranks[0]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_sharded_raw_scores_match_jax(runs, precision):
    ref = np.asarray(runs["jax"]["raw"][precision], np.float32)
    for r in runs["port"]:
        np.testing.assert_allclose(r["raw"][precision], ref,
                                   **truth_tolerance(precision, ref))
    # and K @ gamma over the tile-rounded rows, computed plainly
    d = runs["data"]
    Xr = round_to_tile(torch.as_tensor(d["X"]), precision).double()
    truth = (torch_dist_ranks._spec("rbf").kernel.gram(Xr).numpy()
             @ d["gamma"].astype(np.float64))
    np.testing.assert_allclose(runs["port"][0]["raw"][precision], truth,
                               **truth_tolerance(precision, truth))


def test_sharded_warm_refit_matches_jax(runs):
    tr = _same_on_every_rank(runs, "warm")
    jr = runs["jax"]["warm"]
    assert tr["stats"]["mode"] == jr["stats"]["mode"] == "warm"
    assert tr["stats"]["P"] == jr["stats"]["P"]
    assert tr["converged"] and jr["converged"]
    X_new = runs["data"]["X_new"]
    _within(_objective(tr["gamma"], X_new, "rbf"),
            _objective(jr["gamma"], X_new, "rbf"), "f32", "objective")
    _within(np.asarray(tr["rho"]), np.asarray(jr["rho"]), "f32", "rho")
    assert abs(tr["iters"] - jr["iters"]) <= max(1, 0.1 * jr["iters"])
    # the warm init reconciles each rank's slice: no gather of X, only
    # the two statistics passes
    assert tr["ledger"]["init_ops"] == 4


@pytest.mark.parametrize("case", list(SHRINK))
def test_sharded_shrinking_matches_single_device_jax(runs, case):
    c = SHRINK[case]
    tr = _same_on_every_rank(runs, f"shrink/{case}")
    jr = runs["jax"][f"single/{case}"]
    kinds = [r[0] for r in tr["rounds"]]
    if case.startswith("repack"):
        assert kinds[:2] == ["distributed", "repack"]
    elif case.startswith("unprofitable"):
        # phase 1, then the whole set to the end: no repack
        assert kinds == ["distributed", "distributed"]
    elif case.startswith("rounds"):
        assert "repack" not in kinds and len(kinds) >= 2
    else:
        assert kinds == ["distributed"]     # phase 1 converged
    assert tr["callers_rows"]               # ROADMAP C.5, both returns
    assert tr["converged"] and jr["converged"]
    Xs = runs["data"]["X_shrink"]
    _within(_objective(tr["gamma"], Xs, c["kernel"]),
            _objective(jr["gamma"], Xs, c["kernel"]), c["precision"],
            f"{case} objective")
    _within(np.asarray(tr["rho"]), np.asarray(jr["rho"]), c["precision"],
            f"{case} rho")
    spec = torch_dist_ranks._spec(c["kernel"])
    g = tr["gamma"].astype(np.float64)
    assert float(g.sum()) == pytest.approx(spec.total(), abs=1e-5)
    assert g.max() <= spec.upper(M_SHRINK) + 1e-7
    assert g.min() >= spec.lower(M_SHRINK) - 1e-7


@pytest.mark.parametrize("n", REQUESTS)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_sharded_scorer_matches_jax_and_the_local_scorer(runs, precision,
                                                         n):
    ref = np.asarray(runs["jax"][f"scores/{precision}"][str(n)], np.float32)
    tol = TOLERANCES[precision]
    for r in runs["port"]:
        sharded, local, bucket = r[f"scores/{precision}"][n]
        assert sharded.shape == (n,) and isinstance(sharded, np.ndarray)
        assert bucket == min(b for b in BUCKETS if b >= -(-n // RANKS))
        np.testing.assert_allclose(sharded, ref, **tol)
        np.testing.assert_allclose(sharded, local, **tol)


def test_sharded_scorer_takes_tensors_and_warms_every_bucket(runs):
    for r in runs["port"]:
        for precision in ("f32", "bf16"):
            out = r[f"scores/{precision}/tensor"]
            local = r[f"scores/{precision}"][REQUESTS[0]][1][:100]
            np.testing.assert_allclose(out, local, **TOLERANCES[precision])
            assert r[f"scores/{precision}/warmed"] == list(BUCKETS)
